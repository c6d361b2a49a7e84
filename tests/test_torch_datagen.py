"""The port's host side of datagen (samplers, regions, pixel maps, images,
writers), its sequential and batched pipelines and its in-memory feed,
against fea_tpu's, on the CPU.

Each package's copy is fed the same seed or input. JAX runs with x64 off
(`jax.enable_x64(False)`), as fea_tpu runs on the chip. The pipelines run
at a small config (3 plates, 2 conditions, 2 steps, 64 px, mesh 0.12, at
most one hole) in which no CG lane fails in either package.

Tolerances: the samplers' draws, the pixel maps and the NumPy images
equal; the interpolated field images within 1 gray level; the written
trees hold the same files, the txt files equal but `ranges.txt`, which is
within 1e-4 of each range's span, and every PNG within 1 gray level;
fea_tpu's FEADataset reads the port's tree as the port's reader does; the
in-memory samples' displacement within one gray level of its image
(1/255, that is 2/255 after the [-1, 1] scaling), the rest within 1e-4 of
its largest element (at least 1).
"""

import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fea_tpu_torch import raster
from fea_tpu_torch.datagen import batched, conditions, pipeline, regions, writers
from fea_tpu_torch.geometry import GeometrySampler
from fea_tpu_torch.mesh import mesher

torch.set_num_threads(1)

SQUARE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
HOLE = np.array([[0.35, 0.35], [0.35, 0.6], [0.6, 0.6], [0.6, 0.35]])  # CW
CONFIG = dict(image_size=64, num_plates=3, conditions_per_plate=2, mesh_size=0.12,
              num_steps_per_condition=2, holes_per_polygon_range=(0, 1), seed=5,
              verbose=False)


def test_samplers_and_regions_match():
    import random

    from fea_tpu.datagen import conditions as jconditions
    from fea_tpu.datagen import regions as jregions
    from fea_tpu.geometry import GeometrySampler as JGeometrySampler

    ours, theirs = GeometrySampler(random_seed=3), JGeometrySampler(random_seed=3)
    for _ in range(8):
        a, b = ours.generate(), theirs.generate()
        np.testing.assert_array_equal(a.exterior, b.exterior)
        assert len(a.holes) == len(b.holes)
        for h, g in zip(a.holes, b.holes):
            np.testing.assert_array_equal(h, g)
    np.testing.assert_array_equal(GeometrySampler.create_box().exterior,
                                  JGeometrySampler.create_box().exterior)

    mesh = mesher.triangulate(SQUARE, [HOLE], mesh_size=0.08)
    for seed in range(4):
        got = regions.cluster_regions(mesh.coords, (1, 5), random.Random(seed))
        want = jregions.cluster_regions(mesh.coords, (1, 5), random.Random(seed))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    ours = conditions.ConditionSampler(random_seed=11)
    theirs = jconditions.ConditionSampler(random_seed=11)
    pool, jpool = [], []
    draws = ours.sample(mesh, 4, cluster_pool=pool) + [ours.sample_one(mesh, cluster_pool=pool)]
    jdraws = theirs.sample(mesh, 4, cluster_pool=jpool) + [theirs.sample_one(mesh, cluster_pool=jpool)]
    for c, j in zip(draws, jdraws):
        assert c.keys() == j.keys()
        for key in ("point_constraints", "edge_constraints", "point_forces", "edge_forces"):
            assert c[key] == j[key], key
        assert [m for m, _ in c["material_regions"]] == [m for m, _ in j["material_regions"]]
        for (_, g), (_, w) in zip(c["material_regions"], j["material_regions"]):
            np.testing.assert_array_equal(g, w)
    assert len(pool) == len(jpool)


def test_pixel_maps_and_images_match(tmp_path):
    from fea_tpu import raster as jraster
    from fea_tpu.datagen import writers as jwriters
    from fea_tpu.raster.rasterizer import cell_field_image as jcell_field_image

    mesh = mesher.triangulate(SQUARE, [HOLE], mesh_size=0.08)
    c, tris = mesh.coords, mesh.triangles
    assert raster.make_frame(c, 64) == jraster.make_frame(c, 64)
    pm = raster.build_pixel_map(c, tris, 64, pad_candidates=32)
    jpm = jraster.build_pixel_map(c, tris, 64, pad_candidates=32)
    for field in ("tri_idx", "bary", "inside"):
        np.testing.assert_array_equal(getattr(pm, field), getattr(jpm, field))
    assert pm.frame == jpm.frame and pm.inside.any() and not pm.inside.all()

    rng = np.random.default_rng(0)
    u = rng.normal(size=mesh.num_nodes)
    for value_range in (None, (float(u.min()), float(u.max()) * 0.5), (1.0, 1.0)):
        got = raster.field_image(pm, tris, u, value_range, device="cpu")
        want = jraster.field_image(jpm, tris, u, value_range)
        assert got.dtype == np.uint8 and got.shape == (64, 64)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_allclose(raster.interpolate_field(pm, tris, u, device="cpu").numpy(),
                               np.asarray(jraster.rasterizer.interpolate_field(jpm, tris, u)),
                               rtol=0, atol=1e-6 * np.abs(u).max())
    cells = rng.normal(size=mesh.num_triangles)
    np.testing.assert_array_equal(raster.cell_field_image(pm, cells), jcell_field_image(jpm, cells))
    np.testing.assert_array_equal(raster.geometry_image(pm), jraster.geometry_image(jpm))
    nodes = np.arange(0, mesh.num_nodes, 7)
    np.testing.assert_array_equal(raster.node_splat_image(pm, c, nodes), jraster.node_splat_image(jpm, c, nodes))
    np.testing.assert_array_equal(raster.region_image(pm, tris, nodes, mesh.num_nodes),
                                  jraster.region_image(jpm, tris, nodes, mesh.num_nodes))
    np.testing.assert_array_equal(raster.outline_image(pm, c, mesh.ring_corner_ids),
                                  jraster.outline_image(jpm, c, mesh.ring_corner_ids))
    assert raster.scalar_range(u) == jraster.scalar_range(u)

    # the writers: the same bytes
    img = raster.outline_image(pm, c, mesh.ring_corner_ids)
    for module, tag in ((writers, "ours"), (jwriters, "theirs")):
        module.save_gray_png(str(tmp_path / f"{tag}.png"), img)
        module.append_region_value(str(tmp_path / f"{tag}.txt"), "EdgeForce0", (1.5, -2))
        module.append_region_value(str(tmp_path / f"{tag}.txt"), "MaterialRegion0", (2e5, 0.3))
        assert module.find_image_bounds(str(tmp_path / f"{tag}.png")) == \
            jwriters.find_image_bounds(str(tmp_path / "ours.png"))
    for ext in ("png", "txt"):
        assert (tmp_path / f"ours.{ext}").read_bytes() == (tmp_path / f"theirs.{ext}").read_bytes()
    assert [writers.domain_vtk_name(s, n) for s, n in ((3, 6), (3, 11))] == \
        [jwriters.domain_vtk_name(s, n) for s, n in ((3, 6), (3, 11))] == ["domain.3.vtk", "domain.03.vtk"]
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "x.txt").write_text("x")
    writers.clear_directory(str(tmp_path / "d"))
    assert os.listdir(tmp_path / "d") == []
    assert pipeline.SHAPE_BUCKETS == __import__("fea_tpu.datagen.pipeline").datagen.pipeline.SHAPE_BUCKETS
    assert [pipeline.next_bucket(n) for n in (3, 257, 8000, 10**6)] == [256, 384, 8192, 10**6]


def assert_same_tree(ours, theirs):
    """The same files; txt equal but ranges.txt (within 1e-4 of each
    range's span); PNGs within 1 gray level."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)

    names = files(ours)
    assert names == files(theirs)
    assert any(n.endswith("outputs_displacement_x.png") for n in names)
    for name in names:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".png"):
            x = np.asarray(Image.open(a), np.int16)
            y = np.asarray(Image.open(b), np.int16)
            assert x.shape == y.shape and np.abs(x - y).max() <= 1, name
        elif name.endswith("ranges.txt"):
            for la, lb in zip(open(a), open(b), strict=True):
                ka, va = la.split(":")
                kb, vb = lb.split(":")
                assert ka == kb
                va, vb = np.array(eval(va)), np.array(eval(vb))
                span = max(abs(vb[1] - vb[0]), 1e-30)
                assert np.abs(va - vb).max() <= 1e-4 * span, name
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), name


def test_generate_data_matches_fea_tpu(tmp_path):
    """The sequential pipeline: the same plates, conditions, resamples and
    files as fea_tpu's `generate_data`."""
    import jax

    from fea_tpu.datagen import generate_data as jgenerate_data

    stats = pipeline.generate_data(data_dir=str(tmp_path / "ours"), device="cpu", **CONFIG)
    with jax.enable_x64(False):
        jstats = jgenerate_data(data_dir=str(tmp_path / "theirs"), **CONFIG)
    for key in ("plates", "solves", "failures"):
        assert stats[key] == jstats[key], key
    assert_same_tree(str(tmp_path / "ours"), str(tmp_path / "theirs"))


def test_generate_data_batched_matches_fea_tpu(tmp_path):
    """The batched pipeline (flat chunks through the solve worker): the
    same plates, counters and files as fea_tpu's; fea_tpu's FEADataset
    reads the port's tree as the port's own reader does; the same seed
    writes the same bytes again, and the worker thread ends with the run."""
    import jax

    from fea_tpu.data.dataset import FEADataset as JFEADataset
    from fea_tpu.datagen.batched import generate_data_batched as jgenerate

    from fea_tpu_torch.data import FEADataset

    kw = dict(CONFIG, batch_size=2)
    stats = batched.generate_data_batched(data_dir=str(tmp_path / "ours"), device="cpu", **kw)
    with jax.enable_x64(False):
        jstats = jgenerate(data_dir=str(tmp_path / "theirs"), **kw)
    for key in ("plates", "lane_dispatches", "solves", "host_rejections", "cg_failures",
                "direct_fallbacks", "cg_resamples", "continuations", "chunks", "final_buckets"):
        assert stats[key] == jstats[key], key
    assert stats["cg_failures"] == 0 and stats["host_reads"] > 0
    assert_same_tree(str(tmp_path / "ours"), str(tmp_path / "theirs"))

    again = batched.generate_data_batched(data_dir=str(tmp_path / "again"), device="cpu", **kw)
    assert again["plates"] == 3
    assert not any(t.name.startswith("fea-solve") for t in threading.enumerate())
    for d, _, names in os.walk(tmp_path / "ours"):
        for name in names:
            path = os.path.join(d, name)
            twin = os.path.join(tmp_path / "again", os.path.relpath(path, tmp_path / "ours"))
            assert open(path, "rb").read() == open(twin, "rb").read(), path

    read = dict(image_size=32, conditions_per_plate=2, num_steps=2)
    theirs, ours = JFEADataset(str(tmp_path / "ours"), **read), FEADataset(str(tmp_path / "ours"), **read)
    assert len(theirs) == len(ours) == 3 * 2 * 1
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


def test_in_memory_dataset_matches_fea_tpu():
    import jax

    from fea_tpu.data.arrays import InMemoryFEADataset as JInMemory

    from fea_tpu_torch.data import InMemoryFEADataset

    kw = dict(num_plates=1, conditions_per_plate=2, num_steps=3, image_size=32, mesh_size=0.1,
              seed=3, holes_per_polygon_range=(0, 1))
    ours = InMemoryFEADataset.generate(device="cpu", **kw)
    with jax.enable_x64(False):
        theirs = JInMemory.generate(**kw)
    assert len(ours) == len(theirs) == 2 * 2
    assert ours.num_steps == theirs.num_steps and \
        ours.conditions_per_plate_geometry == theirs.conditions_per_plate_geometry
    for a, b in zip(ours.samples, theirs.samples):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].shape == b[key].shape and a[key].dtype == np.float32, key
            tol = 2.0 / 255 if key == "displacement" else 1e-4 * max(np.abs(b[key]).max(), 1.0)
            assert np.abs(a[key] - b[key]).max() <= tol, key


def test_entry_points_need_a_card_or_the_cpu_named(tmp_path):
    """Without CUDA each entry point raises unless given device="cpu";
    more than one device is a later slice."""
    from fea_tpu_torch.data import InMemoryFEADataset

    mesh = mesher.triangulate(SQUARE, mesh_size=0.3)
    if not torch.cuda.is_available():
        for call in (lambda: batched.generate_data_batched(data_dir=str(tmp_path / "a"), **CONFIG),
                     lambda: pipeline.generate_data(data_dir=str(tmp_path / "b"), **CONFIG),
                     lambda: batched.PlateSolver(mesh, 2),
                     lambda: InMemoryFEADataset.generate(num_plates=1, mesh_size=0.3),
                     lambda: raster.field_image(
                         raster.build_pixel_map(mesh.coords, mesh.triangles, 8), mesh.triangles,
                         np.zeros(mesh.num_nodes))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    with pytest.raises(NotImplementedError, match="slice 7"):
        batched.generate_data_batched(data_dir=str(tmp_path / "c"), n_devices=2, device="cpu", **CONFIG)
    with pytest.raises(ValueError, match="float32 or float64"):
        batched.PlateSolver(mesh, 2, dtype=torch.bfloat16, device="cpu")
