"""The port's condition store and device-resident store
(fea_tpu_torch.data.store, .device_store) against fea_tpu's, on the CPU.

A small PNG dataset is written here with PIL in the reference's on-disk
layout, from a seed. Both packages build a store from it: the files are
byte-identical, the samples bit-identical, and a batch assembled from the
device tables (on the CPU device) equals the samples bit for bit. The
trainers of both packages then take a step from one store, and fea_tpu's
orbax checkpoint goes through tools/convert_orbax_checkpoint.py into the
port's trainer. JAX is imported inside the tests that compare with fea_tpu, so that the `gpu`
test also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_store.py
"""

import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from fea_tpu_torch.data import dataset, device_store, store

torch.set_num_threads(1)

PLATES, CONDITIONS, STEPS = 2, 2, 3  # 2 x 2 x (3 - 1) = 8 samples
# one image size whose rows bit-pack (divisible by 8) and one whose do not
SIZES = (32, 36)


def write_dataset(root, size=40, seed=0, plates=PLATES, conditions=CONDITIONS, steps=STEPS):
    """PNGs, magnitudes, materials and ranges in the reference's layout,
    drawn from `seed`; `size` differs from the image sizes read so that the
    bilinear resize runs. A second material region with an empty mask takes
    the geometry-mask fallback; one force value is exactly zero."""
    rng = np.random.default_rng(seed)

    def png(path, mask=False, empty=False):
        if empty:
            pixels = np.full((size, size), 255)
        elif mask:  # dark (inked) where the region is
            pixels = np.where(rng.random((size, size)) < 0.3, 0, 255)
        else:
            pixels = rng.integers(0, 256, (size, size))
        Image.fromarray(pixels.astype(np.uint8), "L").save(path)

    for plate in range(1, plates + 1):
        pdir = root / str(plate)
        pdir.mkdir(parents=True)
        png(pdir / "input.png", mask=True)
        for condition in range(1, conditions + 1):
            cdir = pdir / str(condition)
            cdir.mkdir()
            for name in ("outputs_displacement_x", "outputs_displacement_y"):
                png(cdir / f"{name}.png")
            for name in ("Constraint_0", "Constraint_1", "regions_Edge_0", "regions_Edge_2",
                         "regions_Vertex_1", "regions_Material_0"):
                png(cdir / f"{name}.png", mask=True)
            png(cdir / "regions_Material_1.png", empty=True)
            fx, fy, gx, vy = rng.normal(0, 100, 4)
            (cdir / "magnitudes.txt").write_text(
                f"Edge_0: ({fx}, {fy})\nVertex_1: (0.0, {vy})\nEdge_2: ({gx}, 0.0)\n"
            )
            (cdir / "materials.txt").write_text(
                f"Material_0: ({rng.uniform(2e4, 4e5)}, 0.3)\n"
                f"Material_1: ({rng.uniform(2e4, 4e5)}, 0.25)\n"
            )
            ranges = "".join(
                f"displacement_{axis}_{step}: ({-rng.random()}, {rng.random()})\n"
                for step in range(1, steps) for axis in "xy"
            )
            (cdir / "ranges.txt").write_text(ranges)
    return root


def build_kw(size):
    return dict(num_plates=PLATES, image_size=size, conditions_per_plate=CONDITIONS,
                num_steps=STEPS)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("fea_data"))


@pytest.fixture(scope="module")
def stores(folder, tmp_path_factory):
    """{size: store directory}, built by the port."""
    out = {}
    for size in SIZES:
        out[size] = tmp_path_factory.mktemp(f"store{size}")
        store.build_condition_store(str(folder), str(out[size]), **build_kw(size))
    return out


def assert_samples_equal(a, b, signed_zero=True):
    """Every leaf: same dtype, shape and bytes. `signed_zero=False` compares
    values instead (-0.0 == 0.0): at step 1 the store's force table holds
    sign(v) * log(1) = -0.0 for a negative force where the PNG path's
    overlay keeps its +0.0 background, in fea_tpu as in the port."""
    assert a.keys() == b.keys()
    for key in a:
        av, bv = np.asarray(a[key]), np.asarray(b[key])
        assert av.dtype == bv.dtype and av.shape == bv.shape, key
        if signed_zero:
            assert av.tobytes() == bv.tobytes(), key
        else:
            assert np.array_equal(av, bv), key


def file_payload(path):
    """A file's bytes; for an .npz, its members' bytes (the zip container
    stamps each member with the time it was written)."""
    if path.suffix == ".npz":
        with zipfile.ZipFile(path) as z:
            return {name: z.read(name) for name in sorted(z.namelist())}
    return path.read_bytes()


@pytest.mark.parametrize("size", SIZES)
def test_store_files_identical_to_fea_tpu(folder, stores, tmp_path, size):
    """Both packages build from one folder: the same files, byte for byte; each
    package reads the other's store and gives the same samples."""
    from fea_tpu.data import store as jstore

    theirs = tmp_path / "theirs"
    jstore.build_condition_store(str(folder), str(theirs), **build_kw(size))
    names = sorted(p.name for p in stores[size].iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    assert set(names) == {p.name for p in store._store_paths(theirs).values()}
    for name in names:
        assert file_payload(stores[size] / name) == file_payload(theirs / name), name

    ours_of_theirs = store.StoredFEADataset(str(theirs))
    theirs_of_ours = jstore.StoredFEADataset(str(stores[size]))
    assert len(ours_of_theirs) == len(theirs_of_ours) == PLATES * CONDITIONS * (STEPS - 1)
    for i in range(len(ours_of_theirs)):
        assert_samples_equal(ours_of_theirs[i], theirs_of_ours[i])


@pytest.mark.parametrize("size", SIZES)
def test_stored_samples_equal_png_samples(tmp_path, size):
    """StoredFEADataset against the port's PNG path: every leaf equal (the
    forces overlay, the empty material mask's fallback, ranges), as
    fea_tpu's tests/test_store.py holds its own two paths. The PNGs are
    written at the size they are read at, as datagen writes them: the
    store's contract is exactly binary region masks, and a resize of a
    black-and-white mask leaves grays whose mask value rounds just under 1."""
    folder = write_dataset(tmp_path / "data", size=size)
    target = str(tmp_path / "store")
    store.build_condition_store(str(folder), target, **build_kw(size))
    png = dataset.FEADataset(
        str(folder), image_size=size, conditions_per_plate=CONDITIONS, num_steps=STEPS
    )
    stored = store.StoredFEADataset(target)
    assert len(stored) == len(png) == 8
    assert stored.index_to_ids(5) == png.index_to_ids(5)
    for i in range(len(png)):
        assert_samples_equal(png[i], stored[i], signed_zero=False)
    assert np.abs(stored[1]["forces"]).max() > 0
    assert np.abs(stored[1]["materials"][..., 1]).max() > 0.25


def test_store_resume_is_idempotent(folder, stores):
    before = {p.name: file_payload(p) for p in stores[32].iterdir()}
    store.build_condition_store(str(folder), str(stores[32]), **build_kw(32))
    assert {p.name: file_payload(p) for p in stores[32].iterdir()} == before
    with pytest.raises(AssertionError, match="meta mismatch"):
        store.ConditionStoreBuilder(str(folder), str(stores[32]), **build_kw(36))


def test_store_crash_before_flush_marks_nothing_done(folder, tmp_path):
    """`done` reaches the disk only in flush(), after scalars and pixels."""
    target = str(tmp_path / "crash")
    b = store.ConditionStoreBuilder(str(folder), target, **build_kw(32))
    b.build_plate(1)
    # no flush: a new instance (the resumed run) sees plate 1 pending
    assert store.ConditionStoreBuilder(str(folder), target, **build_kw(32)).pending_plates() == [1, 2]
    assert b.pending_plates() == [2]  # the running one knows its own work
    with pytest.raises(AssertionError, match="incomplete"):
        store.StoredFEADataset(target)
    b.flush()
    b3 = store.ConditionStoreBuilder(str(folder), target, **build_kw(32))
    assert b3.pending_plates() == [2]
    assert float(np.abs(b3.ranges[:2]).sum()) > 0.0  # the scalars made it too


def test_store_rejects_min_max_modes_and_missing_plates(folder, stores, tmp_path):
    with pytest.raises(AssertionError, match="log-scaling"):
        store.StoredFEADataset(str(stores[32]), min_max_magnitude=(1, 1000))
    with pytest.raises(FileNotFoundError, match="1 missing"):
        store.build_condition_store(
            str(folder), str(tmp_path / "short"), **{**build_kw(32), "num_plates": 3}
        )


def test_unpack_mask_bits_is_packbits_inverse():
    bits = np.random.default_rng(0).integers(0, 2, (3, 5, 24)).astype(np.uint8)
    packed = torch.from_numpy(np.packbits(bits, axis=-1))
    got = device_store._unpack_mask_bits(packed)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), bits)


@pytest.mark.parametrize("size", SIZES)
def test_assemble_batch_equals_samples_and_fea_tpu(stores, size):
    """assemble_batch(build_device_tables(ds), index_arrays(ds, idx)) on
    the CPU device: bit-equal to the port's StoredFEADataset samples and
    to fea_tpu's assemble_batch, with bit-packed masks (32) and flat (36)."""
    import jax
    import jax.numpy as jnp

    from fea_tpu.data import device_store as jdevice
    from fea_tpu.data import store as jstore

    ds = store.StoredFEADataset(str(stores[size]))
    tables = device_store.build_device_tables(ds, "cpu")
    assert ("geometry_bits" in tables) == (size % 8 == 0)
    assert tables["force_winner"].dtype == torch.int8
    assert sum(t.numel() * t.element_size() for t in tables.values()) == \
        device_store.estimate_table_bytes(ds)
    idx = np.array([5, 0, 7, 2, 2, 6], np.int64)
    index = device_store.index_arrays(ds, idx)
    got = device_store.assemble_batch(tables, {k: torch.from_numpy(v) for k, v in index.items()})
    want = dataset.collate([ds[int(i)] for i in idx])
    assert_samples_equal({k: v.numpy() for k, v in got.items()}, want)

    jds = jstore.StoredFEADataset(str(stores[size]))
    assert jdevice.estimate_table_bytes(jds) == device_store.estimate_table_bytes(ds)
    jindex = jdevice.index_arrays(jds, idx)
    assert_samples_equal(index, jindex)
    with jax.enable_x64(False):
        theirs = jdevice.assemble_batch(
            jdevice.build_device_tables(jds), {k: jnp.asarray(v) for k, v in jindex.items()}
        )
    assert_samples_equal({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in theirs.items()})


def test_default_table_byte_cap_on_cpu_is_unbounded():
    assert device_store.default_table_byte_cap("cpu") > 2**60


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """Trainers of both packages over one store, each one step in, at
    tests/test_torch_train.py's sizes and from the same params: the port's
    on the host feed and on the device-resident tables, and fea_tpu's on
    its host feed (one XLA compile of its train step, shared below)."""
    import jax
    import test_torch_train as tt

    root = tmp_path_factory.mktemp("stepped")
    (root / "data").mkdir()
    folder = tt.write_dataset(root / "data")
    store_dir = str(root / "store")
    store.build_condition_store(
        str(folder), store_dir, num_plates=tt.PLATES, image_size=tt.S,
        conditions_per_plate=tt.CONDITIONS, num_steps=tt.STEPS,
    )
    host = tt.port_trainer(folder, root, "host", dataset_store=store_dir)
    resident = tt.port_trainer(
        folder, root, "resident", dataset_store=store_dir, device_resident_store=True
    )
    jt = tt.jax_trainer(folder, root / "jax", tt.port_trainer(folder, root, "init"),
                        dataset_store=store_dir)
    out = dict(root=root, folder=folder, store_dir=store_dir, host=host, resident=resident,
               jax=jt, host_batch=host._fetch_batch(0), resident_batch=resident._fetch_batch(0))
    out["host_loss"] = host._train_step(out["host_batch"])
    out["resident_loss"] = resident._train_step(out["resident_batch"])
    with jax.enable_x64(False):
        out["jax_batch"] = jt._fetch_batch(0)
        jt.state, out["jax_loss"] = jt._train_step(jt.state, out["jax_batch"])
    return out


def assert_step_matches_fea_tpu(pt, loss, state, jloss):
    """tests/test_torch_train.py's bounds for one step from equal state."""
    import test_torch_train as tt

    from fea_tpu_torch.models.convert import from_flax
    from fea_tpu_torch.train.trainer import MODULES

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for key in MODULES:
        count, mu, nu = tt.adam_moments(state, key)
        pcount, pmu, pnu = tt.port_moments(pt, key)
        assert pcount == count
        assert tt.max_rel(pmu, mu) < 1e-4, key
        assert tt.max_rel(pnu, nu) < 2e-4, key
        tt.assert_adam_step_close(pt.modules[key].state_dict(),
                                  from_flax(tt.to_numpy(state.params[key])))
        tt.assert_adam_step_close(dict(zip(pt.names[key], pt.ema_params[key])),
                                  from_flax(tt.to_numpy(state.ema_params[key])), scale=0.005)


def test_trainer_store_feeds_agree_and_match_fea_tpu(stepped):
    """One step from `dataset_store`: the host feed and the device-resident
    tables give the same loss and parameters bit for bit, and the step
    agrees with fea_tpu's from the same store within
    tests/test_torch_train.py's bounds."""
    import test_torch_train as tt

    host, resident = stepped["host"], stepped["resident"]
    assert isinstance(host.dataset, store.StoredFEADataset)
    assert host.device_tables is None and resident.device_tables is not None
    assert set(stepped["resident_batch"]) == {
        "pi", "ci", "si", "plate_index", "condition_index", "iteration_index"}
    assert "ci" not in stepped["host_batch"]
    assert stepped["resident_loss"].item() == stepped["host_loss"].item()
    assert resident.step == host.step == 1
    a, b = tt.snapshot(host), tt.snapshot(resident)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key

    for key, value in stepped["jax_batch"].items():
        np.testing.assert_array_equal(stepped["host_batch"][key].numpy(), np.asarray(value))
    assert_step_matches_fea_tpu(host, stepped["host_loss"], stepped["jax"].state,
                                stepped["jax_loss"])


def test_device_resident_store_messages_and_cap(stepped, capsys):
    """The two messages of fea_tpu's trainer: tables uploaded once, or, over
    the cap, the host feed carries on."""
    import test_torch_train as tt

    kw = dict(dataset_store=stepped["store_dir"], device_resident_store=True)
    tt.port_trainer(stepped["folder"], stepped["root"], "said", **kw)
    assert "tables uploaded once" in capsys.readouterr().out
    capped = tt.port_trainer(stepped["folder"], stepped["root"], "capped",
                             device_store_byte_cap=1000, **kw)
    assert "falling back to the host feed" in capsys.readouterr().out
    assert capped.device_tables is None
    assert "ci" not in capped._fetch_batch(0)


def test_converted_orbax_checkpoint_loads_and_steps(stepped):
    """fea_tpu's Trainer saves with orbax, tools/convert_orbax_checkpoint.py
    converts, the port's Trainer loads: params, EMA and Adam's moments
    equal fea_tpu's bit for bit, and one further step on the same batch
    agrees within the train-step bounds."""
    import importlib.util
    import pathlib

    import jax
    import test_torch_train as tt

    from fea_tpu_torch.models.convert import from_flax
    from fea_tpu_torch.train.trainer import MODULES

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "convert_orbax_checkpoint.py"
    spec = importlib.util.spec_from_file_location("convert_orbax_checkpoint", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    jt, root = stepped["jax"], stepped["root"]
    with jax.enable_x64(False):
        jt.save_checkpoint("final")
    tool.main([
        str(root / "jax" / "model-final"), str(root / "converted" / "model-final"),
        "--image_size", str(tt.S), "--input_dim", str(tt.DIM), "--num_stages", str(tt.STAGES),
    ])
    pt = tt.port_trainer(stepped["folder"], root, "converted", dataset_store=stepped["store_dir"])
    pt.load_checkpoint("final")
    assert pt.step == 1 and pt.lowest_sample_loss == float("inf")
    for key in MODULES:
        count, mu, nu = tt.adam_moments(jt.state, key)
        pcount, pmu, pnu = tt.port_moments(pt, key)
        assert pcount == count == 1
        pairs = [
            (pt.modules[key].state_dict(), from_flax(tt.to_numpy(jt.state.params[key]))),
            (dict(zip(pt.names[key], pt.ema_params[key])),
             from_flax(tt.to_numpy(jt.state.ema_params[key]))),
            (pmu, mu), (pnu, nu),
        ]
        for got, want in pairs:
            assert got.keys() == want.keys()
            for name in want:
                assert torch.equal(got[name], want[name]), (key, name)
    assert float(pmu[pt.names[key][0]].abs().max()) > 0  # the moments came across

    loss = pt._train_step(stepped["host_batch"])
    with jax.enable_x64(False):
        state, jloss = jt._train_step(jt.state, stepped["jax_batch"])
    assert pt.step == int(state.step) == 2
    assert_step_matches_fea_tpu(pt, loss, state, jloss)

    # a leaf the port has no counterpart for is named
    raw = tool.read_orbax(root / "jax" / "model-final")
    raw["opt_states"]["decoder"][0] = {"trust_ratio": np.ones(3)}
    modules = {k: t for k, t in pt.modules.items()}
    with pytest.raises(ValueError, match=r"opt_states.decoder\[0\].*no counterpart"):
        tool.convert(raw, modules)


@pytest.mark.gpu
def test_card_assembly_equals_host_samples(tmp_path):
    """On the card: the tables live there, and a batch assembled there
    equals StoredFEADataset's samples for the same indices bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for size in SIZES:
        folder = write_dataset(tmp_path / f"data{size}", seed=size)
        target = str(tmp_path / f"store{size}")
        store.build_condition_store(str(folder), target, **build_kw(size))
        ds = store.StoredFEADataset(target)
        tables = device_store.build_device_tables(ds, "cuda")
        assert all(t.is_cuda for t in tables.values())
        idx = np.random.default_rng(size).integers(0, len(ds), 16)
        index = {k: torch.from_numpy(v).cuda()
                 for k, v in device_store.index_arrays(ds, idx).items()}
        got = device_store.assemble_batch(tables, index)
        assert all(t.is_cuda for t in got.values())
        want = dataset.collate([ds[int(i)] for i in idx])
        assert_samples_equal({k: v.cpu().numpy() for k, v in got.items()}, want)
