"""The port's application runner (fea_tpu_torch.apps) against fea_tpu's, on
the CPU.

`build_problem` is compared on all five applications (the two packages'
CDT meshers give equal meshes, so fixed nodes, loads and materials are
equal). `run_application("gusset")` runs once per package at 128 px with a
surrogate checkpoint: seeded params and EMA params at a narrow width
(input_dim 8, 4 stages: `predict_with_surrogate` builds the model at
`TrainerConfig`'s defaults, so both packages' `TrainerConfig` get the same
narrow defaults here), saved as fea_tpu's orbax checkpoint and converted
for the port by tools/convert_orbax_checkpoint.py; both predict with the
EMA weights.

Tolerances: every PNG within 1 gray level; `ranges.txt` within 1e-6
relative; the VTK's u within 1e-6 of the largest displacement (the two
refined solves agree to about 1e-8); the raster round-trip MAE and the
prediction's MAE within 3.9e-4, one gray level at the +-0.05 decode;
predicted.vtk's u within 1e-7 of fea_tpu's sampler over the port's
predicted PNGs.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from fea_tpu_torch import apps
from fea_tpu_torch.apps import runner
from fea_tpu_torch.mesh import read_vtk

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
APP, IMAGE, DIM, STAGES = "gusset", 128, 8, 4
GRAY = 0.05 * 2 / 255  # one gray level at the +-0.05 decode
PNGS = ("geometry", "outline", "constraint", "force", "displacement_x", "displacement_y",
        "predicted_displacement_x", "predicted_displacement_y")


@pytest.mark.parametrize("name", list(apps.APPLICATIONS))
def test_build_problem_matches(name):
    from fea_tpu.apps import APPLICATIONS
    from fea_tpu.apps.runner import build_problem, load_app_mesh

    mesh = runner.load_app_mesh(apps.APPLICATIONS[name])
    theirs_mesh = load_app_mesh(APPLICATIONS[name])
    np.testing.assert_array_equal(mesh.coords, theirs_mesh.coords)
    np.testing.assert_array_equal(mesh.triangles, theirs_mesh.triangles)
    ours = runner.build_problem(apps.APPLICATIONS[name], mesh)
    theirs = build_problem(APPLICATIONS[name], theirs_mesh)
    for field in ("fixed_nodes", "loads", "young", "poisson"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
    assert ours.fixed_nodes.any() and np.abs(ours.loads).sum() > 0
    assert ours.structurally_singular() == (name == "composite")


def param_shapes(modules, inputs):
    """The flax trio's param tree as shapes (traced once, nothing run)."""
    import jax

    encoder, decoder, auxiliary = modules

    def init():
        enc = encoder.init(jax.random.PRNGKey(0), *inputs)
        x, hidden, residual = encoder.apply(enc, *inputs)
        return {"encoder": enc["params"],
                "decoder": decoder.init(jax.random.PRNGKey(1), x, list(hidden), residual)["params"],
                "auxiliary": auxiliary.init(jax.random.PRNGKey(2), x)["params"]}

    with jax.enable_x64(False):
        return jax.eval_shape(init)


def seeded_params(shapes, seed):
    """A param tree of these shapes drawn from `seed`: kernels
    N(0, 1/fan_in), biases N(0, 0.1), norm scales 1 + N(0, 0.1)."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def narrow(config_cls):
    return functools.partial(config_cls, input_dim=DIM, num_stages=STAGES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' run_application(APP) with a converted checkpoint."""
    import jax
    import optax
    import orbax.checkpoint as ocp

    from fea_tpu.apps import run_application
    from fea_tpu.models import create_models
    from fea_tpu.train import trainer as jtrainer
    from fea_tpu_torch.train import trainer as ptrainer

    root = tmp_path_factory.mktemp("apps")
    S = 256  # the runner's model size
    modules = create_models(input_dim=DIM, image_height=S, image_width=S, num_channels=2,
                            num_auxiliary_condition_channels=3, num_stages=STAGES)
    inputs = (np.zeros((1, S, S, 2), np.float32), np.zeros((1, S, S, 3), np.float32))
    shapes = param_shapes(modules, inputs)
    params = seeded_params(shapes, seed=0)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    with jax.enable_x64(False):
        state = jax.device_get({
            "params": params,
            "opt_states": {k: opt.init(v) for k, v in params.items()},
            "ema_params": seeded_params(shapes, seed=1),
            "step": np.int32(7),
            "lowest_sample_loss": np.float32(np.inf),
        })
    with ocp.PyTreeCheckpointer() as checkpointer:
        checkpointer.save((root / "jax" / "model-final").absolute(), state)

    path = ROOT / "tools" / "convert_orbax_checkpoint.py"
    spec = importlib.util.spec_from_file_location("convert_orbax_checkpoint", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main([str(root / "jax" / "model-final"), str(root / "port" / "model-final"),
               "--image_size", str(S), "--input_dim", str(DIM), "--num_stages", str(STAGES)])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "TrainerConfig", narrow(jtrainer.TrainerConfig))
        mp.setattr(ptrainer, "TrainerConfig", narrow(ptrainer.TrainerConfig))
        theirs = run_application(APP, output_dir=str(root / "jax_out"), image_size=IMAGE,
                                 checkpoint=str(root / "jax" / "model-final"), use_ema=True)
        ours = apps.run_application(APP, output_dir=str(root / "port_out"), image_size=IMAGE,
                                    checkpoint=str(root / "port" / "model-final"),
                                    use_ema=True, device="cpu")
    return dict(ours=ours, theirs=theirs, root=root)


@pytest.mark.parametrize("name", PNGS)
def test_app_images_match(runs, name):
    root = runs["root"]
    ours, theirs = (np.asarray(Image.open(root / out / f"{name}.png"), dtype=np.int16)
                    for out in ("port_out", "jax_out"))
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= 1, name
    if name.startswith("predicted"):
        assert ours.std() > 0  # the surrogate put a field there


def test_app_ranges_and_vtks_match(runs):
    root = runs["root"]

    def ranges(out):
        lines = (root / out / "ranges.txt").read_text().splitlines()
        return {line.split(":")[0]: eval(line.split(":", 1)[1]) for line in lines}

    ours, theirs = ranges("port_out"), ranges("jax_out")
    assert ours.keys() == theirs.keys() == {"displacement_x_1", "displacement_y_1"}
    for key in ours:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-6, atol=0)

    ours, theirs = (read_vtk(str(root / out / f"{APP}.vtk")) for out in ("port_out", "jax_out"))
    np.testing.assert_array_equal(ours["points"], theirs["points"])
    np.testing.assert_allclose(ours["u"], theirs["u"], atol=1e-6 * np.abs(theirs["u"]).max(),
                               rtol=0)

    # predicted.vtk: fea_tpu's sampler over the port's predicted PNGs (the
    # PNGs themselves are held to fea_tpu's above; the sampler's corner
    # nudge extrapolates, so one gray level there can grow at a node)
    from fea_tpu.metrics import predicted_displacement_at_nodes

    pred = read_vtk(str(root / "port_out" / "predicted.vtk"))
    want = predicted_displacement_at_nodes(
        pred["points"], *(root / "port_out" / f"{n}.png" for n in
                          ("predicted_displacement_x", "predicted_displacement_y", "geometry")),
        image_size=256)
    np.testing.assert_allclose(pred["u"][:, :2], want, atol=1e-7, rtol=0)


def test_app_metrics_match(runs):
    ours, theirs = runs["ours"], runs["theirs"]
    # the same keys: the port keeps fea_tpu's timing names (its forward
    # includes the kernels' build where they are not built yet)
    assert ours.keys() == theirs.keys()
    assert ours["predict_wall_s"].keys() == theirs["predict_wall_s"].keys()
    assert ours["converged"] and theirs["converged"]
    assert (ours["nodes"], ours["triangles"]) == (theirs["nodes"], theirs["triangles"])
    assert abs(ours["raster_roundtrip_mae"] - theirs["raster_roundtrip_mae"]) <= GRAY
    assert ours["raster_roundtrip_mae"] < 1e-2
    for key in ("pred_mae", "pred_mse", "pred_rmse"):
        assert np.isfinite(ours[key])
    assert abs(ours["pred_mae"] - theirs["pred_mae"]) <= GRAY
    for key in ("u_min", "u_max"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-6)


def test_use_ema_without_ema_weights_raises(runs, tmp_path):
    """A checkpoint trained without EMA has no EMA weights to predict with:
    the runner says so (a ValueError, not an assert)."""
    state = torch.load(runs["root"] / "port" / "model-final" / "state.pt", weights_only=True)
    state["ema_params"] = None
    (tmp_path / "model-final").mkdir()
    torch.save(state, tmp_path / "model-final" / "state.pt")
    spec = apps.APPLICATIONS[APP]
    mesh = runner.load_app_mesh(spec)
    problem = runner.build_problem(spec, mesh)
    with pytest.raises(ValueError, match="no EMA weights"):
        runner.predict_with_surrogate(spec, mesh, problem, str(tmp_path), IMAGE,
                                      str(tmp_path / "model-final"), 0.05, use_ema=True,
                                      device="cpu")


def test_entry_points_need_a_device(monkeypatch, tmp_path):
    """Without a CUDA device and without device="cpu" the entry points
    raise before any work; nothing falls back to the CPU."""
    from fea_tpu_torch.models import convert, fdnunet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apps.run_application(APP, output_dir=str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
    spec = apps.APPLICATIONS[APP]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.predict_with_surrogate(spec, None, None, str(tmp_path), IMAGE, str(tmp_path),
                                      0.05)
    with torch.device("meta"):
        module = fdnunet.FDNUNetDecoder(8, num_stages=2, num_channels=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.load_flax(module, {})
