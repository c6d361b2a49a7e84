"""The port's regression training path (fea_tpu_torch.train.trainer,
fea_tpu_torch.data) against fea_tpu's on the CPU, at 32 px, input_dim 16,
2 stages.

One Trainer step (batch 8 x accumulation 2, all three Adam chains, EMA)
runs in both packages from the same params (the port's seeded init, handed
to fea_tpu through convert's leaf mapping) and the same batch, which both trainers
fetch from one small dataset folder written here in the reference's
on-disk layout. tests/test_torch_diffusion_train.py does the same for the
DiffusionTrainer.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fea_tpu.data import dataset as jdataset
from fea_tpu.train import trainer as jtrainer
from fea_tpu_torch.data import dataset
from fea_tpu_torch.models.convert import _convert_leaf, from_flax
from fea_tpu_torch.train import trainer
from fea_tpu_torch.train.trainer import MODULES

torch.set_num_threads(1)

S, DIM, STAGES, BATCH, ACCUM, LR = 32, 16, 2, 8, 2, 3e-4
PLATES, CONDITIONS, STEPS = 2, 2, 3  # 2 x 2 x (3 - 1) = 8 samples
ROUNDING = 2.0 ** -22  # two f32 roundings, relative


def write_dataset(root, size=40, seed=0):
    """PNGs, magnitudes, materials and ranges in the reference's layout
    (fea_tpu/data/dataset.py), drawn from `seed`; `size` differs from S so
    that the bilinear resize runs."""
    rng = np.random.default_rng(seed)

    def png(path, mask=False):
        if mask:  # dark (inked) where the region is
            pixels = np.where(rng.random((size, size)) < 0.3, 0, 255)
        else:
            pixels = rng.integers(0, 256, (size, size))
        Image.fromarray(pixels.astype(np.uint8), "L").save(path)

    for plate in range(1, PLATES + 1):
        pdir = root / str(plate)
        pdir.mkdir()
        png(pdir / "input.png", mask=True)
        for condition in range(1, CONDITIONS + 1):
            cdir = pdir / str(condition)
            cdir.mkdir()
            for name in ("outputs_displacement_x", "outputs_displacement_y"):
                png(cdir / f"{name}.png")
            for name in ("Constraint_0", "regions_Edge_0", "regions_Vertex_1",
                         "regions_Material_0"):
                png(cdir / f"{name}.png", mask=True)
            fx, fy, vy = rng.normal(0, 100, 3)
            (cdir / "magnitudes.txt").write_text(
                f"Edge_0: ({fx}, {fy})\nVertex_1: (0.0, {vy})\n"
            )
            (cdir / "materials.txt").write_text(f"Material_0: ({rng.uniform(2e4, 4e5)}, 0.3)\n")
            ranges = "".join(
                f"displacement_{axis}_{step}: ({-rng.random()}, {rng.random()})\n"
                for step in range(1, STEPS) for axis in "xy"
            )
            (cdir / "ranges.txt").write_text(ranges)
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("fea_data"))


def config_kw(folder, results):
    return dict(
        dataset_folder=str(folder), sample_dataset_folder=str(folder),
        dataset_image_size=S, train_batch_size=BATCH,
        num_gradient_accumulation_steps=ACCUM, num_train_steps=1,
        num_steps_per_condition=STEPS, num_steps_per_sample_condition=STEPS,
        conditions_per_plate=CONDITIONS, num_sample_conditions_per_plate=CONDITIONS,
        skip_dataset_size_check=True, input_dim=DIM, num_stages=STAGES,
        disable_auxiliary=False, use_ema=True, train_learning_rate=LR, seed=0,
        results_folder=str(results), progress_bar=False,
    )


def port_trainer(folder, tmp_path, tag, **kw):
    cfg = trainer.TrainerConfig(**{**config_kw(folder, tmp_path / tag), **kw})
    return trainer.Trainer(cfg, device="cpu")


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def flax_params(state_dict, abstract):
    """A port state dict as a flax param tree shaped like `abstract`:
    convert.from_flax's leaf mapping, run backwards."""
    def leaf(path, a):
        index = np.arange(int(np.prod(a.shape))).reshape(a.shape)
        key, moved = _convert_leaf(".".join(str(p.key) for p in path), index)
        out = np.empty(index.size, np.float32)
        out[np.asarray(moved).ravel()] = state_dict[key].detach().numpy().ravel()
        return out.reshape(a.shape)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def jax_trainer(folder, results, pt, **kw):
    """fea_tpu's Trainer started from the params (and EMA) of the port's
    trainer `pt`. Its own init would run op by op: some 200 small XLA
    compiles, 10-30 s on one core; here it is traced, not run, for the
    state's structure, and filled from the port."""
    init_state = jtrainer.Trainer._init_state

    def from_port(self):
        abstract = jax.eval_shape(functools.partial(init_state, self))
        params = {k: flax_params(pt.modules[k].state_dict(), abstract.params[k])
                  for k in MODULES}
        state = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), abstract).replace(
            params=params,
            ema_params=jax.tree.map(np.copy, params),
            lowest_sample_loss=np.asarray(np.inf, np.float32),
        )
        return jtrainer.replicate(self.mesh, state)

    cfg = jtrainer.TrainerConfig(**config_kw(folder, results), n_devices=1, **kw)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setattr(jtrainer.Trainer, "_init_state", from_port)
        return jtrainer.Trainer(cfg)


def adam_moments(jax_state, key):
    """(count, mu, nu) of fea_tpu's Adam chain for `key`, as state dicts."""
    adam = jax_state.opt_states[key][1][0]
    return int(adam.count), from_flax(to_numpy(adam.mu)), from_flax(to_numpy(adam.nu))


def port_moments(pt, key):
    state = pt.opt_states[key]
    names = pt.names[key]
    return int(state.count), dict(zip(names, state.mu)), dict(zip(names, state.nu))


def max_rel(got: dict, want: dict):
    return max(
        float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
        for k in want
    )


def assert_adam_step_close(got: dict, want: dict, scale: float = 1.0):
    """Params after one Adam step from equal params. The first step moves
    each element by lr g / (|g| + 1e-8): where |g| is near 1e-8, a 1e-4
    relative difference in g moves the element by a visible fraction of lr
    (a flipped sign: 2 lr). Bound, beyond two f32 roundings of the value:
    every element within 2 lr, and no more than 1 in 10^3 beyond lr / 1000
    (times `scale`)."""
    err = torch.cat([
        ((got[k] - want[k]).abs() - ROUNDING * want[k].abs()).flatten() for k in want
    ])
    assert float(err.max()) <= 2 * LR * scale, float(err.max())
    assert float((err > 1e-3 * LR * scale).float().mean()) <= 1e-3


def test_dataset_and_sampler_match_fea_tpu(folder):
    """The port's copy of FEADataset gives the same arrays (exactly) and
    EpochSampler the same order as fea_tpu's, from the same folder and seed."""
    kw = dict(image_size=S, conditions_per_plate=CONDITIONS, num_steps=STEPS)
    ours, theirs = dataset.FEADataset(str(folder), **kw), jdataset.FEADataset(str(folder), **kw)
    assert len(ours) == len(theirs) == PLATES * CONDITIONS * (STEPS - 1)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert np.abs(ours[1]["forces"]).max() > 0
    for seed in (0, 3):
        np.testing.assert_array_equal(
            dataset.EpochSampler(len(ours), seed).indices_at(5, 37),
            jdataset.EpochSampler(len(ours), seed).indices_at(5, 37),
        )


def test_trainer_step_matches_fea_tpu(folder, tmp_path):
    """One f32 step from the same params and batch. Tolerances:
    - loss: rtol 1e-5 (summation order only);
    - each module's gradient, read as Adam's first moment after the first
      step ((1 - b1) x the clipped gradient): relative 1e-4 of its largest
      element, fea_tpu's VJP bound (the second moment, g^2, 2e-4);
    - params after the step: see assert_adam_step_close;
    - EMA: 0.995 p0 + 0.005 p1, so the same bound scaled by 0.005."""
    pt = port_trainer(folder, tmp_path, "f32")
    jt = jax_trainer(folder, tmp_path / "jax", pt)
    with jax.enable_x64(False):
        jbatch = jt._fetch_batch(0)
        state, jloss = jt._train_step(jt.state, jbatch)
    pbatch = pt._fetch_batch(0)
    for key in jbatch:
        np.testing.assert_array_equal(pbatch[key].numpy(), np.asarray(jbatch[key]))
    loss = pt._train_step(pbatch)
    assert pt.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    for key in MODULES:
        count, mu, nu = adam_moments(state, key)
        pcount, pmu, pnu = port_moments(pt, key)
        assert pcount == count == 1
        assert max_rel(pmu, mu) < 1e-4, key
        assert max_rel(pnu, nu) < 2e-4, key  # (1 - b2) g^2: twice g's error
        assert_adam_step_close(pt.modules[key].state_dict(),
                               from_flax(to_numpy(state.params[key])))
        assert_adam_step_close(dict(zip(pt.names[key], pt.ema_params[key])),
                               from_flax(to_numpy(state.ema_params[key])), scale=0.005)


def snapshot(pt):
    sd = pt.state_dict()
    flat = {}
    for part in ("params", "opt_states", "ema_params"):
        for key, value in sd[part].items():
            items = value.items() if isinstance(value, dict) else enumerate(value)
            for name, t in items:
                if isinstance(t, list):
                    flat.update({(part, key, name, i): x.clone() for i, x in enumerate(t)})
                else:
                    flat[(part, key, name)] = t.clone()
    return flat


def test_non_finite_guard_skips_update(folder, tmp_path):
    """A NaN in the batch leaves params, Adam moments and count, and EMA
    bit for bit as they were; the step counter advances; a clean batch then
    updates."""
    pt = port_trainer(folder, tmp_path, "guard")
    batch = pt._fetch_batch(0)
    bad = dict(batch)
    bad["forces"] = batch["forces"].clone()
    bad["forces"][0, 0] = float("nan")
    before = snapshot(pt)
    loss = pt._train_step(bad)
    assert not np.isfinite(float(loss))
    after = snapshot(pt)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert pt.step == 1
    assert np.isfinite(float(pt._train_step(batch)))
    assert any(not torch.equal(before[k], v) for k, v in snapshot(pt).items())


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_transfer_packing_round_trip(folder, tmp_path, dtype):
    """pack_transfers ships +-1 masks as int8 and, under bf16 compute,
    forces and materials as bf16; unpacked, the model sees bit-identical
    inputs to the unpacked batch's."""
    packed = port_trainer(folder, tmp_path, f"p{dtype}", compute_dtype=dtype)
    plain = port_trainer(folder, tmp_path, f"u{dtype}", compute_dtype=dtype,
                         pack_transfers=False)
    a, b = packed._fetch_batch(0), plain._fetch_batch(0)
    assert a["geometry"].dtype == a["constraints"].dtype == torch.int8
    assert b["geometry"].dtype == torch.float32
    model_dtype = torch.bfloat16 if dtype else torch.float32
    ua, ub = packed._unpack_transfer(a), plain._unpack_transfer(b)
    for key in ub:
        got, want = ua[key], ub[key]
        if key in ("forces", "materials"):
            got, want = got.to(model_dtype), want.to(model_dtype)
        assert got.dtype == want.dtype, key
        assert torch.equal(got, want), key


def test_checkpoint_rotation_zip_and_auto_resume(folder, tmp_path):
    """best / latest (rotated to latest-prev) / final with zips; 'auto'
    resumes from the highest step, bit-exactly; a zip alone restores; EMA
    presence mismatches adapt one way and raise the other."""
    pt = port_trainer(folder, tmp_path, "ckpt")
    res = pt.results_folder
    assert pt._newest_milestone() is None
    pt.load_checkpoint("auto")  # nothing saved yet: starts fresh
    pt._train_step(pt._fetch_batch(0))
    pt.save_checkpoint("best")
    pt.step = 7
    pt.save_checkpoint("latest")
    pt.save_checkpoint("latest")
    assert (res / "model-latest-prev").is_dir() and (res / "model-latest-prev.zip").exists()
    assert pt._newest_milestone() == "latest"
    saved = snapshot(pt)

    other = port_trainer(folder, tmp_path, "ckpt")
    other.load_checkpoint("auto")
    assert other.step == 7
    loaded = snapshot(other)
    assert saved.keys() == loaded.keys()
    for k in saved:
        assert torch.equal(saved[k], loaded[k]), k

    import shutil

    shutil.rmtree(res / "model-best")
    raw = port_trainer(folder, tmp_path, "ckpt", use_ema=False, inference_only=True)
    raw.load_checkpoint("best")  # from the zip; the EMA weights are dropped
    assert raw.step == 1 and raw.ema_params is None
    raw.save_checkpoint("final")
    with pytest.raises(ValueError, match="no EMA"):
        port_trainer(folder, tmp_path, "ckpt").load_checkpoint("final")


def test_remat_loss_matches_plain(folder, tmp_path):
    """remat_loss recomputes each micro-batch's forward in the backward: the
    same arithmetic, so the same loss and params, bit for bit, from the
    same init and batch."""
    remat = port_trainer(folder, tmp_path, "remat", remat_loss=True)
    plain = port_trainer(folder, tmp_path, "plain")
    assert float(remat._train_step(remat._fetch_batch(0))) == float(
        plain._train_step(plain._fetch_batch(0)))
    for key in MODULES:
        assert all(torch.equal(a, b) for a, b in zip(remat.params[key], plain.params[key]))


def test_train_loop_milestones_and_samples(folder, tmp_path):
    """train(): the per-step callback sees each step's loss; a milestone
    samples (PNG and range text per sample) and saves best or latest, a
    soft milestone samples without saving, and the end saves final."""
    pt = port_trainer(folder, tmp_path, "loop", num_train_steps=2,
                      num_steps_per_milestone=2, num_steps_per_soft_milestone=1)
    seen = []
    pt.train(lambda step, loss, sample_loss, files, ranges, milestone: seen.append(
        (step, loss, sample_loss, milestone)))
    assert [s[0] for s in seen] == [1, 2] and all(np.isfinite(s[1]) for s in seen)
    assert np.isfinite(seen[0][2]) and seen[0][3] is None and seen[1][3] == "best"
    res = pt.results_folder
    for name in ("model-best", "model-final", "1/1/sample_x_1.png", "1/1/sample_y_2.txt"):
        assert (res / name).exists(), name
    assert pt.step == 2 and pt.lowest_sample_loss == seen[1][2]


def test_train_loop_aborts_on_a_streak_of_skipped_steps(folder, tmp_path, monkeypatch):
    """Every step poisoned: the guard skips each, and the loop stops after
    NAN_STREAK_LIMIT of them in a row (50; 2 here) instead of running on."""
    monkeypatch.setattr(trainer, "NAN_STREAK_LIMIT", 2)
    pt = port_trainer(folder, tmp_path, "streak", num_train_steps=5)
    poisoned = pt._pack_transfer

    def pack(batch):
        out = poisoned(batch)
        out["forces"] = torch.full_like(out["forces"], float("nan"))
        return out

    pt._pack_transfer = pack
    with pytest.raises(RuntimeError, match="non-finite"):
        pt.train()
    assert pt.step < 5


def test_later_slices_raise(folder, tmp_path):
    """Every slice is ported (multi-GPU: tests/test_torch_train_dp.py); two
    devices asked of a process in no process group raise and say how to
    launch the ranks, where no silent single device may stand in."""
    with pytest.raises(ValueError, match="no process group.*torchrun --nproc_per_node 2"):
        port_trainer(folder, tmp_path, "later", n_devices=2)
