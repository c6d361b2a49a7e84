"""The port's data-parallel trainers on the CPU: two real gloo ranks
(spawned by fea_tpu_torch.parallel.launch, running
tests/torch_dp_workers.py) against one process of the port, and against
fea_tpu's Trainer(n_devices=2) on the virtual CPU mesh.

The regression Trainer runs at input_dim 16, 2 stages, 32 px, batch 4 x
accumulation 4 (2 rows per rank and micro-batch), 2 steps with EMA and all
three Adam chains, on tests/test_torch_train.py's dataset folder; the
DiffusionTrainer at input_dim 8, batch 4, 8 time steps, 2 steps.

Tolerances. Both ranks hold the same params, Adam moments and EMA, bit for
bit. Against one process, which sums each micro-batch's loss over 4 rows
where each rank sums 2 and the ranks then average: the loss within 1e-5
relative; the reduced gradients, read as Adam's first moment, within 1e-5
of each module's largest element; params within 2 lr x steps (Adam's first
steps turn a near-zero gradient into +-lr, so params are held loosely).
Against fea_tpu's two-device step, from the same params: the tolerances
tests/test_torch_train.py holds one device to (loss 1e-5 relative, first
moment 1e-4 and second 2e-4 of each tensor's largest element,
`assert_adam_step_close` for params and EMA).
"""

import functools
import pathlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import torch_dp_workers as workers
from fea_tpu_torch.models.convert import from_flax
from fea_tpu_torch.parallel import launch
from fea_tpu_torch.train import trainer
from fea_tpu_torch.train.trainer import MODULES
from test_torch_train import (
    LR, adam_moments, assert_adam_step_close, config_kw, flax_params, max_rel, to_numpy,
    write_dataset,
)

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]
STEPS = 2
DP = dict(train_batch_size=4, num_gradient_accumulation_steps=4,
          num_train_steps=STEPS, num_steps_per_milestone=10**9,
          num_steps_per_soft_milestone=10**9)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5  # of each module's largest gradient


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The regression run in one process and in two gloo ranks."""
    folder = write_dataset(tmp_path_factory.mktemp("fea_data"))

    def kw(tag):
        return {**config_kw(folder, tmp_path_factory.mktemp(tag)), **DP}

    one_kw, two_kw = kw("one"), kw("two")
    one = workers.regression_run(one_kw)
    two = launch(workers.regression_run, 2, (two_kw,), devices=CPU2, timeout_s=300)
    return dict(folder=folder, one_kw=one_kw, two_kw=two_kw, one=one, two=two)


def module_rel(got, want):
    """max |got - want| over max |want|, over a module's tensors."""
    num = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return num / max(float(b.abs().max()) for b in want)


def max_abs(got, want):
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def test_both_ranks_hold_the_same_state(runs):
    a, b = runs["two"]
    assert (a["world"], a["rank"], b["rank"]) == (2, 0, 1)
    for step in range(1, STEPS + 1):
        (la, sa), (lb, sb) = a["steps"][step], b["steps"][step]
        assert la == lb
        for key in MODULES:
            assert sa[key]["count"] == sb[key]["count"] == step
            for field in ("params", "mu", "nu", "ema"):
                assert all(torch.equal(x, y) for x, y in zip(sa[key][field], sb[key][field])), \
                    (step, key, field)


def test_two_ranks_match_one_process(runs):
    one, (rank0, rank1) = runs["one"], runs["two"]
    for step in range(1, STEPS + 1):
        (loss, state), (want_loss, want) = rank0["steps"][step], one["steps"][step]
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        for key in MODULES:
            assert module_rel(state[key]["mu"], want[key]["mu"]) <= GRAD_REL, (step, key)
            assert max_abs(state[key]["params"], want[key]["params"]) <= 2 * LR * step, (step, key)
    # sample_and_save: every rank's loss is the whole set's; rank 0 writes
    np.testing.assert_allclose(rank0["sample_loss"], one["sample_loss"], rtol=1e-4)
    assert rank1["sample_loss"] == rank0["sample_loss"]
    assert rank1["files"] is None and len(rank0["files"]) == len(one["files"]) == 16
    for ours, theirs in zip(rank0["files"], one["files"]):
        x = np.asarray(Image.open(ours), np.int16)
        y = np.asarray(Image.open(theirs), np.int16)
        assert np.abs(x - y).max() <= 1, ours


def test_checkpoint_written_once_and_resumed(runs):
    """Rank 0 writes the checkpoint; rank 1 joins the barriers and writes
    nothing; a 2-rank trainer resumed from it equals the state it saved."""
    rank0, rank1 = runs["two"]
    assert (rank0["saves"], rank1["saves"]) == (1, 0)
    results = pathlib.Path(runs["two_kw"]["results_folder"])
    saved = sorted(str(p.relative_to(results)) for p in results.rglob("*")
                   if p.relative_to(results).parts[0].startswith("model"))
    assert saved == ["model-final", "model-final.zip", "model-final/state.pt"]
    assert rank0["resumed_equal"] and rank1["resumed_equal"]


def jax_two_device_trainer(kw, pt):
    """fea_tpu's Trainer over 2 devices of the virtual CPU mesh, started from
    the params (and EMA) of the port's trainer `pt`."""
    from fea_tpu.train import trainer as jtrainer

    init_state = jtrainer.Trainer._init_state

    def from_port(self):
        abstract = jax.eval_shape(functools.partial(init_state, self))
        params = {k: flax_params(pt.modules[k].state_dict(), abstract.params[k]) for k in MODULES}
        state = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), abstract).replace(
            params=params, ema_params=jax.tree.map(np.copy, params),
            lowest_sample_loss=np.asarray(np.inf, np.float32))
        return jtrainer.replicate(self.mesh, state)

    cfg = jtrainer.TrainerConfig(**kw, n_devices=2)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setattr(jtrainer.Trainer, "_init_state", from_port)
        return jtrainer.Trainer(cfg)


def test_two_ranks_match_fea_tpu_on_two_devices(runs, tmp_path):
    """fea_tpu's first step over 2 devices of the virtual mesh, from the
    port's initial params, against the two ranks' first step."""
    kw = {**runs["one_kw"], "results_folder": str(tmp_path / "jax")}
    pt = trainer.Trainer(trainer.TrainerConfig(**{**kw, "results_folder": str(tmp_path / "pt")}),
                         device="cpu")
    jt = jax_two_device_trainer(kw, pt)
    assert jt.n_devices == 2
    with jax.enable_x64(False):
        state, jloss = jt._train_step(jt.state, jt._fetch_batch(0))
    loss, ours = runs["two"][0]["steps"][1]
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    for key in MODULES:
        count, mu, nu = adam_moments(state, key)
        names = pt.names[key]
        assert ours[key]["count"] == count == 1
        assert max_rel(dict(zip(names, ours[key]["mu"])), mu) < 1e-4, key
        assert max_rel(dict(zip(names, ours[key]["nu"])), nu) < 2e-4, key
        assert_adam_step_close(dict(zip(names, ours[key]["params"])),
                               from_flax(to_numpy(state.params[key])))
        assert_adam_step_close(dict(zip(names, ours[key]["ema"])),
                               from_flax(to_numpy(state.ema_params[key])), scale=0.005)


def test_diffusion_two_ranks_match_one(tmp_path):
    """The DiffusionTrainer: t and the noise drawn for the whole batch on
    every rank, each rank's rows; the same tolerances as the regression
    run's against one process; one checkpoint, written by rank 0, loads back
    bit for bit."""
    (tmp_path / "data").mkdir()
    folder = write_dataset(tmp_path / "data")

    def kw(tag):
        return dict(dataset_folder=str(folder), dataset_image_size=32, conditions_per_plate=2,
                    num_steps_per_condition=3, train_batch_size=4, train_learning_rate=LR,
                    timesteps=8, input_dim=8, num_stages=2, skip_dataset_size_check=True,
                    results_folder=str(tmp_path / tag))

    one = workers.diffusion_run(kw("one"), STEPS)
    rank0, rank1 = launch(workers.diffusion_run, 2, (kw("two"), STEPS), devices=CPU2,
                          timeout_s=300)
    for step, ((loss, mu, params), (loss1, mu1, params1), (want_loss, want_mu, want_params)) in \
            enumerate(zip(rank0["steps"], rank1["steps"], one["steps"]), start=1):
        assert loss == loss1
        assert all(torch.equal(a, b) for a, b in zip(params + mu, params1 + mu1))
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        assert module_rel(mu, want_mu) <= GRAD_REL, step
        assert max_abs(params, want_params) <= 2 * LR * step, step
    assert (rank0["saves"], rank1["saves"], one["saves"]) == (1, 0, 1)
    assert rank0["loaded_equal"] and rank1["loaded_equal"] and one["loaded_equal"]
