"""What the ranks of the data-parallel tests run (tests/test_torch_parallel.py,
test_torch_train_dp.py).

Each rank is a fresh process started by fea_tpu_torch.parallel.launch,
which imports the function it runs by name: so these functions live in a
module of their own that imports neither JAX nor the test files (which
import JAX). Called in the test's own process, outside any group, they give
the one-process run the ranks are held against. Everything runs on the
CPU, with one thread per process.
"""

from unittest import mock

import torch

from fea_tpu_torch.parallel import distributed, mesh


def _host(tensors):
    return [t.detach().cpu().clone() for t in tensors]


def regression_state(trainer) -> dict:
    """Params, Adam moments and EMA of each module, on the host."""
    out = {}
    for key, params in trainer.params.items():
        state = trainer.opt_states[key]
        out[key] = dict(params=_host(params), mu=_host(state.mu), nu=_host(state.nu),
                        count=int(state.count), ema=_host(trainer.ema_params[key]))
    return out


def regression_run(config_kw: dict) -> dict:
    """train() over the configured steps (the state after each step read by
    the per-step callback), the final checkpoint's writes counted on this
    rank, sample_and_save at milestone 'm', and a trainer resumed from the
    checkpoint compared with this one bit for bit."""
    from fea_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    trainer = Trainer(TrainerConfig(**config_kw), device="cpu")
    steps = {}

    def on_step(step, loss, *rest):
        steps[step] = (loss, regression_state(trainer))

    with mock.patch.object(torch, "save", wraps=torch.save) as save:
        trainer.train(on_step)
        saves = save.call_count
    files, _, sample_loss = trainer.sample_and_save(milestone="m")
    resumed = Trainer(TrainerConfig(**config_kw), device="cpu")
    resumed.load_checkpoint("auto")
    same = resumed.step == trainer.step and all(
        torch.equal(a, b) for a, b in zip(trainer._state_tensors(), resumed._state_tensors()))
    return dict(world=distributed.process_count(), rank=distributed.process_index(),
                steps=steps, saves=saves, files=files, sample_loss=sample_loss,
                resumed_equal=same)


def diffusion_run(config_kw: dict, steps: int) -> dict:
    """`steps` DiffusionTrainer steps (loss, first moments and params after
    each), the 'final' checkpoint's writes counted on this rank, and a
    trainer loaded from it compared with this one bit for bit."""
    from fea_tpu_torch.train.diffusion_trainer import DiffusionConfig, DiffusionTrainer

    torch.set_num_threads(1)
    trainer = DiffusionTrainer(DiffusionConfig(**config_kw), device="cpu")
    out = []
    for step in range(steps):
        x0, cond = trainer._fetch(step * trainer.config.train_batch_size)
        loss = float(trainer._train_step(x0, cond))
        out.append((loss, _host(trainer.opt_state.mu), _host(trainer.params)))
    with mock.patch.object(torch, "save", wraps=torch.save) as save:
        trainer.save_checkpoint("final")
        saves = save.call_count
    loaded = DiffusionTrainer(DiffusionConfig(**config_kw), device="cpu")
    loaded.load_checkpoint("final")
    def state(t):
        return [*t.params, *t.ema_params, *t.opt_state.mu, *t.opt_state.nu]

    same = all(torch.equal(a, b) for a, b in zip(state(trainer), state(loaded)))
    return dict(steps=out, saves=saves, loaded_equal=same)


def collectives(rank_rows: int) -> dict:
    """all_reduce_mean, gather_rows, replicate and a barrier on
    rank-dependent values on this rank's device; the results on the host."""
    torch.set_num_threads(1)
    device = distributed.local_device()
    rank, world = distributed.process_index(), distributed.process_count()
    grads = [torch.full((3,), float(rank), device=device), torch.tensor(2.0 * rank, device=device)]
    mesh.all_reduce_mean(grads)
    rows = torch.arange(rank_rows * 2, dtype=torch.float32, device=device).reshape(rank_rows, 2)
    weights = [torch.full((2, 2), float(rank + 1), device=device),
               torch.tensor(rank + 7, dtype=torch.int32, device=device)]
    mesh.replicate(weights)
    distributed.sync_processes()
    view = mesh.make_mesh(world)
    return dict(world=world, device=str(device), grads=_host(grads),
                rows=mesh.gather_rows(rows + 100 * rank), weights=_host(weights),
                view=(view.world_size, view.rank, str(view.device), view.distributed))


def fail_on_rank_one() -> int:
    if distributed.process_index() == 1:
        raise ValueError("rank 1 fails on purpose")
    return 0


def hang() -> None:
    import time

    time.sleep(600)


def skip_a_collective(timeout_s: float) -> str:
    """Rank 0 enters an all_reduce, over a group with a `timeout_s`
    timeout, that rank 1 never joins: the timeout must end it with an
    error."""
    import datetime
    import time

    group = torch.distributed.new_group(timeout=datetime.timedelta(seconds=timeout_s))
    if distributed.process_index() == 0:
        torch.distributed.all_reduce(torch.ones(1), group=group)
        return "returned"
    time.sleep(600)
    return "slept"
