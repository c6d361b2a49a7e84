"""Drive the regression surrogate's training loop, `Trainer.train`, from a
condition store (`data/store.py`) held on the card, as `python -m
fea_tpu_torch train --dataset_store DIR --device_resident_store` runs it:
the store's tables uploaded once (`data/device_store.py`), each step's
batch assembled on the device from index vectors, the loss read one step
late, no per-step callback and no milestone.

Set-up writes a store of the traffic's plates, conditions and steps (256
rows at 16 plates x 4 conditions x 4 steps) into the run's temporary
directory with `ConditionStoreBuilder`, drawn from the seed so that its
rows, as the Trainer decodes them, follow `train-b16`'s as far as a store
holds them: each plate's geometry mask (70% on the plate), each
condition's constraint mask (5%), its displacement as the store's uint8
gray levels of tanh(N(0, 1)), the per-step displacement ranges N(0, 1),
and its forces and materials N(0, 1) on the plate as per-pixel winners
among the traffic's regions (each pixel of the plate one region's, drawn
uniformly): a region's Young's modulus sign(z) (e^|z| - 1) and Poisson's
ratio z', so that the decoded log-scaled modulus is z, and its force
sign(z) (e^|z| - 1) (S - 1) / (S - 2) for S steps, whose decoded
log-scaled ramp reaches z at the last step (and is 0 at the first, as
every store's is). Then, as `train_regression` does, one Trainer built
from the store (`dataset_store`, `device_resident_store=True`), the
benchmark's weights loaded, its first steps run for the check and a few
more to time a step, which fixes the window's step count; the window is
one more `train()` call over that many steps, from the call to the loop's
final `save_checkpoint`.

The check (after the window, the program's state freed) is
`train_regression`'s, with its limits: the reference follows the first
three steps in strict f32 on the rows the Trainer's sampler chose, read
from the store on the host (`StoredFEADataset`, which the device assembly
matches bit for bit).
"""

import contextlib
import time

import numpy as np
import torch

from portbench import harness, inputs
from portbench.drivers.train_regression import ACTIVE, _check, _host
from portbench.reference import fdnunet
from portbench.reference.weights import make_weights, stream_seed

IMAGE_KEYS = ("materials", "forces", "constraints", "geometry", "displacement")


def write_store(ctx, path) -> None:
    """The traffic's store, drawn from the seed on the run's device and
    written with `ConditionStoreBuilder` (module docstring)."""
    from fea_tpu_torch.data.store import ConditionStoreBuilder

    traffic, size = ctx.traffic, ctx.config["model"]["image_size"]
    plates, per_plate, steps = (traffic["plates"], traffic["conditions_per_plate"],
                                traffic["num_steps"])
    forces, materials = traffic["force_regions"], traffic["material_regions"]
    n = plates * per_plate
    g = torch.Generator(device=ctx.device).manual_seed(stream_seed(ctx.seed, inputs.DATA_STREAM))

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=ctx.device)

    def winners(regions, plate):
        drawn = torch.randint(0, regions, (n, size, size, 2), generator=g, device=ctx.device)
        return torch.where(plate[..., None] > 0, drawn, -1).to(torch.int8)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=ctx.device, dtype=torch.float64)

    def unlogged(z):
        # sign(v) log(|v| + 1) = z
        return torch.sign(z) * torch.expm1(z.abs())

    geometry = (uniform(plates, size, size) < 0.7).to(torch.uint8)
    plate = geometry.repeat_interleave(per_plate, dim=0)
    gray = torch.tanh(torch.randn((n, size, size, 2), generator=g, device=ctx.device))
    builder = ConditionStoreBuilder(str(ctx.tmpdir / "images"), str(path), plates, size,
                                    per_plate, steps)
    builder.geometry[:] = geometry.cpu().numpy()
    builder.constraints[:] = (uniform(n, size, size) < 0.05).to(torch.uint8).cpu().numpy()
    builder.displacement[:] = torch.round(255.0 * (1.0 - (gray + 1.0) / 2.0)).to(
        torch.uint8).cpu().numpy()
    builder.force_winner[:] = winners(forces, plate).cpu().numpy()
    builder.mat_winner[:] = winners(materials, plate).cpu().numpy()
    # the store's last sample step is steps - 1, whose ramp is (steps - 2) / (steps - 1)
    ramp = (steps - 1) / (steps - 2)
    builder.force_vals[:, :forces] = (unlogged(normal(n, forces, 2)) * ramp).cpu().numpy()
    builder.mat_vals[:, :materials, 0] = unlogged(normal(n, materials)).cpu().numpy()
    builder.mat_vals[:, :materials, 1] = normal(n, materials).cpu().numpy()
    builder.ranges[:] = torch.randn(builder.ranges.shape, generator=g, device=ctx.device
                                    ).cpu().numpy()
    builder.done[:] = 1
    builder.flush()


class StoreRows:
    """The store's rows as the reference takes them: `batch(indices,
    device)`, the model's inputs and target of those rows, f32."""

    def __init__(self, dataset):
        self.dataset = dataset

    def batch(self, indices, device) -> dict:
        rows = [self.dataset[int(i)] for i in indices]
        return {k: torch.from_numpy(np.stack([r[k] for r in rows])).to(device)
                for k in IMAGE_KEYS}


def _trainer(ctx, store):
    from fea_tpu_torch.data.store import StoredFEADataset
    from fea_tpu_torch.train import Trainer, TrainerConfig

    model, train, traffic = ctx.config["model"], ctx.config["train"], ctx.traffic
    config = TrainerConfig(
        dataset_store=str(store),
        device_resident_store=True,
        conditions_per_plate=traffic["conditions_per_plate"],
        num_steps_per_condition=traffic["num_steps"],
        dataset_image_size=model["image_size"],
        input_dim=model["input_dim"],
        num_stages=model["num_stages"],
        num_channels=model["num_channels"],
        num_auxiliary_condition_channels=model["num_auxiliary_condition_channels"],
        train_batch_size=traffic["batch"],
        train_learning_rate=train["learning_rate"],
        adam_betas=tuple(train["adam_betas"]),
        max_gradient_norm=train["max_gradient_norm"],
        loss_type=train["loss_type"],
        disable_auxiliary=train["disable_auxiliary"],
        use_ema=train["use_ema"],
        compute_dtype="bfloat16" if ctx.control else None,
        num_steps_per_milestone=10**9,
        num_steps_per_soft_milestone=10**9,
        progress_bar=False,
        results_folder=str(ctx.tmpdir / "results"),
    )
    return Trainer(config, sample_dataset=StoredFEADataset(str(store)), device=ctx.device)


def run(ctx) -> harness.Outcome:
    device, traffic = ctx.device, ctx.traffic
    checked = traffic["checked_steps"]
    reference = fdnunet.build(ctx.config)
    weights = make_weights(reference, ctx.seed, device)
    store = ctx.tmpdir / "store"
    write_store(ctx, store)
    trainer = _trainer(ctx, store)
    if trainer.device_tables is None:
        raise RuntimeError("train_regression_store: the store's tables were not uploaded")
    data = StoreRows(trainer.dataset)
    for key in ACTIVE:
        trainer.modules[key].load_state_dict(weights[key])
    # kept on the host until the check, out of the program's memory peak
    weights = {k: {n: t.cpu() for n, t in w.items()} for k, w in weights.items()}

    losses, chosen = [], []
    step = trainer._train_step
    indices_at = trainer.sampler.indices_at

    def recording_step(b):
        loss = step(b)
        losses.append(loss)
        return loss

    def recording_indices(offset, count):
        rows = indices_at(offset, count)
        chosen.append(rows.tolist())
        return rows

    trainer._train_step = recording_step
    trainer.sampler.indices_at = recording_indices
    trainer.save_checkpoint = lambda milestone: None  # no checkpoint in set-up

    def train_to(n):
        trainer.config.num_train_steps = n
        trainer.train()

    names = [f"{k}.{n}" for k in ACTIVE for n in trainer.names[k]]
    train_to(1)
    first_moment = dict(zip(names, _host(m for k in ACTIVE for m in trainer.opt_states[k].mu)))
    train_to(checked)
    after = dict(zip(names, _host(p for k in ACTIVE for p in trainer.params[k])))
    program_losses = [float(v) for v in losses[:checked]]
    rows = chosen[:checked]
    trainer.sampler.indices_at = indices_at

    harness.synchronize(device)
    t0 = time.perf_counter()
    train_to(checked + traffic["warmup_steps"])
    harness.synchronize(device)
    step_s = (time.perf_counter() - t0) / traffic["warmup_steps"]
    steps = max(1, round(ctx.window_seconds / step_s))

    stamp = {}

    def end_of_window(milestone):
        harness.synchronize(device)
        stamp["t"] = time.perf_counter()

    def window(n, tracer=None):
        """train() over n more steps: the seconds from the call to the
        loop's final save_checkpoint."""
        trainer.config.num_train_steps = trainer.step + n
        with tracer if tracer is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            trainer.train()
        return stamp["t"] - t0

    trainer.save_checkpoint = end_of_window
    del losses[:]
    setup_s = harness.end_of_setup(ctx)

    trace = host_trace = None
    facts = {"steps": steps}
    if ctx.trace:
        from portbench.tracing import Trace

        trace, host_trace = Trace(host_ops=False), Trace(host_ops=True)
        window_s = window(steps, trace)
        facts["host_steps"] = max(1, round(ctx.host_window_seconds / step_s))
        window(facts["host_steps"], host_trace)
    else:
        window_s = window(steps)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    attempted = len(losses)

    del trainer, step, recording_step, losses
    harness.after_window()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = _check(ctx, reference, weights, data, rows, program_losses, first_moment, after)
    if ctx.trace:
        from portbench.counts import flops, kernels

        batch = traffic["batch"]
        _, gn = kernels.call_shapes(ctx.config, batch)
        facts["flops"] = steps * flops.train_step_flops(ctx.config, batch)
        facts["gn_bwd_bytes"] = steps * sum(kernels.gn_silu_bwd_call(*s) for s in gn)
    return harness.Outcome(
        attempted=attempted, failed=failed,
        metrics={"train_step_ms": 1e3 * window_s / steps, "setup_s": setup_s},
        memory_peak_bytes=memory_peak, checks=checks, facts=facts, trace=trace,
        host_trace=host_trace,
    )
