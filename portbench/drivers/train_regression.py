"""Drive the regression surrogate's training loop, `Trainer.train`, as
`python -m fea_tpu_torch train` runs it: batches through the loop's own
`_fetch_batch`, the loss read one step late, no per-step callback and no
milestone.

Set-up builds one Trainer, loads the benchmark's weights into it, and
drives it through its first steps with `train()`: the state after step 1
and after step 3 is copied to the host for the check, then more steps
time a step, which fixes the window's step count. The window is one more
`train()` call over that many steps, from the call to the loop's final
`save_checkpoint`, where the harness takes the time and ends the run
instead of writing the checkpoint.

The check (after the window, the program's state freed): the reference
takes the same weights and the same rows and follows the first three
steps in strict f32. Compared, each against its limit in the
configuration file:
  grad_gap    the first step's gradient as Adam got it (its first moment after
              one step over 1 - b1), by leaf: |norm program - norm reference| over
              the larger of the reference leaf's norm and the median leaf's, the
              worst leaf; against the reference's gradient for the route of the
              output maximum's gradient that comes closest (`MAX_TIE`);
  grad_diff   the same gradient, by leaf: the norm of program - reference over the
              larger of the reference leaf's norm and the median leaf's, the median
              leaf, by its closest route: first order in rounding where a gap of
              norms is second order, so it separates a bf16 step from a TF32 one;
  update_gap  the change of the parameters over three steps, by leaf, the same way,
              over the leaves whose reference gradient is at least 1e-3 of the
              median leaf's (below that the gradient is rounding, as a bias before
              a GroupNorm, and Adam moves the leaf by its sign alone).
Each step's loss is logged beside the reference's and not compared: sound
runs and the faults overlap (PERF.md section 2).
"""

import contextlib
import time

import numpy as np
import torch

from portbench import harness, inputs
from portbench.reference import fdnunet, train as ref_train
from portbench.reference.weights import make_weights

ACTIVE = ("encoder", "decoder")
# leaves whose reference gradient norm is under this share of the median
# leaf's are left out of update_gap
ROUNDING_LEAF = 1e-3
# peaks of the output within this share of its maximum can take the
# maximum's gradient in a program whose rounding differs (TF32 moves the
# output by about 1.4e-3 of its maximum); the first gradient is compared
# with the reference's for each way of routing them (at most MAX_ROUTES
# peaks), the closest counting
MAX_TIE = 5e-3
MAX_ROUTES = 8


def _trainer(ctx, data):
    from fea_tpu_torch.train import Trainer, TrainerConfig

    model, train = ctx.config["model"], ctx.config["train"]
    config = TrainerConfig(
        dataset_image_size=model["image_size"],
        input_dim=model["input_dim"],
        num_stages=model["num_stages"],
        num_channels=model["num_channels"],
        num_auxiliary_condition_channels=model["num_auxiliary_condition_channels"],
        train_batch_size=ctx.traffic["batch"],
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
    return Trainer(config, dataset=data, sample_dataset=data, device=ctx.device)


def _host(tensors):
    return [t.detach().to("cpu", copy=True) for t in tensors]


def run(ctx) -> harness.Outcome:
    device, traffic = ctx.device, ctx.traffic
    batch, checked = traffic["batch"], traffic["checked_steps"]
    reference = fdnunet.build(ctx.config)
    weights = make_weights(reference, ctx.seed, device)
    data = inputs.FEASamples(traffic["samples"], ctx.config["model"]["image_size"], ctx.seed,
                             device)
    trainer = _trainer(ctx, data)
    for key in ACTIVE:
        trainer.modules[key].load_state_dict(weights[key])
    # kept on the host until the check, out of the program's memory peak
    weights = {k: {n: t.cpu() for n, t in w.items()} for k, w in weights.items()}

    losses = []
    step = trainer._train_step

    def recording_step(b):
        loss = step(b)
        losses.append(loss)
        return loss

    trainer._train_step = recording_step
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
    reads = list(data.reads)
    rows = [reads[i * batch:(i + 1) * batch] for i in range(checked)]

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

        _, gn = kernels.call_shapes(ctx.config, batch)
        facts["flops"] = steps * flops.train_step_flops(ctx.config, batch)
        facts["gn_bwd_bytes"] = steps * sum(kernels.gn_silu_bwd_call(*s) for s in gn)
    return harness.Outcome(
        attempted=attempted, failed=failed,
        metrics={"train_step_ms": 1e3 * window_s / steps, "setup_s": setup_s},
        memory_peak_bytes=memory_peak, checks=checks, facts=facts, trace=trace,
        host_trace=host_trace,
    )


def _norms(tensors):
    return np.array([float(torch.linalg.vector_norm(t.double())) for t in tensors])


def _gaps(program, reference, keep=None):
    """By leaf, |program - reference| / max(reference, median reference),
    the median over the leaves in `keep`; left-out leaves read 0."""
    keep = np.ones(len(reference), bool) if keep is None else keep
    floor = np.median(reference[keep])
    return np.where(keep, np.abs(program - reference) / np.maximum(reference, floor), 0.0)


def _relative(diff, reference):
    """By leaf, the norm of program - reference (`diff`) over the larger of
    the reference leaf's norm and the median leaf's."""
    return diff / np.maximum(reference, np.median(reference))


def _check(ctx, reference, weights, data, rows, program_losses, first_moment, after):
    device, train = ctx.device, ctx.config["train"]
    limits = ctx.config["correct_limits"]
    flat_rows = [i for r in rows for i in r]
    if len(set(flat_rows)) != len(flat_rows):
        harness.log(f"train_regression: the checked steps' rows repeat: {flat_rows}")
        return [("distinct_rows", 1.0, 0.0)]

    names = [f"{k}.{n}" for k in ACTIVE for n, _ in reference[k].named_parameters()]
    restore = fdnunet.strict_f32()
    try:
        for key, module in reference.items():
            module.load_state_dict({k: v.to(device, copy=True) for k, v in weights[key].items()},
                                   assign=True)
        batches = [data.batch(r, device) for r in rows]
        with torch.no_grad():
            raw = fdnunet.regression_output(reference["encoder"], reference["decoder"], batches[0])
        argmax, alternates, ties = ref_train.max_routes(raw, MAX_TIE, MAX_ROUTES)
        sizes = [(len(list(reference[k].parameters())), train["max_gradient_norm"])
                 for k in ACTIVE]
        b1 = train["adam_betas"][0]
        program_g = [(first_moment[n] / (1.0 - b1)).to(device) for n in names]
        choices = {}
        for label, g in ref_train.route_choices(reference, batches[0], argmax, alternates):
            g = ref_train.clip_modules(g, sizes)
            choices[label] = (_norms(g), _norms(a - b for a, b in zip(program_g, g)))
        del program_g
        ref_losses = ref_train.train_steps(
            reference, batches, train["learning_rate"], train["adam_betas"],
            train["max_gradient_norm"])
    finally:
        restore()
    ref_after = [p.detach() for k in ACTIVE for p in reference[k].parameters()]
    start = [weights[k][n].to(device) for k in ACTIVE for n, _ in reference[k].named_parameters()]
    ref_g = choices["argmax"][0]

    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(program_losses, ref_losses)]
    prog_g = _norms(first_moment[n] / (1.0 - b1) for n in names)
    # the reference's first gradient by each route of the output maximum's
    # gradient that rounding can take; each number is held to its closest
    by_route = {label: _gaps(prog_g, norms) for label, (norms, _) in choices.items()}
    route = min(by_route, key=lambda label: by_route[label].max())
    grad_gaps = by_route[route]
    diffs = {label: _relative(diff, norms) for label, (norms, diff) in choices.items()}
    diff_route = min(diffs, key=lambda label: np.median(diffs[label]))
    grad_diff = float(np.median(diffs[diff_route]))
    keep = ref_g >= ROUNDING_LEAF * np.median(ref_g)
    ref_d = _norms(a - s for a, s in zip(ref_after, start))
    prog_d = _norms(after[n].to(device) - s for n, s in zip(names, start))
    update_gaps = _gaps(prog_d, ref_d, keep)
    worst_g, worst_d = int(np.argmax(grad_gaps)), int(np.argmax(update_gaps))
    harness.log(
        f"train_regression: losses program {program_losses} reference {ref_losses}, "
        f"gaps {loss_gaps}; worst grad leaf {names[worst_g]} {grad_gaps[worst_g]:.3e} "
        f"(norm {ref_g[worst_g]:.3e}, median {np.median(ref_g):.3e}), median leaf "
        f"{np.median(grad_gaps):.3e}; worst update leaf {names[worst_d]} "
        f"{update_gaps[worst_d]:.3e} (change {ref_d[worst_d]:.3e} vs {prog_d[worst_d]:.3e}, "
        f"median {np.median(ref_d[keep]):.3e}), median leaf {np.median(update_gaps[keep]):.3e}; "
        f"{int((~keep).sum())} of {len(keep)} leaves at rounding left out; {ties} peaks within "
        f"{MAX_TIE} of an output maximum, {len(by_route)} routes tried, {route} closest "
        f"(argmax: {by_route['argmax'].max():.3e}); grad_diff {grad_diff:.3e} by {diff_route}, "
        f"worst leaf {diffs[diff_route].max():.3e}")
    return [
        ("grad_gap", float(grad_gaps[worst_g]), limits["grad_gap"]),
        ("grad_diff", grad_diff, limits["grad_diff"]),
        ("update_gap", float(update_gaps[worst_d]), limits["update_gap"]),
    ]
