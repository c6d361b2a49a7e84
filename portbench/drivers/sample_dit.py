"""Drive DiT's learned-range sampler (`make_dit_diffusion_model(...).sample`,
`GaussianDiffusion.sample`) as a served model: a closed loop of one client,
as `sample_adm` drives ADM (whose helpers this driver shares). Each request
is one call at the shipped precision (TF32 convolutions and matmuls, the
precision DiT declares) on a batch of condition stacks uploaded from the
host, over the respaced steps, its noise from a generator seeded per
request, and its output fetched to the host.

Set-up builds the model (a program without `make_dit_diffusion_model`
fails here, before any run), loads the benchmark's weights (every
parameter drawn from the seed, the ones DiT initializes to zero too; the
position table is the program's own), draws the requests' conditions and
runs one request that the window does not count: it builds the kernels,
lets cuDNN and cuBLAS pick their algorithms, captures the step's CUDA
graph and times a request. The requests to check are drawn from the seed
among those that the window is sure to finish; a forward hook keeps those
requests' model inputs and outputs. The program's counters
`GaussianDiffusion.learned_range_steps`, `.final_steps` and
`flash_attention.launches_d72` are read around the traced window, where
the program has them.

The check (after the window, the program's state freed) follows each
checked request step by step from the program's own states, in strict
f32 (`reference/dit.py`, `reference/adm_diffusion.py`), the reference's
forwards in blocks of REFERENCE_BLOCK images:
  pred_gap  the larger of max |eps - reference| / max |reference| and the
            same of v, over the steps, the reference handed the program's
            x_i and the original t of step i;
  step_gap  max |next state - reference update| / max |reference update|
            over the steps, the update from the program's x_i and output,
            the request's noise drawn again from its seed; the initial
            noise and the output on the host included.
"""

import contextlib
import math
import time

import numpy as np
import torch

from portbench import harness, inputs
from portbench.drivers.sample_adm import REFERENCE_BLOCK, _counters, _forwards, _halves_gap
from portbench.drivers.sample_ddpm import WARMUP_REQUEST, _gap
from portbench.reference import adm_diffusion as ref_diffusion, dit as ref_dit
from portbench.reference.weights import make_weights, stream_seed


def _program(ctx):
    from fea_tpu_torch.models import make_dit_diffusion_model

    model = ctx.config["model"]
    return make_dit_diffusion_model(
        image_size=model["image_size"], timesteps=model["timesteps"],
        beta_schedule=model["beta_schedule"], device=ctx.device,
        generator=torch.Generator(device=ctx.device).manual_seed(stream_seed(ctx.seed, 3)),
        patch_size=model["patch_size"],
        in_channels=model["num_channels"] + model["num_auxiliary_condition_channels"],
        out_channels=2 * model["num_channels"], hidden_size=model["hidden_size"],
        depth=model["depth"], num_heads=model["num_heads"], mlp_ratio=model["mlp_ratio"],
    )


def _flash_d72():
    """The program's count of flash calls at head dim 72, or None where it
    has none."""
    from fea_tpu_torch.ops.flash_attention import flash_attention

    return getattr(flash_attention, "launches_d72", None)


def _load(model, weights):
    """The benchmark's weights into the program; its position table stays
    its own."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if missing != ["pos_embed"] or unexpected:
        raise RuntimeError(f"sample_dit: the program's state dict differs from the reference's: "
                           f"missing {missing}, unexpected {unexpected}")


def run(ctx) -> harness.Outcome:
    device, traffic, model = ctx.device, ctx.traffic, ctx.config["model"]
    batch, steps, size = traffic["batch"], traffic["denoising_steps"], model["image_size"]
    channels = model["num_auxiliary_condition_channels"]
    reference = ref_dit.build(ctx.config)
    weights = make_weights(reference, ctx.seed, device)
    diffusion = _program(ctx)
    _load(diffusion.model, weights["model"])
    diffusion.model.eval()
    weights = {k: {n: t.cpu() for n, t in w.items()} for k, w in weights.items()}

    def condition(k):
        return inputs.request_condition(ctx.seed, k, batch, size, channels, device)

    warm = condition(WARMUP_REQUEST)
    harness.synchronize(device)
    t0 = time.perf_counter()
    diffusion.sample(warm.to(device), steps, generator=inputs.request_generator(
        ctx.seed, WARMUP_REQUEST, device)).cpu()
    request_s = time.perf_counter() - t0
    window = ctx.window_seconds
    pool = [condition(k) for k in range(int(math.ceil(window / request_s * 1.5)) + 2)]
    sure = max(1, int(0.8 * window / request_s))
    rng = np.random.default_rng(stream_seed(ctx.seed, inputs.CHECK_STREAM))
    chosen = set(rng.choice(sure, size=min(traffic["checked_requests"], sure),
                            replace=False).tolist())
    records, outputs = {}, {}
    setup_s = harness.end_of_setup(ctx)

    def serve(seconds, first, tracer=None):
        """Requests first, first + 1, ... until `seconds` have passed:
        (window seconds, latencies, failed, next request, counters' change,
        flash calls at D 72)."""
        latencies, failed, k = [], 0, first
        with tracer if tracer is not None else contextlib.nullcontext():
            before, flash_before = _counters(), _flash_d72()
            t_window = time.perf_counter()
            while time.perf_counter() - t_window < seconds:
                cond_host = pool[k] if k < len(pool) else condition(k)
                hook = None
                if k in chosen:
                    records[k] = []
                    hook = diffusion.model.register_forward_hook(
                        lambda m, args, kwargs, out, rec=records[k]: rec.append((args[0], out)),
                        with_kwargs=True)
                t_start = time.perf_counter()
                out = diffusion.sample(cond_host.to(device), steps,
                                       generator=inputs.request_generator(ctx.seed, k, device))
                out = out.cpu()
                t_end = time.perf_counter()
                if hook is not None:
                    hook.remove()
                    outputs[k] = out
                latencies.append(t_end - t_start)
                failed += int(not torch.isfinite(out).all())
                k += 1
            after, flash_after = _counters(), _flash_d72()
        moved = None if before is None else tuple(a - b for a, b in zip(after, before))
        flash = None if flash_before is None else flash_after - flash_before
        return t_end - t_window, latencies, failed, k, moved, flash

    trace = host_trace = None
    if ctx.trace:
        from portbench.tracing import Trace

        trace, host_trace = Trace(host_ops=False), Trace(host_ops=True)
        window_s, latencies, failed, k, moved, flash = serve(window, 0, trace)
        _, _, host_failed, end, _, _ = serve(ctx.host_window_seconds, k, host_trace)
        failed += host_failed
        facts = {"forwards": k * steps, "host_forwards": (end - k) * steps}
        if moved is not None:
            facts["learned_range_steps"], facts["final_steps"] = moved
        if flash is not None:
            facts["flash_d72_calls"] = flash
        attempted = end
    else:
        window_s, latencies, failed, k, _, _ = serve(window, 0)
        facts = {"forwards": k * steps}
        attempted = k
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    harness.log(f"sample_dit: request ms {[round(v * 1e3, 1) for v in latencies]}, "
                f"checked {sorted(chosen)}, warm-up {request_s * 1e3:.1f}")

    del diffusion
    harness.after_window()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, control = _check(ctx, weights, records, outputs, pool)
    p50, p95 = np.percentile(np.array(latencies) * 1e3, [50, 95])
    if ctx.trace:
        from portbench.counts import dit, kernels

        facts["flops"] = k * steps * dit.forward_flops(ctx.config, batch)
        facts["linear_flops"] = k * steps * dit.linear_flops(ctx.config, batch)
        facts["flash_bound_s"] = k * steps * sum(
            kernels.bound_s(*kernels.flash_call(*s)) for s in dit.flash_shapes(ctx.config, batch))
    return harness.Outcome(
        attempted=attempted, failed=failed,
        metrics={"denoise_step_ms": 1e3 * window_s / (k * steps), "request_ms_p50": float(p50),
                 "request_ms_p95": float(p95), "setup_s": setup_s},
        memory_peak_bytes=memory_peak, checks=checks, facts=facts, trace=trace,
        host_trace=host_trace, control_checks=control,
    )


def _reference(ctx, weights, dtype):
    """The reference network over `weights` and its own position table,
    on the run's device in `dtype`."""
    net = ref_dit.build(ctx.config)["model"]
    state = dict(weights, pos_embed=ref_dit.pos_embed(ctx.config))
    net.load_state_dict({k: v.to(ctx.device, dtype) for k, v in state.items()}, assign=True)
    return net.eval()


def _check(ctx, weights, records, outputs, pool):
    """(checks, control checks): the program's gaps, and with ctx.control
    the gaps of the reference in bf16 put in the program's place. The
    reference's forward is strict f32 of its own (`reference/dit.py`)."""
    device, traffic, model = ctx.device, ctx.traffic, ctx.config["model"]
    limits = ctx.config["correct_limits"]
    steps = traffic["denoising_steps"]
    schedule = ref_diffusion.Schedule(model["timesteps"], steps)
    order = schedule.order()
    times = [t for _, _, t in order]
    net = _reference(ctx, weights["model"], torch.float32)
    low = _reference(ctx, weights["model"], torch.bfloat16) if ctx.control else None
    pred_gap = step_gap = c_pred = c_step = 0.0
    for k, rec in sorted(records.items()):
        if len(rec) != steps:
            harness.log(f"sample_dit: request {k} ran {len(rec)} forwards, want {steps}")
            return [("forwards", float(len(rec)), float(steps))], []
        cond = pool[k].to(device)
        g = inputs.request_generator(ctx.seed, k, device)
        shape = rec[0][0].shape
        z = [torch.randn(shape, generator=g, device=device) for _ in range(steps)]
        step_gap = max(step_gap, _gap(rec[0][0], z[0]))
        xs = torch.stack([x for x, _ in rec])
        preds = torch.stack([p for _, p in rec])
        ref_preds = _forwards(net, xs, cond, times)
        low_preds = _forwards(low, xs, cond, times) if low is not None else None
        for step, i, _ in order:
            pred_gap = max(pred_gap, _halves_gap(preds[step], ref_preds[step]))
            noise = z[step + 1] if i else None
            want = ref_diffusion.update(schedule, i, xs[step], preds[step], noise)
            got = xs[step + 1] if step + 1 < steps else outputs[k].to(device)
            step_gap = max(step_gap, _gap(got, want))
            if low is not None:
                c_pred = max(c_pred, _halves_gap(low_preds[step], ref_preds[step]))
                lowz = None if noise is None else noise.bfloat16()
                c_got = ref_diffusion.update(schedule, i, xs[step].bfloat16(),
                                             low_preds[step].bfloat16(), lowz).float()
                c_want = ref_diffusion.update(schedule, i, xs[step], low_preds[step], noise)
                c_step = max(c_step, _gap(c_got, c_want))
    checks = [("pred_gap", pred_gap, limits["pred_gap"]),
              ("step_gap", step_gap, limits["step_gap"])]
    control = []
    if ctx.control:
        control = [("pred_gap", c_pred, limits["pred_gap"]),
                   ("step_gap", c_step, limits["step_gap"])]
    return checks, control
