"""Drive the self-conditioned, full-attention DDPM's sampler,
`GaussianDiffusion.sample`, as a served model: a closed loop of one
client, as `sample_ddpm` drives the DDPM (whose request streams, gap and
image blocks this driver shares). Each request is one call at the shipped
precision on a batch of condition stacks uploaded from the host, its
noise from a generator seeded per request, and its output fetched to the
host.

Set-up builds the model (`make_diffusion_model(use_full_attention=True,
self_condition=True)`; a program without those settings fails here),
loads the benchmark's weights, and runs two short calls that the window
does not count: the first builds the kernels, lets cuDNN pick its
algorithms and captures the step's CUDA graph (every step of a request
replays that one graph, since step 0 is handed zeros), the second times a
step. The requests to check are drawn from the seed among those that the
window is sure to finish; a forward hook keeps those requests' model
inputs, x and x_self_condition, and outputs. The program's counters
`GaussianDiffusion.self_cond_fed` / `.self_cond_zero` are read around the
window.

The check (after the window, the program's state freed) follows each
checked request step by step from the program's own states, in strict
f32 (`reference/fdnunet_fullattn.py`, attention in blocks of queries):
  pred_gap  max |prediction - reference| / max |reference| over the steps,
            the reference handed the program's x_i and x_self_i;
  step_gap  the largest of, over the steps: max |next state - reference
            update| / max |reference update| (the initial noise and the
            output on the host included), and max |x_self_{i+1} - the
            clamped x0 of step i's reference update| / max of the latter
            (step 0's x_self must be zeros).
"""

import contextlib
import math
import time

import numpy as np
import torch

from portbench import harness, inputs
from portbench.drivers.sample_ddpm import REFERENCE_BLOCK, WARMUP_REQUEST, _gap
from portbench.reference import diffusion as ref_diffusion, fdnunet, fdnunet_fullattn
from portbench.reference.weights import make_weights, stream_seed

# steps of each set-up call: one at t > 0 (fed the estimate after the
# first) and the last at t = 0, the shapes and branches of a request
WARMUP_STEPS = 2


def _program(ctx):
    from fea_tpu_torch.models import make_diffusion_model

    model = ctx.config["model"]
    return make_diffusion_model(
        image_size=model["image_size"], input_dim=model["input_dim"],
        num_stages=model["num_stages"], timesteps=model["timesteps"],
        objective=model["objective"], device=ctx.device,
        generator=torch.Generator(device=ctx.device).manual_seed(stream_seed(ctx.seed, 3)),
        use_flash_attention=model["use_flash_attention"],
        use_full_attention=model["use_full_attention"],
        self_condition=model["self_condition"],
        num_attention_heads=model["num_attention_heads"],
        attention_head_dim=model["attention_head_dim"],
    )


def _counters():
    from fea_tpu_torch.models.diffusion import GaussianDiffusion

    return GaussianDiffusion.self_cond_fed, GaussianDiffusion.self_cond_zero


def run(ctx) -> harness.Outcome:
    device, traffic, model = ctx.device, ctx.traffic, ctx.config["model"]
    batch, steps, size = traffic["batch"], traffic["denoising_steps"], model["image_size"]
    channels = model["num_auxiliary_condition_channels"]
    diffusion = _program(ctx)
    reference = fdnunet_fullattn.build(ctx.config)
    weights = make_weights(reference, ctx.seed, device)
    diffusion.model.load_state_dict(weights["model"])
    diffusion.model.eval()
    weights = {k: {n: t.cpu() for n, t in w.items()} for k, w in weights.items()}

    def condition(k):
        return inputs.request_condition(ctx.seed, k, batch, size, channels, device)

    # the set-up calls: their own stream, not one of the window's
    warm = condition(WARMUP_REQUEST)
    for _ in range(2):
        harness.synchronize(device)
        t0 = time.perf_counter()
        diffusion.sample(warm.to(device), WARMUP_STEPS, generator=inputs.request_generator(
            ctx.seed, WARMUP_REQUEST, device)).cpu()
    request_s = (time.perf_counter() - t0) * steps / WARMUP_STEPS
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
        (window seconds, latencies, failed, next request)."""
        latencies, failed, k = [], 0, first
        with tracer if tracer is not None else contextlib.nullcontext():
            t_window = time.perf_counter()
            while time.perf_counter() - t_window < seconds:
                cond_host = pool[k] if k < len(pool) else condition(k)
                hook = None
                if k in chosen:
                    records[k] = []
                    hook = diffusion.model.register_forward_hook(
                        lambda m, args, kwargs, out, rec=records[k]: rec.append(
                            (args[0], kwargs.get("x_self_condition"), out)),
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
        return t_end - t_window, latencies, failed, k

    trace = host_trace = None
    before = _counters()
    if ctx.trace:
        from portbench.tracing import Trace

        trace, host_trace = Trace(host_ops=False), Trace(host_ops=True)
        window_s, latencies, failed, k = serve(window, 0, trace)
        after = _counters()
        _, _, host_failed, end = serve(ctx.host_window_seconds, k, host_trace)
        failed += host_failed
        facts = {"forwards": k * steps, "host_forwards": (end - k) * steps}
        attempted = end
    else:
        window_s, latencies, failed, k = serve(window, 0)
        after = _counters()
        facts = {"forwards": k * steps}
        attempted = k
    facts["self_cond_fed"], facts["self_cond_zero"] = (a - b for a, b in zip(after, before))
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    harness.log(f"sample_ddpm_selfcond: request ms {[round(v * 1e3, 1) for v in latencies]}, "
                f"checked {sorted(chosen)}, set-up estimate {request_s * 1e3:.1f}, "
                f"self-conditioned forwards fed {facts['self_cond_fed']}, zeros "
                f"{facts['self_cond_zero']}")

    del diffusion
    harness.after_window()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, control = _check(ctx, reference, weights, records, outputs, pool)
    p50, p95 = np.percentile(np.array(latencies) * 1e3, [50, 95])
    if ctx.trace:
        from portbench.counts import fullattn

        facts["flops"] = k * steps * fullattn.forward_flops(ctx.config, batch)
        facts["flash_bound_s"] = k * steps * fullattn.flash_bound_s(ctx.config, batch)
    return harness.Outcome(
        attempted=attempted, failed=failed,
        metrics={"denoise_step_ms": 1e3 * window_s / (k * steps), "request_ms_p50": float(p50),
                 "request_ms_p95": float(p95), "setup_s": setup_s},
        memory_peak_bytes=memory_peak, checks=checks, facts=facts, trace=trace,
        host_trace=host_trace, control_checks=control,
    )


def _check(ctx, reference, weights, records, outputs, pool):
    """(checks, control checks): the program's gaps, and with ctx.control
    the gaps of the reference in bf16 put in the program's place."""
    device, traffic, model = ctx.device, ctx.traffic, ctx.config["model"]
    limits = ctx.config["correct_limits"]
    steps = traffic["denoising_steps"]
    schedule = ref_diffusion.Schedule(model["timesteps"])
    times = ref_diffusion.sample_timesteps(model["timesteps"], steps)
    restore = fdnunet.strict_f32()
    try:
        net = reference["model"]
        net.load_state_dict({k: v.to(device) for k, v in weights["model"].items()}, assign=True)
        net.eval()
        low = None
        if ctx.control:
            low = fdnunet_fullattn.build(ctx.config)["model"]
            low.load_state_dict({k: v.to(device, torch.bfloat16)
                                 for k, v in weights["model"].items()}, assign=True)
            low.eval()
        pred_gap = step_gap = 0.0
        c_pred = c_step = 0.0
        for k, rec in sorted(records.items()):
            if len(rec) != steps or any(xs is None for _, xs, _ in rec):
                harness.log(f"sample_ddpm_selfcond: request {k} ran {len(rec)} forwards, "
                            f"want {steps}, each handed x_self_condition")
                return [("forwards", float(len(rec)), float(steps))], []
            cond = pool[k].to(device)
            g = inputs.request_generator(ctx.seed, k, device)
            shape = rec[0][0].shape
            z = [torch.randn(shape, generator=g, device=device) for _ in range(steps)]
            step_gap = max(step_gap, _gap(rec[0][0], z[0]),
                           _gap(rec[0][1], torch.zeros(shape, device=device)))
            xs = torch.stack([x for x, _, _ in rec])
            selfs = torch.stack([s for _, s, _ in rec])
            preds = torch.stack([p for _, _, p in rec])
            ref_preds = _forwards(net, xs, selfs, cond, times)
            low_preds = _forwards(low, xs, selfs, cond, times) if low is not None else None
            for i, t in enumerate(times):
                pred_gap = max(pred_gap, _gap(preds[i], ref_preds[i]))
                noise = z[i + 1] if t else None
                want = ref_diffusion.update(schedule, t, xs[i], preds[i], noise)
                got = xs[i + 1] if i + 1 < steps else outputs[k].to(device)
                step_gap = max(step_gap, _gap(got, want))
                if i + 1 < steps:
                    step_gap = max(step_gap, _gap(selfs[i + 1], fdnunet_fullattn.x0_estimate(
                        schedule, t, xs[i], preds[i])))
                if low is not None:
                    c_pred = max(c_pred, _gap(low_preds[i], ref_preds[i]))
                    lowz = None if noise is None else noise.bfloat16()
                    c_got = ref_diffusion.update(schedule, t, xs[i].bfloat16(),
                                                 low_preds[i].bfloat16(), lowz).float()
                    c_want = ref_diffusion.update(schedule, t, xs[i], low_preds[i], noise)
                    c_step = max(c_step, _gap(c_got, c_want))
    finally:
        restore()
    checks = [("pred_gap", pred_gap, limits["pred_gap"]),
              ("step_gap", step_gap, limits["step_gap"])]
    control = []
    if ctx.control:
        control = [("pred_gap", c_pred, limits["pred_gap"]),
                   ("step_gap", c_step, limits["step_gap"])]
    return checks, control


@torch.no_grad()
def _forwards(net, xs, selfs, cond, times):
    """The network's prediction for each step's state xs[i] and estimate
    selfs[i] (steps, B, H, W, C) at times[i], in blocks of REFERENCE_BLOCK
    images, as f32."""
    steps, b = xs.shape[:2]
    dtype = next(net.parameters()).dtype
    flat_x = xs.reshape(steps * b, *xs.shape[2:])
    flat_s = selfs.reshape(steps * b, *selfs.shape[2:])
    flat_t = torch.tensor(times, dtype=torch.float32, device=xs.device).repeat_interleave(b)
    flat_c = cond.repeat(steps, 1, 1, 1)
    out = []
    for s in range(0, steps * b, REFERENCE_BLOCK):
        e = s + REFERENCE_BLOCK
        out.append(net(flat_x[s:e].to(dtype), flat_c[s:e].to(dtype), flat_t[s:e],
                       flat_s[s:e].to(dtype)).float())
    return torch.cat(out).reshape(xs.shape)
