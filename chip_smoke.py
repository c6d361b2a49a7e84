"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py [--against TREE]

Set-up: TF32 off for matmuls and convolutions; both kernel libraries (flash
attention, fused GroupNorm+SiLU) are built at once, one nvcc each, from
fea_tpu_torch/csrc into fea_tpu_torch/_build.
Phase 1: the flash kernel (tensor cores: 3xTF32 for f32, bf16 products
         for bf16) against its plain PyTorch version at the sampler's shape
         (BH 8, Nq 1024, Nk 1028, D 32) and a ragged one, f32 and bf16, timed
         on the device beside the plain version and
         F.scaled_dot_product_attention.
Phase 2: the conditional-DDPM sampler at full width (FDNUNet input_dim 64,
         4 stages, 256 px, flash attention, random seeded weights) answers
         2 requests with 25 denoising steps; the flash kernel must have
         launched 3 x 25 times and the GroupNorm+SiLU forward 9 x 25, and the
         output must agree with the same sampler run through plain
         attention, and the card with the CPU on a small input.
         The GroupNorm+SiLU kernels take contiguous NCHW x and raise on any
         other layout, so phases 2, 3, 5 and 6 running through them show
         that every model path gives them NCHW.
Phase 3: the regression predictor (create_models + predict) at batch 4; the
         GroupNorm+SiLU forward launches 18 times per call.
Phase 4: the GroupNorm+SiLU kernels, forward and forward+backward, against
         the plain version at the four stage shapes at every batch the
         other phases give them (2, 4 and 16) and a ragged shape, f32, bf16
         x with f32 params and bf16 x with bf16 params; timed at batch 16
         beside the plain version and F.silu(F.group_norm(...)), each
         backward through autograd (the kernel's reads the forward's saved
         coefficients).
Phase 5: the regression Trainer at full width (input_dim 64, 4 stages,
         256 px, batch 16, EMA, all three Adam chains) on a seeded synthetic
         dataset: train() takes a warm-up step and 3 more in f32 (18 + 18
         GroupNorm+SiLU launches per step), its checkpoint loads back bit for
         bit into a bf16 trainer, which takes 4 steps; one 32 px step on the
         card against the same step on the CPU.
Phase 6: the DiffusionTrainer at full width (FDNUNet input_dim 64, 4 stages,
         256 px, batch 4): train() takes a warm-up step and 2 more (9 + 9
         launches per step).

Kernel times are device times: CUDA events around calls that the host
queued behind a device-side wait, each function timed in turns.
`--against TREE` also times the kernels of another checkout of this repo
(for example the parent commit, `git archive` unpacked into a git-ignored
directory) in the same turns, as `earlier`; they build into that
checkout's fea_tpu_torch/_build.

Prints the card, a JSON line of the kernels, and as its last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then not 0 and no result line is printed. Needs CUDA; exits 1 without it.
"""

import argparse
import copy
import functools
import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
SAMPLER_STEPS = 25
SAMPLER_BATCH = 2
PREDICT_BATCH = 4
IMAGE = 256
FLASH_SHAPE = (8, 1024, 1028, 32)  # BH = 4 heads x batch 2, 32x32 px + 4 memory-KV
RAGGED_SHAPE = (3, 100, 68, 32)
F32_TOL = dict(atol=2e-5, rtol=1e-4)  # only the order of summation differs
BF16_ATOL = 1e-2  # one bf16 rounding of the output
FLASH_VS_PLAIN_ATOL = 5e-4  # one forward: fea_tpu's flash-vs-math bound
SAMPLE_ATOL = 1e-3  # 25 steps, compared on the clipped output
CPU_ATOL = 1e-4  # card vs CPU on a small input, f32 without TF32
# the redesigned kernels' designs, for the kernels line
REDESIGNED = {
    "flash_attention": "tensor-core mma.sync, 3xTF32 for f32",
    "group_norm_silu_bwd": "two launches over the forward's saved coefficients",
}


def log(*args):
    print(*args, flush=True)


# a device-side wait of about 50 ms (at up to 2 GHz) before each timed run:
# the host queues the run's calls meanwhile, so the events time the device
# and not the host's launch cost (tens of microseconds a call here)
QUEUE_CYCLES = 100_000_000


def cuda_ms(fn, iters):
    """Mean device milliseconds per call over `iters` calls, by CUDA events
    around calls the host queued behind a device-side wait."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters):
    """Mean ms per call of each function of the dict `fns`, after a
    warm-up, timed in turns (in order, then in reverse) and averaged over
    both turns."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    names = list(fns)
    ms = dict.fromkeys(names, 0.0)
    for name in names + names[::-1]:
        ms[name] += cuda_ms(fns[name], iters) / 2
    return ms


def load_ops(tree):
    """The `fea_tpu_torch.ops` package of another checkout, as the module
    `earlier_ops`; its kernels build into that checkout's _build."""
    path = Path(tree).resolve() / "fea_tpu_torch" / "ops"
    spec = importlib.util.spec_from_file_location(
        "earlier_ops", path / "__init__.py", submodule_search_locations=[str(path)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["earlier_ops"] = module
    spec.loader.exec_module(module)
    return module


def reset_counts():
    from fea_tpu_torch.ops import flash_attention, group_norm_silu

    flash_attention.launches = 0
    group_norm_silu.launches_fwd = group_norm_silu.launches_bwd = 0


def counts():
    """(flash, GroupNorm+SiLU forward, GroupNorm+SiLU backward) launches."""
    from fea_tpu_torch.ops import flash_attention, group_norm_silu

    return flash_attention.launches, group_norm_silu.launches_fwd, group_norm_silu.launches_bwd


def qkv(shape, device, seed):
    bh, nq, nk, d = shape
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
        for s in ((bh, nq, d), (bh, nk, d), (bh, nk, d))
    )


def max_abs_err(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_kernel(device, earlier):
    """Checks, then {dtype: {name: ms}} at FLASH_SHAPE for the kernel, the
    plain version, the library call and, given `earlier` (another tree's
    ops), its kernel."""
    from fea_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    errs = {}
    for shape in (FLASH_SHAPE, RAGGED_SHAPE):
        q, k, v = qkv(shape, device, SEED)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = flash_attention_reference(q, k, v)
        errs[shape, "f32"] = max_abs_err(got, want)
        torch.testing.assert_close(got, want, **F32_TOL)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        got = flash_attention(qb, kb, vb)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 kernel returned {got.dtype}")
        want = flash_attention_reference(qb, kb, vb)
        errs[shape, "bf16"] = max_abs_err(got, want)
        torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL, rtol=0)
    q, k, v = qkv(RAGGED_SHAPE, device, SEED)
    try:
        flash_attention(q.requires_grad_(), k, v)
    except RuntimeError:
        pass  # the kernel has no backward, and says so
    else:
        raise AssertionError("flash_attention took a q that requires grad")
    for (shape, dtype), err in errs.items():
        tol = F32_TOL if dtype == "f32" else dict(atol=BF16_ATOL, rtol=0)
        log(f"phase 1: flash {shape} {dtype}: max abs err vs plain {err:.3e} (tolerance {tol})")

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in qkv(FLASH_SHAPE, device, SEED))
        fns = {
            "kernel": lambda: flash_attention(q, k, v),
            "plain": lambda: flash_attention_reference(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(q, k, v),
        }
        if earlier is not None:
            fns["earlier"] = lambda: earlier.flash_attention(q, k, v)
        ms = times[dtype] = in_turns(fns, 50)
        log(
            f"phase 1: flash {FLASH_SHAPE} {str(dtype)[6:]}: kernel {ms['kernel']:.4f} ms, "
            f"plain {ms['plain']:.4f} ms, scaled_dot_product_attention {ms['library']:.4f} ms"
            + (f", earlier kernel {ms['earlier']:.4f} ms" if earlier is not None else "")
            + " per call"
        )
    return errs[FLASH_SHAPE, "f32"], times[torch.float32]


def phase_sampler(device):
    from fea_tpu_torch.models import make_diffusion_model
    from fea_tpu_torch.models.diffusion import GaussianDiffusion
    from fea_tpu_torch.models.fdnunet import FDNUNet

    generator = torch.Generator(device=device).manual_seed(SEED)
    diffusion = make_diffusion_model(
        image_size=IMAGE, input_dim=64, num_stages=4, timesteps=1000,
        use_flash_attention=True, device=device, generator=generator,
    )
    model = diffusion.model.eval()
    log(f"phase 2: FDNUNet parameters {sum(p.numel() for p in model.parameters())}")
    rng = np.random.default_rng(SEED)
    condition = torch.from_numpy(
        rng.normal(size=(SAMPLER_BATCH, IMAGE, IMAGE, 5)).astype(np.float32)
    ).to(device)
    noise = torch.from_numpy(
        rng.normal(size=(SAMPLER_STEPS + 1, SAMPLER_BATCH, IMAGE, IMAGE, 2)).astype(np.float32)
    ).to(device)

    diffusion.sample(condition, 2, noise=noise[:3])  # warm-up: cuDNN picks algorithms
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    out = diffusion.sample(condition, SAMPLER_STEPS, noise=noise)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, gn_fwd, gn_bwd = counts()
    if (launches, gn_fwd, gn_bwd) != (3 * SAMPLER_STEPS, 9 * SAMPLER_STEPS, 0):
        raise AssertionError(
            f"flash / GroupNorm+SiLU forward / backward launched {launches} / "
            f"{gn_fwd} / {gn_bwd} times, want {3 * SAMPLER_STEPS} / {9 * SAMPLER_STEPS} / 0"
        )
    if out.shape != (SAMPLER_BATCH, IMAGE, IMAGE, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"sampler output {tuple(out.shape)} is not finite or not the shape")
    log(
        f"phase 2: sampler batch {SAMPLER_BATCH}, {SAMPLER_STEPS} steps: "
        f"{wall * 1e3:.2f} ms per call, {wall * 1e3 / SAMPLER_STEPS:.3f} ms per "
        f"denoising step, {wall * 1e3 / SAMPLER_BATCH:.2f} ms per request; "
        f"flash launches {launches}, GroupNorm+SiLU forward launches {gn_fwd}"
    )

    # the same weights through plain attention
    with torch.device("meta"):
        plain_model = FDNUNet(
            input_dim=64, num_stages=4, num_channels=2,
            num_auxiliary_condition_channels=5, use_time_embedding=True,
            use_flash_attention=False,
        )
    plain_model.to_empty(device=device).load_state_dict(model.state_dict())
    plain = GaussianDiffusion(plain_model.eval(), timesteps=1000)
    plain.sample(condition, 2, noise=noise[:3])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_plain = plain.sample(condition, SAMPLER_STEPS, noise=noise)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    err_sample = max_abs_err(out, out_plain)
    log(
        f"phase 2: plain-attention sampler {wall_plain * 1e3 / SAMPLER_STEPS:.3f} "
        f"ms per denoising step; max abs diff of samples {err_sample:.3e} "
        f"(clipped share {float((out.abs() >= 1).float().mean()):.3f})"
    )
    if err_sample > SAMPLE_ATOL:
        raise AssertionError(f"flash and plain samples differ by {err_sample}")

    # one unclipped forward at t = T - 1, flash against plain attention
    t_last = torch.full((SAMPLER_BATCH,), 999.0, device=device)
    with torch.no_grad():
        a = model(noise[0], condition, time=t_last)
        b = plain_model(noise[0], condition, time=t_last)
    err_forward = max_abs_err(a, b)
    log(f"phase 2: one forward, flash vs plain attention: max abs diff {err_forward:.3e}")
    if err_forward > FLASH_VS_PLAIN_ATOL:
        raise AssertionError(f"flash and plain forwards differ by {err_forward}")

    # the card against the CPU on a small input (32 px, batch 1)
    small_x, small_c = noise[0, :1, :32, :32], condition[:1, :32, :32]
    t_small = torch.full((1,), 500.0, device=device)
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        on_card = model(small_x, small_c, time=t_small).cpu()
        on_cpu = cpu_model(small_x.cpu(), small_c.cpu(), time=t_small.cpu())
    err_cpu = max_abs_err(on_card, on_cpu)
    log(f"phase 2: FDNUNet 32 px on the card vs the CPU: max abs diff {err_cpu:.3e}")
    if err_cpu > CPU_ATOL:
        raise AssertionError(f"card and CPU differ by {err_cpu}")
    return launches


def predictor_inputs(batch, size, seed):
    """materials (2), conditions = forces (2) + constraints (1), and a +-1
    geometry mask, NHWC float32, as the repo's example batch draws them."""
    rng = np.random.default_rng(seed)
    materials = rng.normal(size=(batch, size, size, 2))
    forces = rng.normal(size=(batch, size, size, 2))
    constraints = rng.normal(size=(batch, size, size, 1))
    geometry = np.where(rng.random((batch, size, size, 1)) > 0.5, 1.0, -1.0)
    conditions = np.concatenate([forces, constraints], axis=-1)
    return tuple(a.astype(np.float32) for a in (materials, conditions, geometry))


def phase_predictor(device):
    from fea_tpu_torch.models import create_models, predict

    generator = torch.Generator(device=device).manual_seed(SEED + 1)
    encoder, decoder, _aux = create_models(
        input_dim=64, image_height=IMAGE, image_width=IMAGE, num_channels=2,
        num_auxiliary_condition_channels=3, num_stages=4,
        device=device, generator=generator,
    )
    encoder.eval(), decoder.eval()
    log(f"phase 3: encoder parameters {sum(p.numel() for p in encoder.parameters())}")
    materials, conditions, geometry = (
        torch.from_numpy(a).to(device) for a in predictor_inputs(PREDICT_BATCH, IMAGE, SEED)
    )
    predict(encoder, decoder, materials, conditions, geometry)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    iters = 10
    for _ in range(iters):
        out = predict(encoder, decoder, materials, conditions, geometry)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    if counts() != (0, 18 * iters, 0):
        raise AssertionError(f"predictor launches {counts()}, want (0, {18 * iters}, 0)")
    if out.shape != (PREDICT_BATCH, IMAGE, IMAGE, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"predictor output {tuple(out.shape)} is not finite or not the shape")
    outside = geometry[..., 0] < 0
    if not bool((out[outside] == -1.0).all()):
        raise AssertionError("the geometry remask left pixels outside the plate")

    small = [t[:1, :32, :32].contiguous() for t in (materials, conditions, geometry)]
    enc_cpu, dec_cpu = copy.deepcopy(encoder).cpu(), copy.deepcopy(decoder).cpu()
    on_card = predict(encoder, decoder, *small).cpu()
    on_cpu = predict(enc_cpu, dec_cpu, *(t.cpu() for t in small))
    err_cpu = max_abs_err(on_card, on_cpu)
    log(
        f"phase 3: predictor batch {PREDICT_BATCH} at {IMAGE} px: {ms:.3f} ms per "
        f"batch; 32 px card vs CPU max abs diff {err_cpu:.3e}"
    )
    if err_cpu > CPU_ATOL:
        raise AssertionError(f"card and CPU differ by {err_cpu}")


GN_GROUPS = 8
GN_EPS = 1e-6
# the decoder's GroupNorm+SiLU calls in one regression train step at 256 px
# and batch 16, by stage shape (HW, C): two blocks of two sub-blocks per up
# stage, and final_resnet's two at the first stage; 18 in all
GN_STAGE_CALLS = {(65536, 64): 6, (16384, 128): 4, (4096, 256): 4, (1024, 512): 4}
GN_RAGGED = (3, 63, 48)  # B, HW (7 x 9), C: C/G 6, no tile multiple
# (x, gamma and beta) dtypes: f32; bf16 x with f32 params; bf16 params, as
# the bf16 trainer passes them
GN_DTYPES = (
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
)
GN_FWD_TOL = dict(atol=5e-5, rtol=1e-4)  # fea_tpu's bounds (tests/test_models.py:195-233)
GN_VJP_REL = 1e-4  # each of dx, dgamma, dbeta within 1e-4 of its largest element
GN_BF16_TOL = dict(atol=1e-2, rtol=1e-2)  # y, dx: one bf16 rounding (2^-8 relative)
# dgamma, dbeta of bf16 x: f32 sums of the same bf16 terms; in bf16 params,
# one bf16 rounding of those sums (at most 2^-7 of the element)
GN_BF16_PARAM_REL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, dense TF32 FLOP/s on
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
TF32_TENSOR_FLOPS = 495e12

TRAIN_BATCH = 16
TRAIN_STEPS = 3  # timed, after one warm-up step, per compute dtype
TRAIN_LR = 3e-4
DIFFUSION_BATCH = 4
DIFFUSION_STEPS = 2
# every batch at which the main path calls GroupNorm+SiLU: the sampler, the
# predictor, the diffusion step and the regression step (and its samples)
GN_BATCHES = sorted({SAMPLER_BATCH, PREDICT_BATCH, DIFFUSION_BATCH, TRAIN_BATCH})
# card vs CPU, one 32 px step at full width: the loss to rtol 1e-4, and each
# module's gradient (read as Adam's first moment) to 1e-3 of its largest
# element: cuDNN's f32 convolutions sum in other orders than the CPU's
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL = 1e-3


def bound_ms(nbytes, ops, flops):
    """The least time for the work: bytes over the HBM rate or operations
    over the rate `flops` of the unit that does them, whichever is larger;
    and which one it was."""
    by_bytes, by_ops = bytes_ms(nbytes), ops / flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bytes_ms(nbytes):
    """The least time to move `nbytes` through HBM. GroupNorm+SiLU's bound:
    its f32 operations, a few tens per element against 4-12 bytes of it,
    come to a few per byte, well under the card's 20 operations per byte of
    HBM, so the bytes bind at every shape."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def gn_case(device, b, hw, c, dtype, seed):
    """x and a cotangent (B, C, H, W) contiguous, gamma and beta (C,) f32."""
    h = math.isqrt(hw)
    while hw % h:
        h -= 1
    g = torch.Generator(device=device).manual_seed(seed)
    x, ct = (torch.randn((b, c, h, hw // h), generator=g, device=device).to(dtype)
             for _ in range(2))
    gamma, beta = (torch.randn(c, generator=g, device=device) for _ in range(2))
    return x, gamma, beta, ct


def gn_vjp(fn, x, gamma, beta, ct):
    x, gamma, beta = (t.detach().clone().requires_grad_() for t in (x, gamma, beta))
    y = fn(x, gamma, beta, GN_GROUPS, GN_EPS)
    return (y.detach(), *torch.autograd.grad(y, (x, gamma, beta), ct))


def library_group_norm_silu(x, gamma, beta, num_groups, eps):
    return F.silu(F.group_norm(x, num_groups, gamma, beta, eps))


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def phase_group_norm(device, earlier):
    """The kernels against the plain version in every case, then their
    time beside it, the library chain and, given `earlier` (another tree's
    ops), its kernels, at the stage shapes; per-step sums for the kernels'
    rows."""
    from fea_tpu_torch.ops.fused_norm import group_norm_silu, group_norm_silu_reference

    shapes = [(b, hw, c) for b in GN_BATCHES for hw, c in GN_STAGE_CALLS] + [GN_RAGGED]
    fwd_err = bwd_err = 0.0
    for b, hw, c in shapes:
        for dtype, param_dtype in GN_DTYPES:
            x, gamma, beta, ct = gn_case(device, b, hw, c, dtype, SEED)
            gamma, beta = gamma.to(param_dtype), beta.to(param_dtype)
            got = gn_vjp(group_norm_silu, x, gamma, beta, ct)
            torch.cuda.synchronize()
            want = gn_vjp(group_norm_silu_reference, x, gamma, beta, ct)
            case = f"{(b, hw, c)} x {str(dtype)[6:]}, params {str(param_dtype)[6:]}"
            if not (got[0].is_contiguous() and got[1].is_contiguous()):
                raise AssertionError(f"y or dx is not contiguous NCHW at {case}")
            if [t.dtype for t in got] != [dtype, dtype, param_dtype, param_dtype]:
                raise AssertionError(f"dtypes {[t.dtype for t in got]} at {case}")
            errs = [max_abs_err(got[0], want[0])] + [
                rel_err(g, w) for g, w in zip(got[1:], want[1:])
            ]
            if dtype == torch.float32:
                torch.testing.assert_close(got[0], want[0], **GN_FWD_TOL)
                if max(errs[1:]) >= GN_VJP_REL:
                    raise AssertionError(f"VJP relative errors {errs[1:]} at {case}")
                fwd_err = max(fwd_err, errs[0])
                bwd_err = max(bwd_err, max_abs_err(got[1], want[1]))
            else:
                for g, w in zip(got[:2], want[:2]):
                    torch.testing.assert_close(g.float(), w.float(), **GN_BF16_TOL)
                if max(errs[2:]) >= GN_BF16_PARAM_REL[param_dtype]:
                    raise AssertionError(f"bf16 dgamma/dbeta errors {errs[2:]} at {case}")
            log(
                f"phase 4: group_norm_silu {case}: y max abs err {errs[0]:.3e}; "
                "dx, dgamma, dbeta max rel err " + ", ".join(f"{e:.3e}" for e in errs[1:])
            )
            del x, ct, got, want

    fns = {"kernel": group_norm_silu, "plain": group_norm_silu_reference,
           "library": library_group_norm_silu}
    if earlier is not None:
        fns["earlier"] = earlier.group_norm_silu
    # ms per f32 / bf16 train step (its 18 calls) by (direction, dtype), a
    # dict by name as fns
    per_step = {}
    step_bytes = {"fwd": 0, "bwd": 0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:].replace("float", "f")
        for (hw, c), calls in GN_STAGE_CALLS.items():
            x, gamma, beta, dy = gn_case(device, TRAIN_BATCH, hw, c, dtype, SEED)
            gamma, beta = gamma.to(dtype), beta.to(dtype)  # as the bf16 trainer passes them
            fwd = {name: functools.partial(torch.no_grad()(fn), x, gamma, beta, GN_GROUPS, GN_EPS)
                   for name, fn in fns.items()}
            bwd = {}
            for name, fn in fns.items():
                leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
                y = fn(*leaves, GN_GROUPS, GN_EPS)
                bwd[name] = functools.partial(
                    torch.autograd.grad, y, leaves, dy, retain_graph=True)
            n = x.numel()
            for direction, timed in (("fwd", fwd), ("bwd", bwd)):
                ms = in_turns(timed, 10)
                tensors = 2 if direction == "fwd" else 3  # x, y / x, dy, dx
                nbytes = tensors * n * x.element_size()
                log(
                    f"phase 4: group_norm_silu {direction} {(TRAIN_BATCH, hw, c)} {dname}: "
                    + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
                    + f" per call; bound {bytes_ms(nbytes):.4f} ms"
                )
                step = per_step.setdefault((direction, dname), dict.fromkeys(ms, 0.0))
                for name, t in ms.items():
                    step[name] += calls * t
                if dtype == torch.float32:
                    step_bytes[direction] += calls * nbytes
            del x, dy, fwd, bwd
    torch.cuda.empty_cache()
    out = {}
    for direction, err in (("fwd", fwd_err), ("bwd", bwd_err)):
        bound = bytes_ms(step_bytes[direction])
        ms = per_step[direction, "f32"]
        log(
            f"phase 4: group_norm_silu {direction}, the 18 calls of one f32 train step: "
            + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
            + f"; bound {bound:.4f} ms (bytes: {step_bytes[direction] / 1e9:.3f} GB); "
            f"in bf16: kernel {per_step[direction, 'bf16']['kernel']:.4f} ms"
        )
        out[direction] = dict(max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                              bound_ms=bound, bound_by="bytes", library_ms=ms["library"])
        if earlier is not None:
            out[direction]["earlier_ms"] = ms["earlier"]
    return out


class SyntheticFEADataset:
    """Seeded samples in the FEADataset contract (fea_tpu_torch/data), made
    in memory: the card has no datagen and no data. +-1 geometry and
    constraint masks, forces and materials on the plate, displacement in
    [-1, 1], and the range targets."""

    conditions_per_plate_geometry = 1

    def __init__(self, n, size, seed):
        rng = np.random.default_rng(seed)
        self.num_steps = n
        self.samples = []
        for i in range(n):
            geometry = np.where(rng.random((size, size, 1)) < 0.7, 1.0, -1.0)
            plate = (geometry + 1.0) / 2.0
            ranges = rng.normal(size=4).astype(np.float32)
            self.samples.append({
                "plate_index": np.int32(1), "condition_index": np.int32(1),
                "iteration_index": np.int32(i + 1),
                "geometry": geometry.astype(np.float32),
                "displacement": np.tanh(rng.normal(size=(size, size, 2))).astype(np.float32),
                "constraints": np.where(rng.random((size, size, 1)) < 0.05, 1.0, -1.0).astype(
                    np.float32),
                "forces": (rng.normal(size=(size, size, 2)) * plate).astype(np.float32),
                "materials": (rng.normal(size=(size, size, 2)) * plate).astype(np.float32),
                "displacement_range": ranges,
                "log_displacement_range": np.log1p(np.abs(ranges)),
                "sign_displacement_range": (ranges >= 0).astype(np.float32),
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        return self.samples[index]


def trainer_config(image, results, **kw):
    from fea_tpu_torch.train import TrainerConfig

    return TrainerConfig(
        dataset_image_size=image, train_batch_size=TRAIN_BATCH, train_learning_rate=TRAIN_LR,
        loss_type="l1", use_ema=True, disable_auxiliary=False, input_dim=64, num_stages=4,
        num_steps_per_milestone=10**9, num_steps_per_soft_milestone=10**9,
        skip_dataset_size_check=True, progress_bar=False, results_folder=str(results),
        seed=SEED, **kw,
    )


def timed_train(trainer, steps, tag):
    """trainer.train() over `steps` more steps, with the launch counts set
    to 0 before and read after; per-step times from the loop's per-step
    callback (which reads each step's loss, so each step has ended)."""
    stamps, losses = [], []

    def on_step(step, loss, *rest):
        stamps.append(time.perf_counter())
        losses.append(loss)

    trainer.config.num_train_steps = trainer.step + steps
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(on_step)
    launches = counts()
    if not all(math.isfinite(v) for v in losses) or len(losses) != steps:
        raise AssertionError(f"{tag}: losses {losses}")
    if launches != (0, 18 * steps, 18 * steps):
        raise AssertionError(f"{tag}: launches {launches}, want (0, {18 * steps}, {18 * steps})")
    ms = np.diff([t0] + stamps) * 1e3
    log(
        f"phase 5: {tag}: losses {', '.join(f'{v:.5f}' for v in losses)}; ms per step "
        + ", ".join(f"{t:.3f}" for t in ms)
        + f" (the first includes the warm-up); launches {launches}"
    )
    return float(np.mean(ms[1:])), launches


def state_tensors(trainer):
    sd = trainer.state_dict()
    out = {}
    for part in ("params", "opt_states", "ema_params"):
        for key, value in sd[part].items():
            for name, t in value.items():
                for i, leaf in enumerate(t if isinstance(t, list) else [t]):
                    out[part, key, name, i] = leaf
    return out


def phase_regression_train(device, results):
    from fea_tpu_torch.train import Trainer

    data = SyntheticFEADataset(64, IMAGE, SEED)
    samples = SyntheticFEADataset(8, IMAGE, SEED + 1)
    cfg = trainer_config(IMAGE, results / "regression")
    trainer = Trainer(cfg, dataset=data, sample_dataset=samples, device=device)
    log(f"phase 5: parameters {trainer.num_params()}")
    initial = {k: [p.detach().clone() for p in v] for k, v in trainer.params.items()}
    f32_ms, launches = timed_train(trainer, 1 + TRAIN_STEPS, "f32")
    log(f"phase 5: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for key in initial:
        for now, kind in ((trainer.params[key], "params"), (trainer.ema_params[key], "EMA")):
            if all(torch.equal(a, b) for a, b in zip(initial[key], now)):
                raise AssertionError(f"{key} {kind} did not change")
    del initial

    # train() saved 'final': it loads back bit for bit into a bf16 trainer
    saved = state_tensors(trainer)
    bf16 = Trainer(trainer_config(IMAGE, results / "regression", compute_dtype="bfloat16"),
                   dataset=data, sample_dataset=samples, device=device)
    bf16.load_checkpoint("auto")
    loaded = state_tensors(bf16)
    if saved.keys() != loaded.keys() or not all(torch.equal(saved[k], loaded[k]) for k in saved):
        raise AssertionError("the checkpoint did not load back bit for bit")
    if bf16.step != trainer.step:
        raise AssertionError(f"loaded step {bf16.step}, saved {trainer.step}")
    log(f"phase 5: checkpoint of {len(saved)} tensors at step {bf16.step} loaded back bit for bit")
    del trainer, saved, loaded
    torch.cuda.empty_cache()
    bf16_ms, _ = timed_train(bf16, 1 + TRAIN_STEPS, "bf16")
    files, _, sample_loss = bf16.sample_and_save(milestone="smoke", use_ema=True)
    if not math.isfinite(sample_loss) or len(files) != 2 * len(samples):
        raise AssertionError(f"sample_and_save: loss {sample_loss}, {len(files or [])} files")
    del bf16
    torch.cuda.empty_cache()

    # the same 32 px step on the card and on the CPU
    small = SyntheticFEADataset(TRAIN_BATCH, 32, SEED + 2)
    cpu = Trainer(trainer_config(32, results / "cpu"), dataset=small, sample_dataset=small,
                  device="cpu")
    card = Trainer(trainer_config(32, results / "card"), dataset=small, sample_dataset=small,
                   device=device)
    for key, module in card.modules.items():
        module.load_state_dict(cpu.modules[key].state_dict())
    card.ema_params = {k: [p.detach().clone() for p in v] for k, v in card.params.items()}
    loss_cpu = float(cpu._train_step(cpu._fetch_batch(0)))
    loss_card = float(card._train_step(card._fetch_batch(0)))
    grad_err = max(
        rel_err(a.cpu(), b)
        for key in card.opt_states
        for a, b in zip(card.opt_states[key].mu, cpu.opt_states[key].mu)
        if b.abs().max() > 0
    )
    log(
        f"phase 5: one 32 px step, card vs CPU: loss {loss_card:.7f} vs {loss_cpu:.7f}; "
        f"gradient (Adam first moment) max rel err {grad_err:.3e}"
    )
    if abs(loss_card - loss_cpu) > STEP_LOSS_RTOL * abs(loss_cpu) or grad_err > STEP_GRAD_REL:
        raise AssertionError("the 32 px step differs between the card and the CPU")
    return f32_ms, bf16_ms, launches


def phase_diffusion_train(device, results):
    from fea_tpu_torch.train import DiffusionConfig, DiffusionTrainer

    data = SyntheticFEADataset(16, IMAGE, SEED + 3)
    trainer = DiffusionTrainer(DiffusionConfig(
        dataset_image_size=IMAGE, train_batch_size=DIFFUSION_BATCH, num_train_steps=1,
        num_steps_per_milestone=10**9, input_dim=64, num_stages=4,
        skip_dataset_size_check=True, results_folder=str(results / "diffusion"), seed=SEED,
    ), dataset=data, device=device)
    trainer.train()  # the warm-up step, and a checkpoint
    trainer.config.num_train_steps = 1 + DIFFUSION_STEPS
    reset_counts()
    loss = trainer.train()
    launches = counts()
    want = (0, 9 * DIFFUSION_STEPS, 9 * DIFFUSION_STEPS)
    if launches != want or not math.isfinite(loss):
        raise AssertionError(f"diffusion train: loss {loss}, launches {launches}, want {want}")
    times = []
    for i in range(DIFFUSION_STEPS):
        x0, cond = trainer._fetch(i * DIFFUSION_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_loss = trainer._train_step(x0, cond)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(step_loss):
            raise AssertionError(f"diffusion step loss {float(step_loss)}")
    log(
        f"phase 6: diffusion batch {DIFFUSION_BATCH} at {IMAGE} px: train() loss {loss:.5f}, "
        f"launches {launches}; ms per step " + ", ".join(f"{t:.3f}" for t in times)
    )
    return float(np.mean(times))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="TREE",
                        help="also time the kernels of this checkout, as `earlier`")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from fea_tpu_torch.ops.flash_attention import build as build_flash
    from fea_tpu_torch.ops.fused_norm import build as build_group_norm
    from fea_tpu_torch.utils.device import cuda_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = cuda_device()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    builds = [build_flash, build_group_norm]
    earlier = None
    if args.against:
        earlier = load_ops(args.against)
        builds += [importlib.import_module(f"earlier_ops.{name}").build
                   for name in ("flash_attention", "fused_norm")]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source, started together
        libs = list(pool.map(lambda build: build(), builds))
    log(f"set-up: kernels built in {time.perf_counter() - t0:.1f} s")
    for lib in libs[:2]:
        log(f"  {lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log("  nvcc: " + line.strip())

    results = Path(__file__).resolve().parent / "results" / "chip_smoke"
    shutil.rmtree(results, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        err, flash_ms = phase_kernel(device, earlier)
        log(f"phase 1 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches = phase_sampler(device)
        log(f"phase 2 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_predictor(device)
        log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        gn = phase_group_norm(device, earlier)
        log(f"phase 4 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        f32_ms, bf16_ms, (_, gn_fwd, gn_bwd) = phase_regression_train(device, results)
        log(f"phase 5: ms per train step at batch {TRAIN_BATCH}: f32 {f32_ms:.3f}, "
            f"bf16 {bf16_ms:.3f}")
        log(f"phase 5 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        diffusion_ms = phase_diffusion_train(device, results)
        log(f"phase 6: ms per diffusion train step at batch {DIFFUSION_BATCH}: {diffusion_ms:.3f}")
        log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(results, ignore_errors=True)

    bh, nq, nk, d = FLASH_SHAPE
    # the function's two products, 4 BH Nq Nk D operations, at the rate of
    # the unit that runs them; the kernel's 3xTF32 does three times as many
    flash_ops = 4 * bh * nq * nk * d
    flash_bound, flash_by = bound_ms(
        4 * (2 * bh * nq * d + 2 * bh * nk * d), flash_ops, TF32_TENSOR_FLOPS)
    log(f"flash bound {flash_bound:.4f} ms ({flash_by}: {flash_ops / 1e9:.3f} GFLOP at the "
        f"TF32 tensor-core peak); the 3xTF32 method's own floor "
        f"{3 * flash_ops / TF32_TENSOR_FLOPS * 1e3:.4f} ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    gn_source = "fea_tpu_torch/csrc/group_norm_silu.cu"
    log(json.dumps({"kernels": [
        {
            "name": "flash_attention", "route": "cuda",
            "source": "fea_tpu_torch/csrc/flash_attention.cu",
            "replaces": "fea_tpu/ops/flash_attention.py:26",
            "launches": launches, "max_abs_err": err, "ms": flash_ms["kernel"],
            "plain_ms": flash_ms["plain"], "bound_ms": flash_bound, "bound_by": flash_by,
            "library_ms": flash_ms["library"], "bound_unit": "tensor cores, TF32 at 495 TFLOP/s",
            **({"earlier_ms": flash_ms["earlier"]} if earlier is not None else {}),
            "redesigned": REDESIGNED["flash_attention"],
        },
        {
            "name": "group_norm_silu_fwd", "route": "cuda", "source": gn_source,
            "replaces": "fea_tpu/ops/fused_norm.py:115", "launches": gn_fwd, **gn["fwd"],
        },
        {
            "name": "group_norm_silu_bwd", "route": "cuda", "source": gn_source,
            "replaces": "fea_tpu/ops/fused_norm.py:132", "launches": gn_bwd, **gn["bwd"],
            "redesigned": REDESIGNED["group_norm_silu_bwd"],
        },
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
