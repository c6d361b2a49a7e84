"""Drive the PyTorch port's serving, training and datagen paths once on one
CUDA card.

    python3 chip_smoke.py [--against TREE] [--only PHASES]

Set-up: TF32 off for matmuls (PyTorch's default, which the FEM requires);
the model's f32 convolutions at the port's precision policy
(fea_tpu_torch/utils/precision.py: tf32), as `python -m fea_tpu_torch`
runs them, and nothing in this script sets cuDNN's precision for the
process: a check whose tolerance holds strict f32 runs its model work
inside model_precision(conv="ieee"). The five kernel libraries (flash
attention, fused GroupNorm+SiLU, the CG loop, the band operator, linear
attention) are built at once, one nvcc each, from fea_tpu_torch/csrc into
fea_tpu_torch/_build.
Phase 1: the flash kernel (tensor cores: 3xTF32 for f32, bf16 products
         for bf16) against its plain PyTorch version at the sampler's shape
         (BH 8, Nq 1024, Nk 1028, D 32), a ragged one and stage 2 of full
         attention (BH 8, Nq 4096, Nk 4100, D 32), f32 (the wgmma route) and
         bf16 (mma.sync), each line naming the route and launches_wgmma
         counting the wgmma ones; at the sampler's shape timed on the device
         beside the plain version, F.scaled_dot_product_attention and, in
         f32, the mma.sync kernel the route no longer gives f32 at D 32.
Phase 2: the conditional-DDPM sampler at full width (FDNUNet input_dim 64,
         4 stages, 256 px, flash attention, random seeded weights) answers
         2 requests with 25 denoising steps; the flash kernel must have
         launched 3 x 25 times, the GroupNorm+SiLU forward 9 x 25 and the
         linear-attention kernels 6 x 25 (a call: their three launches); at
         ieee, the output must agree with the same sampler run through plain
         attention, and the card with the CPU on a small input. Then the
         linear-attention kernels at stage 0 (b2, 4 heads of 32, 65,536
         pixels and 4 memory slots) against their plain version (the einsum
         chain), timed beside it and beside the chain's two cuBLAS products
         alone (the library yardstick; the port no longer calls them there).
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
         coefficients), and at batches 2 and 4 the kernels alone; each
         timed shape's line names the route the forward took (one cluster
         per (b, group) with x read once, or two launches).
Phase 5: the regression Trainer at full width (input_dim 64, 4 stages,
         256 px, batch 16, EMA, all three Adam chains) on a seeded synthetic
         dataset: train() takes a warm-up step and 3 more in f32 (18 + 18
         GroupNorm+SiLU launches per step), its checkpoint loads back bit for
         bit into a bf16 trainer, which takes 4 steps; one 32 px step on the
         card at ieee against the same step on the CPU.
Phase 6: the DiffusionTrainer at full width (FDNUNet input_dim 64, 4 stages,
         256 px, batch 4): train() takes a warm-up step and 2 more (9 + 9
         launches per step).
Phase 7: training from the condition store held on the card. A small PNG
         dataset (8 plates x 4 conditions x 6 steps, 256 px, from a seed) is
         written with PIL and built into a store, whose samples must equal
         the PNG dataset's; the store's arrays are tiled to the production
         count (4,000 plates, 16,000 conditions; fewer where the disk is
         small or slow, and the line says so) and the full-width regression
         Trainer runs from it at batch 16 with `dataset_store` and
         `device_resident_store`, f32 then bf16, a warm-up and 3 timed steps
         each. The tables must be on the card and every micro-batch
         assembled from them (18 + 18 GroupNorm+SiLU launches per step);
         a batch assembled on the card must equal the store's samples for
         the same indices bit for bit.
Phase 8: one plate's FEM problem on the card: the gusset pentagon meshed by
         the CDT library (built with g++) at mesh_size 1e-2, two material
         regions, the gusset application's supports and loads. The f32
         solve must converge, agree with the host's f64 direct solve within
         1e-3 of the largest displacement, with the CPU's f32 solve within
         1e-4, and with itself bit for bit when run again in longer blocks; solve_refined and
         the f64 solve on the card within 1e-8; structurally_singular False
         here and True with one pinned node.
Phase 9: one flat datagen chunk at the production shape: 4 plates of the
         seeded GeometrySampler at mesh 1e-2 x 4 seeded conditions (16
         lanes), padded to their common buckets, with the scheduler's
         budget, solved through the solve worker with the band and with
         the incidence operator (the CG loop through its kernels, a block
         of bodies replayed as one CUDA graph; the band through its
         non-zeros, csrc/band_matvec.cu). Every converged lane within 1e-3 of the
         host's f64 direct solve, the operators within 1e-4 on the lanes
         both end under a residual of 1e-4, the chunk bit-identical when
         solved again; prints ms per chunk and per loop body, iterations
         per lane, host reads, device kernels per body (operator,
         preconditioner, the rest), the band operator's bytes per
         iteration (its non-zeros, beside the dense band's), peak memory.
Phase 10: generate_data_batched at bench.py's config (512 px, 4 conditions
         x 6 steps, mesh 1e-2, displacement images): 4 warm-up plates, 16
         timed; plates per hour, the solve counters, the StageTimer
         breakdown, ms per loop body inside the scheduler, peak memory;
         every plate directory holds the reference's file set with finite
         ranges; two runs of 2 plates from one seed write the same bytes;
         the timed run's launches of the CG loop's kernels and the band
         operator's (the main path's count for the kernels line; each
         must have launched).
Phase 11: the regression Trainer at full width from
         InMemoryFEADataset.generate (2 plates x 4 conditions x 6 steps,
         256 px, mesh 2e-2, seed 11): a warm-up and one timed f32 step,
         18 + 18 GroupNorm+SiLU launches per step.
Phase 12: the diffusion denoiser at full width with full attention at
         every stage and the self-conditioning input (FDNUNet input_dim
         64, 4 stages, flash attention, self_condition: 2 condition
         channels, seeded weights). At 64 px one forward at ieee against the same model
         through plain attention; at 256 px, batch 2, one forward: 9 flash
         launches (one per FullAttention site), all 9 on the wgmma
         route, and 9 GroupNorm+SiLU; its stage-0 flash call (BH 8, Nq
         65,536, Nk 65,540, D 32) against the plain version on its first
         and last 1,024 query rows over every key; device
         ms of the forward and of the stage-0 call beside its bound and
         scaled_dot_product_attention's memory-efficient backend.
Phase 13: the pipeline end to end through the port's CLI
         (`fea_tpu_torch.cli.main` in this process, and `python -m
         fea_tpu_torch --help` once as a subprocess): generate --batched
         (6 train plates, seed 1234; 2 held-out, seed 99; 4 conditions x 6
         steps, mesh 1e-2, 512 px, meshes saved) and one sequential plate at
         256 px, every plate with the reference's file set; store (samples
         equal the PNG dataset's); train at full width from the store held
         on the card with EMA, 40 steps and one milestone (18 + 18
         GroupNorm+SiLU launches per step, 18 per sample batch, the log's
         40 steps); sample raw and with EMA (18 per batch) and accuracy on
         both (finite MAE / MSE / RMSE); app gusset at 512 px with the
         checkpoint's EMA weights (converged, raster round trip under
         1e-2, its images within 1 gray level of the same app on the CPU);
         train-diffusion at batch 4, 3 steps (9 + 9 per step). Prints each
         command's seconds, peak device memory and bytes written.
Phase 14: data parallelism (fea_tpu_torch.parallel). (a) The phase 5
         Trainer, 3 steps, with no process group and in an NCCL group of one
         rank (cuDNN deterministic): the states equal bit for bit. (b) Two
         gloo ranks on this card (parallel.launch) at the same global batch
         of 16, 8 rows each: both ranks' states equal bit for bit, the first
         loss and reduced gradients within 1e-4 / 1e-3 of (a)'s one-rank
         step (each first step at ieee, the others at the policy's), 18 + 18 GroupNorm+SiLU launches per step in every rank, one
         checkpoint written by rank 0, sample_and_save through the row
         gather; ms per step, peak memory, ms per all-reduce of the
         gradients and per gather of a sample batch's rows, per rank. (c)
         The DiffusionTrainer at full width, batch 4, two gloo ranks
         against one (9 + 9 per step per rank). (d) generate_data_batched
         at bench.py's config, 4 plates from one seed, on 2 shards of this
         card against 1: the same files, PNGs within 1 gray level, ranges
         within 1e-4 of their span, where both runs ended under a residual
         of 1e-4; LAST_DISPATCH; phase 9's chunk, cold and warm started, on
         2 shards, each shard's rows bit for bit those of the unsharded
         chunk of its own plates. (e)
         measure_sharding_efficiency(2) on this card. (f) Two NCCL ranks on
         two cards, where there are two; else a line says it did not run.
Phase 15: band-block Jacobi, the solver variant the port takes from
         fea_tpu's switches, on phase 9's chunk: the default and blocks of
         128 and 256. Per variant: iterations over the lanes (sum, median,
         max), loop bodies and host reads, set-up and loop seconds, ms and
         device kernels per body, peak memory, and every converged lane
         within 1e-3 of the host's f64 direct solve (raises otherwise, or
         where no lane converges). generate_data_batched at bench.py's
         config, 16 plates from phase 10's timed seed, the default and
         blocks of 128 and 256 in turns (twice each): plates per hour, the
         solve counters, and each variant's tree against the default's:
         the same files and sampled inputs, and on the conditions that
         ended under a residual of 1e-4 in both, PNGs within 1 gray level
         and ranges within 1e-3 of their span (raises otherwise).
         Measurements: no variant becomes a default.
Phase 16: the CG loop's kernels (csrc/cg_segmented.cu) and the band
         operator's (csrc/band_matvec.cu) on phase 9's chunk. At the loop's
         state 20 bodies in, each of the five launches (cg_alpha,
         cg_update_xr, jacobi_restrict, prolong_dots, cg_update_p) against
         its plain version on the same inputs (within 1e-5 of each
         output's span), both timed in turns beside the bytes bound; the
         band kernel on p against its plain version and the dense band's
         product (within 1e-5 of y's span), the three timed in turns
         beside one cuSPARSE call (torch.mv on a block-diagonal CSR of the
         same tables) and the bound of the non-zeros' bytes, with the
         non-zeros a lane and the slots a row. The chunk solved through
         the plain versions on the card
         (torch ops that copy into the loop's state in place: not the
         parent's loop), the kernels without a graph, and the kernels in a
         CUDA graph per block, in turns, 3 runs each: ms per body and per
         chunk (median, min, max), device kernels per body (at most 10 on
         the kernels' and the graph's routes), every converged lane within 1e-3 of the
         host's f64 direct solve, each route repeated bit for bit, the graph
         bit for bit the kernels' route, and within 1e-4 of the plain route's
         on the lanes that both end under a residual of 1e-4. Blocks of 8,
         16 and 32 bodies between host reads: ms, host reads, the same rows.
         Two datagen runs of 2 plates from one seed: the same bytes.
         Under `--against TREE` the other checkout's five CG kernels and
         band kernel are timed in the same turns (`earlier`; its cg_alpha
         on a copy of the state with the scratch it took): its run and lane
         flags, x, r, zj, rc, z, p and band product bit for bit this tree's
         (alpha within the tolerance: pAp is summed in another order). The
         five CG kernels print their launch plans and TB/s over the bytes
         they move (the bound's), the band kernel over the bytes it is
         modelled to move (each slice up to its widest row) beside the
         bound's.
Phase 17: the model's precision: the sampler's FDNUNet forward at 256 px,
         batches 2 and 4, the regression predict at batch 4 and one f32
         regression train step at batch 16, each at ieee, at tf32 (the
         shipped setting) and in bf16 (the yardstick, a setting a package
         ships: the FDNUNet's convolutions in one bf16 pass, as on
         fea_tpu's TPU; the Trainer's compute_dtype="bfloat16" route for
         predict and the step), timed in turns; the differences of tf32
         and bf16 from ieee (outputs; the step's loss and largest relative
         gradient difference of a module). Raises where tf32 differs by
         more than bf16, or not at all.
Phase 18: ADM (guided-diffusion's 256 px UNet, fea_tpu_torch/models/adm.py)
         at its published widths, every parameter drawn from a seed (the
         ones ADM initializes to zero too): at 64 px, batch 2, one forward
         at ieee within ADM_IEEE_REL of the benchmark's plain reference
         (portbench/reference/adm.py, strict f32) and one at the policy's
         tf32 within the `adm-256-concat` configuration's pred_gap; at 256
         px, batch 2, one forward: 16 flash launches, all at head dim 64
         (none on the wgmma route), at the shapes counts/adm.py gives, and
         43 GroupNorm+SiLU forwards; device ms a forward; flash at each of
         its D-64 shapes and GroupNorm+SiLU (32 groups, eps 1e-5) at each
         (channels, pixels) of that forward, against the plain versions
         within F32_TOL; a 25-step `GaussianDiffusion.sample`, counted from
         just before it: 400 flash and 1,075 GroupNorm+SiLU launches, 25
         graph replays, 24 learned-range steps and one final step.

Phases 2, 3, 5, 6, 7, 11, 12, 13 and 14 print the precision the model's
convolutions ran at, read at every nn.Conv2d by a global module hook over
the warm-up (a hook slows every module call, so timed runs go without).

Kernel times are device times: CUDA events around calls that the host
queued behind a device-side wait, each function timed in turns.
`--against TREE` also times the kernels of another checkout of this repo
(for example the parent commit, `git archive` unpacked into a git-ignored
directory) in the same turns, as `earlier`; they build into that
checkout's fea_tpu_torch/_build.

The stores (about 7.6 GB at the production count), the checkpoints and
the datagen trees are written under results/chip_smoke/ and deleted at
the end. `--only 9,10,11` runs only those phases (any of 1 to 18; the
card's name and power limit after them, no result line; phase 15 prints
phase 10's plates per hour where 10 runs before it, phase 7 phase 5's ms
per step).

Prints the card, a JSON line of the kernels, and as its last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then not 0 and no result line is printed. Needs CUDA; exits 1 without it.
"""

import argparse
import copy
import functools
import importlib
import importlib.util
import inspect
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from unittest import mock
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

SEED = 0
SAMPLER_STEPS = 25
SAMPLER_BATCH = 2
PREDICT_BATCH = 4
IMAGE = 256
FLASH_SHAPE = (8, 1024, 1028, 32)  # BH = 4 heads x batch 2, 32x32 px + 4 memory-KV
RAGGED_SHAPE = (3, 100, 68, 32)
STAGE2_SHAPE = (8, 4096, 4100, 32)  # stage 2 of full attention at 256 px
F32_TOL = dict(atol=2e-5, rtol=1e-4)  # only the order of summation differs
BF16_ATOL = 1e-2  # one bf16 rounding of the output
FLASH_VS_PLAIN_ATOL = 5e-4  # one forward: fea_tpu's flash-vs-math bound
SAMPLE_ATOL = 1e-3  # 25 steps, compared on the clipped output
CPU_ATOL = 1e-4  # card vs CPU on a small input, f32 without TF32
# the redesigned kernels' designs, for the kernels line
REDESIGNED = {
    "flash_attention": "tensor-core mma.sync, 3xTF32 for f32; each KV tile's P.V accumulated "
                       "apart and added to the running sum by a rounded FMA; f32 at D 32 on "
                       "wgmma, K and V split to TF32 once a call (a "
                       "pre-pass in wgmma's swizzled layout, V transposed), q once a block, "
                       "tiles fed by TMA bulk copies to two consumer warpgroups",
    "group_norm_silu_fwd": "x read once into a thread-block cluster's shared memory; "
                           "two launches with 16-byte vectors where a group does not fit",
    "group_norm_silu_bwd": "two launches over the forward's saved coefficients",
    "cg_alpha": "one thread-block cluster per segment, 16-byte loads, the sums through rank 0's "
                "shared memory (no partials, tickets or atomics in device memory)",
    "prolong_dots": "one thread-block cluster per segment, 16-byte loads, the sums through rank "
                    "0's shared memory (no partials, tickets or atomics in device memory)",
    "cg_update_p": "a grid of blocks per segment, flags and beta read once a block, stopped "
                   "segments skipped whole, 16-byte loads",
    "cg_update_xr": "a grid of blocks per segment, the lane flag and alpha read once a block, "
                    "stopped lanes skipped whole, 16-byte loads",
    "jacobi_restrict": "the Jacobi term on a grid of blocks per lane with 16-byte loads; the "
                       "restriction a warp per aggregate for all lanes of a pass, the member "
                       "table and arms read once, a row of padding leaving after its first load",
    "band_matvec": "each block's slices staged by TMA bulk copies up to their widest row",
}
# the linear-attention kernels' design, for the kernels line (written for
# the port: fea_tpu leaves these einsums to XLA)
LINEAR_ATTENTION_DESIGN = (
    "three launches: the pixel reduction split over one wave of blocks, k and v staged by "
    "16-byte cp.async a tile ahead, p = exp(k - m) with an online max, p v^T in register "
    "blocks; the chunks' partials and the memory slots combined in a fixed order; q's "
    "softmax over d and ctx^T q in register blocks, 16-byte stores; strict f32, no atomics")
# the modulated GroupNorm+SiLU forward's design, for the kernels line
MODULATED_DESIGN = (
    "the fused forward's kernels instantiated per modulation: per (b, c) scale and shift "
    "folded into the coefficients, per pixel read beside x in the pass that writes y; "
    "forward only, channels-last operands copied to NCHW first")
# b, heads, h, w of the sampler's stage-0 linear attention at 256 px
LINEAR_ATTENTION_SHAPE = (2, 4, 256, 256)
LINEAR_ATTENTION_SLOTS = 4


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


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


EARLIER = "earlier_fea_tpu_torch"  # the package name another checkout's port loads under
# the modules of fea_tpu_torch.ops that bind a CUDA library
KERNEL_MODULES = ("flash_attention", "fused_norm", "cg", "band", "linear_attention")


def load_ops(tree, package=EARLIER):
    """The `fea_tpu_torch.ops` package of another checkout: that checkout's
    whole `fea_tpu_torch` loaded as the package `package`, so that each of
    its modules imports its own siblings and binds its own kernels' entry
    points; its kernels build into that checkout's _build."""
    path = Path(tree).resolve() / "fea_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        package, path / "__init__.py", submodule_search_locations=[str(path)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[package] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{package}.ops")


def earlier_module(earlier, name):
    """The module `name` of the ops package `earlier` (`load_ops`)."""
    return importlib.import_module(f"{earlier.__name__}.{name}")


def library_build(module):
    """The function that builds the native library of the kernel module
    `module`: its binder's `build` (`ops/_build.py` `bind`), or the module's
    own `build` in a checkout from before the binder."""
    return getattr(module, "LIBRARY", module).build


def earlier_band(earlier):
    """The band kernel of the ops package `earlier` (`load_ops`), as fn(vals,
    cols, u, y, widths): that checkout's own wrapper, given the width
    table where its signature takes one."""
    band_matvec = earlier_module(earlier, "band").band_matvec
    if "widths" in inspect.signature(band_matvec).parameters:
        return band_matvec
    return lambda vals, cols, u, y, widths: band_matvec(vals, cols, u, y)


def loop_wrappers():
    """The wrappers of the CG loop's kernels and the band operator's."""
    from fea_tpu_torch.ops import band, cg

    return cg.WRAPPERS + (band.band_matvec,)


def reset_counts():
    from fea_tpu_torch.ops import flash_attention, group_norm_silu
    from fea_tpu_torch.ops.fused_norm import group_norm_modulated_silu
    from fea_tpu_torch.ops.linear_attention import linear_attention

    flash_attention.launches = flash_attention.launches_wgmma = 0
    linear_attention.launches = 0
    group_norm_silu.launches_fwd = group_norm_silu.launches_bwd = 0
    group_norm_modulated_silu.launches = 0
    for wrapper in loop_wrappers():
        wrapper.launches = 0


def cg_counts():
    """{name: launches} of the CG loop's kernels and the band operator's."""
    return {wrapper.__name__: wrapper.launches for wrapper in loop_wrappers()}


def counts():
    """(flash, GroupNorm+SiLU forward, GroupNorm+SiLU backward) launches."""
    from fea_tpu_torch.ops import flash_attention, group_norm_silu

    return flash_attention.launches, group_norm_silu.launches_fwd, group_norm_silu.launches_bwd


def modulated_launches():
    """Calls of the modulated GroupNorm+SiLU forward."""
    from fea_tpu_torch.ops.fused_norm import group_norm_modulated_silu

    return group_norm_modulated_silu.launches


def modulated_calls(forward, limit=None):
    """Every call of the modulated GroupNorm+SiLU forward that `forward()`
    makes (the first `limit` where given), read where the blocks call it
    (`models.blocks`), with its arguments cloned in their layouts: [(x,
    gamma, beta, scale, shift, groups, eps)]."""
    from fea_tpu_torch.models import blocks

    calls, entry = [], blocks.group_norm_modulated_silu

    def recording(*args):
        if limit is None or len(calls) < limit:
            calls.append(tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args))
        return entry(*args)

    with mock.patch.object(blocks, "group_norm_modulated_silu", recording):
        forward()
    torch.cuda.synchronize()
    return calls


def modulated_copies(calls):
    """The operands of `calls` (`modulated_calls`) that the modulated
    forward copies to contiguous NCHW first: x, and per pixel scale and
    shift, where not contiguous."""
    return sum(not t.is_contiguous() for x, _, _, scale, shift, _, _ in calls
               for t in ((x, scale, shift) if scale.shape == x.shape else (x,)))


def modulated_bytes(x, scale):
    """The modulated forward's bytes bound: x, per-pixel scale and shift
    read once and y written once."""
    tensors = 4 if scale.shape == x.shape else 2
    return tensors * x.numel() * x.element_size()


def check_modulated(tag, calls):
    """The modulated forward at each of `calls` (`modulated_calls`) against
    its plain version, PyTorch's chain (f32: fea_tpu's forward bounds);
    then the calls, as one forward makes them, timed in turns: the kernels
    (with the copies of channels-last operands), the kernels on operands
    copied beforehand, and the chain, beside the bytes bound. The kernels
    line's entry."""
    from fea_tpu_torch.ops.fused_norm import (
        forward_plan, group_norm_modulated_silu, group_norm_modulated_silu_reference, modulation)

    worst = 0.0
    seen = set()
    for args in calls:
        x, _, _, scale, shift, groups, eps = args
        mode = modulation(x, scale, shift)
        key = (mode, tuple(x.shape), x.is_contiguous(), scale.is_contiguous())
        if key in seen:
            continue
        seen.add(key)
        with torch.no_grad():
            got = group_norm_modulated_silu(*args)
            want = group_norm_modulated_silu_reference(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **GN_FWD_TOL)
        err = rel_err(got, want)
        worst = max(worst, err)
        dense = [t.contiguous() for t in (x, scale, shift)]
        plan = forward_plan(dense[0], groups, (dense[0].data_ptr() | dense[1].data_ptr()
                                               | dense[2].data_ptr()) if mode == "pixel" else None)
        log(f"{tag}: modulated GroupNorm+SiLU {mode} {tuple(x.shape)} "
            f"({'contiguous' if key[2] and (mode == 'channel' or key[3]) else 'channels-last'} "
            f"in), {groups} groups, route {plan.route} (cluster {plan.cluster}, vec "
            f"{plan.vec}): max abs err over max abs vs plain {err:.3e}")
        del got, want

    def every(fn, calls):
        def run():
            for args in calls:
                fn(*args)
        return torch.no_grad()(run)

    dense = [tuple(t.contiguous() if isinstance(t, torch.Tensor) and t.dim() == 4
                   and t.shape[2:] == args[0].shape[2:] else t for t in args) for args in calls]
    ms = in_turns({"kernel": every(group_norm_modulated_silu, calls),
                   "dense": every(group_norm_modulated_silu, dense),
                   "chain": every(group_norm_modulated_silu_reference, calls)}, 5)
    nbytes = sum(modulated_bytes(args[0], args[3]) for args in calls)
    bound = bytes_ms(nbytes)
    log(f"{tag}: the {len(calls)} modulated GroupNorm+SiLU calls of one forward: kernels "
        f"{ms['kernel']:.4f} ms ({ms['dense']:.4f} ms on operands copied to NCHW beforehand), "
        f"PyTorch's chain {ms['chain']:.4f} ms; bound {bound:.4f} ms (bytes: "
        f"{nbytes / 1e9:.3f} GB), the kernels at {100 * bound / ms['kernel']:.1f}% of it "
        f"({100 * bound / ms['dense']:.1f}% without the copies); largest error {worst:.3e}")
    return dict(calls_a_forward=len(calls), max_rel_err=worst, ms_a_forward=ms["kernel"],
                dense_ms_a_forward=ms["dense"], chain_ms_a_forward=ms["chain"],
                bound_ms_a_forward=bound)


def traced_kernels(fn):
    """{kernel name: launches} on the card while `fn()` runs, by
    torch.profiler's CUDA activity (kernels replayed from a graph
    included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_time_total > 0}


def named(kernels, part):
    """Launches of the kernels whose names contain `part`."""
    return sum(n for name, n in kernels.items() if part in name)


def qkv(shape, device, seed):
    bh, nq, nk, d = shape
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
        for s in ((bh, nq, d), (bh, nk, d), (bh, nk, d))
    )


def max_abs_err(a, b):
    return float((a.float() - b.float()).abs().max())


class ConvPrecisions:
    """Records cuDNN's f32 convolution precision at every nn.Conv2d forward
    from its creation until `stop` (a global module hook, which slows every
    module call a little: timed runs stop it after their warm-up)."""

    def __init__(self):
        self.seen = set()
        self._handle = torch.nn.modules.module.register_module_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        if isinstance(module, torch.nn.Conv2d):
            self.seen.add(torch.backends.cudnn.conv.fp32_precision)

    def stop(self):
        if self._handle is not None:
            self._handle.remove()
            self._handle = None

    def check(self, tag, want=None):
        """Stops, logs the precision the convolutions ran at, and raises
        unless every one ran at `want` (the policy's default when None)."""
        from fea_tpu_torch.utils.precision import DEFAULT_CONV

        self.stop()
        want = want or DEFAULT_CONV
        if self.seen != {want}:
            raise AssertionError(f"{tag}: convolutions ran at {sorted(self.seen)}, want {want}")
        log(f"{tag}: the model ran with cuDNN's f32 convolutions at {want}")
        return want


# modulated GroupNorm+SiLU calls a forward: the DDPM's 20 FDN calls (4 in
# each of 4 down stages, 4 in the middle) and 9 time-modulated ones (block1
# of the 8 up blocks and of final_resnet); ADM's one per ResBlock; the
# regression encoder's 20 FDN calls, wherever it runs without a gradient
# (predict, the trainers' and the CLI's samples, the app)
DDPM_MODULATED = 29
ADM_MODULATED = 42
PREDICT_MODULATED = 20


def phase_kernel(device, earlier):
    """Checks, then {dtype: {name: ms}} at FLASH_SHAPE for the kernel, the
    plain version, the library call and, given `earlier` (another tree's
    ops), its kernel; in f32 also the mma.sync kernel at that shape."""
    from fea_tpu_torch.ops.flash_attention import (
        _launch, flash_attention, flash_attention_reference, route)

    errs = {}
    for shape in (FLASH_SHAPE, RAGGED_SHAPE, STAGE2_SHAPE):
        q, k, v = qkv(shape, device, SEED)
        kernel = route(torch.float32, shape[3])
        before = flash_attention.launches_wgmma
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        if flash_attention.launches_wgmma != before + (kernel == "wgmma"):
            raise AssertionError(f"{shape}: launches_wgmma {before} -> "
                                 f"{flash_attention.launches_wgmma} on the {kernel} route")
        want = flash_attention_reference(q, k, v)
        errs[shape, "f32"] = max_abs_err(got, want), kernel
        torch.testing.assert_close(got, want, **F32_TOL)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        got = flash_attention(qb, kb, vb)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 kernel returned {got.dtype}")
        want = flash_attention_reference(qb, kb, vb)
        errs[shape, "bf16"] = max_abs_err(got, want), "mma_sync"
        torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL, rtol=0)
    q, k, v = qkv(RAGGED_SHAPE, device, SEED)
    try:
        flash_attention(q.requires_grad_(), k, v)
    except RuntimeError:
        pass  # the kernel has no backward, and says so
    else:
        raise AssertionError("flash_attention took a q that requires grad")
    for (shape, dtype), (err, kernel) in errs.items():
        tol = F32_TOL if dtype == "f32" else dict(atol=BF16_ATOL, rtol=0)
        log(f"phase 1: flash {shape} {dtype}, {kernel} route: max abs err vs plain {err:.3e} "
            f"(tolerance {tol})")
    log(f"phase 1: launches_wgmma {flash_attention.launches_wgmma} of launches "
        f"{flash_attention.launches}")

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in qkv(FLASH_SHAPE, device, SEED))
        fns = {
            "kernel": lambda: flash_attention(q, k, v),
            "plain": lambda: flash_attention_reference(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(q, k, v),
        }
        if dtype == torch.float32:  # the kernel f32 at D 32 took before the wgmma route
            fns["mma_sync"] = lambda: _launch(q, k, v, FLASH_SHAPE[3] ** -0.5, wgmma=False)
        if earlier is not None:
            fns["earlier"] = lambda: earlier.flash_attention(q, k, v)
        ms = times[dtype] = in_turns(fns, 50)
        log(
            f"phase 1: flash {FLASH_SHAPE} {str(dtype)[6:]}: kernel {ms['kernel']:.4f} ms "
            f"({route(dtype, FLASH_SHAPE[3])} route), "
            f"plain {ms['plain']:.4f} ms, scaled_dot_product_attention {ms['library']:.4f} ms"
            + (f", the mma.sync kernel {ms['mma_sync']:.4f} ms" if "mma_sync" in ms else "")
            + (f", earlier kernel {ms['earlier']:.4f} ms" if earlier is not None else "")
            + " per call"
        )
    return errs[FLASH_SHAPE, "f32"][0], times[torch.float32]


def phase_sampler(device):
    from fea_tpu_torch.models import make_diffusion_model
    from fea_tpu_torch.models.diffusion import GaussianDiffusion
    from fea_tpu_torch.models.fdnunet import FDNUNet
    from fea_tpu_torch.ops.linear_attention import linear_attention
    from fea_tpu_torch.utils.precision import model_precision

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

    recorder = ConvPrecisions()
    diffusion.sample(condition, 2, noise=noise[:3])  # warm-up: cuDNN picks algorithms
    torch.cuda.synchronize()
    conv = recorder.check("phase 2")

    reset_counts()
    t0 = time.perf_counter()
    out = diffusion.sample(condition, SAMPLER_STEPS, noise=noise)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, gn_fwd, gn_bwd = counts()
    linear = linear_attention.launches  # calls, three launches each
    modulated = modulated_launches()
    if (launches, gn_fwd, gn_bwd, linear, modulated) != (
            3 * SAMPLER_STEPS, 9 * SAMPLER_STEPS, 0, 6 * SAMPLER_STEPS,
            DDPM_MODULATED * SAMPLER_STEPS):
        raise AssertionError(
            f"flash / GroupNorm+SiLU forward / backward / linear attention / modulated "
            f"GroupNorm+SiLU launched {launches} / {gn_fwd} / {gn_bwd} / {linear} / {modulated} "
            f"times, want {3 * SAMPLER_STEPS} / {9 * SAMPLER_STEPS} / 0 / {6 * SAMPLER_STEPS} / "
            f"{DDPM_MODULATED * SAMPLER_STEPS}"
        )
    if out.shape != (SAMPLER_BATCH, IMAGE, IMAGE, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"sampler output {tuple(out.shape)} is not finite or not the shape")
    log(
        f"phase 2: sampler batch {SAMPLER_BATCH}, {SAMPLER_STEPS} steps, convolutions at "
        f"{conv}: {wall * 1e3:.2f} ms per call, {wall * 1e3 / SAMPLER_STEPS:.3f} ms per "
        f"denoising step, {wall * 1e3 / SAMPLER_BATCH:.2f} ms per request; "
        f"flash launches {launches}, GroupNorm+SiLU forward launches {gn_fwd}, "
        f"linear-attention calls {linear} ({3 * linear} launches, three a call), modulated "
        f"GroupNorm+SiLU calls {modulated}"
    )
    modulated_entry = dict(launches=modulated,
                           **phase_sampler_modulated(diffusion, model, condition, noise, device))
    with model_precision(conv="ieee"):
        check_sampler(diffusion, model, condition, noise, out, device)
    return launches, dict(linear_attention_stage0(device), launches=3 * linear, calls=linear), \
        modulated_entry


def phase_sampler_modulated(diffusion, model, condition, noise, device):
    """Phase 2's modulated GroupNorm+SiLU: every call of one forward against
    the plain version and timed against PyTorch's chain; then a traced
    2-step sample (graph replays), which must launch no PyTorch GroupNorm
    kernel (`RowwiseMomentsCUDAKernel`)."""
    from fea_tpu_torch.utils.precision import model_precision

    t = torch.full((SAMPLER_BATCH,), 500.0, device=device)
    calls = modulated_calls(model_precision()(torch.no_grad()(
        lambda: model(noise[0], condition, time=t))))
    if len(calls) != DDPM_MODULATED:
        raise AssertionError(f"a forward made {len(calls)} modulated calls, want "
                             f"{DDPM_MODULATED}")
    copies = modulated_copies(calls)
    log(f"phase 2: one forward's modulated calls copy {copies} channels-last operands to NCHW")
    entry = dict(check_modulated("phase 2", calls), copies_a_forward=copies)
    del calls
    reset_counts()
    kernels = traced_kernels(lambda: diffusion.sample(condition, 2, noise=noise[:3]))
    modulated = modulated_launches()
    moments = named(kernels, "RowwiseMomentsCUDAKernel")
    ours = {name: n for name, n in kernels.items()
            if any(k in name for k in ("fwd_cluster", "fwd_stats", "fwd_apply"))}
    log(f"phase 2: a traced 2-step sample (graph replays): {modulated} modulated calls, "
        f"PyTorch GroupNorm moments kernels {moments}; the fused forward's kernels "
        + "; ".join(f"{name} x{n}" for name, n in sorted(ours.items())))
    if moments or modulated != 2 * DDPM_MODULATED:
        raise AssertionError(f"a 2-step sample launched {moments} PyTorch GroupNorm moments "
                             f"kernels and {modulated} modulated calls, want 0 and "
                             f"{2 * DDPM_MODULATED}")
    torch.cuda.empty_cache()
    return dict(entry, traced_moments_kernels=moments)


def linear_attention_stage0(device):
    """The linear-attention kernels at LINEAR_ATTENTION_SHAPE against their
    plain version (the einsum chain), then timed in turns beside it and
    beside the chain's two cuBLAS products alone, on its softmaxed operands
    (`library_ms`); the kernels line's entry without its launches."""
    from fea_tpu_torch.ops.linear_attention import linear_attention, linear_attention_reference

    b, heads, h, w = LINEAR_ATTENTION_SHAPE
    d, n, slots = 32, h * w, LINEAR_ATTENTION_SLOTS
    rng = np.random.default_rng(SEED)
    qkv = torch.from_numpy(rng.normal(size=(b, 3 * heads * d, h, w)).astype(np.float32)).to(device)
    mem = torch.from_numpy(rng.normal(size=(2, heads, d, slots)).astype(np.float32)).to(device)
    with torch.no_grad():
        got = linear_attention(qkv, mem, heads, d)
        want = linear_attention_reference(qkv, mem, heads, d)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        torch.testing.assert_close(got, want, **F32_TOL)
        q, k, v = (t.reshape(b, heads, d, n) for t in qkv.chunk(3, dim=1))
        k = torch.softmax(torch.cat([mem[0].expand(b, -1, -1, -1), k], dim=-1), dim=-1)
        v = torch.cat([mem[1].expand(b, -1, -1, -1), v], dim=-1)
        q = torch.softmax(q, dim=-2) * d**-0.5
        ms = in_turns({
            "kernel": lambda: linear_attention(qkv, mem, heads, d),
            "plain": lambda: linear_attention_reference(qkv, mem, heads, d),
            "library": lambda: torch.einsum("bhde,bhdn->bhen",
                                            torch.einsum("bhdn,bhen->bhde", k, v), q),
        }, 20)
    # q, k and v read once and the output written once; both products
    nbytes = 4 * 4 * b * heads * d * n
    ops = 2 * b * heads * d * d * (2 * n + slots)
    bound, bound_by = bound_ms(nbytes, ops, F32_FLOPS)
    log(f"phase 2: linear attention {LINEAR_ATTENTION_SHAPE} + {slots} slots: max abs err vs "
        f"plain {err:.3e} (tolerance {F32_TOL}); kernels {ms['kernel']:.4f} ms, plain "
        f"{ms['plain']:.4f} ms, the chain's cuBLAS products alone {ms['library']:.4f} ms, "
        f"bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    return {"name": "linear_attention", "route": "cuda",
            "source": "fea_tpu_torch/csrc/linear_attention.cu",
            "replaces": "none: fea_tpu/models/attention.py:65-66 leaves the einsums to XLA",
            "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": ms["library"],
            "library": "the chain's two cuBLAS einsums", "shape": list(LINEAR_ATTENTION_SHAPE),
            "design": LINEAR_ATTENTION_DESIGN}


def check_sampler(diffusion, model, condition, noise, shipped, device):
    """Phase 2's checks, whose tolerances hold strict f32: the caller runs
    them under model_precision(conv="ieee"). `shipped` is the timed run's
    output at the policy's default, compared for the record only."""
    from fea_tpu_torch.models.diffusion import GaussianDiffusion
    from fea_tpu_torch.models.fdnunet import FDNUNet

    out = diffusion.sample(condition, SAMPLER_STEPS, noise=noise)
    log(f"phase 2: sampler at ieee: max abs diff from the shipped sampler's samples "
        f"{max_abs_err(shipped, out):.3e} (no tolerance: for the record)")

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
        f"phase 2: plain-attention sampler at ieee {wall_plain * 1e3 / SAMPLER_STEPS:.3f} "
        f"ms per denoising step; max abs diff of samples at ieee {err_sample:.3e} "
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
    log(f"phase 2: one forward at ieee, flash vs plain attention: max abs diff {err_forward:.3e}")
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
    log(f"phase 2: FDNUNet 32 px on the card at ieee vs the CPU: max abs diff {err_cpu:.3e}")
    if err_cpu > CPU_ATOL:
        raise AssertionError(f"card and CPU differ by {err_cpu}")


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
    """Phase 3: the regression `predict` at batch PREDICT_BATCH, 256 px:
    timed, its launches counted, a small batch held to the CPU, and its
    modulated GroupNorm+SiLU calls held to PyTorch's chain (`check_modulated`).
    Returns the kernels line's predict fields of the modulated entry."""
    from fea_tpu_torch.models import create_models, predict
    from fea_tpu_torch.utils.precision import model_precision

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
    recorder = ConvPrecisions()
    predict(encoder, decoder, materials, conditions, geometry)  # warm-up
    torch.cuda.synchronize()
    conv = recorder.check("phase 3")
    reset_counts()
    t0 = time.perf_counter()
    iters = 10
    for _ in range(iters):
        out = predict(encoder, decoder, materials, conditions, geometry)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    if counts() != (0, 18 * iters, 0) or modulated_launches() != PREDICT_MODULATED * iters:
        raise AssertionError(f"predictor launches {counts()} and {modulated_launches()} modulated, "
                             f"want (0, {18 * iters}, 0) and {PREDICT_MODULATED * iters}")
    if out.shape != (PREDICT_BATCH, IMAGE, IMAGE, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"predictor output {tuple(out.shape)} is not finite or not the shape")
    outside = geometry[..., 0] < 0
    if not bool((out[outside] == -1.0).all()):
        raise AssertionError("the geometry remask left pixels outside the plate")

    small = [t[:1, :32, :32].contiguous() for t in (materials, conditions, geometry)]
    enc_cpu, dec_cpu = copy.deepcopy(encoder).cpu(), copy.deepcopy(decoder).cpu()
    with model_precision(conv="ieee"):  # CPU_ATOL holds strict f32
        on_card = predict(encoder, decoder, *small).cpu()
    on_cpu = predict(enc_cpu, dec_cpu, *(t.cpu() for t in small))
    err_cpu = max_abs_err(on_card, on_cpu)
    log(
        f"phase 3: predictor batch {PREDICT_BATCH} at {IMAGE} px, convolutions at {conv}: "
        f"{ms:.3f} ms per batch; 32 px card at ieee vs CPU max abs diff {err_cpu:.3e}"
    )
    if err_cpu > CPU_ATOL:
        raise AssertionError(f"card and CPU differ by {err_cpu}")
    calls = modulated_calls(lambda: predict(encoder, decoder, materials, conditions, geometry))
    if len(calls) != PREDICT_MODULATED:
        raise AssertionError(f"a predict forward made {len(calls)} modulated calls, want "
                             f"{PREDICT_MODULATED}")
    entry = check_modulated("phase 3", calls)
    log(f"phase 3: {PREDICT_MODULATED * iters} modulated GroupNorm+SiLU calls in {iters} "
        f"batches, {PREDICT_MODULATED} a forward")
    return {f"predict_{k}": v for k, v in entry.items()} | {
        "launches_predict": PREDICT_MODULATED * iters}


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
    """The kernels against the plain version in every case (and, given
    `earlier`, another tree's ops, the forward's y bit for bit that tree's),
    then their time beside it, the library chain and `earlier`'s kernels, at
    the stage shapes; per-step sums for the kernels' rows."""
    from fea_tpu_torch.ops.fused_norm import (
        forward_plan, group_norm_silu, group_norm_silu_reference, resident_clusters,
    )

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
            if earlier is not None:
                with torch.no_grad():
                    y_earlier = earlier.group_norm_silu(x, gamma, beta, GN_GROUPS, GN_EPS)
                if not torch.equal(got[0], y_earlier):
                    raise AssertionError(f"the forward's y differs from the earlier tree's at "
                                         f"{case}")
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
    # dict by name as fns; at the other batches only the kernels are timed
    per_step = {}
    step_bytes = {"fwd": 0, "bwd": 0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:].replace("float", "f")
        for batch, ((hw, c), calls) in itertools.product(GN_BATCHES, GN_STAGE_CALLS.items()):
            x, gamma, beta, dy = gn_case(device, batch, hw, c, dtype, SEED)
            gamma, beta = gamma.to(dtype), beta.to(dtype)  # as the bf16 trainer passes them
            plan = forward_plan(x, GN_GROUPS)
            route = plan.route.replace("_", "-")
            if plan.cluster:
                route += (f" of {plan.cluster} blocks x {plan.smem_bytes} bytes, "
                          f"{resident_clusters(plan, x)} clusters resident")
            timed = fns if batch == TRAIN_BATCH else {
                name: fn for name, fn in fns.items() if name in ("kernel", "earlier")}
            fwd = {name: functools.partial(torch.no_grad()(fn), x, gamma, beta, GN_GROUPS, GN_EPS)
                   for name, fn in timed.items()}
            bwd = {}
            for name, fn in timed.items():
                leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
                y = fn(*leaves, GN_GROUPS, GN_EPS)
                bwd[name] = functools.partial(
                    torch.autograd.grad, y, leaves, dy, retain_graph=True)
            n = x.numel()
            for direction, turn in (("fwd", fwd), ("bwd", bwd)):
                ms = in_turns(turn, 10)
                tensors = 2 if direction == "fwd" else 3  # x, y / x, dy, dx
                nbytes = tensors * n * x.element_size()
                log(
                    f"phase 4: group_norm_silu {direction} {(batch, hw, c)} {dname}: "
                    + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
                    + f" per call; bound {bytes_ms(nbytes):.4f} ms; the kernel moves "
                    f"{nbytes / ms['kernel'] / 1e9:.3f} TB/s of the bound's bytes"
                    + (f"; forward route: {route}" if direction == "fwd" else "")
                )
                if batch != TRAIN_BATCH:
                    continue
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
    in memory (phase 11 trains from the port's own datagen). +-1 geometry and
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


def timed_train(trainer, steps, tag, phase="phase 5"):
    """trainer.train() over `steps` more steps, with the launch counts set
    to 0 before and read after; per-step times from the loop's per-step
    callback (which reads each step's loss, so each step has ended). The
    convolutions' precision is recorded over the first (warm-up) step."""
    stamps, losses = [], []
    recorder = ConvPrecisions()

    def on_step(step, loss, *rest):
        recorder.stop()
        stamps.append(time.perf_counter())
        losses.append(loss)

    trainer.config.num_train_steps = trainer.step + steps
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(on_step)
    launches = counts()
    recorder.check(f"{phase}: {tag}")
    if not all(math.isfinite(v) for v in losses) or len(losses) != steps:
        raise AssertionError(f"{tag}: losses {losses}")
    if launches != (0, 18 * steps, 18 * steps):
        raise AssertionError(f"{tag}: launches {launches}, want (0, {18 * steps}, {18 * steps})")
    ms = np.diff([t0] + stamps) * 1e3
    log(
        f"{phase}: {tag}: losses {', '.join(f'{v:.5f}' for v in losses)}; ms per step "
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
    from fea_tpu_torch.utils.precision import model_precision

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
    with model_precision(conv="ieee"):  # the tolerances hold strict f32
        loss_card = float(card._train_step(card._fetch_batch(0)))
    grad_err = max(
        rel_err(a.cpu(), b)
        for key in card.opt_states
        for a, b in zip(card.opt_states[key].mu, cpu.opt_states[key].mu)
        if b.abs().max() > 0
    )
    log(
        f"phase 5: one 32 px step, card at ieee vs CPU: loss {loss_card:.7f} vs {loss_cpu:.7f}; "
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
    recorder = ConvPrecisions()
    trainer.train()  # the warm-up step, and a checkpoint
    conv = recorder.check("phase 6")
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
        f"phase 6: diffusion batch {DIFFUSION_BATCH} at {IMAGE} px, convolutions at {conv}: "
        f"train() loss {loss:.5f}, "
        f"launches {launches}; ms per step " + ", ".join(f"{t:.3f}" for t in times)
    )
    return float(np.mean(times))


STORE_PLATES, STORE_CONDITIONS, STORE_STEPS = 8, 4, 6
PRODUCTION_PLATES = 4000  # x 4 conditions = 16,000: fea_tpu's production store
STORE_WRITE_SECONDS = 100  # budget for writing the tiled store


def write_png_dataset(root, size, seed):
    """A dataset folder in the reference's on-disk layout, written with PIL
    from `seed`: black-on-white region masks at the size they are read at
    (as datagen writes them), gray displacement images, and the three text
    files. Blocky masks, so that the PNGs stay small."""
    from PIL import Image

    rng = np.random.default_rng(seed)

    def png(path, mask=False):
        if mask:  # dark (inked) where the region is
            coarse = rng.random((size // 8, size // 8)) < 0.35
            pixels = np.where(np.kron(coarse, np.ones((8, 8), bool)), 0, 255)
        else:
            pixels = rng.integers(0, 256, (size, size))
        Image.fromarray(pixels.astype(np.uint8), "L").save(path)

    for plate in range(1, STORE_PLATES + 1):
        pdir = root / str(plate)
        pdir.mkdir(parents=True)
        png(pdir / "input.png", mask=True)
        for condition in range(1, STORE_CONDITIONS + 1):
            cdir = pdir / str(condition)
            cdir.mkdir()
            for name in ("outputs_displacement_x", "outputs_displacement_y"):
                png(cdir / f"{name}.png")
            for name in ("Constraint_0", "regions_Edge_0", "regions_Edge_2", "regions_Vertex_1",
                         "regions_Material_0", "regions_Material_1"):
                png(cdir / f"{name}.png", mask=True)
            fx, fy, gx, vy = rng.normal(0, 100, 4)
            (cdir / "magnitudes.txt").write_text(
                f"Edge_0: ({fx}, {fy})\nVertex_1: (0.0, {vy})\nEdge_2: ({gx}, 0.0)\n")
            (cdir / "materials.txt").write_text(
                f"Material_0: ({rng.uniform(2e4, 4e5)}, 0.3)\n"
                f"Material_1: ({rng.uniform(2e4, 4e5)}, 0.25)\n")
            (cdir / "ranges.txt").write_text("".join(
                f"displacement_{axis}_{step}: ({-rng.random()}, {rng.random()})\n"
                for step in range(1, STORE_STEPS) for axis in "xy"))


def tile_store(src_dir, dst_dir, plates):
    """A store of `plates` plates whose arrays repeat the small store's
    (plate p is plate p mod 8 of it): production size without production
    datagen. Returns the bytes written."""
    from fea_tpu_torch.data.store import _store_paths

    src, dst = _store_paths(Path(src_dir)), _store_paths(Path(dst_dir))
    Path(dst_dir).mkdir(parents=True)
    reps = plates // STORE_PLATES
    meta = json.loads(src["meta"].read_text())
    meta["num_plates"] = reps * STORE_PLATES
    dst["meta"].write_text(json.dumps(meta))
    written = 0
    for name in ("geometry", "constraints", "displacement", "force_winner", "mat_winner", "done"):
        small = np.load(src[name], mmap_mode="r")
        out = np.lib.format.open_memmap(
            dst[name], mode="w+", dtype=small.dtype, shape=(reps * len(small),) + small.shape[1:])
        for r in range(reps):
            out[r * len(small):(r + 1) * len(small)] = small
        out.flush()
        written += out.nbytes
        del out
    scalars = np.load(src["scalars"])
    np.savez(dst["scalars"], **{k: np.tile(scalars[k], (reps, 1, 1)) for k in scalars.files})
    return written


def disk_write_rate(folder):
    """Bytes per second of writing 256 MiB under `folder`, synced."""
    block = np.random.default_rng(SEED).integers(0, 256, 1 << 28, dtype=np.uint8)
    path = folder / "write_probe.bin"
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(block.tobytes())
        f.flush()
        os.fsync(f.fileno())  # to the disk, not to the page cache
    seconds = time.perf_counter() - t0
    path.unlink()
    return block.nbytes / seconds


def samples_differ(a, b, bitwise):
    """The first leaf in which two sample dicts differ, or None."""
    if a.keys() != b.keys():
        return "keys"
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.dtype != y.dtype or x.shape != y.shape:
            return key
        if (x.tobytes() != y.tobytes()) if bitwise else not np.array_equal(x, y):
            return key
    return None


def phase_store_train(device, results, synthetic_ms):
    """Phase 7. `synthetic_ms`: phase 5's (f32, bf16) ms per step, printed
    beside this phase's. Returns the launch counts of the f32 run."""
    from fea_tpu_torch.data import FEADataset, StoredFEADataset, build_condition_store, collate
    from fea_tpu_torch.data import device_store
    from fea_tpu_torch.train import Trainer
    from fea_tpu_torch.train import trainer as trainer_module

    root = results / "store"
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    write_png_dataset(root / "png", IMAGE, SEED)
    t1 = time.perf_counter()
    build_condition_store(str(root / "png"), str(root / "small"), num_plates=STORE_PLATES,
                          image_size=IMAGE, conditions_per_plate=STORE_CONDITIONS,
                          num_steps=STORE_STEPS)
    t2 = time.perf_counter()
    png = FEADataset(str(root / "png"), image_size=IMAGE, conditions_per_plate=STORE_CONDITIONS,
                     num_steps=STORE_STEPS)
    small = StoredFEADataset(str(root / "small"))
    if len(small) != len(png) or len(png) != STORE_PLATES * STORE_CONDITIONS * (STORE_STEPS - 1):
        raise AssertionError(f"{len(small)} stored samples, {len(png)} PNG samples")
    for i in range(0, len(png), 7):  # every plate, condition and step comes up
        # values, not bytes: at step 1 the store holds -0.0 for a negative
        # force where the PNG path's overlay keeps +0.0, as in fea_tpu
        leaf = samples_differ(png[i], small[i], bitwise=False)
        if leaf is not None:
            raise AssertionError(f"store sample {i} differs from the PNG sample in {leaf}")
    log(f"phase 7: {len(png)} PNG samples written in {t1 - t0:.1f} s, store built in "
        f"{t2 - t1:.1f} s; samples equal the PNG dataset's")

    # the production count, cut where the disk is too small or too slow
    per_plate = 7 * STORE_CONDITIONS * IMAGE * IMAGE + IMAGE * IMAGE
    rate = disk_write_rate(root)
    free = shutil.disk_usage(root).free
    plates = min(PRODUCTION_PLATES, int(STORE_WRITE_SECONDS * rate / per_plate),
                 int(0.8 * free / per_plate))
    plates -= plates % STORE_PLATES
    if plates < STORE_PLATES:
        raise AssertionError(f"no room for a store: {free} bytes free, {rate:.3g} bytes/s")
    t0 = time.perf_counter()
    written = tile_store(root / "small", root / "big", plates)
    log(f"phase 7: store of {plates} plates ({plates * STORE_CONDITIONS} conditions; production "
        f"{PRODUCTION_PLATES}) tiled in {time.perf_counter() - t0:.1f} s, {written / 1e9:.2f} GB "
        f"on disk (probe {rate / 1e9:.2f} GB/s, {free / 1e9:.0f} GB free)")

    samples = SyntheticFEADataset(8, IMAGE, SEED + 1)
    out = {}
    for tag, compute in (("f32", None), ("bf16", "bfloat16")):
        upload = {"assembled": 0}
        build, assemble = device_store.build_device_tables, device_store.assemble_batch

        def timed_build(ds, dev):
            t0 = time.perf_counter()
            tables = build(ds, dev)
            torch.cuda.synchronize()
            upload["seconds"] = time.perf_counter() - t0
            return tables

        def counted_assemble(tables, idx):
            upload["assembled"] += 1
            return assemble(tables, idx)

        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(trainer_module, "build_device_tables", timed_build), \
                mock.patch.object(trainer_module, "assemble_batch", counted_assemble):
            trainer = Trainer(
                trainer_config(IMAGE, results / "store_train", dataset_store=str(root / "big"),
                               device_resident_store=True, compute_dtype=compute,
                               conditions_per_plate=STORE_CONDITIONS,
                               num_steps_per_condition=STORE_STEPS),
                sample_dataset=samples, device=device)
            tables = trainer.device_tables
            if tables is None or not all(t.is_cuda for t in tables.values()):
                raise AssertionError("the store's tables are not on the card")
            nbytes = sum(t.numel() * t.element_size() for t in tables.values())
            if nbytes != device_store.estimate_table_bytes(trainer.dataset):
                raise AssertionError(f"{nbytes} table bytes, estimate "
                                     f"{device_store.estimate_table_bytes(trainer.dataset)}")
            batch = trainer._fetch_batch(0)
            if "ci" not in batch or "geometry" in batch or not batch["ci"].is_cuda:
                raise AssertionError(f"the loop does not send index vectors: {sorted(batch)}")
            ms, launches = timed_train(trainer, 1 + TRAIN_STEPS, f"from the store, {tag}", "phase 7")
        if upload["assembled"] != 1 + TRAIN_STEPS:
            raise AssertionError(f"{upload['assembled']} batches assembled from the tables in "
                                 f"{1 + TRAIN_STEPS} steps")
        peak = torch.cuda.max_memory_allocated() / 1e9

        # the same indices through the card's tables and through the store
        ds = trainer.dataset
        idx = trainer.sampler.indices_at(0, TRAIN_BATCH)
        index = {k: torch.from_numpy(v).to(device)
                 for k, v in device_store.index_arrays(ds, idx).items()}
        got = {k: v.cpu().numpy() for k, v in device_store.assemble_batch(tables, index).items()}
        leaf = samples_differ(got, collate([ds[int(i)] for i in idx]), bitwise=True)
        if leaf is not None:
            raise AssertionError(f"the batch assembled on the card differs in {leaf}")
        assemble_ms = in_turns(
            {"assemble": lambda: device_store.assemble_batch(tables, index)}, 20)["assemble"]
        log(f"phase 7: {tag}: tables {nbytes} bytes ({nbytes / 1e9:.3f} GB) on the card, uploaded "
            f"in {upload['seconds']:.2f} s; {len(ds)} samples; assemble_batch at batch "
            f"{TRAIN_BATCH} {assemble_ms:.4f} ms of device time, bit-equal to the store's "
            f"samples; {ms:.3f} ms per step (phase 5, synthetic host feed: "
            f"{synthetic_ms[tag]:.3f}); peak device memory {peak:.2f} GB")
        out[tag] = launches
        del trainer, tables, batch
        torch.cuda.empty_cache()
    return out["f32"]


# the gusset application's plate (fea_tpu/apps/specs.py), its supports
# (bottom and left edges) and loads (right and slanted edges)
GUSSET = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.5], [0.5, 1.0], [0.0, 1.0]])
FEM_MESH_SIZE = 1e-2  # the production mesh size
FEM_F32_REL = 1e-3  # card f32 vs the host's f64 direct solve
FEM_CPU_REL = 1e-4  # card f32 vs CPU f32
FEM_F64_REL = 1e-8  # solve_refined, and f64 on the card, vs the direct solve


def gusset_problems(mesh):
    """The gusset under the application's supports and loads, and the same
    plate pinned at one node (a mechanism)."""
    from fea_tpu_torch.fem import StaticProblem

    c, edges = mesh.coords, mesh.all_edges()
    # two materials by node sets that overlap by two elements, so that every
    # cell lies in one of them (a cell outside every region has no stiffness)
    regions = [((210000.0, 0.3), np.where(c[:, 0] <= 0.52)[0]),
               ((68900.0, 0.33), np.where(c[:, 0] >= 0.5)[0])]
    problem = StaticProblem.from_condition(
        mesh, regions, point_constraints=[], edge_constraints=[edges[0], edges[4]],
        point_forces=[], edge_forces=[(edges[1], (1000.0, 0.0)), (edges[2], (1000.0, 1000.0))],
        num_steps=6)
    one_pin = StaticProblem.from_condition(
        mesh, regions, point_constraints=[0], edge_constraints=[], point_forces=[],
        edge_forces=[(edges[1], (1000.0, 0.0))], num_steps=6)
    return problem, one_pin


def phase_fem(device):
    from fea_tpu_torch.fem import direct_solve, solve_refined
    from fea_tpu_torch.fem.solver import CHECK_EVERY
    from fea_tpu_torch.mesh import triangulate

    t0 = time.perf_counter()
    mesh = triangulate(GUSSET, mesh_size=FEM_MESH_SIZE)  # builds the CDT library with g++
    t1 = time.perf_counter()
    triangulate(GUSSET, mesh_size=FEM_MESH_SIZE)
    mesher_s = time.perf_counter() - t1
    problem, one_pin = gusset_problems(mesh)
    if problem.structurally_singular() or not one_pin.structurally_singular():
        raise AssertionError("structurally_singular: want False for the gusset, True for one pin")
    log(f"phase 8: gusset at mesh_size {FEM_MESH_SIZE}: {mesh.num_nodes} nodes, "
        f"{mesh.num_triangles} triangles, {int(problem.fixed_nodes.sum())} fixed; mesher "
        f"{mesher_s:.3f} s (first call, with the g++ build, {t1 - t0:.1f} s)")

    t0 = time.perf_counter()
    want = direct_solve(problem).displacements
    direct_s = time.perf_counter() - t0
    scale = float(np.abs(want).max())

    def rel(result):
        u = result.displacements
        u = u.cpu().numpy() if isinstance(u, torch.Tensor) else u
        return float(np.abs(u - want).max()) / scale

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = problem.solve(**kw)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    timed(dtype=torch.float32)  # warm-up: cuSOLVER's and cuBLAS's handles
    f32, f32_ms = timed(dtype=torch.float32)
    again, again_ms = timed(dtype=torch.float32, check_every=32)
    if not f32.displacements.is_cuda or not f32.success:
        raise AssertionError(f"f32 solve on the card: converged {bool(f32.converged)}, failed "
                             f"{bool(f32.failed)}, residual {float(f32.residual_norm):.3e}")
    if not torch.equal(f32.displacements, again.displacements) or \
            int(f32.iterations) != int(again.iterations):
        raise AssertionError("the f32 solve is not the same when run again in blocks of 32")
    iters = int(f32.iterations)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        problem.solve(dtype=torch.float32)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    # loop bodies queued: CHECK_EVERY for each host read that found the loop
    # running (each of the 6 restarts ends on one that did not); those past
    # an exit change nothing
    bodies = CHECK_EVERY * (f32.host_reads - 6)
    log(f"phase 8: f32 on the card: {iters} iterations, residual {float(f32.residual_norm):.3e}, "
        f"{f32_ms:.2f} ms per solve (set-up included), {f32_ms / iters:.4f} ms per CG "
        f"iteration, {f32.host_reads} host reads per solve (blocks of {CHECK_EVERY}); in blocks of "
        f"32: {again_ms:.2f} ms, "
        f"{again.host_reads} host reads, the same result bit for bit; {kernels} device kernels "
        f"and copies per solve, {bodies} loop bodies queued ({bodies - iters} past an exit), "
        f"{kernels / bodies:.1f} kernels per body; within {rel(f32):.3e} of the direct solve "
        f"(host f64 SuperLU, {direct_s:.2f} s)")
    if rel(f32) > FEM_F32_REL:
        raise AssertionError(f"f32 solve {rel(f32):.3e} from the direct solve")

    t0 = time.perf_counter()
    cpu = problem.solve(dtype=torch.float32, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    cpu_rel = float((f32.displacements.cpu() - cpu.displacements).abs().max()) / scale
    log(f"phase 8: f32 on the CPU: {int(cpu.iterations)} iterations (card {iters}), "
        f"{cpu_ms:.0f} ms; card vs CPU {cpu_rel:.3e}")
    if cpu_rel > FEM_CPU_REL:
        raise AssertionError(f"card and CPU f32 solves differ by {cpu_rel:.3e}")

    f64, f64_ms = timed()
    t0 = time.perf_counter()
    refined = solve_refined(problem)
    refined_ms = (time.perf_counter() - t0) * 1e3
    log(f"phase 8: f64 on the card: {int(f64.iterations)} iterations, {f64_ms:.2f} ms, within "
        f"{rel(f64):.3e}; solve_refined: {int(refined.iterations)} inner iterations, "
        f"{refined_ms:.2f} ms, {refined.host_reads} host reads, within {rel(refined):.3e}")
    if not (f64.success and refined.success) or max(rel(f64), rel(refined)) > FEM_F64_REL:
        raise AssertionError("the f64 or the refined solve is off the direct solve")


# phases 9-11: datagen on the card at bench.py's production config
# (bench.py:46-54: 512 px, 4 conditions x 6 steps, mesh 1e-2, displacement)
DATAGEN = dict(image_size=512, conditions_per_plate=4, mesh_size=1e-2,
               num_steps_per_condition=6, save_displacement=True, save_meshes=False,
               verbose=False)
CHUNK_PLATES = 4  # the scheduler's batch_size: 4 plates x 4 conditions = 16 lanes
DATAGEN_WARMUP_PLATES, DATAGEN_TIMED_PLATES, DATAGEN_REPEAT_PLATES = 4, 16, 2
CHUNK_DIRECT_REL = 1e-3  # a converged lane vs the host's f64 direct solve
CHUNK_OPERATORS_REL = 1e-4  # band vs incidence operator on the same lanes
CHUNK_OPERATORS_RESIDUAL = 1e-4  # ... that both ended at a residual of at most this


def condition_problem(mesh, condition):
    from fea_tpu_torch.fem import StaticProblem

    return StaticProblem.from_condition(
        mesh, condition["material_regions"], condition["point_constraints"],
        condition["edge_constraints"], condition["point_forces"], condition["edge_forces"],
        num_steps=DATAGEN["num_steps_per_condition"])


def chunk_payloads(device, banded):
    """Phase 9's chunk: the first CHUNK_PLATES plates of the seeded
    GeometrySampler at mesh 1e-2 whose RCM band fits the cap, padded to
    their common buckets as the scheduler pads a chunk, each with 4 seeded
    non-singular conditions; solvers with the scheduler's budget."""
    from fea_tpu_torch.datagen import ConditionSampler, PlateSolver
    from fea_tpu_torch.datagen.batched import (
        BAND_HB_CAP, ITERS_PER_DISPATCH, RESTARTS_PER_DISPATCH, RunningBuckets)
    from fea_tpu_torch.fem.banded import quantize_hb, rcm_permutation
    from fea_tpu_torch.geometry import GeometrySampler
    from fea_tpu_torch.mesh import triangulate_polygon

    geometry = GeometrySampler(random_seed=SEED)
    conditions = ConditionSampler(random_seed=SEED + 1)
    plates, hbs = [], []
    while len(plates) < CHUNK_PLATES:
        mesh = triangulate_polygon(geometry.generate(), mesh_size=DATAGEN["mesh_size"])
        hb = quantize_hb(rcm_permutation(mesh.triangles, mesh.num_nodes)[1])
        if hb > BAND_HB_CAP:
            continue
        pool, problems = [], []
        for condition in conditions.sample(mesh, DATAGEN["conditions_per_plate"], cluster_pool=pool):
            for _ in range(30):
                problem = condition_problem(mesh, condition)
                if not problem.structurally_singular():
                    break
                condition = conditions.sample_one(mesh, cluster_pool=pool)
            else:
                raise AssertionError("phase 9: 30 singular conditions in a row")
            problems.append(problem)
        plates.append((mesh, problems))
        hbs.append(hb)
    buckets = RunningBuckets()
    buckets.update(mesh for mesh, _ in plates)

    def build(degree):
        return [PlateSolver(
            mesh, DATAGEN["num_steps_per_condition"], node_bucket=buckets.node,
            tri_bucket=buckets.tri, min_incidence_degree=degree,
            band_hb=max(hbs) if banded else -1, include_cell_fields=False,
            max_iters=ITERS_PER_DISPATCH, restarts=RESTARTS_PER_DISPATCH, banded=banded,
            device=device) for mesh, _ in plates]

    solvers = build(0)
    solvers = build(max(int(s.slots_dev.shape[1]) for s in solvers))
    return [(s, problems) for s, (_, problems) in zip(solvers, plates)]


def device_kernels(fn):
    """Device kernels and copies that `fn` launches, by torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def solve_chunk(payloads):
    """One chunk through the solve worker: (packed rows on the card, info)."""
    from fea_tpu_torch.datagen.batched import dispatch_plate_group

    info = {}
    rows = dispatch_plate_group(payloads, info=info).result()
    return rows, info


def phase_chunk(device):
    """Phase 9. Returns ms per loop body (band operator)."""
    from fea_tpu_torch.datagen.batched import chunk_inputs, chunk_tables, unpack_plate_group
    from fea_tpu_torch.fem import direct_solve
    from fea_tpu_torch.fem.flatgroup import chunk_system, flat_group_body
    from fea_tpu_torch.fem.solver import CHECK_EVERY, masked_operator

    t0 = time.perf_counter()
    band = chunk_payloads(device, banded=True)
    plain = chunk_payloads(device, banded=False)
    s0 = band[0][0]
    P, C = len(band), len(band[0][1])
    log(f"phase 9: {P} plates x {C} conditions ({P * C} lanes) at mesh {DATAGEN['mesh_size']}: "
        f"nodes {[s.n for s, _ in band]}, triangles {[s.m for s, _ in band]}, buckets "
        f"({s0.node_bucket}, {s0.tri_bucket}), band hb {s0.band_hb}, incidence width "
        f"{int(plain[0][0].slots_dev.shape[1])}, n_coarse {s0.n_coarse}, member table width "
        f"{max(s.members.shape[1] for s, _ in band)}; set-up on the host {time.perf_counter() - t0:.1f} s")
    solve_chunk(band)  # warm-up: cuBLAS, cuSOLVER and the allocator
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for name, payloads in (("band", band), ("incidence", plain), ("band again", band)):
        t0 = time.perf_counter()
        rows, info = solve_chunk(payloads)
        wall = time.perf_counter() - t0
        bodies = CHECK_EVERY * (info["host_reads"] - s0.restarts)
        out[name] = (rows, info, wall, bodies)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not torch.equal(out["band"][0], out["band again"][0]):
        raise AssertionError("the chunk is not the same bit for bit when solved again")

    results = {name: unpack_plate_group(out[name][0].cpu().numpy(), payloads)
               for name, payloads in (("band", band), ("incidence", plain))}
    worst_direct, worst_ops, converged, compared = 0.0, 0.0, 0, 0
    for p, (solver, problems) in enumerate(band):
        for c, problem in enumerate(problems):
            ours, other = results["band"][p][c], results["incidence"][p][c]
            want = direct_solve(problem).displacements[-1]
            scale = max(float(np.abs(want).max()), 1e-30)  # a lane loaded at fixed nodes only: u = 0
            if ours.success:
                converged += 1
                worst_direct = max(worst_direct, float(np.abs(ours.displacements[-1] - want).max()) / scale)
            # the operators are held to each other on lanes that both ended
            # within StaticProblem.solve's own acceptance (1e-4); datagen
            # accepts residuals up to 2e-3, where two solves differ by more
            if max(float(ours.residual_norm), float(other.residual_norm)) <= CHUNK_OPERATORS_RESIDUAL:
                compared += 1
                worst_ops = max(worst_ops, float(np.abs(
                    ours.displacements[-1] - other.displacements[-1]).max()) / scale)
    iters = {name: [int(r.iterations) for plate in res for r in plate] for name, res in results.items()}
    w_band = 2 * s0.band_hb + 128
    band_bytes = C * 2 * P * s0.node_bucket * w_band * 4
    ms_body = {}
    for name in ("band", "incidence"):
        rows, info, wall, bodies = out[name]
        ms_body[name] = info["loop_s"] * 1e3 / max(bodies, 1)
        n_conv = sum(r.success for plate in results[name] for r in plate)
        log(f"phase 9: {name} operator: chunk {wall * 1e3:.1f} ms (set-up {info['setup_s'] * 1e3:.1f}, "
            f"loop {info['loop_s'] * 1e3:.1f}), {info['host_reads']} host reads, {bodies} loop bodies "
            f"queued (blocks of {CHECK_EVERY}), {ms_body[name]:.3f} ms per body; iterations per lane "
            f"{iters[name]}; {n_conv} of {P * C} lanes converged")
    log(f"phase 9: converged lanes within {worst_direct:.3e} of the host's f64 direct solve "
        f"(tolerance {CHUNK_DIRECT_REL}, {converged} lanes); band vs incidence {worst_ops:.3e} "
        f"(tolerance {CHUNK_OPERATORS_REL}, {compared} lanes that both ended at a residual of at "
        f"most {CHUNK_OPERATORS_RESIDUAL}); the band solve again: the same bit "
        f"for bit; peak device memory {peak:.2f} GB")
    if converged == 0 or compared == 0:
        raise AssertionError(f"phase 9: {converged} converged lanes, {compared} compared")
    if worst_direct > CHUNK_DIRECT_REL or worst_ops > CHUNK_OPERATORS_REL:
        raise AssertionError("phase 9: a converged lane is off the direct solve or the other operator")

    # kernels per loop body, split by what torch.profiler can tell apart:
    # the operator as the loop applies it (with the free-dof masks) and
    # the preconditioner, one call each; the recurrence is the rest of a body
    for name, payloads in (("band", band), ("incidence", plain)):
        solvers, host, m_real, band_hb = chunk_inputs(payloads)
        tables, m_real_p = chunk_tables(solvers, host, m_real, device)
        system = chunk_system(*tables, m_real_p=m_real_p, n_coarse=s0.n_coarse, band_hb=band_hb)
        r = system.b * system.free
        A = masked_operator(system.op, system.free)
        k_op = device_kernels(lambda: A(r))
        if name == "band":
            nbytes = band_operator_bytes(system.op.vals, system.op.cols, r)
            log(f"phase 9: the band operator reads {nbytes / 1e6:.3f} MB per iteration (its "
                f"non-zeros, their columns, u and y), where the dense band was "
                f"{band_bytes / 1e9:.3f} GB; {system.op.cols.shape[1]} slots a row")
        k_pre = device_kernels(lambda: system.precondition(r))
        k_setup = device_kernels(lambda: chunk_system(
            *tables, m_real_p=m_real_p, n_coarse=s0.n_coarse, band_hb=band_hb))
        info = {}
        # on this thread, where the profiler records (the worker's launches
        # come from another thread)
        k_total = device_kernels(lambda: flat_group_body(
            *tables, m_real_p=m_real_p, band_hb=band_hb, info=info, n_coarse=s0.n_coarse,
            tol=s0.tol, max_iters=s0.max_iters, accept_tol=s0.accept_tol,
            restarts=s0.restarts, include_cell_fields=s0.include_cell_fields))
        bodies = CHECK_EVERY * (info["host_reads"] - s0.restarts)
        per_body = (k_total - k_setup) / max(bodies, 1)
        log(f"phase 9: {name}: {k_total} device kernels per chunk, {k_setup} in the set-up, "
            f"{per_body:.1f} per loop body: operator {k_op}, preconditioner {k_pre}, recurrence "
            f"and masks {per_body - k_op - k_pre:.1f}")
        del system, tables
    torch.cuda.empty_cache()
    return ms_body["band"]


def plate_files_ok(plate_dir, conditions, steps):
    """The reference's file set for one plate (fea_tpu/datagen/writers.py),
    and finite ranges: raises if not."""
    names = set(os.listdir(plate_dir))
    want = {"input.png", "outline.png"} | {str(c) for c in range(1, conditions + 1)}
    if names != want:
        raise AssertionError(f"{plate_dir}: {sorted(names)}")
    for c in range(1, conditions + 1):
        cdir = os.path.join(plate_dir, str(c))
        files = set(os.listdir(cdir))
        for name in ("magnitudes.txt", "materials.txt", "ranges.txt",
                     "outputs_displacement_x.png", "outputs_displacement_y.png"):
            if name not in files:
                raise AssertionError(f"{cdir}: no {name}")
        with open(os.path.join(cdir, "materials.txt")) as f:
            materials = len(f.readlines())
        with open(os.path.join(cdir, "magnitudes.txt")) as f:
            forces = len(f.readlines())
        regions = [n for n in files if n.startswith("regions_")]
        if sum(n.startswith("regions_MaterialRegion") for n in regions) != materials or \
                sum("Force" in n for n in regions) != forces or \
                not any("Constraint" in n for n in regions):
            raise AssertionError(f"{cdir}: region images {sorted(regions)}")
        with open(os.path.join(cdir, "ranges.txt")) as f:
            values = [eval(line.split(":", 1)[1]) for line in f]
        if len(values) != 2 * (steps - 1) or not np.isfinite(values).all():
            raise AssertionError(f"{cdir}: ranges {values}")


def tree_bytes(root):
    return {os.path.relpath(os.path.join(d, f), root): Path(d, f).read_bytes()
            for d, _, files in os.walk(root) for f in files}


def phase_datagen(device, results, chunk_ms_body):
    """Phase 10: generate_data_batched at bench.py's config."""
    from fea_tpu_torch.datagen import generate_data_batched
    from fea_tpu_torch.fem.solver import CHECK_EVERY
    from fea_tpu_torch.utils.profiling import StageTimer

    common = dict(DATAGEN, device=device)
    t0 = time.perf_counter()
    generate_data_batched(data_dir=str(results / "warm"), num_plates=DATAGEN_WARMUP_PLATES,
                          seed=7, **common)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    stages = StageTimer()
    reset_counts()
    t0 = time.perf_counter()
    stats = generate_data_batched(data_dir=str(results / "timed"), num_plates=DATAGEN_TIMED_PLATES,
                                  seed=1234, stage_timer=stages, **common)
    wall = time.perf_counter() - t0
    launches = cg_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for plate in range(1, DATAGEN_TIMED_PLATES + 1):
        plate_files_ok(str(results / "timed" / str(plate)), DATAGEN["conditions_per_plate"],
                       DATAGEN["num_steps_per_condition"])
    bodies = CHECK_EVERY * (stats["host_reads"] - stats["chunks"])
    ms_body = stats["chunk_loop_s"] * 1e3 / max(bodies, 1)
    iters = stats["converged_iters"]
    log(f"phase 10: generate_data_batched, {DATAGEN_TIMED_PLATES} plates at {DATAGEN['image_size']} "
        f"px, {DATAGEN['conditions_per_plate']} conditions x {DATAGEN['num_steps_per_condition']} "
        f"steps, mesh {DATAGEN['mesh_size']}: {wall:.1f} s, {DATAGEN_TIMED_PLATES / wall * 3600:.1f} "
        f"plates per hour (warm-up of {DATAGEN_WARMUP_PLATES} plates {warm_s:.1f} s)")
    log(f"phase 10: {stats['solves']} solves dispatched in {stats['chunks']} chunks, "
        f"{stats['cg_failures']} CG failures, {stats['direct_fallbacks']} direct fallbacks, "
        f"{stats['continuations']} continuations, {stats['host_rejections']} host rejections, "
        f"{stats['cg_resamples']} resampled; converged lanes' iterations median "
        f"{float(np.median(iters)) if iters else float('nan'):.0f}, max {max(iters, default=0)}; "
        f"final buckets {stats['final_buckets']}")
    log(f"phase 10: solve worker {stats['device_busy_s']:.2f} s busy of {wall:.2f} s; chunks' set-up "
        f"{stats['chunk_setup_s']:.2f} s, loops {stats['chunk_loop_s']:.2f} s over {bodies} bodies: "
        f"{ms_body:.3f} ms per loop body inside the scheduler (phase 9, alone: "
        f"{chunk_ms_body:.3f}); peak device memory {peak:.2f} GB")
    log(f"phase 10: the CG loop's and the band operator's kernel launches in the timed run "
        f"(each block's replays): {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"phase 10: a loop kernel did not launch on the main path: {launches}")
    log("phase 10: stages (host clock)\n" + stages.summary())

    datagen_repeat(device, results, "phase 10")
    return DATAGEN_TIMED_PLATES / wall * 3600, launches


def datagen_repeat(device, results, phase):
    """Two runs of DATAGEN_REPEAT_PLATES plates from one seed at bench.py's
    config: the same files byte for byte (raises otherwise)."""
    from fea_tpu_torch.datagen import generate_data_batched

    trees = []
    for tag in ("a", "b"):
        folder = results / f"repeat_{phase.replace(' ', '')}_{tag}"
        generate_data_batched(data_dir=str(folder), num_plates=DATAGEN_REPEAT_PLATES, seed=99,
                              device=device, **DATAGEN)
        trees.append(tree_bytes(folder))
        shutil.rmtree(folder, ignore_errors=True)
    if trees[0] != trees[1]:
        differ = sorted(k for k in trees[0].keys() | trees[1].keys()
                        if trees[0].get(k) != trees[1].get(k))
        raise AssertionError(f"{phase}: the same seed wrote different files: {differ[:5]}")
    log(f"{phase}: two runs of {DATAGEN_REPEAT_PLATES} plates from seed 99 wrote the same "
        f"{len(trees[0])} files byte for byte")


def phase_inmemory_train(device, results):
    """Phase 11: the regression Trainer from the port's in-memory datagen."""
    from fea_tpu_torch.data import InMemoryFEADataset
    from fea_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    data = InMemoryFEADataset.generate(num_plates=2, conditions_per_plate=4, num_steps=6,
                                       image_size=IMAGE, mesh_size=2e-2, seed=11, device=device)
    gen_s = time.perf_counter() - t0
    if len(data) != 2 * 4 * 5:
        raise AssertionError(f"phase 11: {len(data)} samples")
    for sample in data.samples:
        for key, value in sample.items():
            if not np.isfinite(value).all():
                raise AssertionError(f"phase 11: {key} is not finite")
    cfg = trainer_config(IMAGE, results / "inmemory", conditions_per_plate=4,
                         num_steps_per_condition=6, num_steps_per_sample_condition=6)
    trainer = Trainer(cfg, dataset=data, sample_dataset=data, device=device)
    log(f"phase 11: InMemoryFEADataset.generate: {len(data)} samples (2 plates x 4 conditions x "
        f"5 steps, {IMAGE} px, mesh 2e-2) in {gen_s:.1f} s")
    ms, _ = timed_train(trainer, 2, "from the in-memory datagen, f32", "phase 11")
    del trainer
    torch.cuda.empty_cache()
    return ms


FULL_ATTENTION_BATCH = 2
FULL_ATTENTION_SMALL = 64  # px: the model against itself through plain attention
STAGE0_ROWS = 1024  # query rows of the stage-0 flash call held against the plain version


def phase_full_attention(device, earlier):
    """Phase 12: the denoiser with full attention at every stage and the
    self-conditioning input. Returns the flash launches of the 256 px
    forward, the stage-0 call's max abs error and ms, and its bound; given
    `earlier` (another tree's ops), that kernel's error and ms on the same
    call too."""
    from fea_tpu_torch.models import attention, make_diffusion_model
    from fea_tpu_torch.models.fdnunet import FDNUNet
    from fea_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, route)
    from fea_tpu_torch.utils.precision import model_precision

    kw = dict(input_dim=64, num_stages=4, use_full_attention=True)
    generator = torch.Generator(device=device).manual_seed(SEED + 12)
    model = make_diffusion_model(image_size=IMAGE, use_flash_attention=True, device=device,
                                 generator=generator, self_condition=True, **kw).model.eval()
    sites = [n for n, m in model.named_modules() if isinstance(m, attention.FullAttention)]
    if len(sites) != 2 * 4 + 1:  # down and up at each of 4 stages, and the middle
        raise AssertionError(f"FullAttention at {sites}")
    log(f"phase 12: FDNUNet with full attention and self-conditioning: "
        f"{sum(p.numel() for p in model.parameters())} parameters, FullAttention at {sites}")
    with torch.device("meta"):
        plain = FDNUNet(num_channels=2, num_auxiliary_condition_channels=5,
                        num_condition_channels=2, use_time_embedding=True,
                        use_flash_attention=False, **kw)
    plain.to_empty(device=device).load_state_dict(model.state_dict())
    plain.eval()

    def inputs(size, seed):
        rng = np.random.default_rng(seed)
        x, cond, self_cond = (
            torch.from_numpy(rng.normal(size=(FULL_ATTENTION_BATCH, size, size, c))
                             .astype(np.float32)).to(device)
            for c in (2, 5, 2)
        )
        return x, cond, self_cond, torch.full((FULL_ATTENTION_BATCH,), 500.0, device=device)

    x, cond, self_cond, t = inputs(FULL_ATTENTION_SMALL, SEED)
    with torch.no_grad(), model_precision(conv="ieee"):  # the tolerance holds strict f32
        err_small = max_abs_err(model(x, cond, self_cond, time=t),
                                plain(x, cond, self_cond, time=t))
    log(f"phase 12: {FULL_ATTENTION_SMALL} px, batch {FULL_ATTENTION_BATCH}, at ieee: flash vs "
        f"plain attention max abs diff {err_small:.3e} (tolerance {FLASH_VS_PLAIN_ATOL})")
    if err_small > FLASH_VS_PLAIN_ATOL:
        raise AssertionError(f"flash and plain forwards differ by {err_small}")
    del plain

    # 256 px: the stage-0 call (65,536 queries) is recorded on its way
    recorded = {}

    def recording(q, k, v):
        out = flash_attention(q, k, v)
        if q.shape[1] == IMAGE * IMAGE and not recorded:
            recorded.update(q=q, k=k, v=v, out=out)
        return out

    x, cond, self_cond, t = inputs(IMAGE, SEED + 1)
    # the model called as an entry point would call it: at the policy's default
    forward = model_precision()(torch.no_grad()(lambda: model(x, cond, self_cond, time=t)))
    recorder = ConvPrecisions()
    forward()  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    conv = recorder.check("phase 12")
    reset_counts()
    with mock.patch.object(attention, "flash_attention", recording):
        out = forward()
    torch.cuda.synchronize()
    launches = counts()
    if launches != (len(sites), 9, 0):
        raise AssertionError(f"launches {launches}, want ({len(sites)}, 9, 0)")
    launches_wgmma = flash_attention.launches_wgmma  # every call is f32 at D 32
    if launches_wgmma != len(sites):
        raise AssertionError(f"launches_wgmma {launches_wgmma}, want {len(sites)}")
    if out.shape != (FULL_ATTENTION_BATCH, IMAGE, IMAGE, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"output {tuple(out.shape)} is not finite or not the shape")
    q, k, v = recorded["q"], recorded["k"], recorded["v"]
    bh, nq, d = q.shape
    nk = k.shape[1]
    if (bh, nq, nk, d) != (4 * FULL_ATTENTION_BATCH, IMAGE * IMAGE, IMAGE * IMAGE + 4, 32):
        raise AssertionError(f"stage-0 call at {(bh, nq, nk, d)}")
    kernel = route(q.dtype, d)
    # the plain version's scores for all of this call would take
    # BH Nq Nk 4 bytes (137 GB); on the first and the last rows over every
    # key it is exact for those rows
    want = flash_attention_reference(q[:, :STAGE0_ROWS], k, v)
    got = recorded["out"][:, :STAGE0_ROWS]
    want_last = flash_attention_reference(q[:, -STAGE0_ROWS:], k, v)
    got_last = recorded["out"][:, -STAGE0_ROWS:]
    err_stage0 = max(max_abs_err(got, want), max_abs_err(got_last, want_last))

    def library():
        # the memory-efficient backend: O(N D) memory (the math backend's
        # scores would take 137 GB); its 4-D layout is (1, BH, N, D)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q[None], k[None], v[None])[0]

    err_library = max_abs_err(library()[:, :STAGE0_ROWS], want)
    fns = {"kernel": lambda: flash_attention(q, k, v), "library": library}
    if earlier is not None:
        fns["earlier"] = lambda: earlier.flash_attention(q, k, v)
        err_earlier = max_abs_err(fns["earlier"]()[:, :STAGE0_ROWS], want)
        log(f"phase 12: stage-0 call, earlier kernel: max abs err vs plain {err_earlier:.3e}")
    torch.testing.assert_close(got, want, **F32_TOL)
    torch.testing.assert_close(got_last, want_last, **F32_TOL)
    del want, got, want_last, got_last
    recorded.clear()
    torch.cuda.empty_cache()

    forward_ms = cuda_ms(forward, 3)
    stage0 = in_turns(fns, 5)
    stage0_ms = stage0["kernel"]
    library_ms = stage0["library"]
    ops = 4 * bh * nq * nk * d
    bound, bound_by = bound_ms(4 * (2 * bh * nq * d + 2 * bh * nk * d), ops, TF32_TENSOR_FLOPS)
    log(f"phase 12: {IMAGE} px, batch {FULL_ATTENTION_BATCH}, convolutions at {conv}: launches "
        f"(flash, GroupNorm+SiLU forward, backward) {launches}, {launches_wgmma} of the flash "
        f"launches on the wgmma route; forward {forward_ms:.3f} ms of device time")
    log(f"phase 12: stage-0 flash call {(bh, nq, nk, d)} f32, {kernel} route: {stage0_ms:.4f} "
        f"ms; max abs err vs plain on the first and the last {STAGE0_ROWS} query rows "
        f"{err_stage0:.3e} (tolerance {F32_TOL}); bound "
        f"{bound:.4f} ms ({bound_by}: {ops / 1e12:.3f} TFLOP at the TF32 tensor-core peak), "
        f"the 3xTF32 floor {3 * ops / TF32_TENSOR_FLOPS * 1e3:.4f} ms; {stage0_ms / bound:.2f}x "
        f"the bound" + (f"; earlier kernel {stage0['earlier']:.4f} ms" if earlier else ""))
    log(f"phase 12: stage-0 call, scaled_dot_product_attention (EFFICIENT_ATTENTION): "
        f"{library_ms:.4f} ms; max abs err vs plain on {STAGE0_ROWS} query rows {err_library:.3e}")
    del model, q, k, v
    torch.cuda.empty_cache()
    return dict(launches_full_attention=launches[0],
                launches_wgmma_full_attention=launches_wgmma, max_abs_err_stage0=err_stage0,
                ms_stage0=stage0_ms, bound_ms_stage0=bound, library_ms_stage0=library_ms,
                **({"earlier_ms_stage0": stage0["earlier"]} if earlier else {}))


CLI_TRAIN_STEPS = 40
CLI_DIFFUSION_STEPS = 3
CLI_CONDITIONS, CLI_STEPS = 4, 6
CLI_TRAIN_PLATES, CLI_HELD_OUT_PLATES = 6, 2
CLI_DATA_IMAGE, CLI_MESH_SIZE = 512, 1e-2  # bench.py's datagen config
APP_IMAGE = 512
APP_PNGS = ("geometry", "outline", "constraint", "force", "displacement_x", "displacement_y")


def tree_size(root):
    return sum(p.stat().st_size for p in Path(root).rglob("*") if p.is_file())


def phase_cli(device, results):
    """Phase 13: the pipeline end to end through the port's CLI, in this
    process (`fea_tpu_torch.cli.main`), so that the launch counts can be
    read after each command. Returns them by command: the GroupNorm+SiLU
    forward's and backward's, and the modulated forward's; and the check of
    the modulated calls of `sample`'s and `app`'s first forward."""
    from PIL import Image

    from fea_tpu_torch import cli
    from fea_tpu_torch.apps import run_application
    from fea_tpu_torch.data import FEADataset, StoredFEADataset
    from fea_tpu_torch.utils.logs import parse_train_log

    proc = subprocess.run([sys.executable, "-m", "fea_tpu_torch", "--help"],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0 or "train-diffusion" not in proc.stdout:
        raise AssertionError(f"python -m fea_tpu_torch --help: {proc.returncode} {proc.stderr}")
    log("phase 13: python -m fea_tpu_torch --help exits 0")

    root = results / "cli"
    root.mkdir(parents=True)
    launches, modulated, checked = {}, {}, {}

    def run(tag, *argv, runs_model=False, check=False):
        """One command; `runs_model`: it runs the model, whose convolutions must
        then have run at the CLI's own setting, the policy's default;
        `check`: the modulated calls of its first forward are held to
        PyTorch's chain after it (`check_modulated`)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = tree_size(root)
        reset_counts()
        recorder = ConvPrecisions()
        outs = []
        t0 = time.perf_counter()
        try:
            calls = modulated_calls(lambda: outs.append(cli.main([str(a) for a in argv])),
                                    limit=PREDICT_MODULATED if check else 0)
        finally:
            recorder.stop()
        out, = outs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[tag], modulated[tag] = counts(), modulated_launches()
        log(f"phase 13: {tag}: {wall:.1f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
            f"{(tree_size(root) - before) / 1e9:.3f} GB written (net); launches (flash, "
            f"GroupNorm+SiLU forward, backward) {launches[tag]}, modulated GroupNorm+SiLU "
            f"{modulated[tag]}")
        if runs_model:
            recorder.check(f"phase 13: {tag}")
        if check:
            if len(calls) != PREDICT_MODULATED:
                raise AssertionError(f"{tag}: {len(calls)} modulated calls in its first "
                                     f"forward, want {PREDICT_MODULATED}")
            checked[tag] = check_modulated(f"phase 13: {tag}", calls)
        return out

    def want_launches(tag, fwd, bwd, mod):
        """`mod`: modulated calls, 20 a forward that needs no gradient (the
        samples' and the app's), none in training."""
        if launches[tag] != (0, fwd, bwd) or modulated[tag] != mod:
            raise AssertionError(f"{tag}: launches {launches[tag]} and {modulated[tag]} "
                                 f"modulated, want (0, {fwd}, {bwd}) and {mod}")

    train, held, seq = root / "train", root / "held_out", root / "sequential"
    data = ("--conditions_per_plate", CLI_CONDITIONS, "--steps_per_condition", CLI_STEPS,
            "--mesh_size", CLI_MESH_SIZE, "--save_displacement", "--save_meshes")
    run("generate --batched (train)", "generate", "--batched", "--num_plates", CLI_TRAIN_PLATES,
        "--image_size", CLI_DATA_IMAGE, *data, "--data_dir", train, "--seed", 1234)
    run("generate --batched (held out)", "generate", "--batched", "--num_plates",
        CLI_HELD_OUT_PLATES, "--image_size", CLI_DATA_IMAGE, *data, "--data_dir", held,
        "--seed", 99)
    run("generate (sequential)", "generate", "--num_plates", 1, "--image_size", IMAGE, *data,
        "--data_dir", seq, "--seed", 5)
    for tree, plates in ((train, CLI_TRAIN_PLATES), (held, CLI_HELD_OUT_PLATES), (seq, 1)):
        for plate in range(1, plates + 1):
            plate_files_ok(str(tree / str(plate)), CLI_CONDITIONS, CLI_STEPS)

    run("store", "store", "--data_dir", train, "--store_dir", root / "store", "--num_plates",
        CLI_TRAIN_PLATES, "--image_size", IMAGE, "--conditions_per_plate", CLI_CONDITIONS,
        "--steps_per_condition", CLI_STEPS)
    png = FEADataset(str(train), image_size=IMAGE, conditions_per_plate=CLI_CONDITIONS,
                     num_steps=CLI_STEPS)
    stored = StoredFEADataset(str(root / "store"))
    if len(stored) != len(png) or len(png) != CLI_TRAIN_PLATES * CLI_CONDITIONS * (CLI_STEPS - 1):
        raise AssertionError(f"{len(stored)} stored samples, {len(png)} PNG samples")
    for i in range(0, len(png), 7):
        leaf = samples_differ(png[i], stored[i], bitwise=False)
        if leaf is not None:
            raise AssertionError(f"store sample {i} differs from the PNG sample in {leaf}")

    res = root / "results"
    model = ("--image_size", IMAGE, "--input_dim", 64, "--num_stages", 4)
    sample_set = CLI_HELD_OUT_PLATES * CLI_CONDITIONS * (CLI_STEPS - 1)
    sample_batches = math.ceil(sample_set / TRAIN_BATCH)
    run("train", "train", "--data_dir", train, "--sample_data_dir", held, "--dataset_store",
        root / "store", "--device_resident_store", "--use_ema_model", "--batch_size", TRAIN_BATCH,
        "--num_steps", CLI_TRAIN_STEPS, "--num_steps_per_milestone", CLI_TRAIN_STEPS,
        "--num_steps_per_condition", CLI_STEPS, "--num_steps_per_sample_condition", CLI_STEPS,
        "--conditions_per_plate", CLI_CONDITIONS, "--num_sample_conditions_per_plate",
        CLI_CONDITIONS, "--no_progress_bar", "--results_dir", res, *model, runs_model=True)
    # 18 + 18 per step, and 18 forward per batch of the milestone's samples
    want_launches("train", 18 * (CLI_TRAIN_STEPS + sample_batches), 18 * CLI_TRAIN_STEPS,
                  PREDICT_MODULATED * sample_batches)
    (train_log,) = res.glob(f"train-e{CLI_TRAIN_STEPS}-b{TRAIN_BATCH}-*.log")
    parsed = parse_train_log(str(train_log))
    if (list(parsed["steps"]) != list(range(CLI_TRAIN_STEPS))
            or not np.isfinite(parsed["losses"]).all() or len(parsed["sample_losses"]) != 1):
        raise AssertionError(f"train log {parsed}")
    log(f"phase 13: train log: {len(parsed['steps'])} steps, loss {parsed['losses'][0]:.5f} -> "
        f"{parsed['losses'][-1]:.5f}, sample loss {parsed['sample_losses'][0]:.5f}")
    # the commands below read model-final only
    for path in (res / "model-best", res / "model-best.zip", res / "model-final.zip"):
        shutil.rmtree(path) if path.is_dir() else path.unlink()

    sample = ("sample", "--milestone", "final", "--data_dir", held, "--sample_data_dir", held,
              "--batch_size", TRAIN_BATCH, "--num_steps_per_condition", CLI_STEPS,
              "--num_sample_conditions_per_plate", CLI_CONDITIONS, "--results_dir", res, *model)
    accuracy = ("accuracy", "--data_dir", held, "--results_dir", res, "--milestone", "final",
                "--image_size", IMAGE, "--num_plates", CLI_HELD_OUT_PLATES,
                "--conditions_per_plate", CLI_CONDITIONS, "--steps_per_condition", CLI_STEPS)
    scores = {}
    for tag, flags in (("raw", ()), ("EMA", ("--use_ema",))):
        run(f"sample ({tag})", *sample, *flags, runs_model=True, check=tag == "raw")
        want_launches(f"sample ({tag})", 18 * sample_batches, 0,
                      PREDICT_MODULATED * sample_batches)
        written = len(list((res / "final").rglob("sample_*.png")))
        if written != 2 * sample_set:
            raise AssertionError(f"sample ({tag}) wrote {written} PNGs")
        scores[tag] = run(f"accuracy ({tag})", *accuracy)
        if tag == "raw":  # keep both passes, as examples/eval_surrogate.sh does
            (res / "final").rename(res / "final-raw-samples")
    for tag, s in scores.items():
        log(f"phase 13: accuracy {tag}: MAE {s['mae']:.6f}, MSE {s['mse']:.6f}, RMSE "
            f"{s['rmse']:.6f} over {len(s['mae_values'])} samples")
        if not all(math.isfinite(s[k]) for k in ("mae", "mse", "rmse")):
            raise AssertionError(f"accuracy {tag} is not finite: {s}")

    out = run("app gusset --checkpoint --use_ema", "app", "gusset", "--checkpoint",
              res / "model-final", "--use_ema", "--image_size", APP_IMAGE, "--output_dir",
              root / "app", runs_model=True, check=True)
    want_launches("app gusset --checkpoint --use_ema", 18, 0, PREDICT_MODULATED)
    log(f"phase 13: app gusset: {out}")
    if not (out["converged"] and out["raster_roundtrip_mae"] < 1e-2
            and math.isfinite(out["pred_mae"])):
        raise AssertionError(f"app gusset: {out}")
    t0 = time.perf_counter()
    on_cpu = run_application("gusset", output_dir=str(root / "app_cpu"), image_size=APP_IMAGE,
                             device="cpu")
    diffs = {}
    for name in APP_PNGS:
        card, cpu = (np.asarray(Image.open(root / d / f"{name}.png"), dtype=np.int16)
                     for d in ("app", "app_cpu"))
        diffs[name] = int(np.abs(card - cpu).max())
    log(f"phase 13: app gusset on the CPU in {time.perf_counter() - t0:.1f} s: raster round trip "
        f"{on_cpu['raster_roundtrip_mae']:.6f} (card {out['raster_roundtrip_mae']:.6f}); the "
        f"card's PNGs against the CPU's, max gray-level difference {diffs}")
    if max(diffs.values()) > 1:
        raise AssertionError(f"the card's app images differ from the CPU's by {diffs}")

    run("train-diffusion", "train-diffusion", "--data_dir", train, "--image_size", IMAGE,
        "--batch_size", DIFFUSION_BATCH, "--num_steps", CLI_DIFFUSION_STEPS,
        "--num_steps_per_milestone", CLI_DIFFUSION_STEPS, "--conditions_per_plate",
        CLI_CONDITIONS, "--num_steps_per_condition", CLI_STEPS, "--results_dir",
        root / "results_diffusion", runs_model=True)
    want_launches("train-diffusion", 9 * CLI_DIFFUSION_STEPS, 9 * CLI_DIFFUSION_STEPS, 0)
    state = torch.load(root / "results_diffusion" / "model-final" / "state.pt",
                       map_location="cpu", mmap=True, weights_only=True)
    if state["step"] != CLI_DIFFUSION_STEPS or not all(
            torch.isfinite(t).all() for t in state["params"].values()):
        raise AssertionError(f"train-diffusion: step {state['step']} or non-finite params")
    del state
    torch.cuda.empty_cache()
    stray = {tag: n for tag, n in modulated.items()
             if n and not tag.startswith(("train", "sample", "app"))}
    if stray:  # the commands that run no model
        raise AssertionError(f"modulated GroupNorm+SiLU calls in {stray}")
    fwd = {tag: n for tag, (_, n, _) in launches.items() if n}
    bwd = {tag: n for tag, (_, _, n) in launches.items() if n}
    mod = {tag: n for tag, n in modulated.items() if n}
    return fwd, bwd, mod, checked



# phase 14: data parallelism
DP_STEPS = 1 + 3  # regression steps per run: a warm-up and 3 timed
DP_DIFFUSION_STEPS = 1 + 2
DP_DATAGEN_PLATES = 4
DP_DATAGEN_SEED = 2024
DP_TIMEOUT_S = 600  # a launch of ranks that runs longer fails


def module_rel(got, want):
    """max |got - want| over max |want|, over one module's tensors."""
    num = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    return num / max(float(b.float().abs().max()) for b in want)


def state_digest(tensors):
    """sha256 of the tensors' bytes: equal digests are equal bits."""
    import hashlib

    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def timed_collective(device, fn, reps):
    """ms per call of `fn` (a collective every rank calls alike), each
    ended by a synchronization of the device."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def dp_regression_rank(results, reference, steps):
    """One rank of phase 14b / 14f: the full-width regression Trainer at
    the global batch TRAIN_BATCH (its rows of it): the first step at ieee,
    held against the one-rank reference (whose shapes differ), then train()
    over the rest at the policy's default; a sample batch through
    sample_and_save, and the collectives timed at the step's sizes. Returns
    what the parent checks."""
    from unittest import mock

    from fea_tpu_torch.parallel import distributed, mesh
    from fea_tpu_torch.train import Trainer
    from fea_tpu_torch.train.trainer import MODULES
    from fea_tpu_torch.utils.precision import model_precision

    torch.backends.cuda.matmul.allow_tf32 = False
    device = distributed.local_device()
    data, samples = SyntheticFEADataset(64, IMAGE, SEED), SyntheticFEADataset(8, IMAGE, SEED + 1)
    trainer = Trainer(trainer_config(IMAGE, Path(results)), dataset=data, sample_dataset=samples,
                      device=device)
    trainer.config.num_train_steps = steps
    ref = torch.load(reference, map_location=device, weights_only=True)
    stamps, losses = [], []

    def on_step(step, loss, *rest):
        recorder.stop()
        stamps.append(time.perf_counter())
        losses.append(loss)

    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(torch, "save", wraps=torch.save) as save:
        with model_precision(conv="ieee"):
            losses.append(float(trainer._train_step(trainer._fetch_batch(0))))
        stamps.append(time.perf_counter())
        # the reduced gradients, read as Adam's first moment
        first = {k: module_rel(trainer.opt_states[k].mu, ref["mu"][k]) for k in MODULES}
        recorder = ConvPrecisions()
        trainer.train(on_step)
    launches, modulated, saves = counts(), modulated_launches(), save.call_count
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    reset_counts()
    files, _, sample_loss = trainer.sample_and_save(milestone="dp", use_ema=True)
    sample_launches, sample_modulated = counts(), modulated_launches()
    grads = [p.detach().clone() for k in MODULES for p in trainer.params[k]]
    rows = torch.zeros((TRAIN_BATCH // distributed.process_count(), IMAGE, IMAGE, 2), device=device)
    return dict(
        rank=distributed.process_index(), device=str(device), losses=losses,
        conv=sorted(recorder.seen),
        ms=list(np.diff([t0] + stamps) * 1e3), grad_rel=first, launches=launches,
        modulated=modulated, sample_launches=sample_launches, sample_modulated=sample_modulated,
        saves=saves, files=None if files is None else len(files),
        sample_loss=sample_loss, peak_gb=peak,
        all_reduce_ms=timed_collective(device, lambda: mesh.all_reduce_mean(grads), 3),
        bucket_bytes=sum(g.numel() * g.element_size() for g in grads),
        gather_ms=timed_collective(device, lambda: mesh.gather_rows(rows), 5),
        gather_bytes=rows.numel() * rows.element_size(),
        digest=state_digest(trainer._state_tensors()),
    )


def dp_diffusion_rank(results, reference, steps):
    """One rank of phase 14c: the full-width DiffusionTrainer at the global
    batch DIFFUSION_BATCH, `steps` steps (the first at ieee, held against
    the one-rank reference; the rest at the policy's default), then its
    checkpoint."""
    from unittest import mock

    from fea_tpu_torch.parallel import distributed
    from fea_tpu_torch.utils.precision import model_precision

    torch.backends.cuda.matmul.allow_tf32 = False
    device = distributed.local_device()
    trainer = dp_diffusion_trainer(results, device)
    ref = torch.load(reference, map_location=device, weights_only=True)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    losses, ms, grad_rel, conv = [], [], None, None
    for i in range(steps):
        x0, cond = trainer._fetch(i * DIFFUSION_BATCH)
        torch.cuda.synchronize(device)
        recorder = ConvPrecisions()
        t0 = time.perf_counter()
        with model_precision(conv="ieee" if i == 0 else None):
            losses.append(float(trainer._train_step(x0, cond)))
        ms.append((time.perf_counter() - t0) * 1e3)
        recorder.stop()
        if i == 0:
            grad_rel = module_rel(trainer.opt_state.mu, ref["mu"])
        elif conv is None:
            conv = sorted(recorder.seen)
    launches, modulated = counts(), modulated_launches()
    with mock.patch.object(torch, "save", wraps=torch.save) as save:
        trainer.save_checkpoint("final")
    opt = trainer.opt_state
    return dict(rank=distributed.process_index(), losses=losses, ms=ms, grad_rel=grad_rel,
                conv=conv, launches=launches, modulated=modulated, saves=save.call_count,
                peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                digest=state_digest([*trainer.params, *trainer.ema_params, *opt.mu, *opt.nu]))


def dp_diffusion_trainer(results, device):
    from fea_tpu_torch.train import DiffusionConfig, DiffusionTrainer

    return DiffusionTrainer(DiffusionConfig(
        dataset_image_size=IMAGE, train_batch_size=DIFFUSION_BATCH, num_train_steps=1,
        num_steps_per_milestone=10**9, input_dim=64, num_stages=4,
        skip_dataset_size_check=True, results_folder=str(results), seed=SEED,
    ), dataset=SyntheticFEADataset(16, IMAGE, SEED + 3), device=device)


def check_ranks(tag, outs, ref_loss, want_launches, grad_rel):
    """Both ranks' state equal bit for bit, the first loss and the reduced
    gradients (both at ieee) within STEP_LOSS_RTOL / STEP_GRAD_REL of the
    one-rank step, the later steps' convolutions at the policy's default,
    the kernels launched in every rank (the modulated forward in none: the
    steps need gradients), one checkpoint written by rank 0."""
    from fea_tpu_torch.utils.precision import DEFAULT_CONV

    if len({o["digest"] for o in outs}) != 1:
        raise AssertionError(f"{tag}: the ranks' states differ")
    for o in outs:
        if o["conv"] != [DEFAULT_CONV]:
            raise AssertionError(f"{tag}: rank {o['rank']} convolutions at {o['conv']}")
        if abs(o["losses"][0] - ref_loss) > STEP_LOSS_RTOL * abs(ref_loss):
            raise AssertionError(f"{tag}: rank {o['rank']} loss {o['losses'][0]} against {ref_loss}")
        if grad_rel(o) > STEP_GRAD_REL:
            raise AssertionError(f"{tag}: rank {o['rank']} gradients {grad_rel(o)} off")
        if o["launches"] != want_launches or o["modulated"]:
            raise AssertionError(f"{tag}: rank {o['rank']} launches {o['launches']} and "
                                 f"{o['modulated']} modulated, want {want_launches} and 0")
    if [o["saves"] for o in outs] != [1] + [0] * (len(outs) - 1):
        raise AssertionError(f"{tag}: checkpoint writes by rank {[o['saves'] for o in outs]}")


def regression_ranks(tag, results, reference, ref_loss, devices, backend):
    """Phase 14b / 14f: two ranks of dp_regression_rank, checked."""
    from fea_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    outs = launch(dp_regression_rank, len(devices), (str(results), str(reference), DP_STEPS),
                  devices=devices, backend=backend, timeout_s=DP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check_ranks(tag, outs, ref_loss, (0, 18 * DP_STEPS, 18 * DP_STEPS),
                lambda o: max(o["grad_rel"].values()))
    if [o["files"] for o in outs] != [16] + [None] * (len(outs) - 1) or len(
            {o["sample_loss"] for o in outs}) != 1 or not math.isfinite(outs[0]["sample_loss"]):
        raise AssertionError(f"{tag}: sample_and_save {[(o['files'], o['sample_loss']) for o in outs]}")
    if any(o["sample_launches"] != (0, 18, 0) or o["sample_modulated"] != PREDICT_MODULATED
           for o in outs):
        raise AssertionError(f"{tag}: sample launches "
                             f"{[(o['sample_launches'], o['sample_modulated']) for o in outs]}")
    if not (results / "model-final" / "state.pt").is_file():
        raise AssertionError(f"{tag}: no checkpoint")
    for o in outs:
        log(f"phase 14{tag}: rank {o['rank']} on {o['device']}: losses "
            f"{', '.join(f'{v:.6f}' for v in o['losses'])} (one rank: first {ref_loss:.6f}); "
            f"reduced gradients {max(o['grad_rel'].values()):.3e} of each module's largest off "
            f"the one-rank step; ms per step {', '.join(f'{t:.3f}' for t in o['ms'])} (the first "
            f"at ieee with the warm-up, the rest at {o['conv'][0]}); launches {o['launches']}, "
            f"sample batch {o['sample_launches']} and {o['sample_modulated']} modulated; "
            f"peak {o['peak_gb']:.2f} GB; all-reduce of {o['bucket_bytes'] / 1e9:.3f} GB "
            f"{', '.join(f'{t:.3f}' for t in o['all_reduce_ms'])} ms; gather of "
            f"{o['gather_bytes'] / 1e6:.3f} MB {', '.join(f'{t:.3f}' for t in o['gather_ms'])} ms")
    log(f"phase 14{tag}: {len(outs)} ranks in {wall:.1f} s: states equal bit for bit, one "
        f"checkpoint written by rank 0, sample loss {outs[0]['sample_loss']:.6f} on every rank")
    return outs


def datagen_tree_diffs(a, b):
    """Two datagen trees of one seed, file by file. Returns (the same file
    names, every file outside the solves' outputs equal byte for byte,
    {(plate, condition): (largest gray-level difference of its displacement
    PNGs, largest difference of its ranges over their span)}, the trees
    equal byte for byte)."""
    from PIL import Image

    ta, tb = tree_bytes(a), tree_bytes(b)
    if ta.keys() != tb.keys():
        return False, False, {}, False
    diffs, inputs_equal = {}, True
    for name in sorted(ta):
        parts = Path(name).parts
        solved = len(parts) == 3 and (parts[2].startswith("outputs_") or parts[2] == "ranges.txt")
        if not solved:
            inputs_equal &= ta[name] == tb[name]
            continue
        png, rng = diffs.get(parts[:2], (0, 0.0))
        if parts[2].endswith(".png"):
            x, y = (np.asarray(Image.open(os.path.join(r, name)), np.int16) for r in (a, b))
            png = max(png, int(np.abs(x - y).max()))
        else:
            for la, lb in zip(ta[name].decode().splitlines(), tb[name].decode().splitlines()):
                va, vb = (np.array(eval(line.split(":")[1])) for line in (la, lb))
                rng = max(rng, float(np.abs(va - vb).max() / max(abs(vb[1] - vb[0]), 1e-30)))
        diffs[parts[:2]] = (png, rng)
    return True, inputs_equal, diffs, ta == tb


def shard_shape_witness(device, ranks):
    """Phase 14d's second witness: phase 9's chunk (4 plates x 4
    conditions, the scheduler's budget), cold and then warm started from
    the cold rows as a continuation is, on the 2 shards of `ranks`. Each
    shard's rows must equal bit for bit the unsharded chunk of its own
    plates on the same card: the code is then the same, and what differs
    from the unsharded 4-plate chunk comes from the chunk's shape alone."""
    from fea_tpu_torch.datagen.batched import dispatch_plate_group, unpack_plate_group

    payloads = chunk_payloads(device, banded=True)
    half = len(payloads) // 2
    nb2 = 2 * payloads[0][0].node_bucket
    x0s = None
    for start in ("cold", "warm"):
        whole = dispatch_plate_group(payloads, x0s=x0s).result()
        sharded = dispatch_plate_group(payloads, x0s=x0s, devices=ranks).result()
        equal = []
        for k in range(2):
            block = slice(k * half, (k + 1) * half)
            alone = dispatch_plate_group(payloads[block],
                                         x0s=None if x0s is None else x0s[block]).result()
            equal.append(torch.equal(sharded[block], alone))
        whole_res = unpack_plate_group(whole.cpu().numpy(), payloads)
        sharded_res = unpack_plate_group(sharded.cpu().numpy(), payloads)
        u_rel = float((whole[..., :nb2] - sharded[..., :nb2]).abs().max()
                      / whole[..., :nb2].abs().max())
        log(f"phase 14d: shape witness, {start} start: each shard's rows equal bit for bit to "
            f"the unsharded chunk of its {half} plates {equal}; against the unsharded "
            f"{len(payloads)}-plate chunk u within {u_rel:.3e} of the largest, iterations per "
            f"lane {[int(r.iterations) for p in whole_res for r in p]} whole, "
            f"{[int(r.iterations) for p in sharded_res for r in p]} sharded")
        if not all(equal):
            raise AssertionError(f"14d: a shard's rows differ from its plates' own chunk ({start})")
        x0s = [[np.asarray(r.displacements[-1], np.float32) for r in plate] for plate in whole_res]


def phase_data_parallel(device, results):
    """Phase 14: data parallelism. Returns the GroupNorm+SiLU launches of
    one rank's runs in 14b and 14c, forward and backward, and the modulated
    forward's calls in one rank's sample batch of 14b."""
    from fea_tpu_torch.datagen import batched, generate_data_batched
    from fea_tpu_torch.parallel import distributed, launch, scaling
    from fea_tpu_torch.train import Trainer
    from fea_tpu_torch.train.trainer import MODULES
    from fea_tpu_torch.utils.precision import model_precision

    card = nvidia_smi()
    log(f"phase 14: on {card}")
    root = results / "dp"
    root.mkdir(parents=True)

    # (a) the regression Trainer's steps under an NCCL group of one rank
    # against the same steps with no group, cuDNN's deterministic algorithms
    # so that two runs can be equal bit for bit; the grouped run then saves
    # (its barriers under NCCL). The first step runs at ieee: it is the
    # reference that (b) holds its ranks to, at other shapes; the rest at
    # the policy's default
    data = SyntheticFEADataset(64, IMAGE, SEED)
    samples = SyntheticFEADataset(8, IMAGE, SEED + 1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reference = {}

    def run(tag):
        trainer = Trainer(trainer_config(IMAGE, root / tag), dataset=data, sample_dataset=samples,
                          device=device)
        ms, losses = [], []
        reset_counts()
        for i in range(DP_STEPS):
            batch = trainer._fetch_batch(i * TRAIN_BATCH)
            torch.cuda.synchronize()
            recorder = ConvPrecisions()
            t0 = time.perf_counter()
            with model_precision(conv="ieee" if i == 0 else None):
                losses.append(float(trainer._train_step(batch)))
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 1:
                conv = recorder.check(f"phase 14a: {tag}: step 1")
            recorder.stop()
            if not reference:  # the one-rank step 14b is held against
                reference.update(loss=losses[0], mu={
                    k: [m.to("cpu", copy=True) for m in trainer.opt_states[k].mu] for k in MODULES})
        if counts() != (0, 18 * DP_STEPS, 18 * DP_STEPS) or modulated_launches():
            raise AssertionError(f"14a {tag}: launches {counts()}, {modulated_launches()} "
                                 f"modulated")
        if torch.distributed.is_initialized():
            trainer.save_checkpoint("final")
            if not (root / tag / "model-final" / "state.pt").is_file():
                raise AssertionError(f"14a {tag}: no checkpoint")
        log(f"phase 14a: {tag}: losses {', '.join(f'{v:.5f}' for v in losses)}; ms per step "
            f"{', '.join(f'{t:.3f}' for t in ms)} (the first at ieee with the warm-up, the rest "
            f"at {conv})")
        state = [t.cpu() for t in trainer._state_tensors()]
        del trainer
        torch.cuda.empty_cache()
        return float(np.mean(ms[1:])), state

    try:
        alone_ms, alone = run("no_group")
        distributed.shutdown()  # decide afresh: join a group of one
        distributed.ensure_initialized(f"file://{root / 'rendezvous'}", 1, 0, device=device)
        try:
            backend = torch.distributed.get_backend()
            group_ms, grouped = run("nccl_group_of_one")
        finally:
            distributed.shutdown()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if backend != ("nccl" if device.type == "cuda" else "gloo") or len(alone) != len(grouped) or not all(
            torch.equal(a, b) for a, b in zip(alone, grouped)):
        raise AssertionError(f"14a: under a {backend} group of one the state differs")
    log(f"phase 14a: {DP_STEPS} steps at batch {TRAIN_BATCH}, no group against an NCCL group of "
        f"one rank: {len(alone)} state tensors equal bit for bit; mean ms per step after the "
        f"warm-up {alone_ms:.3f} without a group, {group_ms:.3f} in it (cuDNN deterministic); "
        f"the grouped run saved its checkpoint between two NCCL barriers")
    del alone, grouped
    torch.save(reference, root / "reference.pt")

    # (b) two gloo ranks on this card at the same global batch
    ranks = [f"cuda:{device.index or 0}" if device.type == "cuda" else str(device)] * 2
    b_outs = regression_ranks("b", root / "b", root / "reference.pt", reference["loss"], ranks,
                              "gloo")

    # (c) the DiffusionTrainer: two gloo ranks against one
    one = dp_diffusion_trainer(root / "c_one", device)
    x0, cond = one._fetch(0)
    with model_precision(conv="ieee"):  # the ranks' first step is held to it at other shapes
        loss = float(one._train_step(x0, cond))
    torch.save({"mu": [m.to("cpu", copy=True) for m in one.opt_state.mu]}, root / "diffusion_reference.pt")
    del one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c_outs = launch(dp_diffusion_rank, 2, (str(root / "c"), str(root / "diffusion_reference.pt"),
                                           DP_DIFFUSION_STEPS),
                    devices=ranks, backend="gloo", timeout_s=DP_TIMEOUT_S)
    check_ranks("c", c_outs, loss, (0, 9 * DP_DIFFUSION_STEPS, 9 * DP_DIFFUSION_STEPS),
                lambda o: o["grad_rel"])
    for o in c_outs:
        log(f"phase 14c: rank {o['rank']}: losses {', '.join(f'{v:.6f}' for v in o['losses'])} "
            f"(one rank: first {loss:.6f}); reduced gradients {o['grad_rel']:.3e} of the largest "
            f"off the one-rank step; ms per step {', '.join(f'{t:.3f}' for t in o['ms'])} (the "
            f"first at ieee, the rest at {o['conv'][0]}); launches {o['launches']}; peak "
            f"{o['peak_gb']:.2f} GB")
    log(f"phase 14c: 2 ranks in {time.perf_counter() - t0:.1f} s, states equal bit for bit")

    # (d) datagen at bench.py's config on 2 shards of this card against 1.
    # A lane's f32 arithmetic depends on its chunk's plate count (the card's
    # reductions pick their order by shape), and near the f32 floor that
    # moves a lane between the CG tolerance, the acceptance tolerance (2e-3)
    # and the host's direct solve; so the conditions held to 1 gray level
    # are those whose lanes ended under a residual of 1e-4 in both runs, as
    # phase 9 holds its two operators; the others are printed. The shape
    # witness then holds each shard against the unsharded chunk of its own
    # plates, bit for bit, cold and warm started.
    common = dict(DATAGEN, num_plates=DP_DATAGEN_PLATES, seed=DP_DATAGEN_SEED)
    solved = {}
    for tag, kw in (("1", dict(device=device)), ("2", dict(n_devices=2, device=ranks))):
        t0 = time.perf_counter()
        stats = generate_data_batched(data_dir=str(root / f"datagen_{tag}"), **common, **kw)
        wall = time.perf_counter() - t0
        solved[tag] = {(str(p), str(c)): (r, i) for p, c, r, i in stats["solved_conditions"]}
        log(f"phase 14d: {tag} shard(s): {DP_DATAGEN_PLATES} plates in {wall:.2f} s "
            f"({DP_DATAGEN_PLATES / wall * 3600:.1f} plates per hour), {stats['solves']} "
            f"solves in {stats['chunks']} chunks, {stats['continuations']} continuations, "
            f"{stats['cg_failures']} CG failures, {stats['direct_fallbacks']} direct fallbacks, "
            f"{stats['cg_resamples']} resampled")
    dispatch = dict(batched.LAST_DISPATCH)
    same_files, inputs_equal, diffs, identical = datagen_tree_diffs(root / "datagen_2",
                                                                    root / "datagen_1")
    tight = [k for k in diffs if max(solved["1"][k][0], solved["2"][k][0]) <= CHUNK_OPERATORS_RESIDUAL]
    loose = sorted(set(diffs) - set(tight))
    log(f"phase 14d: LAST_DISPATCH {dispatch}; the trees: same files {same_files}, the sampled "
        f"inputs equal {inputs_equal}, byte for byte equal {identical}; {len(tight)} of "
        f"{len(diffs)} conditions ended under a residual of {CHUNK_OPERATORS_RESIDUAL} in both: "
        f"PNGs within {max((diffs[k][0] for k in tight), default=0)} gray levels, ranges within "
        f"{max((diffs[k][1] for k in tight), default=0.0)} of their span")
    for k in loose:
        log(f"phase 14d: plate {k[0]} condition {k[1]}: residual, iterations {solved['1'][k]} on 1 "
            f"shard, {solved['2'][k]} on 2; PNGs {diffs[k][0]} gray levels apart, ranges "
            f"{diffs[k][1]} of their span")
    shard_shape_witness(device, ranks)
    if dispatch != dict(n_devices=1, n_shards=2, rows=4, shard_rows=2) or not (
            same_files and inputs_equal) or not tight or any(
            diffs[k][0] > 1 or diffs[k][1] > 1e-4 for k in tight):
        raise AssertionError("14d: the sharded datagen differs from the unsharded")

    # (e) the weak-scaling efficiency of the sharded chunk, both shards here
    eff = scaling.measure_sharding_efficiency(2, devices=ranks)
    log(f"phase 14e: measure_sharding_efficiency(2) on {eff['devices']}: t_1 {eff['t_1dev_s']:.4f} "
        f"s, t_2 {eff['t_ndev_s']:.4f} s over {eff['solves_per_timing']} solves; efficiency "
        f"{eff['efficiency']:.4f}, spread {eff['efficiency_spread']}; repeats "
        f"{eff['t_1dev_repeats_s']} / {eff['t_ndev_repeats_s']}")

    # (f) NCCL over two cards
    cards = torch.cuda.device_count()
    if cards >= 2:
        regression_ranks("f", root / "f", root / "reference.pt", reference["loss"],
                         ["cuda:0", "cuda:1"], "nccl")
    else:
        log(f"phase 14f: NOT RUN: NCCL puts each rank on a card of its own and this machine "
            f"shows {cards}; the two-card run is still to do (this is not a pass)")
    log(f"phase 14: on {card}")
    fwd = {"dp_regression_per_rank": b_outs[0]["launches"][1],
           "dp_diffusion_per_rank": c_outs[0]["launches"][1]}
    bwd = {"dp_regression_per_rank": b_outs[0]["launches"][2],
           "dp_diffusion_per_rank": c_outs[0]["launches"][2]}
    mod = {"dp_regression_sample_per_rank": b_outs[0]["sample_modulated"]}
    return fwd, bwd, mod


# phase 15: band-block Jacobi on phase 9's chunk and in the datagen
# scheduler: (name, dispatch keywords)
VARIANTS = (
    ("default", {}),
    ("band_block 128", {"band_block": 128}),
    ("band_block 256", {"band_block": 256}),
)
VARIANT_TREE_REL = 1e-3  # ranges of a variant's tree vs the default's, of their span


def align_plates(tree, reference):
    """Renumber `tree`'s plate folders to the numbers the same plates have
    in `reference`. The scheduler numbers plates in the order they finish,
    which a solver variant changes; a plate is known by its input.png (the
    sampled geometry). Returns {old number: new number}, empty (nothing
    renamed) unless the two trees hold the same plates."""
    def plates(root):
        return {Path(root, d, "input.png").read_bytes(): d for d in os.listdir(root)
                if Path(root, d, "input.png").is_file()}

    ours, theirs = plates(tree), plates(reference)
    mapping = {d: theirs[k] for k, d in ours.items() if k in theirs}
    if len(mapping) != len(ours) or len(ours) != len(theirs):
        return {}
    for old in mapping:
        os.rename(Path(tree, old), Path(tree, old + ".renumbered"))
    for old, new in mapping.items():
        os.rename(Path(tree, old + ".renumbered"), Path(tree, new))
    return mapping


def variant_kernels(device, payloads, kw):
    """Device kernels per loop body of one variant's chunk solve, as phase 9
    counts them: the whole solve on this thread (where the profiler
    records) less its set-up, over the loop bodies it queued. The solve's
    keywords are dispatch_plate_group's own (batched.chunk_keywords)."""
    from fea_tpu_torch.datagen.batched import chunk_inputs, chunk_keywords, chunk_tables
    from fea_tpu_torch.fem.flatgroup import chunk_system, flat_group_body
    from fea_tpu_torch.fem.solver import CHECK_EVERY

    solvers, host, m_real, band_hb = chunk_inputs(payloads)
    body_kw = chunk_keywords(solvers, band_hb, **kw)
    tables, m_real_p = chunk_tables(solvers, host, m_real, device)
    setup_kw = {k: body_kw[k] for k in ("n_coarse", "band_hb", "band_block")}
    k_setup = device_kernels(lambda: chunk_system(*tables, m_real_p=m_real_p, **setup_kw))
    info = {}
    k_total = device_kernels(lambda: flat_group_body(*tables, m_real_p=m_real_p, info=info,
                                                     **body_kw))
    bodies = CHECK_EVERY * (info["host_reads"] - solvers[0].restarts)
    return (k_total - k_setup) / max(bodies, 1)


def phase_variants(device, results, default_plates_per_hour):
    """Phase 15: band-block Jacobi on phase 9's chunk against the host's
    f64 direct solve, and generate_data_batched with it against the
    default's tree of the same seed."""
    from fea_tpu_torch.datagen import generate_data_batched
    from fea_tpu_torch.datagen.batched import dispatch_plate_group, unpack_plate_group
    from fea_tpu_torch.fem import direct_solve
    from fea_tpu_torch.fem.solver import CHECK_EVERY

    t0 = time.perf_counter()
    chunk = chunk_payloads(device, banded=True)
    s0 = chunk[0][0]
    P, C = len(chunk), len(chunk[0][1])
    direct = [[direct_solve(problem).displacements[-1] for problem in problems]
              for _, problems in chunk]
    log(f"phase 15: phase 9's chunk, {P} plates x {C} conditions, band hb {s0.band_hb}, "
        f"n_coarse {s0.n_coarse}; solvers and the {P * C} direct solves in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, kw in VARIANTS:  # warm-up: each variant's solver kernels
        dispatch_plate_group(chunk, **kw).result()
    # timed in turns (in order, reversed, in order): a body's time is the
    # host's and moves from run to run
    runs = {name: [] for name, _ in VARIANTS}
    first = {}
    for name, kw in VARIANTS + VARIANTS[::-1] + VARIANTS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the earlier phases and this one's tables
        info = {}
        t1 = time.perf_counter()
        rows = dispatch_plate_group(chunk, info=info, **kw).result()
        info["wall"] = time.perf_counter() - t1
        info["peak"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        info["same"] = torch.equal(rows, first.setdefault(name, rows))
        runs[name].append(info)
    failures = []
    for name, kw in VARIANTS:
        res = unpack_plate_group(first[name].cpu().numpy(), chunk)
        iters = [int(r.iterations) for plate in res for r in plate]
        worst, converged = 0.0, 0
        for p, plate in enumerate(res):
            for c, r in enumerate(plate):
                if r.success:
                    converged += 1
                    want = direct[p][c]
                    scale = max(float(np.abs(want).max()), 1e-30)
                    worst = max(worst, float(np.abs(r.displacements[-1] - want).max()) / scale)
        reads = runs[name][0]["host_reads"]
        bodies = CHECK_EVERY * (reads - s0.restarts)
        per_body = variant_kernels(device, chunk, kw)

        def spread(key, scale=1.0):
            v = sorted(run[key] * scale for run in runs[name])
            return f"{v[len(v) // 2]:.4f} [{v[0]:.4f}, {v[-1]:.4f}]"

        log(f"phase 15: {name}: iterations over lanes sum {sum(iters)}, median "
            f"{float(np.median(iters)):.1f}, max {max(iters)}; {bodies} loop bodies, {reads} host "
            f"reads; over {len(runs[name])} runs, median [min, max]: chunk ms {spread('wall', 1e3)}, "
            f"setup_s {spread('setup_s')}, loop_s {spread('loop_s')}, ms per body "
            f"{spread('loop_s', 1e3 / max(bodies, 1))}; {per_body:.1f} kernels per body; the "
            f"solve's peak device memory {max(run['peak'] for run in runs[name]):.3f} GB above "
            f"what was held before it; repeats bit for bit: "
            f"{all(run['same'] for run in runs[name])}; {converged} of {P * C} lanes converged, the "
            f"worst within {worst:.3e} of the host's f64 direct solve (tolerance {CHUNK_DIRECT_REL})")
        if converged == 0 or worst > CHUNK_DIRECT_REL:
            failures.append(name)
    del first
    if failures:
        raise AssertionError(f"phase 15: no converged lane, or one off the direct solve: {failures}")
    w = 256
    factor_gb = C * 2 * P * s0.node_bucket * w * 4 / 1e9
    log(f"phase 15: band_block {w}: the factor's f32 copy is held for the loop, {factor_gb:.3f} GB "
        f"({C * 2 * P * s0.node_bucket // w} blocks of {w}x{w}); the bf16 factor "
        f"({factor_gb / 2:.3f} GB) is freed after the set-up")

    # datagen: every variant warmed up as phase 10 warms the default (its
    # first chunks build the band-block factor at new shapes), then from
    # phase 10's timed seed in turns (in order, then reversed); the first
    # run of each keeps its tree
    common = dict(DATAGEN, device=device, num_plates=DATAGEN_TIMED_PLATES, seed=1234)
    for name, kw in VARIANTS:
        folder = results / ("variant_warm_" + name.replace(" ", "_"))
        generate_data_batched(data_dir=str(folder), **dict(common, num_plates=DATAGEN_WARMUP_PLATES,
                                                           seed=7), **kw)
        shutil.rmtree(folder, ignore_errors=True)
    rates = {name: [] for name, _ in VARIANTS}
    solved, trees = {}, {}
    for turn, (name, kw) in enumerate(VARIANTS + VARIANTS[::-1]):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        folder = results / ("variant_" + name.replace(" ", "_") + f"_{turn}")
        t1 = time.perf_counter()
        stats = generate_data_batched(data_dir=str(folder), **common, **kw)
        wall = time.perf_counter() - t1
        rates[name].append(DATAGEN_TIMED_PLATES / wall * 3600)
        for plate in range(1, DATAGEN_TIMED_PLATES + 1):
            plate_files_ok(str(folder / str(plate)), DATAGEN["conditions_per_plate"],
                           DATAGEN["num_steps_per_condition"])
        bodies = CHECK_EVERY * (stats["host_reads"] - stats["chunks"])
        iters = stats["converged_iters"]
        log(f"phase 15: generate_data_batched with {name}, {DATAGEN_TIMED_PLATES} plates "
            f"(seed 1234, as phase 10's timed run), turn {turn}: {wall:.1f} s, "
            f"{rates[name][-1]:.1f} plates per hour; {stats['solves']} solves in "
            f"{stats['chunks']} chunks, {stats['cg_failures']} CG failures, "
            f"{stats['direct_fallbacks']} direct fallbacks, {stats['continuations']} "
            f"continuations; converged lanes' iterations median "
            f"{float(np.median(iters)) if iters else float('nan'):.0f}, max {max(iters, default=0)}; "
            f"{stats['chunk_loop_s'] * 1e3 / max(bodies, 1):.3f} ms per loop body; peak device "
            f"memory {(torch.cuda.max_memory_allocated() - held) / 1e9:.2f} GB above the "
            f"{held / 1e9:.2f} GB held before the run")
        if name in trees:
            shutil.rmtree(folder, ignore_errors=True)
        else:
            trees[name] = folder
            solved[name] = {(str(p), str(c)): (r, i) for p, c, r, i in stats["solved_conditions"]}
    log(f"phase 15: datagen plates per hour, runs in turn order: "
        + "; ".join(f"{name} {', '.join(f'{v:.1f}' for v in rates[name])}" for name, _ in VARIANTS)
        + f" (phase 10, default: {default_plates_per_hour:.1f})")
    # each variant's tree against the default's: a lane's result moves with
    # its preconditioner within the CG tolerance, so the conditions held are
    # those that ended under a residual of 1e-4 in both (as phase 14d holds
    # its two runs), where both are within 1e-3 of the direct solve
    bad = []
    for name, _ in VARIANTS[1:]:
        mapping = align_plates(trees[name], trees["default"])
        renumbered = sum(old != new for old, new in mapping.items())
        same_files, inputs_equal, diffs, identical = datagen_tree_diffs(trees[name], trees["default"])
        pair = ({(mapping.get(p, p), c): v for (p, c), v in solved[name].items()}, solved["default"])
        tight = [k for k in diffs if k in pair[0] and k in pair[1]
                 and max(pair[0][k][0], pair[1][k][0]) <= CHUNK_OPERATORS_RESIDUAL]
        worst_png = max((diffs[k][0] for k in tight), default=0)
        worst_rng = max((diffs[k][1] for k in tight), default=0.0)
        log(f"phase 15: the {name} tree against the default's ({len(mapping)} plates matched by "
            f"input.png, {renumbered} finished in another order): same files {same_files}, the "
            f"sampled inputs equal {inputs_equal}, byte for byte equal {identical}; {len(tight)} "
            f"of {len(diffs)} conditions ended under a residual of {CHUNK_OPERATORS_RESIDUAL} in "
            f"both: PNGs within {worst_png} gray levels, ranges within {worst_rng} of their span "
            f"(tolerances 1 and {VARIANT_TREE_REL})")
        loose = sorted(set(diffs) - set(tight))
        log(f"phase 15: {name}: the other {len(loose)} conditions (a residual above "
            f"{CHUNK_OPERATORS_RESIDUAL} in either run, or the direct lane): PNGs within "
            f"{max((diffs[k][0] for k in loose), default=0)} gray levels, ranges within "
            f"{max((diffs[k][1] for k in loose), default=0.0)} of their span")
        if not (mapping and same_files and inputs_equal and tight) or worst_png > 1 or \
                worst_rng > VARIANT_TREE_REL:
            bad.append(name)
    for folder in trees.values():
        shutil.rmtree(folder, ignore_errors=True)
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase 15: the datagen tree differs from the default's: {bad}")


# phase 16: the CG loop's kernels (fea_tpu_torch/ops/cg.py) on phase 9's chunk
CG_REPLACES = {
    "cg_alpha": "fea_tpu/fem/solver.py:270", "cg_update_xr": "fea_tpu/fem/solver.py:270",
    "jacobi_restrict": "fea_tpu/fem/flatgroup.py:329",
    "prolong_dots": "fea_tpu/fem/flatgroup.py:329", "cg_update_p": "fea_tpu/fem/solver.py:270",
}
CG_SOURCE = "fea_tpu_torch/csrc/cg_segmented.cu"
CG_STATE_BODIES = 20  # the kernels are held against the plain versions this far into the solve
CG_KERNEL_REL = 1e-5  # a launch's outputs against the plain version's, of their span (f32)
CG_ROUTE_RUNS = 3
CG_BLOCKS = (8, 16, 32)
CG_MAX_KERNELS = 10  # device kernels per default loop body
F32_FLOPS = 67e12  # f32 outside the tensor cores
BAND_SOURCE = "fea_tpu_torch/csrc/band_matvec.cu"
BAND_REPLACES = "fea_tpu/fem/banded.py:161"
BAND_KERNEL_REL = 1e-5  # the band kernel against its plain versions, of y's span (f32)


class EagerBlock:
    """In place of `ops.cg.capture`: the block's bodies as kernel launches
    from the host, no graph."""

    def __init__(self, fn, warmup, device):
        self.fn = fn

    def replay(self):
        self.fn()

    def close(self):
        pass


def cg_route(name):
    """A context in which the chunk's loop takes route `name`: "graph" (as
    it ships), "kernels" (the same launches, no graph) or "plain" (the
    plain versions on the card, the band operator's included, no graph:
    torch ops with the kernels' signatures, which copy into the state in
    place, so more device kernels a body than the torch-op loop the
    kernels replaced)."""
    from contextlib import ExitStack

    from fea_tpu_torch.ops import band, cg

    stack = ExitStack()
    if name != "graph":
        stack.enter_context(mock.patch.object(cg, "capture", EagerBlock))
    if name == "plain":
        for module, wrapper in [(cg, w) for w in cg.WRAPPERS] + [(band, band.band_matvec)]:
            stack.enter_context(mock.patch.object(
                module, wrapper.__name__, getattr(module, wrapper.__name__ + "_reference")))
    return stack


def chunk_state(system, P, tol, max_iters, bodies):
    """The chunk's loop state after its restart set-up and `bodies` bodies
    (through the kernels), with the loop's operator A."""
    from fea_tpu_torch.fem.solver import masked_operator, segmented_body
    from fea_tpu_torch.ops import cg

    free = system.free
    b = system.b * free
    C, ndof = b.shape
    st = cg.SegmentedState(C, P, ndof // (2 * P), b.dtype, b.device, max_iters, 180)
    A = masked_operator(system.op, free)

    x = system.x0 * free
    r = b - A(x)
    z = system.precondition(r)
    st.start(x, r, z, st.sdot(r, z), st.sdot(r, r),
             torch.ones((C, P), dtype=torch.bool, device=b.device))
    st.atol2.copy_((tol * torch.sqrt(st.sdot(b, b))) ** 2)
    for _ in range(bodies):
        segmented_body(st, A, system.precondition)
    return st, A


def prolong_dots_bytes(L, P, Ns, NA, item):
    """Bytes prolong_dots must move with the state: zj, free and r read and
    z written (L, 2 P Ns), zc (L, NA, 3), agg and arms (P Ns) read once;
    rz, best, stall, run read and rz, r2, best, beta, stall written per
    segment; the lane flag and k per lane."""
    V, PN, S = L * 2 * P * Ns * item, P * Ns, L * P
    return 4 * V + L * NA * 3 * item + PN * (2 * item + 4) + S * (6 * item + 9) + L * 9


def cg_alpha_bytes(L, P, Ns, item):
    """Bytes cg_alpha must move: p and Ap read (L, 2 P Ns); rz, r2, atol2,
    stall and active read and alpha and run written per segment; k read and
    the lane flag written per lane."""
    return 2 * L * 2 * P * Ns * item + L * P * (4 * item + 6) + L * 5


def cg_update_xr_bytes(L, P, Ns, item, share):
    """Bytes cg_update_xr must move where a `share` of the lanes runs: x, r,
    p and Ap read and x and r written on those; alpha read per segment, the
    lane flag per lane."""
    return 6 * L * 2 * P * Ns * item * share + L * P * item + L


def jacobi_restrict_bytes(L, PN, NA, W, members, item):
    """Bytes jacobi_restrict must move: r read, the block inverse (two
    vectors) read and zj written (L, 2 PN); the member table (NA, W) read,
    the arms of its `members` real entries read, rc (L, NA, 3) written."""
    return 4 * L * 2 * PN * item + NA * W * 4 + members * 2 * item + L * NA * 3 * item


def cg_update_p_bytes(L, P, Ns, item, share):
    """Bytes cg_update_p must move where a `share` of the segments runs: z
    and p read and p written on those; beta and run read per segment, the
    lane flag per lane."""
    return 3 * L * 2 * P * Ns * item * share + L * P * (item + 1) + L


def cg_launches(st, A, pre):
    """{name: (run(state, fn) -> outputs, kernel wrapper, plain version,
    (bytes, operations) the launch must move and do at this state)}: each
    of the loop's five launches on its inputs at the state `st`."""
    from fea_tpu_torch.ops import cg

    C, ndof = st.x.shape
    PN = ndof // 2
    item = st.x.element_size()
    NA, W = pre.members.shape
    Ap = A(st.p)
    zj, zc = pre.parts(st.r)
    agg, arms, free = pre.finish
    cg.cg_alpha(st, Ap)  # the body's flags at this state
    lanes = int(st.lane.sum()) / C  # the share of the lanes that run (update_xr)
    segs = int((st.run & st.lane[:, None]).sum()) / (C * st.P)  # ... and of segments (update_p)
    members = int((pre.members < PN).sum())  # real nodes in the member table

    def alpha(s, fn):
        fn(s, Ap)
        return {"alpha": s.alpha, "run": s.run, "lane": s.lane}

    def update_xr(s, fn):
        fn(s, Ap)
        return {"x": s.x, "r": s.r}

    def jacobi(s, fn):
        out = {"zj": torch.empty_like(s.r), "rc": s.r.new_empty((C, NA, 3))}
        fn(s.r, pre.block_inv, pre.arms, pre.members, out["zj"], out["rc"])
        return out

    def prolong(s, fn):
        fn(zj, zc, agg, arms, free, s.z, s.P, s)
        return {"z": s.z, "rz": s.rz, "r2": s.r2, "best": s.best, "beta": s.beta,
                "stall": s.stall, "k": s.k}

    def update_p(s, fn):
        fn(s)
        return {"p": s.p}

    # bytes: each input read once, each output written once; operations:
    # each product and sum on the values this state reads
    return {
        "cg_alpha": (alpha, cg.cg_alpha, cg.cg_alpha_reference,
                     (cg_alpha_bytes(C, st.P, st.Ns, item), 2 * C * ndof)),
        "cg_update_xr": (update_xr, cg.cg_update_xr, cg.cg_update_xr_reference,
                         (cg_update_xr_bytes(C, st.P, st.Ns, item, lanes),
                          4 * C * ndof * lanes)),
        "jacobi_restrict": (jacobi, cg.jacobi_restrict, cg.jacobi_restrict_reference,
                            (jacobi_restrict_bytes(C, PN, NA, W, members, item),
                             3 * C * ndof + 6 * C * members)),
        "prolong_dots": (prolong, cg.prolong_dots, cg.prolong_dots_reference,
                         (prolong_dots_bytes(C, st.P, st.Ns, NA, item), 8 * C * ndof)),
        "cg_update_p": (update_p, cg.cg_update_p, cg.cg_update_p_reference,
                        (cg_update_p_bytes(C, st.P, st.Ns, item, segs), 2 * C * ndof * segs)),
    }


def launch_error(got, want):
    """(max abs error, the largest error over a field's span) of a launch's
    outputs against the plain version's."""
    worst_abs, worst_rel = 0.0, 0.0
    for field, a in got.items():
        b = want[field]
        if b.dtype == torch.bool:
            worst_rel = max(worst_rel, float((a != b).any()))
            continue
        a, b = a.double(), b.double()
        err = float((a - b).abs().max())
        span = float(b.max() - b.min()) or float(b.abs().max()) or 1.0
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / span)
    return worst_abs, worst_rel


def band_operator_bytes(vals, cols, u):
    """Bytes the band operator must move at these tables: each lane's
    non-zero values (a value the free masks made zero need not be read),
    the columns of K's structure once, u read and y written; no padding."""
    nonzero = int((vals != 0).sum())
    structure = int((cols >= 0).sum())
    return nonzero * vals.element_size() + structure * 4 + 2 * u.numel() * u.element_size()


def band_staged_bytes(vals, cols, widths, u):
    """Bytes the band kernel is modelled to move (not measured): each
    slice's tables up to its widest row (its columns once, each lane's
    values), the width table, u once (assuming its gathers hit L2) and y."""
    C, item = vals.shape[0], vals.element_size()
    staged = int(widths.sum()) * cols.shape[2] * (4 + C * item)
    return staged + widths.numel() * 4 + 2 * u.numel() * u.element_size()


def lanes_csr(vals, cols, n_dofs):
    """The lanes' compacted bands as one block-diagonal CSR matrix (C n_dofs
    square), for the library's sparse product on the same tables."""
    C, slots = vals.shape[0], cols.shape[1]
    by_row = cols.transpose(1, 2).reshape(-1, slots)[:n_dofs]  # (n_dofs, slots)
    real = by_row >= 0
    row = torch.arange(n_dofs, device=cols.device)[:, None].expand(n_dofs, slots)[real]
    lane = torch.arange(C, device=cols.device)[:, None] * n_dofs
    index = torch.stack([(row[None] + lane).reshape(-1), (by_row[real][None] + lane).reshape(-1)])
    values = vals.transpose(2, 3).reshape(C, -1, slots)[:, :n_dofs][:, real].reshape(-1)
    coo = torch.sparse_coo_tensor(index, values, (C * n_dofs, C * n_dofs), check_invariants=True)
    return coo.coalesce().to_sparse_csr()


def band_operator_entry(system, tables, m_real_p, band_hb, u, earlier=None):
    """Phase 16 (a'): the band kernel on the loop's p against its plain
    version and the dense band's product (the route it replaces, with the
    loop's masks), timed in turns beside cuSPARSE's product on the same
    tables and the earlier checkout's kernel `earlier` (fn(vals, cols, u,
    y, widths)) where given. Returns the kernels line's entry (less the main path's
    launches); raises where the kernel disagrees."""
    from fea_tpu_torch.fem.banded import assemble_band
    from fea_tpu_torch.fem.flatgroup import (
        chunk_stiffness, dense_band_operator, flat_band_indices, flatten_tables)
    from fea_tpu_torch.fem.solver import masked_operator
    from fea_tpu_torch.ops import band

    vals, cols, widths = system.op.vals, system.op.cols, system.op.widths
    C, n_dofs = u.shape
    P, Nb = tables[0].shape[:2]
    coords, tris = flatten_tables(*tables[:5], 1)[:2]
    young, poisson = (t.transpose(0, 1).reshape(C, -1) for t in tables[6:8])
    Ke = chunk_stiffness(coords, tris, young, poisson)[2]
    S = assemble_band(Ke, flat_band_indices(tables[1], m_real_p, Nb, band_hb), n_dofs, band_hb)
    dense = masked_operator(dense_band_operator(S, band_hb), system.free)
    csr = lanes_csr(vals, cols, n_dofs)
    flat_u = u.reshape(-1)
    out = {name: torch.empty_like(u) for name in ("kernel", "plain", "earlier")}
    band.band_matvec(vals, cols, u, out["kernel"], widths)
    band.band_matvec_reference(vals, cols, u, out["plain"])
    want = {"plain": out["plain"], "dense": dense(u).clone(),
            "library": torch.mv(csr, flat_u).reshape(C, n_dofs)}
    torch.cuda.synchronize()
    errs = {name: max_abs_err(out["kernel"], w) for name, w in want.items()}
    span = float(want["dense"].max() - want["dense"].min())
    fns = {
        "kernel": lambda: band.band_matvec(vals, cols, u, out["kernel"], widths),
        "plain": lambda: band.band_matvec_reference(vals, cols, u, out["plain"]),
        "dense": lambda: dense(u),
        "library": lambda: torch.mv(csr, flat_u),
    }
    if earlier is not None:
        earlier(vals, cols, u, out["earlier"], widths)
        torch.cuda.synchronize()
        if not torch.equal(out["earlier"], out["kernel"]):
            raise AssertionError("phase 16: the band kernel is not the earlier kernel bit for bit: "
                                 f"{max_abs_err(out['kernel'], out['earlier']):.3e} apart")
        fns["earlier"] = lambda: earlier(vals, cols, u, out["earlier"], widths)
    ms = in_turns(fns, 50)
    nbytes = band_operator_bytes(vals, cols, u)
    staged = band_staged_bytes(vals, cols, widths, u)
    nonzero = int((vals != 0).sum())
    bound, bound_by = bound_ms(nbytes, 2 * nonzero, F32_FLOPS)
    structure = int((cols >= 0).sum())
    log(f"phase 16: band_matvec: {structure} non-zeros a lane in K's structure ({nonzero / C:.0f} "
        f"a lane after the free masks), {cols.shape[1]} slots a row, {n_dofs} rows; the dense "
        f"band {S.numel() * S.element_size() / 1e9:.3f} GB")
    log(f"phase 16: band_matvec: max abs err vs plain {errs['plain']:.3e}, vs the dense band "
        f"{errs['dense']:.3e}, vs cuSPARSE {errs['library']:.3e} (span {span:.3e}, tolerance "
        f"{BAND_KERNEL_REL} of it); kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
        f"dense band {ms['dense']:.4f} ms, cuSPARSE {ms['library']:.4f} ms, bound {bound:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.3f} MB)"
        + (f", earlier {ms['earlier']:.4f} ms (bit for bit this kernel)" if earlier else ""))
    log(f"phase 16: band_matvec: {staged / 1e6:.3f} MB modelled to be read and written (the "
        f"slices up to their widest row: {int(widths.sum())} slots of {widths.numel()} slices, "
        f"against {cols.shape[0] * cols.shape[1]} in the table; u once, from L2), "
        f"{staged / ms['kernel'] / 1e9:.3f} TB/s over them; "
        f"over the bound's {nbytes / 1e6:.3f} MB {nbytes / ms['kernel'] / 1e9:.3f} TB/s")
    if max(errs["plain"], errs["dense"]) > BAND_KERNEL_REL * span:
        raise AssertionError(f"phase 16: the band kernel is off its plain versions: {errs}")
    del S, Ke, csr
    return {"name": "band_matvec", "route": "cuda", "source": BAND_SOURCE,
            "replaces": BAND_REPLACES, "max_abs_err": max(errs["plain"], errs["dense"]),
            "rel_err": max(errs["plain"], errs["dense"]) / span, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "dense_ms": ms["dense"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": ms["library"], "nonzeros_a_lane": structure,
            "redesigned": REDESIGNED["band_matvec"],
            "slots": int(cols.shape[1]), "bound_bytes": nbytes,
            **({"earlier_ms": ms["earlier"]} if earlier else {})}


def earlier_state(st, earlier_cg):
    """A copy of the loop state `st` for the wrappers of `earlier_cg` (the
    `ops.cg` of another checkout): with the scratch its `cg_alpha` took
    where it had any (partials and tickets, sized by its own blocks a
    segment)."""
    other = st.clone()
    groups = getattr(earlier_cg, "_groups", None)
    if groups is not None:
        segments = st.k.shape[0] * st.P
        other.groups = groups(st.Ns)
        other.partials = st.x.new_zeros(segments * other.groups * 2)
        other.tickets = torch.zeros(segments, dtype=torch.int32, device=st.x.device)
    return other


# outputs of the launches that are held bit for bit against the earlier
# checkout's kernel (alpha itself comes of pAp, whose order of sums differs)
EARLIER_EQUAL = {"cg_alpha": ("run", "lane"), "cg_update_xr": ("x", "r"),
                 "jacobi_restrict": ("zj", "rc"), "prolong_dots": ("z",), "cg_update_p": ("p",)}


def coarse_product_time(pre, r):
    """Phase 16: device ms of the preconditioner's coarse product by
    Kc^-1, a batched product in torch (no kernel of the port), beside the
    bound of its bytes: what is left of a body besides the kernels."""
    vec = torch.randn((r.shape[0], pre.P, 3 * pre.n_coarse), dtype=r.dtype, device=r.device)
    ms = in_turns({"coarse": lambda: torch.einsum("...pij,...pj->...pi", pre.Kc_inv, vec)}, 50)
    nbytes = (pre.Kc_inv.numel() + 2 * vec.numel()) * r.element_size()
    bound, bound_by = bound_ms(nbytes, 2 * pre.Kc_inv.numel(), F32_FLOPS)
    log(f"phase 16: the coarse product by Kc^-1 {tuple(pre.Kc_inv.shape)}: {ms['coarse']:.4f} ms, "
        f"bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.3f} MB)")


def launch_floor():
    """Phase 16: device ms of a kernel that does nothing (`torch.cuda._sleep(0)`),
    timed as the kernels are: what any one launch costs at the least."""
    ms = in_turns({"empty": lambda: torch.cuda._sleep(0)}, 50)["empty"]
    log(f"phase 16: an empty kernel, timed as the kernels are: {ms:.4f} ms")


def restrict_plan_text(L, PN, NA):
    """jacobi_restrict's plan (`ops.cg.restrict_plan`) over L lanes of PN
    nodes and NA aggregates, in words."""
    from fea_tpu_torch.ops import cg

    plan = cg.restrict_plan(L)
    jac, passes, res = plan.grid(L, PN, NA)
    return (f"{jac} Jacobi blocks of {plan.span} nodes a lane and {res} restriction blocks of "
            f"{plan.warps} warps ({passes} pass{'es' * (passes > 1)} of {plan.lanes} lanes), the "
            f"{'Jacobi' if plan.jacobi_first else 'restriction'} blocks first")


def phase_cg_loop(device, results, earlier=None):
    """Phase 16: the CG loop's kernels and the band operator's on phase 9's
    chunk (beside the kernels of `earlier`, the ops package of another
    checkout, where given), and a datagen run repeated through them.
    Returns the kernels line's entries (less the main path's launches) and
    the routes' ms per body."""
    from fea_tpu_torch.datagen.batched import (
        chunk_inputs, chunk_keywords, chunk_tables, dispatch_plate_group, unpack_plate_group)
    from fea_tpu_torch.fem import direct_solve
    from fea_tpu_torch.fem.flatgroup import chunk_system
    from fea_tpu_torch.fem.solver import CHECK_EVERY
    from fea_tpu_torch.ops import cg

    t0 = time.perf_counter()
    chunk = chunk_payloads(device, banded=True)
    s0 = chunk[0][0]
    P, C = len(chunk), len(chunk[0][1])
    direct = [[direct_solve(problem).displacements[-1] for problem in problems]
              for _, problems in chunk]
    solvers, host, m_real, band_hb = chunk_inputs(chunk)
    kw = chunk_keywords(solvers, band_hb)
    tables, m_real_p = chunk_tables(solvers, host, m_real, device)
    system = chunk_system(*tables, m_real_p=m_real_p, n_coarse=kw["n_coarse"], band_hb=band_hb)
    st, A = chunk_state(system, P, kw["tol"], kw["max_iters"], CG_STATE_BODIES)
    pre = system.precondition
    plans = {"cg_alpha": "one cluster of %d blocks of %d nodes a segment" % cg.alpha_plan(st.Ns),
             "cg_update_xr": "%d blocks of %d nodes a segment" % cg.update_xr_plan(st.Ns),
             "jacobi_restrict": restrict_plan_text(C, st.x.shape[1] // 2, pre.members.shape[0]),
             "prolong_dots": "one cluster of %d blocks of %d nodes a segment"
                             % cg.prolong_plan(st.Ns),
             "cg_update_p": "%d blocks of %d nodes a segment" % cg.update_p_plan(st.Ns)}
    log(f"phase 16: phase 9's chunk, {P} plates x {C} conditions, band hb {s0.band_hb}, "
        f"{st.x.shape[1]} dofs a lane, member table {tuple(system.precondition.members.shape)}, "
        f"{cg.vector_width(st.Ns, st.x.dtype)} values a load; "
        + "; ".join(f"{name}: {plan}" for name, plan in plans.items())
        + f"; set-up {time.perf_counter() - t0:.1f} s")
    earlier_cg = None if earlier is None else earlier_module(earlier, "cg")

    # (a) each launch against its plain version (and the redesigned ones
    # against the earlier checkout's), then timed beside it
    entries, bad = {}, []
    for name, (run, kernel, plain, (nbytes, ops)) in cg_launches(st, A, system.precondition).items():
        mine, theirs = st.clone(), st.clone()
        got = run(mine, kernel)
        err, rel = launch_error(got, run(theirs, plain))
        if rel > CG_KERNEL_REL:
            bad.append(name)
        a, b = st.clone(), st.clone()
        c = None if earlier_cg is None else earlier_state(st, earlier_cg)
        fns = {"kernel": lambda: run(a, kernel), "plain": lambda: run(b, plain)}
        against = ""
        if earlier_cg is not None and name in EARLIER_EQUAL:
            other = getattr(earlier_cg, name)
            theirs = run(earlier_state(st, earlier_cg), other)
            differ = [f for f in EARLIER_EQUAL[name] if not torch.equal(theirs[f], got[f])]
            if differ:
                bad.append(f"{name}: {differ} not the earlier kernel's")
            against = f"its {', '.join(EARLIER_EQUAL[name])} bit for bit this kernel's"
            if name == "cg_alpha":
                against += (f", alpha {max_abs_err(theirs['alpha'], got['alpha']):.3e} from this "
                            f"kernel's (pAp summed in another order)")
            fns["earlier"] = lambda: run(c, other)
        torch.cuda.synchronize()
        ms = in_turns(fns, 50)
        bound, bound_by = bound_ms(nbytes, ops, F32_FLOPS)
        entries[name] = {"name": name, "route": "cuda", "source": CG_SOURCE,
                         "replaces": CG_REPLACES[name], "max_abs_err": err, "rel_err": rel,
                         "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound,
                         "bound_by": bound_by, "library_ms": None}
        if name in REDESIGNED:
            entries[name]["redesigned"] = REDESIGNED[name]
        line = (f"phase 16: {name}: max abs err vs plain {err:.3e} ({rel:.3e} of the span, "
                f"tolerance {CG_KERNEL_REL}); kernel {ms['kernel']:.4f} ms, plain "
                f"{ms['plain']:.4f} ms, bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.3f} MB)")
        if name in plans:
            line += (f"; {nbytes / ms['kernel'] / 1e9:.3f} TB/s over the bytes it reads and "
                     f"writes (each once: the bound's); {plans[name]}")
        if "earlier" in ms:
            entries[name]["earlier_ms"] = ms["earlier"]
            line += f"; earlier {ms['earlier']:.4f} ms, {against}"
        log(line)
    if bad:
        raise AssertionError(f"phase 16: kernels off their plain versions: {bad}")
    entries["band_matvec"] = band_operator_entry(
        system, tables, m_real_p, band_hb, st.p,
        None if earlier is None else earlier_band(earlier))
    coarse_product_time(system.precondition, st.r)
    launch_floor()
    del st, a, b, c, mine, theirs

    # (b) a body through the plain versions, the kernels and the kernels in a
    # graph, each route's whole chunk solve in turns
    routes = ("plain", "kernels", "graph")
    for name in routes:  # warm-up
        with cg_route(name):
            dispatch_plate_group(chunk).result()
    runs = {name: [] for name in routes}
    first = {}
    for name in routes + routes[::-1] + routes:
        info = {}
        with cg_route(name):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = dispatch_plate_group(chunk, info=info).result()
            info["wall"] = time.perf_counter() - t1
        info["bodies"] = CHECK_EVERY * (info["host_reads"] - s0.restarts)
        info["same"] = torch.equal(rows, first.setdefault(name, rows))
        runs[name].append(info)
    solved = {name: unpack_plate_group(first[name].cpu().numpy(), chunk) for name in routes}
    per_body = {}
    for name in routes:
        with cg_route(name):
            per_body[name] = variant_kernels(device, chunk, {})

    def spread(v):
        v = sorted(v)
        return f"{v[len(v) // 2]:.4f} [{v[0]:.4f}, {v[-1]:.4f}]"

    failures, ms_body = [], {}
    for name in routes:
        worst, converged = 0.0, 0
        for p, plate in enumerate(solved[name]):
            for c, r in enumerate(plate):
                if r.success:
                    converged += 1
                    want = direct[p][c]
                    scale = max(float(np.abs(want).max()), 1e-30)
                    worst = max(worst, float(np.abs(r.displacements[-1] - want).max()) / scale)
        iters = [int(r.iterations) for plate in solved[name] for r in plate]
        body_ms = [run["loop_s"] * 1e3 / max(run["bodies"], 1) for run in runs[name]]
        ms_body[name] = sorted(body_ms)[len(body_ms) // 2]
        log(f"phase 16: {name}: over {len(runs[name])} runs, median [min, max]: ms per body "
            f"{spread(body_ms)}, chunk ms {spread([run['wall'] * 1e3 for run in runs[name]])}, "
            f"loop ms {spread([run['loop_s'] * 1e3 for run in runs[name]])}; "
            f"{runs[name][0]['bodies']} bodies, {runs[name][0]['host_reads']} host reads; "
            f"{per_body[name]:.1f} device kernels per body; iterations sum {sum(iters)}, max "
            f"{max(iters)}; repeats bit for bit: {all(run['same'] for run in runs[name])}; "
            f"{converged} of {P * C} lanes converged, the worst within {worst:.3e} of the host's "
            f"f64 direct solve (tolerance {CHUNK_DIRECT_REL})")
        if converged == 0 or worst > CHUNK_DIRECT_REL or not all(run["same"] for run in runs[name]):
            failures.append(name)
    for name in ("kernels", "graph"):  # the graph's bodies are the same launches
        if per_body[name] > CG_MAX_KERNELS:
            failures.append(f"{name}: {per_body[name]:.1f} kernels per body")
    # the routes lane by lane, on the lanes that end under a residual of
    # 1e-4 under both (a lane near the f32 floor moves its iteration count
    # under any change of the order of its sums)
    for name in ("plain", "kernels"):
        worst, compared = 0.0, 0
        for p, plate in enumerate(solved["graph"]):
            for c, r in enumerate(plate):
                other = solved[name][p][c]
                if max(float(r.residual_norm), float(other.residual_norm)) <= CHUNK_OPERATORS_RESIDUAL:
                    compared += 1
                    scale = max(float(np.abs(direct[p][c]).max()), 1e-30)
                    worst = max(worst, float(np.abs(
                        r.displacements[-1] - other.displacements[-1]).max()) / scale)
        log(f"phase 16: graph vs {name}: {compared} lanes under a residual of "
            f"{CHUNK_OPERATORS_RESIDUAL} in both, within {worst:.3e} of the largest displacement "
            f"(tolerance {CHUNK_OPERATORS_REL})")
        if compared == 0 or worst > CHUNK_OPERATORS_REL:
            failures.append(f"graph vs {name}")
    if not torch.equal(first["graph"], first["kernels"]):
        failures.append("graph vs kernels not bit for bit")

    # (c) blocks of 8, 16 and 32 bodies on the graph route, in turns
    blocks = {n: [] for n in CG_BLOCKS}
    for n in CG_BLOCKS + CG_BLOCKS[::-1]:
        info = {}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows = dispatch_plate_group(chunk, check_every=n, info=info).result()
        info["wall"] = time.perf_counter() - t1
        info["same"] = torch.equal(rows, first["graph"])
        blocks[n].append(info)
    for n, infos in blocks.items():
        bodies = n * (infos[0]["host_reads"] - s0.restarts)
        walls = ", ".join(f"{i['wall'] * 1e3:.1f}" for i in infos)
        body_ms = ", ".join(f"{i['loop_s'] * 1e3 / bodies:.4f}" for i in infos)
        log(f"phase 16: check_every {n}: {bodies} bodies, {infos[0]['host_reads']} host reads; "
            f"chunk ms {walls}; loop ms per body {body_ms}; the rows of blocks of {CHECK_EVERY} "
            f"bit for bit: {all(i['same'] for i in infos)}")
        if not all(i["same"] for i in infos):
            failures.append(f"check_every {n}")
    del system, tables
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"phase 16: {failures}")
    datagen_repeat(device, results, "phase 16")
    return entries, ms_body


# phase 17: the shipped convolution precision against strict f32
PRECISION_FORWARD_BATCHES = (SAMPLER_BATCH, PREDICT_BATCH)
PRECISION_FORWARD_ITERS = 3
PRECISION_STEP_ITERS = 2


def precision_turns(tag, outputs, fns, iters, diff):
    """Logs the device ms per call of each route (in turns) and each one's
    difference from "ieee" by `diff`; returns {route: diff}."""
    ms = in_turns(fns, iters)
    diffs = {name: diff(out, outputs["ieee"]) for name, out in outputs.items() if name != "ieee"}
    log(f"phase 17: {tag}: ms per call " + ", ".join(f"{n} {t:.3f}" for n, t in ms.items())
        + f" (ieee / tf32 {ms['ieee'] / ms['tf32']:.2f}x); from ieee: "
        + ", ".join(f"{n} {d}" for n, d in diffs.items()))
    return diffs


def one_bf16_pass(model):
    """A copy of `model` whose convolutions take one bf16 pass: weights and
    inputs rounded to bf16, the sums in f32 (what XLA's default precision
    runs on a TPU, fea_tpu's setting); everything else unchanged."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.data = m.weight.data.bfloat16().float()
            m.register_forward_pre_hook(lambda _, args: (args[0].bfloat16().float(), *args[1:]))
    return model


def phase_precision(device, results):
    """Phase 17: the model at the shipped convolution precision ("tf32")
    against strict f32 ("ieee"), with a bf16 route as the yardstick, a
    setting one of the packages ships. Device ms per call in turns and each
    route's difference from "ieee": the sampler's FDNUNet forward at 256
    px, batches 2 and 4 (bf16: its convolutions in one bf16 pass, fea_tpu's
    setting on a TPU; the FDNUNet has no cast route in either package, and
    under torch.autocast its memory keys stay f32 beside bf16 queries); the
    regression predict at batch 4 (bf16: the Trainer's
    compute_dtype="bfloat16" cast of the weights and image inputs);
    one f32 regression train step at batch 16 from the same weights (the
    loss, and the largest relative difference of a module's gradients, read
    as Adam's first moment; bf16: a Trainer with compute_dtype="bfloat16").
    Raises where "tf32" differs from "ieee" by more than bf16 does, or not
    at all (the flag did not reach cuDNN)."""
    from fea_tpu_torch.models import create_models, make_diffusion_model, predict
    from fea_tpu_torch.train import Trainer
    from fea_tpu_torch.train.trainer import MODULES
    from fea_tpu_torch.utils.precision import model_precision

    def at(conv, fn, *args):
        return model_precision(conv=conv)(functools.partial(fn, *args))

    checks = []
    model = make_diffusion_model(
        image_size=IMAGE, input_dim=64, num_stages=4, timesteps=1000, use_flash_attention=True,
        device=device, generator=torch.Generator(device=device).manual_seed(SEED),
    ).model.eval()
    forward = torch.no_grad()(model)
    low_forward = torch.no_grad()(one_bf16_pass(model))
    for batch in PRECISION_FORWARD_BATCHES:
        rng = np.random.default_rng(SEED + batch)
        x, cond = (torch.from_numpy(rng.normal(size=(batch, IMAGE, IMAGE, c)).astype(np.float32))
                   .to(device) for c in (2, 5))
        t = torch.from_numpy(rng.integers(0, 1000, batch).astype(np.float32)).to(device)

        def call(route, x=x, cond=cond, t=t):
            with model_precision(conv="tf32" if route == "tf32" else "ieee"):
                return (low_forward if route == "bf16" else forward)(x, cond, time=t)

        fns = {route: functools.partial(call, route) for route in ("ieee", "tf32", "bf16")}
        outputs = {n: fn() for n, fn in fns.items()}
        checks.append((f"FDNUNet forward, batch {batch}", precision_turns(
            f"FDNUNet forward at {IMAGE} px, batch {batch}", outputs, fns,
            PRECISION_FORWARD_ITERS, max_abs_err)))
        del outputs, x, cond
    del model, forward, low_forward
    torch.cuda.empty_cache()

    encoder, decoder, _ = create_models(
        input_dim=64, image_height=IMAGE, image_width=IMAGE, num_channels=2,
        num_auxiliary_condition_channels=3, num_stages=4, device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 1))
    inputs = [torch.from_numpy(a).to(device) for a in predictor_inputs(PREDICT_BATCH, IMAGE, SEED)]
    low = [copy.deepcopy(m).to(torch.bfloat16).eval() for m in (encoder, decoder)]
    low_inputs = (inputs[0].bfloat16(), inputs[1].bfloat16(), inputs[2])
    fns = {"ieee": at("ieee", predict, encoder.eval(), decoder.eval(), *inputs),
           "tf32": at("tf32", predict, encoder, decoder, *inputs),
           "bf16": at("ieee", predict, *low, *low_inputs)}
    outputs = {n: fn() for n, fn in fns.items()}
    checks.append((f"predict, batch {PREDICT_BATCH}", precision_turns(
        f"predict at {IMAGE} px, batch {PREDICT_BATCH}", outputs, fns, PRECISION_FORWARD_ITERS,
        max_abs_err)))
    del encoder, decoder, low, outputs
    torch.cuda.empty_cache()

    data = SyntheticFEADataset(TRAIN_BATCH, IMAGE, SEED)
    trainers = {}
    for name, compute in (("ieee", None), ("tf32", None), ("bf16", "bfloat16")):
        trainers[name] = Trainer(
            trainer_config(IMAGE, results / "precision" / name, compute_dtype=compute),
            dataset=data, sample_dataset=data, device=device)
        if name != "ieee":  # the same weights
            for key, module in trainers[name].modules.items():
                module.load_state_dict(trainers["ieee"].modules[key].state_dict())
    batches = {name: tr._fetch_batch(0) for name, tr in trainers.items()}
    steps = {name: at("tf32" if name == "tf32" else "ieee", tr._train_step, batches[name])
             for name, tr in trainers.items()}
    outputs = {}
    for name, tr in trainers.items():
        loss = float(steps[name]())
        outputs[name] = (loss, {k: [m.clone() for m in tr.opt_states[k].mu] for k in MODULES})

    def step_diff(got, want):
        return (abs(got[0] - want[0]),
                max(module_rel(got[1][k], want[1][k]) for k in MODULES if want[1][k]))

    step_diffs = precision_turns(
        f"one f32 regression train step at {IMAGE} px, batch {TRAIN_BATCH} (loss, largest "
        f"relative gradient difference of a module)", outputs, steps, PRECISION_STEP_ITERS,
        step_diff)
    checks.append(("train step loss", {n: d[0] for n, d in step_diffs.items()}))
    checks.append(("train step gradients", {n: d[1] for n, d in step_diffs.items()}))
    del trainers, batches, steps, outputs
    torch.cuda.empty_cache()

    for tag, diffs in checks:
        if not 0 < diffs["tf32"] <= diffs["bf16"]:
            raise AssertionError(f"phase 17: {tag}: tf32 differs from ieee by {diffs['tf32']}, "
                                 f"the bf16 route by {diffs['bf16']}")
    log("phase 17: the shipped precision (tf32) differs from strict f32 (ieee) by less than "
        "the bf16 route does, in every case, and by more than 0")


ADM_SMALL = 64
ADM_BATCH = 2
ADM_IEEE_REL = 1e-4  # one f32 forward in other orders, flash's 3xTF32 products
ADM_GROUPS, ADM_EPS = 32, 1e-5  # ADM's GroupNorm32


def phase_adm(device):
    """Phase 18: ADM at its published widths against the plain reference at
    64 px; at 256 px its launches and device ms a forward, the flash and
    GroupNorm+SiLU kernels at every shape that forward gives them against
    their plain versions, and the launches of a 25-step sample. Returns the
    kernels line's ADM entries: flash's and GroupNorm+SiLU's (launches a
    sample, the largest error at ADM's shapes), and the forward's own."""
    from fea_tpu_torch.models import adm, make_adm_diffusion_model
    from fea_tpu_torch.models.diffusion import GaussianDiffusion
    from fea_tpu_torch.models.graphed import GraphedForward
    from fea_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, route)
    from fea_tpu_torch.ops.fused_norm import group_norm_silu, group_norm_silu_reference
    from fea_tpu_torch.utils.precision import model_precision

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from portbench import harness
    from portbench.counts import adm as adm_counts
    from portbench.reference import adm as ref_adm
    from portbench.reference.fdnunet import strict_f32
    from portbench.reference.weights import make_weights

    config = harness.load_json(harness.ROOT / "configs" / "adm-256-concat.json")
    generator = torch.Generator(device=device).manual_seed(SEED + 18)
    diffusion = make_adm_diffusion_model(IMAGE, device=device, generator=generator)
    model = diffusion.model.eval()
    reference = ref_adm.build(config)
    weights = make_weights(reference, SEED + 18, device)["model"]
    model.load_state_dict(weights)
    reference["model"].load_state_dict(weights, assign=True)
    reference = reference["model"].eval()
    log(f"phase 18: ADM, {sum(p.numel() for p in model.parameters())} parameters, "
        f"every one drawn from the seed")

    def inputs(size, seed):
        rng = np.random.default_rng(seed)
        x, cond = (torch.from_numpy(rng.normal(size=(ADM_BATCH, size, size, c))
                                    .astype(np.float32)).to(device) for c in (2, 5))
        return x, cond, torch.tensor([999.0, 416.0], device=device)

    x, cond, t = inputs(ADM_SMALL, SEED)
    restore = strict_f32()
    try:
        with torch.no_grad():
            want = reference(x, cond, t)
    finally:
        restore()
    gaps = {}
    for conv in ("ieee", "tf32"):
        with torch.no_grad(), model_precision(conv=conv):
            got = model(x, cond, t)
        gaps[conv] = rel_err(got, want)
    limit = config["correct_limits"]["pred_gap"]
    log(f"phase 18: {ADM_SMALL} px, batch {ADM_BATCH}: against the plain reference (strict "
        f"f32), max abs diff over max abs: ieee {gaps['ieee']:.3e} (tolerance {ADM_IEEE_REL}), "
        f"tf32 {gaps['tf32']:.3e} (tolerance {limit}, the configuration's pred_gap)")
    if gaps["ieee"] > ADM_IEEE_REL or gaps["tf32"] > limit:
        raise AssertionError(f"ADM and its plain reference differ: {gaps}")
    del reference, want

    x, cond, t = inputs(IMAGE, SEED + 1)
    # every GroupNorm+SiLU call's (channels, H W) and flash call's (BH, Nq,
    # Nk, D), read where ADM calls the two kernels
    norm_shapes, attention_shapes = set(), []
    norm, flash = adm.group_norm_silu, adm.flash_attention

    def recording_norm(x, *args):
        norm_shapes.add((x.shape[1], x[0, 0].numel()))
        return norm(x, *args)

    def recording_flash(q, k, v, *args):
        attention_shapes.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
        return flash(q, k, v, *args)

    with mock.patch.object(adm, "group_norm_silu", recording_norm), \
            mock.patch.object(adm, "flash_attention", recording_flash):
        forward = model_precision()(torch.no_grad()(lambda: model(x, cond, t)))
        forward()  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        reset_counts()
        del attention_shapes[:]
        out = forward()
        torch.cuda.synchronize()
    launches = counts()
    modulated = modulated_launches()
    if launches != (16, 43, 0) or flash_attention.launches_wgmma or modulated != ADM_MODULATED:
        raise AssertionError(f"launches {launches}, wgmma {flash_attention.launches_wgmma}, "
                             f"modulated calls {modulated}, want (16, 43, 0), none on the "
                             f"wgmma route and {ADM_MODULATED}")
    if out.shape != (ADM_BATCH, IMAGE, IMAGE, 4) or not torch.isfinite(out).all():
        raise AssertionError(f"output {tuple(out.shape)} is not finite or not the shape")
    if attention_shapes != adm_counts.flash_shapes(config, ADM_BATCH):
        raise AssertionError(f"flash shapes {attention_shapes} are not the reference's "
                             f"{adm_counts.flash_shapes(config, ADM_BATCH)}")
    forward_ms = cuda_ms(forward, 5)
    log(f"phase 18: {IMAGE} px, batch {ADM_BATCH}: launches (flash, GroupNorm+SiLU forward, "
        f"backward) {launches} and {modulated} modulated GroupNorm+SiLU calls in one "
        f"forward, flash at head dim 64 on the mma.sync route (0 on wgmma); forward "
        f"{forward_ms:.3f} ms between CUDA events")
    calls = modulated_calls(forward)
    if len(calls) != ADM_MODULATED or modulated_copies(calls):
        raise AssertionError(f"a forward made {len(calls)} modulated calls, want "
                             f"{ADM_MODULATED}, and {modulated_copies(calls)} copies, want 0")
    adm_modulated = check_modulated("phase 18", calls)
    kernels = traced_kernels(forward)
    moments = named(kernels, "RowwiseMomentsCUDAKernel")
    log(f"phase 18: a traced forward launches {moments} PyTorch GroupNorm moments kernels "
        f"(the 16 attention blocks' norms)")
    if moments != 16:
        raise AssertionError(f"a forward launched {moments} PyTorch GroupNorm moments kernels, "
                             f"want the attention blocks' 16")
    del x, cond, out, calls

    # the kernels at the forward's own shapes, each against its plain version
    errs = {}
    for shape in sorted(set(attention_shapes)):
        if route(torch.float32, shape[3]) != "mma_sync":
            raise AssertionError(f"flash {shape} would take the {route(torch.float32, shape[3])} "
                                 f"route")
        q, k, v = qkv(shape, device, SEED)
        scale = shape[3] ** -0.5
        got = flash_attention(q, k, v, scale)
        want = flash_attention_reference(q, k, v, scale)
        torch.testing.assert_close(got, want, **F32_TOL)
        errs["flash", shape] = max_abs_err(got, want)
    for c, hw in sorted(norm_shapes):
        xg, gamma, beta, _ = gn_case(device, ADM_BATCH, hw, c, torch.float32, SEED)
        with torch.no_grad():
            got = group_norm_silu(xg, gamma, beta, ADM_GROUPS, ADM_EPS)
            want = group_norm_silu_reference(xg, gamma, beta, ADM_GROUPS, ADM_EPS)
        torch.testing.assert_close(got, want, **F32_TOL)
        errs["group_norm_silu", (ADM_BATCH, c, hw)] = max_abs_err(got, want)
    for (name, shape), err in errs.items():
        log(f"phase 18: {name} {shape} f32: max abs err vs plain {err:.3e} (tolerance {F32_TOL})")
    del q, k, v, xg, gamma, beta, got, want

    # the sampler's own loop: 25 respaced steps, each one graph replay
    rng = np.random.default_rng(SEED + 2)
    condition = torch.from_numpy(rng.normal(size=(ADM_BATCH, IMAGE, IMAGE, 5))
                                 .astype(np.float32)).to(device)
    noise = torch.from_numpy(rng.normal(size=(SAMPLER_STEPS + 1, ADM_BATCH, IMAGE, IMAGE, 2))
                             .astype(np.float32)).to(device)
    diffusion.sample(condition, 2, noise=noise[:3])  # warm-up: the capture
    torch.cuda.synchronize()
    reset_counts()
    GraphedForward.captures = GraphedForward.replays = GraphedForward.eager = 0
    steps = (GaussianDiffusion.learned_range_steps, GaussianDiffusion.final_steps)
    t0 = time.perf_counter()
    sample = diffusion.sample(condition, SAMPLER_STEPS, noise=noise)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sample_launches = counts()
    sample_modulated = modulated_launches()
    graphs = (GraphedForward.captures, GraphedForward.replays, GraphedForward.eager)
    steps = (GaussianDiffusion.learned_range_steps - steps[0],
             GaussianDiffusion.final_steps - steps[1])
    want_launches = (16 * SAMPLER_STEPS, 43 * SAMPLER_STEPS, 0)
    if (sample_launches, graphs, steps, sample_modulated) != (
            want_launches, (0, SAMPLER_STEPS, 0), (SAMPLER_STEPS - 1, 1),
            ADM_MODULATED * SAMPLER_STEPS):
        raise AssertionError(
            f"a {SAMPLER_STEPS}-step sample: launches {sample_launches}, want {want_launches}; "
            f"modulated calls {sample_modulated}, want {ADM_MODULATED * SAMPLER_STEPS}; "
            f"captures, replays, eager {graphs}, want (0, {SAMPLER_STEPS}, 0); learned-range "
            f"and final steps {steps}, want ({SAMPLER_STEPS - 1}, 1)")
    if not torch.isfinite(sample).all() or flash_attention.launches_wgmma:
        raise AssertionError("the sample is not finite, or a flash call took the wgmma route")
    log(f"phase 18: sampler batch {ADM_BATCH}, {SAMPLER_STEPS} respaced steps, one graph replay "
        f"each: launches (flash, GroupNorm+SiLU forward, backward) {sample_launches}, "
        f"modulated GroupNorm+SiLU calls {sample_modulated}; {wall * 1e3:.2f} ms on the host's "
        f"clock")
    del model, diffusion, condition, noise, sample
    torch.cuda.empty_cache()
    return (
        dict(launches_adm_sample=sample_launches[0],
             max_abs_err_adm=max(e for (n, _), e in errs.items() if n == "flash")),
        dict(launches_adm_sample=sample_launches[1],
             max_abs_err_adm=max(e for (n, _), e in errs.items() if n == "group_norm_silu")),
        {"name": "adm_forward", "route": "cuda", "source": "fea_tpu_torch/models/adm.py",
         "ms": forward_ms, "batch": ADM_BATCH, "image": IMAGE,
         "launches_flash": launches[0], "launches_group_norm_silu_fwd": launches[1]},
        dict(launches_adm_sample=sample_modulated,
             **{f"{k}_adm": v for k, v in adm_modulated.items()}),
    )


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="TREE",
                        help="also time the kernels of this checkout, as `earlier`")
    parser.add_argument("--only", metavar="PHASES",
                        help="run only these phases (comma-separated numbers, 1 to 18); "
                             "such a partial run prints no result line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from fea_tpu_torch.utils.device import cuda_device
    from fea_tpu_torch.utils.precision import DEFAULT_CONV

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default; the FEM's requirement
    device = cuda_device()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"set-up: the model's f32 convolutions at the policy's {DEFAULT_CONV} "
        f"(fea_tpu_torch/utils/precision.py) unless a check asks for ieee; matmuls with "
        f"torch.backends.cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")

    # the kernel modules (the package's `flash_attention` attribute is the
    # function, so each module by its full name)
    builds = [library_build(importlib.import_module(f"fea_tpu_torch.ops.{name}"))
              for name in KERNEL_MODULES]
    earlier = None
    if args.against:
        earlier = load_ops(args.against)
        builds += [library_build(earlier_module(earlier, name)) for name in KERNEL_MODULES
                   if (Path(args.against) / "fea_tpu_torch" / "ops" / f"{name}.py").exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source, started together
        libs = list(pool.map(lambda build: build(), builds))
    log(f"set-up: kernels built in {time.perf_counter() - t0:.1f} s")
    for lib in libs[:len(KERNEL_MODULES)]:
        log(f"  {lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log("  nvcc: " + line.strip())

    results = Path(__file__).resolve().parent / "results" / "chip_smoke"
    shutil.rmtree(results, ignore_errors=True)
    if args.only:
        chunk_ms_body = plates_per_hour = float("nan")
        synthetic_ms = {"f32": float("nan"), "bf16": float("nan")}
        try:
            for n in sorted(int(v) for v in args.only.split(",")):
                t0 = time.perf_counter()
                if n == 1:
                    phase_kernel(device, earlier)
                elif n == 2:
                    phase_sampler(device)
                elif n == 3:
                    phase_predictor(device)
                elif n == 4:
                    phase_group_norm(device, earlier)
                elif n == 5:
                    f32_ms, bf16_ms, _ = phase_regression_train(device, results)
                    synthetic_ms = {"f32": f32_ms, "bf16": bf16_ms}
                elif n == 6:
                    phase_diffusion_train(device, results)
                elif n == 7:
                    phase_store_train(device, results, synthetic_ms)
                elif n == 8:
                    phase_fem(device)
                elif n == 9:
                    chunk_ms_body = phase_chunk(device)
                elif n == 10:
                    plates_per_hour, _ = phase_datagen(device, results, chunk_ms_body)
                elif n == 11:
                    phase_inmemory_train(device, results)
                elif n == 12:
                    phase_full_attention(device, earlier)
                elif n == 13:
                    phase_cli(device, results)
                elif n == 14:
                    phase_data_parallel(device, results)
                elif n == 15:
                    phase_variants(device, results, plates_per_hour)
                elif n == 16:
                    phase_cg_loop(device, results, earlier)
                elif n == 17:
                    phase_precision(device, results)
                elif n == 18:
                    phase_adm(device)
                else:
                    raise SystemExit(f"--only takes the phases 1 to 18, not {n}")
                log(f"phase {n} done in {time.perf_counter() - t0:.1f} s")
            log(nvidia_smi())
        finally:
            shutil.rmtree(results, ignore_errors=True)
        return 0
    try:
        t0 = time.perf_counter()
        err, flash_ms = phase_kernel(device, earlier)
        log(f"phase 1 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, linear_entry, modulated_entry = phase_sampler(device)
        log(f"phase 2 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        predict_modulated = phase_predictor(device)
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
        t0 = time.perf_counter()
        _, store_fwd, store_bwd = phase_store_train(
            device, results, {"f32": f32_ms, "bf16": bf16_ms})
        log(f"phase 7 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_fem(device)
        log(f"phase 8 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        chunk_ms_body = phase_chunk(device)
        log(f"phase 9 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        plates_per_hour, cg_launches = phase_datagen(device, results, chunk_ms_body)
        log(f"phase 10 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_inmemory_train(device, results)
        log(f"phase 11 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        full_attention = phase_full_attention(device, earlier)
        log(f"phase 12 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli_fwd, cli_bwd, cli_mod, cli_checked = phase_cli(device, results)
        log(f"phase 13 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_fwd, dp_bwd, dp_mod = phase_data_parallel(device, results)
        log(f"phase 14 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_variants(device, results, plates_per_hour)
        log(f"phase 15 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cg_entries, _ = phase_cg_loop(device, results, earlier)
        log(f"phase 16 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_precision(device, results)
        log(f"phase 17 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        adm_flash, adm_gn, adm_entry, adm_modulated = phase_adm(device)
        log(f"phase 18 done in {time.perf_counter() - t0:.1f} s")
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
    log(nvidia_smi())
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
            "redesigned": REDESIGNED["flash_attention"], **full_attention, **adm_flash,
        },
        {
            "name": "group_norm_silu_fwd", "route": "cuda", "source": gn_source,
            "replaces": "fea_tpu/ops/fused_norm.py:115", "launches": gn_fwd,
            "launches_from_store": store_fwd, "launches_cli": cli_fwd, "launches_dp": dp_fwd,
            **gn["fwd"], **adm_gn,
            "redesigned": REDESIGNED["group_norm_silu_fwd"],
        },
        {
            "name": "group_norm_silu_bwd", "route": "cuda", "source": gn_source,
            "replaces": "fea_tpu/ops/fused_norm.py:132", "launches": gn_bwd,
            "launches_from_store": store_bwd, "launches_cli": cli_bwd, "launches_dp": dp_bwd,
            **gn["bwd"],
            "redesigned": REDESIGNED["group_norm_silu_bwd"],
        },
        linear_entry,
        {
            "name": "group_norm_modulated_silu", "route": "cuda", "source": gn_source,
            "replaces": "none: fea_tpu/models/blocks.py leaves the FDN's and the time "
                        "scale-shift's GroupNorm chain to XLA",
            **modulated_entry, **adm_modulated, **predict_modulated,
            "launches_cli": cli_mod, "launches_dp": dp_mod, "checked_cli": cli_checked,
            "design": MODULATED_DESIGN,
        },
        adm_entry,
    ] + [dict(entry, launches=cg_launches[name]) for name, entry in cg_entries.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
