"""Where one full-width FDNUNet forward spends its time on a CUDA card.

    python3 tools/profile_fdnunet.py [--table PATH]

The sampler's model (input_dim 64, 4 stages, 256 px, batch 2, time
embedding, flash attention, random seeded weights), f32, at the precision
the port ships: its convolutions at the policy's default
(fea_tpu_torch/utils/precision.py: TF32), its matmuls strict f32. Two
parts:

1. Forward time under convolution settings, each 5 forwards timed after 2
   warm-ups, all in one process and in two passes, the second in reverse
   order. At the shipped precision: NHWC inputs (the port's default),
   NCHW-contiguous inputs, cudnn.benchmark on, and cuDNN off (PyTorch's
   own convolutions); and strict f32 convolutions ("ieee"). The precision
   is switched only through `model_precision`. Each variant's output is
   compared with the default's.
2. torch.profiler over one forward with the default settings: device time
   and launches per kernel name, the top rows printed, the whole table
   written to PATH when given.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEED = 0
BATCH = 2
IMAGE = 256
WARMUP, TIMED = 2, 5


def log(*args):
    print(*args, flush=True)


def settings(name):
    """(cudnn.enabled, cudnn.benchmark, convolution precision (None: the
    policy's default), nchw input)"""
    return {
        "nhwc": (True, False, None, False),
        "nchw": (True, False, None, True),
        "cudnn_benchmark": (True, True, None, False),
        "cudnn_off": (False, False, None, False),
        "ieee": (True, False, "ieee", False),
    }[name]


def forward_ms(model, x, cond, t, name):
    from fea_tpu_torch.utils.precision import model_precision

    enabled, benchmark, conv, nchw = settings(name)
    if nchw:  # the same values, NCHW-contiguous underneath the NHWC view
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        cond = cond.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    cudnn = torch.backends.cudnn
    saved = cudnn.enabled, cudnn.benchmark
    cudnn.enabled, cudnn.benchmark = enabled, benchmark
    try:
        with torch.no_grad(), model_precision(conv=conv):
            for _ in range(WARMUP):
                out = model(x, cond, time=t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED):
                out = model(x, cond, time=t)
            torch.cuda.synchronize()
    finally:
        cudnn.enabled, cudnn.benchmark = saved
    return (time.perf_counter() - t0) * 1e3 / TIMED, out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--table", type=Path, help="write the profiler's whole table here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_fdnunet: no CUDA device", file=sys.stderr)
        return 1
    from fea_tpu_torch.models import make_diffusion_model
    from fea_tpu_torch.ops.flash_attention import LIBRARY, flash_attention
    from fea_tpu_torch.utils.precision import DEFAULT_CONV, model_precision

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    device = torch.device("cuda")
    LIBRARY.build()
    model = make_diffusion_model(
        image_size=IMAGE, input_dim=64, num_stages=4, timesteps=1000,
        use_flash_attention=True, device=device,
        generator=torch.Generator(device=device).manual_seed(SEED),
    ).model.eval()
    rng = np.random.default_rng(SEED)
    x, cond = (
        torch.from_numpy(rng.normal(size=(BATCH, IMAGE, IMAGE, c)).astype(np.float32)).to(device)
        for c in (2, 5)
    )
    t = torch.full((BATCH,), 999.0, device=device)

    names = ["nhwc", "nchw", "cudnn_benchmark", "cudnn_off", "ieee"]
    log(f"convolutions at {DEFAULT_CONV} (the policy's default) except in ieee")
    times = {name: [] for name in names}
    outputs = {}
    for order in (names, names[::-1]):
        for name in order:
            ms, outputs[name] = forward_ms(model, x, cond, t, name)
            times[name].append(ms)
    for name in names:
        diff = float((outputs[name] - outputs["nhwc"]).abs().max())
        log(
            f"forward {name}: {times[name][0]:.3f} / {times[name][1]:.3f} ms "
            f"(pass 1 / pass 2); max abs diff vs nhwc {diff:.3e}"
        )

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), model_precision():
        model(x, cond, time=t)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x, cond, time=t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, memcpy, memset), not the host ops
    # whose totals include them
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0
    ]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    if not kernels:
        log("profiled forward: the profiler recorded no device time")
        return 1
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    log(
        f"profiled forward, convolutions at {DEFAULT_CONV}: {sum(e.count for e in kernels)} "
        f"kernel launches, {device_ms:.3f} ms of device time, {wall_ms:.3f} ms wall under the "
        f"profiler; flash launches {flash_attention.launches - launches}"
    )
    for e in kernels[:12]:
        log(
            f"  {e.device_time_total / 1e3:9.3f} ms {100 * e.device_time_total / 1e3 / device_ms:5.1f}% "
            f"{e.count:6d} x {e.device_time_total / e.count:8.2f} us  {e.key[:110]}"
        )
    if args.table:
        args.table.parent.mkdir(parents=True, exist_ok=True)
        args.table.write_text(
            prof.key_averages().table(sort_by="device_time_total", row_limit=200, max_name_column_width=160)
        )
        log(f"profiler table: {args.table}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
