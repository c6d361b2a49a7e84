"""roofline_pct.linear.dit

The linear layers' share of their roofline: the operations of the traced
window's linears (fact "linear_flops", portbench/counts/dit.py: 144 a
DiT-XL forward) at the card's dense TF32 peak, over the device time of
cuBLAS's and CUTLASS's matmul kernels by name in the traced window of the
device alone (on an H100 with torch 2.11+cu128: cuBLAS's
`sm90_xmma_gemm_f32f32_tf32f32_*` tiles, CUTLASS's `s1688gemm` and
cuBLASLt's `splitKreduce_kernel`). cuDNN's convolutions (`implicit_gemm`,
`fprop`) and the flash kernel are not counted.
"""

from portbench.counts import kernels

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "denoise_step_ms"
NAMES = ("gemm", "gemv", "nvjet", "cutlass", "splitkreduce")
EXCLUDED = ("implicit_gemm", "flash_fwd_kernel", "fprop", "dgrad", "wgrad")


def is_matmul(name: str) -> bool:
    lowered = name.lower()
    return any(n in lowered for n in NAMES) and not any(n in lowered for n in EXCLUDED)


def read(outcome):
    if outcome.trace is None or not outcome.facts.get("linear_flops"):
        return None
    seconds, _ = outcome.trace.seconds_by_kernel(is_matmul)
    if seconds <= 0:
        return None
    return 100.0 * outcome.facts["linear_flops"] / kernels.TF32_FLOPS / seconds
