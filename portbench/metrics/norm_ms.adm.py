"""norm_ms.adm

Device ms a denoising step in the GroupNorm kernels, by kernel name, in
the traced window of the device alone: PyTorch's GroupNorm (its moments,
fused-parameter and apply kernels: the out-layers' norm under the time
scale-shift and the attention blocks' norm) and the port's fused
GroupNorm+SiLU forward (`fwd_cluster`, or `fwd_stats` and `fwd_apply`:
the in-layers and the output), over the window's forwards (one a step).
"""

LAYER = "Blocks"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "denoise_step_ms"
NAMES = ("RowwiseMomentsCUDAKernel", "ComputeFusedParamsCUDAKernel", "GroupNormKernelImpl",
         "fwd_cluster", "fwd_stats", "fwd_apply")


def read(outcome):
    if outcome.trace is None or not outcome.facts.get("forwards"):
        return None
    seconds, _ = outcome.trace.seconds_by_kernel(lambda name: any(n in name for n in NAMES))
    if seconds <= 0:
        return None
    return 1e3 * seconds / outcome.facts["forwards"]
