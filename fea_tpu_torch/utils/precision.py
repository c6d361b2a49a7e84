"""Precision policy of the port's model: the precision of its f32
convolutions on the card, chosen here and nowhere else.

The model's convolutions (`models/blocks.py` conv3x3 and conv1x1) run
through cuDNN, whose f32 convolutions run in one of two precisions:
"tf32" (the operands rounded to TF32's 10-bit mantissa on the tensor
cores, the sums in f32) or "ieee" (f32 throughout). The port ships
DEFAULT_CONV = "tf32":
  * it is PyTorch's own default on CUDA, so it is what the reference, a
    PyTorch program, ran;
  * it is finer than the one bf16 pass that fea_tpu's convolutions take on
    a TPU at XLA's default precision, where fea_tpu's accepted numbers come
    from. The `gpu` test of tests/test_torch_precision.py holds the TF32
    forward to the strict one within the bf16 settings' difference.

Every model entry point runs all of its model work, forward and backward,
inside `model_precision()`: `GaussianDiffusion.sample`, `predict`, the
Trainer's `_train_step` and `sample_and_save`, the DiffusionTrainer's
`_train_step` and `sample`, and `apps.runner.predict_with_surrogate`. An
explicit `model_precision(conv="ieee")` (or "tf32") around any of them
wins over the default that they ask for, all the way down; the request is
kept in a context variable.

cuDNN's flag is process-wide, not thread-local. Autograd runs a CUDA
backward on a device thread of its own, which reads the same global, so a
scope around a forward alone would leave the backward's convolutions at
whatever the flag holds when `backward()` runs: a train step is scoped
whole. The datagen solve worker runs no convolution, so a scope on the
main thread changes no solve.

The flag is `torch.backends.cudnn.conv.fp32_precision`, and only that one:
once it is set, reading the legacy `torch.backends.cudnn.allow_tf32`
raises, since the two APIs do not mirror each other. This module never
touches `torch.backends.cuda.matmul`: the model's matmuls (the Dense
layers, the non-flash attention einsums) stay strict f32, PyTorch's
default, and the FEM refuses TF32 matmuls (`fem/problem.py`
`_require_true_f32`) in the same process.
"""

import contextvars
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

DEFAULT_CONV = "tf32"
CONV_PRECISIONS = ("ieee", "tf32")

_requested: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "fea_tpu_torch_conv_precision", default=None
)


def conv_precision() -> str:
    """The f32 convolution precision that model work started now runs at:
    the innermost `model_precision` scope's, else DEFAULT_CONV."""
    return _requested.get() or DEFAULT_CONV


@contextmanager
def model_precision(conv: Optional[str] = None) -> Iterator[str]:
    """Run the block (or, as a decorator, each call) with cuDNN's f32
    convolutions at `conv` ("ieee" or "tf32"); None keeps an enclosing
    scope's choice, else DEFAULT_CONV. Yields the precision chosen and
    restores the caller's flag on the way out, also on an exception."""
    if conv is not None and conv not in CONV_PRECISIONS:
        raise ValueError(f"conv precision {conv!r} is not one of {CONV_PRECISIONS}")
    chosen = conv or conv_precision()
    flags = torch.backends.cudnn.conv
    saved = flags.fp32_precision
    flags.fp32_precision = chosen
    token = _requested.set(chosen)
    try:
        yield chosen
    finally:
        _requested.reset(token)
        flags.fp32_precision = saved
