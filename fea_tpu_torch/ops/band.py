"""The flat chunk's stiffness operator over the band's non-zeros as a
hand-written CUDA kernel (`csrc/band_matvec.cu`), with its plain PyTorch
version.

fea_tpu applies K as a dense block-shifted band, one batched product a CG
iteration (fea_tpu/fem/banded.py:161 `banded_matvec`). On the card the
chunk's operator reads only K's non-zeros, compacted once per solve by
`fem.banded.band_tables`: y = vals (C, n_slices, slots, 32) times u (C,
n_dofs) over the shared planar columns cols (n_slices, slots, 32), the free
masks folded into the values; the kernel reads each slice up to its widest
row, from the tables' width table widths (n_slices,).

`band_matvec` launches the kernel for CUDA tensors and raises on what the
kernel does not take (a dtype other than float32 / float64, another device,
a non-contiguous tensor, shapes that disagree, tables that do not start on
a 16-byte boundary, rows too wide for a block's shared memory); it takes
its plain version (`band_matvec_reference`, torch gathers and a sum) only
where the tensors lie on the CPU. Every launch adds one to
`band_matvec.launches`; a launch recorded in a CUDA graph (`ops.cg.capture`)
counts at each replay of it.
"""

import ctypes
import functools
from pathlib import Path

import torch

from ..fem.banded import ELL_ROWS, band_matvec_reference
from . import cg, graphs
from ._build import build_library

# a block of the kernel: SLICES slices of ELL_ROWS rows for LANES lanes,
# staged in shared memory up to MAX_SHARED bytes (csrc/band_matvec.cu)
SLICES, LANES = 4, 4
MAX_SHARED = 200 * 1024


def shared_bytes(slots: int, dtype) -> int:
    """Shared memory a block of the kernel takes at `slots` slots a row:
    its slices' columns and its lanes' values."""
    return SLICES * slots * ELL_ROWS * (LANES * (torch.finfo(dtype).bits // 8) + 4)


def build() -> Path:
    """Compile the kernel's library (at first use); its path."""
    return build_library("fea_band_matvec", ["band_matvec.cu"])


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fea_band_matvec.argtypes = [i, p, p, p, p, p, i, i, i, p]
    lib.fea_band_matvec.restype = i
    lib.fea_band_load.argtypes = []
    lib.fea_band_load.restype = i
    lib.fea_cuda_error_string.argtypes = [i]
    lib.fea_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"band kernel {what} failed: " + _library().fea_cuda_error_string(err).decode())


@functools.cache
def load(index: int):
    """Build the library and load the kernel into device `index`'s context
    (before a capture: a kernel that loaded lazily at its first launch
    would load while the graph is recorded)."""
    lib = _library()
    with torch.cuda.device(index):
        _raise_on(lib.fea_band_load(), "loading")
    return lib


def band_matvec(vals, cols, u, y, widths):
    """y = the compacted band times u (see `band_matvec_reference`), into
    y (C, n_dofs) in place; vals, cols and widths are `band_tables`'
    three tables (the plain version reads no width table)."""
    if all(t.device.type == "cpu" for t in (vals, cols, widths, u, y)):
        return band_matvec_reference(vals, cols, u, y)
    device, dtype = u.device, u.dtype
    C, n_dofs = u.shape
    slots = cols.shape[1]
    n_slices = -(-n_dofs // ELL_ROWS)
    cg._check(device, dtype, {
        "vals": (vals, None, (C, n_slices, slots, ELL_ROWS)),
        "cols": (cols, torch.int32, (n_slices, slots, ELL_ROWS)),
        "widths": (widths, torch.int32, (n_slices,)),
        "u": (u, None, (C, n_dofs)), "y": (y, None, (C, n_dofs))})
    cg._check_aligned("band_matvec", {"vals": vals, "cols": cols})
    if shared_bytes(slots, dtype) > MAX_SHARED:
        raise ValueError(f"band_matvec: rows of {slots} slots take {shared_bytes(slots, dtype)} "
                         f"bytes of a block's shared memory, over its {MAX_SHARED}")
    lib = load(device.index or 0)
    with torch.cuda.device(device):
        err = lib.fea_band_matvec(int(dtype == torch.float64), vals.data_ptr(), cols.data_ptr(),
                                  widths.data_ptr(), u.data_ptr(), y.data_ptr(), C, n_dofs, slots,
                                  torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "launch")
    graphs.count(band_matvec)


band_matvec.launches = 0
