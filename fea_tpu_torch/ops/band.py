"""The flat chunk's stiffness operator over the band's non-zeros as a
hand-written CUDA kernel (`csrc/band_matvec.cu`), with its plain PyTorch
version.

fea_tpu applies K as a dense block-shifted band, one batched product a CG
iteration (fea_tpu/fem/banded.py:161 `banded_matvec`). On the card the
chunk's operator reads only K's non-zeros, compacted once per solve by
`fem.banded.band_tables` into the sliced-ELL layout this module owns: y =
vals (C, n_slices, slots, ELL_ROWS) times u (C, n_dofs) over the shared
planar columns cols (n_slices, slots, ELL_ROWS), the free masks folded into
the values; the kernel reads each slice up to its widest row, from the
tables' width table widths (n_slices,).

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

import torch

from . import graphs
from ._build import bind, check_aligned, check_tensors

DTYPES = (torch.float32, torch.float64)
# Rows of a slice of the compacted band: the rows a warp of the kernel
# (csrc/band_matvec.cu) walks together, one thread a row.
ELL_ROWS = 32
# a block of the kernel: SLICES slices of ELL_ROWS rows for LANES lanes,
# staged in shared memory up to MAX_SHARED bytes (csrc/band_matvec.cu)
SLICES, LANES = 4, 4
MAX_SHARED = 200 * 1024

_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = bind("fea_band_matvec", ["band_matvec.cu"], {
    "fea_band_matvec": ([_i, _p, _p, _p, _p, _p, _i, _i, _i, _p], _i),
}, load_symbol="fea_band_load")


def shared_bytes(slots: int, dtype) -> int:
    """Shared memory a block of the kernel takes at `slots` slots a row:
    its slices' columns and its lanes' values."""
    return SLICES * slots * ELL_ROWS * (LANES * (torch.finfo(dtype).bits // 8) + 4)


def band_matvec_reference(vals, cols, u, y, widths=None):
    """y = the compacted band (`fem.banded.band_tables`) times u, on planar
    (C, n_dofs) vectors: the plain version of `band_matvec`, with its
    arguments, as torch gathers and a sum over every slot (the width
    table, where given, is not read). A pad's column -1 reads the zero
    appended to u."""
    C, n_dofs = u.shape
    padded = torch.cat([u, u.new_zeros((C, 1))], dim=-1)
    rows = (vals * padded[:, cols]).sum(dim=-2)  # (C, n_slices, ELL_ROWS)
    y.copy_(rows.reshape(C, -1)[:, :n_dofs])


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
    check_tensors("band_matvec", device, dtype, DTYPES, {
        "vals": (vals, None, (C, n_slices, slots, ELL_ROWS)),
        "cols": (cols, torch.int32, (n_slices, slots, ELL_ROWS)),
        "widths": (widths, torch.int32, (n_slices,)),
        "u": (u, None, (C, n_dofs)), "y": (y, None, (C, n_dofs))})
    check_aligned("band_matvec", {"vals": vals, "cols": cols})
    if shared_bytes(slots, dtype) > MAX_SHARED:
        raise ValueError(f"band_matvec: rows of {slots} slots take {shared_bytes(slots, dtype)} "
                         f"bytes of a block's shared memory, over its {MAX_SHARED}")
    lib = LIBRARY.loaded(device.index or 0)
    with torch.cuda.device(device):
        err = lib.fea_band_matvec(int(dtype == torch.float64), vals.data_ptr(), cols.data_ptr(),
                                  widths.data_ptr(), u.data_ptr(), y.data_ptr(), C, n_dofs, slots,
                                  torch.cuda.current_stream(device).cuda_stream)
    LIBRARY.check(err, "band_matvec launch")
    graphs.count(band_matvec)


band_matvec.launches = 0
