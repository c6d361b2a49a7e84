"""Device-resident condition store: batches assembled on the card from indices.

The port of fea_tpu/data/device_store.py. The store's packed uint8/int8
tables are uploaded once (the {0,1} geometry and constraint masks ride
bit-packed, 8 px per byte, and are unpacked on the device with a shift
and a mask per batch), and each batch is assembled on the device from
three small int32 index vectors, so a training step sends ~100 bytes to
the card instead of the decoded batch. `estimate_table_bytes` gives the
size of the tables for a store (7 bytes per pixel per condition less the
bit-packing, plus the scalar tables).

Assembly reproduces `StoredFEADataset.__getitem__` bit for bit:

* masks decode as `2*u8 - 1` (to_signed of exact {0,1} masks),
* displacement as `2*(1 - k/255) - 1` (same f32 operation order),
* per-step force log-norms and range decompositions are precomputed on
  the HOST in the same f64-then-f32 pipeline the store uses (the store
  computes them per sample; per (condition, step) they are a tiny
  table, (P*C, steps, R+1, 2)), so the device does pure gathers.

Everything here is a plain function on tensors with an explicit device.
"""

from typing import Dict, Union

import numpy as np
import torch

from .store import StoredFEADataset

# Device memory kept free of tables for the train step itself: the f32
# batch-16 regression step at 256 px peaked at 40.31 GB on an H100
# (PERF.md, section 5), rounded up for the allocator's slack.
TRAIN_STEP_RESERVE_BYTES = 48 * 1024**3


def default_table_byte_cap(device: Union[str, torch.device]) -> int:
    """The card's total memory less the train step's reserve. Tables on a
    CPU device are host arrays, which no device budget bounds."""
    device = torch.device(device)
    if device.type != "cuda":
        return np.iinfo(np.int64).max
    total = torch.cuda.get_device_properties(device).total_memory
    return max(0, total - TRAIN_STEP_RESERVE_BYTES)


def estimate_table_bytes(ds: StoredFEADataset) -> int:
    n_steps = ds.num_steps
    fnorm = ds.force_vals.shape[0] * n_steps * (ds.force_vals.shape[1] + 1) * 2 * 4
    ranges = ds.ranges.shape[0] * n_steps * 4 * 4 * 3
    # {0,1} masks ride bitpacked (8 px/byte) when the row length allows
    mask_div = 8 if ds.image_size % 8 == 0 else 1
    return int(
        ds.geometry.nbytes // mask_div
        + ds.constraints.nbytes // mask_div
        + ds.displacement.nbytes
        + ds.force_winner.nbytes
        + ds.mat_winner.nbytes
        + ds.mat_norm.nbytes
        + fnorm
        + ranges
    )


def _unpack_mask_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., S//8) uint8 -> (..., S) uint8 of {0,1}, np.packbits order.

    np.packbits is bitorder='big': element j of each 8-group lands in bit
    7-j, so shifting by [7..0] restores element order. The shift runs in
    int16 (not every torch version shifts uint8).
    """
    shifts = torch.arange(7, -1, -1, dtype=torch.int16, device=packed.device)
    bits = (packed.to(torch.int16)[..., None] >> shifts) & 1
    return bits.to(torch.uint8).reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def build_device_tables(
    ds: StoredFEADataset, device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """Precompute host-side scalar tables and upload everything once."""
    nc, r, _ = ds.force_vals.shape
    assert r + 1 <= 127 and ds.mat_norm.shape[1] <= 127, (
        "winner+1 must fit int8"
    )
    n_steps = ds.num_steps
    # Per-(condition, step) force log-norms, f64 scalar pipeline then f32
    # cast — the exact math of store.py __getitem__ (which mirrors the
    # reference's Python-float pipeline, diffusion.py:246-266).
    v = ds.force_vals[:, None, :, :]  # (NC, 1, R, 2) f64
    steps = np.arange(1, n_steps + 1, dtype=np.float64)[None, :, None, None]
    norm = np.sign(v) * np.log(np.abs(v) * (steps - 1) / n_steps + 1.0)
    fnorm = np.zeros((nc, n_steps, r + 1, 2), np.float32)
    fnorm[:, :, 1:, :] = norm
    rng = ds.ranges[:, :n_steps].astype(np.float32)  # (NC, steps, 4)

    host_tables = {
        "displacement": np.asarray(ds.displacement),  # (NC, S, S, 2) uint8
        # winner+1 so slot 0 is "no region" (value 0.0 in the norm
        # tables); stays int8 — winners are -1..R-1 with R <= 96, so +1
        # fits and the two large tables don't double to int16
        "force_winner": np.asarray(ds.force_winner) + np.int8(1),
        "mat_winner": np.asarray(ds.mat_winner) + np.int8(1),
        "fnorm": fnorm,
        "mat_norm": ds.mat_norm,  # (NC, R+1, 2) f32, slot 0 = 0
        "ranges": rng,
        "log_ranges": np.log1p(np.abs(rng)).astype(np.float32),
        "sign_ranges": (rng >= 0).astype(np.float32),
    }
    geometry = np.asarray(ds.geometry)  # (P, S, S) uint8 of {0,1}
    constraints = np.asarray(ds.constraints)  # (NC, S, S) uint8 of {0,1}
    if ds.image_size % 8 == 0:
        # bitpack the binary masks 8 px/byte (the masks are exact {0,1} by
        # the store's _binarize contract). packbits treats any nonzero as
        # 1, so the round-trip is exact for {0,1} input.
        host_tables["geometry_bits"] = np.packbits(geometry, axis=-1)
        host_tables["constraints_bits"] = np.packbits(constraints, axis=-1)
    else:
        host_tables["geometry"] = geometry
        host_tables["constraints"] = constraints
    device = torch.device(device)
    # torch wraps writable arrays only: the store's read-only memmaps are
    # read into memory first
    return {
        k: torch.from_numpy(v if v.flags.writeable else np.array(v)).to(device)
        for k, v in host_tables.items()
    }


def index_arrays(
    ds: StoredFEADataset, indices: np.ndarray
) -> Dict[str, np.ndarray]:
    """Host side: sample indices -> (plate row, condition row, step-1)."""
    indices = np.asarray(indices, np.int64)
    plate_row = indices // ds.samples_per_plate
    rem = indices % ds.samples_per_plate
    cond_row = plate_row * ds.C + rem // ds.num_steps
    step0 = rem % ds.num_steps  # 0-based; sample step = step0 + 1
    return {
        "pi": plate_row.astype(np.int32),
        "ci": cond_row.astype(np.int32),
        "si": step0.astype(np.int32),
        # sample metadata (kept for parity with dataset samples)
        "plate_index": (plate_row + ds.start_plate_index).astype(np.int32),
        "condition_index": (rem // ds.num_steps + 1).astype(np.int32),
        "iteration_index": (step0 + 1).astype(np.int32),
    }


def _gather_rows(table: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """out[b, i, j] = table[b, winner[b, i, j]]: each row's own lookup.
    `torch.gather` wants int64 indices; the widened copy is per batch, the
    resident int8 tables stay as they are."""
    b = winner.shape[0]
    flat = winner.reshape(b, -1).to(torch.int64)
    return torch.gather(table, 1, flat).reshape(winner.shape)


def assemble_batch(
    tables: Dict[str, torch.Tensor], idx: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Assemble one (micro-)batch on the tables' device from index vectors
    on that device.

    Output matches `StoredFEADataset.__getitem__` leaves bit for bit
    (asserted by tests/test_torch_store.py and, on the card, by
    chip_smoke.py), as float32 NHWC.
    """
    pi, ci, si = idx["pi"], idx["ci"], idx["si"]

    def signed(u8):
        return u8.to(torch.float32) * 2.0 - 1.0

    if "geometry_bits" in tables:
        g = _unpack_mask_bits(tables["geometry_bits"][pi])  # (B, S, S)
        c = _unpack_mask_bits(tables["constraints_bits"][ci])
    else:
        g = tables["geometry"][pi]  # (B, S, S) uint8
        c = tables["constraints"][ci]
    k = tables["displacement"][ci].to(torch.float32)  # (B, S, S, 2)
    # A true IEEE division: by a Python scalar, CUDA's division multiplies
    # by the reciprocal instead, which can be one ulp off; by a tensor on
    # the device it divides.
    k = k / torch.full((), 255.0, dtype=torch.float32, device=k.device)

    fn = tables["fnorm"][ci, si]  # (B, R+1, 2) f32
    fw = tables["force_winner"][ci]  # (B, S, S, 2) int8
    forces = torch.stack(
        [_gather_rows(fn[:, :, a], fw[:, :, :, a]) for a in range(2)], dim=-1
    )
    mn = tables["mat_norm"][ci]  # (B, R+1, 2)
    mw = tables["mat_winner"][ci]
    materials = torch.stack(
        [_gather_rows(mn[:, :, a], mw[:, :, :, a]) for a in range(2)], dim=-1
    )

    return {
        "plate_index": idx["plate_index"],
        "condition_index": idx["condition_index"],
        "iteration_index": idx["iteration_index"],
        "geometry": signed(g)[..., None],
        "displacement": (1.0 - k) * 2.0 - 1.0,
        "constraints": signed(c)[..., None],
        "forces": forces,
        "materials": materials,
        "displacement_range": tables["ranges"][ci, si],
        "log_displacement_range": tables["log_ranges"][ci, si],
        "sign_displacement_range": tables["sign_ranges"][ci, si],
    }
