"""Decoded-on-disk condition store: production-scale training feed.

The port's own copy of fea_tpu/data/store.py (NumPy and PIL, no JAX and no
torch), kept so that fea_tpu_torch imports nothing of fea_tpu. The files
on disk have the same names, shapes and dtypes: a store written by one
package is read by the other, and tests hold the two packages to
byte-identical files and the two datasets to bit-identical samples.

The PNG-folder dataset (`FEADataset`) pays ~8 PIL decode+resize calls per
sample; at production scale (>=50k samples) the in-RAM cache cannot hold
the decoded set, so every epoch re-decodes (reference counterpart: the
num_workers=0 DataLoader of model/diffusion.py:514-527, which re-decodes
PNGs per item the same way).

This module exploits two structural facts of the data contract
(model/diffusion.py:105-380):

1. Samples (plate, condition, step) share everything except scalars:
   masks, the materials image and the displacement target come from the
   same PNGs for every step; only the force log-scaling
   ``sign(v)*ln(1+|v|*(step-1)/num_steps)`` and the per-step ranges
   differ. So the store is keyed by *condition*, ~20x smaller than
   per-sample storage.

2. `_load_gray` resizes the uint8 PIL image BEFORE converting to float,
   so every mask produced by `_mask01`/`_binarize` is exactly binary
   and the displacement/geometry grids are exact functions of a uint8
   array. A condition is therefore reconstructible BIT-EXACTLY from:

   - ``geometry``     (P, S, S)      uint8   binarized plate mask
   - ``constraints``  (P*C, S, S)    uint8   binarized constraint union
   - ``displacement`` (P*C, S, S, 2) uint8   resized PNG gray k; field
                                             decodes as 2*(1-k/255)-1
   - ``force_winner`` (P*C, S, S, 2) int8    per-axis index of the
                                             overlay-winning force
                                             region (-1: none)
   - ``mat_winner``   (P*C, S, S, 2) int8    same for materials
   - scalar side table (scalars.npz): per-region force values, material
     (E, nu), per-step ranges.

   The where-overlay (diffusion.py:219-295) resolves per pixel per axis
   to "last region in Edge->Vertex file order with mask=1 and value!=0",
   which is step-independent for the log scaling — so the winner maps
   are computed once at build time and runtime work is two `np.take`s.

Total: 7*S*S bytes per condition plus S*S per plate (~460 KB per
condition at 256 px), against ~2 MB per decoded sample on the PNG path.

Limitations: the min-max scaling modes (min_max_magnitude /
min_max_youngs_modulus) can zero a norm that the log scaling keeps
nonzero (|v| == min), which would change the overlay winner; the store
therefore only serves the default log-scaling contract and
`StoredFEADataset` refuses min-max options.
"""

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .dataset import (
    _binarize,
    _load_gray,
    _mask01,
    _parse_kv_file,
    to_signed,
)

# Padded per-condition region table width (int8 winner ids). Edge forces
# create one region per sampled boundary edge, so counts of 30+ occur in
# production (a 28-force-region condition appeared within the first 1000
# plates); the scalar table is tiny, so pad generously.
_MAX_REGIONS = 96


def _store_paths(store_dir: Path) -> Dict[str, Path]:
    return {
        "geometry": store_dir / "geometry.npy",
        "constraints": store_dir / "constraints.npy",
        "displacement": store_dir / "displacement.npy",
        "force_winner": store_dir / "force_winner.npy",
        "mat_winner": store_dir / "mat_winner.npy",
        "done": store_dir / "done.npy",
        "scalars": store_dir / "scalars.npz",
        "meta": store_dir / "meta.json",
    }


class ConditionStoreBuilder:
    """Incremental (resumable) construction. Conditions can be added in any
    order; `done` marks completed ones so a crash or a trailing build
    behind a still-running datagen loses nothing."""

    def __init__(
        self,
        dataset_dir: str,
        store_dir: str,
        num_plates: int,
        image_size: int = 256,
        conditions_per_plate: int = 4,
        num_steps: int = 6,
        extension: str = "png",
    ):
        self.src = Path(dataset_dir)
        self.dir = Path(store_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.P = num_plates
        self.C = conditions_per_plate
        self.S = image_size
        self.num_steps = num_steps - 1  # sample steps, as FEADataset.num_steps
        self.ext = extension
        p = _store_paths(self.dir)
        n = self.P * self.C
        S = self.S
        meta = {
            "num_plates": self.P,
            "conditions_per_plate": self.C,
            "image_size": S,
            "num_steps": num_steps,
            "max_regions": _MAX_REGIONS,
        }
        if p["meta"].exists():
            old = json.loads(p["meta"].read_text())
            assert old == meta, f"store meta mismatch: {old} vs {meta}"
        else:
            p["meta"].write_text(json.dumps(meta))
        self.geometry = self._memmap(p["geometry"], (self.P, S, S), np.uint8)
        self.constraints = self._memmap(p["constraints"], (n, S, S), np.uint8)
        self.displacement = self._memmap(p["displacement"], (n, S, S, 2), np.uint8)
        self.force_winner = self._memmap(p["force_winner"], (n, S, S, 2), np.int8)
        self.mat_winner = self._memmap(p["mat_winner"], (n, S, S, 2), np.int8)
        self.done = self._memmap(p["done"], (n,), np.uint8)
        sc = p["scalars"]
        if sc.exists():
            z = np.load(sc)
            self.force_vals = z["force_vals"]
            self.mat_vals = z["mat_vals"]
            self.ranges = z["ranges"]
        else:
            self.force_vals = np.zeros((n, _MAX_REGIONS, 2), np.float64)
            self.mat_vals = np.zeros((n, _MAX_REGIONS, 2), np.float64)
            self.ranges = np.zeros((n, self.num_steps, 4), np.float32)
        # Conditions built since the last flush(). `done` is only set on
        # disk by flush(), AFTER the scalar table and the pixel memmaps
        # are durable — a memmap write in build_plate could hit disk at
        # any time (kernel writeback), so marking done there would let a
        # crash persist done=1 for conditions whose scalars/pixels never
        # made it, silently poisoning a resumed build.
        self._done_pending: set = set()

    @staticmethod
    def _memmap(path: Path, shape: tuple, dtype) -> np.memmap:
        if path.exists():
            arr = np.lib.format.open_memmap(path, mode="r+")
            assert arr.shape == shape and arr.dtype == dtype
            return arr
        return np.lib.format.open_memmap(path, mode="w+", shape=shape, dtype=dtype)

    def _cidx(self, plate: int, condition: int) -> int:
        return (plate - 1) * self.C + (condition - 1)

    def build_plate(self, plate: int) -> None:
        """Decode one plate's conditions into the store (idempotent)."""
        S = self.S
        pdir = self.src / str(plate)
        geometry01 = _binarize(_load_gray(pdir / f"input.{self.ext}", S))
        self.geometry[plate - 1] = geometry01.astype(np.uint8)
        for condition in range(1, self.C + 1):
            ci = self._cidx(plate, condition)
            if self.done[ci] or ci in self._done_pending:
                continue
            cdir = pdir / str(condition)

            # displacement: the raw resized uint8 gray k (exact decode:
            # to_signed(1 - k/255))
            for ax, name in enumerate(("x", "y")):
                img = (
                    _load_gray(cdir / f"outputs_displacement_{name}.{self.ext}", S)
                )
                self.displacement[ci, :, :, ax] = np.rint(255.0 * (1.0 - img))

            cons = [
                _load_gray(q, S)
                for q in sorted(cdir.iterdir())
                if "Constraint" in q.name
            ]
            summed = (
                np.sum(np.stack(cons, 0), 0) if cons else np.zeros((S, S), np.float32)
            )
            self.constraints[ci] = _binarize(summed).astype(np.uint8)

            # forces: winner = last region in Edge->Vertex order with
            # mask=1 and value!=0 on that axis (diffusion.py:219-295)
            magnitudes = _parse_kv_file(cdir / "magnitudes.txt")
            ordered = [
                (name, values)
                for group in ("Edge", "Vertex")
                for name, values in magnitudes
                if group in name
            ]
            assert len(ordered) <= _MAX_REGIONS, f"{len(ordered)} force regions"
            fwin = np.full((S, S, 2), -1, np.int8)
            for r, (name, values) in enumerate(ordered):
                mask = _mask01(_load_gray(cdir / f"regions_{name}.{self.ext}", S))
                self.force_vals[ci, r] = np.asarray(values, np.float64)
                on = mask > 0
                for ax in range(2):
                    if float(values[ax]) != 0.0:
                        fwin[:, :, ax] = np.where(on, r, fwin[:, :, ax])
            self.force_winner[ci] = fwin

            # materials: same overlay semantics; all-zero mask falls back
            # to the geometry mask (diffusion.py:297-357)
            regions = _parse_kv_file(cdir / "materials.txt")
            assert len(regions) <= _MAX_REGIONS
            mwin = np.full((S, S, 2), -1, np.int8)
            for r, (name, (young, poisson)) in enumerate(regions):
                mask = _mask01(_load_gray(cdir / f"regions_{name}.{self.ext}", S))
                if mask.sum() == 0:
                    mask = geometry01
                self.mat_vals[ci, r] = (float(young), float(poisson))
                on = mask > 0
                young_n = np.sign(young) * np.log(abs(float(young)) + 1.0)
                if young_n != 0.0:
                    mwin[:, :, 0] = np.where(on, r, mwin[:, :, 0])
                if float(poisson) != 0.0:
                    mwin[:, :, 1] = np.where(on, r, mwin[:, :, 1])
            self.mat_winner[ci] = mwin

            all_ranges = dict(_parse_kv_file(cdir / "ranges.txt"))
            for step in range(1, self.num_steps + 1):
                self.ranges[ci, step - 1] = np.asarray(
                    list(all_ranges[f"displacement_x_{step}"])
                    + list(all_ranges[f"displacement_y_{step}"]),
                    np.float32,
                )
            self._done_pending.add(ci)

    def flush(self) -> None:
        """Make everything built so far durable, THEN mark it done.

        Order matters for crash consistency: (1) scalar table via atomic
        replace (a torn savez must not clobber the table the on-disk
        done flags were committed against), (2) pixel memmaps, (3) done
        flags last — done=1 on disk implies that condition's scalars and
        pixels are on disk."""
        paths = _store_paths(self.dir)
        tmp = paths["scalars"].with_name("scalars.tmp.npz")
        np.savez(
            tmp,
            force_vals=self.force_vals,
            mat_vals=self.mat_vals,
            ranges=self.ranges,
        )
        os.replace(tmp, paths["scalars"])
        for m in (
            self.geometry,
            self.constraints,
            self.displacement,
            self.force_winner,
            self.mat_winner,
        ):
            m.flush()
        for ci in self._done_pending:
            self.done[ci] = 1
        self._done_pending.clear()
        self.done.flush()

    def pending_plates(self) -> List[int]:
        done = np.asarray(self.done).copy().reshape(self.P, self.C)
        for ci in self._done_pending:
            done[ci // self.C, ci % self.C] = 1
        return [p + 1 for p in range(self.P) if not done[p].all()]


def build_condition_store(
    dataset_dir: str,
    store_dir: str,
    num_plates: int,
    image_size: int = 256,
    conditions_per_plate: int = 4,
    num_steps: int = 6,
    extension: str = "png",
    follow_pid: Optional[int] = None,
    verbose: bool = False,
) -> None:
    """Build (or resume) the store for `dataset_dir`.

    `follow_pid`: trail a still-running datagen process — only plates
    whose successor directory exists are considered complete until the
    process exits."""
    b = ConditionStoreBuilder(
        dataset_dir, store_dir, num_plates, image_size, conditions_per_plate,
        num_steps, extension,
    )
    src = Path(dataset_dir)

    def _alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    t0 = time.time()
    n_built = 0
    failures: Dict[int, int] = {}  # plate -> consecutive build failures
    _MAX_PLATE_RETRIES = 60  # ~10 min of trailing sweeps: mid-write
    # plates resolve in seconds; a plate still failing after this is
    # corrupt (truncated PNG from a killed datagen) and must surface
    while True:
        pending = b.pending_plates()
        if not pending:
            break
        trailing = follow_pid is not None and _alive(follow_pid)
        ready = [
            p
            for p in pending
            if (src / str(p) / str(conditions_per_plate) / "ranges.txt").exists()
            and (not trailing or (src / str(p + 1)).exists())
        ]
        if not ready:
            if trailing:
                time.sleep(10.0)
                continue
            missing = [p for p in pending if not (src / str(p)).exists()]
            raise FileNotFoundError(
                f"{len(pending)} plates incomplete, {len(missing)} missing "
                f"(e.g. {pending[:4]}) and no datagen process to wait for"
            )
        for p in ready:
            try:
                b.build_plate(p)
                failures.pop(p, None)
            except Exception as e:
                failures[p] = failures.get(p, 0) + 1
                if failures[p] == 1:
                    print(f"store: plate {p} failed ({e!r}); retrying",
                          flush=True)
                if trailing and failures[p] < _MAX_PLATE_RETRIES:
                    continue  # plate likely mid-write; retry next sweep
                raise
            n_built += 1
            if n_built % 50 == 0:
                b.flush()  # bound what a crash can lose on a long sweep
            if verbose and n_built % 200 == 0:
                rate = n_built / (time.time() - t0)
                print(
                    f"store: {n_built} plates built "
                    f"({rate:.1f}/s, {len(b.pending_plates())} pending)",
                    flush=True,
                )
        b.flush()
    b.flush()


class StoredFEADataset:
    """Drop-in replacement for `FEADataset` backed by a condition store.

    Produces bit-identical samples to the PNG path (asserted by
    tests/test_torch_store.py) with no PNG decode."""

    def __init__(
        self,
        store_dir: str,
        start_plate_index: int = 1,
        min_max_magnitude: Optional[Tuple[int, int]] = None,
        min_max_youngs_modulus: Optional[Tuple[int, int]] = None,
    ):
        assert min_max_magnitude is None and min_max_youngs_modulus is None, (
            "the condition store serves the log-scaling contract only "
            "(min-max scaling can change the overlay winner)"
        )
        self.dir = Path(store_dir)
        p = _store_paths(self.dir)
        meta = json.loads(p["meta"].read_text())
        self.P = meta["num_plates"]
        self.C = meta["conditions_per_plate"]
        self.S = meta["image_size"]
        self.image_size = self.S
        self.num_steps = meta["num_steps"] - 1
        self.start_plate_index = start_plate_index
        self.number_of_plate_geometries = self.P
        self.conditions_per_plate_geometry = self.C
        self.samples_per_plate = self.C * self.num_steps
        self.total_samples = self.P * self.samples_per_plate
        done = np.lib.format.open_memmap(p["done"], mode="r")
        assert bool(np.asarray(done).all()), "store is incomplete"
        self.geometry = np.lib.format.open_memmap(p["geometry"], mode="r")
        self.constraints = np.lib.format.open_memmap(p["constraints"], mode="r")
        self.displacement = np.lib.format.open_memmap(p["displacement"], mode="r")
        self.force_winner = np.lib.format.open_memmap(p["force_winner"], mode="r")
        self.mat_winner = np.lib.format.open_memmap(p["mat_winner"], mode="r")
        z = np.load(p["scalars"])
        self.force_vals = z["force_vals"]
        self.ranges = z["ranges"]
        mat_vals = z["mat_vals"]
        # material norms are step-independent: precompute padded tables
        # with slot 0 = "no winner" -> 0.0, indexed by winner+1
        young_n = np.sign(mat_vals[:, :, 0]) * np.log(
            np.abs(mat_vals[:, :, 0]) + 1.0
        )
        self.mat_norm = np.zeros(
            (self.P * self.C, mat_vals.shape[1] + 1, 2), np.float32
        )
        self.mat_norm[:, 1:, 0] = young_n
        self.mat_norm[:, 1:, 1] = mat_vals[:, :, 1]

    def __len__(self) -> int:
        return self.total_samples

    def index_to_ids(self, index: int) -> Tuple[int, int, int]:
        plate = index // self.samples_per_plate + self.start_plate_index
        condition = (index % self.samples_per_plate) // self.num_steps + 1
        step = (index % self.samples_per_plate) % self.num_steps + 1
        return plate, condition, step

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        plate, condition, step = self.index_to_ids(index)
        ci = (plate - self.start_plate_index) * self.C + (condition - 1)
        sample: Dict[str, np.ndarray] = {
            "plate_index": np.int32(plate),
            "condition_index": np.int32(condition),
            "iteration_index": np.int32(step),
        }
        g = self.geometry[plate - self.start_plate_index].astype(np.float32)
        sample["geometry"] = to_signed(g)[..., None]
        k = self.displacement[ci].astype(np.float32)
        sample["displacement"] = to_signed(1.0 - k / 255.0)
        c = self.constraints[ci].astype(np.float32)
        sample["constraints"] = to_signed(c)[..., None]

        # force norms at this step (f64 scalar math, then f32 cast, to
        # match the reference's Python-float pipeline bit-for-bit)
        v = self.force_vals[ci]
        # op order matches the reference's scalar pipeline exactly:
        # abs(v) * (step-1) / num_steps, then log1p (diffusion.py:246-266)
        norm = np.sign(v) * np.log(np.abs(v) * (step - 1) / self.num_steps + 1.0)
        fnorm = np.zeros((v.shape[0] + 1, 2), np.float32)
        fnorm[1:] = norm
        fw = self.force_winner[ci].astype(np.int16) + 1
        sample["forces"] = np.stack(
            [np.take(fnorm[:, 0], fw[:, :, 0]), np.take(fnorm[:, 1], fw[:, :, 1])],
            axis=-1,
        )
        mw = self.mat_winner[ci].astype(np.int16) + 1
        mn = self.mat_norm[ci]
        sample["materials"] = np.stack(
            [np.take(mn[:, 0], mw[:, :, 0]), np.take(mn[:, 1], mw[:, :, 1])],
            axis=-1,
        )
        r = self.ranges[ci, step - 1]
        sample["displacement_range"] = r
        sample["log_displacement_range"] = np.log1p(np.abs(r)).astype(np.float32)
        sample["sign_displacement_range"] = (r >= 0).astype(np.float32)
        return sample
