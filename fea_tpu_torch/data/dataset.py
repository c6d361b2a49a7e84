"""PNG-backed training dataset with the reference's normalization contract.

The port's own copy of fea_tpu/data/dataset.py (NumPy and PIL, no JAX),
kept so that fea_tpu_torch imports nothing of fea_tpu; tests hold the two
copies to the same arrays and the same index order. In NumPy/PIL, NHWC:
  * index -> (plate, condition, step) with 1-based plate/condition dirs;
  * transform: resize(image_size, bilinear) -> grayscale -> /255 -> invert;
  * geometry & constraints: binarize (threshold 0.5) then map to [-1, 1];
  * forces: per-region mask x log-scaled magnitude
    sign(v) * ln(1 + |v| * (step-1)/num_steps)  (or min-max scaling),
    edge channels overlaid first, vertex channels override where nonzero;
  * materials: mask x (log-scaled E, raw nu); an all-zero mask falls back
    to the geometry mask; where-overlay merging;
  * ranges.txt -> (lo_x, hi_x, lo_y, hi_y) + log/sign decompositions;
  * displacement target: step-1 x/y PNGs mapped to [-1, 1].

Samples are float32 numpy arrays (H, W, C); `collate` stacks dicts into
batches ready for device upload.
"""

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image


def _load_gray(path: Path, image_size: int) -> np.ndarray:
    """resize -> grayscale -> [0,1] -> invert, matching the reference's
    torchvision Compose (diffusion.py:118-128). Returns (H, W) float32."""
    img = Image.open(path).resize((image_size, image_size), Image.BILINEAR)
    arr = np.asarray(img.convert("L"), dtype=np.float32) / 255.0
    return 1.0 - arr


def _binarize(arr: np.ndarray) -> np.ndarray:
    """clamp(255*x, 0, 1) then threshold at 0.5 (diffusion.py:137-141)."""
    v = np.clip(255.0 * arr, 0.0, 1.0)
    return (v > 0.5).astype(np.float32)


def _mask01(arr: np.ndarray) -> np.ndarray:
    """clamp(255*x, 0, 1): any inked pixel -> 1 (diffusion.py:243)."""
    return np.clip(255.0 * arr, 0.0, 1.0)


def to_signed(x: np.ndarray) -> np.ndarray:
    return x * 2.0 - 1.0


def from_signed(x: np.ndarray) -> np.ndarray:
    return (x + 1.0) / 2.0


def _parse_kv_file(path: Path) -> List[Tuple[str, tuple]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, value = line.split(":", 1)
            out.append((name, eval(value)))  # the reference's contract
    return out


class FEADataset:
    def __init__(
        self,
        folder: str,
        extension: str = "png",
        image_size: int = 256,
        augmentation: bool = False,
        start_plate_index: int = 1,
        conditions_per_plate: int = 4,
        num_steps: int = 11,
        min_max_magnitude: Optional[Tuple[int, int]] = None,
        min_max_youngs_modulus: Optional[Tuple[int, int]] = None,
        cache_samples: bool = False,
    ):
        """`cache_samples` keeps every decoded sample in RAM (~2 MB each
        at 256px). Samples are deterministic (augmentation is vestigial,
        as in the reference — diffusion.py:150-156), so this trades
        memory for skipping ~8 PNG decode+resize calls per access — the
        dominant host cost of the training input pipeline on a
        single-core host (the reference's num_workers=0 DataLoader has
        the same serialization, train_model.py:77)."""
        self.path = Path(folder)
        assert self.path.exists(), f"Dataset directory {self.path} does not exist."
        assert num_steps >= 2, "num_steps must be >= 2"
        self.extension = extension
        self.image_size = image_size
        self.augmentation = augmentation
        self.start_plate_index = start_plate_index
        self.number_of_plate_geometries = len(
            [d for d in self.path.iterdir() if d.is_dir()]
        )
        self.conditions_per_plate_geometry = conditions_per_plate
        self.num_steps = num_steps - 1  # step 0 (zero load) is not a sample
        self.samples_per_plate = self.conditions_per_plate_geometry * self.num_steps
        self.total_samples = self.number_of_plate_geometries * self.samples_per_plate
        self.min_max_magnitude = min_max_magnitude
        self.min_max_youngs_modulus = min_max_youngs_modulus
        self._cache: Optional[Dict[int, Dict[str, np.ndarray]]] = (
            {} if cache_samples else None
        )

    def __len__(self) -> int:
        return self.total_samples

    @staticmethod
    def _scale_log(value: float) -> float:
        return float(np.log(value + 1.0))

    @staticmethod
    def _scale_min_max(value: float, mm: Tuple[float, float]) -> float:
        return (value - mm[0]) / (mm[1] - mm[0])

    def index_to_ids(self, index: int) -> Tuple[int, int, int]:
        plate = index // self.samples_per_plate + self.start_plate_index
        condition = (index % self.samples_per_plate) // self.num_steps + 1
        step = (index % self.samples_per_plate) % self.num_steps + 1
        return plate, condition, step

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self._cache is not None:
            hit = self._cache.get(index)
            if hit is not None:
                return hit
        sample = self._load_item(index)
        if self._cache is not None:
            self._cache[index] = sample
        return sample

    def _load_item(self, index: int) -> Dict[str, np.ndarray]:
        plate, condition, step = self.index_to_ids(index)
        S = self.image_size
        pdir = self.path / str(plate)
        cdir = pdir / str(condition)
        ext = self.extension

        sample: Dict[str, np.ndarray] = {
            "plate_index": np.int32(plate),
            "condition_index": np.int32(condition),
            "iteration_index": np.int32(step),
        }

        geometry01 = _binarize(_load_gray(pdir / f"input.{ext}", S))
        sample["geometry"] = to_signed(geometry01)[..., None]

        disp_x = to_signed(_load_gray(cdir / f"outputs_displacement_x.{ext}", S))
        disp_y = to_signed(_load_gray(cdir / f"outputs_displacement_y.{ext}", S))
        sample["displacement"] = np.stack([disp_x, disp_y], axis=-1)

        constraints = [
            _load_gray(p, S) for p in sorted(cdir.iterdir()) if "Constraint" in p.name
        ]
        summed = np.sum(np.stack(constraints, 0), 0) if constraints else np.zeros((S, S), np.float32)
        sample["constraints"] = to_signed(_binarize(summed))[..., None]

        # forces: edge overlays first, then vertex overrides (diffusion.py:219-295)
        magnitudes = _parse_kv_file(cdir / "magnitudes.txt")
        force = np.zeros((S, S, 2), dtype=np.float32)
        for group in ("Edge", "Vertex"):
            for name, values in magnitudes:
                if group not in name:
                    continue
                mask = _mask01(_load_gray(cdir / f"regions_{name}.{ext}", S))
                if self.min_max_magnitude is not None:
                    norm = [
                        self._scale_min_max(abs(float(v)), self.min_max_magnitude)
                        for v in values
                    ]
                else:
                    norm = [
                        np.sign(v)
                        * self._scale_log(
                            abs(float(v)) * (step - 1) / self.num_steps
                        )
                        for v in values
                    ]
                layer = np.stack([mask * norm[0], mask * norm[1]], axis=-1)
                force = np.where(layer != 0, layer, force)
        sample["forces"] = force.astype(np.float32)

        # materials (diffusion.py:297-357)
        regions = _parse_kv_file(cdir / "materials.txt")
        material = np.zeros((S, S, 2), dtype=np.float32)
        for name, (young, poisson) in regions:
            mask = _mask01(_load_gray(cdir / f"regions_{name}.{ext}", S))
            if mask.sum() == 0:
                mask = geometry01
            if self.min_max_youngs_modulus is not None:
                young_n = np.sign(young) * self._scale_min_max(
                    abs(float(young)), self.min_max_youngs_modulus
                )
            else:
                young_n = np.sign(young) * self._scale_log(abs(float(young)))
            layer = np.stack(
                [mask * float(young_n), mask * float(poisson)], axis=-1
            )
            material = np.where(layer != 0, layer, material)
        sample["materials"] = material.astype(np.float32)

        # ranges (diffusion.py:359-379). Looked up BY NAME, not by the
        # reference's positional stride of 2 lines per step
        # (diffusion.py:361-363) — that stride silently reads the wrong
        # lines for datasets generated with --save_strain/--save_stress,
        # which interleave all saved fields per step in ranges.txt.
        all_ranges = dict(_parse_kv_file(cdir / "ranges.txt"))
        ranges = list(all_ranges[f"displacement_x_{step}"]) + list(
            all_ranges[f"displacement_y_{step}"]
        )
        r = np.asarray(ranges, dtype=np.float32)
        sample["displacement_range"] = r
        sample["log_displacement_range"] = np.log1p(np.abs(r)).astype(np.float32)
        sample["sign_displacement_range"] = (r >= 0).astype(np.float32)

        return sample


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {
        k: np.stack([s[k] for s in samples], axis=0) for k in samples[0].keys()
    }


class EpochSampler:
    """Deterministic shuffling with O(1) resume.

    Replaces the reference's DataLoader(shuffle=True) +
    skip_first_batches resume dance (diffusion.py:704-717): the
    permutation for epoch e is a pure function of (seed, e), so resuming
    at global sample offset k needs no iteration."""

    def __init__(self, n: int, seed: int = 0, shuffle: bool = True):
        self.n = n
        self.seed = seed
        self.shuffle = shuffle
        self._cache: Dict[int, np.ndarray] = {}

    def epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.n)
        if epoch not in self._cache:
            if len(self._cache) > 4:
                self._cache.clear()
            rng = np.random.default_rng((self.seed, epoch))
            self._cache[epoch] = rng.permutation(self.n)
        return self._cache[epoch]

    def indices_at(self, global_offset: int, count: int) -> np.ndarray:
        out = np.empty(count, dtype=np.int64)
        for i in range(count):
            g = global_offset + i
            epoch, off = divmod(g, self.n)
            out[i] = self.epoch_order(epoch)[off]
        return out
