"""Training runtime for the FDN-UNet surrogate, the port of
fea_tpu/train/trainer.py.

One step is grad accumulation over micro-batches, per-module
clip-by-global-norm then Adam (optax's, written out in optim.py), EMA, and
a non-finite guard, all on the device with no host sync; the host loop
reads each step's loss one step late, so that decoding the next batch
overlaps the step. Semantics kept from fea_tpu:
  * summed mean-L1/L2 losses over the active heads, the geometry mask of
    the image prediction, disable_auxiliary / only_auxiliary gating;
  * effective-batch >= 16 and dataset-size >= 100 guards;
  * the milestone / soft-milestone loop with best / latest (+ latest-prev)
    checkpoints, a zip artifact beside each, and the 'final' save;
  * resume with the O(1) data skip-ahead of EpochSampler, and 'auto'
    resume from the newest checkpoint;
  * results/train-e{steps}-b{batch}-lr{lr}-{ts}.log logging.
Checkpoints are torch files (model-<milestone>/state.pt).

Data parallel under a process group of W ranks (parallel/, one process per
GPU): every rank holds the same params (broadcast from rank 0 after
construction and after a checkpoint loads), draws the same sample order and
feeds its row block of every micro-batch, fea_tpu's process-major layout;
one all-reduce mean of the flat gradients and the loss comes before the
guard and the clip, so every rank takes the same update. Rank 0 alone
writes logs, samples and checkpoints; every rank joins the barriers around
a save.
"""

import logging
import math
import os
import pickle
import shutil
import zipfile
from dataclasses import dataclass
from datetime import datetime
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image
from torch.utils.checkpoint import checkpoint

from ..data.dataset import EpochSampler, FEADataset, collate
from ..data.device_store import (
    assemble_batch,
    build_device_tables,
    default_table_byte_cap,
    estimate_table_bytes,
    index_arrays,
)
from ..data.store import StoredFEADataset
from ..models.fdnunet import create_models
from ..parallel.distributed import is_main_process, sync_processes
from ..parallel.mesh import all_reduce_mean, gather_rows, make_mesh, replicate
from ..utils.precision import model_precision
from .ema import ema_update
from .optim import AdamState, adam_init, adam_update, clip_by_global_norm, global_norm, select_

MODULES = ("encoder", "decoder", "auxiliary")
COMPUTE_DTYPES = {None: None, "bfloat16": torch.bfloat16}
# consecutive non-finite losses after which the loop stops
NAN_STREAK_LIMIT = 50


@dataclass
class TrainerConfig:
    dataset_folder: str = "data"
    sample_dataset_folder: str = "sample_data"
    disable_auxiliary: bool = True
    only_auxiliary: bool = False
    dataset_image_size: int = 256
    train_batch_size: int = 16
    sample_batch_size: Optional[int] = None
    train_start_plate_index: int = 1
    sample_start_plate_index: int = 1
    conditions_per_plate: int = 4
    num_sample_conditions_per_plate: int = 1
    num_steps_per_condition: int = 6
    num_steps_per_sample_condition: int = 6
    num_gradient_accumulation_steps: int = 1
    train_learning_rate: float = 1e-4
    num_train_steps: int = 1000
    num_steps_per_milestone: int = 250
    num_steps_per_soft_milestone: int = 50
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    max_gradient_norm: float = 1.0
    loss_type: str = "l1"
    use_ema: bool = False
    ema_decay: float = 0.995
    results_folder: str = "results"
    input_dim: int = 64
    num_stages: int = 4
    num_channels: int = 2  # displacement / materials channels
    num_auxiliary_condition_channels: int = 3  # forces (2) + constraints (1)
    seed: int = 0
    progress_bar: bool = True
    # keep decoded samples in RAM; None = when the decoded set takes under
    # a quarter of the free RAM
    cache_datasets: Optional[bool] = None
    # a condition-store directory (data/store.py) to train from instead of
    # the PNG folder
    dataset_store: Optional[str] = None
    # ranks of the process group (parallel/): None = every rank of the group,
    # or 1 without one; another number must equal the group's size
    n_devices: Optional[int] = None
    skip_dataset_size_check: bool = False
    inference_only: bool = False  # sampling: no effective-batch floor
    # 'bfloat16': params and image inputs are cast to bf16 at apply time
    # (grads come back f32), outputs cast to f32; None = f32 tensors
    # throughout, with the convolutions at the port's model precision on the
    # card (utils/precision.py: TF32 unless a caller asks for "ieee")
    compute_dtype: Optional[str] = None
    # ship the +-1 mask channels as int8 and, under bf16 compute, forces
    # and materials as bf16: bit-exact, fewer bytes to the device
    pack_transfers: bool = True
    # with dataset_store: upload the store's tables to the device once and
    # assemble every micro-batch there from index vectors, when the tables
    # fit under the cap (None: the device's memory less the train step's
    # reserve, data/device_store.py); else the host feed carries on
    device_resident_store: bool = False
    device_store_byte_cap: Optional[int] = None
    # recompute each micro-batch's forward in the backward
    remat_loss: bool = False


class _StagedLoss:
    """A device scalar on its way to the host. The copy is queued behind the
    step that computes it; `value()` waits for that step only, not for
    steps queued after it."""

    def __init__(self, loss: torch.Tensor):
        if loss.device.type == "cuda":
            self._host = torch.empty((), dtype=loss.dtype, pin_memory=True)
            self._host.copy_(loss, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = loss, None

    def value(self) -> float:
        if self._event is not None:
            self._event.synchronize()
        return float(self._host)


def _check_config(config: TrainerConfig):
    if config.disable_auxiliary and config.only_auxiliary:
        raise ValueError("Cannot disable and only use auxiliary")
    if config.num_steps_per_condition < 2 or config.num_steps_per_sample_condition < 2:
        raise ValueError("num_steps_per_condition and _per_sample_condition must be >= 2")
    if not config.inference_only and (
        config.train_batch_size * config.num_gradient_accumulation_steps < 16
    ):
        raise ValueError("effective batch size (batch x grad accum) must be at least 16")
    if config.loss_type not in ("l1", "l2"):
        raise ValueError(f"unknown loss_type {config.loss_type}")
    if config.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {list(COMPUTE_DTYPES)}")


class Trainer:
    def __init__(self, config: TrainerConfig, dataset=None, sample_dataset=None, device=None):
        """`dataset` / `sample_dataset` override the folder-backed FEADataset
        with any dataset of the same contract. Runs on the CUDA device
        unless `device` says otherwise (the tests pass "cpu"): under a process
        group, the rank's own device."""
        _check_config(config)
        self.config = config
        self.dp = make_mesh(config.n_devices, device)
        self.device = self.dp.device
        self.is_main = is_main_process()
        self.compute_dtype = COMPUTE_DTYPES[config.compute_dtype]

        self.device_tables = None
        if dataset is None and config.dataset_store is not None:
            dataset = StoredFEADataset(
                config.dataset_store, start_plate_index=config.train_start_plate_index
            )
            assert dataset.image_size == config.dataset_image_size
            assert dataset.num_steps == config.num_steps_per_condition - 1
            assert dataset.conditions_per_plate_geometry == config.conditions_per_plate
            if config.device_resident_store:
                est = estimate_table_bytes(dataset)
                cap = config.device_store_byte_cap
                if cap is None:
                    cap = default_table_byte_cap(self.device)
                if est <= cap:
                    self.device_tables = build_device_tables(dataset, self.device)
                    print(
                        f"device-resident store: {est / 1e9:.2f} GB of "
                        "tables uploaded once; per-step host traffic is "
                        "index vectors only"
                    )
                else:
                    print(
                        f"device-resident store disabled: tables "
                        f"{est / 1e9:.2f} GB exceed cap {cap / 1e9:.2f} GB"
                        " — falling back to the host feed"
                    )
        from_folder = dataset is None
        self.dataset = dataset if dataset is not None else FEADataset(
            config.dataset_folder,
            image_size=config.dataset_image_size,
            conditions_per_plate=config.conditions_per_plate,
            num_steps=config.num_steps_per_condition,
            start_plate_index=config.train_start_plate_index,
        )
        if from_folder:
            cache = config.cache_datasets
            if cache is None:
                S = config.dataset_image_size
                est_bytes = len(self.dataset) * (S * S * 8 * 4 + 4096)
                try:
                    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
                except (ValueError, OSError):
                    avail = 8 << 30
                cache = est_bytes < 0.25 * avail
            if cache:
                self.dataset._cache = {}
        # the sample set is decoded again at every soft milestone: cache it
        self.sample_dataset = sample_dataset if sample_dataset is not None else FEADataset(
            config.sample_dataset_folder,
            image_size=config.dataset_image_size,
            conditions_per_plate=config.num_sample_conditions_per_plate,
            num_steps=config.num_steps_per_sample_condition,
            start_plate_index=config.sample_start_plate_index,
            cache_samples=True,
        )
        if not config.skip_dataset_size_check and len(self.dataset) < 100:
            raise ValueError("you should have at least 100 samples; 10k+ recommended")
        self.sampler = EpochSampler(len(self.dataset), seed=config.seed)
        self.sample_batch_size = config.sample_batch_size or config.train_batch_size
        for name, size in (("train", config.train_batch_size), ("sample", self.sample_batch_size)):
            if size % self.dp.world_size:
                raise ValueError(
                    f"{name} batch size {size} must divide over {self.dp.world_size} ranks")

        S = config.dataset_image_size
        generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.modules = dict(zip(MODULES, create_models(
            input_dim=config.input_dim,
            image_height=S,
            image_width=S,
            num_stages=config.num_stages,
            num_channels=config.num_channels,
            num_auxiliary_condition_channels=config.num_auxiliary_condition_channels,
            device=self.device,
            generator=generator,
        )))
        self.names = {k: [n for n, _ in m.named_parameters()] for k, m in self.modules.items()}
        self.params = {k: list(m.parameters()) for k, m in self.modules.items()}
        replicate([p for k in MODULES for p in self.params[k]])
        self.active = {
            "encoder": True,
            "decoder": not config.only_auxiliary,
            "auxiliary": not config.disable_auxiliary,
        }
        self.opt_states = {k: adam_init(self.params[k]) for k in MODULES}
        self.ema_params = None
        if config.use_ema:
            self.ema_params = {k: [p.detach().clone() for p in self.params[k]] for k in MODULES}
        self._ema_decay = torch.tensor(config.ema_decay, dtype=torch.float64, device=self.device)
        self.step = 0
        self.lowest_sample_loss = math.inf

        self.results_folder = Path(config.results_folder).resolve()
        self.results_folder.mkdir(parents=True, exist_ok=True)
        log_name = "train-e{}-b{}-lr{}-{}.log".format(
            config.num_train_steps,
            config.train_batch_size,
            str(config.train_learning_rate)[2:],
            datetime.now().strftime("%Y-%m-%d-%H-%M-%S"),
        )
        if self.is_main:
            logging.basicConfig(
                filename=str(self.results_folder / log_name),
                level=logging.INFO,
                format="%(asctime)s %(message)s",
                force=True,
            )
        else:
            logging.basicConfig(level=logging.ERROR, force=True)  # no train-*.log

    def num_params(self) -> Dict[str, int]:
        return {k: sum(p.numel() for p in v) for k, v in self.params.items()}

    # ------------------------------------------------------------ model fns
    def _apply_model(self, batch, weights: Optional[Dict[str, List[torch.Tensor]]] = None):
        """encoder -> (aux heads, decoder) with geometry masking, through
        `weights` (default: the modules' own parameters). Under bf16 compute
        the weights and the image inputs are cast to bf16 here (the casts
        are differentiable: grads come back f32), and head outputs are cast
        to f32 before masking and loss."""
        cfg = self.config
        dt = self.compute_dtype
        weights = weights if weights is not None else self.params

        def cast(t):
            return t if dt is None else t.to(dt)

        def run(key, *args):
            tensors = dict(zip(self.names[key], map(cast, weights[key])))
            return torch.func.functional_call(self.modules[key], tensors, args)

        conditions = torch.cat([batch["forces"], batch["constraints"]], dim=-1)
        x, hidden, residual = run("encoder", cast(batch["materials"]), cast(conditions))
        image_prediction = None
        range_prediction = None
        if not cfg.disable_auxiliary:
            sign_pred, log_pred = run("auxiliary", x)
            range_prediction = (sign_pred.float(), log_pred.float())
        if not cfg.only_auxiliary:
            image_prediction = run("decoder", x, hidden, residual).float()
            geometry01 = (batch["geometry"] + 1.0) / 2.0
            image_prediction = ((image_prediction + 1.0) / 2.0 * geometry01) * 2.0 - 1.0
        return image_prediction, range_prediction

    def _head_loss(self, pred, target, per_sample: bool = False):
        d = pred - target
        a = d.abs() if self.config.loss_type == "l1" else d * d
        return a.reshape(a.shape[0], -1).mean(dim=1) if per_sample else a.mean()

    def _loss(self, batch):
        image_pred, range_pred = self._apply_model(batch)
        loss = 0.0
        if image_pred is not None:
            loss = loss + self._head_loss(image_pred, batch["displacement"])
        if range_pred is not None:
            sign_pred, log_pred = range_pred
            loss = loss + self._head_loss(sign_pred, batch["sign_displacement_range"])
            loss = loss + self._head_loss(log_pred, batch["log_displacement_range"])
        return loss

    # ------------------------------------------------- transfer packing
    def _pack_transfer(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host tensors of a collated batch, shrunk bit-exactly: geometry and
        constraints are exactly {-1, +1} (the dataset contract) and ship as
        int8; under bf16 compute the model casts forces and materials to
        bf16 anyway, so they ship as bf16. Displacement and the range
        targets stay f32."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if not self.config.pack_transfers:
            return out
        for k in ("geometry", "constraints"):
            if k in out:
                out[k] = out[k].to(torch.int8)
        if self.compute_dtype == torch.bfloat16:
            for k in ("forces", "materials"):
                if k in out:
                    out[k] = out[k].to(torch.bfloat16)
        return out

    @staticmethod
    def _unpack_transfer(batch):
        """Device-side inverse of _pack_transfer: int8 masks back to f32;
        bf16 channels stay bf16 (the model's cast makes them bf16 anyway,
        and the concatenation promotes exactly)."""
        out = dict(batch)
        for k in ("geometry", "constraints"):
            if k in out and not out[k].is_floating_point():
                out[k] = out[k].float()
        return out

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ---------------------------------------------------------- train step
    @model_precision()
    def _train_step(self, batch) -> torch.Tensor:
        """One optimizer step on `batch` (leaves (accum, micro, ...) on the
        device: packed tensors, or with the device-resident store the index
        vectors that each micro-batch is assembled from); returns the mean
        loss as a device scalar, without a sync.

        Non-finite guard: when the loss or the global grad norm is not
        finite, the params, the Adam moments and step count and the EMA all
        keep their values (the selection happens on the device); the step
        counter still advances, and the loop aborts after a long streak."""
        cfg = self.config
        accum = cfg.num_gradient_accumulation_steps
        active = [k for k in MODULES if self.active[k]]
        params = [p for k in active for p in self.params[k]]
        loss_fn = self._loss
        if cfg.remat_loss:
            loss_fn = partial(checkpoint, self._loss, use_reentrant=False)

        grads, loss_sum = None, None
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            if "ci" in micro:
                micro = assemble_batch(self.device_tables, micro)
            else:
                micro = self._unpack_transfer(micro)
            loss = loss_fn(micro)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for gi, p in zip(g, params)]
            if grads is None:
                grads, loss_sum = g, loss.detach()
            else:
                torch._foreach_add_(grads, g)
                loss_sum = loss_sum + loss.detach()
        torch._foreach_div_(grads, accum)
        loss = loss_sum / accum
        # under a process group: the mean over the ranks, before the guard
        # and the clip, so that every rank takes the same decision and update
        all_reduce_mean(grads + [loss])
        ok = torch.isfinite(loss) & torch.isfinite(global_norm(grads))

        start = 0
        for key in active:
            own = self.params[key]
            clipped = clip_by_global_norm(grads[start:start + len(own)], cfg.max_gradient_norm)
            start += len(own)
            state = self.opt_states[key]
            new_params, new_state = adam_update(
                own, clipped, state, cfg.train_learning_rate, *cfg.adam_betas
            )
            select_(ok, own, new_params)
            select_(ok, state.mu, new_state.mu)
            select_(ok, state.nu, new_state.nu)
            select_(ok, [state.count], [new_state.count])
        if self.ema_params is not None:
            # a skipped step moves the EMA by decay 1: e * 1 + p * 0 == e
            decay = torch.where(ok, self._ema_decay, 1.0)
            for key in MODULES:
                ema_update(self.ema_params[key], self.params[key], decay)
        self.step += 1
        return loss

    @torch.no_grad()
    def _eval_step(self, batch, use_ema: bool):
        """Predictions and per-sample losses (so that the caller can mask
        padding out of the mean) from one forward pass."""
        weights = self.ema_params if (use_ema and self.ema_params is not None) else None
        image_pred, range_pred = self._apply_model(batch, weights)
        loss_vec = torch.zeros(batch["geometry"].shape[0], device=self.device)
        if image_pred is not None:
            loss_vec = loss_vec + self._head_loss(image_pred, batch["displacement"], True)
        if range_pred is not None:
            sign_pred, log_pred = range_pred
            loss_vec = loss_vec + self._head_loss(sign_pred, batch["sign_displacement_range"], True)
            loss_vec = loss_vec + self._head_loss(log_pred, batch["log_displacement_range"], True)
        return image_pred, range_pred, loss_vec

    # ------------------------------------------------------------- batches
    def _fetch_batch(self, global_offset: int) -> Dict[str, torch.Tensor]:
        cfg = self.config
        accum, micro = cfg.num_gradient_accumulation_steps, cfg.train_batch_size
        idx = self.sampler.indices_at(global_offset, micro * accum)
        # this rank's row block of every micro-batch
        rows = self.dp.rows(micro)
        idx = np.asarray(idx).reshape(accum, micro)[:, rows].reshape(-1)
        micro = rows.stop - rows.start
        if self.device_tables is not None:
            # device-resident store: ship index vectors, assemble on the device
            batch = {k: torch.from_numpy(v) for k, v in index_arrays(self.dataset, idx).items()}
        else:
            batch = self._pack_transfer(collate([self.dataset[int(i)] for i in idx]))
        return {
            k: self._to_device(v.reshape((accum, micro) + tuple(v.shape[1:])))
            for k, v in batch.items()
        }

    # ------------------------------------------------------------ main loop
    def train(self, wandb_inject_function: Optional[Callable] = None):
        cfg = self.config
        effective = len(self.dataset) / max(
            cfg.train_batch_size * cfg.num_gradient_accumulation_steps, 1
        )
        if self.is_main:
            print(f"Epoch Size: {effective} effective batches")
            if effective:
                print(f"Number of Effective Epochs: {cfg.num_train_steps / effective}")

        per_step = cfg.train_batch_size * cfg.num_gradient_accumulation_steps
        step = self.step
        pbar = None
        if cfg.progress_bar and self.is_main:
            from tqdm import tqdm

            pbar = tqdm(initial=step, total=cfg.num_train_steps, desc="training")

        next_batch = self._fetch_batch(step * per_step)
        # The loss is read one step late: step i's value is converted after
        # step i + 1 is queued and batch i + 2 decoded, so the read never
        # leaves the device idle. pending = (step index, staged loss).
        pending = None
        nan_streak = 0

        def resolve_pending():
            nonlocal pending, nan_streak
            if pending is None:
                return None
            s, staged = pending
            pending = None
            v = staged.value()
            if math.isfinite(v):
                nan_streak = 0
            else:
                nan_streak += 1
                logging.warning(
                    f"step: {s}, non-finite loss ({v}) — update skipped "
                    f"by the non-finite guard ({nan_streak} consecutive)"
                )
                if nan_streak >= NAN_STREAK_LIMIT:
                    raise RuntimeError(
                        f"{NAN_STREAK_LIMIT} consecutive non-finite losses: every "
                        "step is being skipped by the non-finite guard — aborting"
                    )
            logging.info(f"step: {s}, loss: {v:.4f}")
            if pbar is not None:
                pbar.set_description(f"loss: {v:.4f}")
            return v

        while step < cfg.num_train_steps:
            batch = next_batch
            staged = _StagedLoss(self._train_step(batch))
            if step + 1 < cfg.num_train_steps:
                next_batch = self._fetch_batch((step + 1) * per_step)
            loss_value = resolve_pending()
            pending = (step, staged)
            if pbar is not None:
                pbar.update(1)

            new_step = step + 1
            total_sample_loss = None
            image_filenames = None
            ranges = None
            milestone = None
            at_milestone = (
                new_step % cfg.num_steps_per_milestone == 0
                or new_step % cfg.num_steps_per_soft_milestone == 0
            )
            if wandb_inject_function is not None or at_milestone:
                # the callback needs this step's value; milestones wait for
                # the device anyway, so keep the log in order
                loss_value = resolve_pending()
            if new_step % cfg.num_steps_per_milestone == 0:
                image_filenames, ranges, total_sample_loss = self.sample_and_save()
                logging.info(f"sample loss: {total_sample_loss:.4f}")
                if total_sample_loss < self.lowest_sample_loss:
                    self.lowest_sample_loss = total_sample_loss
                    milestone = "best"
                else:
                    milestone = "latest"
                self.save_checkpoint(milestone)
            elif new_step % cfg.num_steps_per_soft_milestone == 0:
                _, _, total_sample_loss = self.sample_and_save(save=False)
                logging.info(f"sample loss: {total_sample_loss:.4f}")

            if wandb_inject_function is not None:
                wandb_inject_function(
                    new_step, loss_value, total_sample_loss, image_filenames,
                    ranges, milestone,
                )
            step = new_step

        resolve_pending()
        if pbar is not None:
            pbar.close()
        self.save_checkpoint("final")
        if self.is_main:
            print("Training done!")

    # ------------------------------------------------------------ sampling
    @staticmethod
    def _view_friendly(image: np.ndarray) -> np.ndarray:
        """[-1, 1] -> 'Greys' colormap pixels: high value -> dark."""
        v01 = np.clip((image + 1.0) / 2.0, 0.0, 1.0)
        return np.round((1.0 - v01) * 255.0).astype(np.uint8)

    @staticmethod
    def _view_friendly_range(sign_out: np.ndarray, log_out: np.ndarray):
        sign = (sign_out < 0.5).astype(np.int32) * 2 - 1
        return sign * (np.exp(log_out) - 1.0)

    @model_precision()
    def sample_and_save(
        self,
        milestone=None,
        save: bool = True,
        progress_bar: bool = False,
        use_ema: bool = False,
    ):
        """Predict the sample set; write each prediction as x/y PNGs and
        the ranges as text under results/[milestone/]plate/condition, and
        return (image file names, ranges, mean sample loss). Under a process
        group each rank predicts its row block of every batch, the rows are
        gathered, and rank 0 writes."""
        n = len(self.sample_dataset)
        bs = self.sample_batch_size
        rows = self.dp.rows(bs)
        write = save and self.is_main
        num_conditions = self.sample_dataset.conditions_per_plate_geometry
        num_steps = self.sample_dataset.num_steps

        image_filenames: List[str] = []
        all_ranges: List[np.ndarray] = []
        loss_sum = 0.0
        loss_count = 0

        starts = range(0, n, bs)
        if progress_bar and self.is_main:
            from tqdm import tqdm

            starts = tqdm(starts, desc="sampling", total=(n + bs - 1) // bs)
        for start in starts:
            idx = list(range(start, min(start + bs, n)))
            # static batch shape: pad by repeating the last sample
            pad = bs - len(idx)
            samples = [self.sample_dataset[i] for i in (idx + [idx[-1]] * pad)[rows]]
            batch = {
                k: self._to_device(torch.from_numpy(v)) for k, v in collate(samples).items()
            }
            image_pred, range_pred, loss_vec = self._eval_step(batch, use_ema)
            if self.dp.distributed:
                loss_vec = gather_rows(loss_vec)
                if save:
                    image_pred = None if image_pred is None else gather_rows(image_pred)
                    range_pred = None if range_pred is None else tuple(map(gather_rows, range_pred))
            # mask the padded (repeated) tail out of the reported loss
            loss_sum += float(loss_vec[: len(idx)].sum())
            loss_count += len(idx)
            if not write:
                continue

            image_pred = None if image_pred is None else image_pred.cpu().numpy()
            for j, sample_index in enumerate(idx):
                ids_of = getattr(self.sample_dataset, "index_to_ids", None)
                if ids_of is not None:
                    plate, condition, step = ids_of(sample_index)
                else:
                    plate = sample_index // (num_conditions * num_steps) + 1
                    condition = (sample_index % (num_conditions * num_steps)) // num_steps + 1
                    step = (sample_index % (num_conditions * num_steps)) % num_steps + 1
                pathname = self.results_folder / f"{plate}" / f"{condition}"
                if milestone is not None:
                    pathname = self.results_folder / f"{milestone}" / f"{plate}" / f"{condition}"
                pathname.mkdir(parents=True, exist_ok=True)

                if image_pred is not None:
                    for channel, axis in ((0, "x"), (1, "y")):
                        img = self._view_friendly(image_pred[j, :, :, channel])
                        fname = str(pathname / f"sample_{axis}_{step}.png")
                        Image.fromarray(img).save(fname)
                        image_filenames.append(fname)
                if range_pred is not None:
                    sign_out = range_pred[0][j].cpu().numpy()
                    log_out = range_pred[1][j].cpu().numpy()
                    rng_val = self._view_friendly_range(sign_out, log_out)
                    all_ranges.append(rng_val)
                    for axis in ("x", "y"):
                        np.savetxt(str(pathname / f"sample_{axis}_{step}.txt"), rng_val)

        total_loss = loss_sum / max(loss_count, 1)
        return (
            image_filenames if (image_filenames and write) else None,
            all_ranges if all_ranges else None,
            total_loss,
        )

    # --------------------------------------------------------- checkpoints
    def _ckpt_dir(self, milestone) -> Path:
        return self.results_folder / f"model-{milestone}"

    def state_dict(self) -> dict:
        """Params, Adam states, EMA, step and lowest sample loss, as saved."""
        return {
            "params": {k: m.state_dict() for k, m in self.modules.items()},
            "opt_states": {
                k: {"count": s.count, "mu": s.mu, "nu": s.nu}
                for k, s in self.opt_states.items()
            },
            "ema_params": None if self.ema_params is None else {
                k: dict(zip(self.names[k], v)) for k, v in self.ema_params.items()
            },
            "step": self.step,
            "lowest_sample_loss": self.lowest_sample_loss,
        }

    def save_checkpoint(self, milestone):
        """Every rank joins the barrier before and after; rank 0 alone
        rotates and writes (the reference's wait_for_everyone +
        is_main_process)."""
        sync_processes()
        if self.is_main:
            self._write_checkpoint(milestone)
        sync_processes()

    def _write_checkpoint(self, milestone):
        if milestone == "latest":
            # rotate latest -> latest-prev
            prev_dir = self._ckpt_dir("latest-prev")
            prev_zip = self.results_folder / "model-latest-prev.zip"
            for p in (prev_dir, prev_zip):
                if p.exists():
                    shutil.rmtree(p) if p.is_dir() else p.unlink()
            cur_dir = self._ckpt_dir("latest")
            cur_zip = self.results_folder / "model-latest.zip"
            if cur_dir.exists():
                cur_dir.rename(prev_dir)
            if cur_zip.exists():
                cur_zip.rename(prev_zip)
        else:
            self.delete_checkpoint_if_exists(milestone)

        path = self._ckpt_dir(milestone)
        path.mkdir(parents=True)
        torch.save(self.state_dict(), path / "state.pt")
        # the zip artifact beside the directory (kept for fast resume)
        zip_path = self.results_folder / f"model-{milestone}.zip"
        with zipfile.ZipFile(zip_path, "w") as zf:
            for file in path.rglob("*"):
                if file.is_file():
                    zf.write(file, arcname=file.relative_to(self.results_folder))

    def delete_checkpoint_if_exists(self, milestone):
        path = self._ckpt_dir(milestone)
        if path.exists():
            shutil.rmtree(path)
        zip_path = self.results_folder / f"model-{milestone}.zip"
        if zip_path.exists():
            zip_path.unlink()

    def unzip_checkpoint(self, milestone):
        with zipfile.ZipFile(self.results_folder / f"model-{milestone}.zip", "r") as zf:
            zf.extractall(self.results_folder)

    def load_checkpoint(self, milestone):
        """`milestone='auto'` resumes from whichever saved checkpoint (best /
        latest / latest-prev / final) has the highest step, and starts
        fresh when there is none. A checkpoint with EMA weights loads into a
        trainer without EMA (the weights are dropped); a trainer with EMA
        refuses a checkpoint without them. Every rank reads the file onto its
        own device; rank 0's values are then broadcast."""
        if milestone == "auto":
            milestone = self._newest_milestone()
            if milestone is None:
                print("auto-resume: no checkpoint yet, starting fresh")
                return
            print(f"auto-resume: milestone '{milestone}'")
        path = self._ckpt_dir(milestone)
        if not path.exists() and (self.results_folder / f"model-{milestone}.zip").exists():
            sync_processes()  # every rank has looked before rank 0 unzips
            if self.is_main:
                self.unzip_checkpoint(milestone)
            sync_processes()
        state = torch.load(path / "state.pt", map_location=self.device, weights_only=True)
        has_ema = state["ema_params"] is not None
        if self.ema_params is not None and not has_ema:
            raise ValueError(
                f"checkpoint '{milestone}' carries no EMA weights (trained "
                "without use_ema); sample without use_ema"
            )
        if has_ema and self.ema_params is None:
            print("note: checkpoint carries EMA weights; restoring raw params")

        for key, module in self.modules.items():
            module.load_state_dict(state["params"][key])  # strict: names and shapes
            opt = state["opt_states"][key]
            self.opt_states[key] = AdamState(opt["count"], list(opt["mu"]), list(opt["nu"]))
            if self.ema_params is not None:
                ema = state["ema_params"][key]
                self.ema_params[key] = [ema[name] for name in self.names[key]]
        self.step = int(state["step"])
        self.lowest_sample_loss = float(state["lowest_sample_loss"])
        replicate(self._state_tensors())

    def _state_tensors(self) -> List[torch.Tensor]:
        """Params, Adam moments and counts, and EMA, in a fixed order."""
        out = []
        for key in MODULES:
            state = self.opt_states[key]
            out += [*self.params[key], state.count, *state.mu, *state.nu]
            if self.ema_params is not None:
                out += self.ema_params[key]
        return out

    def _newest_milestone(self) -> Optional[str]:
        best = None
        for name in ("final", "best", "latest", "latest-prev"):
            path = self._ckpt_dir(name) / "state.pt"
            if not path.exists():
                continue
            try:
                step = torch.load(path, map_location="cpu", mmap=True, weights_only=True)["step"]
            except (RuntimeError, OSError, EOFError, pickle.UnpicklingError):
                continue  # unreadable (a save cut short): resume from another
            if best is None or step > best[1]:
                best = (name, step)
        return None if best is None else best[0]
