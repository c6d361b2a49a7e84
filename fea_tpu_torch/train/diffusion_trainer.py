"""Training loop for the conditional-diffusion mode, the port of
fea_tpu/train/diffusion_trainer.py.

The FDN-UNet denoiser is conditioned on [forces, constraints, materials]
(5 channels) and learns the displacement image distribution: one clipped
Adam chain and an EMA every step, the EMA driving sampling. The time steps
and the noise come from a torch.Generator seeded from the config. Flash
attention is off, as in fea_tpu: its kernel has no backward.

Data parallel under a process group, as the regression Trainer: the params
are broadcast from rank 0, each rank feeds its row block of the batch, and
t and the noise are drawn for the whole batch from the generator, which is
seeded alike on every rank, so that W ranks compute the loss terms of the
one-rank step; one all-reduce mean of the gradients and the loss comes
before the clip. Rank 0 writes the checkpoints.
"""

import logging
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import EpochSampler, FEADataset, collate
from ..models.diffusion import GaussianDiffusion, make_diffusion_model
from ..parallel.distributed import is_main_process, sync_processes
from ..parallel.mesh import all_reduce_mean, make_mesh, replicate
from ..utils.precision import model_precision
from .ema import ema_update
from .optim import AdamState, adam_init, adam_update, clip_by_global_norm


@dataclass
class DiffusionConfig:
    dataset_folder: str = "data"
    dataset_image_size: int = 256
    conditions_per_plate: int = 4
    num_steps_per_condition: int = 6
    train_batch_size: int = 16
    train_learning_rate: float = 1e-4
    num_train_steps: int = 10000
    num_steps_per_milestone: int = 500
    timesteps: int = 1000
    objective: str = "pred_noise"
    ema_decay: float = 0.995
    input_dim: int = 64
    num_stages: int = 4
    results_folder: str = "results_diffusion"
    seed: int = 0
    n_devices: Optional[int] = None  # as TrainerConfig.n_devices
    skip_dataset_size_check: bool = False


class DiffusionTrainer:
    def __init__(self, config: DiffusionConfig, dataset=None, device=None):
        """Runs on the CUDA device unless `device` says otherwise: under a
        process group, the rank's own device."""
        self.config = config
        self.dp = make_mesh(config.n_devices, device)
        self.device = self.dp.device
        self.is_main = is_main_process()
        if config.train_batch_size % self.dp.world_size:
            raise ValueError(f"batch size {config.train_batch_size} must divide over "
                             f"{self.dp.world_size} ranks")
        self.dataset = dataset if dataset is not None else FEADataset(
            config.dataset_folder,
            image_size=config.dataset_image_size,
            conditions_per_plate=config.conditions_per_plate,
            num_steps=config.num_steps_per_condition,
        )
        if not config.skip_dataset_size_check and len(self.dataset) < 100:
            raise ValueError("you should have at least 100 samples; 10k+ recommended")
        self.sampler = EpochSampler(len(self.dataset), seed=config.seed)

        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.diffusion: GaussianDiffusion = make_diffusion_model(
            image_size=config.dataset_image_size,
            input_dim=config.input_dim,
            num_stages=config.num_stages,
            timesteps=config.timesteps,
            objective=config.objective,
            use_flash_attention=False,
            device=self.device,
            generator=self.generator,
        )
        model = self.diffusion.model
        self.names = [n for n, _ in model.named_parameters()]
        self.params = list(model.parameters())
        replicate(self.params)
        self.opt_state = adam_init(self.params)
        self.ema_params = [p.detach().clone() for p in self.params]
        self.step = 0
        self.results_folder = Path(config.results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def batch_condition(batch: Dict[str, np.ndarray]) -> np.ndarray:
        return np.concatenate(
            [batch["forces"], batch["constraints"], batch["materials"]], axis=-1
        )

    def _draws(self, x0):
        """t and the noise for the whole batch, drawn from the generator as
        GaussianDiffusion.loss draws them, and this rank's rows of each."""
        batch = x0.shape[0] * self.dp.world_size
        t = torch.randint(0, self.config.timesteps, (batch,), generator=self.generator,
                          device=self.device)
        noise = torch.randn((batch,) + tuple(x0.shape[1:]), generator=self.generator,
                            device=self.device, dtype=x0.dtype)
        rows = self.dp.rows(batch)
        return t[rows], noise[rows]

    @model_precision()
    def _train_step(self, x0, condition, t=None, noise=None) -> torch.Tensor:
        """One clipped Adam step and EMA update on this rank's rows; t and
        the noise are drawn from the trainer's generator unless both are
        given (as this rank's rows). Returns the loss, the mean over the
        ranks, as a device scalar."""
        if t is None and noise is None:
            t, noise = self._draws(x0)
        loss = self.diffusion.loss(x0, condition, self.generator, t=t, noise=noise)
        grads = list(torch.autograd.grad(loss, self.params))
        loss = loss.detach()
        all_reduce_mean(grads + [loss])
        grads = clip_by_global_norm(grads, 1.0)
        new_params, self.opt_state = adam_update(
            self.params, grads, self.opt_state, self.config.train_learning_rate
        )
        with torch.no_grad():
            torch._foreach_copy_(self.params, new_params)
        ema_update(self.ema_params, self.params, self.config.ema_decay)
        self.step += 1
        return loss

    def _fetch(self, offset: int):
        idx = self.sampler.indices_at(offset, self.config.train_batch_size)
        idx = idx[self.dp.rows(len(idx))]
        batch = collate([self.dataset[int(i)] for i in idx])
        to_device = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return to_device(batch["displacement"]), to_device(self.batch_condition(batch))

    def train(self, log_every: int = 10) -> Optional[float]:
        """Steps up to num_train_steps, a checkpoint at each milestone and
        'final' at the end; the last step's loss (None if none ran)."""
        cfg = self.config
        step = self.step
        loss = None
        while step < cfg.num_train_steps:
            x0, cond = self._fetch(step * cfg.train_batch_size)
            loss = self._train_step(x0, cond)
            if (step + 1) % log_every == 0:
                logging.info(f"diffusion step {step}: loss {float(loss):.4f}")
            if (step + 1) % cfg.num_steps_per_milestone == 0:
                self.save_checkpoint(step + 1)
            step += 1
        self.save_checkpoint("final")
        return None if loss is None else float(loss)

    @model_precision()
    def sample(self, condition, num_steps: Optional[int] = None, use_ema: bool = True,
               seed: int = 0) -> torch.Tensor:
        """DDPM samples for NHWC condition (B, H, W, 5), through the EMA
        weights unless use_ema is False; the noise comes from `seed`."""
        condition = torch.as_tensor(condition, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        if not use_ema:
            return self.diffusion.sample(condition, num_steps, generator=generator)
        raw = [p.detach().clone() for p in self.params]
        with torch.no_grad():
            torch._foreach_copy_(self.params, self.ema_params)
        try:
            return self.diffusion.sample(condition, num_steps, generator=generator)
        finally:
            with torch.no_grad():
                torch._foreach_copy_(self.params, raw)

    def _ckpt_path(self, milestone) -> Path:
        return self.results_folder / f"model-{milestone}" / "state.pt"

    def save_checkpoint(self, milestone):
        """Every rank joins the barriers; rank 0 writes."""
        sync_processes()
        if self.is_main:
            self._write_checkpoint(milestone)
        sync_processes()

    def _write_checkpoint(self, milestone):
        path = self._ckpt_path(milestone)
        if path.parent.exists():
            shutil.rmtree(path.parent)
        path.parent.mkdir(parents=True)
        torch.save({
            "params": self.diffusion.model.state_dict(),
            "opt_state": {"count": self.opt_state.count, "mu": self.opt_state.mu,
                          "nu": self.opt_state.nu},
            "ema_params": dict(zip(self.names, self.ema_params)),
            "generator": self.generator.get_state(),
            "step": self.step,
        }, path)

    def load_checkpoint(self, milestone):
        state = torch.load(self._ckpt_path(milestone), map_location=self.device,
                           weights_only=True)
        self.diffusion.model.load_state_dict(state["params"])
        opt = state["opt_state"]
        self.opt_state = AdamState(opt["count"], list(opt["mu"]), list(opt["nu"]))
        self.ema_params = [state["ema_params"][n] for n in self.names]
        self.generator.set_state(state["generator"].cpu())
        self.step = int(state["step"])
        opt = self.opt_state
        replicate([*self.params, opt.count, *opt.mu, *opt.nu, *self.ema_params])
