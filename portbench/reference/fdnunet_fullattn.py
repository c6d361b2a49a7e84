"""The full-attention, self-conditioned FDN-UNet DDPM in plain PyTorch: the
benchmark's reference for the configuration `ddpm_selfcond_fullattn`.

fea-diffusion's monolithic denoiser (model/fdnunet.py:381, `Denoiser` in
fdnunet.py here, whose building blocks this file reuses) with two of its
upstream's public settings on: full attention at every stage and the
middle (lucidrains' denoising-diffusion-pytorch `Unet(full_attn=True)`),
and self-conditioning (`GaussianDiffusion(self_condition=True)`; Chen,
Zhang & Hinton 2022, "Analog Bits"): the model's input is x and an
estimate of x0 concatenated, [x, x_self] on the channel axis, zeros where
there is no estimate. The sampler feeds each step the last step's clamped
x0 estimate; the loss, on a coin under 0.5, first estimates x0 under
no_grad (unclamped) and feeds it detached.

Attention is computed a block of queries at a time, so that at 256 px
(65,536 queries over 65,540 keys, 17 GB of f32 scores a head and image)
each block's scores stay under `SCORES_BYTES`; every row is
fdnunet.FullAttention's softmax(q k^T / sqrt(d)) v, the scale applied in
the product. Imports nothing of the program under test.
"""

import numpy as np
import torch
from torch import nn

from . import fdnunet

KIND = "ddpm_selfcond_fullattn"
SCORES_BYTES = 8 * 10**9  # one block's scores, (B, heads, rows, keys)


class BlockedFullAttention(fdnunet.FullAttention):
    """fdnunet.FullAttention over blocks of query rows: each block's
    scores take at most `scores_bytes` (at least one row a block)."""

    scores_bytes = SCORES_BYTES

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, self.head_dim, h * w).transpose(-1, -2)
                   for t in self.Conv_0(self.RMSNorm_0(x)).chunk(3, dim=1))
        k = torch.cat([self.memory_kv[0].expand(b, -1, -1, -1), k], dim=-2)
        v = torch.cat([self.memory_kv[1].expand(b, -1, -1, -1), v], dim=-2)
        bh, n, nk = b * self.heads, h * w, k.shape[-2]
        q, keys, v = q.reshape(bh, n, -1), k.transpose(-1, -2).reshape(bh, -1, nk), \
            v.reshape(bh, nk, -1)
        rows = max(1, int(self.scores_bytes // (bh * nk * q.element_size())))
        zero, out = q.new_zeros(()), []
        for s in range(0, n, rows):
            qb = q[:, s:s + rows]
            # the scale in the product's epilogue: one pass over the scores
            # fewer than (q k^T) * scale, within an ulp of it
            scores = torch.baddbmm(zero, qb, keys, beta=0.0, alpha=self.head_dim**-0.5)
            out.append(torch.softmax(scores, dim=-1) @ v)
            del scores
        out = torch.cat(out, dim=1).reshape(b, self.heads, n, -1)
        return self.Conv_1(out.transpose(-1, -2).reshape(b, -1, h, w))


class SelfCondFullAttentionDenoiser(fdnunet.Denoiser):
    """fdnunet.Denoiser with BlockedFullAttention at every stage and the
    middle, and an initial convolution over [x, x_self]."""

    def __init__(self, input_dim=64, num_stages=4, num_channels=2, aux_channels=5,
                 num_groups=8, heads=4, head_dim=32):
        super().__init__(input_dim, num_stages, num_channels, aux_channels, num_groups, heads,
                         head_dim)
        dims = fdnunet.stage_dims(input_dim, num_stages)
        # replaced in place: the parameters keep the program's names and order
        self.initial_conv = fdnunet.conv3x3(2 * num_channels, dims[0])
        for name, module in list(self.named_children()):
            if isinstance(module, (fdnunet.LinearAttention, fdnunet.FullAttention)):
                setattr(self, name, BlockedFullAttention(module.Conv_1.out_channels, heads,
                                                         head_dim))

    def forward(self, x, condition, time, x_self=None):
        if x_self is None:
            x_self = torch.zeros_like(x)
        return super().forward(torch.cat([x, x_self], dim=-1), condition, time)


def build(config: dict, device="meta") -> dict:
    """The reference module of a configuration file's `model` entry of
    kind `ddpm_selfcond_fullattn`, by the program's module name, on
    `device` without weights."""
    model = config["model"]
    if model["kind"] != KIND:
        raise ValueError(f"{__name__} builds {KIND!r}, not {model['kind']!r}")
    with torch.device(device):
        return {"model": SelfCondFullAttentionDenoiser(
            input_dim=model["input_dim"], num_stages=model["num_stages"],
            num_channels=model["num_channels"],
            aux_channels=model["num_auxiliary_condition_channels"],
            num_groups=model["num_groups"], heads=model["num_attention_heads"],
            head_dim=model["attention_head_dim"],
        )}


def x0_estimate(schedule, t: int, x: torch.Tensor, eps: torch.Tensor, clamp=True):
    """x0 from the state x at time t and the predicted noise eps, clamped
    to [-1, 1] as the sampler feeds it (unclamped as the loss feeds it)."""
    a = float(max(schedule.sqrt_ab[t], np.float32(1e-8)))
    x0 = (x - float(schedule.sqrt_1mab[t]) * eps) / a
    return x0.clamp(-1.0, 1.0) if clamp else x0


@torch.no_grad()
def sample(net: nn.Module, schedule, condition, noise, times) -> tuple:
    """The self-conditioned strided sampler from noise[0] over `times`,
    noise[i + 1] step i's fresh noise: (output, [(x_i, x_self_i, eps_i)]
    a step)."""
    from .diffusion import update

    x = noise[0]
    x_self = torch.zeros_like(x)
    steps = []
    for i, t in enumerate(times):
        eps = net(x, condition, torch.full((x.shape[0],), float(t), device=x.device), x_self)
        steps.append((x, x_self, eps))
        x_self = x0_estimate(schedule, t, x, eps)
        x = update(schedule, t, x, eps, noise[i + 1] if t else None)
    return x, steps


def loss(net: nn.Module, schedule, x0, condition, t, noise, coin: float):
    """The pred_noise loss at integer times t (B,) with the given noise:
    on coin < 0.5 the x0 estimate of a no_grad forward (unclamped) is fed
    detached, else zeros."""
    ab = torch.from_numpy(schedule.sqrt_ab).to(x0.device)[t][:, None, None, None]
    s = torch.from_numpy(schedule.sqrt_1mab).to(x0.device)[t][:, None, None, None]
    x_t = ab * x0 + s * noise
    time = t.float()
    x_self = None
    if coin < 0.5:
        with torch.no_grad():
            x_self = ((x_t - s * net(x_t, condition, time)) / ab.clamp_min(1e-8)).detach()
    return torch.mean((net(x_t, condition, time, x_self) - noise) ** 2)
