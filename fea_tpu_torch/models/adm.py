"""ADM, the "ablated diffusion model" UNet of Dhariwal & Nichol, "Diffusion
Models Beat GANs on Image Synthesis" (arXiv:2105.05233), as
openai/guided-diffusion's `guided_diffusion/unet.py` `UNetModel` builds it:
the pixel-space diffusion UNet that image-to-image models such as SR3 and
Palette condition by concatenating the source image with x_t.

The network at the flags of guided-diffusion's released 256x256
unconditional model (`make_adm_diffusion_model`'s defaults):
  model_channels 256, channel_mult (1, 1, 2, 2, 4, 4), num_res_blocks 2,
  attention at downsample rates 8, 16 and 32 (32, 16 and 8 px) in heads of
  64 channels, resblock_updown, use_scale_shift_norm, learn_sigma, no
  class embedding, no dropout.
Its parts, by guided-diffusion's names (so that its state dict's keys are
the ones here):
  * `ResBlock`: in_layers GroupNorm32 -> SiLU -> 3x3 conv, with nearest x2
    up- or 2x2 average down-sampling of both branches between the norm and
    the conv (`h_upd`, `x_upd`); the time embedding's SiLU -> Linear gives
    a scale and a shift, `GroupNorm32(h) * (1 + scale) + shift`, then
    SiLU -> 3x3 conv; a 1x1 conv on the skip where the width changes;
  * `AttentionBlock` in the legacy order: GroupNorm32, one 1x1 qkv
    convolution whose channels are (head, q/k/v, 64), softmax(q k^T / 8) v
    (guided-diffusion scales q and k by 64^-1/4 each), a 1x1 projection;
  * the sinusoidal embedding of t (cos first, then sin; frequencies
    10000^(-i/128)), then 256 -> 1024 -> 1024 with SiLU between;
  * the input, middle and output block lists, each output block taking
    the matching input block's output concatenated on the channels (up to
    2048 channels at 8 px);
  * GroupNorm with 32 groups and eps 1e-5, in f32.

The in-layers' GroupNorm+SiLU (and the output's) run the port's fused
kernel (`ops.fused_norm.group_norm_silu`, 32 groups, eps 1e-5); the
out-layers' GroupNorm, scale-shift and SiLU run its modulated forward
where no gradient is needed (`blocks.modulated_norm_silu`); attention runs
the flash kernel (`ops.flash_attention.flash_attention`) at head dim 64.
CPU tensors take the kernels' plain versions.

It departs from guided-diffusion's UNetModel in two ways:
  * 7 channels in, x_t's 2 displacement channels concatenated with the
    5-channel condition stack [forces(2), constraints(1), materials(2)]
    (the FEA task's concat conditioning), and 4 out: the noise estimate
    and the variance interpolant v of each displacement channel;
  * parameters in f32 with the port's TF32 convolutions
    (`utils.precision`) in place of `use_fp16`.

The forward takes and returns NHWC tensors, as the port's other models
do, and runs NCHW inside; inside a `graphed.scope` (the sampler's loop) it
is replayed from a CUDA graph where it can be.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.fused_norm import group_norm_silu
from . import graphed
from .blocks import modulated_norm_silu
from .initializers import materialize

GROUPS = 32
EPS = 1e-5  # torch.nn.GroupNorm's, which GroupNorm32 keeps
HEAD_CHANNELS = 64


def normalization(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GROUPS, channels, eps=EPS)


def norm_silu(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """silu(norm(x)) in one call of the fused kernel."""
    return group_norm_silu(x, norm.weight, norm.bias, GROUPS, EPS)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """guided-diffusion's sinusoidal embedding of t (B,): [cos, sin] of t
    times max_period^(-i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, channels: int, emb_channels: int, out_channels: int = None,
                 up: bool = False, down: bool = False):
        super().__init__()
        out_channels = out_channels or channels
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            normalization(channels), nn.SiLU(),
            nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels))
        self.out_layers = nn.Sequential(
            normalization(out_channels), nn.SiLU(), nn.Dropout(p=0.0),
            nn.Conv2d(out_channels, out_channels, 3, padding=1))
        if out_channels != channels:
            self.skip_connection = nn.Conv2d(channels, out_channels, 1)
        else:
            self.skip_connection = nn.Identity()

    def _resample(self, x):
        if self.up:
            return F.interpolate(x, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(x, kernel_size=2, stride=2)
        return x

    def forward(self, x, emb):
        h = norm_silu(self.in_layers[0], x)
        h = self.in_layers[2](self._resample(h))
        x = self._resample(x)
        scale, shift = self.emb_layers(emb)[..., None, None].chunk(2, dim=1)
        norm = self.out_layers[0]
        h = modulated_norm_silu(h, norm.weight, norm.bias, scale, shift, GROUPS, EPS)
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Self-attention over the pixels in heads of HEAD_CHANNELS, legacy
    channel order; one flash call."""

    def __init__(self, channels: int):
        super().__init__()
        if channels % HEAD_CHANNELS:
            raise ValueError(f"{channels} channels do not split into heads of {HEAD_CHANNELS}")
        self.num_heads = channels // HEAD_CHANNELS
        self.norm = normalization(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        n, bh = h * w, b * self.num_heads
        x = x.reshape(b, c, n)
        qkv = self.qkv(F.group_norm(x, GROUPS, self.norm.weight, self.norm.bias, EPS))
        # (b heads, q/k/v, d, n) -> (q/k/v, b heads, n, d), one copy
        q, k, v = qkv.reshape(bh, 3, HEAD_CHANNELS, n).permute(1, 0, 3, 2).contiguous()
        a = flash_attention(q, k, v, HEAD_CHANNELS**-0.5)
        a = a.transpose(1, 2).reshape(b, c, n)
        return (x + self.proj_out(a)).reshape(b, c, h, w)


class TimestepSequential(nn.Sequential):
    """guided-diffusion's TimestepEmbedSequential: the residual blocks
    take the embedding too."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class ADMUNet(nn.Module):
    """guided-diffusion's UNetModel at the flags of the module docstring,
    conditioned by concatenation: forward(x (B, H, W, 2), condition (B, H,
    W, 5), time (B,)) -> (B, H, W, 4), the noise estimate in channels 0-1
    and the variance interpolant v in 2-3."""

    # what GaussianDiffusion asks of a model: a time input, no
    # self-conditioning input, and a learned-range variance in its output
    use_time_embedding = True
    num_condition_channels = None
    learned_range = True

    def __init__(self, in_channels: int = 7, model_channels: int = 256,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (8, 16, 32),
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4)):
        super().__init__()
        self.model_channels = model_channels
        self.num_channels = out_channels // 2
        self.num_levels = len(channel_mult)
        emb = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))

        ch = input_ch = channel_mult[0] * model_channels
        self.input_blocks = nn.ModuleList(
            [TimestepSequential(nn.Conv2d(in_channels, ch, 3, padding=1))])
        skips, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, emb, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch))
                self.input_blocks.append(TimestepSequential(*layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepSequential(ResBlock(ch, emb, ch, down=True)))
                skips.append(ch)
                ds *= 2
        self.middle_block = TimestepSequential(ResBlock(ch, emb), AttentionBlock(ch),
                                               ResBlock(ch, emb))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), emb, model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, emb, ch, up=True))
                    ds //= 2
                self.output_blocks.append(TimestepSequential(*layers))
        self.out = nn.Sequential(normalization(ch), nn.SiLU(),
                                 nn.Conv2d(input_ch, out_channels, 3, padding=1))

    def forward(self, x, condition, time):
        """NHWC x and condition, time (B,). Inside a `graphed.scope` the
        forward is replayed from a CUDA graph where it can be."""
        runner = graphed.active()
        if runner is not None:
            return runner(self, self._forward, x, condition, time)
        return self._forward(x, condition, time)

    def _forward(self, x, condition, time):
        size = 2 ** (self.num_levels - 1)
        if x.shape[1] % size or x.shape[2] % size:
            raise ValueError(f"spatial dims {tuple(x.shape[1:3])} must be divisible by {size}")
        emb = self.time_embed(timestep_embedding(time, self.model_channels))
        h = torch.cat([x, condition], dim=-1).permute(0, 3, 1, 2).contiguous()
        skips = []
        for block in self.input_blocks:
            h = block(h, emb)
            skips.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, skips.pop()], dim=1), emb)
        h = self.out[2](norm_silu(self.out[0], h))
        return h.permute(0, 2, 3, 1)


def zero_modules(model: ADMUNet):
    """The convolutions that guided-diffusion initializes to zero
    (`zero_module`): each ResBlock's last, each attention's projection and
    the output's."""
    for m in model.modules():
        if isinstance(m, ResBlock):
            yield m.out_layers[3]
        elif isinstance(m, AttentionBlock):
            yield m.proj_out
    yield model.out[2]


def make_adm_diffusion_model(image_size: int = 256, timesteps: int = 1000,
                             beta_schedule: str = "linear", *, device,
                             generator: torch.Generator, **kw):
    """GaussianDiffusion over an ADMUNet (`**kw` goes to it) with the
    learned-range variance, on `device`, for images of `image_size` (the
    network's shapes do not depend on it). The weights are drawn from
    `generator` as `materialize` draws the FDN-UNet's, and the
    `zero_modules` then zeroed, as guided-diffusion initializes them."""
    from .diffusion import GaussianDiffusion

    with torch.device("meta"):
        model = ADMUNet(**kw)
    materialize(model, device, generator)
    with torch.no_grad():
        for m in zero_modules(model):
            for p in m.parameters():
                p.zero_()
    return GaussianDiffusion(model, timesteps=timesteps, beta_schedule=beta_schedule)
