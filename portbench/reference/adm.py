"""ADM in plain PyTorch: the benchmark's reference for openai/guided-diffusion's
`guided_diffusion/unet.py` `UNetModel` at the flags of its 256x256
unconditional model (num_channels 256, channel_mult 1,1,2,2,4,4,
num_res_blocks 2, attention at 32, 16 and 8 px in heads of 64 channels,
resblock_updown, use_scale_shift_norm, learn_sigma), conditioned by
concatenation: 7 channels in (x_t's 2 and the 5-channel condition stack),
4 out (the noise estimate and the variance interpolant of each channel).

Written with torch.nn layers and functional ops alone: GroupNorm then SiLU
as two operations, attention as guided-diffusion's QKVAttentionLegacy
(q and k each scaled by ch^-1/4, two einsums and a softmax). It imports
nothing of the program under test. Parameter names are guided-diffusion's
(`input_blocks.1.0.in_layers.0.weight`, ...), the program's too, so one set
of weights made by the benchmark loads into both by name. NHWC at the
boundary, NCHW inside. Its runs on the card are strict f32, TF32 off for
matmuls and convolutions (`fdnunet.strict_f32`, the flags' current API:
the legacy `allow_tf32` cannot be read once that API is set).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

GROUPS, EPS, HEAD_CHANNELS = 32, 1e-5, 64


def group_norm(norm, x):
    """GroupNorm32: in f32 whatever x's type, as guided-diffusion keeps it
    under use_fp16."""
    return F.group_norm(x.float(), GROUPS, norm.weight.float(), norm.bias.float(),
                        EPS).type(x.dtype)


class ResBlock(nn.Module):
    def __init__(self, channels, emb_channels, out_channels=None, up=False, down=False):
        super().__init__()
        out_channels = out_channels or channels
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(nn.GroupNorm(GROUPS, channels), nn.SiLU(),
                                       nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels))
        self.out_layers = nn.Sequential(nn.GroupNorm(GROUPS, out_channels), nn.SiLU(),
                                        nn.Dropout(p=0.0),
                                        nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (nn.Identity() if out_channels == channels
                                else nn.Conv2d(channels, out_channels, 1))

    def updown(self, x):
        if self.up:
            return F.interpolate(x, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(x, kernel_size=2, stride=2)
        return x

    def forward(self, x, emb):
        h = F.silu(group_norm(self.in_layers[0], x))
        h = self.in_layers[2](self.updown(h))
        x = self.updown(x)
        emb_out = self.emb_layers(emb)[:, :, None, None]
        scale, shift = torch.chunk(emb_out, 2, dim=1)
        h = group_norm(self.out_layers[0], h) * (1 + scale) + shift
        h = self.out_layers[3](F.silu(h))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.num_heads = channels // HEAD_CHANNELS
        self.norm = nn.GroupNorm(GROUPS, channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        b, c, *spatial = x.shape
        x = x.reshape(b, c, -1)
        qkv = self.qkv(group_norm(self.norm, x))
        bs, width, length = qkv.shape
        ch = width // (3 * self.num_heads)
        q, k, v = qkv.reshape(bs * self.num_heads, ch * 3, length).split(ch, dim=1)
        scale = 1 / math.sqrt(math.sqrt(ch))
        weight = torch.einsum("bct,bcs->bts", q * scale, k * scale)
        weight = torch.softmax(weight.float(), dim=-1).type(weight.dtype)
        a = torch.einsum("bts,bcs->bct", weight, v).reshape(bs, -1, length)
        return (x + self.proj_out(a)).reshape(b, c, *spatial)


def timestep_embedding(timesteps, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(start=0, end=half, dtype=torch.float32) / half
                      ).to(device=timesteps.device)
    args = timesteps[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ADM(nn.Module):
    def __init__(self, in_channels=7, model_channels=256, out_channels=4, num_res_blocks=2,
                 attention_ds=(8, 16, 32), channel_mult=(1, 1, 2, 2, 4, 4)):
        super().__init__()
        self.model_channels = model_channels
        emb = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))
        ch = input_ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(in_channels, ch, 3,
                                                                    padding=1)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, emb, int(mult * model_channels))]
                ch = int(mult * model_channels)
                if ds in attention_ds:
                    layers.append(AttentionBlock(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([ResBlock(ch, emb, ch, down=True)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, emb), AttentionBlock(ch),
                                           ResBlock(ch, emb)])
        self.output_blocks = nn.ModuleList([])
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), emb, int(model_channels * mult))]
                ch = int(model_channels * mult)
                if ds in attention_ds:
                    layers.append(AttentionBlock(ch))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, emb, ch, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(nn.GroupNorm(GROUPS, ch), nn.SiLU(),
                                 nn.Conv2d(input_ch, out_channels, 3, padding=1))

    @staticmethod
    def run(layers, h, emb):
        for layer in layers:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h

    def forward(self, x, condition, time):
        """NHWC x (B, H, W, 2) and condition (B, H, W, 5), time (B,) ->
        NHWC (B, H, W, 4)."""
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(time, self.model_channels).to(dtype))
        h = torch.cat([x, condition], dim=-1).permute(0, 3, 1, 2)
        hs = []
        for module in self.input_blocks:
            h = self.run(module, h, emb)
            hs.append(h)
        h = self.run(self.middle_block, h, emb)
        for module in self.output_blocks:
            h = self.run(module, torch.cat([h, hs.pop()], dim=1), emb)
        h = self.out[2](F.silu(group_norm(self.out[0], h)))
        return h.permute(0, 2, 3, 1)


def build(config: dict, device="meta") -> dict:
    """{"model": the reference} of a configuration file's `model` entry
    (kind "adm"), on `device` without weights."""
    model = config["model"]
    if model["kind"] != "adm":
        raise ValueError(f"no ADM reference for model kind {model['kind']!r}")
    size = model["image_size"]
    with torch.device(device):
        return {"model": ADM(
            in_channels=model["num_channels"] + model["num_auxiliary_condition_channels"],
            model_channels=model["model_channels"],
            out_channels=2 * model["num_channels"],
            num_res_blocks=model["num_res_blocks"],
            attention_ds=tuple(size // r for r in model["attention_resolutions"]),
            channel_mult=tuple(model["channel_mult"]),
        )}
