"""The FDN-UNet family in plain PyTorch: the benchmark's own reference.

A frozen copy of the architecture that fea-diffusion publishes
(model/fdnunetwithaux.py for the regression encoder and decoder,
model/fdnunet.py for the monolithic denoiser with attention), written with
torch.nn layers and functional ops alone: no hand-written kernel, no
fused GroupNorm+SiLU, no flash attention (softmax(q k^T) v as two matmuls).
It imports nothing of the program under test. Parameter names follow the
program's state dict, so one set of weights made by the benchmark loads
into both by name.

Tensors are NHWC at the model boundary and NCHW inside, as in the program.
"""

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm's epsilon, which the model keeps


def conv3x3(in_dim, out_dim):
    return nn.Conv2d(in_dim, out_dim, 3, padding=1)


def conv1x1(in_dim, out_dim, bias=True):
    return nn.Conv2d(in_dim, out_dim, 1, bias=bias)


def stage_dims(input_dim, num_stages):
    return [input_dim] + [input_dim * (2**i) for i in range(num_stages)]


def amax_normalize(x, eps=1e-4, route=None):
    """x over its signed spatial maximum per channel, the divisor kept at
    least eps away from zero with its sign. The maximum's gradient flows
    through its argmax, or, given `route` (B, C) of flat pixel indices,
    through those pixels: at a near-tie any of the tied pixels is a valid
    choice, and rounding decides which one a program takes."""
    m = x.amax(dim=(2, 3), keepdim=True)
    if route is not None:
        b, c, h, w = x.shape
        chosen = x.reshape(b, c, h * w).gather(2, route.reshape(b, c, 1)).reshape(b, c, 1, 1)
        m = chosen + (m - chosen).detach()
    m = torch.where(m >= 0, m.clamp_min(eps), m.clamp_max(-eps))
    return x / m


class Downsample(nn.Module):
    """2x2 space-to-depth, channel (2 p1 + p2) C + c, then a 1x1 conv."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.Conv_0 = conv1x1(4 * in_dim, out_dim)

    def forward(self, x):
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
        return self.Conv_0(x.reshape(b, 4 * c, h // 2, w // 2))


class Upsample(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.Conv_0 = conv3x3(in_dim, out_dim)

    def forward(self, x):
        return self.Conv_0(F.interpolate(x, scale_factor=2, mode="nearest"))


class FeatureDenormalization(nn.Module):
    """GroupNorm without affine, scale and shift from the condition
    features, SiLU."""

    def __init__(self, dim, feature_dim, num_groups=8):
        super().__init__()
        self.num_groups = num_groups
        self.scale_conv = conv3x3(feature_dim, dim)
        self.shift_conv = conv3x3(feature_dim, dim)

    def forward(self, x, features):
        x = F.group_norm(x, self.num_groups, eps=GROUP_NORM_EPS)
        return F.silu(x * (self.scale_conv(features) + 1.0) + self.shift_conv(features))


class ConditionFeatureExtractor(nn.Module):
    """Conv stem 32, 64, 128, 128, dims[0]; then one head per stage."""

    STEM = (32, 64, 128, 128)

    def __init__(self, in_dim, dims: Sequence[int]):
        super().__init__()
        pairs = list(zip(dims[:-1], dims[1:]))
        width, n = in_dim, 0
        for out in self.STEM + (dims[0],):
            self.add_module(f"Conv_{n}", conv3x3(width, out))
            n, width = n + 1, out
        self.stem = [f"Conv_{i}" for i in range(n)]
        self.heads = []
        for index, (head_in, out) in enumerate(pairs):
            if index == len(pairs) - 1:
                name = f"Conv_{n}"
                self.add_module(name, conv3x3(head_in, out))
            else:
                name = f"Downsample_{index}"
                self.add_module(name, Downsample(head_in, out))
            self.heads.append(name)

    def forward(self, x) -> List[torch.Tensor]:
        for name in self.stem:
            x = F.silu(getattr(self, name)(x))
        features = [x]
        for name in self.heads:
            x = F.silu(getattr(self, name)(x))
            features.append(x)
        return features


class LeanResnetSubBlock(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.Conv_0 = conv3x3(in_dim, out_dim)

    def forward(self, x, scale_shift=None):
        x = self.Conv_0(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetSubBlock(nn.Module):
    """Conv, GroupNorm with affine, optional time scale-shift, SiLU."""

    def __init__(self, in_dim, out_dim, num_groups=8):
        super().__init__()
        self.Conv_0 = conv3x3(in_dim, out_dim)
        self.GroupNorm_0 = nn.GroupNorm(num_groups, out_dim, eps=GROUP_NORM_EPS)

    def forward(self, x, scale_shift=None):
        x = self.GroupNorm_0(self.Conv_0(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ConditionedResnetBlock(nn.Module):
    def __init__(self, in_dim, out_dim, use_fdn=True, num_groups=8, feature_dim=None,
                 time_dim=None):
        super().__init__()
        self.use_fdn = use_fdn
        if use_fdn:
            self.fdn1 = FeatureDenormalization(in_dim, feature_dim, num_groups)
            self.block1 = LeanResnetSubBlock(in_dim, out_dim)
            self.fdn2 = FeatureDenormalization(out_dim, feature_dim, num_groups)
            self.block2 = LeanResnetSubBlock(out_dim, out_dim)
        else:
            self.block1 = ResnetSubBlock(in_dim, out_dim, num_groups)
            self.block2 = ResnetSubBlock(out_dim, out_dim, num_groups)
        if time_dim is not None:
            self.Dense_0 = nn.Linear(time_dim, 2 * out_dim)
        if in_dim != out_dim:
            self.residual_conv = conv1x1(in_dim, out_dim)

    def forward(self, x, features=None, time_embedding=None):
        h = x
        if self.use_fdn:
            h = self.fdn1(h, features)
        scale_shift = None
        if time_embedding is not None:
            emb = self.Dense_0(F.silu(time_embedding))[:, :, None, None]
            scale_shift = emb.chunk(2, dim=1)
        h = self.block1(h, scale_shift)
        if self.use_fdn:
            h = self.fdn2(h, features)
        h = self.block2(h)
        if hasattr(self, "residual_conv"):
            x = self.residual_conv(x)
        return h + x


class RMSNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        return x * math.sqrt(x.shape[1]) / norm * self.g


class LinearAttention(nn.Module):
    """softmax over d of q, softmax over n of k, with 4 memory key-value
    slots kept as (2, heads, head_dim, mem)."""

    def __init__(self, dim, heads=4, head_dim=32, mem=4):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        hd = heads * head_dim
        self.RMSNorm_0 = RMSNorm(dim)
        self.Conv_0 = conv1x1(dim, 3 * hd, bias=False)
        self.memory_kv = nn.Parameter(torch.empty(2, heads, head_dim, mem))
        self.Conv_1 = conv1x1(hd, dim)
        self.RMSNorm_1 = RMSNorm(dim)

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, self.head_dim, h * w)
                   for t in self.Conv_0(self.RMSNorm_0(x)).chunk(3, dim=1))
        k = torch.cat([self.memory_kv[0].expand(b, -1, -1, -1), k], dim=-1)
        v = torch.cat([self.memory_kv[1].expand(b, -1, -1, -1), v], dim=-1)
        q = torch.softmax(q, dim=-2) * self.head_dim**-0.5
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.RMSNorm_1(self.Conv_1(out.reshape(b, -1, h, w)))


class FullAttention(nn.Module):
    """softmax(q k^T / sqrt(d)) v over the pixels, with 4 memory key-value
    slots, kept as (2, heads, mem, head_dim), before the pixels' keys."""

    def __init__(self, dim, heads=4, head_dim=32, mem=4):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        hd = heads * head_dim
        self.RMSNorm_0 = RMSNorm(dim)
        self.Conv_0 = conv1x1(dim, 3 * hd, bias=False)
        self.memory_kv = nn.Parameter(torch.empty(2, heads, mem, head_dim))
        self.Conv_1 = conv1x1(hd, dim)

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, self.head_dim, h * w).transpose(-1, -2)
                   for t in self.Conv_0(self.RMSNorm_0(x)).chunk(3, dim=1))
        k = torch.cat([self.memory_kv[0].expand(b, -1, -1, -1), k], dim=-2)
        v = torch.cat([self.memory_kv[1].expand(b, -1, -1, -1), v], dim=-2)
        scores = (q @ k.transpose(-1, -2)) * self.head_dim**-0.5
        out = torch.softmax(scores, dim=-1) @ v
        return self.Conv_1(out.transpose(-1, -2).reshape(b, -1, h, w))


class TimeEmbedding(nn.Module):
    """Sinusoidal embedding of dim input_dim, Dense, tanh-GELU, Dense."""

    def __init__(self, input_dim):
        super().__init__()
        self.input_dim = input_dim
        self.Dense_0 = nn.Linear(2 * (input_dim // 2), 4 * input_dim)
        self.Dense_1 = nn.Linear(4 * input_dim, 4 * input_dim)

    def forward(self, t):
        half = self.input_dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * -(math.log(10000) / (half - 1)))
        angles = t[:, None] * freq[None, :]
        x = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
        x = x.to(self.Dense_0.weight.dtype)
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Encoder(nn.Module):
    """The regression surrogate's down path and middle."""

    def __init__(self, input_dim=64, num_stages=4, num_channels=2, aux_channels=3,
                 num_groups=8):
        super().__init__()
        self.num_stages = num_stages
        dims = stage_dims(input_dim, num_stages)
        self.initial_conv = conv3x3(num_channels, dims[0])
        self.condition_feature_extractor = ConditionFeatureExtractor(aux_channels, dims)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            for name in (f"down{i}_block1", f"down{i}_block2"):
                self.add_module(name, ConditionedResnetBlock(a, a, num_groups=num_groups,
                                                             feature_dim=a))
            if i == num_stages - 1:
                self.add_module(f"down{i}_conv", conv3x3(a, b))
            else:
                self.add_module(f"down{i}_downsample", Downsample(a, b))
        for name in ("middle_block_1", "middle_block_2"):
            self.add_module(name, ConditionedResnetBlock(dims[-1], dims[-1], num_groups=num_groups,
                                                         feature_dim=dims[-1]))

    def forward(self, x, condition):
        x = self.initial_conv(nchw(x))
        residual = x
        features = self.condition_feature_extractor(nchw(condition))
        hidden = []
        for i in range(self.num_stages):
            x = getattr(self, f"down{i}_block1")(x, features[i])
            hidden.append(x)
            x = getattr(self, f"down{i}_block2")(x, features[i])
            hidden.append(x)
            last = i == self.num_stages - 1
            x = getattr(self, f"down{i}_conv" if last else f"down{i}_downsample")(x)
        x = self.middle_block_1(x, features[-1])
        x = self.middle_block_2(x, features[-1])
        return x, hidden, residual


class Decoder(nn.Module):
    """The regression surrogate's up path, skip concatenations and amax
    output normalization."""

    def __init__(self, input_dim=64, num_stages=4, num_channels=2, num_groups=8):
        super().__init__()
        self.num_stages = num_stages
        dims = stage_dims(input_dim, num_stages)
        for i, (a, b) in enumerate(reversed(list(zip(dims[:-1], dims[1:])))):
            for name in (f"up{i}_block1", f"up{i}_block2"):
                self.add_module(name, ConditionedResnetBlock(b + a, b, use_fdn=False,
                                                             num_groups=num_groups))
            if i == num_stages - 1:
                self.add_module(f"up{i}_conv", conv3x3(b, a))
            else:
                self.add_module(f"up{i}_upsample", Upsample(b, a))
        self.final_resnet = ConditionedResnetBlock(2 * dims[0], dims[0], use_fdn=False,
                                                   num_groups=num_groups)
        self.final_conv = conv1x1(dims[0], num_channels)

    def forward(self, x, hidden, residual, route=None, raw=False):
        """The normalized output, its maximum's gradient through `route`
        (amax_normalize); with raw, the NCHW output before normalizing."""
        hidden = list(hidden)
        for i in range(self.num_stages):
            x = getattr(self, f"up{i}_block1")(torch.cat([x, hidden.pop()], dim=1))
            x = getattr(self, f"up{i}_block2")(torch.cat([x, hidden.pop()], dim=1))
            last = i == self.num_stages - 1
            x = getattr(self, f"up{i}_conv" if last else f"up{i}_upsample")(x)
        x = self.final_conv(self.final_resnet(torch.cat([x, residual], dim=1)))
        return x if raw else nhwc(amax_normalize(x, route=route))


def regression_prediction(encoder, decoder, batch, route=None):
    """The image head of the regression surrogate on an NHWC batch, with
    the geometry remask of its signed output."""
    condition = torch.cat([batch["forces"], batch["constraints"]], dim=-1)
    image = decoder(*encoder(batch["materials"], condition), route=route)
    geometry01 = (batch["geometry"] + 1.0) / 2.0
    return ((image + 1.0) / 2.0 * geometry01) * 2.0 - 1.0


def regression_output(encoder, decoder, batch):
    """The decoder's NCHW output before its amax normalization."""
    condition = torch.cat([batch["forces"], batch["constraints"]], dim=-1)
    return decoder(*encoder(batch["materials"], condition), raw=True)


class Denoiser(nn.Module):
    """The monolithic FDN-UNet of the DDPM: time-conditioned blocks, linear
    attention at the outer stages and full attention at the innermost stage
    and the middle."""

    def __init__(self, input_dim=64, num_stages=4, num_channels=2, aux_channels=5,
                 num_groups=8, heads=4, head_dim=32):
        super().__init__()
        self.num_stages = num_stages
        dims = stage_dims(input_dim, num_stages)
        pairs = list(zip(dims[:-1], dims[1:]))
        time_dim = 4 * input_dim

        def attention(full, dim):
            return (FullAttention if full else LinearAttention)(dim, heads, head_dim)

        def block(a, b, use_fdn=True):
            return ConditionedResnetBlock(a, b, use_fdn=use_fdn, num_groups=num_groups,
                                          feature_dim=a if use_fdn else None, time_dim=time_dim)

        self.TimeEmbeddingMLP_0 = TimeEmbedding(input_dim)
        self.initial_conv = conv3x3(num_channels, dims[0])
        self.condition_feature_extractor = ConditionFeatureExtractor(aux_channels, dims)
        for i, (a, b) in enumerate(pairs):
            self.add_module(f"down{i}_block1", block(a, a))
            self.add_module(f"down{i}_block2", block(a, a))
            self.add_module(f"down{i}_attention", attention(i == num_stages - 1, a))
            if i == num_stages - 1:
                self.add_module(f"down{i}_conv", conv3x3(a, b))
            else:
                self.add_module(f"down{i}_downsample", Downsample(a, b))
        self.middle_block_1 = block(dims[-1], dims[-1])
        self.middle_attention = attention(True, dims[-1])
        self.middle_block_2 = block(dims[-1], dims[-1])
        for i, (a, b) in enumerate(reversed(pairs)):
            self.add_module(f"up{i}_block1", block(b + a, b, False))
            self.add_module(f"up{i}_block2", block(b + a, b, False))
            self.add_module(f"up{i}_attention", attention(i == 0, b))
            if i == num_stages - 1:
                self.add_module(f"up{i}_conv", conv3x3(b, a))
            else:
                self.add_module(f"up{i}_upsample", Upsample(b, a))
        self.final_resnet = block(2 * dims[0], dims[0], False)
        self.final_conv = conv1x1(dims[0], num_channels)

    def forward(self, x, condition, time):
        emb = self.TimeEmbeddingMLP_0(time)
        x = self.initial_conv(nchw(x))
        residual = x
        features = self.condition_feature_extractor(nchw(condition))
        hidden = []
        for i in range(self.num_stages):
            x = getattr(self, f"down{i}_block1")(x, features[i], emb)
            hidden.append(x)
            x = getattr(self, f"down{i}_block2")(x, features[i], emb)
            x = getattr(self, f"down{i}_attention")(x) + x
            hidden.append(x)
            last = i == self.num_stages - 1
            x = getattr(self, f"down{i}_conv" if last else f"down{i}_downsample")(x)
        x = self.middle_block_1(x, features[-1], emb)
        x = self.middle_attention(x) + x
        x = self.middle_block_2(x, features[-1], emb)
        for i in range(self.num_stages):
            x = getattr(self, f"up{i}_block1")(torch.cat([x, hidden.pop()], dim=1), None, emb)
            x = getattr(self, f"up{i}_block2")(torch.cat([x, hidden.pop()], dim=1), None, emb)
            x = getattr(self, f"up{i}_attention")(x) + x
            last = i == self.num_stages - 1
            x = getattr(self, f"up{i}_conv" if last else f"up{i}_upsample")(x)
        x = self.final_resnet(torch.cat([x, residual], dim=1), None, emb)
        return nhwc(amax_normalize(self.final_conv(x)))


def build(config: dict, device="meta") -> dict:
    """The reference modules of a configuration file's `model` entry, by
    the program's module names, on `device` without weights."""
    model = config["model"]
    kind = model["kind"]
    with torch.device(device):
        if kind == "regression":
            common = dict(input_dim=model["input_dim"], num_stages=model["num_stages"],
                          num_channels=model["num_channels"], num_groups=model["num_groups"])
            return {
                "encoder": Encoder(aux_channels=model["num_auxiliary_condition_channels"],
                                   **common),
                "decoder": Decoder(**common),
            }
        if kind == "ddpm":
            return {"model": Denoiser(
                input_dim=model["input_dim"], num_stages=model["num_stages"],
                num_channels=model["num_channels"],
                aux_channels=model["num_auxiliary_condition_channels"],
                num_groups=model["num_groups"], heads=model["num_attention_heads"],
                head_dim=model["attention_head_dim"],
            )}
    raise ValueError(f"no reference for model kind {kind!r}")


def strict_f32():
    """Matmuls and cuDNN convolutions in IEEE f32, for the reference's own
    runs; returns a function that restores the settings it found."""
    matmul = torch.backends.cuda.matmul.fp32_precision
    conv = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"

    def restore():
        torch.backends.cuda.matmul.fp32_precision = matmul
        torch.backends.cudnn.conv.fp32_precision = conv

    return restore

