"""FDN-UNet building blocks, the port of fea_tpu/models/blocks.py.

These modules take and return NCHW tensors; the public model functions in
fdnunet.py take NHWC (fea_tpu's layout) and permute once. Submodule names
follow the flax names of fea_tpu (`Conv_0`, `GroupNorm_0`, `Dense_0`, ...),
so that convert.from_flax maps a flax param tree onto the state dict by path.
Channel counts that flax infers at init are explicit constructor arguments.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_norm import (
    group_norm_modulated_silu, group_norm_modulated_silu_reference, group_norm_silu, needs_grad,
)

GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm's epsilon; torch's default is 1e-5


def modulated_norm_silu(x, gamma, beta, scale, shift, num_groups: int, eps: float):
    """silu(GroupNorm(x, gamma, beta) * (scale + 1) + shift): the fused
    forward where no gradient is needed (its CUDA kernel for CUDA tensors),
    else PyTorch's chain, through which autograd runs."""
    fn = (group_norm_modulated_silu_reference if needs_grad(x, gamma, beta, scale, shift)
          else group_norm_modulated_silu)
    return fn(x, gamma, beta, scale, shift, num_groups, eps)


def conv3x3(in_dim: int, out_dim: int) -> nn.Conv2d:
    return nn.Conv2d(in_dim, out_dim, 3, padding=1)


def conv1x1(in_dim: int, out_dim: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_dim, out_dim, 1, bias=bias)


def amax_normalize(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """x / max(x) over the spatial dims of NCHW x, with fea_tpu's
    sign-preserving clamp of the divisor away from zero."""
    m = x.amax(dim=(2, 3), keepdim=True)
    m = torch.where(m >= 0, m.clamp_min(eps), m.clamp_max(-eps))
    return x / m


class Downsample(nn.Module):
    """Space-to-depth (2x2) then 1x1 conv."""

    def __init__(self, in_dim: int, output_dim: int):
        super().__init__()
        self.Conv_0 = conv1x1(4 * in_dim, output_dim)

    def forward(self, x):
        # fea_tpu's channel order (p1, p2, c): channel (2 p1 + p2) C + c;
        # F.pixel_unshuffle would give (c, p1, p2)
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
        return self.Conv_0(x.reshape(b, 4 * c, h // 2, w // 2))


class Upsample(nn.Module):
    """Nearest 2x upsample then 3x3 conv."""

    def __init__(self, in_dim: int, output_dim: int):
        super().__init__()
        self.Conv_0 = conv3x3(in_dim, output_dim)

    def forward(self, x):
        return self.Conv_0(F.interpolate(x, scale_factor=2, mode="nearest"))


class FeatureDenormalization(nn.Module):
    """Parameter-free GroupNorm, then per-pixel scale/shift predicted from
    condition features by 3x3 convs, then SiLU (`modulated_norm_silu`)."""

    def __init__(self, dim: int, feature_dim: int, num_groups: int = 8):
        super().__init__()
        self.num_groups = num_groups
        self.scale_conv = conv3x3(feature_dim, dim)
        self.shift_conv = conv3x3(feature_dim, dim)

    def forward(self, x, features):
        if features.shape[2:] != x.shape[2:]:
            raise ValueError("features must share spatial dims with x")
        scale = self.scale_conv(features)
        shift = self.shift_conv(features)
        return modulated_norm_silu(x, None, None, scale, shift, self.num_groups, GROUP_NORM_EPS)


class ConditionFeatureExtractor(nn.Module):
    """Condition pyramid: conv stem 32->64->128->128, then one head per
    UNet stage at that stage's resolution and width."""

    STEM = (32, 64, 128, 128)

    def __init__(self, in_dim: int, stagewise_dimensions: Sequence[int]):
        super().__init__()
        dims = list(stagewise_dimensions)
        pairs = list(zip(dims[:-1], dims[1:]))
        width = in_dim
        convs = 0
        for out in self.STEM + (dims[0],):
            self.add_module(f"Conv_{convs}", conv3x3(width, out))
            convs += 1
            width = out
        # one head per stage pair: Downsample_i, or a conv for the last pair
        self.heads = []
        for index, (head_in, out) in enumerate(pairs):
            if index == len(pairs) - 1:
                name = f"Conv_{convs}"
                self.add_module(name, conv3x3(head_in, out))
            else:
                name = f"Downsample_{index}"
                self.add_module(name, Downsample(head_in, out))
            self.heads.append(name)
        self.stem = [f"Conv_{i}" for i in range(len(self.STEM) + 1)]

    def forward(self, x) -> List[torch.Tensor]:
        for name in self.stem:
            x = F.silu(getattr(self, name)(x))
        features = [x]
        for name in self.heads:
            x = F.silu(getattr(self, name)(x))
            features.append(x)
        return features


class LeanResnetSubBlock(nn.Module):
    """Conv + SiLU (no norm), used where FDN normalizes."""

    def __init__(self, in_dim: int, output_dim: int):
        super().__init__()
        self.Conv_0 = conv3x3(in_dim, output_dim)

    def forward(self, x, scale_shift: Optional[Tuple] = None):
        x = self.Conv_0(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetSubBlock(nn.Module):
    """Conv + GroupNorm + SiLU. Without a time scale-shift the norm, affine
    and SiLU are one fused op (ops/fused_norm.py: the CUDA kernels on the
    card), computing what flax's GroupNorm then silu compute; with one,
    `modulated_norm_silu`."""

    def __init__(self, in_dim: int, output_dim: int, num_groups: int = 8):
        super().__init__()
        self.Conv_0 = conv3x3(in_dim, output_dim)
        self.GroupNorm_0 = nn.GroupNorm(num_groups, output_dim, eps=GROUP_NORM_EPS)

    def forward(self, x, scale_shift: Optional[Tuple] = None):
        x = self.Conv_0(x)
        norm = self.GroupNorm_0
        if scale_shift is None:
            return group_norm_silu(x, norm.weight, norm.bias, norm.num_groups, norm.eps)
        scale, shift = scale_shift
        return modulated_norm_silu(x, norm.weight, norm.bias, scale, shift, norm.num_groups,
                                   norm.eps)


class ConditionedResnetBlock(nn.Module):
    """Two sub-blocks + residual 1x1.

    use_fdn=True: FDN conditioning (on `feature_dim`-channel features)
    before each sub-block; use_fdn=False: GroupNorm sub-blocks. With
    `time_dim`, a time embedding adds a per-channel scale/shift after the
    first conv."""

    def __init__(
        self,
        in_dim: int,
        output_dim: int,
        use_fdn: bool = True,
        num_groups: int = 8,
        feature_dim: Optional[int] = None,
        time_dim: Optional[int] = None,
    ):
        super().__init__()
        self.use_fdn = use_fdn
        if use_fdn:
            if feature_dim is None:
                raise ValueError("use_fdn needs feature_dim")
            self.fdn1 = FeatureDenormalization(in_dim, feature_dim, num_groups)
            self.block1 = LeanResnetSubBlock(in_dim, output_dim)
            self.fdn2 = FeatureDenormalization(output_dim, feature_dim, num_groups)
            self.block2 = LeanResnetSubBlock(output_dim, output_dim)
        else:
            self.block1 = ResnetSubBlock(in_dim, output_dim, num_groups)
            self.block2 = ResnetSubBlock(output_dim, output_dim, num_groups)
        if time_dim is not None:
            self.Dense_0 = nn.Linear(time_dim, 2 * output_dim)
        if in_dim != output_dim:
            self.residual_conv = conv1x1(in_dim, output_dim)

    def forward(self, x, condition_features=None, time_embedding=None):
        h = x
        if self.use_fdn:
            h = self.fdn1(h, condition_features)

        scale_shift = None
        if time_embedding is not None:
            emb = self.Dense_0(F.silu(time_embedding))[:, :, None, None]
            scale_shift = emb.chunk(2, dim=1)

        h = self.block1(h, scale_shift)
        if self.use_fdn:
            h = self.fdn2(h, condition_features)
        h = self.block2(h)

        if hasattr(self, "residual_conv"):
            x = self.residual_conv(x)
        return h + x


class AuxiliaryRangePredictor(nn.Module):
    """Flatten the middle features (in NHWC order, as fea_tpu does) and
    predict displacement ranges: a sigmoid sign head and a linear
    log-magnitude head."""

    def __init__(
        self, in_features: int, output_dim: int, hidden_dim: int = 256,
        num_layers: int = 3,
    ):
        super().__init__()
        widths = [in_features] + [hidden_dim] * (num_layers - 1)
        self.trunk = [f"Dense_{i}" for i in range(num_layers - 1)]
        for name, (a, b) in zip(self.trunk, zip(widths[:-1], widths[1:])):
            self.add_module(name, nn.Linear(a, b))
        n = len(self.trunk)
        self.add_module(f"Dense_{n}", nn.Linear(hidden_dim, hidden_dim))
        self.add_module(f"Dense_{n + 1}", nn.Linear(hidden_dim, output_dim))
        self.add_module(f"Dense_{n + 2}", nn.Linear(hidden_dim, hidden_dim))
        self.add_module(f"Dense_{n + 3}", nn.Linear(hidden_dim, output_dim))
        self.sign_head = (f"Dense_{n}", f"Dense_{n + 1}")
        self.log_head = (f"Dense_{n + 2}", f"Dense_{n + 3}")

    def forward(self, x):
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for name in self.trunk:
            x = F.relu(getattr(self, name)(x))
        hidden, out = (getattr(self, n) for n in self.sign_head)
        sign = torch.sigmoid(out(F.relu(hidden(x))))
        hidden, out = (getattr(self, n) for n in self.log_head)
        log = out(F.relu(hidden(x)))
        return sign, log
