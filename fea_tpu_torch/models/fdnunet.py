"""FDN-UNet model family, the port of fea_tpu/models/fdnunet.py.

The split encoder / decoder / auxiliary-range decoder that the regression
surrogate serves (`create_models`, `predict`), and the monolithic FDNUNet
with attention that the DDPM sampler runs. The forward functions take and
return NHWC tensors, as fea_tpu's do; inside they run NCHW views of the
same memory (channels_last when the input is NHWC-contiguous).
"""

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..utils.precision import model_precision
from . import graphed
from .attention import FullAttention, LinearAttention
from .blocks import (
    AuxiliaryRangePredictor,
    ConditionedResnetBlock,
    ConditionFeatureExtractor,
    Downsample,
    Upsample,
    amax_normalize,
    conv1x1,
    conv3x3,
)
from .initializers import materialize
from .time_embedding import TimeEmbeddingMLP


def _stage_dims(input_dim: int, initial_dim: Optional[int], num_stages: int):
    initial = initial_dim if initial_dim is not None else input_dim
    return [initial] + [input_dim * (2**i) for i in range(num_stages)]


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _check_divisible(x, num_stages):
    max_resolution = 2 ** (num_stages - 1)
    if any(d % max_resolution for d in x.shape[1:3]):
        raise ValueError(
            f"spatial dims {tuple(x.shape[1:3])} must be divisible by "
            f"{max_resolution}"
        )


def _self_condition(x, x_self_condition):
    """x with the self-condition concatenated (zeros when absent): the
    input of a model built with num_condition_channels."""
    if x_self_condition is None:
        x_self_condition = torch.zeros_like(x)
    return torch.cat([x, x_self_condition], dim=-1)


class FDNUNetEncoder(nn.Module):
    """Down path + middle. forward returns (middle, hidden_states x
    2 * num_stages, residual), all NHWC. With num_condition_channels (any
    value, as in fea_tpu) the input is x and the self-condition
    concatenated, so the initial conv takes 2 * num_channels."""

    def __init__(
        self,
        input_dim: int,
        initial_dim: Optional[int] = None,
        num_stages: int = 4,
        num_channels: int = 3,
        num_auxiliary_condition_channels: int = 3,
        num_condition_channels: Optional[int] = None,
        num_groups: int = 8,
    ):
        super().__init__()
        self.num_stages = num_stages
        self.num_condition_channels = num_condition_channels
        dims = _stage_dims(input_dim, initial_dim, num_stages)

        in_channels = num_channels * (1 if num_condition_channels is None else 2)
        self.initial_conv = conv3x3(in_channels, dims[0])
        self.condition_feature_extractor = ConditionFeatureExtractor(
            num_auxiliary_condition_channels, dims
        )
        for index, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for name in (f"down{index}_block1", f"down{index}_block2"):
                self.add_module(name, ConditionedResnetBlock(
                    in_dim, in_dim, num_groups=num_groups, feature_dim=in_dim,
                ))
            if index == num_stages - 1:
                self.add_module(f"down{index}_conv", conv3x3(in_dim, out_dim))
            else:
                self.add_module(
                    f"down{index}_downsample", Downsample(in_dim, out_dim)
                )
        for name in ("middle_block_1", "middle_block_2"):
            self.add_module(name, ConditionedResnetBlock(
                dims[-1], dims[-1], num_groups=num_groups, feature_dim=dims[-1],
            ))

    def forward(self, x, x_auxiliary_condition, x_self_condition=None):
        _check_divisible(x, self.num_stages)
        if self.num_condition_channels is not None:
            x = _self_condition(x, x_self_condition)
        x = self.initial_conv(nchw(x))
        residual = x
        features = self.condition_feature_extractor(nchw(x_auxiliary_condition))

        hidden_states = []
        for index in range(self.num_stages):
            block1 = getattr(self, f"down{index}_block1")
            block2 = getattr(self, f"down{index}_block2")
            x = block1(x, features[index])
            hidden_states.append(x)
            x = block2(x, features[index])
            hidden_states.append(x)
            if index == self.num_stages - 1:
                x = getattr(self, f"down{index}_conv")(x)
            else:
                x = getattr(self, f"down{index}_downsample")(x)

        x = self.middle_block_1(x, features[-1])
        x = self.middle_block_2(x, features[-1])
        return nhwc(x), [nhwc(h) for h in hidden_states], nhwc(residual)


class FDNUNetDecoder(nn.Module):
    """Up path with skip concatenation and amax output normalization."""

    def __init__(
        self,
        input_dim: int,
        initial_dim: Optional[int] = None,
        final_dim: Optional[int] = None,
        num_stages: int = 4,
        num_channels: int = 3,
        num_groups: int = 8,
    ):
        super().__init__()
        self.num_stages = num_stages
        dims = _stage_dims(input_dim, initial_dim, num_stages)
        pairs = list(zip(dims[:-1], dims[1:]))
        final_dim = final_dim if final_dim is not None else num_channels

        for index, (in_dim, out_dim) in enumerate(reversed(pairs)):
            for name in (f"up{index}_block1", f"up{index}_block2"):
                self.add_module(name, ConditionedResnetBlock(
                    out_dim + in_dim, out_dim, use_fdn=False, num_groups=num_groups,
                ))
            if index == num_stages - 1:
                self.add_module(f"up{index}_conv", conv3x3(out_dim, in_dim))
            else:
                self.add_module(f"up{index}_upsample", Upsample(out_dim, in_dim))
        self.final_resnet = ConditionedResnetBlock(
            2 * dims[0], dims[0], use_fdn=False, num_groups=num_groups
        )
        self.final_conv = conv1x1(dims[0], final_dim)

    def forward(self, x, hidden_states: List[torch.Tensor], residual):
        x = nchw(x)
        hidden = [nchw(h) for h in hidden_states]
        for index in range(self.num_stages):
            x = torch.cat([x, hidden.pop()], dim=1)
            x = getattr(self, f"up{index}_block1")(x)
            x = torch.cat([x, hidden.pop()], dim=1)
            x = getattr(self, f"up{index}_block2")(x)
            if index == self.num_stages - 1:
                x = getattr(self, f"up{index}_conv")(x)
            else:
                x = getattr(self, f"up{index}_upsample")(x)

        x = self.final_resnet(torch.cat([x, nchw(residual)], dim=1))
        # amax (signed max, not abs) normalization, zero-divisor guarded
        return nhwc(amax_normalize(self.final_conv(x)))


class FDNUNetAuxDecoder(nn.Module):
    """Auxiliary range decoder over the (NHWC) middle features."""

    def __init__(
        self,
        middle_dim: int,
        final_dim: int,
        image_height: int,
        image_width: int,
        hidden_dim: int = 256,
        num_layers: int = 3,
        num_stages: int = 4,
    ):
        super().__init__()
        scale = 2 ** (num_stages - 1)
        in_features = middle_dim * (image_height // scale) * (image_width // scale)
        self.auxiliary_range_predictor = AuxiliaryRangePredictor(
            in_features, final_dim * 2, hidden_dim, num_layers
        )

    def forward(self, x):
        return self.auxiliary_range_predictor(nchw(x))


def build_models(
    input_dim: int,
    image_height: int,
    image_width: int,
    range_prediction_hidden_dim: int = 256,
    range_prediction_num_layers: int = 3,
    initial_dim: Optional[int] = None,
    final_dim: Optional[int] = None,
    num_stages: int = 4,
    num_channels: int = 3,
    num_auxiliary_condition_channels: int = 3,
    num_condition_channels: Optional[int] = None,
    resnet_num_groups_for_normalization: int = 8,
) -> Tuple[FDNUNetEncoder, FDNUNetDecoder, FDNUNetAuxDecoder]:
    """The three modules with matched dims on the meta device: names and
    shapes, no storage (`create_models` gives them weights)."""
    dims = _stage_dims(input_dim, initial_dim, num_stages)
    with torch.device("meta"):
        encoder = FDNUNetEncoder(
            input_dim=input_dim,
            initial_dim=initial_dim,
            num_stages=num_stages,
            num_channels=num_channels,
            num_auxiliary_condition_channels=num_auxiliary_condition_channels,
            num_condition_channels=num_condition_channels,
            num_groups=resnet_num_groups_for_normalization,
        )
        decoder = FDNUNetDecoder(
            input_dim=input_dim,
            initial_dim=initial_dim,
            final_dim=final_dim,
            num_stages=num_stages,
            num_channels=num_channels,
            num_groups=resnet_num_groups_for_normalization,
        )
        auxiliary = FDNUNetAuxDecoder(
            middle_dim=dims[-1],
            final_dim=final_dim if final_dim is not None else num_channels,
            image_height=image_height,
            image_width=image_width,
            hidden_dim=range_prediction_hidden_dim,
            num_layers=range_prediction_num_layers,
            num_stages=num_stages,
        )
    return encoder, decoder, auxiliary


def create_models(*args, device, generator: torch.Generator, **kwargs):
    """`build_models`' three modules on `device`, with weights drawn from
    `generator` (flax's default initializers)."""
    return tuple(materialize(m, device, generator) for m in build_models(*args, **kwargs))


@torch.no_grad()
@model_precision()
def predict(encoder, decoder, materials, conditions, geometry):
    """The regression surrogate's prediction: encoder -> decoder, then the
    geometry remask of the signed output (fea_tpu/apps/runner.py:320-331).
    NHWC in and out; `conditions` is forces (2) + constraints (1)."""
    x, hidden, residual = encoder(materials, conditions)
    image = decoder(x, hidden, residual)
    return ((image + 1.0) / 2.0 * (geometry + 1.0) / 2.0) * 2.0 - 1.0


class FDNUNet(nn.Module):
    """Monolithic FDN-UNet with per-stage attention: LinearAttention at
    the outer stages, FullAttention at the innermost stage and the middle
    (at every stage with use_full_attention); an optional self-condition
    input (num_condition_channels, as in FDNUNetEncoder) and an optional
    time embedding (the diffusion hooks)."""

    def __init__(
        self,
        input_dim: int,
        initial_dim: Optional[int] = None,
        final_dim: Optional[int] = None,
        num_stages: int = 4,
        num_channels: int = 3,
        num_auxiliary_condition_channels: int = 3,
        num_condition_channels: Optional[int] = None,
        num_groups: int = 8,
        attention_head_dim: int = 32,
        num_attention_heads: int = 4,
        use_full_attention: bool = False,
        use_flash_attention: bool = False,
        use_time_embedding: bool = False,
    ):
        super().__init__()
        self.num_stages = num_stages
        self.num_condition_channels = num_condition_channels
        self.use_time_embedding = use_time_embedding
        dims = _stage_dims(input_dim, initial_dim, num_stages)
        pairs = list(zip(dims[:-1], dims[1:]))
        final_dim = final_dim if final_dim is not None else num_channels

        def attn(use_full, dim):
            if use_full:
                return FullAttention(
                    dim, num_attention_heads, attention_head_dim,
                    use_flash=use_flash_attention,
                )
            return LinearAttention(dim, num_attention_heads, attention_head_dim)

        def block(in_dim, out_dim, use_fdn=True):
            return ConditionedResnetBlock(
                in_dim, out_dim, use_fdn=use_fdn, num_groups=num_groups,
                feature_dim=in_dim if use_fdn else None, time_dim=time_dim,
            )

        time_dim = None
        if use_time_embedding:
            self.TimeEmbeddingMLP_0 = TimeEmbeddingMLP(input_dim)
            time_dim = 4 * input_dim
        in_channels = num_channels * (1 if num_condition_channels is None else 2)
        self.initial_conv = conv3x3(in_channels, dims[0])
        self.condition_feature_extractor = ConditionFeatureExtractor(
            num_auxiliary_condition_channels, dims
        )
        # full attention at the innermost stage (down last, up first), at
        # every stage with use_full_attention
        for index, (in_dim, out_dim) in enumerate(pairs):
            self.add_module(f"down{index}_block1", block(in_dim, in_dim))
            self.add_module(f"down{index}_block2", block(in_dim, in_dim))
            self.add_module(f"down{index}_attention",
                            attn(use_full_attention or index == num_stages - 1, in_dim))
            if index == num_stages - 1:
                self.add_module(f"down{index}_conv", conv3x3(in_dim, out_dim))
            else:
                self.add_module(f"down{index}_downsample", Downsample(in_dim, out_dim))
        self.middle_block_1 = block(dims[-1], dims[-1])
        self.middle_attention = attn(True, dims[-1])
        self.middle_block_2 = block(dims[-1], dims[-1])
        for index, (in_dim, out_dim) in enumerate(reversed(pairs)):
            self.add_module(f"up{index}_block1", block(out_dim + in_dim, out_dim, False))
            self.add_module(f"up{index}_block2", block(out_dim + in_dim, out_dim, False))
            self.add_module(f"up{index}_attention", attn(use_full_attention or index == 0, out_dim))
            if index == num_stages - 1:
                self.add_module(f"up{index}_conv", conv3x3(out_dim, in_dim))
            else:
                self.add_module(f"up{index}_upsample", Upsample(out_dim, in_dim))
        self.final_resnet = block(2 * dims[0], dims[0], False)
        self.final_conv = conv1x1(dims[0], final_dim)

    def forward(self, x, x_auxiliary_condition, x_self_condition=None, time=None):
        """NHWC x (B, H, W, num_channels) and condition stack;
        `x_self_condition` (zeros when absent) where the model
        self-conditions; `time` (B,) is used when the model has a time
        embedding. Inside a `graphed.scope` (the sampler's loop) the
        forward is replayed from a CUDA graph where it can be."""
        runner = graphed.active()
        if runner is not None:
            return runner(self, self._forward, x, x_auxiliary_condition, x_self_condition, time)
        return self._forward(x, x_auxiliary_condition, x_self_condition, time)

    def _forward(self, x, x_auxiliary_condition, x_self_condition, time):
        _check_divisible(x, self.num_stages)
        if self.num_condition_channels is not None:
            x = _self_condition(x, x_self_condition)

        time_embedding = None
        if self.use_time_embedding and time is not None:
            time_embedding = self.TimeEmbeddingMLP_0(time)

        x = self.initial_conv(nchw(x))
        residual = x
        features = self.condition_feature_extractor(nchw(x_auxiliary_condition))

        hidden_states = []
        for index in range(self.num_stages):
            x = getattr(self, f"down{index}_block1")(x, features[index], time_embedding)
            hidden_states.append(x)
            x = getattr(self, f"down{index}_block2")(x, features[index], time_embedding)
            x = getattr(self, f"down{index}_attention")(x) + x
            hidden_states.append(x)
            if index == self.num_stages - 1:
                x = getattr(self, f"down{index}_conv")(x)
            else:
                x = getattr(self, f"down{index}_downsample")(x)

        x = self.middle_block_1(x, features[-1], time_embedding)
        x = self.middle_attention(x) + x
        x = self.middle_block_2(x, features[-1], time_embedding)

        for index in range(self.num_stages):
            x = torch.cat([x, hidden_states.pop()], dim=1)
            x = getattr(self, f"up{index}_block1")(x, None, time_embedding)
            x = torch.cat([x, hidden_states.pop()], dim=1)
            x = getattr(self, f"up{index}_block2")(x, None, time_embedding)
            x = getattr(self, f"up{index}_attention")(x) + x
            if index == self.num_stages - 1:
                x = getattr(self, f"up{index}_conv")(x)
            else:
                x = getattr(self, f"up{index}_upsample")(x)

        x = torch.cat([x, residual], dim=1)
        x = self.final_resnet(x, None, time_embedding)
        return nhwc(amax_normalize(self.final_conv(x)))
