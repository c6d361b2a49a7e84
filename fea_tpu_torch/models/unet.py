"""Plain conditional UNet baseline, the port of fea_tpu/models/unet.py
(reference model/unet.py:287-546, lucidrains-style; unused by the
reference's current training but part of its model-family surface).
Conditions are concatenated input channels (no FDN); attention is linear
at outer stages and full at the innermost; output uses the same amax
normalization. NHWC in and out, as fea_tpu's; NCHW inside.
"""

from typing import Optional

import torch
from torch import nn

from .attention import FullAttention, LinearAttention
from .blocks import (
    ConditionedResnetBlock,
    Downsample,
    Upsample,
    amax_normalize,
    conv1x1,
    conv3x3,
)
from .fdnunet import _check_divisible, _stage_dims, nchw, nhwc
from .time_embedding import TimeEmbeddingMLP


class UNet(nn.Module):
    def __init__(
        self,
        input_dim: int,
        initial_dim: Optional[int] = None,
        final_dim: Optional[int] = None,
        num_stages: int = 4,
        num_channels: int = 3,
        num_condition_channels: Optional[int] = None,
        self_condition: bool = False,
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
        self.self_condition = self_condition
        self.use_time_embedding = use_time_embedding
        dims = _stage_dims(input_dim, initial_dim, num_stages)
        pairs = list(zip(dims[:-1], dims[1:]))
        final_dim = final_dim if final_dim is not None else num_channels
        full_attn = (
            (True,) * num_stages
            if use_full_attention
            else (False,) * (num_stages - 1) + (True,)
        )

        time_dim = None
        if use_time_embedding:
            self.TimeEmbeddingMLP_0 = TimeEmbeddingMLP(input_dim)
            time_dim = 4 * input_dim

        def block(in_dim, out_dim):
            return ConditionedResnetBlock(
                in_dim, out_dim, use_fdn=False, num_groups=num_groups, time_dim=time_dim,
            )

        def attn(use_full, dim):
            if use_full:
                return FullAttention(
                    dim, num_attention_heads, attention_head_dim,
                    use_flash=use_flash_attention,
                )
            return LinearAttention(dim, num_attention_heads, attention_head_dim)

        # the input stack: x, then the self-condition, then the condition
        in_channels = num_channels * (2 if self_condition else 1)
        in_channels += num_condition_channels or 0
        self.initial_conv = conv3x3(in_channels, dims[0])
        for index, (in_dim, out_dim) in enumerate(pairs):
            self.add_module(f"down{index}_block1", block(in_dim, in_dim))
            self.add_module(f"down{index}_block2", block(in_dim, in_dim))
            self.add_module(f"down{index}_attention", attn(full_attn[index], in_dim))
            if index == num_stages - 1:
                self.add_module(f"down{index}_conv", conv3x3(in_dim, out_dim))
            else:
                self.add_module(f"down{index}_downsample", Downsample(in_dim, out_dim))
        self.middle_block_1 = block(dims[-1], dims[-1])
        self.middle_attention = attn(True, dims[-1])
        self.middle_block_2 = block(dims[-1], dims[-1])
        for index, (in_dim, out_dim) in enumerate(reversed(pairs)):
            self.add_module(f"up{index}_block1", block(out_dim + in_dim, out_dim))
            self.add_module(f"up{index}_block2", block(out_dim + in_dim, out_dim))
            self.add_module(f"up{index}_attention", attn(full_attn[-(index + 1)], out_dim))
            if index == num_stages - 1:
                self.add_module(f"up{index}_conv", conv3x3(out_dim, in_dim))
            else:
                self.add_module(f"up{index}_upsample", Upsample(out_dim, in_dim))
        self.final_resnet = block(2 * dims[0], dims[0])
        self.final_conv = conv1x1(dims[0], final_dim)

    def forward(self, x, x_condition=None, x_self_condition=None, time=None):
        """NHWC x (B, H, W, num_channels); `x_condition` (B, H, W,
        num_condition_channels) where the model has condition channels;
        `x_self_condition` (zeros when absent) where it self-conditions;
        `time` (B,) where it has a time embedding."""
        _check_divisible(x, self.num_stages)
        if self.self_condition:
            if x_self_condition is None:
                x_self_condition = torch.zeros_like(x)
            x = torch.cat([x, x_self_condition], dim=-1)
        if self.num_condition_channels is not None:
            if x_condition is None:
                raise ValueError(
                    "the model was built with num_condition_channels="
                    f"{self.num_condition_channels}: x_condition is required"
                )
            x = torch.cat([x, x_condition], dim=-1)

        time_embedding = None
        if self.use_time_embedding and time is not None:
            time_embedding = self.TimeEmbeddingMLP_0(time)

        x = self.initial_conv(nchw(x))
        residual = x

        hidden_states = []
        for index in range(self.num_stages):
            x = getattr(self, f"down{index}_block1")(x, None, time_embedding)
            hidden_states.append(x)
            x = getattr(self, f"down{index}_block2")(x, None, time_embedding)
            x = getattr(self, f"down{index}_attention")(x) + x
            hidden_states.append(x)
            if index == self.num_stages - 1:
                x = getattr(self, f"down{index}_conv")(x)
            else:
                x = getattr(self, f"down{index}_downsample")(x)

        x = self.middle_block_1(x, None, time_embedding)
        x = self.middle_attention(x) + x
        x = self.middle_block_2(x, None, time_embedding)

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
