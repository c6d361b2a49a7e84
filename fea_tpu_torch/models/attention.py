"""Attention modules, the port of fea_tpu/models/attention.py (NCHW).

Heads come from channels as head * head_dim + d, as in fea_tpu, so a 1x1
conv's output reshapes straight to (B, heads, head_dim, N).
"""

import math

import torch
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.linear_attention import linear_attention, linear_attention_reference
from .blocks import conv1x1


class RMSNorm(nn.Module):
    """Channelwise RMS norm with a learned gain."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        dim = x.shape[1]
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        return x * math.sqrt(dim) / norm * self.g


class LinearAttention(nn.Module):
    """softmax(q over d) . softmax(k over n) linear attention with learned
    memory-KV slots, kept as (2, heads, head_dim, mem). The attention between
    the two convolutions is `ops.linear_attention`'s wrapper where no
    gradient is needed (its CUDA kernels on the card, as in the sampler; the
    plain einsum chain on the CPU), else the plain chain, since the kernels
    have no backward."""

    def __init__(
        self, dim: int, num_heads: int = 4, head_dim: int = 32,
        num_memory_kv: int = 4,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        hd = num_heads * head_dim
        self.RMSNorm_0 = RMSNorm(dim)
        self.Conv_0 = conv1x1(dim, 3 * hd, bias=False)
        self.memory_kv = nn.Parameter(
            torch.empty(2, num_heads, head_dim, num_memory_kv)
        )
        self.Conv_1 = conv1x1(hd, dim)
        self.RMSNorm_1 = RMSNorm(dim)

    def forward(self, x):
        qkv = self.Conv_0(self.RMSNorm_0(x))
        mem = self.memory_kv
        needs_grad = torch.is_grad_enabled() and (qkv.requires_grad or mem.requires_grad)
        attend = linear_attention_reference if needs_grad else linear_attention
        out = attend(qkv, mem, self.num_heads, self.head_dim)
        return self.RMSNorm_1(self.Conv_1(out))


class FullAttention(nn.Module):
    """Full softmax attention over pixels with memory-KV slots, kept as
    (2, heads, mem, head_dim) and placed before the pixels' keys.
    `use_flash` takes the flash-attention kernel instead of the einsum
    chain."""

    def __init__(
        self, dim: int, num_heads: int = 4, head_dim: int = 32,
        num_memory_kv: int = 4, use_flash: bool = False,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.use_flash = use_flash
        hd = num_heads * head_dim
        self.RMSNorm_0 = RMSNorm(dim)
        self.Conv_0 = conv1x1(dim, 3 * hd, bias=False)
        self.memory_kv = nn.Parameter(
            torch.empty(2, num_heads, num_memory_kv, head_dim)
        )
        self.Conv_1 = conv1x1(hd, dim)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        qkv = self.Conv_0(self.RMSNorm_0(x))
        # (b, heads, n, d)
        q, k, v = (
            t.reshape(b, self.num_heads, self.head_dim, n).transpose(-1, -2)
            for t in qkv.chunk(3, dim=1)
        )
        mem = self.memory_kv
        k = torch.cat([mem[0].expand(b, -1, -1, -1), k], dim=-2)
        v = torch.cat([mem[1].expand(b, -1, -1, -1), v], dim=-2)

        if self.use_flash:
            bh, n_kv = b * self.num_heads, k.shape[2]
            out = flash_attention(
                q.reshape(bh, n, self.head_dim).contiguous(),
                k.reshape(bh, n_kv, self.head_dim).contiguous(),
                v.reshape(bh, n_kv, self.head_dim).contiguous(),
            ).reshape(b, self.num_heads, n, self.head_dim)
        else:
            scores = (q @ k.transpose(-1, -2)) * (self.head_dim**-0.5)
            out = torch.softmax(scores, dim=-1) @ v
        out = out.transpose(-1, -2).reshape(b, self.num_heads * self.head_dim, h, w)
        return self.Conv_1(out)
