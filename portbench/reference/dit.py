"""DiT in plain PyTorch: the benchmark's reference for facebookresearch/DiT's
`models.py` (`DiT`, `DiTBlock`, `FinalLayer`, `TimestepEmbedder`,
`LabelEmbedder`, `get_2d_sincos_pos_embed`), at DiT-XL's widths (depth 28,
hidden 1152, 16 heads of 72, MLP ratio 4, learn_sigma), read over pixels in
patches of 8 and conditioned by concatenation: 7 channels in (x_t's 2 and
the 5-channel condition stack), 4 out (the noise estimate and the variance
interpolant of each channel), no class embedding unless `num_classes` is
given (only for counting DiT-XL/2-256's published parameters).

Written as DiT writes it, with torch.nn layers and plain ops: LayerNorm
modules without affine, `modulate`, timm's Attention as q k^T, a softmax
and a second product, timm's Mlp, the unpatchify einsum, NCHW inside. It
imports nothing of the program under test. Parameter names are DiT's
(`blocks.0.attn.qkv.weight`, ...), the program's too, so one set of
weights made by the benchmark loads into both by name; the position table
is a buffer, computed here in f64 as MAE's numpy code computes it. Its
forward runs in strict f32 on the card: TF32 off for matmuls and for
convolutions (`fdnunet.strict_f32`, the flags' current API), restored on
the way out.
"""

import math

import torch
from torch import nn

from .fdnunet import strict_f32


def get_1d_sincos_pos_embed_from_grid(embed_dim, pos):
    omega = torch.arange(embed_dim // 2, dtype=torch.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = torch.einsum("m,d->md", pos.reshape(-1), omega)
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def get_2d_sincos_pos_embed(embed_dim, grid_size):
    """(grid_size * grid_size, embed_dim), f64: MAE's table, its grid from
    np.meshgrid(grid_w, grid_h), so the first half is the column's."""
    grid_h = torch.arange(grid_size, dtype=torch.float64)
    grid_w = torch.arange(grid_size, dtype=torch.float64)
    grid = torch.stack(torch.meshgrid(grid_w, grid_h, indexing="xy"), dim=0)
    grid = grid.reshape(2, 1, grid_size, grid_size)
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return torch.cat([emb_h, emb_w], dim=1)


def modulate(x, shift, scale):
    return x * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, in_chans, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size, frequency_embedding_size=256):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(frequency_embedding_size, hidden_size), nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size))
        self.frequency_embedding_size = frequency_embedding_size

    @staticmethod
    def timestep_embedding(t, dim, max_period=10000):
        half = dim // 2
        freqs = torch.exp(-math.log(max_period)
                          * torch.arange(start=0, end=half, dtype=torch.float32) / half
                          ).to(device=t.device)
        args = t[:, None].float() * freqs[None]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    def forward(self, t):
        t_freq = self.timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(t_freq.to(self.mlp[0].weight.dtype))


class LabelEmbedder(nn.Module):
    def __init__(self, num_classes, hidden_size):
        super().__init__()
        self.embedding_table = nn.Embedding(num_classes + 1, hidden_size)  # + the null class

    def forward(self, labels):
        return self.embedding_table(labels)


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim**-0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.act = nn.GELU(approximate="tanh")
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class DiTBlock(nn.Module):
    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=1e-6)
        self.attn = Attention(hidden_size, num_heads=num_heads)
        self.norm2 = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=1e-6)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))

    def forward(self, x, c):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            self.adaLN_modulation(c).chunk(6, dim=1))
        x = x + gate_msa.unsqueeze(1) * self.attn(modulate(self.norm1(x), shift_msa, scale_msa))
        x = x + gate_mlp.unsqueeze(1) * self.mlp(modulate(self.norm2(x), shift_mlp, scale_mlp))
        return x


class FinalLayer(nn.Module):
    def __init__(self, hidden_size, patch_size, out_channels):
        super().__init__()
        self.norm_final = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=1e-6)
        self.linear = nn.Linear(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=1)
        return self.linear(modulate(self.norm_final(x), shift, scale))


class DiT(nn.Module):
    def __init__(self, input_size=256, patch_size=8, in_channels=7, out_channels=4,
                 hidden_size=1152, depth=28, num_heads=16, mlp_ratio=4.0, num_classes=None):
        super().__init__()
        self.out_channels = out_channels
        self.patch_size = patch_size
        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = None if num_classes is None else LabelEmbedder(num_classes, hidden_size)
        grid = input_size // patch_size
        self.register_buffer("pos_embed", torch.zeros(1, grid * grid, hidden_size))
        self.blocks = nn.ModuleList([DiTBlock(hidden_size, num_heads, mlp_ratio=mlp_ratio)
                                     for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels)

    def unpatchify(self, x):
        c = self.out_channels
        p = self.patch_size
        h = w = int(x.shape[1] ** 0.5)
        x = x.reshape(shape=(x.shape[0], h, w, p, p, c))
        x = torch.einsum("nhwpqc->nchpwq", x)
        return x.reshape(shape=(x.shape[0], c, h * p, h * p))

    def forward(self, x, condition, time, y=None):
        """NHWC x (B, H, W, 2) and condition (B, H, W, 5), time (B,) ->
        NHWC (B, H, W, 4), in strict f32 for f32 weights."""
        restore = strict_f32()
        try:
            h = torch.cat([x, condition], dim=-1).permute(0, 3, 1, 2)
            h = self.x_embedder(h) + self.pos_embed
            c = self.t_embedder(time)
            if y is not None:
                c = c + self.y_embedder(y)
            for block in self.blocks:
                h = block(h, c)
            h = self.final_layer(h, c)
            return self.unpatchify(h).permute(0, 2, 3, 1)
        finally:
            restore()


def pos_embed(config: dict) -> torch.Tensor:
    """The position table of a configuration's model, (1, T, hidden) f32."""
    model = config["model"]
    grid = model["image_size"] // model["patch_size"]
    return get_2d_sincos_pos_embed(model["hidden_size"], grid).float()[None]


def build(config: dict, device="meta") -> dict:
    """{"model": the reference} of a configuration file's `model` entry
    (kind "dit"), on `device` without weights; its `pos_embed` is
    `pos_embed(config)`'s to load."""
    model = config["model"]
    if model["kind"] != "dit":
        raise ValueError(f"no DiT reference for model kind {model['kind']!r}")
    with torch.device(device):
        return {"model": DiT(
            input_size=model["image_size"], patch_size=model["patch_size"],
            in_channels=model["num_channels"] + model["num_auxiliary_condition_channels"],
            out_channels=2 * model["num_channels"], hidden_size=model["hidden_size"],
            depth=model["depth"], num_heads=model["num_heads"], mlp_ratio=model["mlp_ratio"],
        )}
