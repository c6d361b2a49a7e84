"""DiT, the diffusion transformer of Peebles & Xie, "Scalable Diffusion
Models with Transformers" (arXiv:2212.09748), as facebookresearch/DiT's
`models.py` builds it (`DiT`, `DiTBlock`, `FinalLayer`, `TimestepEmbedder`,
`get_2d_sincos_pos_embed`), at DiT-XL's widths by default:
  depth 28, hidden 1152, 16 heads of 72, MLP ratio 4 (4608, tanh GELU),
  learn_sigma (the noise estimate and the variance interpolant v).
Its parts, by DiT's names (so that its state dict's keys are the ones
here):
  * `x_embedder.proj`: the patch embedding, a p x p convolution of stride
    p, then the tokens in row-major order, plus `pos_embed`, MAE's fixed
    2D sin-cos table (a buffer): the first half of the width from the
    column index, the second from the row index, each [sin, cos] over
    10000^(-j / (width / 4));
  * `t_embedder.mlp`: the sinusoidal embedding of t (guided-diffusion's,
    `adm.timestep_embedding`, 256 wide), Linear, SiLU, Linear;
  * `blocks`: adaLN-Zero blocks. SiLU(c) -> Linear gives (shift, scale,
    gate) for the attention and for the MLP; LayerNorm without affine
    (eps 1e-6), modulated by x (1 + scale) + shift, then
    x += gate * attention(...) and x += gate * mlp(...). Attention is
    timm's: one qkv Linear with bias, softmax(q k^T / sqrt(72)) v, a
    projection Linear with bias; the MLP fc1, GELU (tanh), fc2;
  * `final_layer`: SiLU(c) -> Linear gives (shift, scale), then the
    modulated LayerNorm and a Linear to p x p x out channels, then the
    patches laid back into the image.

It departs from DiT's `DiT_XL_2` in four ways:
  * it reads pixels, not VAE latents: the 256 px image in patches of 8
    (`make_dit_diffusion_model`'s defaults), which gives the 512 px
    model's own 32 x 32 grid of 1,024 tokens, where DiT reads a 32 x 32
    latent in patches of 2;
  * 7 channels in, x_t's 2 displacement channels concatenated with the
    5-channel condition stack [forces(2), constraints(1), materials(2)],
    as the ADM UNet (`models/adm.py`) takes them, and 4 out: the noise
    estimate and the variance interpolant v of each displacement channel;
  * no class embedding, so no classifier-free guidance: c is the time
    embedding alone;
  * f32 parameters, with TF32 convolutions and TF32 matmuls: the class
    declares `matmul_precision = "tf32"`, which `GaussianDiffusion.sample`
    hands to `utils.precision.model_precision`, as DiT's scripts set
    `torch.backends.cuda.matmul.allow_tf32`.

Each attention is one call of the port's flash kernel
(`ops.flash_attention.flash_attention`) at head dim 72, f32 in 3xTF32
products; CPU tensors take its plain version. The forward takes and
returns NHWC tensors, as the port's other models do; inside a
`graphed.scope` (the sampler's loop) it is replayed from a CUDA graph
where it can be.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from . import graphed
from .adm import timestep_embedding
from .initializers import materialize

LN_EPS = 1e-6
FREQUENCY_EMBEDDING = 256  # TimestepEmbedder's frequency_embedding_size


def pos_embed_table(width: int, grid: int) -> torch.Tensor:
    """MAE's get_2d_sincos_pos_embed(width, grid) as DiT uses it, computed
    in f64 and returned as f32 (grid * grid, width): token r * grid + c
    takes [sin, cos](c omega) in its first half and [sin, cos](r omega) in
    its second, omega_j = 10000^(-j / (width / 4))."""
    quarter = width // 4
    omega = 1.0 / 10000 ** (np.arange(quarter, dtype=np.float64) / quarter)
    rows, cols = np.meshgrid(np.arange(grid, dtype=np.float64),
                             np.arange(grid, dtype=np.float64), indexing="ij")

    def one_d(pos):
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return torch.from_numpy(np.concatenate([one_d(cols), one_d(rows)], axis=1)).float()


class PatchEmbed(nn.Module):
    """timm's PatchEmbed as DiT builds it: a p x p convolution of stride p,
    the tokens in row-major order."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQUENCY_EMBEDDING, hidden_size), nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size))

    def forward(self, t):
        return self.mlp(timestep_embedding(t, FREQUENCY_EMBEDDING))


class Attention(nn.Module):
    """timm's Attention (qkv_bias, no q/k norm), softmax through one flash
    call over the batch's heads."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        h, d = self.num_heads, self.head_dim
        # (b, n, q/k/v, heads, d) -> (q/k/v, b heads, n, d), one copy
        q, k, v = self.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).reshape(
            3, b * h, n, d)
        a = flash_attention(q, k, v, d**-0.5)
        return self.proj(a.reshape(b, h, n, d).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def modulated_norm(x, shift, scale):
    """LayerNorm(x) (no affine, eps 1e-6) * (1 + scale) + shift, the
    modulation (B, C) broadcast over the tokens."""
    return torch.addcmul(shift[:, None], F.layer_norm(x, x.shape[-1:], eps=LN_EPS),
                         1 + scale[:, None])


class DiTBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))

    def forward(self, x, silu_c):
        """x (B, N, C); silu_c = SiLU(c), shared by the blocks."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            self.adaLN_modulation[1](silu_c).chunk(6, dim=1))
        x = torch.addcmul(x, gate_msa[:, None], self.attn(modulated_norm(x, shift_msa, scale_msa)))
        return torch.addcmul(x, gate_mlp[:, None],
                             self.mlp(modulated_norm(x, shift_mlp, scale_mlp)))


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))

    def forward(self, x, silu_c):
        shift, scale = self.adaLN_modulation[1](silu_c).chunk(2, dim=1)
        return self.linear(modulated_norm(x, shift, scale))


class DiT(nn.Module):
    """DiT over the module docstring's departures: forward(x (B, H, W, 2),
    condition (B, H, W, 5), time (B,)) -> (B, H, W, 4), the noise estimate
    in channels 0-1 and the variance interpolant v in 2-3; H and W are
    `input_size`."""

    # what GaussianDiffusion asks of a model: a time input, no
    # self-conditioning input, a learned-range variance in its output; and
    # the matmul precision its sampling runs at (utils.precision)
    use_time_embedding = True
    num_condition_channels = None
    learned_range = True
    matmul_precision = "tf32"

    def __init__(self, input_size: int = 256, patch_size: int = 8, in_channels: int = 7,
                 out_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0):
        super().__init__()
        if input_size % patch_size or hidden_size % num_heads or hidden_size % 4:
            raise ValueError(f"input {input_size} in patches of {patch_size}, width "
                             f"{hidden_size} in {num_heads} heads: not whole")
        self.input_size, self.patch_size = input_size, patch_size
        self.out_channels = out_channels
        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.grid = input_size // patch_size
        self.register_buffer("pos_embed", pos_embed_table(hidden_size, self.grid)[None])
        self.blocks = nn.ModuleList(
            [DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, patch_size, out_channels)

    def forward(self, x, condition, time):
        """NHWC x and condition, time (B,). Inside a `graphed.scope` the
        forward is replayed from a CUDA graph where it can be."""
        runner = graphed.active()
        if runner is not None:
            return runner(self, self._forward, x, condition, time)
        return self._forward(x, condition, time)

    def _forward(self, x, condition, time):
        b, height, width, _ = x.shape
        if (height, width) != (self.input_size, self.input_size):
            raise ValueError(f"DiT takes {self.input_size} x {self.input_size} inputs; got "
                             f"{height} x {width}")
        h = torch.cat([x, condition], dim=-1).permute(0, 3, 1, 2)
        h = self.x_embedder(h) + self.pos_embed
        silu_c = F.silu(self.t_embedder(time))
        for block in self.blocks:
            h = block(h, silu_c)
        h = self.final_layer(h, silu_c)
        # unpatchify: (b, gh gw, p p c) -> (b, gh p, gw p, c), NHWC
        p, g, c = self.patch_size, self.grid, self.out_channels
        return h.reshape(b, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, g * p, g * p, c)


def zero_modules(model: DiT):
    """The linears that DiT initializes to zero (`initialize_weights`):
    each block's adaLN modulation, the final layer's and its output
    linear."""
    for block in model.blocks:
        yield block.adaLN_modulation[1]
    yield model.final_layer.adaLN_modulation[1]
    yield model.final_layer.linear


def make_dit_diffusion_model(image_size: int = 256, timesteps: int = 1000,
                             beta_schedule: str = "linear", *, device,
                             generator: torch.Generator, **kw):
    """GaussianDiffusion over a DiT (`**kw` goes to it) with the
    learned-range variance, on `device`, for images of `image_size` (its
    `input_size`). The weights are drawn from `generator` as `materialize`
    draws the FDN-UNet's, the position table computed, and the
    `zero_modules` then zeroed, as DiT initializes them."""
    from .diffusion import GaussianDiffusion

    with torch.device("meta"):
        model = DiT(input_size=image_size, **kw)
    materialize(model, device, generator)
    with torch.no_grad():
        model.pos_embed.copy_(pos_embed_table(model.pos_embed.shape[-1], model.grid)[None])
        for m in zero_modules(model):
            for p in m.parameters():
                p.zero_()
    return GaussianDiffusion(model, timesteps=timesteps, beta_schedule=beta_schedule)
