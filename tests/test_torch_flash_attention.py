"""The port's flash attention (fea_tpu_torch.ops.flash_attention) against
fea_tpu's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is compared with that plain version by the tests marked
`gpu`, which skip where there is no CUDA device. JAX is imported inside the
helper that runs the Pallas kernel, so that the `gpu` tests also run on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_flash_attention.py
"""

import numpy as np
import pytest
import torch

from fea_tpu_torch.ops import flash_attention as port_flash_attention
from fea_tpu_torch.ops.flash_attention import flash_attention_reference

torch.set_num_threads(1)

# (BH, Nq, Nk, D): ragged tiles (fea_tpu's own test), and Nk = Nq + 4,
# the memory-KV case of FullAttention
SHAPES = [(3, 100, 68, 32), (2, 64, 68, 32)]


def qkv(shape, seed=0):
    bh, nq, nk, d = shape
    rng = np.random.default_rng(seed)
    return tuple(
        rng.normal(size=s).astype(np.float32)
        for s in ((bh, nq, d), (bh, nk, d), (bh, nk, d))
    )


def pallas(q, k, v, dtype="float32"):
    """fea_tpu's Pallas flash attention in interpret mode, as f32 numpy."""
    import jax
    import jax.numpy as jnp

    from fea_tpu.ops import flash_attention

    with jax.enable_x64(False):
        out = flash_attention(
            *(jnp.asarray(a, dtype) for a in (q, k, v)),
            block_q=32, block_k=32, interpret=True,
        )
        return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("fn", [flash_attention_reference, port_flash_attention])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_f32(shape, fn):
    """float32: atol 2e-5, as fea_tpu's own flash test
    (tests/test_models.py:174); only the order of summation differs."""
    q, k, v = qkv(shape)
    got = fn(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), pallas(q, k, v), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_bf16(shape):
    """bfloat16 inputs, f32 arithmetic, bfloat16 output: atol 1e-2, one
    bf16 rounding of outputs below 1 in magnitude."""
    q, k, v = qkv(shape, seed=1)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = port_flash_attention(*bf)
    assert got.dtype == torch.bfloat16
    want = pallas(q, k, v, dtype="bfloat16")
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)


def test_cpu_wrapper_does_not_count_launches():
    before = port_flash_attention.launches
    port_flash_attention(*(torch.from_numpy(a) for a in qkv(SHAPES[0])))
    assert port_flash_attention.launches == before


LOG2E = 1.4426950408889634


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def bf16(x):
    return x.to(torch.bfloat16).float()


def mm_3xtf32(a, b):
    """a @ b as the kernel's 3xTF32 mma.sync sums it: hi = tf32(x),
    lo = tf32(x - hi), hi*lo + lo*hi + hi*hi with f32 accumulation (the
    products of TF32 values are exact in f32)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def kernel_emulation(q, k, v, dtype, block_k=64, splits=2):
    """The CUDA kernel's arithmetic in plain torch on f32 CPU tensors: q
    scaled in `dtype`; per KV tile of `block_k` keys, walked by `splits`
    warps in turn (tile i by walk i % splits), S = (q scale) k^T (3xTF32 for
    float32, exact bf16 products for bfloat16), the online softmax, and
    o += P v (3xTF32, or P split into bf16 hi + lo against bf16 v); then
    the walks' (max, sum, acc) merged and the sum clamped at 1e-30."""
    scale = q.shape[-1] ** -0.5
    if dtype == "float32":
        qs, mm, pv = q * scale, mm_3xtf32, mm_3xtf32
    else:
        qs, mm = bf16(q * scale), torch.matmul

        def pv(p, vt):
            hi = bf16(p)
            return bf16(p - hi) @ vt + hi @ vt
    walks = []
    for walk in range(splits):
        m = torch.full(q.shape[:-1] + (1,), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q)
        for start in range(walk * block_k, k.shape[1], splits * block_k):
            kt, vt = k[:, start:start + block_k], v[:, start:start + block_k]
            s = mm(qs, kt.transpose(-1, -2))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2(s * LOG2E - m_new * LOG2E)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + pv(p, vt)
            m = m_new
        walks.append((m, l, acc))
    m = torch.maximum(*(w[0] for w in walks))
    weights = [torch.exp2((w[0] - m) * LOG2E) for w in walks]
    l = sum(w[1] * c for w, c in zip(walks, weights))
    acc = sum(w[2] * c for w, c in zip(walks, weights))
    out = acc / l.clamp_min(1e-30)
    return out if dtype == "float32" else bf16(out)


def block_keys(d, itemsize):
    """The kernel's KV tile: 64 keys while a row is at most 128 bytes, 32
    up to 256 bytes, else 16."""
    return 64 if d * itemsize <= 128 else 32 if d * itemsize <= 256 else 16


@pytest.mark.parametrize("shape", [(2, 256, 260, 32), (3, 100, 68, 32), (2, 40, 4, 32),
                                   (2, 56, 100, 64), (2, 48, 100, 128)])
def test_kernel_arithmetic_matches_pallas(shape):
    """The kernel's tensor-core arithmetic, emulated on the CPU, against
    fea_tpu's Pallas kernel: 3xTF32 holds f32's atol 2e-5 / rtol 1e-4; bf16
    inputs (bf16 scores, P in bf16 hi + lo) hold atol 1e-2. Nk 4 leaves the
    second walk without keys; D 64 and 128 take smaller f32 tiles, as the
    kernel does."""
    q, k, v = qkv(shape, seed=3)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = kernel_emulation(qt, kt, vt, "float32", block_keys(shape[-1], 4))
    np.testing.assert_allclose(got.numpy(), pallas(q, k, v), atol=2e-5, rtol=1e-4)
    qb, kb, vb = (bf16(t) for t in (qt, kt, vt))
    got = kernel_emulation(qb, kb, vb, "bfloat16", block_keys(shape[-1], 2))
    np.testing.assert_allclose(got.numpy(), pallas(q, k, v, dtype="bfloat16"), atol=1e-2, rtol=0)


def test_one_tf32_pass_is_not_enough():
    """Why the kernel takes three TF32 products for f32: one pass of
    tf32(a) @ tf32(b) in both products misses the f32 tolerance."""
    q, k, v = (torch.from_numpy(a) for a in qkv((2, 256, 260, 32), seed=3))
    s = tf32(q * 32 ** -0.5) @ tf32(k).transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    one_pass = tf32(p) @ tf32(v)
    err = float((one_pass - flash_attention_reference(q, k, v)).abs().max())
    assert err > 2e-5 + 1e-4 * 1.0, err


def test_mixed_devices_raise():
    q, k, v = (torch.from_numpy(a) for a in qkv(SHAPES[1]))
    with pytest.raises(ValueError):
        port_flash_attention(q, k.to("meta"), v)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1024, 1028, 32), (3, 100, 68, 32),
                                   (2, 70, 33, 64), (2, 65, 40, 128),
                                   # Nq off the 16- and 32-row tiles; Nk 4 (one walk
                                   # sees no key) and 1028 (a 4-key last tile)
                                   (2, 37, 4, 32), (3, 23, 1028, 32), (2, 50, 1028, 64),
                                   (1, 81, 4, 64), (2, 45, 1028, 128), (2, 9, 4, 128)])
def test_cuda_kernel_matches_plain(cuda, shape):
    """f32 (3xTF32 on the tensor cores) atol 2e-5 / rtol 1e-4; bf16 in,
    compared in f32, atol 1e-2."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in qkv(shape, seed=2))
    before = port_flash_attention.launches
    got = port_flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert port_flash_attention.launches == before + 1
    torch.testing.assert_close(got, flash_attention_reference(q, k, v), atol=2e-5, rtol=1e-4)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = port_flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), flash_attention_reference(qb, kb, vb).float(), atol=1e-2, rtol=0
    )


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input(cuda):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in qkv(SHAPES[0]))
    with pytest.raises(TypeError):
        port_flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # head dim 16 is not compiled
        port_flash_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                             v[..., :16].contiguous())
    with pytest.raises(ValueError):  # k and v differ
        port_flash_attention(q, k, v[:, :10].contiguous())
    with pytest.raises(ValueError):  # not contiguous
        port_flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError):  # one tensor on the CPU
        port_flash_attention(q, k.cpu(), v)


@pytest.mark.gpu
def test_cuda_wrapper_raises_when_grad_is_needed(cuda):
    """The kernel has no backward: rather than return an output without a
    grad_fn, the wrapper raises; under no_grad it launches."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in qkv(SHAPES[1]))
    before = port_flash_attention.launches
    with pytest.raises(RuntimeError):
        port_flash_attention(q.requires_grad_(), k, v)
    assert port_flash_attention.launches == before
    with torch.no_grad():
        port_flash_attention(q, k, v)
    assert port_flash_attention.launches == before + 1
