"""The port's flash attention (fea_tpu_torch.ops.flash_attention) against
fea_tpu's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is compared with that plain version by the tests marked
`gpu`, which skip where there is no CUDA device. JAX is imported inside the
helper that runs the Pallas kernel, so that the `gpu` tests also run on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_flash_attention.py
"""

import functools

import numpy as np
import pytest
import torch

from fea_tpu_torch.ops import flash_attention as port_flash_attention
from fea_tpu_torch.ops import graphs
from fea_tpu_torch.ops.flash_attention import flash_attention_reference, route

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


def tf32_truncated(x):
    """x with its low 13 mantissa bits dropped, as the tensor cores read an
    f32 operand of a TF32 product."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b, lo=tf32):
    """a @ b as the kernel's 3xTF32 mma.sync sums it: hi = tf32(x),
    lo = tf32(x - hi), hi*lo + lo*hi + hi*hi with f32 accumulation (the
    products of TF32 values are exact in f32). The wgmma kernel leaves
    x - hi unrounded: `lo` tf32_truncated."""
    ah, bh = tf32(a), tf32(b)
    al, bl = lo(a - ah), lo(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def fma(a, b, c):
    """a * b + c rounded once to f32, as fmaf rounds (the f32 product is
    exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_emulation(q, k, v, dtype, block_k=64, splits=2, fold=None, mm_f32=mm_3xtf32):
    """The CUDA kernel's arithmetic in plain torch on f32 CPU tensors: q
    scaled in `dtype`; per KV tile of `block_k` keys, walked by `splits`
    warps in turn (tile i by walk i % splits), S = (q scale) k^T (3xTF32 for
    float32, exact bf16 products for bfloat16), the online softmax, and
    o += P v (3xTF32, or P split into bf16 hi + lo against bf16 v), each
    tile's P v into the running o by `fold` (acc, corr, pv) when given, the
    f32 products by `mm_f32`; then the walks' (max, sum, acc) merged and the
    sum clamped at 1e-30."""
    scale = q.shape[-1] ** -0.5
    if dtype == "float32":
        qs, mm, pv = q * scale, mm_f32, mm_f32
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
            acc = fold(acc, corr, pv(p, vt)) if fold else acc * corr + pv(p, vt)
            m = m_new
        walks.append((m, l, acc))
    m = torch.stack([w[0] for w in walks]).amax(0)
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
                                   (2, 56, 100, 64), (2, 48, 100, 128),
                                   # the wgmma route: Nk 4 and 1028 (a 4-key last
                                   # tile), Nq off the 64-row tile
                                   (2, 100, 4, 32, "wgmma"), (2, 130, 1028, 32, "wgmma"),
                                   (3, 64, 260, 32, "wgmma"),
                                   # one query row; a 1-key last tile; the sampler's
                                   # Nq and Nk on one head
                                   (2, 1, 7, 32, "wgmma"), (1, 128, 129, 32, "wgmma"),
                                   (2, 192, 196, 32, "wgmma"), (1, 65, 65, 32, "wgmma"),
                                   (1, 1024, 1028, 32, "wgmma")])
def test_kernel_arithmetic_matches_pallas(shape):
    """The kernel's tensor-core arithmetic, emulated on the CPU, against
    fea_tpu's Pallas kernel: 3xTF32 holds f32's atol 2e-5 / rtol 1e-4; bf16
    inputs (bf16 scores, P in bf16 hi + lo) hold atol 1e-2. Nk 4 leaves the
    second walk without keys; D 64 and 128 take smaller f32 tiles, as the
    kernel does. The wgmma route (f32 only) walks 64-key tiles once per
    row tile, splits q, K, V and P into hi = tf32(x) and lo = x - hi (read
    truncated by the tensor cores), and folds each tile's P v into the
    output by one FMA."""
    *shape, kernel = shape if len(shape) == 5 else (*shape, "mma_sync")
    q, k, v = qkv(shape, seed=3)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    if kernel == "wgmma":
        got = kernel_emulation(qt, kt, vt, "float32", 64, splits=1, fold=fma,
                               mm_f32=functools.partial(mm_3xtf32, lo=tf32_truncated))
        np.testing.assert_allclose(got.numpy(), pallas(q, k, v), atol=2e-5, rtol=1e-4)
        return
    got = kernel_emulation(qt, kt, vt, "float32", block_keys(shape[-1], 4))
    np.testing.assert_allclose(got.numpy(), pallas(q, k, v), atol=2e-5, rtol=1e-4)
    qb, kb, vb = (bf16(t) for t in (qt, kt, vt))
    got = kernel_emulation(qb, kb, vb, "bfloat16", block_keys(shape[-1], 2))
    np.testing.assert_allclose(got.numpy(), pallas(q, k, v, dtype="bfloat16"), atol=1e-2, rtol=0)


@pytest.mark.parametrize("shape", [(2, 100, 1028, 72), (1, 37, 4, 72), (2, 64, 130, 72),
                                   (1, 1, 17, 72)])
def test_d72_kernel_arithmetic_matches_plain(shape):
    """f32 at head dim 72 (DiT-XL's heads; f32 only), emulated on the CPU:
    nine TF32 k-steps of 8 a product, the kernel's 16-key tiles,
    against the plain f32 chain at f32's atol 2e-5 / rtol 1e-4. Nk 4 and
    17 leave a walk without keys or a ragged last tile."""
    q, k, v = (torch.from_numpy(a) for a in qkv(shape, seed=5))
    got = kernel_emulation(q, k, v, "float32", block_keys(72, 4))
    want = flash_attention_reference(q, k, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)
    assert float((got - want).abs().max()) > 0  # the emulation is not the plain chain


def test_one_tf32_pass_is_not_enough():
    """Why the kernel takes three TF32 products for f32: one pass of
    tf32(a) @ tf32(b) in both products misses the f32 tolerance."""
    q, k, v = (torch.from_numpy(a) for a in qkv((2, 256, 260, 32), seed=3))
    s = tf32(q * 32 ** -0.5) @ tf32(k).transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    one_pass = tf32(p) @ tf32(v)
    err = float((one_pass - flash_attention_reference(q, k, v)).abs().max())
    assert err > 2e-5 + 1e-4 * 1.0, err


@pytest.mark.parametrize("dtype, d, want", [
    (torch.float32, 32, "wgmma"),
    (torch.float32, 64, "mma_sync"),
    (torch.float32, 72, "mma_sync"),
    (torch.float32, 128, "mma_sync"),
    (torch.bfloat16, 32, "mma_sync"),
    (torch.bfloat16, 64, "mma_sync"),
    (torch.bfloat16, 128, "mma_sync"),
])
def test_route(dtype, d, want):
    """The wrapper's choice of kernel, from the call's dtype and head dim:
    f32 at D 32 takes the wgmma kernel, at any shape."""
    assert route(dtype, d) == want


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
                                   (1, 81, 4, 64), (2, 45, 1028, 128), (2, 9, 4, 128),
                                   # 256 row blocks; 135, with Nq off the 64-row tile
                                   # and a 7-key last tile
                                   (8, 4096, 4100, 32), (3, 5700, 5703, 32),
                                   # one 64-row tile; Nq off the 128-row block; 100
                                   # rows over a 4-key last tile
                                   (1, 64, 64, 32), (2, 130, 68, 32), (3, 100, 1028, 32)])
def test_cuda_kernel_matches_plain(cuda, shape):
    """f32 (3xTF32 on the tensor cores) atol 2e-5 / rtol 1e-4; bf16 in,
    compared in f32, atol 1e-2. `launches_wgmma` counts the f32 calls at
    D 32, which take the wgmma kernel."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in qkv(shape, seed=2))
    wgmma = shape[-1] == 32
    before = port_flash_attention.launches, port_flash_attention.launches_wgmma
    got = port_flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (port_flash_attention.launches, port_flash_attention.launches_wgmma) == (
        before[0] + 1, before[1] + wgmma)
    torch.testing.assert_close(got, flash_attention_reference(q, k, v), atol=2e-5, rtol=1e-4)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = port_flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    assert port_flash_attention.launches_wgmma == before[1] + wgmma
    torch.testing.assert_close(
        got.float(), flash_attention_reference(qb, kb, vb).float(), atol=1e-2, rtol=0
    )


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 1024, 1024, 72), (2, 37, 4, 72), (3, 23, 1028, 72),
                                   (2, 130, 17, 72), (1, 1, 1, 72)])
def test_cuda_kernel_matches_plain_at_d72(cuda, shape):
    """f32 at head dim 72 on mma.sync, DiT-XL's call (32, 1024, 1024, 72)
    and ragged ones, at the D-64 route's tolerance (atol 2e-5 / rtol
    1e-4); `launches_d72` counts each call, `launches_wgmma` none. bf16 at
    D 72 raises and launches nothing."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in qkv(shape, seed=6))
    before = (port_flash_attention.launches, port_flash_attention.launches_wgmma,
              port_flash_attention.launches_d72)
    got = port_flash_attention(q, k, v, 72**-0.5)
    torch.cuda.synchronize()
    assert (port_flash_attention.launches, port_flash_attention.launches_wgmma,
            port_flash_attention.launches_d72) == (before[0] + 1, before[1], before[2] + 1)
    torch.testing.assert_close(got, flash_attention_reference(q, k, v, 72**-0.5), atol=2e-5,
                               rtol=1e-4)
    with pytest.raises(TypeError, match="float32 only"):
        port_flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert port_flash_attention.launches == before[0] + 1


@pytest.mark.gpu
def test_cuda_graph_replays_wgmma_route(cuda):
    """A captured call of the wgmma route replays bit for bit what the
    eager call gives, its scratch in the graph's pool, and each replay
    counts one launch of each counter."""
    shape = (8, 4096, 4100, 32)
    q, k, v = (torch.from_numpy(a).to(cuda) for a in qkv(shape, seed=4))
    with torch.no_grad():
        eager = port_flash_attention(q, k, v)
        block = graphs.capture(lambda: port_flash_attention(q, k, v),
                               lambda: port_flash_attention(q, k, v), cuda)
    try:
        before = port_flash_attention.launches, port_flash_attention.launches_wgmma
        for i in range(1, 3):
            block.output.zero_()
            block.replay()
            torch.cuda.synchronize()
            assert torch.equal(block.output, eager)
            assert (port_flash_attention.launches, port_flash_attention.launches_wgmma) == (
                before[0] + i, before[1] + i)
    finally:
        block.close()


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
