"""LinearAttention's attention as `ops.linear_attention`: the plain version
(`linear_attention_reference`, the einsum chain), the wrapper
(`linear_attention`) and its hand-written CUDA kernels
(`csrc/linear_attention.cu`).

On the CPU:
- the plain version is the module's chain as it was, bit for bit, and the
  port's LinearAttention through the wrapper stays within
  tests/test_torch_models.py's tolerance of fea_tpu's module;
- LinearAttention calls the wrapper where no gradient is needed and the
  chain where one is;
- the pixel chunks of the partial kernel's grid;
- a call recorded in a graph counts in `linear_attention.launches` at each
  replay (the stand-in graph of tests/test_torch_graphed.py).

The tests marked `gpu` skip without a CUDA device; JAX is imported inside
one CPU test only, so on the card they run with

    python -m pytest --noconftest -p no:cacheprovider -m gpu -s tests/test_torch_linear_attention.py

They hold the kernels against the chain in f64 at the sampler's three
shapes (b2, 4 heads of 32, 65,536 / 16,384 / 4,096 pixels and 4 memory
slots): the kernels' largest error relative to the output's span at most
twice that of the cuBLAS f32 chain on the same inputs; at a ragged last
tile and a chunk smaller than a tile, and with memory slots that dominate; two launches bit for bit; a graphed 64 px sample bit for bit the
eager one, 150 calls a 25-step request; none in a grad-on loss backward;
the wrapper raising on what it does not take.
"""

import numpy as np
import pytest
import torch

from fea_tpu_torch.models import attention, graphed, make_diffusion_model
from fea_tpu_torch.ops import graphs
from fea_tpu_torch.ops import linear_attention as la
from fea_tpu_torch.ops.linear_attention import (
    chunking, linear_attention, linear_attention_reference)

torch.set_num_threads(1)


def _inputs(b, heads, n, slots=4, seed=0, hw=None, device="cpu", dtype=torch.float32):
    """qkv (b, 3 heads 32, h, w) and memory_kv (2, heads, 32, slots), N(0, 1)."""
    h, w = hw or (n, 1)
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, 3 * heads * 32, h, w)).astype(np.float32)
    mem = rng.normal(size=(2, heads, 32, slots)).astype(np.float32)
    return (torch.from_numpy(qkv).to(device, dtype), torch.from_numpy(mem).to(device, dtype))


def _chain(qkv, mem, num_heads, head_dim):
    """LinearAttention.forward's chain between the convolutions, as the
    module had it before the kernels."""
    b, _, h, w = qkv.shape
    q, k, v = (t.reshape(b, num_heads, head_dim, h * w) for t in qkv.chunk(3, dim=1))
    k = torch.cat([mem[0].expand(b, -1, -1, -1), k], dim=-1)
    v = torch.cat([mem[1].expand(b, -1, -1, -1), v], dim=-1)
    q = torch.softmax(q, dim=-2) * (head_dim**-0.5)
    k = torch.softmax(k, dim=-1)
    context = torch.einsum("bhdn,bhen->bhde", k, v)
    out = torch.einsum("bhde,bhdn->bhen", context, q)
    return out.reshape(b, num_heads * head_dim, h, w)


# ---- the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4, (8, 8), 4), (1, 2, (5, 7), 3), (3, 1, (1, 1), 1)])
def test_plain_version_is_the_chain_bit_for_bit(shape):
    b, heads, hw, slots = shape
    qkv, mem = _inputs(b, heads, hw[0] * hw[1], slots, seed=1, hw=hw)
    assert torch.equal(linear_attention_reference(qkv, mem, heads, 32),
                       _chain(qkv, mem, heads, 32))
    assert torch.equal(linear_attention(qkv, mem, heads, 32), _chain(qkv, mem, heads, 32))


def test_the_module_through_the_wrapper_matches_fea_tpu():
    """tests/test_torch_models.py's LinearAttention case, the attention
    between the convolutions taken from the wrapper."""
    import test_torch_models as tm
    from fea_tpu.models import attention as jattention

    x = tm.normal(5, 2, 4, 4, 16)
    jm = jattention.LinearAttention(num_heads=2, head_dim=8)
    params = tm.flax_init(jm, x)
    module = tm.port(attention.LinearAttention, params, 16, num_heads=2, head_dim=8)
    with torch.no_grad():
        xt = tm.nchw(x)
        qkv = module.Conv_0(module.RMSNorm_0(xt))
        got = module.RMSNorm_1(module.Conv_1(linear_attention(qkv, module.memory_kv, 2, 8)))
        assert torch.equal(got, module(xt))
    tm.assert_close(tm.to_np_nhwc(got), tm.flax_apply(jm, params, x))


@pytest.mark.parametrize("case", [
    # (grad mode, parameters trainable, input requires grad, what the module calls)
    ("no_grad", True, False, "wrapper"),
    ("inference_mode", True, False, "wrapper"),
    ("grad", True, False, "chain"),
    ("grad", False, False, "wrapper"),  # frozen parameters: nothing needs a gradient
    ("grad", False, True, "chain"),  # a gradient of the input
])
def test_linear_attention_takes_the_route_it_observes(monkeypatch, case):
    """The module calls the wrapper (here a stand-in that runs the plain
    version and counts; the real one sends CPU tensors to the plain version
    and CUDA tensors to the kernels, which have no backward) where no
    gradient is needed, else the chain, whose output is the old module's."""
    mode, trainable, input_grad, want = case
    calls = []

    def stand_in(qkv, mem, num_heads, head_dim):
        calls.append(qkv.shape)
        return linear_attention_reference(qkv, mem, num_heads, head_dim)

    monkeypatch.setattr(attention, "linear_attention", stand_in)
    module = attention.LinearAttention(16, num_heads=2, head_dim=32)
    torch.nn.init.normal_(module.memory_kv)
    module.requires_grad_(trainable)
    x = torch.randn(2, 16, 4, 4, generator=torch.Generator().manual_seed(0))
    x.requires_grad_(input_grad)
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
               "grad": torch.enable_grad}[mode]
    with context():
        out = module(x)
    assert len(calls) == (1 if want == "wrapper" else 0)
    assert out.shape == x.shape and out.requires_grad == (want == "chain")
    with torch.no_grad():
        qkv = module.Conv_0(module.RMSNorm_0(x))
        chain = module.RMSNorm_1(module.Conv_1(_chain(qkv, module.memory_kv, 2, 32)))
    assert torch.equal(out.detach(), chain)


@pytest.mark.parametrize("n, bh, want", [
    (65536, 8, (32, 2048)),  # stage 0 at b2: one wave of 2 blocks on 132 SMs
    (16384, 8, (32, 512)),
    (4096, 8, (16, 256)),  # chunks of MIN_CHUNK
    (1000, 8, (4, 256)),
    (100, 8, (1, 128)),
    (65536, 4000, (1, 65536)),  # more heads than the wave holds: one chunk each
])
def test_chunking_fills_one_wave_in_tiles(n, bh, want):
    chunks, chunk = chunking(n, bh, sms=132, resident=2)
    assert (chunks, chunk) == want
    assert chunk % la.TILE == 0 and (chunks - 1) * chunk < n <= chunks * chunk
    assert chunks == 1 or chunk >= la.MIN_CHUNK
    assert chunks * bh <= max(2 * 132, bh)


def test_a_recorded_call_counts_at_each_replay(monkeypatch):
    """The wrapper's count goes through `graphs.count`: a call made while a
    graph is recorded counts at each replay, one made outside at once. The
    launch itself is replaced by a stand-in on meta tensors."""

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(la, "_check_cuda_inputs", lambda *args: None)
    monkeypatch.setattr(la, "_launch", lambda qkv, mem, heads: torch.empty(
        (qkv.shape[0], heads * 32) + tuple(qkv.shape[2:]), device="meta"))
    qkv = torch.empty((2, 3 * 4 * 32, 8, 8), device="meta")
    mem = torch.empty((2, 4, 32, 4), device="meta")
    before = linear_attention.launches
    linear_attention(qkv, mem, 4, 32)
    assert linear_attention.launches == before + 1
    graphs._capture.tally = {}
    try:
        for _ in range(6):  # a forward's six calls
            linear_attention(qkv, mem, 4, 32)
        tally = graphs._capture.tally
    finally:
        graphs._capture.tally = None
    assert linear_attention.launches == before + 1
    block = graphs.CapturedBlock(Graph(), tally)
    for _ in range(25):
        block.replay()
    assert linear_attention.launches == before + 1 + 150


# ---- the card -------------------------------------------------------------


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want):
    """Largest error relative to the f64 output's span."""
    return float((got.double() - want).abs().max() / want.abs().max())


def _errors(qkv, mem, heads):
    """The kernels' and the f32 cuBLAS chain's error against the chain in
    f64, and the kernels' output."""
    want = linear_attention_reference(qkv.double(), mem.double(), heads, 32)
    got = linear_attention(qkv, mem, heads, 32)
    chain = linear_attention_reference(qkv, mem, heads, 32)
    torch.cuda.synchronize()
    return _rel(got, want), _rel(chain, want), got


# the sampler's shapes at 256 px: down stages 0-2 and up stages 1-3
STAGES = [(256, 256), (128, 128), (64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("hw", STAGES)
def test_kernels_against_f64_at_the_sampler_shapes(hw):
    device = cuda_or_skip()
    qkv, mem = _inputs(2, 4, hw[0] * hw[1], seed=hw[0], hw=hw, device=device)
    with torch.no_grad():
        kernel, chain, _ = _errors(qkv, mem, 4)
    print(f"{hw}: kernels {kernel:.3e}, cuBLAS chain {chain:.3e} from f64")
    assert kernel <= 2 * chain


# a ragged last tile (1,000 pixels: 15 tiles of 64 and one of 40), and 4
# pixels, fewer than a tile
RAGGED = [(40, 25), (2, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("hw", RAGGED)
def test_kernels_at_ragged_pixel_counts(hw):
    device = cuda_or_skip()
    qkv, mem = _inputs(2, 4, hw[0] * hw[1], seed=7, hw=hw, device=device)
    with torch.no_grad():
        kernel, chain, _ = _errors(qkv, mem, 4)
    print(f"{hw}: kernels {kernel:.3e}, cuBLAS chain {chain:.3e} from f64")
    # twice the chain's, or two f32 roundings of the span where that is less
    assert kernel <= max(2 * chain, 2 * 2.0**-24)


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_memory_slots_that_dominate_or_vanish(sign):
    """Memory keys of +-30 over N(0, 1) pixels: the slots take nearly all
    of each row's weight, or nearly none; both against the f64 chain, and a
    slot dropped or misplaced moves the dominant case's output by far more
    than the tolerance."""
    device = cuda_or_skip()
    qkv, mem = _inputs(2, 4, 4096, seed=3, hw=(64, 64), device=device)
    mem[0] = sign * 30.0 + mem[0]
    with torch.no_grad():
        kernel, chain, got = _errors(qkv, mem, 4)
        want = linear_attention_reference(qkv.double(), mem.double(), 4, 32)
        dropped = linear_attention_reference(qkv.double(), mem[:, :, :, 1:].double(), 4, 32)
    print(f"memory keys {sign * 30:+.0f}: kernels {kernel:.3e}, cuBLAS chain {chain:.3e}; "
          f"a slot dropped moves it {_rel(dropped, want):.3e}")
    assert kernel <= max(2 * chain, 2 * 2.0**-24)
    if sign > 0:
        assert _rel(dropped, want) > 100 * kernel


@pytest.mark.gpu
def test_two_launches_give_the_same_bits():
    device = cuda_or_skip()
    qkv, mem = _inputs(2, 4, 65536, seed=5, hw=(256, 256), device=device)
    with torch.no_grad():
        a = linear_attention(qkv, mem, 4, 32)
        b = linear_attention(qkv, mem, 4, 32)
    assert torch.equal(a, b)


STEPS = 25


@pytest.mark.gpu
def test_graphed_sample_is_the_eager_one_bit_for_bit():
    """A 64 px, 4-stage sampler (6 LinearAttentions a forward): the graphed
    request against the eager one, bit for bit, 150 kernel calls each."""
    device = cuda_or_skip()
    diffusion = make_diffusion_model(image_size=64, input_dim=32, num_stages=4,
                                     timesteps=1000, use_flash_attention=True, device=device,
                                     generator=torch.Generator(device=device).manual_seed(0))
    diffusion.model.eval()
    gen = torch.Generator(device=device).manual_seed(1)
    cond = torch.randn((2, 64, 64, 5), generator=gen, device=device)
    noise = torch.randn((STEPS + 1, 2, 64, 64, 2), generator=gen, device=device)

    def request(eager):
        before = linear_attention.launches
        active = graphed.active
        try:
            if eager:
                graphed.active = lambda: None
            out = diffusion.sample(cond, STEPS, noise=noise)
            torch.cuda.synchronize()
        finally:
            graphed.active = active
        return out, linear_attention.launches - before

    eager = request(eager=True)
    first, second = request(eager=False), request(eager=False)
    assert eager[1] == first[1] == second[1] == 6 * STEPS
    assert torch.equal(first[0], eager[0]) and torch.equal(second[0], eager[0])


@pytest.mark.gpu
def test_a_loss_backward_keeps_the_chain():
    """A training step's forward (grad on) takes the chain: no kernel call,
    and the memory slots get their gradient."""
    device = cuda_or_skip()
    diffusion = make_diffusion_model(image_size=64, input_dim=32, num_stages=4,
                                     timesteps=1000, device=device,
                                     generator=torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(2)
    x0 = torch.randn((2, 64, 64, 2), generator=gen, device=device)
    cond = torch.randn((2, 64, 64, 5), generator=gen, device=device)
    before = linear_attention.launches
    diffusion.loss(x0, cond, generator=gen).backward()
    torch.cuda.synchronize()
    assert linear_attention.launches == before
    assert diffusion.model.down0_attention.memory_kv.grad is not None


@pytest.mark.gpu
def test_the_wrapper_raises_on_what_it_does_not_take():
    device = cuda_or_skip()
    qkv, mem = _inputs(2, 4, 64, hw=(8, 8), device=device)
    odd = _inputs(2, 4, 31 * 33, hw=(31, 33), device=device)[0]
    buf = torch.empty(qkv.numel() + 1, device=device)
    unaligned = buf[1:].view(qkv.shape).copy_(qkv)
    bad = [
        (qkv.bfloat16(), mem.bfloat16(), 4, 32),  # bf16
        (qkv, mem, 4, 16),  # head dim
        (qkv[:, :, :, :4], mem, 4, 32),  # not contiguous
        (qkv, mem.cpu(), 4, 32),  # memory slots on the CPU
        (qkv[:, :-32], mem, 4, 32),  # channels not 3 heads 32
        (qkv, mem[:, :2], 4, 32),  # memory slots of other heads
        (qkv.cpu(), mem, 4, 32),  # qkv on the CPU, memory slots on the card
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            linear_attention(*args)
    # the 16-byte copies and stores: 31 x 33 pixels, one pixel, qkv 4 bytes
    # past a 16-byte boundary
    one = _inputs(2, 4, 1, device=device)[0]
    for args, why in [((odd, mem, 4, 32), "multiple of 4"), ((one, mem, 4, 32), "multiple of 4"),
                      ((unaligned, mem, 4, 32), "16-byte")]:
        with pytest.raises(ValueError, match=why):
            linear_attention(*args)
    with pytest.raises(RuntimeError, match="no backward"):
        linear_attention(qkv.requires_grad_(), mem, 4, 32)
