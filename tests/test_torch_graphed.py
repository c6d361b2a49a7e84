"""The sampler's forward replayed from a CUDA graph
(fea_tpu_torch/models/graphed.py, ops/graphs.py).

On the CPU the runner's logic runs with a stand-in for `ops.graphs.capture`
(`StandIn`: the warm-up and the recorded function run eagerly; a replay
runs the function again and writes its output into the block's output
tensor, as a graph's replay rewrites its memory): which calls capture,
replay or run eagerly, the cap on graphs, a failed capture, the hooks and
outputs the sampler's caller sees, the counters and the capture's span.
The `gpu` tests hold the real graphs on the card to the eager forward.
Imports no JAX.
"""

import logging

import numpy as np
import pytest
import torch

from fea_tpu_torch.models import graphed, make_diffusion_model
from fea_tpu_torch.models.graphed import GRAPHS_PER_MODULE, GraphedForward
from fea_tpu_torch.ops import flash_attention, graphs, group_norm_silu
from fea_tpu_torch.utils.precision import model_precision
from fea_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)

S, DIM, STAGES, T, STEPS = 32, 8, 2, 50, 25


class Block:
    """A stand-in for a captured block: a replay runs the function again
    and copies its result into `output`."""

    def __init__(self, fn):
        self.fn, self.output = fn, fn()
        self.replays, self.closed = 0, False

    def replay(self):
        self.replays += 1
        self.output.copy_(self.fn())

    def close(self):
        self.closed = True


class StandIn:
    """In place of `ops.graphs.capture` on the CPU; raises after the
    warm-up where `fail`."""

    def __init__(self, fail=False):
        self.fail, self.calls, self.blocks = fail, 0, []

    def __call__(self, fn, warmup, device):
        self.calls += 1
        warmup()
        if self.fail:
            raise RuntimeError("the stand-in's capture fails")
        self.blocks.append(Block(fn))
        return self.blocks[-1]


def _diffusion(seed=0, image=S, **kw):
    return make_diffusion_model(image_size=image, input_dim=DIM, num_stages=STAGES, timesteps=T,
                                use_flash_attention=True, device="cpu",
                                generator=torch.Generator().manual_seed(seed), **kw)


def _inputs(batch=2, seed=1, image=S, device="cpu"):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    return draw(batch, image, image, 2), draw(batch, image, image, 5), \
        torch.full((batch,), 17.0, device=device)


def _counts():
    return GraphedForward.captures, GraphedForward.replays, GraphedForward.eager


def _since(before):
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.fixture
def model():
    return _diffusion().model.eval()


def _call(runner, model, x, cond, t):
    with torch.no_grad(), graphed.scope(runner):
        return model(x, cond, time=t)


def _eager(model, x, cond, t):
    with torch.no_grad():
        return model(x, cond, time=t)


def _bump_in_place(model):
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)


def _replace_weights(model):
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)


def _replace_one_tensor(model):
    model.final_conv.weight.data = model.final_conv.weight.data.clone()


# (what happens between two calls, the second call's inputs, whether it
# captures); the others replay
KEY_CASES = {
    "same": (lambda m: None, {}, False),
    "shape": (lambda m: None, {"batch": 3}, True),
    "precision": (lambda m: None, {"conv": "ieee"}, True),
    "matmul_precision": (lambda m: None, {"matmul": "tf32"}, True),
    "address": (_replace_one_tensor, {}, True),
    "assign": (_replace_weights, {}, True),
    "in_place": (_bump_in_place, {}, False),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_a_new_key_captures_and_the_same_key_replays(model, case):
    change, second, captures = KEY_CASES[case]
    stand_in = StandIn()
    runner = GraphedForward(stand_in, "cpu")
    x, cond, t = _inputs()
    before = _counts()
    first = _call(runner, model, x, cond, t)
    assert torch.equal(first, _eager(model, x, cond, t))
    assert _since(before) == (1, 0, 0) and stand_in.calls == 1
    change(model)
    x2, cond2, t2 = _inputs(batch=second.get("batch", 2), seed=2)
    with model_precision(conv=second.get("conv"), matmul=second.get("matmul")):
        got = _call(runner, model, x2, cond2, t2)
        want = _eager(model, x2, cond2, t2)
    assert torch.equal(got, want)
    assert _since(before) == ((2, 0, 0) if captures else (1, 1, 0))
    assert stand_in.calls == 1 + captures
    # the output is a tensor of its own, never a graph's buffer
    assert all(got.data_ptr() != b.output.data_ptr() for b in stand_in.blocks)


def test_the_oldest_graph_is_freed_past_the_cap(model):
    stand_in = StandIn()
    runner = GraphedForward(stand_in, "cpu")
    batches = list(range(1, GRAPHS_PER_MODULE + 2))
    before = _counts()
    for b in batches:
        _call(runner, model, *_inputs(batch=b))
    assert [blk.closed for blk in stand_in.blocks] == [True] + [False] * GRAPHS_PER_MODULE
    _call(runner, model, *_inputs(batch=batches[-1]))  # still held: a replay
    _call(runner, model, *_inputs(batch=batches[0]))  # freed: captured again
    assert _since(before) == (len(batches) + 1, 1, 0)
    assert [blk.closed for blk in stand_in.blocks] == [True, True] + [False] * GRAPHS_PER_MODULE


@pytest.mark.parametrize("case", ["grad", "cpu", "not_a_tensor"])
def test_calls_that_cannot_replay_run_eagerly(model, case):
    stand_in = StandIn()
    runner = GraphedForward(stand_in, "cuda" if case == "cpu" else "cpu")
    x, cond, t = _inputs()
    before = _counts()
    for _ in range(2):
        if case == "grad":
            with torch.enable_grad(), graphed.scope(runner):
                got = model(x, cond, time=t)
            assert got.requires_grad
        elif case == "not_a_tensor":
            with graphed.scope(runner):
                got = runner(model, lambda *a: model._forward(x, cond, None, t), x, cond, 0.5)
        else:
            got = _call(runner, model, x, cond, t)
        assert torch.equal(got, _eager(model, x, cond, t))
    assert _since(before) == (0, 0, 2) and stand_in.calls == 0


def test_a_failed_capture_runs_eagerly_and_is_not_retried(model, caplog):
    stand_in = StandIn(fail=True)
    runner = GraphedForward(stand_in, "cpu")
    x, cond, t = _inputs()
    before = _counts()
    with caplog.at_level(logging.WARNING, logger=graphed.__name__):
        for _ in range(3):
            assert torch.equal(_call(runner, model, x, cond, t), _eager(model, x, cond, t))
    assert stand_in.calls == 1 and _since(before) == (0, 0, 3)
    assert len([r for r in caplog.records if "could not be captured" in r.getMessage()]) == 1


def _sample_with_hook(diffusion, cond, seed, steps=STEPS):
    """(output, [(the hook's x, the hook's output)] a step)."""
    rec = []
    handle = diffusion.model.register_forward_hook(
        lambda m, args, kwargs, out: rec.append((args[0], out)), with_kwargs=True)
    try:
        out = diffusion.sample(cond, steps, generator=torch.Generator().manual_seed(seed))
    finally:
        handle.remove()
    return out, rec


def test_the_sampler_hook_sees_its_own_x_and_a_new_output_each_step():
    diffusion = _diffusion()
    eager = _diffusion()  # the same weights; its own runner keeps CPU calls eager
    stand_in = StandIn()
    diffusion.graphs = GraphedForward(stand_in, "cpu")
    _, cond, _ = _inputs()
    before = _counts()
    runs = [_sample_with_hook(diffusion, cond, seed) for seed in (3, 4)]
    assert _since(before) == (1, 2 * STEPS - 1, 0) and stand_in.calls == 1
    before = _counts()
    want = [_sample_with_hook(eager, cond, seed) for seed in (3, 4)]
    assert _since(before) == (0, 0, 2 * STEPS)
    (block,) = stand_in.blocks
    ((inputs, _),) = diffusion.graphs._modules()[diffusion.model].graphs.values()
    statics = {t.data_ptr() for t in inputs if t is not None}
    for (out, rec), (want_out, want_rec) in zip(runs, want):
        assert torch.equal(out, want_out) and len(rec) == STEPS
        outputs = [o for _, o in rec]
        assert len({o.data_ptr() for o in outputs}) == STEPS
        assert block.output.data_ptr() not in {o.data_ptr() for o in outputs}
        assert not statics & {x.data_ptr() for x, _ in rec}
        for (x, o), (want_x, want_o) in zip(rec, want_rec):
            assert torch.equal(x, want_x) and torch.equal(o, want_o)
        # each step's x is the sampler's update of the last: different
        # tensors, none the graph's input
        assert len({x.data_ptr() for x, _ in rec}) == STEPS


def test_a_self_conditioned_request_replays_one_graph():
    """Step 0 hands the model a zeros tensor, not None, so that every step
    of a request has one key: one capture, then replays, and the same
    outputs as the eager sampler."""
    kw = dict(self_condition=True, use_full_attention=True)
    diffusion, eager = _diffusion(**kw), _diffusion(**kw)
    stand_in = StandIn()
    diffusion.graphs = GraphedForward(stand_in, "cpu")
    _, cond, _ = _inputs()
    before = _counts()
    got = [diffusion.sample(cond, STEPS, generator=torch.Generator().manual_seed(s))
           for s in (3, 4)]
    assert _since(before) == (1, 2 * STEPS - 1, 0) and stand_in.calls == 1
    ((inputs, _),) = diffusion.graphs._modules()[diffusion.model].graphs.values()
    assert inputs[2] is not None  # the estimate is one of the graph's inputs
    want = [eager.sample(cond, STEPS, generator=torch.Generator().manual_seed(s))
            for s in (3, 4)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_capture_is_a_span_in_the_first_step():
    diffusion = _diffusion()
    diffusion.graphs = GraphedForward(StandIn(), "cpu")
    cond = torch.zeros(1, S, S, 5)
    with recording() as recorder:
        for seed in (1, 2):
            diffusion.sample(cond, 3, generator=torch.Generator().manual_seed(seed))
    (capture,) = [s for s in recorder.spans if s.name == "sample.capture"]
    parent = recorder.spans[capture.parent]
    assert parent.name == "sample.step" and parent.step == 0 and parent.request == 0
    assert parent.start_ns <= capture.start_ns <= capture.end_ns <= parent.end_ns


def test_a_captured_block_counts_its_launches_at_each_replay():
    def wrapper():
        pass

    wrapper.launches = wrapper.launches_fwd = 0

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    graphs.count(wrapper)
    assert (wrapper.launches, wrapper.launches_fwd) == (1, 0)
    graphs._capture.tally = {}
    try:
        graphs.count(wrapper)
        graphs.count(wrapper)
        graphs.count(wrapper, "launches_fwd")
        tally = graphs._capture.tally
    finally:
        graphs._capture.tally = None
    assert (wrapper.launches, wrapper.launches_fwd) == (1, 0)  # recorded, not launched
    block = graphs.CapturedBlock(Graph(), tally)
    for _ in range(3):
        block.replay()
    assert (wrapper.launches, wrapper.launches_fwd, Graph.replays) == (7, 3, 3)


# ---- the card -----------------------------------------------------------


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_IMAGE, CARD_STAGES = 64, 3


def _card_diffusion(device, **kw):
    diffusion = make_diffusion_model(image_size=CARD_IMAGE, input_dim=32, num_stages=CARD_STAGES,
                                     timesteps=1000, use_flash_attention=True, device=device,
                                     generator=torch.Generator(device=device).manual_seed(0),
                                     **kw)
    diffusion.model.eval()
    return diffusion


def _card_sample(diffusion, cond, noise, eager):
    """(output, hook records, (flash, GroupNorm+SiLU forward) launches,
    the runner's counts) of one sample, eagerly where `eager`."""
    rec = []
    handle = diffusion.model.register_forward_hook(
        lambda m, args, kwargs, out: rec.append((args[0], out, kwargs.get("x_self_condition"))),
        with_kwargs=True)
    launches = flash_attention.launches, group_norm_silu.launches_fwd
    before = _counts()
    active = graphed.active
    try:
        if eager:
            graphed.active = lambda: None
        out = diffusion.sample(cond, STEPS, noise=noise)
        torch.cuda.synchronize()
    finally:
        graphed.active = active
        handle.remove()
    return (out, rec, (flash_attention.launches - launches[0],
                       group_norm_silu.launches_fwd - launches[1]), _since(before))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
def test_graphed_sampling_matches_eager_on_the_card():
    device = cuda_or_skip()
    diffusion = _card_diffusion(device)
    gen = torch.Generator(device=device).manual_seed(1)
    cond = torch.randn((2, CARD_IMAGE, CARD_IMAGE, 5), generator=gen, device=device)
    noise = torch.randn((STEPS + 1, 2, CARD_IMAGE, CARD_IMAGE, 2), generator=gen, device=device)
    eager = _card_sample(diffusion, cond, noise, eager=True)
    first = _card_sample(diffusion, cond, noise, eager=False)
    second = _card_sample(diffusion, cond, noise, eager=False)
    assert eager[3] == (0, 0, 0)
    assert first[3] == (1, STEPS - 1, 0) and second[3] == (0, STEPS, 0)
    # the same launches a call under both, a step's 3 flash and 9
    # GroupNorm+SiLU forwards at this width
    assert eager[2] == first[2] == second[2] and eager[2][0] > 0 and eager[2][1] > 0
    gaps = []
    for got in (first, second):
        gaps.append(_rel(got[0], eager[0]))
        assert len(got[1]) == STEPS
        for (x, o, _), (want_x, want_o, _) in zip(got[1], eager[1]):
            gaps += [_rel(x, want_x), _rel(o, want_o)]
        assert len({o.data_ptr() for _, o, _ in got[1]}) == STEPS
    bitwise = all(torch.equal(got[0], eager[0]) for got in (first, second))
    print(f"graphed against eager: max relative gap {max(gaps):.3e}, bitwise {bitwise}; "
          f"launches a call {eager[2]}")
    assert max(gaps) <= 1e-6


@pytest.mark.gpu
def test_a_replay_reads_weights_updated_in_place_and_recaptures_replaced_ones():
    device = cuda_or_skip()
    diffusion = _card_diffusion(device)
    gen = torch.Generator(device=device).manual_seed(2)
    cond = torch.randn((2, CARD_IMAGE, CARD_IMAGE, 5), generator=gen, device=device)
    noise = torch.randn((STEPS + 1, 2, CARD_IMAGE, CARD_IMAGE, 2), generator=gen, device=device)
    before = _card_sample(diffusion, cond, noise, eager=False)
    _bump_in_place(diffusion.model)
    got = _card_sample(diffusion, cond, noise, eager=False)
    want = _card_sample(diffusion, cond, noise, eager=True)
    assert got[3] == (0, STEPS, 0)
    assert _rel(got[0], want[0]) <= 1e-6 and _rel(got[0], before[0]) > 1e-3
    _replace_weights(diffusion.model)
    _bump_in_place(diffusion.model)
    got = _card_sample(diffusion, cond, noise, eager=False)
    want = _card_sample(diffusion, cond, noise, eager=True)
    assert got[3] == (1, STEPS - 1, 0)
    assert _rel(got[0], want[0]) <= 1e-6


@pytest.mark.gpu
def test_self_conditioned_graphed_sampling_matches_eager_bit_for_bit_on_the_card():
    """Full attention at every stage and the estimate fed back: the graphed
    sampler against the eager one, bit for bit, step 0's estimate zeros
    and each later one the last step's clamped x0; one capture for the
    request's key, then replays only."""
    device = cuda_or_skip()
    diffusion = _card_diffusion(device, use_full_attention=True, self_condition=True)
    gen = torch.Generator(device=device).manual_seed(3)
    cond = torch.randn((2, CARD_IMAGE, CARD_IMAGE, 5), generator=gen, device=device)
    noise = torch.randn((STEPS + 1, 2, CARD_IMAGE, CARD_IMAGE, 2), generator=gen, device=device)
    eager = _card_sample(diffusion, cond, noise, eager=True)
    first = _card_sample(diffusion, cond, noise, eager=False)
    second = _card_sample(diffusion, cond, noise, eager=False)
    assert first[3] == (1, STEPS - 1, 0) and second[3] == (0, STEPS, 0)
    # a flash call at every stage and the middle, each step
    assert eager[2] == first[2] == second[2] and eager[2][0] == STEPS * (2 * CARD_STAGES + 1)
    for got in (first, second):
        assert torch.equal(got[0], eager[0])
        for (x, o, s), (want_x, want_o, want_s) in zip(got[1], eager[1]):
            assert torch.equal(x, want_x) and torch.equal(o, want_o) and torch.equal(s, want_s)
        assert not got[1][0][2].any()
