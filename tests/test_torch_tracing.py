"""The port's span recorder (fea_tpu_torch/utils/profiling.py) and the
spans of the train loop and the sampler loop, on the CPU.

Off (the default) `span()` hands back one shared no-op object and records
nothing, and `Trainer.train` and `GaussianDiffusion.sample` give the same
bits with a recording on as off. On, each loop leaves its spans with
their parents and identifiers, every child inside its parent; the spans
lie on torch.profiler's clock (a `record_function` inside a span lies
inside it there, one before it does not); `StageTimer` keeps its totals
and records its stages as `datagen.<stage>` spans; a garbage collection
is a `gc.gen<n>` span. Imports no JAX.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from fea_tpu_torch.models import make_diffusion_model
from fea_tpu_torch.train import trainer
from fea_tpu_torch.utils import profiling
from fea_tpu_torch.utils.profiling import StageTimer, recording, request_span, span

torch.set_num_threads(1)

S, DIM, STAGES, BATCH, ACCUM, T = 32, 8, 2, 2, 8, 4  # the Trainer's floor: 16 a step
TRAIN_STEPS, SAMPLE_STEPS = 3, 4
# the sleep on each side of a probe inside a span: the clocks' agreement
# that the clock test asks for
MARGIN_S = 1e-3


def _trainer(root, tag):
    from test_torch_precision import Dataset

    data = Dataset(BATCH * ACCUM, S, 1)
    tr = trainer.Trainer(trainer.TrainerConfig(
        dataset_image_size=S, train_batch_size=BATCH, num_gradient_accumulation_steps=ACCUM,
        input_dim=DIM, num_stages=STAGES, num_train_steps=TRAIN_STEPS,
        num_steps_per_milestone=10**9, num_steps_per_soft_milestone=10**9,
        skip_dataset_size_check=True, progress_bar=False,
        results_folder=str(root / tag), seed=0,
    ), dataset=data, sample_dataset=data, device="cpu")
    tr.save_checkpoint = lambda milestone: None
    return tr


def _params(tr):
    return [p.detach().clone() for key in sorted(tr.params) for p in tr.params[key]]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two Trainers from one seed, trained TRAIN_STEPS steps, the first
    without a recording, the second with one: (params off, params on,
    the recorder)."""
    root = tmp_path_factory.mktemp("tracing")
    off = _trainer(root, "off")
    off.train()
    on = _trainer(root, "on")
    with recording() as recorder:
        on.train()
    return _params(off), _params(on), recorder


def _diffusion():
    return make_diffusion_model(image_size=S, input_dim=DIM, num_stages=STAGES, timesteps=T,
                                device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def sampled():
    """One 4-step sample, the same condition and noise seed, off and on:
    (output off, output on, the recorder)."""
    diffusion = _diffusion()
    rng = np.random.default_rng(2)
    condition = torch.from_numpy(rng.normal(size=(2, S, S, 5)).astype(np.float32))

    def sample():
        return diffusion.sample(condition, SAMPLE_STEPS,
                                generator=torch.Generator().manual_seed(5))

    off = sample()
    with recording() as recorder:
        on = sample()
    return off, on, recorder


def _named(recorder, name):
    return [s for s in recorder.spans if s.name == name]


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_off_span_is_one_shared_object_and_records_nothing():
    assert profiling._active is None
    objects = {id(span("train.step")), id(span("train.fetch", step=3)),
               id(span("sample.step", step=1, request=2)), id(request_span("sample.request"))}
    assert objects == {id(profiling._OFF)}
    with span("train.step", step=0) as s:
        assert s is profiling._OFF and s.request is None
    with request_span("sample.request") as r:
        assert r.request is None
    assert profiling._active is None


def test_recording_is_one_at_a_time_and_ends_on_an_exception():
    with pytest.raises(ValueError):
        with recording() as recorder:
            with pytest.raises(RuntimeError):
                with recording():
                    pass
            assert recorder._gc_callback in gc.callbacks
            raise ValueError("out of the block")
    assert profiling._active is None
    assert recorder._gc_callback not in gc.callbacks
    assert span("x") is profiling._OFF


def test_train_gives_the_same_bits_with_a_recording(trained):
    off, on, _ = trained
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_train_spans_their_counts_parents_and_steps(trained):
    _, _, recorder = trained
    steps = _named(recorder, "train.step")
    assert [s.step for s in steps] == list(range(TRAIN_STEPS))
    assert all(s.parent is None for s in steps)
    by_index = {s.index: s for s in recorder.spans}
    for name in ("train.dispatch", "train.fetch", "train.loss_read"):
        assert len(_named(recorder, name)) == TRAIN_STEPS, name
    for s in _named(recorder, "train.dispatch"):
        parent = by_index[s.parent]
        assert parent.name == "train.step" and parent.step == s.step and _inside(s, parent)
    fetches = _named(recorder, "train.fetch")
    # the first batch before the loop, then batch i + 1 inside step i
    assert [s.step for s in fetches] == list(range(TRAIN_STEPS))
    assert fetches[0].parent is None
    for s in fetches[1:]:
        parent = by_index[s.parent]
        assert parent.name == "train.step" and parent.step == s.step - 1 and _inside(s, parent)
    reads = _named(recorder, "train.loss_read")
    # step i's loss is read inside step i + 1; the last one after the loop
    assert [s.step for s in reads] == list(range(TRAIN_STEPS))
    for s in reads[:-1]:
        parent = by_index[s.parent]
        assert parent.name == "train.step" and parent.step == s.step + 1 and _inside(s, parent)
    assert reads[-1].parent is None and reads[-1].start_ns > steps[-1].end_ns
    # dispatch, then the next fetch (none in the last step), then the late
    # read (none in the first)
    kids = [[s.name for s in recorder.spans if s.parent == step.index
             and not s.name.startswith("gc.")] for step in steps]
    assert kids == [["train.dispatch", "train.fetch"],
                    ["train.dispatch", "train.fetch", "train.loss_read"],
                    ["train.dispatch", "train.loss_read"]]


def test_sample_gives_the_same_bits_with_a_recording(sampled):
    off, on, _ = sampled
    assert torch.equal(off, on)


def test_sample_spans_share_one_request_in_order(sampled):
    _, _, recorder = sampled
    (request,) = _named(recorder, "sample.request")
    steps = _named(recorder, "sample.step")
    assert request.request == 0 and request.parent is None
    assert [s.step for s in steps] == list(range(SAMPLE_STEPS))
    assert all(s.request == request.request and s.parent == request.index for s in steps)
    assert all(_inside(s, request) for s in steps)
    assert all(a.end_ns <= b.start_ns for a, b in zip(steps, steps[1:]))


def test_requests_take_new_identifiers():
    diffusion = _diffusion()
    condition = torch.zeros(1, S, S, 5)
    with recording() as recorder:
        for seed in (1, 2):
            diffusion.sample(condition, 2, generator=torch.Generator().manual_seed(seed))
    requests = _named(recorder, "sample.request")
    assert [r.request for r in requests] == [0, 1]
    for r in requests:
        assert [s.request for s in recorder.spans if s.parent == r.index] == [r.request] * 2


def _kineto_event(prof, name):
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == name]
    return event.start_ns(), event.start_ns() + event.duration_ns()


def test_spans_lie_on_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with recording() as recorder:
            with torch.profiler.record_function("probe.before"):
                torch.ones(8).sum()
            time.sleep(MARGIN_S)
            with span("probe.span"):
                time.sleep(MARGIN_S)
                with torch.profiler.record_function("probe.inside"):
                    torch.ones(8).sum()
                time.sleep(MARGIN_S)
    (start, end, name, *_), = [s for s in recorder.on_profiler_clock() if s[2] == "probe.span"]
    inside = _kineto_event(prof, "probe.inside")
    before = _kineto_event(prof, "probe.before")
    assert start <= inside[0] <= inside[1] <= end
    assert before[1] < start


def test_spans_of_another_thread_have_their_own_parents():
    seen = {}

    def work():
        with span("worker") as s:
            seen["span"] = s

    with recording() as recorder:
        with span("main") as main:
            thread = threading.Thread(target=work)
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive()
    worker = seen["span"]
    assert worker.parent is None and main.parent is None
    assert worker.thread != main.thread and worker.thread == thread.native_id


def test_stage_timer_keeps_its_totals_and_records_datagen_spans():
    def stages(timer):
        with timer.stage("mesh"):
            with timer.stage("conditions"):
                pass
        with timer.stage("mesh"):
            pass

    off = StageTimer()
    stages(off)
    on = StageTimer()
    with recording() as recorder:
        stages(on)
    assert dict(off.counts) == dict(on.counts) == {"mesh": 2, "conditions": 1}
    assert set(on.as_dict()) == {"mesh", "conditions"}
    spans = [s for s in recorder.spans if not s.name.startswith("gc.")]
    assert [s.name for s in spans] == ["datagen.mesh", "datagen.conditions", "datagen.mesh"]
    assert spans[1].parent == spans[0].index and _inside(spans[1], spans[0])
    assert spans[2].parent is None
    total = sum(s.end_ns - s.start_ns for s in spans if s.name == "datagen.mesh") / 1e9
    assert 0 < total <= on.totals["mesh"]


def test_a_garbage_collection_is_a_span():
    with recording() as recorder:
        with span("outer") as outer:
            gc.collect()
    (collection,) = _named(recorder, "gc.gen2")
    assert collection.parent == outer.index and _inside(collection, outer)
    assert collection.end_ns > collection.start_ns


def test_spans_convert_to_the_profilers_clock_by_the_anchors():
    recorder = profiling.Recorder()
    recorder.anchors = [(1_000_000, 500), (1_002_000, 2_500)]
    assert recorder.profiler_ns(500) == 1_000_000
    assert recorder.profiler_ns(1_500) == 1_001_000
    recorder.anchors = [(1_000_000, 500), (1_004_000, 2_500)]  # a clock that runs at twice
    assert recorder.profiler_ns(1_500) == 1_002_000
