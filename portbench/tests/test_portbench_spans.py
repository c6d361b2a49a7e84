"""The arithmetic of portbench/spans.py on synthetic kernels and spans,
with exact answers: a gap half covered by a fetch, nested spans, a gap
outside every span, spans of two threads open at once, a window that
cuts kernels and spans."""

from portbench.spans import idle_by_innermost, idle_by_name, idle_by_span, idle_gaps

WINDOW = (0, 100)


def test_gaps_are_the_windows_time_with_no_kernel():
    kernels = [(10, 20, "a", "?"), (15, 30, "b", "?"), (50, 60, "c", "?"), (95, 120, "d", "?")]
    assert idle_gaps(kernels, WINDOW) == [(0, 10), (30, 50), (60, 95)]
    assert idle_gaps([], WINDOW) == [(0, 100)]
    assert idle_gaps([(-5, 100, "all", "?")], WINDOW) == []


def test_a_gap_half_covered_by_a_fetch():
    # the card idles 40-60; the host fetches 50-70 inside step 0 (0-100)
    kernels = [(0, 40, "k", "?"), (60, 100, "k", "?")]
    spans = [(0, 100, "train.step", None), (50, 70, "train.fetch", 0)]
    assert idle_by_innermost(kernels, spans, WINDOW) == {0: 10, 1: 10}
    assert idle_by_span(kernels, spans, WINDOW, ["train.fetch"]) == (10, 0)
    assert idle_by_span(kernels, spans, WINDOW, ["train.step"]) == (20, 0)


def test_nested_spans_charge_the_innermost_and_count_for_their_ancestors():
    kernels = [(0, 10, "k", "?"), (90, 100, "k", "?")]  # idle 10-90
    spans = [
        (5, 95, "train.step", None),
        (20, 60, "train.fetch", 0),
        (30, 40, "gc.gen0", 1),
        (70, 80, "train.loss_read", 0),
    ]
    assert idle_by_name(kernels, spans, WINDOW) == {
        "train.step": 10 + 10 + 10, "train.fetch": 10 + 20, "gc.gen0": 10,
        "train.loss_read": 10}
    # the collector's pause inside the fetch counts for the fetch
    assert idle_by_span(kernels, spans, WINDOW, ["train.fetch"]) == (40, 0)
    assert idle_by_span(kernels, spans, WINDOW, ["gc.gen0"]) == (10, 0)


def test_a_gap_outside_every_span():
    kernels = [(0, 20, "k", "?"), (40, 60, "k", "?")]  # idle 20-40 and 60-100
    spans = [(50, 70, "sample.step", None)]
    assert idle_by_innermost(kernels, spans, WINDOW) == {None: 20 + 30, 0: 10}
    assert idle_by_span(kernels, spans, WINDOW, ["sample.step"]) == (10, 50)


def test_spans_of_two_threads_charge_the_one_that_began_last():
    kernels = []  # idle all through
    spans = [(0, 60, "sample.step", None), (20, 40, "gc.gen1", None)]
    assert idle_by_innermost(kernels, spans, WINDOW) == {0: 20 + 20, 1: 20, None: 40}


def test_the_window_cuts_spans_and_kernels():
    kernels = [(-50, 10, "k", "?"), (90, 150, "k", "?")]  # idle 10-90
    spans = [(-30, 30, "train.fetch", None), (80, 200, "train.dispatch", None)]
    assert idle_by_innermost(kernels, spans, WINDOW) == {0: 20, None: 50, 1: 10}
    assert sum(idle_by_innermost(kernels, spans, WINDOW).values()) == 80
