"""The cell `dit-sample-b2`: its files found by name, its metrics as the
spec declares them, DiT's counts at the published widths and on a small
configuration against the reference, the two new metrics on an empty
trace, and `correct` on the CPU at a small size for sound runs, the bf16
control and planted faults."""

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from portbench import faults, harness
from portbench.counts import dit as dit_counts
from portbench.reference import dit as ref_dit
from small import SEED, run_cell, small_cell

SPEC = harness.benchmark_spec()
DIT = "dit-sample-b2"
CONFIG = harness.load_json(harness.ROOT / "configs" / "dit-xl-p8-256-concat.json")
SMALL_DIT = dict(hidden_size=64, depth=2, num_heads=4, patch_size=8)
NEW = ("roofline_pct.linear.dit", "flash_calls_per_step.dit")


def run_small(trace=False, control=False, seconds=1.0):
    torch.set_num_threads(2)
    cell = small_cell(DIT, **SMALL_DIT)
    return run_cell(cell, SEED, seconds, trace, torch.device("cpu"), control=control)


def small_config():
    return {"model": dict(CONFIG["model"], image_size=32, **SMALL_DIT)}


def test_the_cell_finds_its_files_and_metrics():
    found = harness.find_cell(DIT, SPEC)
    assert found.driver == "sample_dit" and found.chips == 1
    assert found.config == CONFIG and found.config["reduced"] == []
    assert {m["name"] for m in found.end_to_end} == {
        "denoise_step_ms", "request_ms_p50", "request_ms_p95", "setup_s"}
    assert {m["name"] for m in found.per_layer} == {
        "idle_pct.sample", "mfu.sample", "roofline_pct.flash.sample", "learned_range_pct.adm",
        *NEW}


def test_dit_counts_at_published_widths():
    # 1.051 TFLOP an image: DiT's published 524.6 G multiply-adds for XL/2-512
    assert abs(dit_counts.forward_flops(CONFIG, 1) / 1.0506e12 - 1) < 0.001
    assert abs(dit_counts.forward_flops(CONFIG, 2) / 2.1012e12 - 1) < 0.001
    assert abs(dit_counts.linear_flops(CONFIG, 2) / 1.8286e12 - 1) < 0.001
    net = ref_dit.build(CONFIG)["model"]
    assert sum(isinstance(m, nn.Linear) for m in net.modules()) == 144
    assert dit_counts.flash_shapes(CONFIG, 2) == [(32, 1024, 1024, 72)] * 28
    assert sum(p.numel() for p in net.parameters()) == CONFIG["parameters"]["model"]
    assert net.pos_embed.numel() == CONFIG["parameters"]["pos_embed"]


def test_the_counts_hold_to_the_reference_on_a_small_config():
    """The linears' and the attention's operations, counted apart, add up
    to FlopCounterMode's total over the reference less its patch
    convolution's; each linear's share is its rows times in times out."""
    config, batch = small_config(), 3
    net = ref_dit.build(config)["model"]
    tokens, width = (32 // 8) ** 2, 64
    conv = 2 * batch * tokens * width * 7 * 8 * 8
    attention = sum(4 * bh * nq * nk * d for bh, nq, nk, d in dit_counts.flash_shapes(config,
                                                                                       batch))
    assert dit_counts.flash_shapes(config, batch) == [(batch * 4, tokens, tokens, 16)] * 2
    rows = {"t_embedder": batch, "adaLN_modulation": batch}
    linear = 0
    for name, m in net.named_modules():
        if isinstance(m, nn.Linear):
            n = next((r for key, r in rows.items() if key in name), batch * tokens)
            linear += 2 * n * m.in_features * m.out_features
    assert dit_counts.linear_flops(config, batch) == linear
    assert sum(isinstance(m, nn.Linear) for m in net.modules()) == 4 + 5 * 2
    assert dit_counts.forward_flops(config, batch) == linear + attention + conv
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        s = 32
        net(torch.empty((batch, s, s, 2), device="meta"),
            torch.empty((batch, s, s, 5), device="meta"), torch.empty((batch,), device="meta"))
    assert counter.get_total_flops() == linear + attention + conv


def test_the_new_metrics_read_nothing_on_an_empty_trace():
    class Empty:
        kernels = []
        window_s = 5.0

        def seconds_by_kernel(self, match):
            return 0.0, 0

    for name in NEW:
        read = harness.metric_module(name).read
        assert read(harness.Outcome(0, 0, {}, 0, [], facts={})) is None
        assert read(harness.Outcome(0, 0, {}, 0, [], facts={"forwards": 50})) is None
        assert read(harness.Outcome(0, 0, {}, 0, [], facts={"forwards": 50, "linear_flops": 1e12},
                                    trace=Empty())) is None


def test_the_new_metrics_read_what_they_declare():
    calls = harness.metric_module("flash_calls_per_step.dit").read
    assert calls(harness.Outcome(0, 0, {}, 0, [], facts={"forwards": 50,
                                                          "flash_d72_calls": 1400})) == 28.0
    linear = harness.metric_module("roofline_pct.linear.dit")

    class Trace:
        kernels = [(0, 2_000_000, "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT", "?"),
                   (0, 1_000_000, "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32", "?"),
                   (0, 5_000_000, "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc", "?"),
                   (0, 7_000_000, "void (anonymous namespace)::flash_fwd_kernel<float, 72>", "?"),
                   (0, 3_000_000, "void at::native::vectorized_layer_norm_kernel<float>", "?")]

        def seconds_by_kernel(self, match):
            hits = [e - s for s, e, name, _ in self.kernels if match(name)]
            return sum(hits) / 1e9, len(hits)

    facts = {"forwards": 50, "linear_flops": 0.495e12}  # 1 ms at the TF32 peak
    outcome = harness.Outcome(0, 0, {}, 0, [], facts=facts, trace=Trace())
    assert linear.read(outcome) == pytest.approx(100.0 / 3)


def test_a_sound_run_is_correct():
    _, line = run_small()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1


def test_the_bf16_control_is_not_correct():
    outcome, _ = run_small(control=True)
    assert outcome.control_checks
    assert not harness.correct(outcome.control_checks), outcome.control_checks


def test_a_traced_sampling_run_reads_the_counters():
    outcome, line = run_small(trace=True)
    assert line["correct"]
    # the CPU has no device trace and runs flash's plain version (uncounted)
    assert set(line["metrics"]) == {"mfu.sample", "learned_range_pct.adm",
                                    "flash_calls_per_step.dit"}
    assert line["metrics"]["learned_range_pct.adm"]["value"] == 96.0
    assert line["metrics"]["flash_calls_per_step.dit"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["altered_output", "half_requests", "stale_step"])
def test_a_broken_sampler_is_not_correct(fault):
    remove = faults.FAULTS[fault]()
    try:
        _, line = run_small()
    finally:
        remove()
    assert not line["correct"], (fault, line["checks"])
