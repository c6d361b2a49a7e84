"""The cell `adm-sample-b2`: its files found by name, its metrics as the
spec declares them, ADM's counts at the published widths, and `correct` on
the CPU at a small size for sound runs, the bf16 control and planted
faults."""

import pytest
import torch

from portbench import faults, harness
from portbench.counts import adm as adm_counts
from portbench.reference import adm as ref_adm
from small import SEED, run_cell, small_cell

SPEC = harness.benchmark_spec()
ADM = "adm-sample-b2"
CONFIG = harness.load_json(harness.ROOT / "configs" / "adm-256-concat.json")
SMALL_ADM = dict(model_channels=64, channel_mult=[1, 2], attention_resolutions=[16])


def run_small(trace=False, control=False, seconds=1.0):
    torch.set_num_threads(2)
    cell = small_cell(ADM, **SMALL_ADM)
    return run_cell(cell, SEED, seconds, trace, torch.device("cpu"), control=control)


def test_the_cell_finds_its_files_and_metrics():
    found = harness.find_cell(ADM, SPEC)
    assert found.driver == "sample_adm" and found.chips == 1
    assert found.config == CONFIG and found.config["reduced"] == []
    assert {m["name"] for m in found.end_to_end} == {
        "denoise_step_ms", "request_ms_p50", "request_ms_p95", "setup_s"}
    assert {m["name"] for m in found.per_layer} == {
        "idle_pct.sample", "mfu.sample", "roofline_pct.flash.sample", "learned_range_pct.adm",
        "norm_ms.adm"}


def test_the_new_metrics_read_what_they_declare():
    read = harness.metric_module("learned_range_pct.adm").read
    facts = {"learned_range_steps": 48, "final_steps": 2, "forwards": 50}
    assert read(harness.Outcome(0, 0, {}, 0, [], facts=facts)) == 96.0
    assert read(harness.Outcome(0, 0, {}, 0, [], facts={"forwards": 50})) is None
    norm = harness.metric_module("norm_ms.adm")
    assert norm.read(harness.Outcome(0, 0, {}, 0, [], facts=facts)) is None  # no trace

    class Trace:
        kernels = [(0, 2_000_000, "void (anonymous namespace)::fwd_cluster<float>(FwdArgs)", "?"),
                   (0, 1_000_000, "RowwiseMomentsCUDAKernel<float>", "?"),
                   (0, 5_000_000, "sm90_xmma_fprop_implicit_gemm", "?")]

        def seconds_by_kernel(self, match):
            hits = [e - s for s, e, name, _ in self.kernels if match(name)]
            return sum(hits) / 1e9, len(hits)

    outcome = harness.Outcome(0, 0, {}, 0, [], facts=facts, trace=Trace())
    assert norm.read(outcome) == pytest.approx(3.0 / 50)


def test_adm_counts_at_published_widths():
    # 2.240 TFLOP an image (convolutions, matmuls and attention's products)
    assert abs(adm_counts.forward_flops(CONFIG, 1) / 2.240e12 - 1) < 0.005
    shapes = adm_counts.flash_shapes(CONFIG, 2)
    assert sorted(shapes) == sorted([(16, 1024, 1024, 64)] * 5 + [(32, 256, 256, 64)] * 5
                                    + [(32, 64, 64, 64)] * 6)
    attention = sum(4 * bh * nq * nk * d for bh, nq, nk, d in shapes)
    assert abs(attention / 24.36e9 - 1) < 0.001
    net = ref_adm.build(CONFIG)["model"]
    assert sum(p.numel() for p in net.parameters()) == CONFIG["parameters"]["model"]


def test_a_sound_run_is_correct():
    _, line = run_small()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1


def test_the_bf16_control_is_not_correct():
    outcome, _ = run_small(control=True)
    assert outcome.control_checks
    assert not harness.correct(outcome.control_checks), outcome.control_checks


def test_a_traced_sampling_run_reads_the_learned_range_share():
    outcome, line = run_small(trace=True)
    assert line["correct"]
    # the CPU has no device trace: the counters and the whole step's share
    assert set(line["metrics"]) == {"mfu.sample", "learned_range_pct.adm"}
    assert line["metrics"]["learned_range_pct.adm"]["value"] == 96.0


@pytest.mark.parametrize("fault", ["altered_output", "half_requests", "stale_step"])
def test_a_broken_sampler_is_not_correct(fault):
    remove = faults.FAULTS[fault]()
    try:
        _, line = run_small()
    finally:
        remove()
    assert not line["correct"], (fault, line["checks"])
