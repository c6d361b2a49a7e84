"""The cell `ddpm-fullattn-sample-b2`: its files found by name, its
metrics as the spec declares them, the reference and counts of the
full-attention, self-conditioned denoiser, and `correct` on the CPU at 32
px for sound runs, the bf16 control and planted faults."""

import pytest
import torch

from portbench import faults, harness
from portbench.counts import fullattn
from portbench.reference import fdnunet, fdnunet_fullattn
from small import run_small

SPEC = harness.benchmark_spec()
FULLATTN = "ddpm-fullattn-sample-b2"
CONFIG = harness.load_json(harness.ROOT / "configs" / "fdnunet-ddpm-256-fullattn-selfcond.json")


def test_the_cell_finds_its_files():
    found = harness.find_cell(FULLATTN, SPEC)
    assert found.driver == "sample_ddpm_selfcond" and found.chips == 1
    assert found.config == CONFIG
    assert (harness.ROOT / "drivers" / f"{found.driver}.py").is_file()
    reported = {m["name"] for m in found.end_to_end}
    assert reported == {"denoise_step_ms", "request_ms_p50", "request_ms_p95", "setup_s"}
    assert found.per_layer and all(m["moves"] in reported for m in found.per_layer)


def test_the_full_attention_cell_reports_the_samplers_shares_and_its_own():
    names = {m["name"] for m in harness.find_cell(FULLATTN, SPEC).per_layer}
    assert names == {"idle_pct.sample", "mfu.sample", "roofline_pct.flash.sample",
                     "self_cond_pct.fullattn"}


def test_self_cond_pct_declares_what_the_spec_says():
    (entry,) = [m for m in SPEC["per_layer"] if m["name"] == "self_cond_pct.fullattn"]
    module = harness.metric_module(entry["name"])
    assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"]) == (
        "Sampler loop", "%", "program_counter", "denoise_step_ms")
    assert entry["workloads"] == [FULLATTN]
    read = module.read
    assert read(harness.Outcome(0, 0, {}, 0, [], facts={"self_cond_fed": 24,
                                                        "self_cond_zero": 1})) == 96.0
    assert read(harness.Outcome(0, 0, {}, 0, [], facts={"forwards": 25})) is None


def test_the_old_reference_refuses_the_new_kind_and_the_new_one_the_old():
    with pytest.raises(ValueError):
        fdnunet.build(CONFIG)
    with pytest.raises(ValueError):
        fdnunet_fullattn.build(harness.load_json(harness.ROOT / "configs" /
                                                 "fdnunet-ddpm-256.json"))


def test_the_configuration_has_a_source_of_its_own():
    """Another configuration's source and reduced keys would make this one
    no new configuration: its source names the two settings' upstream."""
    (entry,) = [c for c in SPEC["configs"] if c["name"] == CONFIG["name"]]
    assert entry["source"] == CONFIG["source"]
    assert entry["file"] == "portbench/configs/fdnunet-ddpm-256-fullattn-selfcond.json"
    for other in SPEC["configs"]:
        if other is not entry:
            assert (other["source"], other["reduced"]) != (entry["source"], entry["reduced"])


def test_parameters_at_published_widths():
    net = fdnunet_fullattn.build(CONFIG)["model"]
    assert sum(p.numel() for p in net.parameters()) == CONFIG["parameters"]["model"]
    assert CONFIG["reduced"] == []


def test_counts_at_the_cell_shape():
    # attention 9.39 TFLOP (four products of 2 Nq Nk D a head over the nine
    # calls) and the rest of the network 0.76, as the DDPM's forward
    flops = fullattn.forward_flops(CONFIG, 2)
    shapes = fullattn.flash_shapes(CONFIG, 2)
    attention = sum(4 * bh * nq * nk * d for bh, nq, nk, d in shapes)
    assert abs(attention / 9.39e12 - 1) < 0.01
    assert abs((flops - attention) / 0.76e12 - 1) < 0.02
    # operations bind every call: 8.886 ms for each stage-0 call
    assert abs(fullattn.flash_bound_s(CONFIG, 2) / (attention / 495e12) - 1) < 1e-9


def test_a_sound_run_is_correct():
    _, line = run_small(FULLATTN)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1


def test_the_bf16_reference_in_the_programs_place_is_not_correct():
    outcome, _ = run_small(FULLATTN, control=True)
    assert not harness.correct(outcome.control_checks), outcome.control_checks


def test_a_traced_run_reads_the_self_conditioned_share():
    outcome, line = run_small(FULLATTN, trace=True)
    assert line["correct"]
    # the CPU has no device trace: the counters and the whole step's share
    assert set(line["metrics"]) == {"mfu.sample", "self_cond_pct.fullattn"}
    assert line["metrics"]["self_cond_pct.fullattn"]["value"] == 96.0
    assert outcome.facts["forwards"] == 25 * (outcome.facts["self_cond_fed"] // 24)


@pytest.mark.parametrize("fault", ["altered_output", "half_requests", "stale_step"])
def test_a_broken_sampler_is_not_correct(fault):
    remove = faults.FAULTS[fault]()
    try:
        _, line = run_small(FULLATTN)
    finally:
        remove()
    assert not line["correct"], (fault, line["checks"])


def test_a_sampler_that_feeds_zeros_is_not_correct(monkeypatch):
    """The estimate left out (zeros at every step, as a sampler that stores
    self_condition and reads it nowhere would feed)."""
    from fea_tpu_torch.models.fdnunet import FDNUNet

    forward = FDNUNet._forward

    def zeros(self, x, cond, x_self, time):
        return forward(self, x, cond, None if x_self is None else torch.zeros_like(x_self), time)

    monkeypatch.setattr(FDNUNet, "_forward", zeros)
    _, line = run_small(FULLATTN)
    assert not line["correct"], line["checks"]
