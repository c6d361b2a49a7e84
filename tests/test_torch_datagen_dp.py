"""The port's plate-sharded datagen (fea_tpu_torch.datagen.batched with
`devices` / `n_devices`, parallel/scaling.py) against the unsharded path and
against fea_tpu's sharding over the virtual CPU mesh, on the CPU.

One chunk: tests/test_torch_flatgroup.py's three plates (mesh 0.14 / 0.145
/ 0.15, 2 seeded conditions each), padded to 4 and split into 2 shards of
2 plates, against the unsharded chunk and fea_tpu's
`solve_plate_group(sharding=...)` over 2 devices; the same chunk warm
started, each shard against the unsharded chunk of its own plates. Each shard stops at its
own slowest lane, where one flat system runs every lane to the chunk's
slowest, so the lanes agree within 1e-4 of their largest displacement
(where both converge), not bit for bit. Then `generate_data_batched(
n_devices=2)` at tests/test_torch_datagen.py's config (3 plates, 64 px,
mesh 0.12) against fea_tpu's `n_devices=2` tree, with that file's
tolerances (PNGs within 1 gray level); the CLI's `generate --batched
--num_devices 2 --device cpu`; and the weak-scaling measurements on CPU
shards and ranks, for their contract only (a CPU time says nothing of a
card's).
"""

import contextlib
import io
import math
import os
import threading

import jax
import numpy as np
import pytest
import torch

from fea_tpu_torch import cli
from fea_tpu_torch.datagen import batched
from fea_tpu_torch.parallel import scaling
from test_torch_datagen import CONFIG, assert_same_tree
from test_torch_flatgroup import jax_payloads, payload_problems, port_payloads

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]
U_REL = 1e-4


@pytest.fixture(scope="module")
def plates():
    return payload_problems()


def assert_lanes_close(got, want):
    """u of every lane that converges on both sides within U_REL of the
    lane's largest displacement; returns how many lanes were compared."""
    compared = 0
    for plate_got, plate_want in zip(got, want, strict=True):
        for a, b in zip(plate_got, plate_want, strict=True):
            if not (a.success and b.success):
                continue
            ua, ub = np.asarray(a.displacements), np.asarray(b.displacements)
            assert np.abs(ua - ub).max() <= U_REL * max(np.abs(ub).max(), 1e-30)
            compared += 1
    return compared


def test_sharded_chunk_matches_unsharded_and_fea_tpu(plates):
    from jax.sharding import NamedSharding, PartitionSpec

    from fea_tpu.datagen.batched import LAST_DISPATCH as JLAST_DISPATCH
    from fea_tpu.datagen.batched import solve_plate_group as jsolve_plate_group
    from fea_tpu.parallel.mesh import make_mesh

    ours = port_payloads(plates)
    whole = batched.solve_plate_group(ours, pad_group_to=4)
    info = {}
    token = batched.dispatch_plate_group(ours, pad_group_to=4, devices=CPU2, info=info)
    packed = token.result()
    assert packed.device.type == "cpu" and packed.shape[0] == 4
    assert batched.LAST_DISPATCH == dict(n_devices=1, n_shards=2, rows=4, shard_rows=2)
    assert info["host_reads"] >= 4 and info["loop_s"] > 0 and info["seconds"] > 0
    sharded = batched.unpack_plate_group(packed.numpy(), ours)
    assert assert_lanes_close(sharded, whole) == 6
    # the padded plate (a repeat of the last) is solved in the second shard
    np.testing.assert_array_equal(packed[3].numpy(), packed[2].numpy())

    with jax.enable_x64(False):
        theirs = jax_payloads(plates)
        sharding = NamedSharding(make_mesh(2), PartitionSpec("dp"))
        want = jsolve_plate_group(theirs, sharding=sharding, pad_group_to=4)
    assert (JLAST_DISPATCH["n_shards"], JLAST_DISPATCH["shard_rows"]) == (2, 2)
    assert assert_lanes_close(sharded, want) == 6

    with pytest.raises(ValueError, match="3 plates do not split over 2 shards"):
        batched.dispatch_plate_group(ours, devices=CPU2)
    with pytest.raises(ValueError, match="1 solve workers for 2 shards"):
        batched.dispatch_plate_group(ours, pad_group_to=4, devices=CPU2,
                                     workers=[batched.SolveWorker()])


def test_sharded_warm_starts_match_unsharded(plates):
    """A continuation's chunk (warm starts from a 10-iteration solve)
    through two CPU shards: every shard's rows equal bit for bit the
    unsharded chunk of its own plates (the same code at the same shape),
    and the lanes agree with the unsharded 4-plate chunk within U_REL."""
    ours = port_payloads(plates)
    partial = batched.solve_plate_group(ours, max_iters=10)
    assert not any(r.success for plate in partial for r in plate)
    x0s = [[np.asarray(r.displacements[-1], np.float32) for r in plate] for plate in partial]
    whole = batched.dispatch_plate_group(ours, pad_group_to=4, x0s=x0s).result()
    sharded = batched.dispatch_plate_group(ours, pad_group_to=4, x0s=x0s, devices=CPU2).result()
    padded, padded_x0s = ours + ours[-1:], x0s + x0s[-1:]
    for k in range(2):
        alone = batched.dispatch_plate_group(padded[2 * k:2 * k + 2],
                                             x0s=padded_x0s[2 * k:2 * k + 2]).result()
        assert torch.equal(sharded[2 * k:2 * k + 2], alone)
    got = batched.unpack_plate_group(sharded.numpy(), ours)
    assert assert_lanes_close(got, batched.unpack_plate_group(whole.numpy(), ours)) == 6
    # the warm starts were used: fewer iterations than the cold solve's
    cold = batched.solve_plate_group(ours, pad_group_to=4)
    assert (sum(r.iterations for plate in got for r in plate)
            < sum(r.iterations for plate in cold for r in plate))


def test_shard_devices():
    cpu = torch.device("cpu")
    assert batched.shard_devices("cpu", 3) == [cpu] * 3
    assert batched.shard_devices(["cpu", "cpu"], 2) == [cpu, cpu]
    with pytest.raises(ValueError, match="1 devices named for 2 shards"):
        batched.shard_devices(["cpu"], 2)
    with pytest.raises(ValueError, match="n_devices=0"):
        batched.shard_devices("cpu", 0)


def test_generate_data_batched_on_two_shards_matches_fea_tpu(tmp_path):
    """Two CPU shards of one plate each against fea_tpu's n_devices=2 over
    the virtual mesh: the same counters and the same tree."""
    from fea_tpu.datagen.batched import generate_data_batched as jgenerate

    kw = dict(CONFIG, batch_size=2, n_devices=2)
    stats = batched.generate_data_batched(data_dir=str(tmp_path / "ours"), device="cpu", **kw)
    assert batched.LAST_DISPATCH == dict(n_devices=1, n_shards=2, rows=2, shard_rows=1)
    with jax.enable_x64(False):
        jstats = jgenerate(data_dir=str(tmp_path / "theirs"), **kw)
    for key in ("plates", "lane_dispatches", "solves", "host_rejections", "cg_failures",
                "direct_fallbacks", "cg_resamples", "continuations", "chunks", "final_buckets"):
        assert stats[key] == jstats[key], key
    assert stats["plates"] == 3 and stats["host_reads"] > 0
    assert_same_tree(str(tmp_path / "ours"), str(tmp_path / "theirs"))
    assert not any(t.name.startswith("fea-solve") for t in threading.enumerate())


def test_cli_generate_on_two_cpu_shards(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--device", "cpu", "generate", *map(str, [
            "--batched", "--num_devices", 2, "--num_plates", 2, "--conditions_per_plate", 2,
            "--steps_per_condition", 2, "--mesh_size", 0.12, "--image_size", 32,
            "--save_displacement", "--data_dir", tmp_path, "--seed", 3])])
    assert '"plates": 2' in out.getvalue()
    assert batched.LAST_DISPATCH["n_shards"] == 2
    for plate in ("1", "2"):
        assert os.path.isfile(tmp_path / plate / "input.png")
        for condition in ("1", "2"):
            assert os.path.isfile(tmp_path / plate / condition / "outputs_displacement_x.png")


def test_sharding_efficiency_on_cpu_shards():
    """One plate on each of 2 CPU shards: the placement check and the
    1e-5 agreement run inside; the result carries its spread."""
    out = scaling.measure_sharding_efficiency(2, mesh_size=0.2, repeats=2, min_work_s=0.05,
                                              devices="cpu")
    assert out["devices"] == CPU2 and len(out["t_ndev_repeats_s"]) == 2
    lo, hi = out["efficiency_spread"]
    assert 0 < lo <= out["efficiency"] <= hi and math.isfinite(hi)
    assert out["efficiency"] == 2 * out["t_1dev_s"] / out["t_ndev_s"]


def test_train_sharding_efficiency_on_cpu_ranks():
    """The train step in a group of 1 gloo rank and of 2, at 2 rows per
    rank: times from inside each rank."""
    out = scaling.measure_train_sharding_efficiency(2, image_size=16, input_dim=8, repeats=2,
                                                    devices=CPU2, timeout_s=300)
    assert len(out["t_1dev_repeats_s"]) == len(out["t_ndev_repeats_s"]) == 2
    lo, hi = out["efficiency_spread"]
    assert 0 < lo <= out["efficiency"] <= hi and math.isfinite(hi)
