"""Sharding efficiency of datagen and training, the port of
fea_tpu/parallel/scaling.py, with its method: WEAK scaling with
shape-identical per-shard work.

Datagen: every shard gets the SAME plate (one plate replicated n times),
so each shard's work is identical by construction: the same system, the
same CG trajectory, the same stopping point. The n-shard chunk is n
`flat_group_body` solves, one per shard, each on its solve worker and
device, with no collective. Where the n shards share the host's
interpreter or one card, zero-overhead sharding means t_n ~= n * t_1; on n
cards that run at once, t_n ~= t_1. In both

    efficiency = n * t_1 / t_n

reads the partition and dispatch overhead against the first case, and the
speed-up against the second. fea_tpu's reason for not timing a fixed TOTAL
work holds here too: one flat system runs every lane to the group's
slowest, the shards stop at their own, which is different work.

Training: the data-parallel train step, timed in a group of one rank and in
a group of n ranks at the same per-rank batch (n times the work), each
rank in its own process (parallel.launch). Both groups accumulate the same
number of micro-batches, the depth that keeps the one-rank group's
effective batch >= 16, so that the once-per-step all-reduce is spread
alike, and the times are per accumulated micro-batch.
"""

import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _spread(n: int, times_1: List[float], times_n: List[float]) -> List[float]:
    """The efficiency over every pairing of the repeats: a regression is
    only meaningful if it leaves this band."""
    effs = [n * a / b for a in times_1 for b in times_n]
    return [min(effs), max(effs)]


def measure_sharding_efficiency(
    n_devices: int,
    conditions_per_plate: int = 2,
    mesh_size: float = 0.05,
    repeats: int = 3,
    min_work_s: float = 1.0,
    devices=None,
) -> Dict:
    """Weak-scaling efficiency of the sharded plate-group solve over
    `n_devices` shards on `devices` (datagen.batched.shard_devices: None is
    `cuda:0` .. `cuda:n-1`; a list may repeat a card). Each timed
    measurement runs at least `min_work_s` of work (the solve is looped
    until the estimate crosses it), so that a 20% placement regression
    shows. Checks that the chunk really split one plate per shard
    (`batched.LAST_DISPATCH`) and that every shard's result is the 1-shard
    solve's within 1e-5. Returns the times and {'efficiency',
    'efficiency_spread', ...}."""
    from ..datagen.batched import LAST_DISPATCH, PlateSolver, shard_devices, solve_plate_group
    from ..datagen.conditions import ConditionSampler
    from ..fem.problem import StaticProblem
    from ..geometry import GeometryError, GeometrySampler
    from ..mesh import MeshError, triangulate_polygon

    shards = shard_devices(devices, n_devices)

    # one plate, replicated per shard -> per-shard work identical
    gs = GeometrySampler(random_seed=21)
    cs = ConditionSampler(random_seed=22)
    job = None
    while job is None:
        try:
            poly = gs.generate()
            mesh = triangulate_polygon(poly, mesh_size=mesh_size)
            conds = cs.sample(mesh, conditions_per_plate)
        except (GeometryError, MeshError, RuntimeError):  # a rejected draw: draw again
            continue
        probs = [
            StaticProblem.from_condition(
                mesh,
                material_regions=c["material_regions"],
                point_constraints=c["point_constraints"],
                edge_constraints=c["edge_constraints"],
                point_forces=c["point_forces"],
                edge_forces=c["edge_forces"],
                num_steps=2,
            )
            for c in conds
        ]
        if any(p.structurally_singular() for p in probs):
            continue
        job = (mesh, conds)

    mesh_geo, conds = job
    solver = PlateSolver(mesh_geo, 2, band_hb=-1, include_cell_fields=False, device=shards[0])
    payload = (solver, [solver.build_problem(c) for c in conds])

    def solve_once(n: int, on: Optional[Sequence]):
        return solve_plate_group([payload] * n, max_iters=600, devices=on, pad_group_to=n)

    # settle, then estimate the 1-shard solve (best of 3), and loop both
    # the same number of times so that each measurement is >= min_work_s
    solve_once(1, shards[:1])
    t_est = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        solve_once(1, shards[:1])
        t_est = min(t_est, time.perf_counter() - t0)
    inner = max(1, int(np.ceil(min_work_s / max(t_est, 1e-4))))

    def timed(n: int, on):
        for _ in range(3):  # settle
            solve_once(n, on)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(inner):
                out = solve_once(n, on)
            times.append(time.perf_counter() - t0)
        return min(times), out, times

    t_1, out_1, times_1 = timed(1, shards[:1])
    t_n, out_n, times_n = timed(n_devices, shards)

    # the chunk must really have split one plate per shard: a chunk solved
    # whole would otherwise read as efficiency ~1
    if LAST_DISPATCH.get("n_shards") != n_devices or (
        LAST_DISPATCH.get("shard_rows") * n_devices != LAST_DISPATCH.get("rows")
    ):
        raise AssertionError(f"the chunk did not split one plate per shard: {LAST_DISPATCH}")

    # every shard solved the same plate: each must agree with the 1-shard solve
    ref = out_1[0]
    for plate_res in out_n:
        for ru, rs in zip(ref, plate_res):
            if bool(ru.success) != bool(rs.success):
                raise AssertionError("a shard and the 1-shard solve disagree on success")
            if ru.success:
                err = float(np.abs(np.asarray(ru.displacements[-1])
                                   - np.asarray(rs.displacements[-1])).max())
                if err > 1e-5:
                    raise AssertionError(f"a shard is {err:.3e} off the 1-shard solve")

    return {
        "n_devices": n_devices,
        "devices": [str(d) for d in shards],
        "lanes_per_device": conditions_per_plate,
        "solves_per_timing": inner,
        "t_1dev_s": t_1,
        "t_ndev_s": t_n,
        "t_1dev_repeats_s": times_1,
        "t_ndev_repeats_s": times_n,
        "efficiency": n_devices * t_1 / t_n,
        "efficiency_spread": _spread(n_devices, times_1, times_n),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_step_times(results_folder: str, image_size: int, per_device_batch: int,
                     accum: int, input_dim: int, repeats: int) -> List[float]:
    """Inside a rank: seconds per accumulated micro-batch of `repeats` data-
    parallel train steps at `per_device_batch` rows per rank and `accum`
    micro-batches per step, after one warm-up step, each ended by a
    synchronization of the device."""
    from ..data.arrays import InMemoryFEADataset
    from ..train.trainer import Trainer, TrainerConfig
    from .distributed import local_device, process_count

    world = process_count()
    device = local_device()
    ds = InMemoryFEADataset.generate(num_plates=2, conditions_per_plate=2, num_steps=3,
                                     image_size=image_size, mesh_size=0.1, seed=13, device=device)
    cfg = TrainerConfig(
        dataset_image_size=image_size, train_batch_size=per_device_batch * world,
        num_gradient_accumulation_steps=accum, num_train_steps=1, num_steps_per_condition=3,
        num_steps_per_sample_condition=3, conditions_per_plate=2, input_dim=input_dim,
        skip_dataset_size_check=True, results_folder=results_folder, progress_bar=False,
    )
    trainer = Trainer(cfg, dataset=ds, sample_dataset=ds, device=device)
    batch = trainer._fetch_batch(0)
    trainer._train_step(batch)
    _sync(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        trainer._train_step(batch)
        _sync(device)
        times.append((time.perf_counter() - t0) / accum)
    return times


def measure_train_sharding_efficiency(
    n_devices: int,
    image_size: int = 32,
    per_device_batch: int = 2,
    input_dim: int = 16,
    repeats: int = 2,
    devices: Optional[Sequence] = None,
    timeout_s: float = 600.0,
) -> Dict:
    """Weak-scaling efficiency of the data-parallel train step: a group of
    one rank on `devices[0]` against a group of `n_devices` ranks on
    `devices` (default `cuda:0` .. `cuda:n-1` over NCCL; ["cpu"] * n for
    gloo on the CPU), at the same per-rank batch. The reduced-width FDN-UNet (input_dim
    16) keeps the run short; the partition is the flagship's."""
    from .launch import launch

    if devices is None:
        devices = [f"cuda:{r}" for r in range(n_devices)]
    # one depth for both groups, the one that keeps the one-rank group's
    # effective batch (batch x accumulation) >= 16
    accum = -(-16 // per_device_batch)
    with tempfile.TemporaryDirectory(prefix="train_scaling_") as tmp:
        args = (tmp, image_size, per_device_batch, accum, input_dim, repeats)
        times_1 = launch(train_step_times, 1, args, devices=devices[:1], timeout_s=timeout_s)[0]
        times_n = launch(train_step_times, n_devices, args, devices=devices, timeout_s=timeout_s)[0]
    t_1, t_n = min(times_1), min(times_n)
    return {
        "n_devices": n_devices,
        "devices": [str(d) for d in devices],
        "per_device_batch": per_device_batch,
        "accumulation_steps": accum,
        "image_size": image_size,
        "t_1dev_s_per_accum": t_1,
        "t_ndev_s_per_accum": t_n,
        "t_1dev_repeats_s": times_1,
        "t_ndev_repeats_s": times_n,
        "efficiency": n_devices * t_1 / t_n,
        "efficiency_spread": _spread(n_devices, times_1, times_n),
    }
