"""Device-resident plate solving, the port of fea_tpu/datagen/batched.py:
upload the padded mesh scaffold once per plate, solve chunks of same-bucket
plates x conditions as one flat system (fem/flatgroup.py), fetch packed
results.

This is the throughput core of datagen: the reference pays a fresh sfepy
problem build + SuperLU factorization per condition per step
(fea_analysis.py:418-461); here a plate's mesh lives on the device and a
whole chunk of conditions is one packed PCG solve.

The host drives the CG loop (it reads the loop's condition once per block
of bodies), so a plain call would hold the scheduler for the whole solve.
`dispatch_plate_group` therefore hands the chunk to a solve worker thread
with its own CUDA stream and returns a future at once; chunks run in the
order they were dispatched, and the scheduler meshes, samples, rasterizes
and writes PNGs meanwhile.

A chunk is n contiguous blocks of plates, its shards (`n_devices`,
fea_tpu's plate-axis sharding; n = 1 unless asked), each one
`flat_group_body` on its own device, run by a solve worker of its own; the
plates are independent, so the shards share no collective, as fea_tpu's
shard_map of the same body does. The scheduler stays one process.
"""

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..fem.assembly import build_incidence
from ..fem.banded import quantize_hb, rcm_permutation
from ..fem.coarse import build_aggregates, n_coarse_for_bucket
from ..fem.direct import direct_solve
from ..fem.flatgroup import flat_group_body
from ..fem.problem import (
    SolveResult,
    StaticProblem,
    _require_true_f32,
    _solve_kernel_packed,
    unpack_solve,
)
from ..fem.solver import CHECK_EVERY
from ..mesh import Mesh
from ..utils.device import cuda_device, resolve_device
from .pipeline import DATAGEN_ACCEPT_TOL, next_bucket

# Hard cap on the banded half-bandwidth. The band buffer is
# n_dofs x (2*hb + BAND_R) floats PER LANE (fem/banded.py). fea_tpu sized
# the cap for a 16 GB chip with 3 chunks in flight; on an 80 GB card it
# does not bind (hb 384 at bucket 8192, 4 plates x 4 conditions: 0.94 GB
# of band per chunk), but it decides which plates ride banded chunks, so
# it sets the chunk grouping and the plate order — kept equal to fea_tpu's
# so that the same seed gives the same dataset. Typical RCM dof
# half-bandwidths at mesh_size 1e-2 are 105-239; capped plates ride
# dedicated incidence-operator chunks (see dispatch_chunk's band-class
# grouping).
BAND_HB_CAP = 384


def _failed_result(num_steps: int, n: int, m: int) -> SolveResult:
    zeros_u = np.zeros((num_steps, n, 2))
    zeros_c = np.zeros((num_steps, m, 3))
    return SolveResult(
        displacements=zeros_u,
        strain=zeros_c,
        stress=zeros_c,
        converged=np.asarray(False),
        failed=np.asarray(True),
        residual_norm=np.asarray(np.inf),
        iterations=np.asarray(0),
    )


class PlateSolver:
    """Per-plate solver with a device-resident padded mesh scaffold."""

    def __init__(
        self,
        mesh: Mesh,
        num_steps: int,
        dtype=torch.float32,
        tol: Optional[float] = None,
        max_iters: int = 6000,
        accept_tol: float = DATAGEN_ACCEPT_TOL,
        restarts: Optional[int] = None,
        include_cell_fields: bool = True,
        node_bucket: Optional[int] = None,
        tri_bucket: Optional[int] = None,
        min_incidence_degree: int = 0,
        band_hb: int = 0,
        banded: bool = True,
        device=None,
    ):
        """`node_bucket`/`tri_bucket`/`min_incidence_degree`/`band_hb` force
        the padded shapes (bumped up if the mesh doesn't fit) so a group of
        plates can share one chunk solve. `band_hb` is the forced minimum
        banded half-bandwidth (-1: no band); with `banded` the solver
        RCM-permutes its scaffold for the band operator (fem/banded.py).
        The tables live on `device`, the CUDA device unless named."""
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"FEM solves run in float32 or float64, not {dtype}")
        self.mesh = mesh
        self.num_steps = num_steps
        self.n = mesh.num_nodes
        self.m = mesh.num_triangles
        self.node_bucket = max(node_bucket or 0, next_bucket(self.n + 3))
        self.tri_bucket = max(tri_bucket or 0, next_bucket(self.m))
        self._min_incidence_degree = min_incidence_degree
        self.dtype = dtype
        self.device = resolve_device(device)
        # Datagen iteration target 1e-5 (f32): measured displacement error at
        # rnorm 1e-5 is ~1e-7..1e-6 relative — polishing to the 1e-6 floor
        # costs ~30-50% more lockstep iterations for precision the uint8
        # image pipeline cannot represent.
        self.tol = tol if tol is not None else (
            1e-10 if self.dtype == torch.float64 else 1e-5
        )
        self.max_iters = max_iters
        self.accept_tol = accept_tol
        self.restarts = restarts if restarts is not None else (
            1 if self.dtype == torch.float64 else 6
        )
        self.include_cell_fields = include_cell_fields

        # Build the padded scaffold once from a dummy condition.
        scaffold = StaticProblem(
            coords=np.asarray(mesh.coords),
            triangles=np.asarray(mesh.triangles),
            young=np.zeros(self.m),
            poisson=np.zeros(self.m),
            fixed_nodes=np.zeros(self.n, dtype=bool),
            loads=np.zeros((self.n, 2)),
            num_steps=num_steps,
        ).padded(self.node_bucket, self.tri_bucket)
        self._pad_fixed_tail = scaffold.fixed_nodes[self.n :]

        # Banded operator scaffold: RCM-permute the node order so K is
        # narrow-banded. The permutation is internal — conditions are built
        # on the original mesh and results are unpermuted at fetch. The
        # band's scatter plan is computed on the device at dispatch from
        # the triangle table (fem/banded.band_assembly_indices_dev).
        self.band_hb = 0
        self._perm = None  # bucket-wide node permutation (None = identity)
        self._unperm = None
        coords_s, tris_s = scaffold.coords, scaffold.triangles
        if band_hb >= 0 and banded and self.dtype == torch.float32:
            perm_r, hb_nat = rcm_permutation(mesh.triangles, self.n)
            hb = max(quantize_hb(hb_nat), band_hb)
            if hb <= min(self.node_bucket // 4, BAND_HB_CAP):
                perm = np.arange(self.node_bucket, dtype=np.int64)
                perm[: self.n] = perm_r
                inv = np.argsort(perm)
                self.band_hb = hb
                self._perm = perm
                self._unperm = inv
                coords_s = coords_s[perm]
                tris_s = inv[tris_s].astype(np.int64)

        self._padded_triangles = tris_s
        incidence = build_incidence(
            tris_s,
            self.node_bucket,
            pad_degree=self._min_incidence_degree,
            device=self.device,
        )
        self.coords_dev = torch.as_tensor(coords_s, dtype=self.dtype, device=self.device)
        self.triangles_dev = torch.as_tensor(tris_s, dtype=torch.int32, device=self.device)
        self.slots_dev = incidence.slots
        # Coarse rigid-body-mode space (condition-independent, per plate;
        # a pure function of node_bucket so grouped plates share shapes).
        # The member table holds the real nodes only (coarse.aggregate_members).
        self.n_coarse = n_coarse_for_bucket(self.node_bucket)
        space = build_aggregates(coords_s, self.n_coarse, n_real=self.n)
        self.agg_dev = torch.as_tensor(space.agg_ids, device=self.device)
        self.arms_dev = torch.as_tensor(space.arms, dtype=self.dtype, device=self.device)
        self.members = space.members
        self.members_dev = torch.as_tensor(space.members, device=self.device)

    def build_problem(self, condition: Dict) -> StaticProblem:
        return StaticProblem.from_condition(
            self.mesh,
            material_regions=condition["material_regions"],
            point_constraints=condition["point_constraints"],
            edge_constraints=condition["edge_constraints"],
            point_forces=condition["point_forces"],
            edge_forces=condition["edge_forces"],
            num_steps=self.num_steps,
        )

    def _solve_packed(self, young, poisson, free, loads):
        def dev(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        return _solve_kernel_packed(
            self.coords_dev,
            self.triangles_dev,
            dev(young),
            dev(poisson),
            self.slots_dev,
            dev(free),
            dev(loads),
            self.agg_dev,
            self.arms_dev,
            self.members_dev,
            tol=self.tol,
            max_iters=self.max_iters,
            accept_tol=self.accept_tol,
            restarts=self.restarts,
            include_cell_fields=self.include_cell_fields,
            n_coarse=self.n_coarse,
        )

    def dispatch(self, problem: StaticProblem):
        """One condition's packed solve (a tensor on the solver's device)."""
        return self._solve_packed(*self._pad_condition_arrays(problem))

    def fetch(self, token) -> SolveResult:
        packed = token.cpu().numpy()  # single round trip
        return self._unpack(packed)

    def _unpack(self, packed) -> SolveResult:
        result = self._unpermute(
            unpack_solve(packed, self.node_bucket, self.tri_bucket, self.num_steps)
        )
        return result._replace(
            displacements=result.displacements[:, : self.n],
            strain=result.strain[:, : self.m],
            stress=result.stress[:, : self.m],
        )

    def _pad_condition_arrays(self, problem: StaticProblem):
        pad_m = self.tri_bucket - self.m
        young = np.concatenate([problem.young, np.zeros(pad_m)])
        poisson = np.concatenate([problem.poisson, np.zeros(pad_m)])
        free = ~np.concatenate([problem.fixed_nodes, self._pad_fixed_tail])
        loads = np.concatenate(
            [problem.loads, np.zeros((self.node_bucket - self.n, 2))]
        )
        if self._perm is not None:
            free = free[self._perm]
            loads = loads[self._perm]
        return young, poisson, free.astype(np.float32), loads

    def _unpermute(self, result: SolveResult) -> SolveResult:
        """Solver scaffold order -> original mesh node order."""
        if self._unperm is None:
            return result
        return result._replace(
            displacements=result.displacements[:, self._unperm]
        )

    def dispatch_batch(self, problems: List[StaticProblem]):
        """A batch of conditions on this plate's mesh: one packed row per
        condition, (C, K) on the solver's device. fea_tpu vmaps the
        single-plate solve over the conditions; its lanes are independent,
        so one solve per condition gives every lane's result."""
        return torch.stack([self.dispatch(p) for p in problems])

    def fetch_batch(self, token) -> List[SolveResult]:
        packed_b = token.cpu().numpy()  # ONE copy for the whole batch
        return [self._unpack(packed) for packed in packed_b]

    def failed_result(self) -> SolveResult:
        return _failed_result(self.num_steps, self.n, self.m)

    @property
    def shape_key(self):
        return (
            self.node_bucket,
            self.tri_bucket,
            int(self.slots_dev.shape[1]),
            self.band_hb,
        )


class SolveWorker:
    """The thread that runs chunk solves: one thread, so chunks solve in
    the order they were submitted (the plate numbering of a run depends on
    it), with a CUDA stream of its own per device, so the caller's device
    work (the raster) does not queue behind a chunk's. Close it, or use it
    as a context manager, to end the thread."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fea-solve")
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def stream(self, device) -> "torch.cuda.Stream":
        """This worker's stream on `device` (called on the worker thread)."""
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def submit(self, fn, *args) -> Future:
        return self._pool.submit(fn, self, *args)

    def close(self, wait: bool = True) -> None:
        """End the thread once the chunks submitted so far have run."""
        self._pool.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def chunk_inputs(payloads, pad_group_to: int = 0, x0s=None):
    """The host half of a dispatch: pad the group to `pad_group_to`
    plates and stack its condition arrays and member tables. Returns
    (solvers, host arrays, real-triangle counts or None, band_hb).

    `x0s`: optional list parallel to `payloads`; each entry is a list
    parallel to that payload's problems of per-condition warm starts
    ((N, 2) arrays in real-node coordinates) or None for a cold start."""
    n_real = len(payloads)
    if pad_group_to > n_real:
        payloads = payloads + [payloads[-1]] * (pad_group_to - n_real)
        if x0s is not None:
            x0s = list(x0s) + [x0s[-1]] * (pad_group_to - n_real)
    solver0 = payloads[0][0]
    for s, _ in payloads:
        assert s.shape_key[:3] == solver0.shape_key[:3]
        assert s.device == solver0.device and s.dtype == solver0.dtype
    # banded requires a uniform half-bandwidth across the group (the
    # scheduler forces this via RunningBuckets.band); ad-hoc groups with
    # mixed hb fall back to the incidence operator
    band_hb = solver0.band_hb
    if any(s.band_hb != band_hb for s, _ in payloads):
        band_hb = 0

    Nb = solver0.node_bucket
    width = max(s.members.shape[1] for s, _ in payloads)
    members = np.full((len(payloads), solver0.n_coarse, width), Nb, np.int32)
    young, poisson, free, loads, x0 = [], [], [], [], []
    for pi, (s, problems) in enumerate(payloads):
        members[pi, :, : s.members.shape[1]] = s.members
        arrays = [s._pad_condition_arrays(p) for p in problems]
        young.append(np.stack([a[0] for a in arrays]))
        poisson.append(np.stack([a[1] for a in arrays]))
        free.append(np.stack([a[2] for a in arrays]))
        loads.append(np.stack([a[3] for a in arrays]))
        x0_c = np.zeros((len(problems), s.node_bucket, 2), np.float32)
        if x0s is not None and x0s[pi] is not None:
            for ci, w in enumerate(x0s[pi]):
                if w is not None:
                    x0_c[ci, : s.n] = w
        if s._perm is not None:  # warm starts arrive in original order
            x0_c = x0_c[:, s._perm]
        x0.append(x0_c)
    host = dict(
        members=members, young=np.stack(young), poisson=np.stack(poisson),
        free=np.stack(free), loads=np.stack(loads), x0=np.stack(x0),
    )
    m_real = [s.m for s, _ in payloads] if band_hb > 0 else None
    return [s for s, _ in payloads], host, m_real, band_hb


def chunk_tables(solvers, host, m_real, device):
    """The device half: the solvers' stacked tables (moved to `device` when
    they live on another) and the uploaded condition arrays, in
    `fem.flatgroup.chunk_system`'s argument order, and the real-triangle
    counts (or None)."""

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def stacked(name):
        return torch.stack([getattr(s, name) for s in solvers]).to(device)

    dtype = solvers[0].dtype
    tables = [
        stacked("coords_dev"), stacked("triangles_dev"), stacked("slots_dev"),
        stacked("agg_dev"), stacked("arms_dev"),
        dev(host["members"], torch.int32),
    ] + [dev(host[name], dtype) for name in ("young", "poisson", "free", "loads", "x0")]
    return tables, None if m_real is None else dev(m_real, torch.int64)


def chunk_keywords(solvers, band_hb: int, tol=None, max_iters: Optional[int] = None,
                   check_every: int = CHECK_EVERY, band_block: int = 0) -> dict:
    """The keywords of a chunk's `flat_group_body`, from its first solver
    (`tol` and `max_iters` where not given) and the switches."""
    solver0 = solvers[0]
    return dict(
        n_coarse=solver0.n_coarse,
        tol=solver0.tol if tol is None else tol,
        max_iters=solver0.max_iters if max_iters is None else max_iters,
        accept_tol=solver0.accept_tol,
        restarts=solver0.restarts,
        include_cell_fields=solver0.include_cell_fields,
        check_every=check_every,
        band_hb=band_hb,
        band_block=band_block,
    )


def _solve_chunk(worker, device, ready, solvers, host, m_real, kw, info):
    """The worker's half of a dispatch: upload, stack and run the flat
    chunk solve with the keywords `kw` (`chunk_keywords`). Returns the
    packed (P, C, K) rows on the device, finished."""
    t0 = time.perf_counter()

    def run():
        tables, m_real_p = chunk_tables(solvers, host, m_real, device)
        return flat_group_body(*tables, m_real_p=m_real_p, info=info, **kw)

    if device.type == "cuda":
        stream = worker.stream(device)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            packed = run()
        stream.synchronize()
    else:
        packed = run()
    if info is not None:
        info["seconds"] = time.perf_counter() - t0
    return packed


# Placement record of the most recent dispatch: the distinct
# devices, the shards, the plates of the chunk and of each shard. Written
# by dispatch_plate_group, asserted by parallel/scaling.py.
LAST_DISPATCH: Dict[str, int] = {}


def shard_devices(device, n_devices: int) -> List[torch.device]:
    """The device of each of `n_devices` plate shards. `device` is a list of
    n devices (repeats allowed: several shards can share one card), the
    CPU (every shard on the CPU), a CUDA device (`cuda:k` .. `cuda:k+n-1`;
    k is 0 without an index), or None (`cuda:0` .. `cuda:n-1`). Raises
    where the devices are not there: no shard falls back to another
    device."""
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}")
    if isinstance(device, (list, tuple)):
        if len(device) != n_devices:
            raise ValueError(f"{len(device)} devices named for {n_devices} shards")
        return [torch.device(d) for d in device]
    device = torch.device(device) if device is not None else cuda_device()
    if device.type != "cuda":
        return [device] * n_devices
    first = device.index or 0
    visible = torch.cuda.device_count()
    if first + n_devices > visible:
        raise ValueError(
            f"{n_devices} shards from cuda:{first} need {first + n_devices} CUDA devices, "
            f"{visible} visible; name the devices, e.g. device=['cuda:0'] * {n_devices}"
        )
    return [torch.device("cuda", first + k) for k in range(n_devices)]


def _join_shards(futures: List[Future], device: torch.device, info: Optional[dict],
                 infos: List) -> Future:
    """One future for a chunk's shards: its result is their packed rows
    joined in plate order on `device` (one shard's rows as they are);
    `info` gets their summed `host_reads`, `setup_s` and `loop_s` and the
    longest `seconds`."""
    joined = Future()
    left = [len(futures)]
    lock = threading.Lock()

    def one_done(_):
        with lock:
            left[0] -= 1
            if left[0]:
                return
        try:
            parts = [f.result() for f in futures]
            if len(parts) == 1:
                packed = parts[0]
            else:
                packed = torch.cat([p.to(device) for p in parts])
                if device.type == "cuda":
                    # the shards' rows were made on their workers' streams:
                    # read them all before they can be freed
                    torch.cuda.current_stream(device).synchronize()
        except Exception as exc:  # a shard's error is the chunk's
            joined.set_exception(exc)
            return
        if info is not None:
            for key in ("host_reads", "setup_s", "loop_s"):
                info[key] = sum(i[key] for i in infos)
            info["seconds"] = max(i["seconds"] for i in infos)
        joined.set_result(packed)

    for f in futures:
        f.add_done_callback(one_done)
    return joined


def dispatch_plate_group(
    payloads,
    tol=None,
    max_iters: Optional[int] = None,
    pad_group_to: int = 0,
    x0s=None,
    check_every: int = CHECK_EVERY,
    info: Optional[dict] = None,
    workers: Optional[Sequence[SolveWorker]] = None,
    devices: Optional[Sequence] = None,
    band_block: int = 0,
) -> Future:
    """Asynchronous half of `solve_plate_group`: pad and stack a group of
    same-bucket plates' condition arrays on the host (`chunk_inputs`),
    hand the chunk to the solve workers, and return its future at once
    (the packed rows, once solved) — the host is free to prep the next
    chunk while the solve runs. `info`, when given, receives the solve's
    `host_reads`, `setup_s`, `loop_s` and `seconds` (worker wall time).

    With the band, `band_block` > 0 takes band-block Jacobi with blocks of
    that many dofs for the smoother (fem/flatgroup.chunk_system); 0, the
    default as in fea_tpu, the per-node 2x2 blocks.

    `devices` (n of them, repeats allowed; default the plates' own device)
    shards the padded plates into n contiguous blocks, block k solved on
    `devices[k]` by `workers[k]` (n workers, or None for workers of their
    own that end with this chunk); the future's result is every shard's
    rows in plate order on `devices[0]`, and `info` sums the shards'. The
    plate count must divide by n."""
    _require_true_f32()
    solvers, host, m_real, band_hb = chunk_inputs(payloads, pad_group_to, x0s)
    kw = chunk_keywords(solvers, band_hb, tol, max_iters, check_every, band_block)
    device = solvers[0].device
    ready = None
    if device.type == "cuda":
        # the workers' streams start after everything this thread queued
        # so far (the solvers' tables)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))

    devices = [device] if devices is None else [torch.device(d) for d in devices]
    n, plates = len(devices), len(solvers)
    if plates % n:
        raise ValueError(f"{plates} plates do not split over {n} shards: pad the group "
                         f"to a multiple of {n} (pad_group_to)")
    own = workers is None
    workers = [SolveWorker() for _ in range(n)] if own else list(workers)
    if len(workers) != n:
        raise ValueError(f"{len(workers)} solve workers for {n} shards")
    per = plates // n
    LAST_DISPATCH.clear()
    LAST_DISPATCH.update(n_devices=len(set(devices)), n_shards=n, rows=plates, shard_rows=per)
    futures, infos = [], []
    for k, (shard_device, shard_worker) in enumerate(zip(devices, workers)):
        block = slice(k * per, (k + 1) * per)
        shard_info = None if info is None else {}
        infos.append(shard_info)
        futures.append(shard_worker.submit(
            _solve_chunk, shard_device, ready, solvers[block],
            {name: a[block] for name, a in host.items()},
            None if m_real is None else m_real[block], kw, shard_info))
    if own:
        for w in workers:
            w.close(wait=False)
    return _join_shards(futures, devices[0], info, infos)


def fetch_plate_group(token: Future, payloads):
    """Blocking half of `solve_plate_group`: wait for the chunk, ONE copy
    of its packed rows to the host, then unpack per plate/condition."""
    return unpack_plate_group(token.result().cpu().numpy(), payloads)


def unpack_plate_group(packed, payloads):
    """Host-side unpack of an already-fetched packed group array."""
    out = []
    for (s, problems), packed_plate in zip(payloads, packed):
        out.append([s._unpack(packed_cond) for packed_cond in packed_plate[: len(problems)]])
    return out


def solve_plate_group(
    payloads,
    tol=None,
    max_iters: Optional[int] = None,
    pad_group_to: int = 0,
    x0s=None,
    devices: Optional[Sequence] = None,
    band_block: int = 0,
):
    """Solve all conditions of a group of same-bucket plates as one chunk.

    payloads: list of (PlateSolver, [StaticProblem, ...]) with equal
    shape_key and equal condition counts. `pad_group_to` repeats the last
    payload so every chunk has one fixed plate count; `devices` shards the
    chunk; `band_block` picks the smoother (see dispatch_plate_group).
    Returns list-of-lists of SolveResult matching the (unpadded) input."""
    token = dispatch_plate_group(
        payloads, tol=tol, max_iters=max_iters, pad_group_to=pad_group_to, x0s=x0s,
        devices=devices, band_block=band_block,
    )
    return fetch_plate_group(token, payloads)


class RunningBuckets:
    """Monotone bucket policy: every plate is padded up to the largest
    bucket seen so far in the run, so shapes (and grouped dispatches)
    stabilize after the first few plates instead of splintering into one
    shape key per plate. Scales with the actual mesh sizes — tiny test
    meshes stay tiny."""

    def __init__(self):
        self.node = 0
        self.tri = 0
        self.degree = 0
        self.band = 0

    def update(self, meshes) -> None:
        for mesh in meshes:
            self.node = max(self.node, next_bucket(mesh.num_nodes + 3))
            self.tri = max(self.tri, next_bucket(mesh.num_triangles))

    def update_degree(self, solvers) -> None:
        for s in solvers:
            self.degree = max(self.degree, int(s.slots_dev.shape[1]))
            self.band = max(self.band, s.band_hb)


# --- scheduler tuning (generate_data_batched) -------------------------------
# Per-dispatch PCG budget. The chunk solve is LOCKSTEP: every lane pays
# for the slowest lane, so an unbounded chunk costs
# n_lanes x max_lane_iters while lane iterations are long-tailed (median
# ~100, p90 ~400, max 1500+). A small fixed budget makes every chunk cost
# n_lanes x K; lanes that need more CONTINUE in a later chunk warm-started
# from their partial x (each re-dispatch recomputes the true residual,
# acting as iterative refinement), so total device time approaches the sum
# of per-lane iterations (rounded up to K). Continuation also keeps
# hard-but-valid conditions the reference's direct solver would have
# solved (fea_analysis.py:371-375) instead of resampling them.
ITERS_PER_DISPATCH = 300
RESTARTS_PER_DISPATCH = 1
MAX_CONTINUATIONS = 20
# lanes whose relative residual exceeds this are diverging, not slow —
# resample immediately instead of continuing
CONTINUE_RNORM_LIMIT = 1.0
# a continuing lane must beat its previous dispatch's residual by this
# factor, else it has hit its f32 floor and is resampled (host-side
# cross-dispatch stagnation detection)
CONTINUE_PROGRESS_FACTOR = 0.7

# Terminal CG failures fall back to a host f64 SuperLU solve instead of
# resampling (the reference keeps every finite direct solve,
# fea_analysis.py:455-461 — see fem/direct.py). This is the reference's
# semantics, not a device fallback.
DIRECT_FALLBACK = True

# Chunks in the pipeline: one solving, the next ones queued on the solve
# worker while the host preps and writes.
MAX_FLIGHTS = 3


class _PlateJob:
    """One plate moving through the deferred-retry scheduler."""

    __slots__ = (
        "mesh", "solver", "pixel_map", "pairs", "results", "retries", "pool",
        "warm", "cont", "last_rnorm", "band_hint",
    )

    def __init__(self, mesh, pairs, pool):
        self.mesh = mesh
        self.band_hint: Optional[int] = None  # quantized NATURAL hb cache
        self.solver: Optional[PlateSolver] = None
        self.pixel_map = None
        self.pairs = pairs  # [(condition, problem)] per slot
        self.results = [None] * len(pairs)
        self.retries = 0
        self.pool = pool  # per-plate clustering cache for cheap resamples
        self.warm = [None] * len(pairs)  # per-slot PCG warm start (N,2)
        self.cont = [0] * len(pairs)  # per-slot continuation count
        self.last_rnorm = [None] * len(pairs)  # per-slot progress tracking

    def pending(self) -> List[int]:
        return [i for i, r in enumerate(self.results) if r is None]

    def complete(self) -> bool:
        return all(r is not None for r in self.results)


def generate_data_batched(
    data_dir: str = "data/",
    image_size: int = 512,
    num_plates: int = 8,
    start_plate: Optional[int] = None,
    conditions_per_plate: int = 4,
    mesh_size: float = 1e-2,
    num_polygons_range=(1, 3),
    points_per_polygon_range=(3, 8),
    holes_per_polygon_range=(0, 3),
    points_per_hole_range=(3, 4),
    num_regions=(1, 5),
    save_displacement: bool = True,
    save_strain: bool = False,
    save_stress: bool = False,
    num_steps_per_condition: int = 11,
    save_meshes: bool = False,
    seed=None,
    batch_size: int = 4,
    max_condition_retries: int = 30,
    n_devices: Optional[int] = None,
    wandb_inject_function=None,
    stage_timer=None,
    verbose: bool = True,
    banded: bool = True,
    device=None,
    band_block: int = 0,
) -> Dict:
    """Multi-plate batched datagen: the throughput path.

      * a chunk of `batch_size` plates is padded to shared monotone
        running-max buckets so ALL of its solves run as ONE flat chunk
        solve — one dispatch + ONE packed fetch per chunk;
      * failed (near-singular) conditions are NOT retried synchronously:
        the plate is re-queued and its resampled conditions ride the NEXT
        chunk's dispatch (the reference pays a fresh SuperLU factorization
        to discover each NaN, fea_analysis.py:455-461);
      * host work (meshing, clustering, pixel maps, PNG writes) happens
        while solves are in flight on the solve worker.

    `batch_size` plates/dispatch defaults to 4: every lane of a chunk runs
    to the SLOWEST lane's finish, so big groups pay a lockstep tax.
    `banded` picks the band operator for plates whose RCM bandwidth fits
    (fem/banded.py), else every chunk uses the incidence operator. Solves
    and nodal images run on `device`, the CUDA device unless named.
    `band_block` > 0 takes band-block Jacobi for every banded chunk's
    smoother, fea_tpu's FEA_TPU_BAND_BLOCK (`dispatch_plate_group`; 0, the
    default, is fea_tpu's).

    `n_devices` > 1 shards every chunk's plate axis over that many devices
    (`shard_devices`: `device` None means `cuda:0` .. `cuda:n-1`, the CPU
    gives n CPU shards, a list names each shard's device), one solve
    worker each; chunks then hold max(batch_size, n) plates rounded up to
    a multiple of n. The plates' tables and images live on the first.
    """
    from collections import deque
    from concurrent.futures import TimeoutError as FutureTimeout
    from timeit import default_timer as timer

    from ..geometry import GeometryError, GeometrySampler
    from ..mesh import MeshError, triangulate_polygon
    from ..raster import build_pixel_map, geometry_image, outline_image
    from ..utils.profiling import StageTimer
    from .conditions import ConditionSampler
    from .pipeline import _write_condition
    from .writers import save_gray_png, verify_directory

    shards = shard_devices(device, n_devices or 1)
    device = shards[0]
    _require_true_f32()
    verify_directory(data_dir)
    geometry_sampler = GeometrySampler(
        num_polygons_range=num_polygons_range,
        points_per_polygon_range=points_per_polygon_range,
        holes_per_polygon_range=holes_per_polygon_range,
        points_per_hole_range=points_per_hole_range,
        random_seed=seed,
    )
    condition_sampler = ConditionSampler(
        num_regions_range=num_regions,
        random_seed=None if seed is None else seed + 1,
    )
    include_cell_fields = save_strain or save_stress or save_meshes
    buckets = RunningBuckets()
    stages = stage_timer if stage_timer is not None else StageTimer()
    # chunks must be a multiple of the shard count
    group_size = max(batch_size, len(shards))
    group_size += (-group_size) % len(shards)

    stats = {
        "plates": 0,
        # Device-side accounting (what the card actually ran):
        #   lane_dispatches  — every pending lane sent to the device,
        #                      including continuation re-dispatches
        #   solves           — unique condition attempts dispatched
        #                      (= lane_dispatches - continuations)
        #   failures         — dispatched attempts that failed CG
        #                      (= cg_failures)
        # Host-side accounting (never touched the device):
        #   host_rejections  — structurally-singular draws rejected by the
        #                      microsecond pre-check and resampled
        "lane_dispatches": 0,
        "solves": 0,
        "failures": 0,
        "host_rejections": 0,
        "singular_resamples": 0,  # alias of host_rejections
        "cg_failures": 0,
        # of the cg_failures: recovered by the host f64 SuperLU lane
        # (fem/direct.py) vs actually resampled
        "direct_fallbacks": 0,
        "cg_resamples": 0,
        "continuations": 0,
        # (rnorm, iterations) of every failed CG lane
        "failed_lanes": [],
        "converged_iters": [],
        "total_solve_time": 0.0,
        # union of [dispatch-issue, solve-complete] intervals: the span
        # the solve worker was occupied
        "device_busy_s": 0.0,
        # the solve worker's own clock, summed over chunks: set-up (element
        # stiffness, band, coarse factorization), the CG loop, host reads
        "chunk_setup_s": 0.0,
        "chunk_loop_s": 0.0,
        "host_reads": 0,
        "chunks": 0,
        # (plate, condition, true relative residual, iterations) of every
        # written condition; a condition the host's direct solve kept
        # reports 0 and 0
        "solved_conditions": [],
    }
    run_start = timer()

    def fresh_pair(mesh, pool):
        """One non-structurally-singular (condition, problem), or None if
        the budget is blown. Cached clusterings make resamples cheap."""
        budget = max_condition_retries
        while True:
            condition = condition_sampler.sample_one(mesh, cluster_pool=pool)
            problem = StaticProblem.from_condition(
                mesh,
                material_regions=condition["material_regions"],
                point_constraints=condition["point_constraints"],
                edge_constraints=condition["edge_constraints"],
                point_forces=condition["point_forces"],
                edge_forces=condition["edge_forces"],
                num_steps=num_steps_per_condition,
            )
            if not problem.structurally_singular():
                return condition, problem
            stats["host_rejections"] += 1
            stats["singular_resamples"] += 1
            budget -= 1
            if budget <= 0:
                return None

    def prep_job() -> _PlateJob:
        """Host prep of one plate: geometry -> mesh -> C viable conditions."""
        while True:
            try:
                with stages.stage("geometry"):
                    polygon = geometry_sampler.generate()
                with stages.stage("mesh"):
                    mesh = triangulate_polygon(polygon, mesh_size=mesh_size)
            except (GeometryError, MeshError):
                continue
            pool: List = []
            with stages.stage("conditions"):
                try:
                    conditions = condition_sampler.sample(
                        mesh, conditions_per_plate, cluster_pool=pool
                    )
                except RuntimeError:
                    continue  # sampler did not converge: redraw plate
                pairs = []
                ok = True
                for condition in conditions:
                    problem = StaticProblem.from_condition(
                        mesh,
                        material_regions=condition["material_regions"],
                        point_constraints=condition["point_constraints"],
                        edge_constraints=condition["edge_constraints"],
                        point_forces=condition["point_forces"],
                        edge_forces=condition["edge_forces"],
                        num_steps=num_steps_per_condition,
                    )
                    if problem.structurally_singular():
                        stats["host_rejections"] += 1
                        stats["singular_resamples"] += 1
                        pair = fresh_pair(mesh, pool)
                        if pair is None:
                            ok = False
                            break
                        pairs.append(pair)
                    else:
                        pairs.append((condition, problem))
            if ok:
                return _PlateJob(mesh, pairs, pool)

    def band_class(job: _PlateJob) -> int:
        """Effective banded half-bandwidth the job's solver WILL get at
        the current buckets (0 = incidence operator). Mirrors
        PlateSolver's own criterion exactly — hb = max(natural,
        buckets.band) and hb <= min(node_bucket // 4, BAND_HB_CAP) —
        otherwise a 'banded-class' job can build a band_hb=0 solver and
        the mixed-chunk safety net (buckets.band = -1) permanently
        disables banding for the run. Only the quantized natural hb is
        cached; the bucket-dependent classification is recomputed per
        call (buckets grow during a run)."""
        if job.band_hint is None:
            if not banded:
                job.band_hint = 0
            else:
                _, hb_nat = rcm_permutation(
                    np.asarray(job.mesh.triangles), job.mesh.num_nodes
                )
                job.band_hint = quantize_hb(hb_nat)
        hb = job.band_hint
        if hb <= 0:
            return 0
        eff = max(hb, max(buckets.band, 0))
        return eff if eff <= min(buckets.node // 4, BAND_HB_CAP) else 0

    def ensure_solver(job: _PlateJob, want_band: Optional[bool] = None) -> None:
        """(Re)build the job's solver at the CURRENT running buckets, so
        every payload of a dispatch shares one shape key. `want_band` pins
        the chunk's band class: dispatch_chunk groups jobs by class BEFORE
        buckets.update can grow buckets.node (which loosens band_class),
        so re-deriving the class here could band one job of an incidence
        chunk and trip the mixed-chunk fallback."""
        key = (buckets.node, buckets.tri)
        if want_band is None:
            want_band = buckets.band >= 0 and band_class(job) > 0
        if (
            job.solver is not None
            and job.solver.node_bucket == key[0]
            and job.solver.tri_bucket == key[1]
            and job.solver.slots_dev.shape[1] >= buckets.degree
            and (job.solver.band_hb > 0) == want_band
            and (not want_band or job.solver.band_hb >= buckets.band)
        ):
            return
        with stages.stage("solver_build"):
            job.solver = PlateSolver(
                job.mesh,
                num_steps_per_condition,
                node_bucket=buckets.node,
                tri_bucket=buckets.tri,
                min_incidence_degree=buckets.degree,
                band_hb=buckets.band if want_band else -1,
                include_cell_fields=include_cell_fields,
                max_iters=ITERS_PER_DISPATCH,
                restarts=RESTARTS_PER_DISPATCH,
                banded=banded,
                device=device,
            )
            # NB: band_hint deliberately NOT updated from solver.band_hb —
            # the hint caches the quantized NATURAL half-bandwidth, while
            # solver.band_hb is the effective one (forced-min raised, or 0
            # when built unbanded); mixing them corrupts band_class

    def make_pixel_map(job: _PlateJob) -> None:
        if job.pixel_map is None:
            with stages.stage("pixel_map"):
                job.pixel_map = build_pixel_map(
                    job.mesh.coords,
                    job.mesh.triangles,
                    image_size,
                    pad_candidates=32,
                    pad_shapes=(buckets.node, buckets.tri),
                )

    def write_job(job: _PlateJob, plate_number: int) -> None:
        make_pixel_map(job)
        with stages.stage("write"):
            plate_dir = os.path.join(data_dir, str(plate_number))
            verify_directory(plate_dir)
            for slot, ((condition, _), result) in enumerate(
                zip(job.pairs, job.results)
            ):
                stats["solved_conditions"].append((
                    plate_number, slot + 1, float(result.residual_norm), int(result.iterations)))
                condition_dir = os.path.join(plate_dir, str(slot + 1))
                verify_directory(condition_dir)
                _write_condition(
                    job.mesh,
                    job.pixel_map,
                    condition,
                    result,
                    condition_dir,
                    num_steps_per_condition,
                    save_displacement,
                    save_strain,
                    save_stress,
                    save_meshes,
                    device=device,
                )
            # plate-level images LAST, input.png atomically: a plate dir
            # containing input.png is guaranteed complete, so killed runs
            # can resume by counting plates with the sentinel and deleting
            # partial dirs
            save_gray_png(
                os.path.join(plate_dir, "outline.png"),
                outline_image(
                    job.pixel_map, job.mesh.coords, job.mesh.ring_corner_ids
                ),
            )
            tmp_input = os.path.join(plate_dir, ".input.tmp.png")
            save_gray_png(tmp_input, geometry_image(job.pixel_map))
            os.replace(tmp_input, os.path.join(plate_dir, "input.png"))

    workers = [SolveWorker() for _ in shards]
    ready: deque = deque()  # jobs with pending solves
    writes: deque = deque()  # completed jobs awaiting disk writes
    # dispatched chunks, oldest first: (t0, future, payloads, jobs, pendings, info)
    flights: deque = deque()
    plate_seq = (start_plate - 1) if start_plate is not None else 0
    written = 0
    busy_intervals: List = []  # (dispatch-issue, solve-complete) per chunk
    PREP_AHEAD = 2  # ready may hold up to PREP_AHEAD x group_size jobs

    def in_system() -> int:
        return (
            len(ready)
            + len(writes)
            + sum(len(f[3]) for f in flights)
        )

    def can_prep() -> bool:
        return (
            in_system() + written < num_plates
            and len(ready) < PREP_AHEAD * group_size
        )

    def dispatch_chunk():
        """Assemble one chunk from `ready` and hand it to the solve worker."""
        # one chunk = one band class: a capped (hb > BAND_HB_CAP) plate
        # rides a dedicated incidence-operator chunk instead of forcing
        # banding off (or the band buffer up) for everyone else
        want = band_class(ready[0]) > 0
        jobs, skipped = [], []
        while ready and len(jobs) < group_size:
            j = ready.popleft()
            if (band_class(j) > 0) == want:
                jobs.append(j)
            else:
                skipped.append(j)
        for j in reversed(skipped):
            ready.appendleft(j)  # other class dispatches next
        chunk_band = want and buckets.band >= 0
        buckets.update(j.mesh for j in jobs)
        for job in jobs:
            ensure_solver(job, want_band=chunk_band)
        wmax = max(j.solver.slots_dev.shape[1] for j in jobs)
        if wmax > buckets.degree:
            buckets.degree = wmax
            for job in jobs:
                ensure_solver(job, want_band=chunk_band)  # rebuild narrower
        hbs = [j.solver.band_hb for j in jobs]
        if buckets.band >= 0:
            if 0 in hbs and max(hbs) > 0:
                # mixed chunk should be impossible (class grouping); keep
                # the monotone run-wide fallback as a safety net
                buckets.band = -1
                chunk_band = False
                for job in jobs:
                    ensure_solver(job, want_band=False)
            elif max(hbs) > buckets.band:
                buckets.band = max(hbs)
                for job in jobs:
                    ensure_solver(job, want_band=chunk_band)  # widen bands
        payloads = []
        pendings = []
        x0s = []
        for job in jobs:
            idx = job.pending()
            probs = [job.pairs[i][1] for i in idx]
            warms = [job.warm[i] for i in idx]
            while len(probs) < conditions_per_plate:  # pad retry lanes
                probs.append(probs[-1])
                warms.append(warms[-1])
            payloads.append((job.solver, probs))
            pendings.append(idx)
            x0s.append(warms)
        info: Dict = {}
        with stages.stage("dispatch"):
            t0 = timer()
            future = dispatch_plate_group(
                payloads, pad_group_to=group_size, x0s=x0s, info=info, workers=workers,
                devices=shards, band_block=band_block,
            )
            future.add_done_callback(lambda _f, info=info: info.setdefault("done", timer()))
        stats["lane_dispatches"] += sum(len(i) for i in pendings)
        flights.append((t0, future, payloads, jobs, pendings, info))
        # device-memory telemetry, every 10 chunks
        stats["chunks"] += 1
        if verbose and device.type == "cuda" and stats["chunks"] % 10 == 1:
            ms = torch.cuda.memory_stats(device)
            print(
                f"device memory: in_use={ms.get('allocated_bytes.all.current', -1) / 1e9:.2f}GB "
                f"peak={ms.get('allocated_bytes.all.peak', -1) / 1e9:.2f}GB "
                f"reserved={ms.get('reserved_bytes.all.current', -1) / 1e9:.2f}GB "
                f"(chunk {stats['chunks']}, band={buckets.band}, "
                f"node={buckets.node})",
                flush=True,
            )

    def drain_writes(limit: Optional[int] = None):
        nonlocal plate_seq, written
        while writes and (limit is None or limit > 0):
            job = writes.popleft()
            plate_seq += 1
            write_job(job, plate_seq)
            written += 1
            stats["plates"] += 1
            if limit is not None:
                limit -= 1
            if wandb_inject_function is not None:
                elapsed = timer() - run_start
                remaining = (
                    (num_plates - written) * elapsed / max(written, 1)
                )
                wandb_inject_function(plate_seq - 1, elapsed, remaining)
            if verbose:
                rate = written / max(timer() - run_start, 1e-9) * 3600
                print(
                    f"plate {plate_seq} written "
                    f"({written}/{num_plates}, {rate:.0f} plates/h)"
                )

    def overlap_until_ready(future) -> None:
        """Host work (prep, pixel maps, writes) until `future` completes;
        only the truly idle remainder is charged to the fetch stage."""
        while not future.done():
            if can_prep():
                with stages.stage("overlap_host"):
                    ready.append(prep_job())
                continue
            pending_map = next(
                (job for f in flights for job in f[3] if job.pixel_map is None), None
            )
            if pending_map is not None:  # pixel maps for dispatched plates
                make_pixel_map(pending_map)
                continue
            if writes:
                with stages.stage("overlap_host"):
                    drain_writes(limit=1)
                continue
            with stages.stage("fetch"):
                try:
                    future.result(timeout=0.05)
                except FutureTimeout:
                    pass

    try:
        # Pipeline fill: prep the first chunk (nothing to overlap with yet).
        while in_system() + written < num_plates and len(ready) < group_size:
            ready.append(prep_job())

        while written < num_plates:
            # ---- keep up to MAX_FLIGHTS chunks queued on the solve worker ----
            while len(flights) < MAX_FLIGHTS:
                # top the queue up first so retries merge into full chunks and
                # the prep work overlaps any solves already in flight
                with stages.stage("overlap_host"):
                    while (
                        in_system() + written < num_plates
                        and len(ready) < group_size
                    ):
                        ready.append(prep_job())
                if not ready:
                    break
                dispatch_chunk()

            if not flights:
                # nothing in flight: flush writes, refill for the next lap
                with stages.stage("overlap_host"):
                    drain_writes()
                    while in_system() + written < num_plates and len(ready) < group_size:
                        ready.append(prep_job())
                if not ready:
                    continue
                dispatch_chunk()

            # ---- overlap the oldest in-flight chunk with host work -----------
            t0, future, payloads, jobs, pendings, info = flights[0]
            overlap_until_ready(future)
            flights.popleft()
            with stages.stage("fetch"):
                packed = future.result().cpu().numpy()
            solved = unpack_plate_group(packed, payloads)
            t_done = info.get("done", timer())
            stats["total_solve_time"] += t_done - t0
            stats["chunk_setup_s"] += info["setup_s"]
            stats["chunk_loop_s"] += info["loop_s"]
            stats["host_reads"] += info["host_reads"]
            busy_intervals.append((t0, t_done))

            for job, idx, results in zip(jobs, pendings, solved):
                for slot, result in zip(idx, results):
                    if result.success:
                        job.results[slot] = result
                        job.warm[slot] = None
                        job.last_rnorm[slot] = None
                        stats["converged_iters"].append(int(result.iterations))
                        continue
                    rnorm = float(result.residual_norm)
                    prev = job.last_rnorm[slot]
                    if (
                        np.isfinite(rnorm)
                        and rnorm < CONTINUE_RNORM_LIMIT
                        and job.cont[slot] < MAX_CONTINUATIONS
                        and (prev is None or rnorm < CONTINUE_PROGRESS_FACTOR * prev)
                    ):
                        # slow, not singular: continue in a later chunk from
                        # the partial solution (u(1) = displacements[-1] = x)
                        job.cont[slot] += 1
                        job.warm[slot] = np.asarray(
                            result.displacements[-1], np.float32
                        )
                        job.last_rnorm[slot] = rnorm
                        stats["continuations"] += 1
                        continue
                    stats["failures"] += 1
                    stats["cg_failures"] += 1
                    stats["failed_lanes"].append(
                        (rnorm, int(result.iterations))
                    )
                    job.warm[slot] = None
                    job.cont[slot] = 0
                    job.last_rnorm[slot] = None
                    # Terminal CG failure: before resampling, try the host f64
                    # SuperLU lane — the reference keeps every finite direct
                    # solve (fea_analysis.py:455-461), so resampling here would
                    # thin the ill-conditioned tail of the data distribution.
                    if DIRECT_FALLBACK:
                        with stages.stage("direct_fallback"):
                            direct = direct_solve(job.pairs[slot][1])
                        if direct is not None:
                            job.results[slot] = direct
                            stats["direct_fallbacks"] += 1
                            continue
                    stats["cg_resamples"] += 1
                    job.retries += 1
                    with stages.stage("conditions"):
                        pair = (
                            fresh_pair(job.mesh, job.pool)
                            if job.retries <= max_condition_retries
                            else None
                        )
                    if pair is None:
                        job.retries = -1  # abandon marker
                        break
                    job.pairs[slot] = pair
                if job.retries < 0:
                    if verbose:
                        print("abandoning unsatisfiable plate")
                    continue  # dropped; queue refill preps a replacement
                if job.complete():
                    writes.append(job)
                else:
                    ready.append(job)  # retry rides a later chunk

            # Nothing in flight or ready: drain writes, then refill.
            if not ready and not flights:
                drain_writes()
                while in_system() + written < num_plates and len(ready) < group_size:
                    ready.append(prep_job())
    finally:
        for w in workers:
            w.close()

    # derived device-honest counters (see the stats comments above)
    stats["solves"] = stats["lane_dispatches"] - stats["continuations"]
    stats["failures"] = stats["cg_failures"]
    busy = 0.0
    end = None
    for s, e in sorted(busy_intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    stats["device_busy_s"] = busy
    stats["final_buckets"] = (
        buckets.node, buckets.tri, buckets.degree, buckets.band
    )
    if verbose:
        print("TOTAL TIME:", timer() - run_start)
        print(
            "final buckets:",
            ",".join(str(v) for v in stats["final_buckets"]),
        )
        print(stages.summary())
    stats["stage_seconds"] = stages.as_dict()
    return stats
