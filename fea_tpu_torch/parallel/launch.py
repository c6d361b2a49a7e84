"""Spawn the ranks of a process group on this host and collect their
results.

    results = launch(fn, world_size, args, devices=["cuda:0", "cuda:1"])

Each rank is a fresh process (the `spawn` start method) that joins the
group through a `file://` rendezvous in a temporary directory of its own,
so launches never contend for a port, runs `fn(*args)` on its device, and
sends back what `fn` returns. The tests, parallel/scaling.py and
chip_smoke.py use it; the CLI runs under `torchrun` instead.
"""

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from . import distributed

# a rank's process that has sent its result gets this long to end cleanly
EXIT_GRACE_S = 60.0


def _rank_main(fn, args, rank, world_size, init_method, device, backend, timeout_s, threads,
               results):
    if torch.device(device).type == "cpu":
        # CPU ranks share the launcher's threads: each spinning on all the
        # host's cores would stall the others
        torch.set_num_threads(threads)
    try:
        distributed.ensure_initialized(
            init_method, world_size, rank, device=device, backend=backend, timeout_s=timeout_s)
        # pickled here, by value: a queue would pass tensors as shared-memory
        # handles that die with this process
        out = pickle.dumps(fn(*args))
        distributed.sync_processes()  # no rank leaves the group while another still uses it
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def launch(
    fn: Callable,
    world_size: int,
    args: Sequence = (),
    devices: Optional[Sequence] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> List[Any]:
    """Run `fn(*args)` in `world_size` processes joined into one process
    group; returns their results in rank order.

    `fn` must be a top-level function of a module that imports without JAX
    (each rank imports it by name), and return what pickles: CPU tensors,
    arrays, numbers. Rank r runs on `devices[r]` (default: `cuda:r`, which
    raises where there are fewer cards); repeats are allowed, so two ranks
    can share one card over gloo. `backend` defaults to NCCL on CUDA, gloo
    on the CPU. A rank that raises fails the launch with that rank's
    traceback (RuntimeError), and so does one that dies without a result;
    ranks still running after `timeout_s` fail it with TimeoutError. A CPU
    rank takes an equal share of this process's torch threads. Every
    process has ended when this returns or raises."""
    if devices is None:
        if torch.cuda.device_count() < world_size:
            raise ValueError(
                f"{world_size} ranks need {world_size} CUDA devices, "
                f"{torch.cuda.device_count()} visible; name the devices"
            )
        devices = [f"cuda:{r}" for r in range(world_size)]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")

    threads = max(1, torch.get_num_threads() // world_size)  # for CPU ranks
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = []
    with tempfile.TemporaryDirectory(prefix="fea_launch_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        try:
            for rank in range(world_size):
                proc = ctx.Process(
                    target=_rank_main, daemon=True, name=f"fea-rank-{rank}",
                    args=(fn, tuple(args), rank, world_size, init_method, str(devices[rank]),
                          backend, timeout_s, threads, results),
                )
                proc.start()
                procs.append(proc)
            out = {}
            deadline = time.monotonic() + timeout_s
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(out))
                    raise TimeoutError(f"ranks {missing} did not finish within {timeout_s} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    for rank, proc in enumerate(procs):
                        if rank not in out and proc.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"rank {rank} exited with code {proc.exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                out[rank] = pickle.loads(value)
            for proc in procs:
                proc.join(EXIT_GRACE_S)
            return [out[rank] for rank in range(world_size)]
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
            for proc in procs:
                proc.join()
            results.close()
