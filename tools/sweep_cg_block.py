"""Time the f32 FEM solves on the card by the length of the CG loop's
blocks (`check_every`: iterations queued between two host reads of the
loop's condition).

    python3 tools/sweep_cg_block.py

Two solves: the single-mesh solve of chip_smoke.py's gusset at the
production mesh size, and the flat chunk of chip_smoke.py's phase 9 (4
plates x 4 conditions at mesh 1e-2, the scheduler's budget of 300
iterations, one restart), with the band operator and with the incidence
operator. Every block length gives the same result bit for bit
(asserted); what changes is how many loop bodies are queued past an exit
and how often the host waits. Two passes each, printing ms per solve
(host clock, the device synchronised), iterations and host reads per
block length. Needs CUDA.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from fea_tpu_torch.mesh import triangulate  # noqa: E402
from fea_tpu_torch.utils.device import cuda_device  # noqa: E402

BLOCKS = (1, 4, 8, 16, 32, 64)


def timed_solve(problem, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = problem.solve(dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    return result, (time.perf_counter() - t0) * 1e3


def main():
    cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi())
    mesh = triangulate(chip_smoke.GUSSET, mesh_size=chip_smoke.FEM_MESH_SIZE)
    problem, _ = chip_smoke.gusset_problems(mesh)
    first, _ = timed_solve(problem)  # warm-up
    for turn in range(2):
        for block in BLOCKS:
            result, ms = timed_solve(problem, check_every=block)
            if not torch.equal(result.displacements, first.displacements):
                raise AssertionError(f"blocks of {block} changed the result")
            print(f"pass {turn}: blocks of {block}: {ms:.1f} ms per solve, "
                  f"{int(result.iterations)} iterations, {result.host_reads} host reads")
    # 6 restarts of one iteration each: the set-up, the restarts' residuals
    # and 6 loop bodies
    _, ms = timed_solve(problem, max_iters=6, check_every=1)
    print(f"set-up, 6 restarts and 6 iterations: {ms:.1f} ms")

    from fea_tpu_torch.datagen.batched import dispatch_plate_group

    for banded in (True, False):
        name = "band" if banded else "incidence"
        payloads = chip_smoke.chunk_payloads(cuda_device(), banded=banded)
        first = dispatch_plate_group(payloads).result()  # warm-up
        for turn in range(2):
            for block in BLOCKS:
                info = {}
                t0 = time.perf_counter()
                rows = dispatch_plate_group(payloads, check_every=block, info=info).result()
                ms = (time.perf_counter() - t0) * 1e3
                if not torch.equal(rows, first):
                    raise AssertionError(f"{name}: blocks of {block} changed the chunk")
                bodies = block * (info["host_reads"] - 1)
                print(f"chunk, {name}, pass {turn}: blocks of {block}: {ms:.1f} ms per chunk "
                      f"(set-up {info['setup_s'] * 1e3:.1f}, loop {info['loop_s'] * 1e3:.1f}), "
                      f"{int(rows[..., -1].max())} iterations, {info['host_reads']} host reads, "
                      f"{bodies} bodies, {info['loop_s'] * 1e3 / max(bodies, 1):.3f} ms per body")


if __name__ == "__main__":
    main()
