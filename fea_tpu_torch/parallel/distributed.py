"""The multi-process runtime of the port, the counterpart of
fea_tpu/parallel/distributed.py.

fea_tpu joins JAX's multi-controller runtime (one process per host,
`jax.distributed.initialize`) and lets GSPMD insert the collectives. The
port takes PyTorch's idiom: one process per GPU, joined into a
`torch.distributed` process group, NCCL on CUDA and gloo on the CPU.
`ensure_initialized` forms that group; `process_count`, `process_index`,
`is_main_process` and `sync_processes` read and synchronise it, and are
no-ops without one. Every host-side effect of the trainers (log files,
progress bars, checkpoint and sample writes, wandb) is gated on the main
process, rank 0, as in fea_tpu (the reference's
`accelerator.is_main_process`).

Launch with `torchrun --nproc_per_node N -m fea_tpu_torch train ...`, set
`FEA_TPU_COORDINATOR` / `FEA_TPU_NUM_PROCESSES` / `FEA_TPU_PROCESS_ID` (and
`LOCAL_RANK`) yourself, or spawn the ranks of a function with
`parallel.launch`.
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import cuda_device

# A collective that waits longer than this fails: gloo raises, NCCL's
# watchdog aborts the group.
DEFAULT_TIMEOUT_S = 600.0

_DECIDED = False
_DEVICE: Optional[torch.device] = None
_HOST_GROUP = None  # gloo group for host tensors when the default group is NCCL


def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def ensure_initialized(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Idempotently join the process group.

    Each of the three values resolves in this order: the argument,
    `FEA_TPU_COORDINATOR` / `FEA_TPU_NUM_PROCESSES` / `FEA_TPU_PROCESS_ID`
    (fea_tpu's names), then torchrun's `MASTER_ADDR` / `WORLD_SIZE` /
    `RANK`. An address without a scheme is `tcp://host:port`; `file://` and
    `env://` pass through. With none of them set this is a no-op that
    creates no group and touches no device, and the decision sticks.

    The process runs on `device`: by default, and for "cuda" without an
    index, `cuda:LOCAL_RANK` (or `cuda:<process_id mod cards>` without
    `LOCAL_RANK`), raising where there is no card; pass "cpu" for a CPU
    group. On CUDA the device is made
    current before the group forms. `backend` defaults to NCCL on CUDA and
    gloo on the CPU (gloo also carries CUDA tensors for all_reduce and
    broadcast, so two ranks can share one card). A collective that waits
    more than `timeout_s` fails.

    Returns True if a process group is (now) active."""
    global _DECIDED, _DEVICE, _HOST_GROUP
    if _DECIDED:
        return dist.is_initialized()

    address = coordinator_address or os.environ.get("FEA_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("FEA_TPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("FEA_TPU_PROCESS_ID", "RANK")
    if address is None and "MASTER_ADDR" in os.environ:
        address = "env://"  # torchrun: MASTER_ADDR and MASTER_PORT
    if address is None:
        _DECIDED = True  # one process: nothing to join
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            f"joining the process group at {address} needs the number of "
            "processes and this process's index (FEA_TPU_NUM_PROCESSES and "
            "FEA_TPU_PROCESS_ID, or torchrun's WORLD_SIZE and RANK)"
        )
    if "://" not in address:
        address = f"tcp://{address}"

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:  # this rank's own card, not the current one
            local_rank = _env_int("LOCAL_RANK")
            if local_rank is None:
                cuda_device()  # raises without a card
                local_rank = process_id % torch.cuda.device_count()
            device = torch.device("cuda", local_rank)
        # before the group forms: an NCCL rank left on the default device
        # would put every rank on cuda:0
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=address, world_size=num_processes, rank=process_id,
        timeout=timeout,
    )
    _HOST_GROUP = dist.new_group(backend="gloo", timeout=timeout) if backend == "nccl" else None
    _DEVICE = device
    _DECIDED = True
    return True


def shutdown() -> None:
    """Leave the process group (if any); the next `ensure_initialized`
    decides afresh."""
    global _DECIDED, _DEVICE, _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _DECIDED, _DEVICE, _HOST_GROUP = False, None, None


def local_device() -> torch.device:
    """This process's device: the group's (`cuda:LOCAL_RANK` unless set
    otherwise), or without a group the CUDA device, raising where there is
    none."""
    return _DEVICE if dist.is_initialized() else cuda_device()


def host_group():
    """The group that carries host tensors: the default one under gloo, a
    gloo group beside it under NCCL."""
    return _HOST_GROUP


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Reference parity: `accelerator.is_main_process`. Gates checkpoint
    writes, sample and image writes, log files, wandb and progress bars to
    exactly one process."""
    return process_index() == 0


def sync_processes() -> None:
    """A barrier over the group (the reference's
    `accelerator.wait_for_everyone()`); a no-op without a group. Under NCCL
    it names this process's device."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[_DEVICE.index])
    else:
        dist.barrier()
