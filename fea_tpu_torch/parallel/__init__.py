"""Multi-GPU data parallelism, the counterpart of fea_tpu.parallel: the
process group (`distributed`), the data-parallel helpers that stand in for
fea_tpu's mesh and shardings (`mesh`), a launcher of ranks (`launch`), and
the sharding-efficiency measurements (`scaling`)."""

from .distributed import (
    ensure_initialized,
    is_main_process,
    local_device,
    process_count,
    process_index,
    shutdown,
    sync_processes,
)
from .launch import launch
from .mesh import DataParallel, all_reduce_mean, gather_rows, make_mesh, replicate, row_block

__all__ = [
    "make_mesh",
    "DataParallel",
    "row_block",
    "replicate",
    "all_reduce_mean",
    "gather_rows",
    "ensure_initialized",
    "shutdown",
    "local_device",
    "is_main_process",
    "process_count",
    "process_index",
    "sync_processes",
    "launch",
]
