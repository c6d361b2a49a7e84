"""Data-parallel helpers over the process group, the counterpart of
fea_tpu/parallel/mesh.py.

fea_tpu builds a ('dp',) `jax.sharding.Mesh` (an outer 'dcn' axis across
hosts), shards the batch axis over it, replicates the params and lets XLA
insert the gradient psum. The port's counterpart is the process group of
parallel/distributed.py, one process per GPU, and these helpers:

  * `make_mesh` -> `DataParallel`, the data-parallel view (world size,
    rank, device);
  * `batch_sharding` / `shard_batch` -> `DataParallel.rows`: rank r feeds
    the contiguous rows [r B / W, (r + 1) B / W) of every micro-batch,
    fea_tpu's process-major layout (`Trainer._fetch_batch`);
  * the psum -> `all_reduce_mean`, one flat bucket;
  * `process_allgather` of outputs -> `gather_rows`, through host tensors;
  * `replicated_sharding` / `replicate` -> `replicate`, a broadcast from
    rank 0.

fea_tpu's hybrid DCN x ICI device grouping (`make_mesh(dcn_size=)`,
`create_hybrid_device_mesh`) has no counterpart here: NCCL picks its own
rings and trees, over NVLink within a host and the network across hosts.
"""

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from . import distributed


@dataclass(frozen=True)
class DataParallel:
    world_size: int
    rank: int
    device: torch.device
    distributed: bool  # a process group is active (of any size, 1 included)

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a batch of `batch_size`."""
        return row_block(batch_size, self.world_size, self.rank)


def row_block(batch_size: int, world_size: int, rank: int) -> slice:
    """Rows [rank B / W, (rank + 1) B / W) of a batch of B over W ranks."""
    if batch_size % world_size:
        raise ValueError(f"batch size {batch_size} must divide over {world_size} ranks")
    per = batch_size // world_size
    return slice(rank * per, (rank + 1) * per)


def make_mesh(n_devices: Optional[int] = None, device=None) -> DataParallel:
    """The data-parallel view of this process. `n_devices=None` means the
    whole group, or 1 without a group (fea_tpu's "every device"); another
    number must equal the group's size. `device` defaults to the group's
    device (`distributed.local_device`)."""
    world = distributed.process_count()
    if n_devices is not None and n_devices != world:
        how = (
            f"launch one process per GPU, e.g. `torchrun --nproc_per_node {n_devices} "
            "-m fea_tpu_torch train ...`, or spawn the ranks with parallel.launch"
        )
        if not dist.is_initialized():
            raise ValueError(f"n_devices={n_devices}, but this process is in no process group: {how}")
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks: {how}")
    return DataParallel(
        world_size=world,
        rank=distributed.process_index(),
        device=torch.device(device) if device is not None else distributed.local_device(),
        distributed=dist.is_initialized(),
    )


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("one bucket holds tensors of one dtype")
    return torch.cat([t.reshape(-1) for t in tensors])


@torch.no_grad()
def _unflat_(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """In place: each tensor becomes its mean over the group's ranks, by
    one all_reduce of a flat bucket (one dtype). A no-op without a group."""
    if not dist.is_initialized():
        return
    flat = _flat(tensors)
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    _unflat_(tensors, flat)


def gather_rows(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `tensor` (the same shape on every rank),
    concatenated in rank order, as a CPU tensor on every rank. It goes
    through host tensors, so it runs on gloo with CUDA tensors and, through
    the gloo host group, under NCCL. Without a group: `tensor` on the host."""
    host = tensor.detach().cpu().contiguous()
    if not dist.is_initialized():
        return host
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host, group=distributed.host_group())
    return torch.cat(parts)


def replicate(tensors: List[torch.Tensor]) -> None:
    """In place: every rank takes rank 0's values, by one broadcast of a
    flat bucket per dtype. A no-op without a group."""
    if not dist.is_initialized():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flat(group)
        dist.broadcast(flat, src=0)
        _unflat_(group, flat)
