"""The graph stage over several processes: the counterpart of
sibeliaz_tpu/parallel/multihost.py, on torch.distributed.

Every process holds the whole input and runs one shard of the joined
stream on its own device (parallel/sharded.py's steps a-f, over the
Distributed transport below): the counts and rows cross by
all_to_all_single with exact split sizes, the junction rows by all_gather,
and every rank returns the same records.

The backend follows the device: NCCL for tensors on the card, gloo for
tensors on the CPU.  A CUDA tensor on a gloo group (or a CPU tensor on an
NCCL group) raises; nothing is staged through the host on the way.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sibeliaz_tpu_torch.io.dbg import JunctionChr
from sibeliaz_tpu_torch.parallel import sharded

# The backend each device type's tensors travel on.
BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the default process group; a no-op for one process (world_size
    None or 1) and when a group is already up.  backend: "nccl" (default:
    the card) or "gloo" (shards on the CPU).  init_method is the store's
    address, e.g. "tcp://host:port" or "file:///path"; None takes
    torch.distributed's env:// variables."""
    if world_size is None or world_size <= 1 or dist.is_initialized():
        return
    dist.init_process_group(backend or "nccl", init_method=init_method,
                            world_size=world_size, rank=rank)


class Distributed:
    """One shard a rank of `group`, on `device`, with the transport
    interface of sharded.InProcess."""

    def __init__(self, device, group=None):
        self.group = group
        self.devices = [sharded.normalize(device)]
        backend = dist.get_backend(group)
        want = BACKEND_OF.get(self.devices[0].type)
        if backend != want:
            raise ValueError(f"a {backend} group cannot carry tensors on {self.devices[0]} "
                             f"(that takes {want})")
        self.n = dist.get_world_size(group)
        self.shards = [dist.get_rank(group)]

    def swap_counts(self, counts: List[List[int]]) -> List[List[int]]:
        recv = torch.empty(self.n, dtype=torch.int64, device=self.devices[0])
        dist.all_to_all_single(
            recv, torch.tensor(counts[0], dtype=torch.int64, device=self.devices[0]),
            group=self.group)
        return [recv.tolist()]

    def exchange(self, send_counts, recv_counts, tensors):
        out = []
        for t in tensors[0]:
            got = torch.empty(sum(recv_counts[0]), dtype=t.dtype, device=t.device)
            dist.all_to_all_single(got, t, recv_counts[0], send_counts[0], group=self.group)
            out.append(got)
        return [out]

    def gather(self, rows: List[torch.Tensor]) -> np.ndarray:
        """All ranks' [m, 2] rows, in rank order, on every rank: the sizes
        first, then the rows padded to the largest."""
        mine = rows[0]
        size = torch.tensor([mine.shape[0]], dtype=torch.int64, device=mine.device)
        sizes = [torch.empty_like(size) for _ in range(self.n)]
        dist.all_gather(sizes, size, group=self.group)
        sizes = [int(s) for s in sizes]
        padded = torch.zeros(max(*sizes, 1), mine.shape[1], dtype=mine.dtype, device=mine.device)
        padded[: mine.shape[0]] = mine
        parts = [torch.empty_like(padded) for _ in range(self.n)]
        dist.all_gather(parts, padded, group=self.group)
        return torch.cat([p[:m].cpu() for p, m in zip(parts, sizes)]).numpy()


def build_junctions_multihost(seqs: Sequence[np.ndarray], k: int, group=None,
                              device=None) -> List[JunctionChr]:
    """construct.build_junctions over every rank of `group` (None: the
    default group), one shard a rank on `device` (None: cuda:LOCAL_RANK).
    Every rank must call it with the same inputs; every rank returns the
    same records.  Without a process group (one process),
    sharded.build_junctions_sharded over that one device."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    if group is None and not dist.is_initialized():
        return sharded.build_junctions_sharded(seqs, k, devices=[device])
    return sharded.junctions_over(seqs, k, Distributed(device, group))
