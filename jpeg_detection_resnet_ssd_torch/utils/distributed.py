"""Process-group bring-up and rank-0 gating.

Counterpart of the JAX package's `utils/distributed.py`, which calls
`jax.distributed.initialize()` from `JAX_COORDINATOR_ADDRESS`,
`JAX_NUM_PROCESSES` and `JAX_PROCESS_ID`.  Here the contract is the one
`torchrun` sets: `RANK`, `WORLD_SIZE`, `LOCAL_RANK` and `MASTER_ADDR` /
`MASTER_PORT` (the `env://` rendezvous), or explicit arguments.  One process
drives one card (`cuda:{LOCAL_RANK}`) over NCCL; gloo runs on the CPU, and
is the only backend that puts two ranks on one card (NCCL refuses two ranks
on one device).  `is_primary_process()` gates side effects (run dirs,
checkpoints, logs) as the reference gates on `hvd.rank() == 0`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """This process's card on its host (`LOCAL_RANK`, 0 without one)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def maybe_initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    timeout: datetime.timedelta | None = None,
) -> bool:
    """Join the process group when a multi-process contract is given (the
    arguments, or `WORLD_SIZE`/`RANK` from `torchrun`); returns True when
    more than one process takes part.  Re-entrant: with a process group
    already up it only answers.  `backend` None is NCCL when CUDA is
    available, else gloo; with NCCL the process's card is set to
    `cuda:{LOCAL_RANK}` first.  `timeout` bounds every collective (torch's
    default when None)."""
    if _initialized():
        return dist.get_world_size() > 1
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None:
        return False  # no multi-process contract
    if rank is None:
        raise ValueError("a world size without a rank: set RANK or pass rank=")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return world_size > 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if _initialized() else 1


def is_primary_process() -> bool:
    """True on rank 0, and without a process group."""
    return process_index() == 0
