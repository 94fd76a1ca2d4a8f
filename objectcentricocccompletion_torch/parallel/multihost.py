"""The multi-process launch (counterpart of the JAX package's
``parallel/multihost.py``: ``initialize``, ``process_allgather`` and
``sync_hosts``), on ``torch.distributed``.

One process per card: ``initialize`` joins the process group over TCP and
gives each rank its device, ``cuda:{rank % device_count}`` (nothing tells a
program of a cluster, so a rank's card assumes one host), or the CPU. The
backend is ``nccl`` on the card and ``gloo`` on the CPU. NCCL refuses two
ranks on one card; ``gloo`` serves that layout (it all-reduces and
broadcasts CUDA tensors through the host) and must be asked for by name:
nothing switches backend by itself. Every helper is the identity, and
``rank()`` / ``world_size()`` are 0 / 1, where no process group is up, so
one script runs unchanged from one process to many.

``make_multihost_mesh`` (the JAX package's 2D data x model mesh) belongs
to tensor parallelism and is not ported yet.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> torch.device:
    """Join ``num_processes`` processes at ``coordinator_address``
    (``host:port``, served by rank 0) as rank ``process_id``, and return
    this rank's device: ``cuda:{rank % device_count}`` where ``device`` is
    CUDA (the default), else the CPU. One process (``num_processes`` None or
    1) joins nothing and returns ``device``; an address without a process
    count raises (nothing detects a cluster here). ``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU; ``nccl`` raises on the
    CPU and where two ranks would share a card (pass ``backend="gloo"``
    for that layout)."""
    dev = resolve_device(device)
    if num_processes is None and coordinator_address is not None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    if num_processes is None or num_processes <= 1:
        return dev
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process launch needs --coordinator, "
                         "--num-processes and --process-id together")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, "
                         f"{num_processes})")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and num_processes > count:
            raise ValueError(
                f"nccl cannot serve {num_processes} ranks on {count} "
                f"card(s): NCCL refuses two ranks on one card; pass "
                f"backend='gloo' for that layout")
        dev = torch.device("cuda", process_id % count)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("nccl needs CUDA devices; the CPU takes gloo")
    dist.init_process_group(backend, init_method="tcp://"
                            + coordinator_address, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    return dev


def shutdown() -> None:
    """Leave the process group, where one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The number of processes, 1 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_allgather(obj):
    """Every rank's ``obj`` (any picklable object), in rank order; the
    identity in one process. Where the JAX package stacks each rank's
    arrays on a new leading axis, this returns the list."""
    if world_size() == 1:
        return obj
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def sync_hosts(name: str = "sync") -> None:
    """A barrier across the processes (``name`` documents the call site,
    as in the JAX package); nothing in one process."""
    del name
    if world_size() > 1:
        dist.barrier()


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A detached copy of ``x`` summed over the ranks where more than one
    process is up, and ``x`` itself otherwise: what makes a per-rank term
    equal to the global batch's (the reference's ``reduce_mean``
    avg-factor)."""
    if world_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out
