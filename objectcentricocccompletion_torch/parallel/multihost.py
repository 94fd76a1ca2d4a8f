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

``make_multihost_mesh`` lays the ranks out as a 2D ``DeviceMesh`` named
``("data", "model")``, the model axis innermost, so that consecutive ranks
form a model group (the JAX package's mesh, whose model axis stays inside
a host). The model-parallel train step makes its mesh the current one
while it runs (:func:`use_mesh`); the helpers below then read its groups,
and without a current mesh they read the world as the data axis (the
data-parallel launch) and a model axis of one rank.
"""
from __future__ import annotations

import contextlib
import datetime
import os

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
    """A detached copy of ``x`` summed over the data axis's ranks where
    there is more than one, and ``x`` itself otherwise: what makes a
    per-rank term equal to the global batch's (the reference's
    ``reduce_mean`` avg-factor)."""
    if data_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=data_group())
    return out


_MESH: list = [None]     # the mesh of the step that runs, or None


def make_multihost_mesh(model_axis_size: int = 1, device_type: str | None
                        = None, world: int | None = None,
                        per_host: int | None = None):
    """The 2D ``("data", "model")`` ``DeviceMesh`` of the process group:
    ``world / model_axis_size`` data rows of ``model_axis_size``
    consecutive ranks. Raises ``ValueError`` where the world (default:
    the process group's) does not divide into model groups, or a model
    group would not fit in one host: the hosts hold ``per_host`` ranks
    each (default ``LOCAL_WORLD_SIZE``, else the world: ``initialize``
    assumes one host). Returns None in one process without a process
    group, where nothing is laid out. ``device_type``: the mesh's devices
    (default ``cuda`` where a card is present, else ``cpu``)."""
    world = world_size() if world is None else world
    m = model_axis_size
    if m < 1 or world % m:
        raise ValueError(f"--tp {m}: {world} process(es) do not divide "
                         f"into model groups of {m} (one process per card: "
                         f"--tp N needs a multiple of N processes)")
    if per_host is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if m > per_host:
        raise ValueError(f"--tp {m}: the model axis must fit inside one "
                         f"host ({per_host} ranks) so its collectives stay "
                         f"on the host's links")
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (world // m, m),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None) the current one while the
    block runs."""
    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        yield mesh
    finally:
        _MESH[0] = prev


def current_mesh():
    return _MESH[0]


def _axis(mesh, name: str):
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, None
    return mesh, name


def data_group(mesh=None):
    """The process group of this rank's data axis (None: the default
    group, which is the data axis without a mesh)."""
    mesh, name = _axis(mesh, "data")
    return None if mesh is None else mesh.get_group(name)


def model_group(mesh=None):
    """The process group of this rank's model axis; None where there is
    no model axis."""
    mesh, name = _axis(mesh, "model")
    return None if mesh is None else mesh.get_group(name)


def data_size(mesh=None) -> int:
    mesh, name = _axis(mesh, "data")
    return world_size() if mesh is None else mesh.size(
        mesh.mesh_dim_names.index(name))


def model_size(mesh=None) -> int:
    mesh, name = _axis(mesh, "model")
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(name))


def data_rank(mesh=None) -> int:
    """This rank's row on the data axis: its slice of the global batch."""
    mesh, name = _axis(mesh, "data")
    return rank() if mesh is None else mesh.get_local_rank(name)


def model_rank(mesh=None) -> int:
    mesh, name = _axis(mesh, "model")
    return 0 if mesh is None else mesh.get_local_rank(name)
