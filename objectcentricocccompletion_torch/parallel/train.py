"""The OcOccNet training step (counterpart of the JAX package's
``parallel/train.py``: ``create_train_state``, the mesh makers, the
parameter layouts and ``make_train_step`` / ``make_train_multi_step`` with
the tree optimizer).

A step runs the loss, the backward, the gradients' global norm (before the
clip, as ``optax.global_norm(grads)``), the clip at ``cfg.grad_clip_norm``
and AdamW at ``schedule(step)``, step counted from 0. The parameters stay
float32; ``cfg.compute_dtype`` sets the compute dtype. Dropout draws its
keys on the device from ``[seed, step]``, so a step reads nothing back to
the host.

Data parallelism (a process group up, ``parallel/multihost.py``): each
rank holds the whole model and its slice of the global batch, and the loss
goes through ``DistributedDataParallel`` (one forward per backward), whose
reducer all-reduces every parameter's gradient, the frozen auto-encoder's
under ``fixed_ae`` too (the JAX ``grad_norm`` covers it). DDP rather than
an all-reduce after ``backward()``: it overlaps the buckets' all-reduce
with the backward, and every OcOccNet / CTRL parameter takes a gradient in
every step, as DDP without ``find_unused_parameters`` needs. The loss's
positive counts are the global batch's (``global_sum``), dropout offsets
its counter by the rank (``models/layers.py::DropoutKeys``), and the logged
loss entries are the ranks' mean: the run equals one process on the global
batch. The clip and AdamW then run on equal gradients on every rank.

Model parallelism (``mesh``: a ``DeviceMesh`` of :func:`make_mesh_2d` or
``make_multihost_mesh``, ``("data", "model")``): the batch splits over the
data axis, and the model ranks of one data rank share its slice. The
layout is the JAX package's ``_state_shardings`` ladder, FSDP before TP:

- tensor parallelism (``param_shardings``): each wide Dense holds its rows
  of the output (:class:`ColumnParallel`, which ``models/layers.py::dense``
  calls), its output gathered over the model group before the next layer
  and its input's gradient summed there (Megatron's f / g); DDP runs over
  the data group;
- FSDP (``param_shardings_fsdp``): each large parameter and its AdamW
  moments hold this data rank's chunk; the step gathers the whole
  parameters in one collective before the forward and reduce-scatters
  their gradients in one, and averages the small replicated ones in one
  all-reduce; the model axis then serves sequence parallelism only;
- sequence parallelism (``parallel/sp.py``, set while the step runs):
  the packed points and the decoder's queries split over the model group,
  and the parameters that read them (``models/ococcnet.py::
  sequence_sharded``) get their gradients summed over it.

The global norm counts each sharded gradient once (its squares summed over
its group), and checkpoints hold whole tensors (:meth:`Layout.full_state`).

The flat and stacked optimizer layouts (``create_train_state(flat_opt=True
| stacked_opt=True)``, ``make_train_step(flat_opt=, stacked_spec=)``) hold
every parameter in a few contiguous buffers: two flat vectors (decayed and
not), or one ``[count, *shape]`` stack per (decay, dtype, shape) group. The
buffers are laid out element for element as the JAX package's
(:func:`make_flat_opt_spec`, :func:`make_stacked_opt_spec`: the flax tree's
leaf order, names and shapes through ``convert.py``), the parameters and
their gradients are views of them, and the clip and AdamW run over the
buffers (``training/optim.py::BufferAdamW``). They serve the replicated
layout (one process, or data parallelism) only, as in the JAX package; a
module's ``state_dict`` still holds whole tensors under the tree's names.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.nn import functional as F
from torch.nn.parallel import DistributedDataParallel

from ..configs.ococcnet_config import OcOccNetConfig
from ..convert import flax_leaf
from ..data.tracklet import TrackletBatch
from ..models.layers import DropoutKeys
from ..models.ococcnet import OcOccNetWithLoss, sequence_sharded
from ..training.optim import (BufferAdamW, clip_grad_global_norm_, decays,
                              global_norm, make_flat_optimizer,
                              make_optimizer, make_stacked_optimizer, set_lr)
from . import collectives as cc
from . import sp
from .multihost import (data_group, data_rank, data_size, global_sum,
                        model_group, use_mesh, world_size)

__all__ = ["ColumnParallel", "FlatOptSpec", "Layout", "StackedOptSpec",
           "create_train_state", "flatten_by_spec", "frozen_prefixes",
           "global_sum", "make_flat_opt_spec", "make_mesh", "make_mesh_2d",
           "make_stacked_opt_spec", "make_train_multi_step",
           "make_train_step", "mean_over_ranks", "param_shardings",
           "param_shardings_fsdp", "shard_batch", "stack_by_spec",
           "unflatten_by_spec", "unstack_by_spec", "wrap_ddp"]


def frozen_prefixes(cfg: OcOccNetConfig) -> tuple:
    """Parameter names that take no update: the occupancy auto-encoder
    under ``fixed_ae`` (the reference's frozen-AE mode)."""
    return ("ae_encoder",) if cfg.fixed_ae else ()


class FlatOptSpec(NamedTuple):
    """Where each parameter lies in the two flat vectors of the flat
    optimizer (``{"decay", "nodecay"}``, the split of
    ``training/optim.py::decays``). Per parameter, in the flax tree's leaf
    order: its name (``names``), ``(group, offset, size, flax shape,
    dtype)`` (``entries``, the JAX spec's) and the permutation from its
    torch layout to the flax one (``perms``, flax dim i = torch dim
    ``perm[i]``)."""
    names: tuple
    entries: tuple
    perms: tuple
    sizes: dict


class StackedOptSpec(NamedTuple):
    """Where each parameter lies in the shape-grouped stacks of the stacked
    optimizer: every parameter of one (decay, dtype, flax shape) group at
    one slot of a ``[count, *shape]`` stack, keyed ``"d:float32:AxB"`` ("n"
    without decay) as in the JAX package. ``entries``: per parameter
    ``(key, slot, flax shape, dtype)``; ``groups``: key -> ``(count, shape,
    dtype)``."""
    names: tuple
    entries: tuple
    perms: tuple
    groups: dict


def _tree_leaves(params: dict) -> list:
    """``(name, perm, flax shape, decays)`` of each parameter of ``params``
    (name -> tensor, torch layout), in the flax tree's leaf order: sorted by
    the flax path, as ``jax.tree_util`` flattens a dict."""
    rows = []
    for name, p in params.items():
        path, perm, mirrored = flax_leaf(name, tuple(p.shape))
        if mirrored:
            raise ValueError(f"{name}: a transposed convolution's taps are "
                             f"mirrored in the flax tree, which no view "
                             f"of a buffer can hold")
        rows.append((path, name, perm,
                     tuple(int(p.shape[d]) for d in perm), decays(name)))
    return [r[1:] for r in sorted(rows)]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def make_flat_opt_spec(params: dict) -> FlatOptSpec:
    """The flat layout of ``params`` (name -> tensor; its shapes alone)."""
    offs = {"decay": 0, "nodecay": 0}
    names, entries, perms = [], [], []
    for name, perm, shape, dec in _tree_leaves(params):
        g = "decay" if dec else "nodecay"
        size = math.prod(shape)
        names.append(name)
        perms.append(perm)
        entries.append((g, offs[g], size, shape, params[name].dtype))
        offs[g] += size
    return FlatOptSpec(tuple(names), tuple(entries), tuple(perms), offs)


def make_stacked_opt_spec(params: dict) -> StackedOptSpec:
    """The stacked layout of ``params`` (name -> tensor; its shapes
    alone)."""
    counts: dict = {}
    names, entries, perms = [], [], []
    for name, perm, shape, dec in _tree_leaves(params):
        dt = params[name].dtype
        key = (("d" if dec else "n") + ":" + _dtype_name(dt) + ":"
               + "x".join(str(s) for s in shape))
        slot = counts.get(key, 0)
        counts[key] = slot + 1
        names.append(name)
        perms.append(perm)
        entries.append((key, slot, shape, dt))
    groups = {key: (counts[key], shape, dt) for key, _, shape, dt in entries}
    return StackedOptSpec(tuple(names), tuple(entries), tuple(perms), groups)


def _to_torch(perm) -> tuple:
    return tuple(sorted(range(len(perm)), key=perm.__getitem__))


def flatten_by_spec(spec: FlatOptSpec, tree: dict) -> dict:
    """``tree`` (name -> tensor, torch layout) as the two flat vectors, each
    tensor in its flax layout (new contiguous tensors)."""
    parts: dict = {"decay": [], "nodecay": []}
    for name, perm, (g, *_) in zip(spec.names, spec.perms, spec.entries):
        parts[g].append(tree[name].permute(perm).reshape(-1))
    dev = next(iter(tree.values())).device
    return {g: (torch.cat(v) if v else torch.zeros(0, device=dev))
            for g, v in parts.items()}


def unflatten_by_spec(spec: FlatOptSpec, flat: dict) -> dict:
    """name -> each parameter of ``flat`` in its torch layout: views."""
    return {name: flat[g][off:off + size].view(shape).permute(_to_torch(perm))
            for name, perm, (g, off, size, shape, _) in zip(
                spec.names, spec.perms, spec.entries)}


def stack_by_spec(spec: StackedOptSpec, tree: dict) -> dict:
    """``tree`` (name -> tensor, torch layout) as the stacks, each tensor in
    its flax layout (new contiguous tensors)."""
    parts = {k: [None] * c for k, (c, _, _) in spec.groups.items()}
    for name, perm, (key, slot, _, _) in zip(spec.names, spec.perms,
                                             spec.entries):
        parts[key][slot] = tree[name].permute(perm)
    return {k: torch.stack(v) for k, v in parts.items()}


def unstack_by_spec(spec: StackedOptSpec, stacked: dict) -> dict:
    """name -> each parameter of ``stacked`` in its torch layout: views."""
    return {name: stacked[key][slot].permute(_to_torch(perm))
            for name, perm, (key, slot, _, _) in zip(
                spec.names, spec.perms, spec.entries)}


def create_train_state(cfg: OcOccNetConfig, total_steps: int,
                       device="cuda", seed: int = 0, flat_opt: bool = False,
                       stacked_opt: bool = False):
    """``(model, optimizer, schedule)``: ``OcOccNetWithLoss`` with weights
    drawn from a ``torch.Generator`` seeded with ``seed``, on ``device``
    (``cuda`` unless the caller asks for the CPU), and AdamW with the
    cyclic-cosine schedule of the config's recipe. The model is whole on
    every rank; ``make_train_step`` lays it out.

    ``flat_opt``: the optimizer is ``make_flat_optimizer``'s over the flat
    vectors of :func:`make_flat_opt_spec`, the parameters views of them
    (pass ``flat_opt=True`` to ``make_train_step``). ``stacked_opt`` (which
    wins): the same over the stacks of :func:`make_stacked_opt_spec`, and
    the spec is returned too: ``(model, optimizer, schedule, spec)`` (pass
    ``stacked_spec=spec``). Neither supports the frozen auto-encoder
    (``fixed_ae``), as in the JAX package."""
    if (flat_opt or stacked_opt) and frozen_prefixes(cfg):
        raise ValueError("flat_opt / stacked_opt do not support frozen "
                         "parameters (fixed_ae=True): use the tree optimizer")
    model = OcOccNetWithLoss(cfg, device,
                             torch.Generator().manual_seed(seed))
    kw = dict(weight_decay=cfg.weight_decay, peak_ratio=cfg.lr_mult)
    if not (flat_opt or stacked_opt):
        optimizer, schedule = make_optimizer(
            model.named_parameters(), cfg.base_lr, total_steps,
            frozen_prefixes=frozen_prefixes(cfg), **kw)
        return model, optimizer, schedule
    named = dict(model.named_parameters())
    if stacked_opt:
        spec = make_stacked_opt_spec(named)
        build, unbuild, make = (stack_by_spec, unstack_by_spec,
                                make_stacked_optimizer)
    else:
        spec = make_flat_opt_spec(named)
        build, unbuild, make = (flatten_by_spec, unflatten_by_spec,
                                make_flat_optimizer)
    optimizer, schedule = make(build(spec, named), cfg.base_lr, total_steps,
                               grad_clip=cfg.grad_clip_norm, **kw)
    views = unbuild(spec, optimizer.params)
    grads = unbuild(spec, optimizer.grads)
    optimizer.bind([named[n] for n in spec.names],
                   [views[n] for n in spec.names],
                   [grads[n] for n in spec.names])
    return (model, optimizer, schedule) + ((spec,) if stacked_opt else ())


def make_mesh(device_type: str | None = None):
    """A 1D ``("data",)`` mesh over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type), (world_size(),),
                            mesh_dim_names=("data",))


def make_mesh_2d(data: int, model: int, device_type: str | None = None):
    """A ``[data, model]`` mesh (DP x TP) of ``data * model`` ranks, the
    process group's world; the model axis holds consecutive ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if data * model != world_size():
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"processes, not {world_size()}")
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _axis_sizes(mesh) -> dict:
    """``{axis: ranks}`` of a ``DeviceMesh``, or ``mesh`` itself where it is
    already such a mapping (the JAX ``mesh.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh)


def _named_shapes(model) -> list:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def param_shardings(model, mesh, min_dim: int = 1024) -> dict:
    """Tensor-parallel layout: ``{name: dim or None}`` over ``model``'s
    parameters. The JAX rule on the flax leaf (``convert.flax_leaf``): a 2D
    kernel ``[in, out]`` with ``out >= min_dim`` and ``out`` divisible by
    the model axis shards ``out`` over it, which is dim 0 of the torch
    ``nn.Linear`` weight ``[out, in]``; everything else (None) is
    replicated. ``mesh``: a ``DeviceMesh`` or ``{axis: size}``."""
    sizes = _axis_sizes(mesh)
    out = {}
    for name, shape in _named_shapes(model):
        _, perm, _ = flax_leaf(name, shape)
        flax = [shape[d] for d in perm]
        out[name] = (perm[1] if "model" in sizes and len(flax) == 2
                     and flax[1] >= min_dim and flax[1] % sizes["model"] == 0
                     else None)
    return out


def param_shardings_fsdp(model, mesh, axis: str = "data",
                         min_size: int = 1 << 15) -> dict:
    """FSDP (ZeRO-3) layout: ``{name: dim or None}``. The JAX rule on the
    flax leaf: a tensor of at least ``min_size`` elements shards the
    largest flax dim divisible by the ``axis`` size (the first of equal
    ones), mapped to its torch dim; smaller tensors are replicated (None).
    The AdamW moments follow their parameter."""
    n = _axis_sizes(mesh)[axis]
    out = {}
    for name, shape in _named_shapes(model):
        _, perm, _ = flax_leaf(name, shape)
        flax = [shape[d] for d in perm]
        out[name] = None
        if flax and math.prod(flax) >= min_size:
            for i in sorted(range(len(flax)), key=lambda i: -flax[i]):
                if flax[i] % n == 0:
                    out[name] = perm[i]
                    break
    return out


def _state_shardings(model, mesh, tp_min_dim: int, fsdp: bool,
                     fsdp_min_size: int) -> tuple:
    """The JAX ladder: FSDP over 'data', else TP over 'model', else
    replicated. Returns ``(axis, {name: dim or None})``, axis None for the
    replicated layout."""
    if mesh is not None and fsdp:
        return "data", param_shardings_fsdp(model, mesh,
                                            min_size=fsdp_min_size)
    if mesh is not None and "model" in (mesh.mesh_dim_names or ()):
        return "model", param_shardings(model, mesh, tp_min_dim)
    return None, {}


class ColumnParallel:
    """A Dense whose weight holds this rank's rows of the output (the
    output's columns), set on the layer as ``column_parallel``. On a
    replicated input the output columns are gathered over the model group
    (the input's gradient summed there); inside an SP region, whose input
    rows are this rank's slice, the weight is gathered instead (its
    gradient reduce-scattered). The bias is whole either way."""

    def __init__(self, group):
        self.group = group

    def __call__(self, layer, x: torch.Tensor, dt: torch.dtype
                 ) -> torch.Tensor:
        bias = None if layer.bias is None else layer.bias.to(dt)
        if sp.current_region() is not None:
            w = cc.gather_shards(layer.weight, 0, self.group)
            return F.linear(x, w.to(dt), bias)
        y = F.linear(cc.copy_to_group(x, self.group), layer.weight.to(dt))
        y = cc.gather_last(y, self.group)
        return y if bias is None else y + bias


class _GatherFlat(torch.autograd.Function):
    """Every sharded parameter whole, in one all-gather of the shards laid
    end to end; the gradients reduce-scattered in one collective and
    multiplied by ``scale``."""

    @staticmethod
    def forward(ctx, dims, group, scale, *shards):
        n = cc.group_size(group)
        ctx.dims, ctx.group, ctx.scale = dims, group, scale
        ctx.shapes = [s.shape for s in shards]
        flat = torch.cat([s.movedim(d, 0).reshape(-1)
                          for s, d in zip(shards, dims)])
        rows = cc.all_gather_cat(flat[None], 0, group)      # [n, total]
        fulls, off = [], 0
        for s, d in zip(shards, dims):
            moved = s.movedim(d, 0).shape
            part = rows[:, off:off + s.numel()].reshape((n,) + moved)
            fulls.append(part.reshape((n * moved[0],) + moved[1:])
                         .movedim(0, d).contiguous())
            off += s.numel()
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        n = cc.group_size(ctx.group)
        # rank r's chunk of every gradient, end to end, in row r
        cols = [g.movedim(d, 0).reshape((n, -1))
                for g, d in zip(grads, ctx.dims)]
        flat = cc.reduce_scatter_dim(torch.cat(cols, 1), 0, ctx.group)[0]
        if ctx.scale != 1.0:
            flat = flat * ctx.scale
        out, off = [], 0
        for shape, d in zip(ctx.shapes, ctx.dims):
            size = math.prod(shape)
            moved = list(shape)
            moved.insert(0, moved.pop(d))
            out.append(flat[off:off + size].reshape(moved).movedim(0, d))
            off += size
        return (None, None, None) + tuple(out)


class Layout:
    """How a step lays out the parameters of ``model`` on ``mesh``: the
    sharded parameters (``dims``: name -> torch dim, over ``axis``'s
    group), the column-parallel layers, and under sequence parallelism the
    replicated parameters whose gradients are summed over the model
    group. ``Layout(model, None, ...)`` is the replicated layout of the
    data-parallel launch."""

    def __init__(self, model: OcOccNetWithLoss, mesh=None,
                 tp_min_dim: int = 1024, fsdp: bool = False,
                 fsdp_min_size: int = 1 << 15,
                 sequence_parallel: bool = False):
        if sequence_parallel and (mesh is None or "model" not in
                                  (mesh.mesh_dim_names or ())):
            raise ValueError("sequence parallelism needs a 'model' mesh "
                             "axis (--tp > 1)")
        self.mesh = mesh
        self.sequence_parallel = sequence_parallel
        self.axis, dims = _state_shardings(model, mesh, tp_min_dim, fsdp,
                                           fsdp_min_size)
        self.group = (data_group(mesh) if self.axis == "data" else
                      model_group(mesh) if self.axis == "model" else None)
        self.size = cc.group_size(self.group) if self.axis else 1
        self.rank = cc.group_rank(self.group) if self.axis else 0
        self.dims = {n: d for n, d in dims.items()
                     if d is not None and self.size > 1}
        self.fsdp = self.axis == "data" and bool(self.dims)
        summed = (sequence_sharded(model.cfg)
                  if sequence_parallel and cc.group_size(model_group(mesh))
                  > 1 else ())
        self.summed = [n for n, _ in model.named_parameters()
                       if n.startswith(summed)
                       and not (self.axis == "model" and n in self.dims)]

    def shard_(self, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer | None = None) -> None:
        """Keep this rank's chunk of every sharded parameter (the same
        ``Parameter`` objects, so ``optimizer`` keeps them) and of any
        AdamW moments it already holds; mark the column-parallel
        layers."""
        mods = dict(model.named_modules())
        for name, p in model.named_parameters():
            d = self.dims.get(name)
            if d is None:
                continue
            with torch.no_grad():
                p.data = p.data.chunk(self.size, d)[self.rank].clone()
            state = optimizer.state.get(p, {}) if optimizer else {}
            for k in ("exp_avg", "exp_avg_sq"):
                if k in state:
                    state[k] = state[k].chunk(self.size, d)[self.rank].clone()
            if self.axis == "model":
                owner, _, attr = name.rpartition(".")
                layer = mods[owner]
                if not (isinstance(layer, torch.nn.Linear)
                        and attr == "weight"):
                    raise ValueError(f"tensor parallelism shards {name}, "
                                     f"which is not a Dense weight")
                layer.column_parallel = ColumnParallel(self.group)

    @contextlib.contextmanager
    def running(self, model: torch.nn.Module):
        """The step's scope: the mesh current, sequence parallelism set,
        and under FSDP the whole parameters read in place of the shards
        (the ``Parameter`` objects stay registered; the gathered tensors
        shadow them as instance attributes)."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(use_mesh(self.mesh))
            if self.sequence_parallel:
                sp.set_sequence_parallel(self.mesh, "model")
                stack.callback(sp.clear_sequence_parallel)
            if self.fsdp:
                stack.enter_context(self._gathered(model))
            yield

    @contextlib.contextmanager
    def _gathered(self, model):
        mods = dict(model.named_modules())
        owners, shards, dims = [], [], []
        for name, p in model.named_parameters():
            if name in self.dims:
                owner, _, attr = name.rpartition(".")
                owners.append((mods[owner], attr))
                shards.append(p)
                dims.append(self.dims[name])
        fulls = _GatherFlat.apply(tuple(dims), self.group, 1.0 / self.size,
                                  *shards)
        try:
            for (mod, attr), full in zip(owners, fulls):
                object.__setattr__(mod, attr, full)
            yield
        finally:
            for mod, attr in owners:
                mod.__dict__.pop(attr, None)

    def reduce_grads(self, model: torch.nn.Module) -> None:
        """After the backward: under FSDP the replicated parameters'
        gradients averaged over the data group (one all-reduce); under SP
        those of ``summed`` summed over the model group (one all-reduce).
        DDP has averaged everything else over the data group, FSDP's
        gather reduce-scattered its shards."""
        named = dict(model.named_parameters())
        if self.fsdp:
            cc.all_reduce_coalesced_(
                [p.grad for n, p in named.items()
                 if n not in self.dims and p.grad is not None],
                self.group, 1.0 / self.size)
        if self.summed:
            cc.all_reduce_coalesced_(
                [named[n].grad for n in self.summed
                 if named[n].grad is not None], model_group(self.mesh))

    def split(self, model: torch.nn.Module, params) -> tuple[list, list]:
        """``params`` as (replicated, sharded) lists."""
        sharded = {id(p) for n, p in model.named_parameters()
                   if n in self.dims}
        return ([p for p in params if id(p) not in sharded],
                [p for p in params if id(p) in sharded])

    def full_state(self, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer) -> tuple[dict, dict]:
        """The model's and the optimizer's state dicts with every shard
        gathered whole: the one-process run's format, which any process
        count restores. Every rank of the layout calls it."""
        sd = dict(model.state_dict())
        for name, d in self.dims.items():
            sd[name] = cc.all_gather_cat(sd[name], d, self.group)
        osd = optimizer.state_dict()
        names = {id(p): n for n, p in model.named_parameters()}
        order = [p for g in optimizer.param_groups for p in g["params"]]
        state = dict(osd["state"])
        for i, p in enumerate(order):
            d = self.dims.get(names[id(p)])
            if d is None or i not in state:
                continue
            state[i] = {k: (cc.all_gather_cat(v, d, self.group)
                            if k in ("exp_avg", "exp_avg_sq") else v)
                        for k, v in state[i].items()}
        return sd, {**osd, "state": state}


def wrap_ddp(model: torch.nn.Module, find_unused_parameters: bool = False,
             process_group=None) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` over ``process_group``
    (default: the world) where a process group is up (of any size: one
    rank runs DDP's reducer too), else ``model`` itself. Its buffers are
    constants of the config and are not broadcast; the parameters are
    broadcast from the group's first rank once."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    return DistributedDataParallel(
        model, broadcast_buffers=False, process_group=process_group,
        find_unused_parameters=find_unused_parameters)


def mean_over_ranks(metrics: dict, keys) -> dict:
    """``metrics`` with the entries of ``keys`` replaced by their mean over
    the data axis's ranks (one all-reduce); the identity with one."""
    keys = [k for k in keys if k in metrics]
    if data_size() == 1 or not keys:
        return metrics
    vals = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=data_group())
    vals = vals / data_size()
    return {**metrics, **{k: vals[i] for i, k in enumerate(keys)}}


def make_train_step(model: OcOccNetWithLoss,
                    optimizer: torch.optim.Optimizer | BufferAdamW,
                    schedule: Callable[[int], float], seed: int = 0,
                    mesh=None, tp_min_dim: int = 1024, fsdp: bool = False,
                    fsdp_min_size: int = 1 << 15,
                    sequence_parallel: bool = False, flat_opt: bool = False,
                    stacked_spec: StackedOptSpec | None = None):
    """``step_fn(step, batch) -> metrics``: one training step on ``batch``
    (moved to the model's device; under data parallelism the data rank's
    slice of the global batch). The metrics are the loss dict and
    ``grad_norm``, 0-d tensors on the device (reading them synchronises),
    the global batch's under data parallelism. Under ``fixed_ae`` the clip,
    as in the JAX package, sees the trained parameters' gradients only, and
    ``grad_norm`` all of them.

    ``mesh`` lays the model out (:class:`Layout`: TP with ``tp_min_dim``,
    FSDP with ``fsdp_min_size``, ``sequence_parallel``); this shards
    ``model`` and ``optimizer`` in place. ``step_fn.layout`` gathers whole
    state dicts for a checkpoint.

    ``flat_opt`` / ``stacked_spec``: ``optimizer`` is the flat or stacked
    one of ``create_train_state``, whose buffers the gradients accumulate
    into; ``grad_norm`` is their global norm. Both refuse a TP or FSDP
    layout (per-parameter moments), as the JAX package does."""
    cfg = model.cfg
    device = model.code_weights.device
    buffered = flat_opt or stacked_spec is not None
    if buffered:
        if fsdp or "model" in (getattr(mesh, "mesh_dim_names", None) or ()):
            raise ValueError(
                "flat_opt / stacked_opt serve the replicated layout only "
                "(one process or data parallelism): TP and FSDP shard "
                "per-parameter moments; use the tree optimizer")
        keys = ({"decay", "nodecay"} if stacked_spec is None
                else set(stacked_spec.groups))
        if not isinstance(optimizer, BufferAdamW) or \
                set(optimizer.params) != keys:
            raise ValueError("flat_opt / stacked_spec take the optimizer of "
                             "create_train_state(flat_opt=True / "
                             "stacked_opt=True)")
    elif isinstance(optimizer, BufferAdamW):
        raise ValueError("a flat or stacked optimizer needs "
                         "make_train_step(flat_opt=True / stacked_spec=)")
    layout = Layout(model, mesh, tp_min_dim, fsdp, fsdp_min_size,
                    sequence_parallel)
    if not buffered:
        layout.shard_(model, optimizer)
        trained = [p for group in optimizer.param_groups
                   for p in group["params"]]
        params = list(model.parameters())
        frozen = len(trained) != len(params)
        trained, trained_sharded = layout.split(model, trained)
        every, every_sharded = layout.split(model, params)
    loss_fn = model if layout.fsdp else wrap_ddp(
        model, process_group=data_group(mesh))
    shard = data_rank(mesh)
    # [seed, step]: the dropout keys' base, updated in place on the device
    base = torch.tensor([seed, 0], dtype=torch.int64, device=device)

    def step_fn(step: int, batch: TrackletBatch) -> dict:
        batch = batch.to(device)
        base[1].fill_(step)
        if buffered:
            optimizer.zero_grad()
        else:
            set_lr(optimizer, schedule(step))
            model.zero_grad(set_to_none=True)
        with layout.running(model):
            total, aux = loss_fn(batch, train=True,
                                 keys=DropoutKeys(base, rank=shard))
            total.backward()
            layout.reduce_grads(model)
            aux = mean_over_ranks({k: v.detach() for k, v in aux.items()},
                                  [k for k in aux if k.startswith("loss")])
            if buffered:
                return {**aux, "grad_norm": optimizer.step(schedule(step))}
            norm_all = (global_norm(
                [p.grad for p in every if p.grad is not None],
                [p.grad for p in every_sharded if p.grad is not None],
                layout.group) if frozen else None)
            norm = clip_grad_global_norm_(trained, cfg.grad_clip_norm,
                                          trained_sharded, layout.group)
        optimizer.step()
        return {**aux, "grad_norm": norm if norm_all is None else norm_all}

    step_fn.layout = layout
    return step_fn


def make_train_multi_step(model: OcOccNetWithLoss,
                          optimizer: torch.optim.Optimizer,
                          schedule: Callable[[int], float], seed: int = 0,
                          mesh=None, tp_min_dim: int = 1024,
                          fsdp: bool = False, fsdp_min_size: int = 1 << 15,
                          sequence_parallel: bool = False):
    """``multi_fn(step, batches) -> metrics``: ``K`` steps from ``step`` on
    a batch whose every tensor carries a leading ``[K]`` axis (``[K, B,
    ...]``), each metric stacked ``[K]``. The JAX package scans the step
    in one program to save the TPU's dispatches; here it is a loop over
    :func:`make_train_step`'s step on the same layout, whose dropout
    counter follows the step (step ``step + k`` of the loop draws the
    masks of a lone step there)."""
    step_fn = make_train_step(model, optimizer, schedule, seed, mesh,
                              tp_min_dim, fsdp, fsdp_min_size,
                              sequence_parallel)

    def multi_fn(step: int, batches: TrackletBatch) -> dict:
        rows = [step_fn(step + k, TrackletBatch(*(x[k] for x in batches)))
                for k in range(batches.points.shape[0])]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    multi_fn.layout = step_fn.layout
    return multi_fn


def shard_batch(batch: TrackletBatch, mesh=None,
                scan_axis: bool = False) -> TrackletBatch:
    """This data rank's contiguous slice of a global batch (along the
    second dim with ``scan_axis``, the ``[K, B, ...]`` batches of
    :func:`make_train_multi_step`); the model ranks of one data rank get
    the same slice."""
    dim = 1 if scan_axis else 0
    n, r = data_size(mesh), data_rank(mesh)
    per = batch.points.shape[dim] // n
    return TrackletBatch(*(x.narrow(dim, r * per, per) for x in batch))
