"""One rank of the port's model-parallel runs on the CPU (gloo), for
``tests/test_torch_model_parallel.py``:

    python tests/torch_mp_worker.py RANK WORLD PORT OUT

joins ``WORLD`` processes at ``127.0.0.1:PORT`` and, for each case of
``CASES`` in turn, on the case's data x model mesh, runs one training step
of the packed tiny config from the seeded init on its data rank's slice of
the global batch, with dropout and without; writes ``OUT/rank{RANK}.pt``:
per case and dropout setting the metrics, the parameters and the clipped
gradients gathered whole, and the shapes of this rank's parameter and
moment shards. Imports no JAX.
"""
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from objectcentricocccompletion_torch.parallel import collectives as cc  # noqa: E402,E501
from objectcentricocccompletion_torch.parallel import multihost, sp  # noqa: E402,E501
from objectcentricocccompletion_torch.parallel.train import (  # noqa: E402
    create_train_state, make_mesh_2d, make_train_step, shard_batch)
from tests import torch_ddp_worker as ddp  # noqa: E402

# (mesh shape, make_train_step options) of each case
CASES = {
    "tp_sp": ((1, 2), dict(tp_min_dim=32, sequence_parallel=True)),
    "fsdp": ((2, 1), dict(fsdp=True, fsdp_min_size=256)),
}


def packed_case(dropout: bool = True):
    """``torch_ddp_worker.ococc_case`` on the packed layout that the JAX
    package's sequence-parallel test uses (budget 64, quantum 2: 32 blocks
    of 2 points)."""
    cfg, batch = ddp.ococc_case(dropout)
    return dataclasses.replace(cfg, packed_point_budget=64,
                               packed_quantum=2), batch


def mp_step(cfg, batch, mesh=None, **layout_kw) -> dict:
    """One step of the tiny model (seed 0) on ``batch`` (this data rank's
    slice where ``mesh`` is given) under ``layout_kw``: its metrics, the
    parameters after it and the clipped gradients, gathered whole, the
    shapes of this rank's parameter and moment shards, the checkpoint's
    whole state (``Layout.full_state``: the parameters, each moment's
    shape by name), whether a model restored from that state and laid out
    again holds this rank's shards, and whether the SP setting outlived
    the step."""
    model, optimizer, schedule = create_train_state(cfg, 10, "cpu", seed=0)
    step = make_train_step(model, optimizer, schedule, seed=1, mesh=mesh,
                           **layout_kw)
    metrics = step(0, batch if mesh is None else shard_batch(batch, mesh))
    layout = step.layout

    def whole(name, t):
        d = layout.dims.get(name)
        return t if d is None else cc.all_gather_cat(t, d, layout.group)

    named = dict(model.named_parameters())
    sd, osd = layout.full_state(model, optimizer)
    order = [n for g in optimizer.param_groups for p in g["params"]
             for n, q in named.items() if q is p]
    # a resumed run: the whole state restored, then laid out again
    again, opt_again, schedule = create_train_state(cfg, 10, "cpu", seed=5)
    again.load_state_dict(sd)
    opt_again.load_state_dict(osd)
    make_train_step(again, opt_again, schedule, seed=1, mesh=mesh,
                    **layout_kw)
    resumed = all(
        torch.equal(p, q) and all(torch.equal(optimizer.state[p][k],
                                              opt_again.state[q][k])
                                  for k in ("exp_avg", "exp_avg_sq"))
        for p, q in zip(model.parameters(), again.parameters()))
    return dict(
        resumed_shards_equal=resumed,
        checkpoint=dict(params=sd, moments={
            order[i]: tuple(st["exp_avg"].shape)
            for i, st in osd["state"].items()}),
        metrics={k: float(v) for k, v in metrics.items()},
        params={n: whole(n, p.detach()).clone() for n, p in named.items()},
        grads={n: whole(n, p.grad).clone() for n, p in named.items()},
        shards={n: tuple(p.shape) for n, p in named.items()},
        moments={n: tuple(optimizer.state[p]["exp_avg"].shape)
                 for n, p in named.items() if p in optimizer.state},
        dims=dict(layout.dims),
        sp_after_step=sp.sequence_parallel_enabled())


def main(rank, world, port, out):
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, "gloo", "cpu")
    res = {}
    try:
        for case, (shape, layout_kw) in CASES.items():
            mesh = make_mesh_2d(*shape, device_type="cpu")
            res[case] = {dropout: mp_step(*packed_case(dropout), mesh,
                                          **layout_kw)
                         for dropout in (True, False)}
    finally:
        multihost.shutdown()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(*map(int, sys.argv[1:4]), sys.argv[4])
