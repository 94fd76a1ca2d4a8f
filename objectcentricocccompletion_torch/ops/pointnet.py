"""PointNet++ primitives on masked fixed-size point buffers (counterpart of
the JAX package's ``ops/pointnet.py``): squared distances, k nearest
neighbours, ball query, furthest point sampling, gathers and grouping,
inverse-distance 3-NN interpolation and PAConv's score assembly.

Each choice is made as the JAX package makes it. Distances are the
broadcast difference squared and summed over x, y, z (never the
``|a|^2 + |b|^2 - 2ab`` expansion, which rounds otherwise); the ``k``
nearest are the first ``k`` of a stable ascending sort, so that equal
distances (every masked point sits at 1e10) go in index order as
``lax.top_k`` puts them; ``argmax`` takes the first maximum.

The picks (furthest-point samples, nearest-neighbour indices, ball
memberships) are discrete: inputs within a rounding step of a tie pick
otherwise on another device. Where an ``ops/routes.py::Routes`` is active
each pick goes through it, whatever takes a gradient: ``with Routes() as
r:`` records one run's picks among its routes, ``with Routes(masks):``
feeds them to another run, which counts in ``flips`` the elements where
its own pick differs. No gradient flows through a pick.
"""
from __future__ import annotations

import torch

from .routes import Routes

_BIG = 1e10


def _pick(kind: str, own: torch.Tensor) -> torch.Tensor:
    routes = Routes.active
    return own if routes is None else routes.take(kind, own)


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 3] x [M, 3] -> [N, M] squared euclidean distances."""
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def knn(query: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
        k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest valid points of each query: (idx [Q, k] int64,
    dist [Q, k]); masked points sit at distance 1e10, so a query with
    fewer than ``k`` valid points gets the masked ones in index order."""
    d = torch.where(points_mask[None, :], square_distance(query, points),
                    _BIG)
    with torch.no_grad():
        idx = _pick("knn", torch.sort(d.detach(), dim=-1,
                                      stable=True)[1][:, :k])
    return idx, torch.gather(d, 1, idx)


def ball_query(query: torch.Tensor, points: torch.Tensor,
               points_mask: torch.Tensor, radius: float, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` points within ``radius`` of each query, padded with the
    nearest one (the CUDA ``ball_query``'s rule): (idx [Q, k], valid
    [Q, k])."""
    idx, dist = knn(query, points, points_mask, k)
    with torch.no_grad():
        ok = _pick("ball", dist.detach() <= radius * radius)
    return torch.where(ok, idx, idx[:, 0:1]), ok


def furthest_point_sample(points: torch.Tensor, mask: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """Iterative furthest point sampling from the first valid point:
    [num_samples] int64 indices (the first valid point repeats where fewer
    points are valid than samples). One step per sample, each 6 launches
    and no synchronisation: a sequential loop on the host."""
    with torch.no_grad():
        pts = torch.where(mask[:, None], points.detach(), 0.0)
        start = torch.argmax(mask.to(torch.uint8))
        # a masked point stays at -1e10: min(-1e10, d) for any d >= 0
        dist = torch.where(mask, _BIG, -_BIG).to(pts.dtype)
        last, out = start, [start]
        for _ in range(num_samples - 1):
            # a one-element index: a 0-d one would read it to the host
            d = ((pts - pts.index_select(0, last.view(1))) ** 2).sum(-1)
            dist = torch.minimum(dist, d)
            last = torch.argmax(dist)
            out.append(last)
        return _pick("fps", torch.stack(out))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, C] gathered at [..., K] -> [..., K, C]."""
    return points[idx]


def group_points(points: torch.Tensor, idx: torch.Tensor,
                 centers: torch.Tensor | None = None) -> torch.Tensor:
    """[N, C] features grouped as [Q, k, C]; with ``centers`` the xyz
    channels are taken relative to each query's centre."""
    g = points[idx]
    if centers is None:
        return g
    return torch.cat([g[..., :3] - centers[:, None, :3], g[..., 3:]], -1)


def three_interpolate(query: torch.Tensor, points: torch.Tensor,
                      points_mask: torch.Tensor, feats: torch.Tensor
                      ) -> torch.Tensor:
    """Inverse-distance-weighted features of each query's 3 nearest valid
    points."""
    idx, dist = knn(query, points, points_mask, 3)
    w = 1.0 / dist.clamp(min=1e-8)
    w = w / w.sum(-1, keepdim=True)
    return (feats[idx] * w[..., None]).sum(1)


def assign_score_withk(scores: torch.Tensor, point_feats: torch.Tensor,
                       center_feats: torch.Tensor, knn_idx: torch.Tensor,
                       aggregate: str = "sum") -> torch.Tensor:
    """PAConv's score-weighted kernel assembly: scores [Q, k, M] mix the
    weight bank's outputs of each neighbour less those of the centre
    (``knn_idx[:, 0]``), point_feats / center_feats [N, M, C] ->
    [Q, k, C], reduced over k by ``aggregate`` (``sum``, ``avg`` or
    ``max``) to [Q, C]; any other value keeps k."""
    diff = point_feats[knn_idx] - center_feats[knn_idx[:, :1]]
    mixed = torch.einsum("qkm,qkmc->qkc", scores, diff)
    if aggregate == "sum":
        return mixed.sum(1)
    if aggregate == "avg":
        return mixed.mean(1)
    if aggregate == "max":
        return mixed.amax(1)
    return mixed
