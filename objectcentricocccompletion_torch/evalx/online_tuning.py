"""Online test-time tuning of the shape latent (counterpart of the JAX
package's ``evalx/online_tuning.py``): at inference each RoI's latent is
fitted by Adam to the *observed* occupancy (voxel centres holding pooled
points are occupied, the rest of the sampled grid free), all RoIs at once.

The gradient is taken with respect to the latent alone; the decoder runs
without dropout and its parameters get no gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import roi_pool as rp

# optax.adam's constants
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


def _bias_correction(decay: float, t: int) -> float:
    # optax forms 1 - decay ** t in float32
    return float(np.float32(1) - np.float32(decay) ** np.float32(t))


def observation_targets(local_xyz: torch.Tensor, pool_mask: torch.Tensor,
                        roi_sizes: torch.Tensor, voxel_size: float,
                        queries: torch.Tensor) -> torch.Tensor:
    """Observed-occupancy labels (float32 0 / 1) for ``queries`` [L, K, 3]:
    1 where the query's voxel holds at least one pooled point.

    local_xyz / pool_mask: [L, P(, 3)] box-local pooled points; roi_sizes:
    [L, 3]. A query is occupied iff some point snaps to the same voxel
    centre (``[L, K, P]`` comparisons, no dense grid)."""
    pt_centers = rp.quantize_to_voxel_centers(local_xyz, roi_sizes,
                                              voxel_size)   # [L, P, 3]
    q_centers = rp.quantize_to_voxel_centers(queries, roi_sizes, voxel_size)
    same = ((q_centers[:, :, None, :] - pt_centers[:, None, :, :]).abs()
            < voxel_size * 0.5).all(-1)                     # [L, K, P]
    return (same & pool_mask[:, None, :]).any(-1).float()


def tune_latent(decode_fn, latent: torch.Tensor, queries: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor, num_iters: int = 10,
                lr: float = 0.01) -> torch.Tensor:
    """``num_iters`` Adam steps (optax's ``adam(lr)``) on ``latent`` [L, D]
    so that ``decode_fn(latent, queries)`` fits ``labels`` [L, K] (the BCE
    over the samples that ``mask`` selects). Returns the tuned latent,
    detached."""
    lat = latent.detach().float().clone()
    m = torch.zeros_like(lat)
    v = torch.zeros_like(lat)
    den = mask.sum().clamp(min=1.0)
    for t in range(1, num_iters + 1):
        with torch.enable_grad():
            x = lat.requires_grad_(True)
            logits = decode_fn(x, queries)
            bce = (logits.clamp(min=0) - logits * labels
                   + torch.log1p(torch.exp(-logits.abs())))
            loss = (bce * mask).sum() / den
            (g,) = torch.autograd.grad(loss, x)
        lat = lat.detach()
        m = (1 - ADAM_B1) * g + ADAM_B1 * m
        v = (1 - ADAM_B2) * g * g + ADAM_B2 * v
        m_hat = m / _bias_correction(ADAM_B1, t)
        v_hat = v / _bias_correction(ADAM_B2, t)
        lat = lat - lr * (m_hat / (torch.sqrt(v_hat + ADAM_EPS_ROOT)
                                   + ADAM_EPS))
    return lat
