"""The benchmark's yardstick: the card's peaks, the attention kernels'
least time, and the operations each configuration's work needs.

FLOPs are 2 per multiply-add of the matrix products, convolutions and
attention products; norms, activations, gathers and the losses are not
counted. Only the work the inputs need is counted: OcOccNet's pooled points
that the packed budget keeps, the real frames of each tracklet and its
occupancy queries; SST's points in kept voxels, the tokens of each window
and the whole BEV grid of the neck. A training step counts three forwards.
"""
from __future__ import annotations

import torch

# H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s, and float32 products at
# float32 accuracy: three TF32 products (3xTF32) at 494.7 TFLOP/s, the
# fastest way to float32 accuracy on the card (the CUDA cores' float32 rate
# is 67 TFLOP/s)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3}


def attention_bound_ms(mask: torch.Tensor, C: int, dtype: torch.dtype,
                       backward: bool = False) -> tuple[float, str]:
    """The least time for the bytes the attention must move and its
    products, on this ``[W, T]`` token mask. Every window reads the mask;
    the forward reads v and writes out, the backward reads g and writes
    dq, dk and dv; only a window with a valid key needs q and k (forward)
    or q, k and v (backward) and has products: 2 (forward) or 5 (backward)
    of 2*T^2*hd per head. Returns (ms, "bytes" or "operations")."""
    W, T = mask.shape
    live = int(mask.any(1).sum())
    row_bytes = T * C * torch.finfo(dtype).bits // 8
    if backward:
        nbytes, flops = (4 * W + 3 * live) * row_bytes, 10 * live * T * T * C
    else:
        nbytes, flops = (2 * W + 2 * live) * row_bytes, 4 * live * T * T * C
    t_bytes = (nbytes + W * T) / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mlp_flops(dims) -> int:
    """FLOPs per row of a chain of dense layers ``dims[0] -> ... ->
    dims[-1]``."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def sir_flops_per_point(feat_dim: int, rel_dim: int, cfg: dict,
                        geo_input: bool) -> int:
    """One SIR encoder's FLOPs per point: per block the ``rel_mlp`` gate
    and the VFE layers (the second reads the first's output and its
    broadcast group max)."""
    ch = list(cfg["feat_channels"])
    total, width = 0, feat_dim
    for _ in range(cfg["num_blocks"]):
        in_dim = 3 + width + (rel_dim if geo_input else 0)
        total += mlp_flops([rel_dim, *cfg["rel_mlp_hidden"], in_dim])
        fin = in_dim
        for c in ch:
            total += 2 * fin * c
            fin = 2 * c
        width = ch[-1]
    return total


def ococcnet_flops(cfg: dict, kept_points: int, frame_lengths,
                   queries_per_frame: int) -> int:
    """One OcOccNet forward plus the occupancy decode over tracklets of
    ``frame_lengths`` real frames holding ``kept_points`` pooled points
    that the budget keeps, ``queries_per_frame`` queries each."""
    D = cfg["d_model"]
    roi_dim = cfg["num_blocks"] * sum(cfg["feat_channels"])
    per_point = (sir_flops_per_point(cfg["num_point_feats"] + 1, 13, cfg,
                                     True)
                 + sir_flops_per_point(12, 3, cfg, False))
    per_frame = (
        mlp_flops([7, *cfg["roi_pos_enc_mlp"], D])
        + cfg["num_enc_layers"] * (4 * 2 * D * D
                                   + mlp_flops([D, cfg["attn_ffn_dim"], D]))
        + mlp_flops([roi_dim + D, *cfg["latent_mlp"], D])
        + mlp_flops([D + roi_dim, *cfg["fusion_mlp"], D])
        + mlp_flops([D, *cfg["cls_mlp"], 1])
        + mlp_flops([D, *cfg["reg_mlp"], 7])
        + 2 * D * cfg["occ_mlp"][0])
    enc = 2 * 3 * cfg["pos_encode_freqs"]
    per_query = mlp_flops([enc, cfg["occ_mlp"][0]]) + mlp_flops(
        [*cfg["occ_mlp"], 1])
    frames = sum(frame_lengths)
    # causal attention: L (L + 1) / 2 query-key pairs, QK^T and PV
    attn = sum(cfg["num_enc_layers"] * 2 * 2 * D * T * (T + 1) // 2
               for T in frame_lengths)
    return (kept_points * per_point + frames * per_frame + attn
            + frames * queries_per_frame * per_query)


def sst_flops(cfg: dict, points: int, voxels: int, window_tokens,
              grid: tuple[int, int]) -> int:
    """One SST detector forward: the VFE over ``points`` (the points in
    kept voxels), the input projection over ``voxels``, per layer the
    projections and FFN over its windows' tokens and the attention over
    each window's token pairs (``window_tokens``: per layer, the token
    counts of its live windows), the neck and the head over the BEV grid."""
    s = cfg["sst"]
    C = s["d_model"]
    vfe, fin = 0, s["point_dim"] + 6
    for i, c in enumerate(s["vfe_channels"]):
        vfe += 2 * fin * c
        fin = 2 * c
    total = points * vfe + voxels * 2 * s["vfe_channels"][-1] * C
    for counts in window_tokens:
        n = sum(counts)
        total += n * (4 * 2 * C * C + mlp_flops([C, s["ffn_dim"], C]))
        total += sum(2 * 2 * C * t * t for t in counts)
    gx, gy = grid
    chans = [C] + [cfg["neck_channels"]] * 3
    for a, b in zip(chans[:-1], chans[1:]):
        total += 2 * 9 * a * b * gx * gy
    n_anchor = len(cfg["anchors"]["sizes"]) * len(cfg["anchors"]["rotations"])
    total += 2 * cfg["neck_channels"] * n_anchor * (
        cfg["num_classes"] + 7 + 2) * gx * gy
    return total
