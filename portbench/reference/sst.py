"""Plain PyTorch reference of the SST single-stage detector (single-stride
sparse transformer, dilated-convolution neck, anchor head): from a LiDAR
frame to every anchor's decoded box and score.

Float32 with TF32 off. Voxels, windows and levels are worked out again
from the points: the occupied pillars in key order, the first
``max_voxels`` kept; per shift the windows in key order, the first
``max_windows`` kept, each window's first ``capacity`` voxels in slot
order; windows of at most ``small_capacity`` tokens on the small level,
the rest on the large one, each within its budget. Attention is plain
softmax attention over each live window's valid tokens. Nothing here
imports the port or JAX; parameters are a dict under the port's state-dict
names (``param_specs``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

NECK_DILATIONS = (1, 1, 2)


def param_specs(cfg: dict) -> list:
    """Every parameter of ``SSTDetector``: ``(name, shape, kind, fan_in)``."""
    s = cfg["sst"]
    C, fc = s["d_model"], s["ffn_dim"]
    out = []

    def lin(name, fin, fout, bias=True):
        out.append((f"{name}.weight", (fout, fin), "w", fin))
        if bias:
            out.append((f"{name}.bias", (fout,), "zeros", 0))

    def norm(name, c):
        out.extend([(f"{name}.weight", (c,), "ones", 0),
                    (f"{name}.bias", (c,), "zeros", 0)])

    fin = s["point_dim"] + 6
    for i, c in enumerate(s["vfe_channels"]):
        lin(f"backbone.vfe.vfe_{i}", fin, c, False)
        norm(f"backbone.vfe.norm_{i}", c)
        fin = 2 * c
    lin("backbone.input_proj", s["vfe_channels"][-1], C)
    for i in range(2 * s["num_blocks"]):
        b = f"backbone.layers.{i}"
        for n in ("q", "k", "v", "out"):
            lin(f"{b}.{n}", C, C)
        norm(f"{b}.norm1", C)
        lin(f"{b}.ffn1", C, fc)
        lin(f"{b}.ffn2", fc, C)
        norm(f"{b}.norm2", C)
    cin, N = C, cfg["neck_channels"]
    for i in range(len(NECK_DILATIONS)):
        out.append((f"neck_convs.{i}.weight", (N, cin, 3, 3), "w", 9 * cin))
        norm(f"neck_norms.{i}", N)
        cin = N
    a = cfg["anchors"]
    n = len(a["sizes"]) * len(a["rotations"])
    for name, k in (("cls", cfg["num_classes"]), ("reg", 7), ("dir", 2)):
        out.append((f"head.{name}.weight", (n * k, N, 1, 1), "w", N))
        out.append((f"head.{name}.bias", (n * k,), "zeros", 0))
    return out


def grid_shape(s: dict) -> tuple:
    return tuple(int(g) for g in np.round(
        (np.asarray(s["pc_range"][3:]) - np.asarray(s["pc_range"][:3]))
        / np.asarray(s["voxel_size"])))


# --------------------------------------------------------------- voxels

def voxelize(points: torch.Tensor, mask: torch.Tensor, s: dict) -> dict:
    """The kept pillars: their coords ``[V, 3]`` (x, y, z), and each
    point's pillar (``p2v``, -1 where the point is out of range, masked
    out or in a pillar past ``max_voxels``). A point's cell is
    ``floor((p - lo) * (1 / voxel_size))`` in float32, clamped to the
    grid; pillars are numbered in the order of their linear key."""
    dev = points.device
    vs = torch.tensor(s["voxel_size"], dtype=torch.float32, device=dev)
    lo = torch.tensor(s["pc_range"][:3], dtype=torch.float32, device=dev)
    hi = torch.tensor(s["pc_range"][3:], dtype=torch.float32, device=dev)
    xyz = points[:, :3]
    grid = torch.floor((hi - lo) / vs).long()
    cell = torch.minimum(torch.floor((xyz - lo) * (1.0 / vs)).long()
                         .clamp(min=0), grid - 1)
    valid = mask & ((xyz >= lo) & (xyz < hi)).all(-1)
    key = (cell[:, 0] * grid[1] + cell[:, 1]) * grid[2] + cell[:, 2]
    kept = torch.unique(key[valid])[:s["max_voxels"]]
    slot = torch.searchsorted(kept, key).clamp(max=max(len(kept) - 1, 0))
    found = valid & (kept[slot] == key) if len(kept) else valid & False
    coords = torch.stack([kept // (grid[1] * grid[2]),
                          (kept // grid[2]) % grid[1], kept % grid[2]], -1)
    return dict(coords=coords, p2v=torch.where(found, slot, -1),
                valid=valid)


def vfe(p: dict, s: dict, points: torch.Tensor, vox: dict) -> torch.Tensor:
    """Per pillar: the points decorated with their offsets to the pillar's
    point mean and centre, then Dense -> LayerNorm -> ReLU layers with the
    pillar max concatenated between them; the last layer's pillar max."""
    V = len(vox["coords"])
    inside = vox["p2v"] >= 0
    pts, v = points[inside], vox["p2v"][inside]
    xyz = pts[:, :3]
    cnt = torch.bincount(v, minlength=V).clamp(min=1)[:, None].float()
    mean = torch.zeros(V, 3, device=pts.device).index_add_(0, v, xyz) / cnt
    vs = torch.tensor(s["voxel_size"], device=pts.device)
    lo = torch.tensor(s["pc_range"][:3], device=pts.device)
    center = (vox["coords"].float() + 0.5) * vs + lo
    x = torch.cat([pts, xyz - mean[v], xyz - center[v]], -1)
    n = len(s["vfe_channels"])
    for i in range(n):
        x = torch.relu(F.layer_norm(
            F.linear(x, p[f"backbone.vfe.vfe_{i}.weight"]),
            (s["vfe_channels"][i],), p[f"backbone.vfe.norm_{i}.weight"],
            p[f"backbone.vfe.norm_{i}.bias"], 1e-3))
        g = torch.full((V, x.shape[1]), float("-inf"), device=x.device)
        g = g.scatter_reduce(0, v[:, None].expand_as(x), x, "amax")
        if i != n - 1:
            x = torch.cat([x, g[v]], -1)
    return g


# -------------------------------------------------------------- windows

def windows(coords: torch.Tensor, s: dict, shifted: bool) -> dict:
    """One shift's partition of the pillars into windows and levels: per
    level the pillars' window slot and rank (``slot``, ``rank``, -1 off
    the level), and every pillar's in-window position ``inwin``."""
    grid = grid_shape(s)
    w = s["window_shape"]
    n = [math.ceil(g / k) + 1 for g, k in zip(grid, w)]
    off = [k // 2 for k in w] if shifted else list(w)
    if grid[2] == w[2]:
        off[2] = 0
    dev = coords.device
    sc = coords + torch.tensor(off, device=dev)
    wt = torch.tensor(w, device=dev)
    wc = torch.div(sc, wt, rounding_mode="floor")
    key = (wc[:, 0] * n[1] + wc[:, 1]) * n[2] + wc[:, 2]
    _, win, counts = torch.unique(key, return_inverse=True,
                                  return_counts=True)
    # rank: the pillar's place among its window's pillars, in slot order
    order = torch.argsort(key, stable=True)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(win)
    rank[order] = torch.arange(len(key), device=dev) - first[win[order]]
    cap, small = int(np.prod(w)), s["small_capacity"]
    keep = (win < s["max_windows"]) & (rank < cap)
    tokens = counts.clamp(max=cap)[:s["max_windows"]]
    levels = []
    is_small = tokens <= small
    if 0 < small < cap:
        split = ((is_small, s.get("max_small_windows") or s["max_windows"],
                  small),
                 (~is_small, s.get("max_large_windows")
                  or max(s["max_windows"] // 4, 1), cap))
    else:
        split = ((torch.ones_like(is_small), s["max_windows"], cap),)
    for sel, budget, T in split:
        lslot = torch.cumsum(sel, 0) - 1
        wi = win.clamp(max=len(sel) - 1)
        on = keep & sel[wi] & (lslot[wi] < budget)
        levels.append(dict(slot=torch.where(on, lslot[wi], -1),
                           rank=torch.where(on, rank, -1), W=budget, T=T))
    return dict(levels=levels, inwin=torch.remainder(sc, wt))


def pos_embed(inwin: torch.Tensor, s: dict) -> torch.Tensor:
    """Sine embedding of the in-window (x, y) offsets from the window's
    centre: per axis sin and cos of alternate frequencies interleaved."""
    wx, wy, _ = s["window_shape"]
    half = s["d_model"] // 2
    i = np.arange(half)
    inv_freq = torch.tensor(s["pos_temperature"] ** (2 * (i // 2) / half),
                            dtype=torch.float32, device=inwin.device)

    def embed(t):
        e = t[:, None] / inv_freq
        return torch.stack([torch.sin(e[:, ::2]), torch.cos(e[:, 1::2])],
                           -1).reshape(len(t), -1)

    return torch.cat([embed(inwin[:, 0].float() - wx / 2),
                      embed(inwin[:, 1].float() - wy / 2)], -1)


def level_mask(level: dict) -> torch.Tensor:
    """The level's ``[W, T]`` token mask."""
    m = torch.zeros(level["W"], level["T"], dtype=torch.bool,
                    device=level["slot"].device)
    on = level["slot"] >= 0
    m[level["slot"][on], level["rank"][on]] = True
    return m


# -------------------------------------------------------------- layers

def attention_layer(p: dict, name: str, s: dict, x, pos, level) -> tuple:
    """One encoder layer over one level's live windows: returns the
    pillars on the level and their new features."""
    on = level["slot"] >= 0
    ids = torch.nonzero(on)[:, 0]
    if len(ids) == 0:
        return ids, x[ids]
    live, wid = torch.unique(level["slot"][ids], return_inverse=True)
    T, C, H = level["T"], s["d_model"], s["num_heads"]
    hd = C // H
    tok = x.new_zeros(len(live), T, C)
    pe = x.new_zeros(len(live), T, C)
    m = torch.zeros(len(live), T, dtype=torch.bool, device=x.device)
    r = level["rank"][ids]
    tok[wid, r], pe[wid, r], m[wid, r] = x[ids], pos[ids], True

    def lin(n, t):
        return F.linear(t, p[f"{name}.{n}.weight"], p[f"{name}.{n}.bias"])

    def ln(n, t):
        return F.layer_norm(t, (C,), p[f"{name}.{n}.weight"],
                            p[f"{name}.{n}.bias"], 1e-5)

    qk = tok + pe
    q, k, v = (t.view(len(live), T, H, hd)
               for t in (lin("q", qk), lin("k", qk), lin("v", tok)))
    logits = torch.einsum("wthd,wshd->whts", q, k) / math.sqrt(hd)
    a = torch.softmax(logits.masked_fill(~m[:, None, None, :],
                                         float("-inf")), -1)
    o = torch.einsum("whts,wshd->wthd", a, v).reshape(len(live), T, C)
    y = ln("norm1", tok + lin("out", o))
    f = lin("ffn2", F.gelu(lin("ffn1", y)))
    y = ln("norm2", y + f)
    return ids, y[wid, r]


def backbone(p: dict, s: dict, points, mask) -> tuple:
    """The BEV canvas ``[GX, GY, C]``, and the voxels and partitions."""
    vox = voxelize(points, mask, s)
    x = F.linear(vfe(p, s, points, vox), p["backbone.input_proj.weight"],
                 p["backbone.input_proj.bias"])
    parts = [windows(vox["coords"], s, sh) for sh in (False, True)]
    pos = [pos_embed(pt["inwin"], s) for pt in parts]
    for i in range(2 * s["num_blocks"]):
        sh = i % 2
        out = x.clone()
        for level in parts[sh]["levels"]:
            ids, y = attention_layer(p, f"backbone.layers.{i}", s, x,
                                     pos[sh], level)
            out[ids] = y
        x = out
    gx, gy, _ = grid_shape(s)
    canvas = x.new_zeros(gx, gy, s["d_model"])
    canvas[vox["coords"][:, 0], vox["coords"][:, 1]] = x
    return canvas, vox, parts


def generate_anchors(hw, pc_range, a: dict) -> np.ndarray:
    """``[GX * GY * sizes * rotations, 7]`` anchors at the BEV cells'
    centres, flat order (x, y, size, rotation)."""
    GX, GY = hw
    xs = np.linspace(pc_range[0], pc_range[3], GX, endpoint=False) \
        + (pc_range[3] - pc_range[0]) / GX / 2
    ys = np.linspace(pc_range[1], pc_range[4], GY, endpoint=False) \
        + (pc_range[4] - pc_range[1]) / GY / 2
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    out = []
    for size, zc in zip(a["sizes"], a["z_centers"]):
        for rot in a["rotations"]:
            b = np.zeros((GX, GY, 7), np.float32)
            b[..., 0], b[..., 1], b[..., 2] = gx, gy, zc
            b[..., 3:6], b[..., 6] = size, rot
            out.append(b.reshape(-1, 7))
    return np.stack(out, 1).reshape(-1, 7)


@torch.no_grad()
def detect(p: dict, cfg: dict, points, mask) -> dict:
    """Every anchor's score ``[A]``, decoded box ``[A, 7]``, the margin of
    its direction logits and how near its yaw lies to the decode's wrap."""
    s = cfg["sst"]
    canvas, _, _ = backbone(p, s, points, mask)
    x = canvas.permute(2, 0, 1)[None]
    for i, d in enumerate(NECK_DILATIONS):
        x = F.conv2d(x, p[f"neck_convs.{i}.weight"], None, 1, d, d)
        x = torch.relu(F.group_norm(x, 16, p[f"neck_norms.{i}.weight"],
                                    p[f"neck_norms.{i}.bias"], 1e-3))

    def head(name, k):
        y = F.conv2d(x, p[f"head.{name}.weight"], p[f"head.{name}.bias"])
        return y[0].permute(1, 2, 0).reshape(-1, k)

    cls, reg, dirl = (head("cls", cfg["num_classes"]), head("reg", 7),
                      head("dir", 2))
    a = cfg["anchors"]
    anchors = torch.from_numpy(generate_anchors(x.shape[2:], s["pc_range"],
                                                a)).to(x.device)
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = reg.unbind(-1)
    diag = torch.sqrt(la ** 2 + wa ** 2)
    hg = torch.exp(ht) * ha
    yaw = rt + ra
    turn = torch.remainder(yaw - a["dir_offset"], math.pi)
    boxes = torch.stack([xt * diag + xa, yt * diag + ya,
                         zt * ha + za + ha / 2 - hg / 2, torch.exp(wt) * wa,
                         torch.exp(lt) * la, hg,
                         turn + a["dir_offset"]
                         + math.pi * dirl.argmax(-1)], -1)
    return dict(scores=torch.sigmoid(cls).amax(-1), boxes=boxes,
                dir_margin=(dirl[:, 0] - dirl[:, 1]).abs(),
                wrap_margin=torch.minimum(turn, math.pi - turn))


def frame_work(cfg: dict, points, mask) -> dict:
    """What one frame asks of the detector, from the reference's own
    voxels and windows: the points in kept pillars, the pillars, per layer
    the token counts of its live windows, and each shift's level masks."""
    s = cfg["sst"]
    vox = voxelize(points, mask, s)
    masks, tokens = [], []
    for sh in (False, True):
        lv = [level_mask(level) for level in windows(vox["coords"], s,
                                                     sh)["levels"]]
        masks.append(lv)
        tokens.append([int(t) for m in lv for t in m.sum(1) if t > 0])
    return dict(points=int((vox["p2v"] >= 0).sum()),
                voxels=len(vox["coords"]), masks=masks,
                window_tokens=[tokens[i % 2]
                               for i in range(2 * s["num_blocks"])])


# ------------------------------------------------------------- training
#
# The training loss of one labelled frame, its gradient and the optimizer
# step, as the port states them (``models/anchor_head.py``,
# ``training/detector_trainer.py``, ``training/optim.py``), written out
# again: float32 with TF32 off, the gradient by autograd. Departures of
# that head from the published one (mmdetection3d's ``Anchor3DHead`` with
# ``MaxIoUAssigner`` in ``sst_waymoD5_1x_3class_8heads_v2.py``), kept here
# because they are the program's stated behaviour:
#
# - a GT's forced match takes its single best anchor (the first on ties)
#   whatever its IoU; the published assigner takes every anchor at the GT's
#   best IoU, and only where that is at least ``min_pos_iou``;
# - where several GTs force one anchor the last by index wins, padded GTs
#   too (they all force anchor 0, so a valid GT forcing anchor 0 would lose
#   it; anchor 0 lies at the grid's corner, outside every labelled scene);
# - the box loss is plain L1 (weight 0.5) on the deltas with the heading
#   as sin(p - t) split as sin p cos t vs cos p sin t, as the published
#   config's ``L1Loss``; every loss is normalised by the positive count
#   (at least 1), with no sampling, as published;
# - one frame a step, the learning rate of mmcv's one-cycle schedule set
#   before the step, the global-norm clip before AdamW.

FOCAL_ALPHA, FOCAL_GAMMA = 0.25, 2.0
LOSS_WEIGHTS = dict(cls=1.0, bbox=0.5, dir=0.2)


def neck_and_head(p: dict, cfg: dict, canvas: torch.Tensor) -> tuple:
    """The neck and the head over the BEV canvas, with the gradient:
    per anchor the class logits ``[A, classes]``, the deltas ``[A, 7]``
    and the direction logits ``[A, 2]``, and the BEV grid's shape."""
    x = canvas.permute(2, 0, 1)[None]
    for i, d in enumerate(NECK_DILATIONS):
        x = F.conv2d(x, p[f"neck_convs.{i}.weight"], None, 1, d, d)
        x = torch.relu(F.group_norm(x, 16, p[f"neck_norms.{i}.weight"],
                                    p[f"neck_norms.{i}.bias"], 1e-3))

    def head(name, k):
        y = F.conv2d(x, p[f"head.{name}.weight"], p[f"head.{name}.bias"])
        return y[0].permute(1, 2, 0).reshape(-1, k)

    return (head("cls", cfg["num_classes"]), head("reg", 7), head("dir", 2),
            tuple(x.shape[2:]))


def bev_iou_nearest(anchors: torch.Tensor, gts: torch.Tensor
                    ) -> torch.Tensor:
    """``[A, G]`` BEV IoU of the boxes turned to their nearest axis: ``w``
    (index 3) spans x and ``l`` spans y, swapped where |sin yaw| > |cos
    yaw|."""
    def extent(b):
        swap = torch.sin(b[:, 6]).abs() > torch.cos(b[:, 6]).abs()
        w = torch.where(swap, b[:, 4], b[:, 3])
        l = torch.where(swap, b[:, 3], b[:, 4])
        return (b[:, 0] - w / 2, b[:, 1] - l / 2,
                b[:, 0] + w / 2, b[:, 1] + l / 2)

    ax0, ay0, ax1, ay1 = extent(anchors)
    gx0, gy0, gx1, gy1 = extent(gts)
    ix = (torch.minimum(ax1[:, None], gx1[None])
          - torch.maximum(ax0[:, None], gx0[None])).clamp(min=0)
    iy = (torch.minimum(ay1[:, None], gy1[None])
          - torch.maximum(ay0[:, None], gy0[None])).clamp(min=0)
    inter = ix * iy
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_g = (gx1 - gx0) * (gy1 - gy0)
    return inter / (area_a[:, None] + area_g[None] - inter).clamp(min=1e-6)


def assign_anchors(anchors, gt_boxes, gt_labels, gt_valid, a: dict
                   ) -> tuple:
    """Each anchor's GT, and whether it is positive or negative. An anchor
    is of the class of its size row and takes the GT of its class (of any
    class where there is one size) with the best IoU (the first on ties):
    positive at ``pos_iou_thr`` of its class or above, negative under
    ``neg_iou_thr``. Then each GT forces its best anchor positive (the
    first on ties; where several force one, the last GT by index, kept
    only if valid). Invalid GTs match nothing."""
    A, S, R = len(anchors), len(a["sizes"]), len(a["rotations"])
    cls = (torch.arange(A, device=anchors.device) // R) % S
    iou = bev_iou_nearest(anchors, gt_boxes)
    ok = gt_valid[None]
    if S > 1:
        ok = ok & (cls[:, None] == gt_labels[None].long())
    iou = torch.where(ok, iou, -1.0)

    def per_class(v):
        v = v if isinstance(v, (list, tuple)) else [v] * S
        return torch.tensor(v, dtype=torch.float32,
                            device=anchors.device)[cls]

    best_iou, best_gt = iou.amax(1), iou.argmax(1)
    pos = best_iou >= per_class(a["pos_iou_thr"])
    neg = best_iou < per_class(a["neg_iou_thr"])
    claim = torch.full((A,), -1, dtype=torch.long, device=anchors.device)
    gts = torch.arange(len(gt_boxes), device=anchors.device)
    claim.scatter_reduce_(0, iou.argmax(0), gts, "amax")
    forced = (claim >= 0) & gt_valid[claim.clamp(min=0)]
    best_gt = torch.where(forced & ~pos, claim.clamp(min=0), best_gt)
    pos = pos | forced
    return best_gt, pos, neg & ~pos


def box_deltas(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """The deltas that take bottom-centre ``anchors`` to ``boxes``: the
    centre over the anchor's BEV diagonal (z over its height, between
    mid-heights), log size ratios, the yaw difference."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xg, yg, zg, wg, lg, hg, rg = boxes.unbind(-1)
    diag = torch.sqrt(la ** 2 + wa ** 2)
    return torch.stack([(xg - xa) / diag, (yg - ya) / diag,
                        ((zg + hg / 2) - (za + ha / 2)) / ha,
                        torch.log(wg / wa), torch.log(lg / la),
                        torch.log(hg / ha), rg - ra], -1)


def anchor_losses(cls, reg, dirl, anchors, gt_boxes, gt_labels, gt_valid,
                  a: dict, num_classes: int) -> dict:
    """Sigmoid focal loss over the positive and negative anchors (one-hot
    targets on positives), L1 on the positives' deltas with the heading's
    sine split, and the direction cross-entropy on positives (bin 1 where
    the GT's yaw less ``dir_offset`` lies in [pi, 2 pi) modulo 2 pi), each
    over the positive count (at least 1)."""
    best_gt, pos, neg = assign_anchors(anchors, gt_boxes, gt_labels,
                                       gt_valid, a)
    gt = gt_boxes[best_gt]
    lab = gt_labels[best_gt].long()
    n_pos = pos.sum().float().clamp(min=1.0)
    onehot = ((lab[:, None] == torch.arange(num_classes,
                                            device=cls.device))
              & pos[:, None]).float()
    prob = torch.sigmoid(cls)
    ce = F.binary_cross_entropy_with_logits(cls, onehot, reduction="none")
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    a_t = FOCAL_ALPHA * onehot + (1 - FOCAL_ALPHA) * (1 - onehot)
    focal = a_t * (1 - p_t) ** FOCAL_GAMMA * ce
    loss_cls = (focal * (pos | neg).float()[:, None]).sum() / n_pos

    t = box_deltas(anchors, gt)
    pred = torch.cat([reg[:, :6], (torch.sin(reg[:, 6])
                                   * torch.cos(t[:, 6]))[:, None]], -1)
    tgt = torch.cat([t[:, :6], (torch.cos(reg[:, 6])
                                * torch.sin(t[:, 6]))[:, None]], -1)
    loss_bbox = ((pred - tgt).abs() * pos.float()[:, None]).sum() / n_pos

    rot = gt[:, 6] - a["dir_offset"]
    turned = torch.fmod(rot, 2 * math.pi)
    turned = torch.where(turned < 0, turned + 2 * math.pi, turned)
    dir_tgt = (turned >= math.pi).long()
    ce_dir = F.cross_entropy(dirl, dir_tgt, reduction="none")
    loss_dir = (ce_dir * pos.float()).sum() / n_pos
    w = LOSS_WEIGHTS
    loss = w["cls"] * loss_cls + w["bbox"] * loss_bbox + w["dir"] * loss_dir
    return dict(loss_cls=w["cls"] * loss_cls, loss_bbox=w["bbox"] * loss_bbox,
                loss_dir=w["dir"] * loss_dir, loss=loss,
                num_pos=pos.sum().float())


def frame_losses(p: dict, cfg: dict, frame: dict) -> dict:
    """One labelled frame's losses (``frame``: ``points``, ``mask``,
    ``gt_boxes``, ``gt_labels``, ``gt_valid``)."""
    s = cfg["sst"]
    canvas, _, _ = backbone(p, s, frame["points"], frame["mask"])
    cls, reg, dirl, hw = neck_and_head(p, cfg, canvas)
    anchors = torch.from_numpy(generate_anchors(
        hw, s["pc_range"], cfg["anchors"])).to(cls.device)
    return anchor_losses(cls, reg, dirl, anchors, frame["gt_boxes"],
                         frame["gt_labels"], frame["gt_valid"],
                         cfg["anchors"], cfg["num_classes"])


def step_grads(params: dict, cfg: dict, frame: dict) -> dict:
    """One training forward and backward of ``frame`` from ``params``: the
    loss terms, each leaf's gradient before the clip (zeros where the loss
    does not reach it) and their global norm."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    terms = frame_losses(p, cfg, frame)
    grads = torch.autograd.grad(terms["loss"], list(p.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(p.items(), grads)}
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    return dict(losses={k: float(v.detach()) for k, v in terms.items()},
                grads=grads, norm=float(norm))


def learning_rate(opt: dict, total_steps: int, step: int) -> float:
    """mmcv's one-cycle cosine schedule: from ``base_lr`` up to
    ``peak_ratio`` times it over the first 10% of the steps, then down to
    1e-3 of that peak."""
    up = max(int(total_steps * 0.1), 1)
    peak = opt["base_lr"] * opt["peak_ratio"]

    def cos(t, lo, hi):
        return hi + (lo - hi) * 0.5 * (1 + math.cos(math.pi * t))

    if step < up:
        return cos(min(max(step / up, 0.0), 1.0), opt["base_lr"], peak)
    t = (step - up) / max(total_steps - up, 1)
    return cos(min(max(t, 0.0), 1.0), peak, peak * 1e-3)


def decays(name: str) -> bool:
    """Weight decay on every weight but norms' and biases."""
    parts = name.split(".")
    return not (any("norm" in q.lower() or q == "ln" for q in parts)
                or parts[-1] == "bias")


def adamw(params: dict, moments: tuple, grads: dict, opt: dict,
          total_steps: int, step: int) -> tuple:
    """AdamW (0.9, 0.999, eps 1e-8, decoupled decay ``weight_decay`` on
    ``decays``) at the schedule's rate for step ``step`` (its ``t`` is
    ``step + 1``): the parameters and the first and second moments after
    it."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr = learning_rate(opt, total_steps, step)
    t = step + 1
    out, m1, m2 = {}, {}, {}
    with torch.no_grad():
        for k, v in params.items():
            g = grads[k]
            v = v * (1 - lr * opt["weight_decay"]) if decays(k) else v.clone()
            m1[k] = moments[0][k] * b1 + g * (1 - b1)
            m2[k] = moments[1][k] * b2 + g * g * (1 - b2)
            denom = m2[k].sqrt() / math.sqrt(1 - b2 ** t) + eps
            out[k] = v - lr / (1 - b1 ** t) * m1[k] / denom
    return out, (m1, m2)
