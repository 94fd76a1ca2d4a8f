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
