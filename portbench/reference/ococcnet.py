"""Plain PyTorch reference of OcOccNet (the paper's tracklet refinement and
occupancy completion network): forward, box decode, occupancy decode, and
the training step (losses, gradients, clip, AdamW).

Float32 with TF32 off, every layer a plain ``F.linear`` / ``F.layer_norm``
and the attention plain softmax attention. Each frame's pooled points (the
RoI pooling worked out again from the inputs) are cut to what the packed
point budget keeps (its waterfill worked out again from the counts); the
kept points of all frames form one list, each with its frame, and the SIR
group reductions are a max and a mean over each frame's points. Nothing
here imports the port or JAX; parameters are a dict under the port's
state-dict names (``param_specs``), drawn by ``portbench/weights.py``.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

GEO_DIM = 13
AE_FEAT_DIM = 12
CODE_SIZE = 7
NERF_BOUND = (-8.0, -8.0, -4.0, 8.0, 8.0, 4.0)


# ---------------------------------------------------------------- parameters

def _mlp_specs(name: str, fin: int, dims, head: bool) -> list:
    out = []
    for i, c in enumerate(dims):
        last_head = head and i == len(dims) - 1
        out.append((f"{name}.Dense_{i}.weight", (c, fin), "w", fin))
        if last_head:
            out.append((f"{name}.Dense_{i}.bias", (c,), "zeros", 0))
        else:
            out += _ln_specs(f"{name}.LayerNorm_{i}", c)
        fin = c
    return out


def _ln_specs(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "ones", 0),
            (f"{name}.bias", (c,), "zeros", 0)]


def _linear_specs(name: str, fin: int, fout: int, bias: bool = True) -> list:
    return [(f"{name}.weight", (fout, fin), "w", fin)] + (
        [(f"{name}.bias", (fout,), "zeros", 0)] if bias else [])


def _sir_specs(name: str, feat_dim: int, rel_dim: int, cfg: dict,
               geo_input: bool) -> list:
    out, width = [], feat_dim
    ch = list(cfg["feat_channels"])
    for i in range(cfg["num_blocks"]):
        in_dim = 3 + width + (rel_dim if geo_input else 0)
        b = f"{name}.block_{i}"
        out += _mlp_specs(f"{b}.rel_mlp", rel_dim,
                          list(cfg["rel_mlp_hidden"]) + [in_dim], False)
        fin = in_dim
        for k, c in enumerate(ch):
            out.append((f"{b}.vfe_{k}.Dense_0.weight", (c, fin), "w", fin))
            out += _ln_specs(f"{b}.vfe_{k}.LayerNorm_0", c)
            fin = 2 * c
        width = ch[-1]
    return out


def param_specs(cfg: dict) -> list:
    """Every parameter of ``OcOccNetWithLoss`` (variant ``ococc``, no
    segmentor): ``(name, shape, kind, fan_in)``."""
    if cfg["variant"] != "ococc" or cfg.get("use_segmentor"):
        raise ValueError("the reference covers the ococc variant without "
                         "a segmentor")
    D = cfg["d_model"]
    roi_dim = cfg["num_blocks"] * sum(cfg["feat_channels"])
    n = "net"
    specs = _sir_specs(f"{n}.roi_encoder", cfg["num_point_feats"] + 1,
                       GEO_DIM, cfg, True)
    specs += _sir_specs(f"{n}.ae_encoder", AE_FEAT_DIM, 3, cfg, False)
    specs += _mlp_specs(f"{n}.roi_pos_enc", 7,
                        list(cfg["roi_pos_enc_mlp"]) + [D], True)
    for i in range(cfg["num_enc_layers"]):
        t = f"{n}.temporal.layer_{i}"
        for p in ("q", "k", "v", "out"):
            specs += _linear_specs(f"{t}.self_attn.{p}", D, D)
        specs += _ln_specs(f"{t}.norm1", D)
        specs += _linear_specs(f"{t}.linear1", D, cfg["attn_ffn_dim"])
        specs += _linear_specs(f"{t}.linear2", cfg["attn_ffn_dim"], D)
        specs += _ln_specs(f"{t}.norm2", D)
    specs += _mlp_specs(f"{n}.conv_latent", roi_dim + D,
                        list(cfg["latent_mlp"]) + [D], True)
    specs += _mlp_specs(f"{n}.conv_fused", D + roi_dim,
                        list(cfg["fusion_mlp"]) + [D], True)
    specs += _mlp_specs(f"{n}.conv_cls", D, list(cfg["cls_mlp"]) + [1],
                        True)
    specs += _mlp_specs(f"{n}.conv_reg", D,
                        list(cfg["reg_mlp"]) + [CODE_SIZE], True)
    c0 = cfg["occ_mlp"][0]
    specs += _ln_specs(f"{n}.occ_decoder.ln", D)
    specs += _linear_specs(f"{n}.occ_decoder.in_latent", D, c0, False)
    specs += _linear_specs(f"{n}.occ_decoder.in_pos",
                           2 * cfg["pos_encode_freqs"] * 3, c0, False)
    specs += _ln_specs(f"{n}.occ_decoder.in_norm", c0)
    specs += _mlp_specs(f"{n}.occ_decoder.mlp", c0,
                        list(cfg["occ_mlp"][1:]) + [1], True)
    return specs


# ----------------------------------------------------------------- dropout

_M32 = (1 << 32) - 1


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c`` modulo 2^32 for ``h`` in [0, 2^32), in two 16-bit halves
    of ``h`` (each product stays under 2^48)."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_bits(k0, k1, counter: torch.Tensor) -> torch.Tensor:
    """The counter hash of the port's dropout: a murmur3 finalizer over the
    uint32 ``counter`` keyed by the words ``k0``, ``k1``."""
    h = counter & _M32
    h = (_mul32(h, 2654435761) + k0) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h ^ k1
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


class Dropout:
    """The dropout sites of one training forward, in call order: site ``i``
    is keyed by the hash of counters ``2i, 2i + 1`` under ``(seed,
    step)``; its mask keeps an element where the hash of its flat index is
    below ``round(keep * 2^32)``, and scales it by ``1 / keep`` in
    float32."""

    def __init__(self, seed: int, step: int, device):
        self.seed, self.step, self.device = int(seed), int(step), device
        self.site = 0

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        i = self.site
        self.site += 1
        key = hash_bits(self.seed, self.step, torch.arange(
            2 * i, 2 * i + 2, device=self.device))
        bits = hash_bits(key[0], key[1], torch.arange(
            x.numel(), device=self.device)).view(x.shape)
        keep = 1.0 - rate
        thresh = min(int(round(keep * 4294967296.0)), _M32)
        scale = float(torch.tensor(1.0 / keep, dtype=torch.float32))
        return torch.where(bits < thresh, x * scale, 0.0)


def _no_drop(x, rate):
    return x


# ------------------------------------------------------------------ layers

def linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def layer_norm(p: dict, name: str, x: torch.Tensor, eps: float
               ) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def mlp(p: dict, name: str, x: torch.Tensor, n: int, head: bool,
        drop=_no_drop, rate: float = 0.0) -> torch.Tensor:
    """Dense -> LayerNorm (eps 1e-3) -> exact GELU -> dropout per hidden
    layer; with ``head`` the last layer is a biased Dense."""
    for i in range(n):
        x = linear(p, f"{name}.Dense_{i}", x)
        if not (head and i == n - 1):
            x = drop(F.gelu(layer_norm(p, f"{name}.LayerNorm_{i}", x, 1e-3)),
                     rate)
    return x


# ------------------------------------------------------------------- boxes

def rotate_z(pts: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Points ``[..., 3]`` rotated about z by ``ang [...]``: x' = x cos +
    y sin, y' = y cos - x sin."""
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    x, y, z = pts[..., 0:1], pts[..., 1:2], pts[..., 2:3]
    ox, oy = x * c + y * s, -x * s + y * c
    return torch.cat([ox, oy, z.expand(ox.shape)], -1)


def box_center(boxes: torch.Tensor) -> torch.Tensor:
    z = boxes[..., 2:3] + 0.5 * boxes[..., 5:6]
    return torch.cat([boxes[..., 0:2], z], -1)


def to_box_frame(pts: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """``pts [..., P, 3]`` in the frame of ``boxes [..., 7]``."""
    return rotate_z(pts - box_center(boxes)[..., None, :],
                    -boxes[..., None, 6])


def decode_from_rois(rois: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Residuals ``d [..., 7]`` against each RoI -> ego-frame boxes."""
    w, l, h = rois[..., 3:4], rois[..., 4:5], rois[..., 5:6]
    diag = torch.sqrt(l ** 2 + w ** 2)
    hg = torch.exp(d[..., 5:6]) * h
    local = torch.cat([d[..., 0:1] * diag, d[..., 1:2] * diag,
                       d[..., 2:3] * h + h / 2 - hg / 2], -1)
    ctr = rotate_z(local[..., None, :],
                   rois[..., None, 6] + math.pi / 2)[..., 0, :]
    return torch.cat([ctr + rois[..., 0:3], torch.exp(d[..., 3:4]) * w,
                      torch.exp(d[..., 4:5]) * l, hg,
                      d[..., 6:7] + rois[..., 6:7]], -1)


# ------------------------------------------------------ pooling and budget

def roi_pool(points: torch.Tensor, points_mask: torch.Tensor,
             rois: torch.Tensor, extra) -> dict:
    """Each frame's points against its RoI ``[B, L, P]``: box-local xyz,
    distances to the six faces, whether a point lies only in the margin,
    the offset from the RoI's bottom centre; pooled where inside the box
    enlarged by ``extra`` (in total)."""
    xyz = points[..., :3]
    local = to_box_frame(xyz, rois)
    half = 0.5 * rois[..., None, 3:6]
    half_ext = half + 0.5 * torch.tensor(extra, device=points.device)
    inside_ext = (local.abs() <= half_ext).all(-1)
    inside = (local.abs() <= half).all(-1)
    return dict(mask=points_mask & inside_ext, local=local,
                boundary=torch.cat([half - local, local + half], -1),
                margin=(inside_ext & ~inside).float(),
                rel=xyz - rois[..., None, 0:3])


def budget_keep(mask: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The pooled points the port's layout keeps, ``[B, L, P]``. Packed
    (``packed_point_budget``): a tracklet of L frames has
    ``L * max(budget // reg_len, quantum)`` slots, rounded up to the
    quantum; each frame keeps its first T points, T the largest cap whose
    footprint (each frame's kept count rounded up to the quantum) fits.
    Dense: each frame's first ``roi_point_budget`` points."""
    B, L, P = mask.shape
    rank = mask.long().cumsum(-1) - 1
    budget = cfg.get("packed_point_budget")
    if not budget:
        q = cfg.get("roi_point_budget") or P
        return mask & (rank < q)
    q = cfg["packed_quantum"]
    n = L * max(budget // cfg["reg_len"], q or 1)
    if q:
        n = -(-n // q) * q
    counts = mask.sum(-1)                                      # [B, L]
    caps = torch.arange(P + 1, device=mask.device)
    kept = torch.minimum(counts[..., None], caps)              # [B, L, P+1]
    foot = (-(-kept // q) * q) if q else kept
    fits = foot.sum(1) <= n                                    # [B, P+1]
    cap = torch.where(fits, caps, -1).amax(-1)                 # [B]
    return mask & (rank < cap[:, None, None])


# ----------------------------------------------------------------- encoders

def _group_max(x: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    """Per frame the max of its points' rows; 0 for a frame with none.
    The reduction starts from -inf, not from 0 with ``include_self=False``:
    autograd there counts the untouched 0 as a tie wherever a maximum is 0,
    and halves that point's gradient (a frame of one point, whose gate is 0
    while the biases are)."""
    out = x.new_full((G, x.shape[1]), -math.inf).scatter_reduce(
        0, seg[:, None].expand_as(x), x, "amax")
    return torch.where(out > -math.inf, out, 0.0)


def sir_encoder(p: dict, name: str, cfg: dict, xyz, feats, seg, G: int,
                f_cluster=None, geo_input: bool = True):
    """One SIR encoder over the kept points ``[M, ...]`` of ``G`` frames
    (``seg``: each point's frame) -> ``[G, num_blocks *
    sum(feat_channels)]``."""
    norm = cfg["xyz_normalizer" if geo_input else "ae_xyz_normalizer"]
    xyz_n = xyz / torch.tensor(norm, device=xyz.device)
    if f_cluster is None:
        cnt = torch.bincount(seg, minlength=G).clamp(min=1)[:, None]
        center = xyz.new_zeros(G, 3).index_add(0, seg, xyz) / cnt
        f_cluster = xyz - center[seg]
    f_rel = f_cluster / 10.0
    out, clusters = feats, []
    nv = len(cfg["feat_channels"])
    for i in range(cfg["num_blocks"]):
        b = f"{name}.block_{i}"
        parts = [xyz_n, out] + ([f_rel] if geo_input else [])
        x = torch.cat(parts, -1) * mlp(p, f"{b}.rel_mlp", f_rel,
                                       len(cfg["rel_mlp_hidden"]) + 1, False)
        for k in range(nv):
            x = F.gelu(layer_norm(p, f"{b}.vfe_{k}.LayerNorm_0",
                                  linear(p, f"{b}.vfe_{k}.Dense_0", x), 1e-3))
            g = _group_max(x, seg, G)
            clusters.append(g)
            if k != nv - 1:
                x = torch.cat([x, g[seg]], -1)
        if not geo_input and x.shape == out.shape:
            x = x + out
        out = x
    return torch.cat(clusters, -1)


def encode(p: dict, cfg: dict, points, points_mask, rois, roi_scores):
    """Both encoders' per-frame features ``[B, L, roi_dim]`` over the
    points the budget keeps, and the frames that hold one."""
    B, L, P, _ = points.shape
    G = B * L
    pool = roi_pool(points, points_mask, rois, cfg["extra_wlh"])
    keep = budget_keep(pool["mask"], cfg)
    nonempty = keep.any(-1)
    b, l, i = torch.nonzero(keep, as_tuple=True)
    seg = b * L + l
    pts = points[b, l, i]
    local, boundary = pool["local"][b, l, i], pool["boundary"][b, l, i]
    margin, rel = pool["margin"][b, l, i, None], pool["rel"][b, l, i]

    inv = float(1.0 / torch.tensor(cfg["ae_voxel_size"]))
    vs = cfg["ae_voxel_size"]
    lo = -0.5 * rois[b, l, 3:6]
    vox = torch.floor((local - lo) * inv) * vs + lo + 0.5 * vs

    roi = sir_encoder(
        p, "net.roi_encoder", cfg, pts[:, :3],
        torch.cat([pts[:, 3:], roi_scores[b, l, None]], -1), seg, G,
        torch.cat([local, boundary, margin, rel], -1), True)
    ae = sir_encoder(
        p, "net.ae_encoder", cfg, local,
        torch.cat([pts[:, 3:5], boundary, margin, vox], -1), seg, G, None,
        False)
    nz = nonempty[..., None]
    return (torch.where(nz, roi.reshape(B, L, -1), 0.0),
            torch.where(nz, ae.reshape(B, L, -1), 0.0), nonempty, keep)


# -------------------------------------------------------------------- heads

def frame_encoding(frame_inds: torch.Tensor, D: int) -> torch.Tensor:
    div = torch.exp(torch.arange(0, D, 2, device=frame_inds.device).float()
                    * (-math.log(10000.0) / D))
    ang = frame_inds[..., None].float() * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def temporal(p: dict, cfg: dict, src, pos, drop=_no_drop):
    """Post-norm causal transformer layers over the frames."""
    B, L, D = src.shape
    H = cfg["attn_num_heads"]
    hd = D // H
    causal = torch.ones(L, L, dtype=torch.bool, device=src.device).tril()
    for i in range(cfg["num_enc_layers"]):
        t = f"net.temporal.layer_{i}"
        qk = src + pos
        q = linear(p, f"{t}.self_attn.q", qk).view(B, L, H, hd)
        k = linear(p, f"{t}.self_attn.k", qk).view(B, L, H, hd)
        v = linear(p, f"{t}.self_attn.v", src).view(B, L, H, hd)
        logits = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(hd)
        w = torch.softmax(logits.masked_fill(~causal, float("-inf")), -1)
        w = drop(w, cfg["attn_dropout"])
        a = torch.einsum("bhlm,bmhd->blhd", w, v).reshape(B, L, D)
        src = layer_norm(p, f"{t}.norm1",
                         src + linear(p, f"{t}.self_attn.out", a), 1e-5)
        ffn = linear(p, f"{t}.linear2",
                     F.gelu(linear(p, f"{t}.linear1", src)))
        src = layer_norm(p, f"{t}.norm2", src + ffn, 1e-5)
    return src


def heads(p: dict, cfg: dict, roi, ae, rois, frame_inds, drop=_no_drop):
    D = cfg["d_model"]
    pos = frame_encoding(frame_inds, D) + mlp(
        p, "net.roi_pos_enc", rois, len(cfg["roi_pos_enc_mlp"]) + 1, True)
    fused = temporal(p, cfg, roi, pos, drop)
    latent = mlp(p, "net.conv_latent", torch.cat([ae, fused], -1),
                 len(cfg["latent_mlp"]) + 1, True, drop,
                 cfg["latent_dropout"])
    rcnn = mlp(p, "net.conv_fused", torch.cat([latent, roi], -1),
               len(cfg["fusion_mlp"]) + 1, True, drop, cfg["fusion_dropout"])
    cls = mlp(p, "net.conv_cls", rcnn, len(cfg["cls_mlp"]) + 1, True, drop,
              cfg["cls_dropout"])[..., 0]
    reg = mlp(p, "net.conv_reg", rcnn, len(cfg["reg_mlp"]) + 1, True, drop,
              cfg["reg_dropout"])
    return cls, reg, latent


def nerf_encoding(xyz: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """sin and cos of pi x 2^k of each coordinate normalised to [-1, 1],
    ordered (sin, cos) x frequency x axis."""
    b = torch.tensor(NERF_BOUND, device=xyz.device)
    x = (xyz - b[:3]) / (b[3:] - b[:3]) * 2.0 - 1.0
    ang = (math.pi * x)[..., None, :] * (2.0 ** torch.arange(
        num_freqs, device=xyz.device).float())[:, None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -2).flatten(-2)


def decode_occ(p: dict, cfg: dict, latent, queries, drop=_no_drop):
    """Occupancy logits ``[..., K]`` of box-local ``queries [..., K, 3]``
    given each frame's ``latent [..., D]``."""
    d = "net.occ_decoder"
    lat = F.linear(layer_norm(p, f"{d}.ln", latent, 1e-5),
                   p[f"{d}.in_latent.weight"])
    x = lat[..., None, :] + F.linear(
        nerf_encoding(queries, cfg["pos_encode_freqs"]),
        p[f"{d}.in_pos.weight"])
    x = drop(F.gelu(layer_norm(p, f"{d}.in_norm", x, 1e-3)),
             cfg["occ_dropout"])
    return mlp(p, f"{d}.mlp", x, len(cfg["occ_mlp"]), True, drop,
               cfg["occ_dropout"])[..., 0]


@torch.no_grad()
def refine(p: dict, cfg: dict, batch: dict) -> dict:
    """One refinement call: boxes ``[B, L, 7]``, scores ``[B, L]`` and
    the occupancy logits ``[B, L, K]`` of ``batch["queries"]``."""
    roi, ae, _, _ = encode(p, cfg, batch["points"], batch["points_mask"],
                           batch["rois"], batch["roi_scores"])
    cls, reg, latent = heads(p, cfg, roi, ae, batch["rois"],
                             batch["frame_inds"])
    occ = torch.cat([decode_occ(p, cfg, latent[:, s:s + 32],
                                batch["queries"][:, s:s + 32])
                     for s in range(0, latent.shape[1], 32)], 1)
    return dict(boxes=decode_from_rois(batch["rois"], reg),
                scores=torch.sigmoid(cls), occ=occ)


def kept_points(cfg: dict, batch: dict) -> torch.Tensor:
    """The pooled points the budget keeps per tracklet, ``[B]``."""
    pool = roi_pool(batch["points"], batch["points_mask"], batch["rois"],
                    cfg["extra_wlh"])
    return budget_keep(pool["mask"], cfg).sum((1, 2))


# ----------------------------------------------------------------- training

def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def roi_targets(rois: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The GT box against its RoI, in the RoI's frame turned by a quarter:
    centre offsets over the RoI's diagonal and height, log size ratios,
    the heading folded into (-pi/2, pi/2] (flip-invariant)."""
    roi_yaw = _mod(rois[..., 6], 2 * math.pi)
    ctr = rotate_z((gt[..., 0:3] - rois[..., 0:3])[..., None, :],
                   -(roi_yaw[..., None] + math.pi / 2))[..., 0, :]
    ry = _mod(gt[..., 6] - roi_yaw, 2 * math.pi)
    opposite = (ry > math.pi * 0.5) & (ry < math.pi * 1.5)
    ry = torch.where(opposite, _mod(ry + math.pi, 2 * math.pi), ry)
    ry = torch.where(ry > math.pi, ry - 2 * math.pi, ry).clamp(
        -math.pi / 2, math.pi / 2)
    w, l, h = rois[..., 3], rois[..., 4], rois[..., 5]
    diag = torch.sqrt(l ** 2 + w ** 2)
    zg = ctr[..., 2] + gt[..., 5] / 2
    return torch.stack([ctr[..., 0] / diag, ctr[..., 1] / diag,
                        (zg - h / 2) / h, torch.log(gt[..., 3] / w),
                        torch.log(gt[..., 4] / l), torch.log(gt[..., 5] / h),
                        ry], -1)


def _bev_corners(b) -> list:
    """A box's BEV corners, counter-clockwise, in the frame convention of
    ``to_box_frame`` (world = its inverse rotation of the local corners)."""
    c, s = math.cos(b[6]), math.sin(b[6])
    return [(b[0] + x * c + y * s, b[1] - x * s + y * c)
            for x, y in ((b[3] / 2, b[4] / 2), (-b[3] / 2, b[4] / 2),
                         (-b[3] / 2, -b[4] / 2), (b[3] / 2, -b[4] / 2))]


def _clip(poly: list, a, b) -> list:
    """``poly`` clipped to the left of the directed edge a -> b."""
    def side(p):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])

    out = []
    for i, p in enumerate(poly):
        q = poly[(i + 1) % len(poly)]
        sp, sq = side(p), side(q)
        if sp >= 0:
            out.append(p)
        if (sp >= 0) != (sq >= 0):
            t = sp / (sp - sq)
            out.append((p[0] + t * (q[0] - p[0]), p[1] + t * (q[1] - p[1])))
    return out


def _area(poly: list) -> float:
    return 0.5 * abs(sum(p[0] * q[1] - q[0] * p[1]
                         for p, q in zip(poly, poly[1:] + poly[:1])))


def aligned_iou_3d(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Paired 3D IoU of bottom-centre boxes ``[..., 7]``: the BEV overlap
    of the two rotated rectangles (polygon clipping in float64 on the
    host) times the height overlap, over the union."""
    x1 = b1.detach().double().cpu().reshape(-1, 7).tolist()
    x2 = b2.detach().double().cpu().reshape(-1, 7).tolist()
    out = []
    for u, v in zip(x1, x2):
        poly, clip = _bev_corners(u), _bev_corners(v)
        for k in range(4):
            if not poly:
                break
            poly = _clip(poly, clip[k], clip[(k + 1) % 4])
        bev = _area(poly) if len(poly) >= 3 else 0.0
        h = max(min(u[2] + u[5], v[2] + v[5]) - max(u[2], v[2]), 0.0)
        inter = bev * h
        union = u[3] * u[4] * u[5] + v[3] * v[4] * v[5] - inter
        out.append(inter / max(union, 1e-8))
    return torch.tensor(out, dtype=b1.dtype,
                        device=b1.device).reshape(b1.shape[:-1])


def bce(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def losses(p: dict, cfg: dict, batch: dict, drop=_no_drop) -> dict:
    """The training loss terms of one batch (a training forward: the full
    causal window, dropout by ``drop``): classification against the
    IoU-soft label over the frames with points, the weighted L1 of the box
    residuals over positives, the occupancy BCE of the GT samples in each
    RoI's frame over positives with a confident annotation."""
    roi, ae, nonempty, _ = encode(p, cfg, batch["points"],
                                  batch["points_mask"], batch["rois"],
                                  batch["roi_scores"])
    cls, reg, latent = heads(p, cfg, roi, ae, batch["rois"],
                             batch["frame_inds"], drop)
    B, L = cls.shape
    rois, gt = batch["rois"], batch["gt_boxes"]
    iou = torch.where(batch["gt_valid"], aligned_iou_3d(rois, gt), 0.0)
    soft = ((iou - cfg["cls_neg_thr"])
            / (cfg["cls_pos_thr"] - cfg["cls_neg_thr"])).clamp(0.0, 1.0)
    loss_cls = cfg["loss_cls_weight"] * (
        bce(cls, soft) * nonempty.float()).sum() / (B * L)
    pos = (batch["gt_valid"] & nonempty).float()
    num_pos = pos.sum()
    w = torch.tensor(cfg["rcnn_code_weights"], device=cls.device)
    l1 = (reg - roi_targets(rois, gt)).abs() * w
    loss_bbox = cfg["loss_bbox_weight"] * (l1 * pos[..., None]).sum() \
        / num_pos.clamp(min=1.0)
    ego = rotate_z(batch["occ_points"][:, None],
                   gt[..., None, 6]) + box_center(gt)[..., None, :]
    queries = to_box_frame(ego, rois)                         # [B, L, K, 3]
    K = queries.shape[2]
    logits = decode_occ(p, cfg, latent, queries, drop)
    lab = (batch["occ_labels"] == 1)[:, None].expand(logits.shape).float()
    conf = (batch["occ_score"] > cfg["occ_label_thresh"]).float()
    occ_w = (pos[..., None] * conf[:, None, None]
             * batch["occ_mask"][:, None].float())
    loss_occ = cfg["loss_occ_weight"] * (bce(logits, lab) * occ_w).sum() \
        / (num_pos * K).clamp(min=1.0)
    return dict(loss_rcnn_cls=loss_cls, loss_rcnn_bbox=loss_bbox,
                loss_rcnn_occ=loss_occ, loss=loss_cls + loss_bbox + loss_occ)


def learning_rate(cfg: dict, total_steps: int, step: int) -> float:
    """The one-cycle cosine schedule: from base_lr up to ``lr_mult`` times
    it over the first 10% of the steps, then down to 1e-3 of that peak."""
    up = max(int(total_steps * 0.1), 1)
    peak = cfg["base_lr"] * cfg["lr_mult"]

    def cos(t, lo, hi):
        return hi + (lo - hi) * 0.5 * (1 + math.cos(math.pi * t))

    if step < up:
        return cos(min(max(step / up, 0.0), 1.0), cfg["base_lr"], peak)
    t = (step - up) / max(total_steps - up, 1)
    return cos(min(max(t, 0.0), 1.0), peak, peak * 1e-3)


def decays(name: str) -> bool:
    """Weight decay on every weight but norms' and biases."""
    parts = name.split(".")
    return not (any("norm" in q.lower() or q == "ln" for q in parts)
                or parts[-1] == "bias")


def step_grads(params: dict, cfg: dict, batch: dict, seed: int,
               step: int) -> dict:
    """One training forward and backward from ``params`` at step ``step``
    (dropout keyed by ``(seed, step)``): the loss terms, each leaf's
    gradient before the clip, and their global norm."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    terms = losses(p, cfg, batch, Dropout(seed, step,
                                          batch["points"].device))
    grads = torch.autograd.grad(terms["loss"], list(p.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(p.items(), grads)}
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    return dict(losses={k: float(v.detach()) for k, v in terms.items()},
                grads=grads, norm=float(norm))


def clip(grads: dict, norm: float, max_norm: float) -> dict:
    """The global-norm clip: where ``norm`` is at least ``max_norm``, each
    gradient becomes ``g / norm * max_norm``."""
    if norm < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


def adamw(params: dict, moments: tuple, grads: dict, cfg: dict,
          total_steps: int, step: int) -> tuple:
    """AdamW (0.9, 0.999, eps 1e-8, decoupled decay on ``decays``) at the
    schedule's rate for step ``step`` (its ``t`` is ``step + 1``): returns
    the parameters and the first and second moments after it."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr = learning_rate(cfg, total_steps, step)
    t = step + 1
    out, m1, m2 = {}, {}, {}
    with torch.no_grad():
        for k, v in params.items():
            g = grads[k]
            v = v * (1 - lr * cfg["weight_decay"]) if decays(k) else v.clone()
            m1[k] = moments[0][k] * b1 + g * (1 - b1)
            m2[k] = moments[1][k] * b2 + g * g * (1 - b2)
            denom = m2[k].sqrt() / math.sqrt(1 - b2 ** t) + eps
            out[k] = v - lr / (1 - b1 ** t) * m1[k] / denom
    return out, (m1, m2)


def train_steps(params: dict, cfg: dict, batches: list, seed: int,
                total_steps: int, start: int = 0,
                moments: tuple | None = None) -> dict:
    """One training step per batch from ``params``, the first at step
    ``start``: the losses, the backward, the global-norm clip at
    ``grad_clip_norm``, AdamW at the schedule's rate, from the first and
    second moments ``moments`` (zeros by default); dropout keyed by
    ``(seed, step)``. Returns each step's losses, the first step's clipped
    gradients and the parameters after the last step."""
    p = {k: v.detach() for k, v in params.items()}
    if moments is None:
        moments = tuple({k: torch.zeros_like(v) for k, v in p.items()}
                        for _ in range(2))
    out = dict(losses=[], first_grads=None)
    for step, batch in enumerate(batches, start):
        r = step_grads(p, cfg, batch, seed, step)
        grads = clip(r["grads"], r["norm"], cfg["grad_clip_norm"])
        out["losses"].append(r["losses"])
        if out["first_grads"] is None:
            out["first_grads"] = grads
        p, moments = adamw(p, moments, grads, cfg, total_steps, step)
    out["params"] = p
    return out
