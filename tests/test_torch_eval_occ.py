"""The port's occupancy IoU, online latent tuning and test-time
augmentation held against the JAX package on the CPU, at ``tiny_config()``
with one converted parameter tree (``tests/test_torch_ococcnet.py``'s).

Bars: inter / union exact, except that a frame may differ by as many
queries as have a probability within 1e-5 of the threshold; the decode of
the valid prefix equal to the decode of the whole padded buffer;
observation targets exact; the latent after 3 Adam steps within 1e-5
(where Adam's first move is ill-conditioned, see the test, within 3 lr (1
- u)); the
weighted merge (four distinct yaws: the median is the mean of the middle
two) within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from objectcentricocccompletion_tpu.evalx import evaluator as jev
from objectcentricocccompletion_tpu.evalx import occ_iou as jocc
from objectcentricocccompletion_tpu.evalx import online_tuning as jot
from objectcentricocccompletion_tpu.evalx import tta as jtta
from objectcentricocccompletion_tpu.models import ococcnet as jnet
from objectcentricocccompletion_torch.data.tracklet import TrackletBatch
from objectcentricocccompletion_torch.evalx import evaluator as tev
from objectcentricocccompletion_torch.evalx import occ_iou as tocc
from objectcentricocccompletion_torch.evalx import online_tuning as tot
from objectcentricocccompletion_torch.evalx import tta as ttta
from objectcentricocccompletion_torch.models import ococcnet as tnet
from tests.test_torch_ococcnet import (TINY, _batch, _params, _port_model,
                                       _torch_config)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

NEAR = 1e-5


def _models():
    params = _params("dense")
    return params, jnet.OcOccNetWithLoss(TINY), _port_model(TINY, params)


def _tracklet(rng, L):
    """RoIs and GT boxes of one object over ``L`` frames (the RoIs a noisy
    copy), and a latent per frame."""
    size = np.array([4.2, 1.9, 1.6])
    gt = np.concatenate([rng.uniform(-5, 5, (L, 3)), np.tile(size, (L, 1)),
                         rng.uniform(-np.pi, np.pi, (L, 1))], -1)
    rois = gt + rng.normal(0, 0.15, (L, 7)) * [1, 1, 1, 0.3, 0.3, 0.3, 0.2]
    return rois.astype(np.float32), gt.astype(np.float32), size


def test_occ_iou_per_frame_matches(one_torch_thread):
    params, jmodel, model = _models()
    rng = np.random.RandomState(0)
    L, K, k = 20, 400, 230          # 16 + 4 frames; a valid prefix of 230
    rois, gt, size = _tracklet(rng, L)
    D = model.net.occ_decoder.ln.normalized_shape[0]
    latent = rng.randn(L, D).astype(np.float32)
    pts = np.zeros((K, 3), np.float32)
    pts[:k] = rng.uniform(-0.5, 0.5, (k, 3)) * size
    lab = np.zeros(K, np.int32)
    lab[:k] = rng.rand(k) < 0.4
    msk = np.arange(K) < k
    gt_valid = rng.rand(L) < 0.8

    def jdecode(lat, q):
        return jmodel.apply({"params": params}, lat, q,
                            method=jmodel.decode_occ_queries)

    ref = jax.jit(lambda *a: jocc.occ_iou_per_frame(jdecode, *a, 0.5))(
        latent, rois, gt, gt_valid, pts, lab, msk)
    args = [torch.from_numpy(x) for x in (latent, rois, gt, gt_valid, pts,
                                          lab, msk)]
    inter, union = tocc.occ_iou_per_frame(model.decode_occ_queries, *args,
                                          0.5)
    assert inter.dtype == union.dtype == torch.int64
    # the decode of the whole padded buffer: equal to the prefix's
    with torch.no_grad():
        q = tnet.gt_occ_to_roi_frame(args[4][None], args[2][None],
                                     args[1][None])[0]
        prob = torch.sigmoid(model.decode_occ_queries(args[0], q))
    pred = (prob > 0.5) & (q.abs() <= 0.5 * args[1][:, None, 3:6]).all(-1)
    valid = args[6][None] & args[3][:, None]
    gt_occ = (args[5] == 1) & args[6]
    assert torch.equal(inter, ((pred & gt_occ) & valid).sum(-1))
    assert torch.equal(union, ((pred | gt_occ) & valid).sum(-1))
    # against JAX, up to the queries at the threshold
    near = (((prob - 0.5).abs() < NEAR) & valid).sum(-1).numpy()
    for got, r in ((inter, ref[0]), (union, ref[1])):
        assert (np.abs(got.numpy() - np.asarray(r)) <= near).all()
    assert (union > inter).any() and (inter > 0).any()
    assert (inter[~args[3]] == 0).all() and (union[~args[3]] == 0).all()


def test_observation_targets_and_tuning_match(one_torch_thread):
    """``observation_targets`` exact and the Evaluator's tuning step (roi
    pool, voxel snap, targets, 3 Adam steps) within 1e-5, against the JAX
    Evaluator's jitted tuning on the same padded sample."""
    params, jmodel, model = _models()
    b = _batch(TINY, seed=3)
    padded = dict(rois=b.rois[0].numpy(), points=b.points[0].numpy(),
                  points_mask=b.points_mask[0].numpy())
    L, P = padded["points_mask"].shape
    rng = np.random.RandomState(1)
    lat = rng.randn(1, L, model.net.occ_decoder.ln.normalized_shape[0])
    lat = lat.astype(np.float32)

    rois_t = torch.from_numpy(padded["rois"])
    local = torch.from_numpy(rng.uniform(-1.2, 1.2, (L, P, 3)).astype(
        np.float32)) * rois_t[:, None, 3:6] / 2
    pmask = torch.from_numpy(rng.rand(L, P) < 0.6)
    queries = local[:, :40] + 0.3 * torch.randn(L, 40, 3,
                                                 generator=torch.Generator()
                                                 .manual_seed(0))
    got = tot.observation_targets(local, pmask, rois_t[:, 3:6], 0.2, queries)
    ref = jax.jit(jot.observation_targets, static_argnums=3)(
        local.numpy(), pmask.numpy(), padded["rois"][:, 3:6], 0.2,
        queries.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.mean() < 1

    cfg = _torch_config(TINY)

    def tune(steps):
        return tev.Evaluator(model, None, cfg, online_tuning_iters=steps,
                             device="cpu")._maybe_tune(
            {"shape_latent": torch.from_numpy(lat)}, padded)["shape_latent"]

    tuned = tune(3)
    jtuned = jev.Evaluator(jmodel, params, None, TINY,
                           online_tuning_iters=3)._maybe_tune(
        {"shape_latent": jnp.asarray(lat)}, padded)["shape_latent"]
    # Adam's first move is lr g / (|g| + 1e-8): u = |move| / lr. Where u <
    # 0.99 (|g| below 1e-6, 100 eps) the move turns on float32 noise of
    # the gradient; there the latents may part by up to 3 lr (1 - u).
    lr = 0.01
    u = np.abs(tune(1).numpy() - lat) / lr
    bar = np.where(u < 0.99, 1e-5 + 3 * lr * (1 - u), 1e-5)
    assert ((u > 0) & (u < 0.99)).mean() < 0.01   # (u = 0: no gradient)
    assert (np.abs(tuned.numpy() - np.asarray(jtuned)) <= bar).all()
    assert np.abs(tuned.numpy() - lat).max() > 0.01   # the latent moved
    assert not tuned.requires_grad
    assert all(p.grad is None for p in model.parameters())


def test_tta_merges_flips_and_the_callers_batch(one_torch_thread):
    rng = np.random.RandomState(2)
    boxes = [rng.randn(2, 5, 7).astype(np.float32) for _ in range(4)]
    for i, yaw in enumerate((0.1, 0.4, 0.2, 0.3)):
        boxes[i][..., 6] = yaw + 0.01 * rng.randn(2, 5)
    scores = [rng.uniform(0.1, 1, (2, 5)).astype(np.float32)
              for _ in range(4)]
    tb = [torch.from_numpy(x) for x in boxes]
    ts = [torch.from_numpy(x) for x in scores]
    for name in ("merge_boxes_weighted", "merge_boxes"):
        got = getattr(ttta, name)(tb, ts)
        ref = getattr(jtta, name)([jnp.asarray(x) for x in boxes],
                                  [jnp.asarray(x) for x in scores])
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                       rtol=0, err_msg=name)
    yaws = torch.tensor([0.1, 0.4, 0.2, 0.3])
    assert abs(float(ttta.median(yaws)) - 0.25) < 1e-7
    assert float(torch.median(yaws)) == np.float32(0.2)   # the lower one
    assert float(ttta.median(yaws[:3])) == np.float32(0.2)

    b = _batch(TINY, seed=4)
    jb = jnet.TrackletBatch(*(jnp.asarray(x.numpy()) for x in b))
    before = [x.clone() for x in b]
    for fh, fv in ttta.FLIPS:
        f = ttta.flip_batch(b, fh, fv)
        jf = jtta.flip_batch(jb, fh, fv)
        for name, x, y in zip(TrackletBatch._fields, f, jf):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6,
                                       rtol=0, err_msg=name)
        # each flip is an involution (yaw modulo 2 pi)
        back = ttta.flip_batch(f, fh, fv)
        for name, x, y in zip(TrackletBatch._fields, back, b):
            d = x.double().numpy() - y.double().numpy()
            if name in ("rois", "gt_boxes"):
                d[..., 6] = np.angle(np.exp(1j * d[..., 6]))
            assert np.abs(d).max() < 1e-5, name
        un = ttta.unflip_boxes(f.rois, fh, fv)
        np.testing.assert_allclose(
            np.asarray(un), np.asarray(jtta.unflip_boxes(jf.rois, fh, fv)),
            atol=1e-6, rtol=0)
        d = (un - b.rois).numpy()
        d[..., 6] = np.angle(np.exp(1j * d[..., 6]))
        assert np.abs(d).max() < 1e-5
    outs, copies = [], []

    def apply(batch):
        outs.append(model.predict(batch))
        copies.append({k: v.clone() for k, v in outs[-1].items()})
        return outs[-1]

    model = _port_model(TINY, _params("dense"))
    with torch.no_grad():
        merged = ttta.predict_tta(apply, b)
    for x, y in zip(b, before):
        assert torch.equal(x, y)          # the caller's batch is untouched
    for out, copy in zip(outs, copies):   # so are the variants' outputs
        for k in out:
            assert torch.equal(out[k], copy[k]), k
    assert merged["shape_latent"] is outs[0]["shape_latent"]
    assert not torch.equal(merged["boxes"], outs[0]["boxes"])
