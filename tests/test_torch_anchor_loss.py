"""The port's anchor assignment and losses (``models/anchor_head.py``)
held against the JAX package's on shared maps, for one class and for the
three Waymo classes. Indices must be equal exactly; every float tolerance
is stated where it is used."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectcentricocccompletion_tpu.models import anchor_head as jah
from objectcentricocccompletion_torch.models import anchor_head as tah

PC_RANGE = (-9.6, -9.6, -2.0, 9.6, 9.6, 4.0)
GRID = (24, 16)        # a rectangular BEV grid
MAX_GT = 10
SIZES = {0: (2.1, 4.8, 1.8), 1: (0.9, 0.9, 1.7), 2: (0.85, 1.8, 1.7)}


def _configs(num_classes):
    if num_classes == 1:
        return jah.AnchorConfig(), tah.AnchorConfig()
    return jah.waymo_3class_anchor_config(), tah.waymo_3class_anchor_config()


def _gts(num_classes, seed):
    """Six valid GTs and padded invalid ones (zeros). With three classes
    class 2 has no GT. GTs 4 and 5 are small boxes at one centre, below
    every positive threshold, so they force-match the same anchor: the
    later one must win; they sit in a corner away from the others."""
    rng = np.random.RandomState(seed)
    labels = np.zeros(MAX_GT, np.int32)
    boxes = np.zeros((MAX_GT, 7), np.float32)
    n = 6
    if num_classes == 3:
        labels[:n] = [0, 1, 0, 1, 1, 1]
    for i in range(n):
        w, l, h = SIZES[int(labels[i])]
        boxes[i] = [rng.uniform(-6, 4), rng.uniform(-6, 4),
                    rng.uniform(-1.8, -1.2), w, l, h,
                    rng.uniform(-np.pi, np.pi)]
    boxes[4, 3:6] = boxes[5, 3:6] = (0.3, 0.3, 1.0)
    boxes[4, :2] = boxes[5, :2] = (8.0, -8.0)
    boxes[5, 6] = boxes[4, 6]
    valid = np.arange(MAX_GT) < n
    return boxes, labels, valid


def _anchor_classes(jcfg, A):
    if len(jcfg.sizes) == 1:
        return None
    return (np.arange(A) // len(jcfg.rotations)) % len(jcfg.sizes)


@pytest.fixture(scope="module", params=[1, 3], ids=["1class", "3class"])
def maps(request):
    ncls = request.param
    jcfg, tcfg = _configs(ncls)
    anchors = tah.generate_anchors(GRID, PC_RANGE, tcfg)
    A = anchors.shape[0]
    boxes, labels, valid = _gts(ncls, seed=ncls)
    rng = np.random.RandomState(10 + ncls)
    return dict(ncls=ncls, jcfg=jcfg, tcfg=tcfg, anchors=anchors,
                boxes=boxes, labels=labels, valid=valid,
                cls=rng.randn(A, ncls).astype(np.float32) - 2,
                reg=(0.3 * rng.randn(A, 7)).astype(np.float32),
                dir=rng.randn(A, 2).astype(np.float32))


def test_anchors_equal_the_jax_package(maps):
    ref = np.asarray(jah.generate_anchors(GRID, PC_RANGE, maps["jcfg"]))
    np.testing.assert_array_equal(maps["anchors"], ref)


def test_nearest_bev_iou(maps):
    ref = np.asarray(jah.nearest_bev_iou(jnp.asarray(maps["anchors"]),
                                         jnp.asarray(maps["boxes"])))
    got = tah.nearest_bev_iou(torch.from_numpy(maps["anchors"]),
                              torch.from_numpy(maps["boxes"]))
    # float32 sin/cos/division in another library: atol 1e-6
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def _assign_both(maps):
    A = maps["anchors"].shape[0]
    ac = _anchor_classes(maps["jcfg"], A)
    ref = jax.jit(lambda a, b, l, v: jah.assign(
        a, b, l, v, maps["jcfg"],
        None if ac is None else jnp.asarray(ac, jnp.int32)))(
            maps["anchors"], maps["boxes"], maps["labels"], maps["valid"])
    got = tah.assign(*map(torch.from_numpy, (maps["anchors"], maps["boxes"],
                                             maps["labels"], maps["valid"])),
                     maps["tcfg"],
                     None if ac is None else torch.from_numpy(ac))
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_assign_indices_exact(maps):
    ref, got = _assign_both(maps)
    for name, r, g in zip(("best_gt", "pos", "neg"), ref, got):
        np.testing.assert_array_equal(g, r, err_msg=name)
    best_gt, pos, neg = got
    assert pos.sum() > 0 and neg.sum() > 0 and not (pos & neg).any()
    # the two GTs that claim one anchor: the later one (5) wins
    iou = tah.nearest_bev_iou(torch.from_numpy(maps["anchors"]),
                              torch.from_numpy(maps["boxes"])).numpy()
    if maps["ncls"] == 3:
        ac = _anchor_classes(maps["jcfg"], len(iou))
        iou = np.where(ac[:, None] == maps["labels"][None], iou, -1.0)
    shared = int(iou[:, 4].argmax())
    assert shared == int(iou[:, 5].argmax())
    assert pos[shared] and best_gt[shared] == 5
    # no positive anchor is matched to a padded GT
    assert maps["valid"][best_gt[pos]].all()
    if maps["ncls"] == 3:   # class 2 has no GT: its anchors are background
        cls2 = _anchor_classes(maps["jcfg"], len(pos)) == 2
        assert not pos[cls2].any() and neg[cls2].all()


def test_focal_loss(maps):
    rng = np.random.RandomState(0)
    tgt = (rng.rand(*maps["cls"].shape) > 0.7).astype(np.float32)
    ref = np.asarray(jah.focal_loss(jnp.asarray(maps["cls"]),
                                    jnp.asarray(tgt)))
    got = tah.focal_loss(torch.from_numpy(maps["cls"]),
                         torch.from_numpy(tgt))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)


def test_anchor_head_loss_entries(maps):
    args = [maps[k] for k in ("cls", "reg", "dir", "anchors", "boxes",
                              "labels", "valid")]
    ref = jax.jit(lambda *a: jah.anchor_head_loss(
        *a, maps["jcfg"], maps["ncls"]))(*args)
    got = tah.anchor_head_loss(*map(torch.from_numpy, args), maps["tcfg"],
                               maps["ncls"])
    assert set(got) == set(ref)
    assert int(got["num_pos_anchors"]) == int(ref["num_pos_anchors"])
    for k in ("loss_cls", "loss_bbox", "loss_dir", "loss"):
        assert got[k].dtype == torch.float32
        # float32 sums over the anchors in another order: rtol 1e-5
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
