"""Sharded evaluation on the CPU: ``Evaluator.run`` on two ``gloo`` ranks
(``tests/torch_ddp_worker.py``, each killed at 120 s) against one process;
the loaders' rank slices of the global batch; the ``parallel/multihost.py``
helpers without a process group."""

import pytest
import torch

from objectcentricocccompletion_torch.configs.ococcnet_config import (
    tiny_config)
from objectcentricocccompletion_torch.data import loader as tloader
from objectcentricocccompletion_torch.data.frame_dataset import (
    FrameDataset, write_synthetic_frames)
from objectcentricocccompletion_torch.data.loader import (
    write_synthetic_dataset)
from objectcentricocccompletion_torch.data.tracklet_dataset import (
    TrackletDataset)
from objectcentricocccompletion_torch.evalx.waymo_bin import read_bin
from objectcentricocccompletion_torch.parallel import multihost
from objectcentricocccompletion_torch.training.detector_trainer import (
    FrameLoader)
from tests import torch_ddp_worker as worker
from tests.test_torch_ddp import run_worker
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def test_two_rank_evaluation_equals_one_process(tmp_path):
    """Tracklets round-robin by rank: rank 0's ``results.bin`` is the
    shards' bytes in rank order and holds the one-process run's objects
    (as a multiset); every metric, the baseline's and the Waymo ones
    among them, equals the one-process run's (rank 1 has no Waymo
    metrics)."""
    write_synthetic_dataset(str(tmp_path / "data"), num_tracklets=5,
                            track_len=12, seed=4)
    ranks = run_worker(("eval",), tmp_path)["eval"]
    one = worker.eval_run(str(tmp_path / "data"), str(tmp_path / "one"))
    ev = tmp_path / "eval"
    shards = [(ev / f"results.shard{r}.bin").read_bytes() for r in (0, 1)]
    assert (ev / "results.bin").read_bytes() == shards[0] + shards[1]
    assert all(shards)

    def objects(path):
        return sorted(repr(sorted(o.items())) for o in read_bin(str(path)))

    assert objects(ev / "results.bin") == objects(tmp_path / "one" /
                                                  "results.bin")
    assert one["num_tracklets"] == 5
    assert any(k.startswith("occ_baseline/") for k in one)
    assert any(k.startswith("occ/") for k in one)
    waymo = {k for k in one if not k.startswith(("occ", "num_", "results"))}
    assert waymo
    for k, v in one.items():
        if k != "results_bin":
            assert ranks[0][k] == v, k
            assert k in waymo or ranks[1][k] == v, k
    assert not waymo & set(ranks[1])


def test_multihost_helpers_without_a_process_group():
    assert multihost.rank() == 0 and multihost.world_size() == 1
    obj = {"a": [1, 2]}
    assert multihost.process_allgather(obj) is obj
    assert multihost.sync_hosts("x") is None
    t = torch.ones(3)
    assert multihost.global_sum(t) is t
    assert multihost.initialize(None, 1, 0, device="cpu") == \
        torch.device("cpu")
    assert multihost.initialize(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--coordinator"):
        multihost.initialize(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize("127.0.0.1:1", 2, 0, "nccl", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            multihost.initialize("127.0.0.1:1", 2, 0)


def test_loaders_slice_the_global_batch(tmp_path):
    """Each shard of ``TrainLoader``, ``PrefetchLoader`` (one spawned
    worker) and ``FrameLoader`` (augmenting) keeps its contiguous slice of
    the one-process loader's global batch, batch after batch."""
    paths = write_synthetic_dataset(str(tmp_path / "data"), num_tracklets=5,
                                    track_len=12, seed=2)
    ds = TrackletDataset(cfg=tiny_config(), **paths)
    infos = write_synthetic_frames(str(tmp_path / "frames"), num_frames=3,
                                   num_points=2000, num_boxes=4, seed=0)
    frames = FrameDataset(infos, str(tmp_path / "frames"), augment=True,
                          max_points=4096, max_gt=32)
    cases = [(lambda **kw: tloader.make_loader(ds, 4, seed=1, **kw)),
             (lambda **kw: tloader.make_loader(ds, 4, seed=1, workers=1,
                                               **kw)),
             (lambda **kw: FrameLoader(frames, 4, seed=1, **kw))]
    for make in cases:
        loaders = [make()] + [make(num_shards=2, shard_id=r) for r in (0, 1)]
        try:
            for _ in range(3):
                whole, *parts = (next(x) for x in loaders)
                assert parts[0][0].shape[0] == 2
                for x, a, b in zip(whole, *parts):
                    assert torch.equal(x, torch.cat([a, b]))
        finally:
            for x in loaders:
                getattr(x, "close", lambda: None)()
    with pytest.raises(ValueError, match="split"):
        tloader.TrainLoader(ds, 3, num_shards=2)
