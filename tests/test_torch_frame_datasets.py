"""The port's other frame readers (nuScenes, Lyft, ScanNet, SUN RGB-D,
Argoverse 2) against the JAX package's on the CPU, on the files the JAX
package's own reader tests write, and one detector's CLIs on nuScenes
files.

Bars: every sample equal to JAX's (dtype and bytes, metadata too), draw for
draw from the same ``RandomState``, each reader cut below its points so
that the random subset is drawn.

A file of at most four tests (pytest-xdist's ``--dist loadfile`` hands out
the files with the most tests first)."""
import json

import numpy as np
import pytest

from objectcentricocccompletion_tpu.data import indoor_dataset as jin
from objectcentricocccompletion_tpu.data import nuscenes_dataset as jnu
from objectcentricocccompletion_torch.data import indoor_dataset as tin
from objectcentricocccompletion_torch.data import nuscenes_dataset as tnu
from objectcentricocccompletion_torch.tools import test as test_cli
from objectcentricocccompletion_torch.tools import train as train_cli
from tests.test_indoor_dataset import write_scannet_fixture
from tests.test_nuscenes_dataset import write_nuscenes_fixture
from tests.test_torch_create_data import assert_same
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def _same_samples(got, ref, n_draws=3):
    """Every sample of both readers equal, drawn from one shared
    ``RandomState`` per reader in the same order."""
    assert len(got) == len(ref) > 0
    rg, rr = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(n_draws):
        for i in range(len(ref)):
            assert_same(got.build_sample(i, rg), ref.build_sample(i, rr),
                        f"sample {i}")


def test_nuscenes_and_lyft_samples_equal(tmp_path):
    """Key frame and sweeps (0 and 1 sweep), the valid-flag gate, more
    points than the buffer (the subset drawn), and Lyft's classes."""
    info = write_nuscenes_fixture(str(tmp_path))
    root = str(tmp_path)
    for kw in (dict(max_points=1024, max_gt=8),
               dict(max_points=550, max_gt=2, max_sweeps=1),
               dict(max_points=400, max_gt=8, use_valid_flag=True)):
        _same_samples(tnu.NuScenesDataset(info, root, **kw),
                      jnu.NuScenesDataset(info, root, **kw))
        _same_samples(tnu.LyftDataset(info, root, **kw),
                      jnu.LyftDataset(info, root, **kw))
    ds = tnu.NuScenesDataset(info, root, max_sweeps=1)
    assert ds.point_dim == ds.build_sample(0, np.random.RandomState(0))[
        "points"].shape[1] == 5
    assert tnu.LYFT_CLASSES == jnu.LYFT_CLASSES
    assert tnu.NUSCENES_CLASSES == jnu.NUSCENES_CLASSES


def test_scannet_and_sunrgbd_samples_equal(tmp_path):
    """ScanNet's axis alignment and axis-aligned boxes, SUN RGB-D's yawed
    boxes, the buffer cut below the scene's 400 points."""
    for yawed, t, j in ((False, tin.ScanNetDataset, jin.ScanNetDataset),
                        (True, tin.SUNRGBDDataset, jin.SUNRGBDDataset)):
        root = str(tmp_path / str(yawed))
        info = write_scannet_fixture(root, yawed=yawed)
        for kw in (dict(max_points=512, max_gt=8),
                   dict(max_points=300, max_gt=1)):
            _same_samples(t(info, root, **kw), j(info, root, **kw))
        ds = t(info, root)
        assert ds.point_dim == 6 and ds.classes == list(j.CLASSES)


def test_argo2_samples_equal(tmp_path):
    """The Argoverse 2 reader on the JAX test's feather files (pandas and
    pyarrow, which this reader needs): boxes, labels and the point subset."""
    pytest.importorskip("pyarrow")
    pytest.importorskip("pandas")
    from objectcentricocccompletion_tpu.data import argo2_dataset as jar
    from objectcentricocccompletion_torch.data import argo2_dataset as tar
    from tests.test_argo2 import write_av2_fixture
    write_av2_fixture(str(tmp_path))
    write_av2_fixture(str(tmp_path), log_id="log1", ts=315966070919970000)
    for kw in (dict(max_points=8192), dict(max_points=3000, max_gt=1)):
        _same_samples(tar.Argo2Dataset(str(tmp_path), "train", **kw),
                      jar.Argo2Dataset(str(tmp_path), "train", **kw),
                      n_draws=2)
    ds = tar.Argo2Dataset(str(tmp_path), "train")
    assert len(ds) == 2 and ds.point_dim == 5
    for args in ((0.3, -0.1, 0.2, 0.9), (1.0, 0.0, 0.0, 0.0)):
        assert tar.quat_to_yaw(*args) == jar.quat_to_yaw(*args)
    np.testing.assert_array_equal(
        tar.av2_box_to_lidar(1.0, 2.0, 3.0, 4.5, 2.0, 1.8, 0.7),
        jar.av2_box_to_lidar(1.0, 2.0, 3.0, 4.5, 2.0, 1.8, 0.7))


def test_sst_cli_on_nuscenes_files(tmp_path, capsys):
    """``tools/train.py sst --dataset nuscenes`` for 2 steps and
    ``tools/test.py sst --dataset nuscenes`` on its checkpoint (the KITTI
    protocol keyed by nuScenes' 10 classes), tiny, on the CPU."""
    info = write_nuscenes_fixture(str(tmp_path))
    work = str(tmp_path / "run")
    common = ["sst", "--dataset", "nuscenes", "--infos", info,
              "--data-root", str(tmp_path), "--tiny", "--device", "cpu"]
    assert train_cli.main(common + ["--work-dir", work, "--total-steps",
                                    "2", "--log-interval", "1"]) == 2
    rows = [json.loads(line) for line in open(f"{work}/metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    capsys.readouterr()
    metrics = test_cli.main(common + ["--ckpt-dir", f"{work}/ckpt",
                                      "--score-thresh", "0.0"])
    assert len(metrics) == 3 * 10 and "traffic_cone_3d_hard" in metrics
    with pytest.raises(SystemExit, match="metric waymo"):
        test_cli.main(common + ["--ckpt-dir", f"{work}/ckpt", "--metric",
                                "waymo"])
