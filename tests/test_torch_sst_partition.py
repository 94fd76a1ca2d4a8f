"""SST's window partition (unshifted) and the non-square two-level 3-class
detector held against the JAX package (moved out of
``test_torch_sst.py``, whose helpers and bars they use).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import dataclasses

import pytest

from objectcentricocccompletion_tpu.models import anchor_head as jah
from tests.test_torch_sst import (PARTITION_CASES, TINY, _check_forward,
                                  _detector_pair, check_partition_and_split)
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


def test_non_square_two_level_3class_detector_forward_matches():
    """A 24 x 16 BEV grid (an x/y swap anywhere would show), the two-level
    window split inside the model (small capacity 4 of 16), and the 3-class
    head (6 anchors per cell: the channel-last reshape)."""
    jcfg = dataclasses.replace(
        TINY, sst=dataclasses.replace(
            TINY.sst, pc_range=(-9.6, -6.4, -2, 9.6, 6.4, 4),
            small_capacity=4, max_small_windows=40, max_large_windows=12),
        anchors=jah.waymo_3class_anchor_config(), num_classes=3)
    _check_forward(_detector_pair(jcfg, 300, seed=4), (24, 16))


@pytest.mark.parametrize("case", PARTITION_CASES)
@pytest.mark.parametrize("shifted", [False])
def test_partition_and_split_indices_exact(case, shifted):
    check_partition_and_split(case, shifted)
