"""OcOccNet's predict and occupancy decode held against the JAX package in
the dense, compacted and packed layouts (``ctrl``:
``test_torch_ococcnet_full.py``); helpers and bars of
``test_torch_ococcnet.py``.

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import pytest

from tests.test_torch_ococcnet import check_predict_and_decode
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["dense", "compact", "packed", "packed_q0"])
def test_predict_and_decode_match(name):
    check_predict_and_decode(name)
