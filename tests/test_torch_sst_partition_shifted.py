"""SST's shifted window partition held against the JAX package, index for
index (the cases of ``test_torch_sst_partition.py`` with ``shifted``).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import pytest

from tests.test_torch_sst import PARTITION_CASES, check_partition_and_split
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", PARTITION_CASES)
@pytest.mark.parametrize("shifted", [True])
def test_partition_and_split_indices_exact(case, shifted):
    check_partition_and_split(case, shifted)
