"""The port's data parallelism over the flat and stacked optimizer layouts
on the CPU (``parallel/train.py``: ``make_train_step(flat_opt=,
stacked_spec=)`` under DDP, the parameters and their gradients views of
``BufferAdamW``'s buffers): two ``gloo`` ranks on 127.0.0.1
(``tests/torch_ddp_worker.py``, each process killed at 120 s) against one
process on the global batch with the same layout, at
``tests/test_torch_ddp.py``'s bars: metrics at 1e-6 relative, every
clipped gradient within 1e-5 of the largest, every parameter within 1e-6,
the ranks' parameters bit-equal.

The case is ``test_torch_ddp.py``'s: the tiny config with its dropout on,
a global batch of 4 whose halves hold different positive counts, so the
ranks agree with the global batch only through the global denominators
and the dropout counter's rank offset, and the gradients reach the
optimizer's buffers only through DDP's all-reduce."""
import pytest

from tests import torch_ddp_worker as worker
from tests.test_torch_ddp import assert_like_one_process, run_worker
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Both layouts' cases on two gloo ranks, in one launch."""
    return run_worker(("ococc_flat", "ococc_stacked"),
                      tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("opt", ["flat", "stacked"])
def test_two_ranks_equal_the_global_batch(opt, rank_runs):
    ranks = rank_runs[f"ococc_{opt}"]
    cfg, batch = worker.ococc_case()
    ref = worker.ococc_step(cfg, batch, opt=opt)
    assert_like_one_process(ranks, ref)
    # the same step as the tree layout's, at the same bars
    assert_like_one_process(ranks, worker.ococc_step(cfg, batch))
