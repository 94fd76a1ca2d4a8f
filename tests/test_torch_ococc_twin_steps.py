"""The 5-step OcOccNet twin against the JAX ``make_train_step`` (moved out of
``test_torch_ococc_twin.py``, whose data fixture and helpers it uses).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import numpy as np

from objectcentricocccompletion_tpu.data import loader as jloader
from objectcentricocccompletion_torch.data import loader as tloader
from tests.test_torch_ococc_twin import _datasets, _twin, data  # noqa: F401
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TWIN_STEPS = 5


def _loader_batches(data):
    """The port's and the JAX package's loader batches, in pairs."""
    tds, jds = _datasets(data[0])
    return zip(tloader.make_loader(tds, 2, seed=1),
               jloader.make_loader(jds, 2, seed=1))


def test_twin_training(data):
    """Five steps of the loaders' batches of two tracklets at base_lr 1e-4
    (peak 1e-2 after the first step), so that the weights move within
    them."""
    jls, tls, diffs, schedule = _twin(_loader_batches(data), TWIN_STEPS,
                                      1e-4)
    rel = np.abs(tls - jls) / np.abs(jls)
    print(f"twin losses jax {jls} port {tls} max rel dev {rel.max():.2e}")
    assert abs(jls[-1] - jls[0]) > 0.05 * jls[0]     # the weights moved
    # the repository's twin-training bar: 6e-3
    assert rel.max() <= 6e-3, rel
    key_bias = {n for n in diffs if n.endswith(".k.bias")}
    worst = max(v for n, v in diffs.items() if n not in key_bias)
    print(f"twin final params max abs diff {worst:.2e}")
    # a hundredth of one step at the peak rate (1e-2): atol 1e-4
    assert worst <= 1e-4, diffs
    # the softmax is invariant to the key bias: its exact gradient is 0,
    # and Adam turns the float32 noise there into steps of up to lr in
    # either direction, so the two runs may part by twice the sum of lr
    lr_sum = sum(schedule(s) for s in range(TWIN_STEPS))
    assert all(diffs[n] <= 2 * lr_sum for n in key_bias)
