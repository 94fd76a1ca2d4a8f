"""The SST twin training run against the JAX package (moved out of
``test_torch_sst_twin.py``, whose frames fixture it uses).

A file of at most four tests: pytest-xdist's ``--dist loadfile`` hands
out the files with the most tests first, so a costly case in a large
file would start ahead of the suite's longest file."""
import jax
import jax.numpy as jnp
import numpy as np

from objectcentricocccompletion_tpu.data import frame_dataset as jfd
from objectcentricocccompletion_tpu.models import sst_detector as jdet
from objectcentricocccompletion_tpu.parallel.train import make_mesh, replicated
from objectcentricocccompletion_tpu.training import detector_trainer as jdt
from objectcentricocccompletion_tpu.training.optim import (
    make_optimizer as jax_make_optimizer)
from objectcentricocccompletion_torch import convert
from objectcentricocccompletion_torch.data import frame_dataset as tfd
from objectcentricocccompletion_torch.models import sst_detector as tdet
from objectcentricocccompletion_torch.training import detector_trainer as tdt
from objectcentricocccompletion_torch.training.optim import make_optimizer
from tests.test_torch_sst import _param_tree, _random_params, _torch_config
from tests.test_torch_sst_twin import TINY, frames  # noqa: F401
from tests.test_torch_window_attention import one_torch_thread  # noqa: F401

TWIN_STEPS = 5


def test_twin_training(frames):
    """Five steps of two frames each at base_lr 1e-4 (peak 1e-2 after the
    first step), from one converted init on the same batches."""
    info, root = frames
    kw = dict(max_points=2048, max_gt=TINY.max_gt)
    jloader = jdt.FrameLoader(jfd.FrameDataset(info, root, **kw), 2, seed=1)
    tloader = tdt.FrameLoader(tfd.FrameDataset(info, root, **kw), 2, seed=1)

    model = jdet.SSTDetector(TINY)
    first = next(jloader)
    params = jax.tree_util.tree_map(np.asarray,
                                    _random_params(_param_tree(TINY), 2))
    tx, _ = jax_make_optimizer(1e-4, TWIN_STEPS)
    mesh = make_mesh(jax.devices()[:1])
    # the state placed as the step returns it (replicated on the mesh), so
    # that the step compiles once, not again at its second call
    state = jax.device_put(jdt.DetectorState(
        jnp.zeros((), jnp.int32), params, jax.jit(tx.init)(params)),
        replicated(mesh))
    jstep = jdt.make_detector_train_step(model, tx, mesh)

    tmodel = tdet.SSTDetector(_torch_config(TINY), device="cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(params))
    opt, schedule = make_optimizer(tmodel.named_parameters(), 1e-4,
                                   TWIN_STEPS)
    tstep = tdt.make_detector_train_step(tmodel, opt, schedule)

    jl, tl = [], []
    for step in range(TWIN_STEPS):
        jb = first if step == 0 else next(jloader)
        tb = next(tloader)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        state, aux = jstep(state, jb, jax.random.PRNGKey(step))
        got = tstep(step, tb)
        for k in ("loss_cls", "loss_bbox", "loss_dir", "num_pos_anchors",
                  "grad_norm"):
            assert k in got and np.isfinite(float(got[k])), k
        jl.append(float(aux["loss"]))
        tl.append(float(got["loss"]))
    jl, tl = np.asarray(jl), np.asarray(tl)
    rel = np.abs(tl - jl) / np.abs(jl)
    print(f"twin losses jax {jl} port {tl} max rel dev {rel.max():.2e}")
    assert abs(jl[-1] - jl[0]) > 0.05 * jl[0]     # the weights moved
    # the repository's twin-training bar: 6e-3
    assert rel.max() <= 6e-3, rel
    final = convert.state_dict_to_flax(
        {n: p for n, p in tmodel.named_parameters()})
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, state.params))[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(final)[0])
    diffs = {jax.tree_util.keystr(p): np.abs(flat_got[p] - r).max()
             for p, r in flat_ref}
    key_bias = {k for k in diffs if k.endswith("['k']['bias']")}
    worst = max(v for k, v in diffs.items() if k not in key_bias)
    print(f"twin final params max abs diff {worst:.2e}, attention key "
          f"biases {max(diffs[k] for k in key_bias):.2e}")
    # a hundredth of one step at the peak rate (1e-2): atol 1e-4
    assert worst <= 1e-4, diffs
    # the softmax is invariant to the key bias: its exact gradient is 0,
    # and Adam turns the float32 noise there into steps of up to lr in
    # either direction, so the two runs may part by twice the sum of lr
    lr_sum = sum(schedule(s) for s in range(TWIN_STEPS))
    assert all(diffs[k] <= 2 * lr_sum for k in key_bias)
