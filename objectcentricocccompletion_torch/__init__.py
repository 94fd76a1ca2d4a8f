"""objectcentricocccompletion_torch: the PyTorch / CUDA counterpart of
``objectcentricocccompletion_tpu``, for one NVIDIA H100 (Hopper, sm_90a).

The layout mirrors the JAX package module for module (``ops/voxelize.py``
here is the counterpart of ``ops/voxelize.py`` there), so each piece can be
held against its reference. Inside, the code is PyTorch's own idiom:
``nn.Module``s and plain functions on tensors, an explicit ``device``
argument, explicit ``torch.Generator``s for initialisation and data.

Every kernel that the JAX package wrote in Pallas for the TPU is a kernel
written by hand here (``csrc/``), built with ``nvcc`` at first use into
``build/`` at the repository root. A wrapper dispatches on the device of the
tensor it is given: a CUDA tensor goes to the kernel, a CPU tensor to the
kernel's plain PyTorch version. Nothing falls back from one to the other.

This package imports neither JAX nor anything of the JAX package; it keeps
its own copy of what it needs.
"""

__version__ = "0.1.0"
