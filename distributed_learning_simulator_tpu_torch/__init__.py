"""PyTorch/CUDA port of ``distributed_learning_simulator_tpu``.

The JAX package beside it is the reference: this package mirrors its module
paths and names, imports ``torch`` and nothing of JAX, and runs its hand-
written Hopper kernels (``csrc/``) on an NVIDIA H100.  Entry points run on
CUDA unless the caller asks for ``device="cpu"``.
"""
