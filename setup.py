"""Packaging (reference ``setup.py:8-45`` packages ``simulation_lib`` as
``distributed_learning_simulator``; here the package is first-class)."""

from setuptools import find_packages, setup

setup(
    name="distributed_learning_simulator_tpu",
    version="0.1.0",
    description=(
        "TPU-native federated/distributed-learning framework "
        "(JAX/XLA/pjit/pallas re-design of distributed_learning_simulator)"
    ),
    python_requires=">=3.11",
    packages=find_packages(
        include=["distributed_learning_simulator_tpu*", "distributed_learning_simulator_tpu_torch*"]
    ),
    package_data={"distributed_learning_simulator_tpu_torch": ["csrc/*.cu"]},
    install_requires=["jax", "flax", "optax", "numpy", "pyyaml"],
    # the PyTorch/CUDA port (distributed_learning_simulator_tpu_torch) needs
    # torch, and nvcc for sm_90a on the machine that runs its kernels
    extras_require={"torch": ["torch", "numpy", "pyyaml"]},
)
