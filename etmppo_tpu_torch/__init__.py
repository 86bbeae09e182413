"""PyTorch/CUDA port of etmppo_tpu (episodic-transformer-memory PPO).

The JAX package ``etmppo_tpu`` is the reference; this package imports neither
it nor JAX. Plain tensor code is PyTorch; the TPU kernels on the ported path
are hand-written CUDA kernels for Hopper (``csrc/``).
"""
__version__ = "0.1.0"
