"""PyTorch/CUDA port of hypelcnn_tpu: HSI + LiDAR classification on an NVIDIA GPU.

The JAX package ``hypelcnn_tpu`` is the reference this package is held
against in the tests; this package imports torch and numpy, never jax.
"""
