"""Hand-written CUDA kernels (sources in ../csrc), their build and their wrappers."""
