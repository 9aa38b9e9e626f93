"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their wrappers."""
