"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a, built with
nvcc at first use) and their plain PyTorch versions; see ``ops``."""
