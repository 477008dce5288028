"""Hand-written Hopper kernels of the port (built at first CUDA use)."""
