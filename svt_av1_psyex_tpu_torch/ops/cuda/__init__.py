"""Hand-written Hopper kernels (CUDA C++ for sm_90a), built at first use."""
