"""Support code: building the CUDA kernels."""
