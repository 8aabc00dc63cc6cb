"""Support code: building the CUDA kernels, profiling, the summary writer,
class names and drawing."""
