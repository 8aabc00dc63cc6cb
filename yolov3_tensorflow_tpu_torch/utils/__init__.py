"""Support code: building the CUDA kernels, profiling, the summary writer,
class names, drawing and the anchor k-means."""
