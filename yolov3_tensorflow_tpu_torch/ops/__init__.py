"""Box ops, NMS (CUDA kernel + plain version) and the serving postprocess."""
