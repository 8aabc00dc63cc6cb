"""Command-line entry points of the port: the image and video demos and
training (the JAX package's `cli` without evaluate, convert_weights,
strip_checkpoint, kmeans_anchors and parse_voc, which are not ported yet)."""
