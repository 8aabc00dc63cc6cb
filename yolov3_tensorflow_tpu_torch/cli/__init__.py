"""Command-line entry points of the port, those of the JAX package's `cli`:
the image and video demos, training, evaluation, the checkpoint tools
(convert_weights, strip_checkpoint) and the host-only dataset tools
(kmeans_anchors, parse_voc)."""
