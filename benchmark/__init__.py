"""The benchmark of yolov3_tensorflow_tpu_torch: one command runs one cell
(`python3 -m benchmark.run`); every configuration, traffic mix, loop and
per-layer metric is a file of its own, found by name from
`BENCHMARK.json`."""
