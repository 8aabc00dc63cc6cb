"""Performance-analysis tools: the tensor-core and patch-build probes
(`exp_mxu_shapes`), the roofline (`roofline`) and the stage profiler
(`profile_stages`), the overfit-to-mAP gate (`overfit_gate`), the
real-weights parity harness (`parity_demo`), and the measurement scripts:
serving throughput and the decode+NMS p50 (`bench`), the train step
(`bench_train`, `profile_train`), the host loader (`bench_loader`) and the
video demo (`bench_video`). Run each with `python -m`."""
