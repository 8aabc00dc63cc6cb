"""Performance-analysis tools: the tensor-core and patch-build probes
(`exp_mxu_shapes`), the roofline (`roofline`) and the stage profiler
(`profile_stages`), the overfit-to-mAP gate (`overfit_gate`) and the
real-weights parity harness (`parity_demo`). Run each with `python -m`."""
