"""Performance-analysis tools: the tensor-core and patch-build probes
(`exp_mxu_shapes`), the roofline (`roofline`) and the stage profiler
(`profile_stages`), and the overfit-to-mAP gate (`overfit_gate`). Run each
with `python -m`."""
