"""Performance-analysis tools: the tensor-core and patch-build probes
(`exp_mxu_shapes`), the roofline (`roofline`) and the stage profiler
(`profile_stages`). Run each with `python -m`."""
