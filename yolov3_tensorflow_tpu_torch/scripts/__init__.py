"""Performance-analysis tools: the tensor-core and patch-build probes
(`exp_mxu_shapes`), the roofline (`roofline`) and the stage profiler
(`profile_stages`), the overfit-to-mAP gate (`overfit_gate`), the
real-weights parity harness (`parity_demo`), and the measurement scripts:
serving throughput and the decode+NMS p50 (`bench`), the train step
(`bench_train`, `profile_train`), the host loader (`bench_loader`) and the
video demo (`bench_video`). The serving experiments (shared parts in
`experiments`): the selection score's variants beside its read floor
(`exp_score`), the packed postprocess stage by stage (`exp_topk`), its
tail stages alone (`exp_tail`), each stage's cost inside the pipeline
(`exp_pp_incr`), the postprocess variants end to end (`exp_postprocess`),
the stem-int8 hybrid by handoff point (`exp_stem_int8`) and int8 serving
at 896x1344 (`exp_highres_int8`); and the gates' precision by score
cutoff (`analyze_recipe_precision`). Run each with `python -m`; results
go under `build/`."""
