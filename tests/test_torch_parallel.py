"""The port's data parallelism against the JAX package's, on the CPU.

A module-scoped fixture runs two gloo ranks once (spawned processes, two
threads each, `testing.parallel_worker`, a file:// rendezvous under the
test's temporary directory), on YOLOv3 at 64x64, 4 classes, fp32, from one
seeded weight tree (testing.numpy_variables, carried across by
from_jax_variables). Then:

- one data-parallel train step (2 ranks, global batch 4, momentum, lr
  1e-3, per-leaf clip 100) against JAX's `make_dp_train_step` on a 2-device
  mesh of the 8 virtual CPU devices and against the port's single-device
  step on the global batch, with tests/test_torch_train_model.py's
  tolerances: every loss term and every BN moving statistic within 1e-4 of
  its largest magnitude, the detection convs' updates (no batch norm
  before them) within 1e-4 of their largest, every leaf's update, and all
  of them together, in norm within twice the reordering noise plus 1e-4;
  both ranks' new parameters and statistics bit-equal. The noise is the
  larger of JAX's and the port's own, each the distance of its DP step on
  the batch reordered (reversed, and re-partitioned over the ranks: the
  same step mathematically) to its step on the batch. In fp32 the 72
  training-mode batch norms amplify rounding (tests/test_torch_train_model
  .py): a re-partition alone moves backbone/conv_50/beta's update by 5% in
  the port's step and 2% in JAX's, while in float64 the port's DP gradient
  equals its single-device gradient to 1e-13;
- `gather_prediction_rows` and `gather_meter_sums`: exactly the
  concatenation, in rank order, and the sums of the ranks' own;
- `make_sharded_detector` in modes packed and prefilter (spread-head
  weights, 8 images, 4 a rank, bf16 as in the JAX package): every rank gets
  the same whole batch, each rank's rows bit-equal to `build_detector` on
  them in that process, and the detections those of JAX's sharded
  detector on a 2-device mesh by detection identity (same label, IoU >=
  0.9, for every detection scored at least 0.02 above the threshold), both
  ways: at least 95% found, as for the port's stem8 detector in
  tests/test_torch_mode_select.py, since JAX's sharded detector runs bf16
  only and the two packages sum its 75 bf16 convs in other orders (97-98%
  are found here; tests/test_parallel.py asks 99% of JAX's sharded
  detector against its own single-device one).

One JAX train-step compile (the reordered batches reuse it).
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.config import load_config as jax_load_config
from yolov3_tensorflow_tpu.parallel import data_parallel as jdp
from yolov3_tensorflow_tpu.parallel import mesh as jmesh
from yolov3_tensorflow_tpu.parallel.serving import \
    make_sharded_detector as jax_sharded_detector
from yolov3_tensorflow_tpu.train.optimizers import \
    build_optimizer as jax_build_optimizer
from yolov3_tensorflow_tpu.train.schedules import fixed as jax_fixed
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS, load_config
from yolov3_tensorflow_tpu_torch.data.encoder import encode_labels
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.models.yolov3 import DETECTION_CONVS
from yolov3_tensorflow_tpu_torch.ops.postprocess import detections_to_numpy
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS, DP_CLIP,
                                                 DP_LR, DP_OVERRIDES, SCORE_T,
                                                 SHARDED, match_detections,
                                                 numpy_variables,
                                                 parallel_worker)
from yolov3_tensorflow_tpu_torch.train.optimizers import (build_optimizer,
                                                          flatten)
from yolov3_tensorflow_tpu_torch.train.schedules import fixed
from yolov3_tensorflow_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(CPU_TEST_THREADS)

C = 4
SEED = 2                               # numpy_variables' seed
SIZE = 64
BATCH = 4
SERVE_BATCH = 8
WORLD = 2
# the same step mathematically: the batch reversed, and re-partitioned
# ({0, 3} on rank 0, {1, 2} on rank 1)
REORDERS = {"reversed": [3, 2, 1, 0], "repartitioned": [0, 3, 1, 2]}
RTOL = 1e-4
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
CPU = torch.device("cpu")
LOSS_KEYS = ("total", "xy", "wh", "conf", "class", "l2")


def close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


def fro(a, b) -> float:
    """|a - b| / |b| in the Frobenius norm."""
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b))
                 / np.linalg.norm(np.ravel(b)))


def hwio(t) -> np.ndarray:
    """A port leaf in the JAX layout (conv kernels OIHW -> HWIO)."""
    a = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a


def inputs():
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    grids = []
    for _ in range(BATCH):
        xy = rng.uniform(0, 40, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (3, 2))], 1)
        grids.append(encode_labels(boxes.astype(np.float32),
                                   rng.integers(0, C, 3), (SIZE, SIZE), C,
                                   ANCHORS))
    y_true = [np.stack([g[s] for g in grids]) for s in range(3)]
    serve = rng.uniform(0, 1, (SERVE_BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return images, y_true, serve


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The two ranks' results, the JAX-layout weights and the inputs."""
    directory = tmp_path_factory.mktemp("dp")
    jvars = numpy_variables(C, seed=SEED)
    images, y_true, serve = inputs()
    torch.save({"num_classes": C, "seed": SEED,
                "images": torch.from_numpy(images),
                "y_true": [torch.from_numpy(y) for y in y_true],
                "reorders": REORDERS,
                "serve_images": torch.from_numpy(serve)},
               directory / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=parallel_worker,
                         args=(rank, WORLD, str(directory)))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [torch.load(directory / f"rank{r}.pt", weights_only=True)
             for r in range(WORLD)]
    for f in directory.glob("*.pt"):          # ~0.25 GB of parameters
        f.unlink()
    return ranks, jvars, images, y_true, serve


@pytest.fixture(scope="module")
def jax_steps(case):
    """JAX's DP step on the batch and on each reordering: name ("batch" or
    a REORDERS key) -> (new params, new batch stats, metrics), numpy, JAX
    layout."""
    _, jvars, images, y_true, _ = case
    cfg = jax_load_config(None, list(DP_OVERRIDES)
                          + [f"model.num_classes={C}"]).finalize(
                              count_files=False)
    opt = jax_build_optimizer("momentum", jax_fixed(DP_LR),
                              grad_clip_norm=DP_CLIP)
    mesh = jmesh.make_data_mesh(WORLD)
    step = jdp.make_dp_train_step(cfg, opt, mesh)
    out = {}
    for name, order in {"batch": list(range(BATCH)), **REORDERS}.items():
        params = jax.tree_util.tree_map(jnp.asarray, jvars["params"])
        state = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(
                     jnp.asarray, jvars["batch_stats"]),
                 "opt_state": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        new, metrics = step(
            jmesh.replicate(mesh, state),
            jmesh.shard_batch(mesh, jnp.asarray(images[order])),
            tuple(jmesh.shard_batch(mesh, jnp.asarray(y[order]))
                  for y in y_true))
        out[name] = jax.device_get((new["params"], new["batch_stats"],
                                    metrics))
    return out


@pytest.fixture(scope="module")
def noise(case, jax_steps):
    """(per-leaf noise, noise of all updates together): the largest
    relative distance of a reordered DP step's updates to its step's, over
    JAX's steps and the port's (module doc)."""
    ranks, jvars, *_ = case
    old = flatten(jvars["params"])

    def updates(params):
        return {p: np.asarray(params[p], np.float64) - old[p] for p in old}

    j = updates(flatten(jax_steps["batch"][0]))
    leaf, whole = 0.0, 0.0
    for name in REORDERS:
        jr = updates(flatten(jax_steps[name][0]))
        leaf = max(leaf, max(fro(jr[p], j[p]) for p in old))
        whole = max(whole, fro(np.concatenate([jr[p].ravel() for p in old]),
                               np.concatenate([j[p].ravel() for p in old])))
        port = ranks[0]["noise"][name]
        leaf = max(leaf, max(port["leaves"].values()))
        whole = max(whole, port["all"])
    assert 0 < whole < 2e-2 and 0 < leaf < 0.1, (whole, leaf)
    return leaf, whole


@pytest.fixture(scope="module")
def single_step(case):
    """The port's single-device step on the whole global batch."""
    _, jvars, images, y_true, _ = case
    cfg = load_config(None, DP_OVERRIDES + (f"model.num_classes={C}",)
                      ).finalize(count_files=False)
    opt = build_optimizer("momentum", fixed(DP_LR), grad_clip_norm=DP_CLIP)
    v = from_jax_variables(jvars, device=CPU)
    state = {"params": v["params"], "batch_stats": v["batch_stats"],
             "opt_state": opt.init(v["params"]), "step": 0}
    new, metrics = make_train_step(cfg, opt)(
        state, torch.from_numpy(images),
        tuple(torch.from_numpy(y) for y in y_true))
    return new["params"], new["batch_stats"], metrics


def check_step(got, want, noise, jvars, what):
    """got / want: (params, batch_stats, metrics) in the JAX layout (numpy
    leaves, flattened paths); noise: the `noise` fixture; the tolerances of
    the module doc."""
    for k in LOSS_KEYS:
        close(float(got[2][k]), float(want[2][k]), what=f"{what} loss {k}")
    assert set(got[1]) == set(want[1]) and len(want[1]) == 72 * 2
    for p in want[1]:
        close(got[1][p], want[1][p], what=f"{what} BN statistics {p}")
    old = flatten(jvars["params"])
    u, w = ({p: np.asarray(t[0][p], np.float64) - old[p] for p in old}
            for t in (got, want))
    for name in DETECTION_CONVS:
        for k in ("w", "b"):
            p = f"head/{name}/{k}"
            close(u[p], w[p], what=f"{what} update of {p}")
    leaf_noise, whole_noise = noise
    assert fro(np.concatenate([u[p].ravel() for p in old]),
               np.concatenate([w[p].ravel() for p in old])) \
        <= 2 * whole_noise + RTOL, what
    for p in old:
        assert fro(u[p], w[p]) <= 2 * leaf_noise + RTOL, f"{what} {p}"


def port_step(params, stats, metrics):
    """A port step's results in check_step's form."""
    return ({p: hwio(t) for p, t in flatten(params).items()},
            {p: t.numpy() for p, t in flatten(stats).items()},
            {k: float(metrics[k]) for k in LOSS_KEYS})


def jax_form(params, stats, metrics):
    return (flatten(params), flatten(stats),
            {k: float(metrics[k]) for k in LOSS_KEYS})


def test_dp_step_matches_jax(case, jax_steps, noise):
    ranks, jvars, *_ = case
    r0 = ranks[0]
    check_step(port_step(r0["params"], r0["batch_stats"], r0["metrics"]),
               jax_form(*jax_steps["batch"]), noise, jvars,
               "port DP vs JAX DP")


def test_dp_step_matches_single_device_step(case, single_step, noise):
    ranks, jvars, *_ = case
    r0 = ranks[0]
    check_step(port_step(r0["params"], r0["batch_stats"], r0["metrics"]),
               port_step(*single_step), noise, jvars,
               "port DP vs port single device")


def test_dp_ranks_stay_replicas(case):
    """Averaged gradients and synced moments: both ranks hold the same
    parameters and statistics after the step, bit for bit, and report the
    same (averaged) metrics."""
    ranks, *_ = case
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for k in LOSS_KEYS:
        assert torch.equal(ranks[0]["metrics"][k], ranks[1]["metrics"][k])


def test_gathers_are_exact(case):
    ranks, *_ = case
    rows = [r for rank in ranks for r in rank["rows_local"]]
    assert len(rows) == 2 + 5
    for rank in ranks:
        assert rank["rows"] == rows       # float32 values survive exactly
    for rank in ranks:
        for k, (s, n, avg) in rank["meters"].items():
            sums = [other["meters_local"][k] for other in ranks]
            assert s == sum(x[0] for x in sums)
            assert n == sum(x[1] for x in sums)
            assert avg == s / n


@pytest.mark.parametrize("mode", ["packed", "prefilter"])
def test_sharded_detector(case, mode):
    ranks, jvars, _, _, serve = case
    per = SERVE_BATCH // WORLD
    whole = ranks[0][mode]["whole"]
    assert whole["boxes"].shape == (SERVE_BATCH, C * SHARDED["max_out"], 4)
    for r, rank in enumerate(ranks):
        for k, t in whole.items():
            assert torch.equal(rank[mode]["whole"][k], t), (r, k)
            assert torch.equal(t[r * per:(r + 1) * per],
                               rank[mode]["slice"][k]), (r, k)

    spread = spread_head(jvars, seed=0)
    jdet = jax_sharded_detector(spread, ANCHORS, C, (SIZE, SIZE),
                                jmesh.make_data_mesh(WORLD), mode=mode,
                                use_pallas=False, **SHARDED)
    want = jax.device_get(jdet(jmesh.shard_batch(
        jmesh.make_data_mesh(WORLD), jnp.asarray(serve))))

    def jax_dets(i):
        v = want["valid"][i].astype(bool)
        return want["boxes"][i][v], want["scores"][i][v], want["labels"][i][v]

    g = [detections_to_numpy(whole, i) for i in range(SERVE_BATCH)]
    w = [jax_dets(i) for i in range(SERVE_BATCH)]
    n_w, found_w = match_detections(w, g, SCORE_T + 0.02)
    n_g, found_g = match_detections(g, w, SCORE_T + 0.02)
    assert n_w >= 20 and n_g >= 20, (n_w, n_g)
    assert found_w >= 0.95 * n_w and found_g >= 0.95 * n_g, \
        (found_w, n_w, found_g, n_g)
