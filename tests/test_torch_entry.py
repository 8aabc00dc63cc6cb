"""The port's graft entry points (`yolov3_tensorflow_tpu_torch.entry`)
against the JAX repository's `__graft_entry__.py`, on the CPU.

- `make_entry_fn` on JAX's own seed-0 COCO-80 tree (`init_yolov3(
  PRNGKey(0), 80)`, carried across by `from_jax_variables`), plain and with
  the head spread (`models.convert.spread_head` on the numpy tree given to
  both packages, so that NMS has work at 0.3), on one seeded 416^2 image:
  - fp32 compute against JAX's entry composition folded in fp32: the same
    detections both ways (same label, IoU >= 0.9) and the same number of
    valid detections;
  - bf16, against JAX's `__graft_entry__.entry()` program itself, jitted,
    with its packed head outputs returned beside its detections: the
    port's postprocess on those outputs gives JAX's detections as a set
    (the same count, labels and scores, boxes to 1e-4), and the port's
    bf16 packed forward lies close to JAX's. The two
    frameworks sum each conv in another order, so about half of the bf16
    outputs differ by a step; at 416^2, where the random-init scores
    crowd the 0.3 threshold and overlapping candidates, that moves the
    top-64 candidates and NMS's order, so the two whole bf16 pipelines
    share most but not all of their detections: at least BF16_SHARED of
    each side's are found in the other's (the test prints how many). The
    fp32 comparison holds the whole program.
  On the CPU JAX's `approx_max_k` selects what the exact top-k selects
  here: the port's exact top-k gives JAX's detections on JAX's outputs.
- `entry(device="cpu")`: JAX's example (8 zero 416^2 images, float32) and
  the output contract (keys, shapes, dtypes).
- `dryrun_multichip(2, device="cpu")`: two spawned ranks over gloo with a
  file:// rendezvous; both losses finite, JAX's 99% rule on the sharded
  detections, and the first step's loss equal to the single-process
  `make_train_step` loss on the whole 2-image batch (sync batch norm and
  averaged gradients make them one step; tests/test_torch_parallel.py
  holds that step to JAX's).
- `entry()` without a device asks for CUDA, and raises where there is none;
  the module's main runs both on the CPU when asked.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models import yolov3 as jy
from yolov3_tensorflow_tpu.ops import fast_postprocess as jfp
from yolov3_tensorflow_tpu_torch import entry as E
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS, Config
from yolov3_tensorflow_tpu_torch.models.convert import (from_jax_variables,
                                                        spread_head)
from yolov3_tensorflow_tpu_torch.models.yolov3 import (fold_batch_norm,
                                                       init_yolov3)
from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as tfp
from yolov3_tensorflow_tpu_torch.ops.postprocess import detections_to_numpy
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 match_detections)
from yolov3_tensorflow_tpu_torch.train.optimizers import build_optimizer
from yolov3_tensorflow_tpu_torch.train.schedules import fixed
from yolov3_tensorflow_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
ROOT = Path(__file__).resolve().parent.parent
BF16_SHARED = 0.75     # whole bf16 programs: least share of shared detections


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", ROOT / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_tree():
    return jax.device_get(jy.init_yolov3(jax.random.PRNGKey(0), 80))


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(
        0, 1, (1, 416, 416, 3)).astype(np.float32)


def _dets(out, i=0):
    """Image i's valid (boxes, scores, labels), numpy."""
    if isinstance(out["valid"], torch.Tensor):
        return detections_to_numpy(out, i)
    v = np.asarray(out["valid"][i]).astype(bool)
    return tuple(np.asarray(out[k][i])[v] for k in ("boxes", "scores",
                                                    "labels"))


def _sorted(dets):
    boxes, scores, labels = dets
    order = np.lexsort((boxes[:, 3], boxes[:, 2], boxes[:, 1], boxes[:, 0],
                        scores, labels))
    return boxes[order], scores[order], labels[order]


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.maximum(np.abs(a), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8).astype(np.float32)


@pytest.mark.parametrize("spread", [False, True], ids=["plain", "spread"])
def test_entry_fn_fp32_matches_jax(spread, jax_tree, image):
    tree = spread_head(jax_tree, seed=0) if spread else jax_tree
    jp = jfp.pack_serving_head(jy.fold_batch_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), dtype=jnp.float32), 80)
    want = jax.device_get(jax.jit(lambda im: jfp.postprocess_packed(
        jfp.yolov3_forward_packed(jp, im, compute_dtype=jnp.float32),
        ANCHORS, 80, (416, 416), **E.SERVING))(jnp.asarray(image)))
    got = E.make_entry_fn(from_jax_variables(tree, device=CPU), CPU,
                          compute_dtype=torch.float32)(
        torch.from_numpy(image))
    w, g = [_dets(want)], [_dets(got)]
    n_w, found_w = match_detections(w, g, 0.0)
    n_g, found_g = match_detections(g, w, 0.0)
    assert n_w >= 50, n_w
    assert (found_w, found_g) == (n_w, n_g) and n_w == n_g, \
        (found_w, n_w, found_g, n_g)
    assert sorted(w[0][2].tolist()) == sorted(g[0][2].tolist())


@pytest.mark.parametrize("spread", [False, True], ids=["plain", "spread"])
def test_entry_fn_bf16_matches_jax_entry(spread, jax_tree, image,
                                         monkeypatch):
    tree = spread_head(jax_tree, seed=0) if spread else jax_tree
    original = jfp.postprocess_packed

    def with_outputs(outs, *args, **kw):
        return {**original(outs, *args, **kw), "outs": tuple(outs)}

    # JAX's entry() builds from init_yolov3(PRNGKey(0), 80): give it the
    # tree under test, and have its program return its head outputs too
    monkeypatch.setattr(jy, "init_yolov3", lambda key, c: jax.tree_util
                        .tree_map(jnp.asarray, tree))
    monkeypatch.setattr(jfp, "postprocess_packed", with_outputs)
    fn, (example,) = _graft().entry()
    monkeypatch.undo()
    assert example.shape == (8, 416, 416, 3) and example.dtype == jnp.float32
    want = jax.device_get(jax.jit(fn)(jnp.asarray(image)))
    j_outs = [torch.from_numpy(np.asarray(o, np.float32)).to(torch.bfloat16)
              for o in want["outs"]]

    # the port's postprocess on JAX's outputs: JAX's detections
    got = _sorted(_dets(tfp.postprocess_packed(
        j_outs, ANCHORS, 80, (416, 416), **E.SERVING)))
    ref = _sorted(_dets(want))
    assert len(ref[1]) >= 50, len(ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)

    # the port's bf16 packed forward (make_entry_fn's) against JAX's
    packed = tfp.pack_serving_head(fold_batch_norm(
        from_jax_variables(tree, device=CPU), dtype=torch.bfloat16), 80)
    with torch.inference_mode():
        p_outs = tfp.yolov3_forward_packed(packed, torch.from_numpy(image))
    # within 2 bf16 steps of max(|value|, 0.5), the rule for bf16 convs
    # summed in another order (tests/test_torch_exp_scripts.py); spread_head
    # multiplies the detection kernels by 8, and with them the body's
    # absolute differences, so its floor is 8 times 0.5: above the floor
    # the same 2 steps, under it 8 times the plain floor's
    floor = 0.5 * (8 if spread else 1)
    for p, j in zip(p_outs, j_outs):
        assert p.shape == j.shape and p.dtype == torch.bfloat16
        p, j = p.float().numpy(), j.float().numpy()
        mag = np.maximum(np.maximum(np.abs(p), np.abs(j)), floor)
        assert (np.abs(p - j) <= 2 * _bf16_ulp(mag)).all()

    # end to end in bf16: most detections shared both ways (readings: 73
    # of 88 and 73 of 84 plain, 48 of 56 and 48 of 55 spread)
    w = [_dets(want)]
    g = [_dets(E.make_entry_fn(from_jax_variables(tree, device=CPU), CPU)(
        torch.from_numpy(image)))]
    (n_w, found_w), (n_g, found_g) = (match_detections(w, g, 0.0),
                                      match_detections(g, w, 0.0))
    print(f"bf16 entry programs, {'spread' if spread else 'plain'}: the "
          f"port finds {found_w} of JAX's {n_w} detections, JAX {found_g} "
          f"of the port's {n_g}")
    assert found_w >= BF16_SHARED * n_w and found_g >= BF16_SHARED * n_g, \
        (found_w, n_w, found_g, n_g)


def test_entry_on_the_cpu_keeps_the_contract():
    fn, example = E.entry(device="cpu")
    assert len(example) == 1
    x = example[0]
    assert x.shape == (8, 416, 416, 3) and x.dtype == torch.float32
    assert x.device == CPU and not x.any()
    out = fn(x[:1])
    assert set(out) == {"boxes", "scores", "labels", "valid"}
    assert out["boxes"].shape == (1, 80 * 128, 4)
    for key, dtype in (("boxes", torch.float32), ("scores", torch.float32),
                       ("labels", torch.int32), ("valid", torch.bool)):
        assert out[key].dtype == dtype, key
    for key in ("scores", "labels", "valid"):
        assert out[key].shape == (1, 80 * 128), key
    assert torch.isfinite(out["boxes"]).all()


def test_entry_without_a_device_asks_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.dryrun_multichip(1)


def test_dryrun_multichip_two_ranks_on_gloo(monkeypatch, capfd):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    got = E.dryrun_multichip(2, device="cpu")
    printed = capfd.readouterr().out
    assert got["backend"] == "gloo" and got["nms_shared_launches"] == 0
    assert got["nms_shared_max_err"] == 0.0
    assert np.isfinite(got["loss"]) and np.isfinite(got["loss_aug"])
    assert got["total"] > 0 and got["found"] >= 0.99 * got["total"]
    for line in ("dryrun_multichip(2): ok, loss=",
                 "dryrun_multichip(2): device-augment step ok, loss=",
                 "dryrun_multichip(2): sharded serving step ok, "
                 f"{got['found']}/{got['total']} detections reproduced"):
        assert line in printed

    # one process, the whole batch: the same step
    cfg = Config()
    cfg.model.num_classes = E.DRY_CLASSES
    cfg.finalize(count_files=False)
    v = init_yolov3(torch.Generator().manual_seed(0), E.DRY_CLASSES,
                    device=CPU)
    opt = build_optimizer("momentum", fixed(1e-3), grad_clip_norm=100.0)
    inp = {k: torch.from_numpy(x) for k, x in E.dry_inputs(2).items()}
    _, metrics = make_train_step(cfg, opt)(
        {"params": v["params"], "batch_stats": v["batch_stats"],
         "opt_state": opt.init(v["params"]), "step": 0},
        inp["images"], tuple(inp[f"y_true{i}"] for i in range(3)))
    assert abs(got["loss"] - float(metrics["total"])) <= 1e-5 * abs(
        float(metrics["total"]))


def test_main_runs_both_on_the_cpu(monkeypatch, capfd):
    """`python -m yolov3_tensorflow_tpu_torch.entry --device cpu`: the
    program on the example, then the dry run over one rank, as the JAX
    module's main runs them over its devices."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert E.main(["--device", "cpu"]) == 0
    printed = capfd.readouterr().out
    assert "entry: ok {'boxes': (8, 10240, 4), 'scores': (8, 10240)" in printed
    assert "dryrun_multichip(1): sharded serving step ok" in printed


def test_reproduced_is_jax_rule():
    """found/total: only reference detections scored >= 0.27 count; a
    match needs the label, every coordinate within 1 px and the score
    within 5e-3."""
    ref = {"boxes": np.asarray([[[0, 0, 10, 10], [5, 5, 9, 9],
                                 [0, 0, 4, 4]]], np.float32),
           "scores": np.asarray([[0.5, 0.26, 0.4]], np.float32),
           "labels": np.asarray([[1, 1, 2]], np.int32),
           "valid": np.asarray([[True, True, True]])}
    near = {"boxes": ref["boxes"] + 0.9, "scores": ref["scores"] + 4e-3,
            "labels": ref["labels"], "valid": ref["valid"]}
    assert E.reproduced(ref, near) == (2, 2)
    far = dict(near, boxes=ref["boxes"] + 1.0)
    assert E.reproduced(ref, far) == (0, 2)
    relabeled = dict(near, labels=ref["labels"] + 1)
    assert E.reproduced(ref, relabeled) == (0, 2)
    invalid = dict(near, valid=np.zeros_like(ref["valid"]))
    assert E.reproduced(ref, invalid) == (0, 2)
