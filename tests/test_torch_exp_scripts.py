"""The port's serving experiments against the JAX scripts' computations, on
the CPU.

The JAX variants live inside the JAX scripts' `main()` and cannot be
imported, so each is restated here in a few lines of `jnp`, next to the
port's. Both packages' packed head outputs are built at 64^2 (COCO-80, the
same seeded variables: the port's through `from_jax_variables`), by JAX in
fp32 and in bf16; JAX's outputs then go into both packages' stage
computations, so that each stage is compared on the same inputs:

- exp_score's v0-v4 sums equal JAX's (rtol 1e-5; the bf16 v4 rounds each
  term as JAX's bf16 logistic does, so its terms are equal and only the
  order of the fp32 sum differs);
- exp_topk's stable-sort selection equals `lax.top_k`'s indices;
- exp_tail's gather+decode boxes equal JAX's `postprocess_packed`
  internals (the cell gather and the decode tables) within 1e-4 px;
- exp_pp_incr's last stage gives `build_detector(mode="packed")`'s
  detections bit for bit;
- the stem8 detectors of exp_stem_int8 and exp_highres_int8 at upto 4 and
  9: the int8 region's output (the input of the first bf16 conv)
  bit-equal to JAX's unjitted `yolov3_forward_stem_int8_packed`'s; the
  packed outputs, which the bf16 remainder sums in another order than
  XLA (about half of them differ at COCO-80), within 2 bf16 steps, the
  bound tests/test_torch_quantize.py holds them to;
- every script's main runs with `--device cpu` at a tiny size, exits 0
  and prints its JSON record last; `--device cuda` without CUDA exits.
"""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu.models import layers as jax_layers
from yolov3_tensorflow_tpu.models.yolov3 import fold_batch_norm as jfold
from yolov3_tensorflow_tpu.ops import fast_postprocess as jfp
from yolov3_tensorflow_tpu.ops import quantize as jq
from yolov3_tensorflow_tpu_torch.models.convert import from_jax_variables
from yolov3_tensorflow_tpu_torch.models.yolov3 import fold_batch_norm as tfold
from yolov3_tensorflow_tpu_torch.ops import fast_postprocess as tfp
from yolov3_tensorflow_tpu_torch.ops import quantize as tq
from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector
from yolov3_tensorflow_tpu_torch.scripts import (
    analyze_recipe_precision, bench, exp_highres_int8, exp_postprocess,
    exp_pp_incr, exp_score, exp_stem_int8, exp_tail, exp_topk, experiments)
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
C = 80
SIZE = 64
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def variables():
    jvars = numpy_variables(C, seed=0)
    images = np.random.default_rng(0).uniform(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    return jvars, from_jax_variables(jvars, device=CPU), images


@pytest.fixture(scope="module")
def packed(variables):
    """dtype -> (JAX's packed outputs, the same values as torch tensors),
    after holding the port's own packed outputs close to JAX's."""
    jvars, tvars, images = variables
    out = {}
    for name, (jdt, tdt) in DTYPES.items():
        jp = jfp.pack_serving_head(jfold(jvars, dtype=jdt), C, out_dtype=jdt)
        want = jax.jit(lambda im, jp=jp, jdt=jdt: jfp.yolov3_forward_packed(
            jp, im, compute_dtype=jdt, out_dtype=jdt))(jnp.asarray(images))
        tp = tfp.pack_serving_head(tfold(tvars, dtype=tdt), C,
                                   out_dtype=tdt)
        with torch.inference_mode():
            got = tfp.yolov3_forward_packed(tp, torch.from_numpy(images),
                                            compute_dtype=tdt, out_dtype=tdt)
        for g, w in zip(got, want):
            w32 = np.asarray(w, np.float32)
            g32 = g.float().numpy()
            assert g32.shape == w32.shape
            tol = 1e-4 if tdt == torch.float32 else 0.05
            assert np.abs(g32 - w32).max() <= tol * np.abs(w32).max()
        out[name] = (want, [torch.from_numpy(np.array(w, np.float32))
                            .to(tdt) for w in want])
    return out


# --- the JAX scripts' computations, restated --------------------------------

def _jax_score_variants(po):
    """scripts/exp_score.py's v0-v4 (its feedback scalar at 0)."""
    row = jfp.head_row_width(C)
    lane = jax.lax.broadcasted_iota(jnp.int32, (row,), 0)
    addmask = jnp.where(lane < C, 0.0, -1e4).astype(jnp.bfloat16)
    neg = jnp.asarray(-jnp.inf, po[0].dtype)
    sig = jax.nn.sigmoid
    out = {k: jnp.float32(0) for k in ("v0", "v1", "v2", "v3", "v4")}
    for p_ in po:
        bb, hg, wg, _ = p_.shape
        pc = p_.reshape(bb, hg * wg, 3 * row)
        for a3 in range(3):
            blk = pc[..., a3 * row:(a3 + 1) * row]
            conf = blk[..., C].astype(jnp.float32)
            m0 = jnp.max(jnp.where(lane < C, blk, neg), -1).astype(jnp.float32)
            out["v0"] += jnp.sum(sig(conf) * sig(m0))
            m1 = jnp.max(blk + addmask.astype(blk.dtype), -1).astype(
                jnp.float32)
            out["v1"] += jnp.sum(sig(conf) * sig(m1))
            b4 = p_[..., a3 * row:(a3 + 1) * row]
            m2 = jnp.max(jnp.where(lane < C, b4, neg), -1).astype(jnp.float32)
            out["v2"] += jnp.sum(sig(b4[..., C].astype(jnp.float32))
                                 * sig(m2))
            out["v3"] += jnp.sum(sig(p_[..., a3 * row + C].astype(
                jnp.float32)))
            m4 = jnp.max(blk + addmask.astype(blk.dtype), -1)
            out["v4"] += jnp.sum((sig(blk[..., C]) * sig(m4)).astype(
                jnp.float32))
    return {k: float(v) for k, v in out.items()}


def _jax_scores_cm(po):
    """scripts/exp_topk.py's scores_cm (fp32 selection score)."""
    row = jfp.head_row_width(C)
    lane = jax.lax.broadcasted_iota(jnp.int32, (row,), 0)
    neg = jnp.asarray(-jnp.inf, po[0].dtype)
    objs = []
    for p_ in po:
        bb, hg, wg, _ = p_.shape
        pc = p_.reshape(bb, hg * wg, 3 * row)
        obj_a = []
        for a3 in range(3):
            blk = pc[..., a3 * row:(a3 + 1) * row]
            lane_max = jnp.max(jnp.where(lane < C, blk, neg), -1).astype(
                jnp.float32)
            conf = blk[..., C].astype(jnp.float32)
            obj_a.append(jax.nn.sigmoid(conf) * jax.nn.sigmoid(lane_max))
        objs.append(jnp.stack(obj_a, -1).reshape(bb, hg * wg * 3))
    return jnp.concatenate(objs, axis=1)


def _jax_gather_decode(po, idx):
    """scripts/exp_tail.py's s_gather_decode, to boxes [B, K, 4] xyxy."""
    row = jfp.head_row_width(C)
    offsets, cells, off = [], [], 0
    for p_ in po:
        offsets.append(off)
        cells.append(p_.shape[1] * p_.shape[2])
        off += p_.shape[1] * p_.shape[2] * 3
    pcs = [p_.reshape(p_.shape[0], -1, 3 * row) for p_ in po]
    rows = jfp._gather_cells_per_scale(pcs, idx, offsets, cells, row)
    tx, ty, rw, rh, aw, ah = (jnp.asarray(t) for t in jfp._decode_tables(
        SIZE, SIZE, tuple(ANCHORS.reshape(-1).tolist())))
    box = rows[..., C + 1:C + 5].astype(jnp.float32)
    cx = (jax.nn.sigmoid(box[..., 0]) + jnp.take(tx, idx)) * jnp.take(rw, idx)
    cy = (jax.nn.sigmoid(box[..., 1]) + jnp.take(ty, idx)) * jnp.take(rh, idx)
    w = jnp.exp(box[..., 2]) * jnp.take(aw, idx)
    h = jnp.exp(box[..., 3]) * jnp.take(ah, idx)
    return np.asarray(jnp.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                 cy + h / 2], -1))


# --- stage parity -----------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exp_score_variants_match_jax(packed, dtype):
    jouts, touts = packed[dtype]
    want = _jax_score_variants(jouts)
    with torch.inference_mode():
        got = {name.split()[0]: float(fn(touts)) for name, fn in
               exp_score.variants(C, CPU).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # v0 is the port's own selection score, the one the detector ranks by
    np.testing.assert_allclose(
        got["v0"], float(tfp.packed_scores(touts, C).sum()), rtol=1e-6)
    assert exp_score.read_floor_ms(touts) > 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exp_topk_sort_matches_lax_top_k(packed, dtype):
    jouts, touts = packed[dtype]
    jobj = _jax_scores_cm(jouts)
    _, want = jax.lax.top_k(jobj, exp_topk.K)
    with torch.inference_mode():
        obj = tfp.packed_scores(touts, C)
        got = tfp.top_candidates(obj, exp_topk.K)
        alt = exp_topk.topk_indices(obj, exp_topk.K)
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # torch.topk selects the same values (its tie order is its own)
    np.testing.assert_array_equal(obj.gather(1, alt).numpy(),
                                  obj.gather(1, got).numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exp_tail_gather_decode_matches_jax(packed, dtype):
    jouts, touts = packed[dtype]
    anchors = sum(p.shape[1] * p.shape[2] * 3 for p in touts)
    cand = exp_tail.random_candidates(2, anchors, CPU)
    tables = tfp.decode_tables((SIZE, SIZE), ANCHORS, device=CPU)
    with torch.inference_mode():
        boxes, scores = tfp.packed_decode(touts, cand, C, tables)
    want = _jax_gather_decode(jouts, jnp.asarray(cand.numpy()))
    np.testing.assert_allclose(boxes.numpy(), want, rtol=0, atol=1e-4)
    assert scores.shape == (2, exp_tail.K, C)


def test_packed_candidates_is_its_stages(packed):
    """The refactor into packed_scores / top_candidates / packed_decode
    keeps packed_candidates' outputs, and both score dtypes rank."""
    _, touts = packed["bfloat16"]
    tables = tfp.decode_tables((SIZE, SIZE), ANCHORS, device=CPU)
    for sdt in (None, "bf16"):
        boxes, scores = tfp.packed_candidates(touts, C, tables, 64,
                                              score_dtype=sdt)
        cand = tfp.top_candidates(tfp.packed_scores(touts, C, sdt), 64)
        b2, s2 = tfp.packed_decode(touts, cand, C, tables)
        assert torch.equal(boxes, b2) and torch.equal(scores, s2)


def test_exp_pp_incr_last_stage_is_the_packed_detector():
    variables = bench.serving_variables(CPU)
    det = bench.packed_detector(variables, (SIZE, SIZE), CPU)
    images = bench.bench_images(2, (SIZE, SIZE), CPU)
    stages = exp_pp_incr.stages(det, images)
    names = [s[0] for s in stages]
    assert names[-1] == "full" and set(exp_pp_incr.CHAIN) <= set(names)
    assert [s[2] for s in stages] == [n.startswith("full") for n in names]
    with torch.inference_mode():
        got = stages[-1][1]()
    want = build_detector(variables, ANCHORS, C, (SIZE, SIZE), device=CPU,
                          compute_dtype=torch.bfloat16, mode="packed",
                          **experiments.SERVING)(images)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert bool(want["valid"].any())


def _handoff(module, attr, forward):
    """The int8 region's output: the input of the forward's first bf16
    conv (module.attr, patched to stop there)."""
    class Handoff(Exception):
        pass

    def stop(x, *args, **kw):
        raise Handoff(x)

    with mock.patch.object(module, attr, stop):
        try:
            forward()
        except Handoff as h:
            return h.args[0]
    raise AssertionError("the stem8 forward reached no bf16 conv")


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.maximum(np.abs(a), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8).astype(np.float32)


@pytest.mark.parametrize("upto", [4, 9])
def test_stem8_detectors_match_jax_unjitted(variables, upto):
    jvars, tvars, images = variables
    scales = jq.calibrate_activation_scales(jvars, jnp.asarray(images))
    jhp = jq.build_stem_int8_packed(jvars, scales, C, upto=upto)
    dets = dict(exp_stem_int8.detectors(tvars, scales, (upto,),
                                        (SIZE, SIZE), CPU, int8_packed=True))
    assert list(dets) == ["bf16 packed", "int8-packed", f"stem8 upto={upto}"]
    det = dets[f"stem8 upto={upto}"]
    timg = torch.from_numpy(images)
    with torch.inference_mode():
        got = det.forward_fn(det.params, timg)
        got_h = _handoff(tq, "conv_folded",
                         lambda: det.forward_fn(det.params, timg))
    want = jq.yolov3_forward_stem_int8_packed(jhp, jnp.asarray(images))
    want_h = _handoff(jax_layers, "conv_folded",
                      lambda: jq.yolov3_forward_stem_int8_packed(
                          jhp, jnp.asarray(images)))
    # the int8 region, bit for bit (NCHW in the port, NHWC in JAX)
    np.testing.assert_array_equal(
        got_h.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want_h, np.float32))
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        d = np.abs(g - w)
        mag = np.maximum(np.abs(g), np.abs(w))
        assert (d <= 2 * _bf16_ulp(np.maximum(mag, 0.5))).all(), d.max()


def test_stem8_refuses_a_split_residual_block(variables):
    _, tvars, images = variables
    scales = tq.calibrate_activation_scales(tvars, torch.from_numpy(images))
    dets = dict(exp_stem_int8.detectors(tvars, scales, (10,), (SIZE, SIZE),
                                        CPU))
    assert isinstance(dets["stem8 upto=10"], ValueError)
    assert "splits a residual block" in str(dets["stem8 upto=10"])
    assert 15 not in tq.stem_int8_safe_boundaries()       # JAX's default


# --- the scripts' mains -----------------------------------------------------

TINY = ["--device", "cpu", "--size", str(SIZE), str(SIZE), "--batch", "2"]
SCRIPTS = {"exp_score": (exp_score, []), "exp_topk": (exp_topk, []),
           "exp_tail": (exp_tail, []), "exp_pp_incr": (exp_pp_incr, []),
           "exp_postprocess": (exp_postprocess, ["--sweep", "1"]),
           "exp_stem_int8": (exp_stem_int8, ["--upto", "4", "10"]),
           "exp_highres_int8": (exp_highres_int8, ["--upto", "9"])}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_main_on_cpu(name, capsys, tmp_path):
    module, extra = SCRIPTS[name]
    out = tmp_path / "record.json"
    assert module.main(TINY + extra + ["--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(out.read_text())
    assert last["script"] == name and last["device"] == "cpu"
    assert last["batch"] == 2 and last["size"] == [SIZE, SIZE]
    timed = [r for r in last["rows"] if r["ms"] is not None]
    assert timed
    for r in timed:
        # no device metric off the card
        assert r["busy_ms"] is None and r["idle_share"] is None
        assert r["device_ms"] is None and r["ms"] > 0
        # a differential of (1, 3) calls: 1 untimed + 3 x (1 + 3)
        assert r["calls"] == 13
        assert r["nms_calls"] in (0, 13)
    for r in last["rows"]:
        if r["ms"] is None:
            assert set(r) & {"no_counterpart", "refused"}
    assert last["nms_calls"] >= sum(r.get("nms_calls", 0)
                                    for r in last["rows"])
    if name == "exp_stem_int8":
        refused = [r["name"] for r in last["rows"] if "refused" in r]
        assert refused == ["64x64 stem8 upto=10"]
    if name == "exp_topk":
        d = last["differences"]
        assert d["indices"] == 2 * exp_topk.K
    if name == "exp_pp_incr":
        assert set(last["increments"]) == {
            f"{b} - {a}" for a, b in zip(exp_pp_incr.CHAIN,
                                         exp_pp_incr.CHAIN[1:])}
        assert last["p50"]["calls"] == bench.P50_CALLS + 1
    if name == "exp_postprocess":
        assert last["faster"] in exp_postprocess.VARIANTS
        assert [r["batch"] for r in last["rows"]] == [2, 2, 1]


def test_default_out_under_build():
    run = experiments.Run("exp_score", experiments.parser(
        exp_score.__doc__, batch=1), ["--device", "cpu"])
    assert run.out.startswith("build")
    assert exp_highres_int8.UPTO == (9, 12, 15)
    assert exp_stem_int8.UPTO == (4, 9, 12)


@pytest.mark.parametrize("module", [
    exp_score, exp_topk, exp_tail, exp_pp_incr, exp_postprocess,
    exp_stem_int8, exp_highres_int8, analyze_recipe_precision])
def test_no_silent_cpu_path(module):
    """--device cuda (each script's default) where there is no CUDA device
    exits with a message instead of timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(["--device", "cuda"])
