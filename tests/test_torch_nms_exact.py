"""Per-group NMS (the exact path's) of the PyTorch port.

On the CPU: the plain keep masks (`nms_keep_mask_reference`) equal the JAX
Pallas kernel `nms_keep_mask_pallas` in interpret mode (save the few pairs
whose IoU XLA's CPU compiler rounds across t, see the test), the JAX
`suppression_mask` and the numpy greedy oracle, bit for bit, on the case
list that chip_smoke.py also runs on the card; the port's `batched_nms`
and `batched_nms_kernel` equal the JAX `batched_nms` and
`batched_nms_pallas` (interpret mode): `valid` and `labels` exactly,
`scores` and `boxes` to rtol 1e-6 (the same float32 values gathered, so in
practice equal). `keep_mask_by_blocks`, the CUDA kernel's decision order in
PyTorch, equals JAX's `suppression_mask` bit for bit on the same cases. The
`cuda` test holds the CUDA kernel to the plain version on the card, on the
case list and on the exact path's own candidates at G = 640, K = 1024.

JAX is imported inside a fixture, not at the top: the GPU machine has no
jax, and there this file runs its `cuda` test alone
(`python -m pytest --noconftest -m cuda tests/test_torch_nms_exact.py`).
"""

import types

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.ops.boxes import iou_xyxy
from yolov3_tensorflow_tpu_torch.ops.nms import (batched_nms,
                                                 batched_nms_auto, cpu_nms,
                                                 per_class_nms, py_nms)
from yolov3_tensorflow_tpu_torch.ops.nms_cuda import (batched_nms_kernel,
                                                      keep_mask_by_blocks,
                                                      nms_keep_mask,
                                                      nms_keep_mask_reference)
from yolov3_tensorflow_tpu_torch.testing import per_class_cases

# G <= 8 and K in {128, 256} against the JAX kernel: interpret mode is slow
CASES_JAX = {c.name: c for c in per_class_cases(groups=4, ks=(128, 256),
                                                seed=0)}
CASES = {c.name: c for c in per_class_cases(groups=4, ks=(8, 200, 567),
                                            seed=1)}


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax
    from yolov3_tensorflow_tpu.ops import nms
    from yolov3_tensorflow_tpu.ops.nms_pallas import (batched_nms_pallas,
                                                      nms_keep_mask_pallas)
    return types.SimpleNamespace(
        suppression=jax.jit(jax.vmap(nms.suppression_mask,
                                     in_axes=(0, 0, None)),
                            static_argnums=2),
        kernel=nms_keep_mask_pallas, batched=nms.batched_nms,
        batched_pallas=batched_nms_pallas, per_class=nms.per_class_nms)


def _reference(case) -> np.ndarray:
    return nms_keep_mask_reference(torch.from_numpy(case.boxes),
                                   torch.from_numpy(case.valid),
                                   case.iou_thresh).numpy()


def _oracle(case) -> np.ndarray:
    keep = np.zeros_like(case.valid)
    for g in range(case.boxes.shape[0]):
        idx = np.where(case.valid[g])[0]
        if idx.size:
            with np.errstate(invalid="ignore"):       # 0/0 for zero areas
                kept = py_nms(case.boxes[g][idx], -idx.astype(np.float32),
                              max_boxes=idx.size, iou_thresh=case.iou_thresh)
            keep[g, idx[kept]] = True
    return keep


def _check_shape_of_result(name, case, got):
    assert got.dtype == np.bool_ and got.shape == case.valid.shape
    assert not (got & ~case.valid).any()
    if name != "random_k8":
        assert 0 < got.sum() < case.valid.sum(), "case must keep and suppress"


@pytest.mark.parametrize("name", sorted(CASES_JAX))
def test_reference_matches_jax_kernel(name, jref):
    """Bit for bit against the Pallas kernel, K padded with invalid rows to
    its multiple of 128 (the JAX wrapper's rule; the port takes any K)."""
    import jax.numpy as jnp
    case = CASES_JAX[name]
    g, k, _ = case.boxes.shape
    k_pad = -(-k // 128) * 128
    boxes = np.zeros((g, k_pad, 4), np.float32)
    valid = np.zeros((g, k_pad), bool)
    boxes[:, :k], valid[:, :k] = case.boxes, case.valid
    want = np.asarray(jref.kernel(jnp.asarray(boxes), jnp.asarray(valid),
                                  case.iou_thresh, interpret=True))[:, :k]
    got = _reference(case)
    if name == "iou_at_threshold":
        # XLA's CPU compiler contracts the kernel body's area_i + area_j
        # into an FMA (area_j's product unrounded), so some IoUs within an
        # ulp or two of t land on the other side of it than the correctly
        # rounded IoU, and the JAX kernel disagrees with JAX's own
        # suppression_mask there. The port is held to the correctly rounded
        # one on those rows and to the kernel everywhere else.
        xla = np.asarray(jref.suppression(jnp.asarray(case.boxes),
                                          jnp.asarray(case.valid),
                                          case.iou_thresh))
        off = want != xla
        assert off.sum() <= 8
        np.testing.assert_array_equal(got, xla)
        want = np.where(off, xla, want)
    np.testing.assert_array_equal(got, want)
    _check_shape_of_result(name, case, got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_suppression_mask_and_oracle(name, jref):
    import jax.numpy as jnp
    case = CASES[name]
    got = _reference(case)
    want = np.asarray(jref.suppression(jnp.asarray(case.boxes),
                                       jnp.asarray(case.valid),
                                       case.iou_thresh))
    np.testing.assert_array_equal(got, want)
    if name != "iou_at_threshold":
        # py_nms has no 1e-10 in its IoU denominator, so pairs within an
        # ulp of t may legitimately go the other way there
        np.testing.assert_array_equal(got, _oracle(case))
    if name == "chain":
        assert got[:, :3].tolist() == [[True, False, True]] * len(got)
    _check_shape_of_result(name, case, got)


@pytest.mark.parametrize("block", [32, 7])
@pytest.mark.parametrize("name", sorted(CASES) + ["random_k1024"])
def test_kernel_decision_order_matches_suppression_mask(name, block, jref):
    """The CUDA kernel's order (decide a block of rows, then let only its
    kept rows remove from later blocks), modelled in PyTorch at the
    kernel's block of 32 and at an odd block, equals the greedy."""
    import jax.numpy as jnp
    case = CASES.get(name) or per_class_cases(groups=2, ks=(1024,),
                                              seed=5)[0]
    boxes, valid = torch.from_numpy(case.boxes), torch.from_numpy(case.valid)
    got = keep_mask_by_blocks(boxes, valid, case.iou_thresh, block=block)
    want = np.asarray(jref.suppression(jnp.asarray(case.boxes),
                                       jnp.asarray(case.valid),
                                       case.iou_thresh))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, nms_keep_mask_reference(boxes, valid,
                                                    case.iou_thresh))


def test_zero_intersection_never_passes_a_threshold():
    """The kernel skips the division where the intersection is 0 and
    t >= 0: the plain IoU of every such pair, zero-area, touching, apart
    or NaN-free degenerate, is +-0 or NaN, never > t."""
    rng = np.random.default_rng(6)
    x0, y0 = rng.integers(0, 20, (2, 4000)).astype(np.float32)
    w, h = rng.integers(0, 6, (2, 4000)).astype(np.float32)
    boxes = torch.from_numpy(np.stack([x0, y0, x0 + w, y0 + h], -1))
    a, b = boxes[:2000], boxes[2000:]
    iou = iou_xyxy(a, b)
    mins = torch.maximum(a[:, None, :2], b[None, :, :2])
    maxs = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(maxs - mins, min=0.0)
    zero = wh[..., 0] * wh[..., 1] == 0
    assert zero.float().mean() > 0.5 and (~zero).any()
    for t in (0.0, 0.45, 0.9):
        assert not (iou[zero] > t).any()


def _scored_boxes(seed: int, b: int = 2, a: int = 300, c: int = 4):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(0, 300, (2, b, a))
    w, h = rng.uniform(5, 120, (2, b, a))
    boxes = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)
    return boxes, rng.uniform(0, 0.9, (b, a, c)).astype(np.float32)


@pytest.mark.parametrize("max_out,pre_topk", [(10, 128),    # max_out < K
                                              (200, 128),   # max_out > K
                                              (20, 400)])   # pre_topk > A
def test_batched_nms_matches_jax(max_out, pre_topk, jref):
    import jax.numpy as jnp
    boxes, scores = _scored_boxes(seed=pre_topk + max_out)
    kw = dict(max_out=max_out, pre_topk=pre_topk, score_thresh=0.3,
              iou_thresh=0.5)
    jb, js = jnp.asarray(boxes), jnp.asarray(scores)
    wants = [jref.batched(jb, js, **kw),
             jref.batched_pallas(jb, js, interpret=True, **kw)]
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    gots = [fn(tb, ts, **kw) for fn in (batched_nms, batched_nms_kernel,
                                        batched_nms_auto)]
    assert np.asarray(wants[0]["valid"]).any()
    for got in gots:
        assert got["boxes"].shape == (2, 4 * max_out, 4)
        assert got["valid"].dtype == torch.bool
        assert got["labels"].dtype == torch.int32
        for want in wants:
            for key in ("valid", "labels"):
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(want[key]))
            for key in ("boxes", "scores"):
                np.testing.assert_allclose(got[key].numpy(),
                                           np.asarray(want[key]), rtol=1e-6)

    # one image: per_class_nms against JAX's, and (with every candidate in
    # play) the host oracle cpu_nms, whose rows are class-major and
    # score-descending as the valid rows are here
    one = per_class_nms(tb[0], ts[0], **kw)
    want = jref.per_class(jb[0], js[0], **kw)
    for key in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_array_equal(one[key].numpy(), np.asarray(want[key]))
    if pre_topk >= boxes.shape[1]:
        v = one["valid"].numpy()
        oracle = cpu_nms(boxes[0], scores[0], 4, max_boxes=max_out,
                         score_thresh=0.3, iou_thresh=0.5)
        for got, key in zip(oracle, ("boxes", "scores", "labels")):
            np.testing.assert_array_equal(got, one[key].numpy()[v])


def test_cpu_tensors_take_the_plain_version():
    case = CASES["random_k200"]
    before = nms_keep_mask.launches
    got = nms_keep_mask(torch.from_numpy(case.boxes),
                        torch.from_numpy(case.valid), case.iou_thresh)
    np.testing.assert_array_equal(got.numpy(), _reference(case))
    assert nms_keep_mask.launches == before


def test_wrapper_rejects_tensors_off_cpu_and_cuda():
    boxes = torch.zeros((1, 8, 4), device="meta")
    valid = torch.zeros((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        nms_keep_mask(boxes, valid, 0.45)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for case in per_class_cases(groups=8, seed=2):
        boxes = torch.from_numpy(case.boxes).to(dev)
        valid = torch.from_numpy(case.valid).to(dev)
        before = nms_keep_mask.launches
        got = nms_keep_mask(boxes, valid, case.iou_thresh)
        torch.cuda.synchronize()
        assert nms_keep_mask.launches == before + 1
        want = nms_keep_mask_reference(boxes, valid, case.iou_thresh)
        assert torch.equal(got, want), case.name
    # the exact path's own candidates at the eval config: G = 640, K = 1024
    from yolov3_tensorflow_tpu_torch.scripts.compare_revisions import \
        eval_candidates
    cand = eval_candidates(dev)
    got = nms_keep_mask(cand["boxes"], cand["valid"], 0.45)
    assert cand["boxes"].shape == (640, 1024, 4)
    assert torch.equal(got, cand["keep"])
    with pytest.raises(ValueError, match="K <= 1024"):
        nms_keep_mask(torch.zeros((1, 1025, 4), device=dev),
                      torch.ones((1, 1025), dtype=torch.bool, device=dev),
                      0.45)
