"""Shared-candidate NMS of the PyTorch port.

On the CPU: the plain PyTorch keep masks equal the JAX Pallas kernel (in
interpret mode) and the numpy greedy oracle bit for bit, on the case list
that chip_smoke.py also runs on the card (and the oracle alone on the
card-only cases small enough for it); `batched_nms_shared` equals the JAX
wrapper in both of its branches; the kernel's launch plan (`shared_plan`)
fits shared memory and reads class columns without bank conflicts. The
`cuda` test holds the CUDA kernel to the plain version on the card.

JAX is imported inside a fixture, not at the top: the GPU machine has no
jax, and there this file runs its `cuda` test alone
(`python -m pytest --noconftest -m cuda tests/test_torch_nms.py`).
"""

import types

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.ops import nms_cuda
from yolov3_tensorflow_tpu_torch.ops.nms_cuda import (
    batched_nms_shared, nms_keep_mask_shared, nms_keep_mask_shared_reference,
    shared_plan)
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS, bench_case,
                                                 card_cases, nms_cases)

torch.set_num_threads(CPU_TEST_THREADS)

CASES = {c.name: c for c in nms_cases(batch=2)}
SMALL_CARD_CASES = {c.name: c for c in card_cases()
                    if c.name.startswith(("ragged", "one_cta"))}


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    from yolov3_tensorflow_tpu.ops.nms import py_nms
    from yolov3_tensorflow_tpu.ops.nms_pallas import (
        batched_nms_shared_pallas, nms_keep_mask_shared_pallas)
    return types.SimpleNamespace(
        py_nms=py_nms, keep=nms_keep_mask_shared_pallas,
        batched=batched_nms_shared_pallas)


def _oracle(jref, case) -> np.ndarray:
    b, k, c = case.scores.shape
    keep = np.zeros((b, c, k), bool)
    for i in range(b):
        for cl in range(c):
            s = case.scores[i, :, cl]
            idx = np.where(s >= np.float32(case.score_thresh))[0]
            if idx.size:
                with np.errstate(invalid="ignore"):    # 0/0 for zero areas
                    kept = jref.py_nms(case.boxes[i][idx], s[idx],
                                       max_boxes=k,
                                       iou_thresh=case.iou_thresh)
                keep[i, cl, idx[kept]] = True
    return keep


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_kernel_and_oracle(name, jref):
    import jax.numpy as jnp
    case = CASES[name]
    got = nms_keep_mask_shared_reference(
        torch.from_numpy(case.boxes), torch.from_numpy(case.scores),
        case.score_thresh, case.iou_thresh).numpy()
    want = np.asarray(jref.keep(jnp.asarray(case.boxes),
                                jnp.asarray(case.scores), case.score_thresh,
                                case.iou_thresh, interpret=True))
    np.testing.assert_array_equal(got, want)
    if name != "iou_at_threshold":
        # py_nms has no 1e-10 in its IoU denominator, so pairs within an
        # ulp of t may legitimately go the other way there
        np.testing.assert_array_equal(got, _oracle(jref, case))
    valid = case.scores.transpose(0, 2, 1) >= np.float32(case.score_thresh)
    assert not (got & ~valid).any()
    if name != "invalid_classes":
        assert 0 < got.sum() < valid.sum(), "case must keep and suppress"


@pytest.mark.parametrize("name", sorted(SMALL_CARD_CASES))
def test_reference_matches_oracle_on_small_card_cases(name, jref):
    """The card-only cases whose shapes the kernel treats apart (keep rows
    that are not whole 32-bit words, a batch large enough for one CTA per
    image) are real NMS work: the plain version equals the numpy oracle and
    keeps and suppresses."""
    case = SMALL_CARD_CASES[name]
    got = nms_keep_mask_shared_reference(
        torch.from_numpy(case.boxes), torch.from_numpy(case.scores),
        case.score_thresh, case.iou_thresh).numpy()
    np.testing.assert_array_equal(got, _oracle(jref, case))
    valid = case.scores.transpose(0, 2, 1) >= np.float32(case.score_thresh)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("k", [1, 8, 64, 200, 256, 1024])
@pytest.mark.parametrize("c", [1, 6, 20, 80, 91])
def test_shared_plan_fits_and_reads_columns_without_conflicts(k, c):
    """At every batch: the CTA's shared memory (boxes and areas, the whole
    mask, the staged scores) fits in 227 KB, as many classes are staged as
    fit, the odd pitch puts the 32 candidates of a class column in 32
    banks, the slices cover the classes, and a cluster is a portable one
    that only K > 64 uses."""
    t = -(-k // 32)
    for b in (1, 8, 64, 128, 300):
        p = shared_plan(b, k, c)
        assert p.smem == 4 * (5 * k + k * t + k * p.pitch)
        assert p.smem <= nms_cuda.SMEM_LIMIT
        assert p.pitch % 2 == 1 and p.chunk <= p.pitch <= p.chunk + 1
        assert 1 <= p.chunk <= p.classes
        if p.chunk < p.classes:             # one class more would not fit
            assert 4 * (5 * k + k * t + k * ((p.chunk + 1) | 1)) \
                > nms_cuda.SMEM_LIMIT
        for col in range(p.chunk):
            banks = {(j * p.pitch + col) % 32 for j in range(32)}
            assert len(banks) == 32
        assert p.slices in (1, 2, 4, 8)
        assert p.classes * p.slices >= c > (p.classes - 1) * p.slices
        assert p.shared == (p.slices > 1 and k > nms_cuda.REBUILD_K)
        assert p.warps * 32 <= (1024 if k <= 256 else 512)
        # the fewest slices that give FILL_CTAS CTAs, or the most there are
        assert p.slices == nms_cuda.MAX_SLICES \
            or b * p.slices >= nms_cuda.FILL_CTAS
        assert p.slices == 1 or b * p.slices // 2 < nms_cuda.FILL_CTAS


def test_shared_plan_at_the_serving_shapes():
    """The packed request at the bench batch takes one 32-warp CTA per
    image; the small packed request 8 per image, each building the mask;
    the prefilter request 8 per image as one cluster sharing it."""
    assert shared_plan(128, 64, 80) == (1, False, 32, 80, 80, 81, 22528)
    assert shared_plan(8, 64, 80) == (8, False, 32, 10, 10, 11, 4608)
    assert shared_plan(8, 256, 80) == (8, True, 32, 10, 10, 11, 24576)
    # K = 1024 at 160 classes stages its 20 classes a CTA in two chunks
    assert shared_plan(2, 1024, 160) == (8, True, 16, 20, 19, 19, 229376)


@pytest.mark.parametrize("max_out", [80, 64, 16])
def test_batched_nms_shared_matches_jax(max_out, jref):
    """max_out >= K emits every kept candidate in candidate order; max_out
    < K compacts each class by score (stable: ties to the lower index)."""
    import jax.numpy as jnp
    case = CASES["ties"]
    got = batched_nms_shared(torch.from_numpy(case.boxes),
                             torch.from_numpy(case.scores), max_out=max_out,
                             score_thresh=case.score_thresh,
                             iou_thresh=case.iou_thresh)
    want = jref.batched(jnp.asarray(case.boxes), jnp.asarray(case.scores),
                        max_out=max_out, score_thresh=case.score_thresh,
                        iou_thresh=case.iou_thresh, interpret=True)
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6)
    assert got["valid"].dtype == torch.bool
    assert got["labels"].dtype == torch.int32


def test_cpu_tensors_take_the_plain_version():
    case = CASES["random_k64_c80"]
    before = nms_keep_mask_shared.launches
    boxes, scores = (torch.from_numpy(case.boxes),
                     torch.from_numpy(case.scores))
    got = nms_keep_mask_shared(boxes, scores, case.score_thresh,
                               case.iou_thresh)
    want = nms_keep_mask_shared_reference(boxes, scores, case.score_thresh,
                                          case.iou_thresh)
    assert torch.equal(got, want)
    assert nms_keep_mask_shared.launches == before


def test_wrapper_rejects_tensors_off_cpu_and_cuda():
    boxes = torch.zeros((1, 8, 4), device="meta")
    scores = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError):
        nms_keep_mask_shared(boxes, scores, 0.3, 0.45)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cases = (nms_cases(batch=4, seed=1) + [bench_case(seed=2)]
             + card_cases(seed=3))
    for case in cases:
        boxes = torch.from_numpy(case.boxes).to(dev)
        scores = torch.from_numpy(case.scores).to(dev)
        before = nms_keep_mask_shared.launches
        got = nms_keep_mask_shared(boxes, scores, case.score_thresh,
                                   case.iou_thresh)
        torch.cuda.synchronize()
        assert nms_keep_mask_shared.launches == before + 1
        want = nms_keep_mask_shared_reference(
            boxes, scores, case.score_thresh, case.iou_thresh)
        assert torch.equal(got, want), case.name
