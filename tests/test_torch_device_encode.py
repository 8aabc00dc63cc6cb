"""Label encoding on the device (`data/device_encode.py`) and the padded
ground truth it reads (`data/encoder.py:pad_ground_truth`), against the JAX
package on the CPU.

- `pad_ground_truth` equals JAX's byte for byte, past `max_boxes` too
  (the largest areas kept, ties in annotation order).
- `encode_labels_device` is bit-equal to JAX's `encode_labels_device` and
  to the host `encode_labels` of each image's valid rows, at a square and a
  non-square size, on random boxes with slot collisions.
- On a collision the last box wins the coordinates, objectness and mixup
  weight, and the class bits are the union; padded rows are ignored
  whatever they hold.

JAX is imported inside a fixture, not at the top: the GPU machine has no
jax, and there this file runs its `cuda` test alone
(`python -m pytest --noconftest -m cuda tests/test_torch_device_encode.py`),
which holds the grids made on the GPU bit-equal to the CPU's.
"""

import types

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data.device_encode import \
    encode_labels_device
from yolov3_tensorflow_tpu_torch.data.encoder import (encode_labels,
                                                      pad_ground_truth)
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
C = 7


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from yolov3_tensorflow_tpu.data import device_encode, encoder
    return types.SimpleNamespace(jnp=jnp, encode=device_encode.
                                 encode_labels_device,
                                 pad=encoder.pad_ground_truth)


def random_gt(seed: int, batch: int, m: int, size, collide: bool = True):
    """Padded ground truth [B, M, 5], labels [B, M], mask [B, M]: a random
    number of boxes per image (0 to m, one image full), xyxy inside the
    image, mixup weights in (0.3, 1]; with `collide`, each image repeats a
    box under another label, so that two boxes share a slot."""
    rng = np.random.default_rng(seed)
    w, h = size
    boxes = np.zeros((batch, m, 5), np.float32)
    labels = np.zeros((batch, m), np.int32)
    mask = np.zeros((batch, m), bool)
    for i in range(batch):
        n = m if i == 0 else int(rng.integers(0, m + 1))
        xy = rng.uniform(0, [w - 8, h - 8], (n, 2))
        wh = rng.uniform(4, [w, h], (n, 2))
        boxes[i, :n, 0:2] = xy
        boxes[i, :n, 2:4] = np.minimum(xy + wh, [w, h])
        boxes[i, :n, 4] = rng.uniform(0.3, 1.0, n)
        labels[i, :n] = rng.integers(0, C, n)
        mask[i, :n] = True
        if collide and n >= 2:
            boxes[i, n - 1, :4] = boxes[i, 0, :4]
            labels[i, n - 1] = (labels[i, 0] + 1) % C
    return boxes, labels, mask


def port_grids(boxes, labels, mask, size):
    return [g.numpy() for g in encode_labels_device(
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(mask), size, C, ANCHORS)]


@pytest.mark.parametrize("n,max_boxes", [(0, 4), (3, 4), (4, 4), (9, 4),
                                         (12, 5)])
def test_pad_ground_truth_equal(jref, n, max_boxes):
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 50, (n, 2)).astype(np.float32)
    wh = rng.integers(1, 4, (n, 2)).astype(np.float32)  # many equal areas
    boxes = np.concatenate([xy, xy + wh, rng.uniform(0.5, 1, (n, 1))],
                           axis=1).astype(np.float32)
    labels = rng.integers(0, C, n).astype(np.int64)
    got = pad_ground_truth(boxes, labels, max_boxes)
    want = jref.pad(boxes, labels, max_boxes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert int(got[2].sum()) == min(n, max_boxes)


@pytest.mark.parametrize("size", [(96, 96), (128, 64)])
def test_grids_bit_equal_to_jax_and_host(jref, size):
    boxes, labels, mask = random_gt(1, batch=6, m=24, size=size)
    got = port_grids(boxes, labels, mask, size)
    jnp = jref.jnp
    want = [np.asarray(g) for g in jref.encode(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask), size, C,
        ANCHORS)]
    w, h = size
    for g, wg, stride in zip(got, want, (32, 16, 8)):
        assert g.shape == (6, h // stride, w // stride, 3, 6 + C)
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, wg)
    for i in range(6):
        m = mask[i]
        host = encode_labels(boxes[i][m], labels[i][m], size, C, ANCHORS)
        for g, hg in zip(got, host):
            np.testing.assert_array_equal(g[i], hg)
    assert sum(int(g[..., 4].sum()) for g in got) > 0


def test_collision_last_box_wins_and_classes_union():
    size = (64, 64)
    boxes = np.zeros((1, 4, 5), np.float32)
    labels = np.zeros((1, 4), np.int32)
    mask = np.zeros((1, 4), bool)
    # three boxes of one size and cell (one anchor slot), the second a
    # padded row; the last valid one must win
    boxes[0, 0] = [8, 8, 40, 40, 0.5]
    boxes[0, 1] = [0, 0, 60, 60, 0.9]          # padded: ignored
    boxes[0, 2] = [9, 9, 41, 41, 0.7]
    boxes[0, 3] = [10, 10, 42, 42, 0.25]
    labels[0] = [1, 6, 3, 5]
    mask[0] = [True, False, True, True]
    grids = port_grids(boxes, labels, mask, size)
    occupied = [(s, np.argwhere(g[0, ..., 4] > 0)) for s, g in
                enumerate(grids)]
    hits = [(s, tuple(ix)) for s, ixs in occupied for ix in ixs]
    assert len(hits) == 1
    s, (y, x, k) = hits[0]
    cell = grids[s][0, y, x, k]
    np.testing.assert_array_equal(cell[0:4], [26, 26, 32, 32])
    assert cell[4] == 1.0 and cell[-1] == np.float32(0.25)
    assert sorted(np.flatnonzero(cell[5:5 + C]).tolist()) == [1, 3, 5]


def test_padded_rows_are_ignored():
    size = (96, 64)
    boxes, labels, mask = random_gt(4, batch=3, m=10, size=size)
    junk_boxes, junk_labels = boxes.copy(), labels.copy()
    rng = np.random.default_rng(9)
    junk_boxes[~mask] = rng.uniform(0, 90, (int((~mask).sum()), 5))
    junk_labels[~mask] = rng.integers(-3, C + 3, int((~mask).sum()))
    clean = boxes.copy()
    clean[~mask] = 0
    for g, w in zip(port_grids(junk_boxes, junk_labels, mask, size),
                    port_grids(clean, labels, mask, size)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cuda_grids_bit_equal_to_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for size in ((416, 416), (608, 320)):
        boxes, labels, mask = random_gt(7, batch=32, m=64, size=size)
        want = port_grids(boxes, labels, mask, size)
        got = encode_labels_device(
            torch.from_numpy(boxes).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(mask).to(dev), size, C, ANCHORS)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w)
