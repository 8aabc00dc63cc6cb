"""Anchor decode of the PyTorch port against the JAX package, on the CPU.

Seeded fp32 feature maps at 64^2 and 96^2, some wh logits above 60 (the
exp clamp), go through both packages' `predict_boxes`. Tolerance rtol 1e-6
on boxes, confs and probs: torch's and XLA's sigmoid and exp may differ by
an ulp. A corner is center - size/2, and where the two nearly cancel an ulp
of the center (up to the image size) is a large relative error of the
corner, so corners also get an absolute 1e-6 x image size in pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models import decode as jdecode
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.models import decode as tdecode
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
C = 20


def feature_maps(size: int, seed: int):
    rng = np.random.default_rng(seed)
    maps = []
    for stride in (32, 16, 8):
        g = size // stride
        f = rng.normal(0, 2, (2, g, g, 3, 5 + C)).astype(np.float32)
        f[0, 0, 0, :, 2:4] = [61.0, 75.0]          # exp clamps at 60
        maps.append(f.reshape(2, g, g, 3 * (5 + C)))
    return maps


@pytest.mark.parametrize("size", [64, 96])
def test_predict_boxes_matches_jax(size):
    maps = feature_maps(size, seed=size)
    got = tdecode.predict_boxes([torch.from_numpy(m) for m in maps], ANCHORS,
                                C, (size, size))
    want = jdecode.predict_boxes([jnp.asarray(m) for m in maps], ANCHORS, C,
                                 (size, size))
    a = 3 * sum((size // s) ** 2 for s in (32, 16, 8))
    for g, w, shape, atol in zip(got, want, [(2, a, 4), (2, a, 1), (2, a, C)],
                                 [1e-6 * size, 0, 0]):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=atol)
    # the clamped box: e^60 times the anchor, centred on its cell
    half = float(np.exp(np.float32(60.0)) * ANCHORS[6, 0]) / 2
    np.testing.assert_allclose(float(got[0][0, 0, 2]), half, rtol=1e-6)


def test_decode_feature_map_matches_jax():
    fmap = feature_maps(64, seed=1)[1]
    got = tdecode.decode_feature_map(torch.from_numpy(fmap), ANCHORS[3:6], C,
                                     (64, 96))
    want = jdecode.decode_feature_map(jnp.asarray(fmap), ANCHORS[3:6], C,
                                      (64, 96))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
