"""The port's reference-API wrapper `YoloV3` and the box-format helpers
against the JAX package's, on the CPU.

- `YoloV3` with JAX's defaults (batch-norm decay 0.999, no label smoothing
  or focal loss) in fp32 at 64x64, 4 classes, batch 4, from one seeded
  weight tree (testing.numpy_variables, carried across by
  from_jax_variables): the eval forward's feature maps, the training
  forward's new statistics (which carry the decay), `predict`'s boxes,
  confidences and class probabilities and `compute_loss`'s terms, each
  within 1e-4 of its largest magnitude (tests/test_torch_train_model.py's
  tolerance: 75 convs summed in other orders). The training forward's
  feature maps, which its 72 batch norms make sensitive to the order of the
  sums (1.2e-4 here), are held bit-equal to the port's `yolov3_forward` at
  that decay; tests/test_torch_train_model.py holds that forward to JAX's.
  JAX's side runs in one jitted function.
- `xywh_to_xyxy` and `xyxy_to_xywh`: bit-equal to JAX's on seeded boxes,
  and each other's inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.models import YoloV3 as JaxYoloV3
from yolov3_tensorflow_tpu.ops import boxes as jboxes
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data.encoder import encode_labels
from yolov3_tensorflow_tpu_torch.models import YoloV3
from yolov3_tensorflow_tpu_torch.models.convert import from_jax_variables
from yolov3_tensorflow_tpu_torch.models.yolov3 import (init_yolov3,
                                                       yolov3_forward)
from yolov3_tensorflow_tpu_torch.ops import boxes as tboxes
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)

torch.set_num_threads(CPU_TEST_THREADS)

C = 4
SIZE = 64
BATCH = 4
ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)
RTOL = 1e-4


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


def test_yolov3_wrapper_matches_jax():
    variables = numpy_variables(C, seed=4)
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    grids = []
    for _ in range(BATCH):
        xy = rng.uniform(0, 40, (2, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (2, 2))], 1)
        grids.append(encode_labels(boxes.astype(np.float32),
                                   rng.integers(0, C, 2), (SIZE, SIZE), C,
                                   ANCHORS))
    y_true = [np.stack([g[s] for g in grids]) for s in range(3)]

    jmodel = JaxYoloV3(C, ANCHORS, compute_dtype=jnp.float32)
    model = YoloV3(C, ANCHORS, compute_dtype=torch.float32)
    assert (model.batch_norm_decay, model.weight_decay,
            model.use_label_smooth, model.use_focal_loss) == \
        (jmodel.batch_norm_decay, jmodel.weight_decay,
         jmodel.use_label_smooth, jmodel.use_focal_loss)

    @jax.jit
    def run(variables, images, y_true):
        fmaps, _ = jmodel.forward(variables, images)
        _, stats = jmodel.forward(variables, images, train=True)
        return (fmaps, None, stats,
                jmodel.predict(fmaps, (SIZE, SIZE)),
                jmodel.compute_loss(fmaps, y_true, (SIZE, SIZE)))

    want = jax.device_get(run(variables, jnp.asarray(images),
                              [jnp.asarray(y) for y in y_true]))

    tv = from_jax_variables(variables, device=torch.device("cpu"))
    timages = torch.from_numpy(images)
    with torch.no_grad():
        fmaps, _ = model.forward(tv, timages)
        train_fmaps, stats = model.forward(tv, timages, train=True)
        plain_fmaps, plain_stats = yolov3_forward(
            tv, timages, train=True, compute_dtype=torch.float32,
            bn_momentum=0.999)
        predicted = model.predict(fmaps, (SIZE, SIZE))
        losses = model.compute_loss(fmaps,
                                    [torch.from_numpy(y) for y in y_true],
                                    (SIZE, SIZE))
    for s in range(3):
        close(fmaps[s], want[0][s], f"eval fmap {s}")
        assert torch.equal(train_fmaps[s], plain_fmaps[s])
    for scope in want[2]:
        for name in want[2][scope]:
            for k in ("mean", "var"):
                close(stats[scope][name][k], want[2][scope][name][k],
                      f"{scope}/{name}/{k}")
                assert torch.equal(stats[scope][name][k],
                                   plain_stats[scope][name][k])
    for got, w, what in zip(predicted, want[3], ("boxes", "confs", "probs")):
        close(got, w, what)
    assert set(losses) == set(want[4])
    for k in losses:
        close(float(losses[k]), float(want[4][k]), f"loss {k}")


def test_yolov3_init_needs_a_device():
    """`YoloV3.init` takes the device as a required keyword, as every
    build function of the port does: without one it raises TypeError
    instead of building the weights on the CPU; with one they land there,
    drawn as `init_yolov3` draws them."""
    model = YoloV3(C, ANCHORS)
    with pytest.raises(TypeError, match="device"):
        model.init(torch.Generator().manual_seed(0))
    got = model.init(torch.Generator().manual_seed(0),
                     device=torch.device("cpu"))
    want = init_yolov3(torch.Generator().manual_seed(0), C,
                       device=torch.device("cpu"))
    for scope, tree in want["params"].items():
        for name, p in tree.items():
            for k, v in p.items():
                assert torch.equal(got["params"][scope][name][k], v)
    assert got["params"]["head"]["conv_6"]["w"].shape[0] == 3 * (5 + C)


def test_box_format_helpers_match_jax():
    rng = np.random.default_rng(5)
    xywh = np.concatenate([rng.uniform(0, 400, (3, 7, 2)),
                           rng.uniform(1, 120, (3, 7, 2))], -1
                          ).astype(np.float32)
    xyxy = np.asarray(jboxes.xywh_to_xyxy(jnp.asarray(xywh)))
    got = tboxes.xywh_to_xyxy(torch.from_numpy(xywh))
    np.testing.assert_array_equal(got.numpy(), xyxy)
    back = tboxes.xyxy_to_xywh(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jboxes.xyxy_to_xywh(jnp.asarray(xyxy))))
    np.testing.assert_allclose(back.numpy(), xywh, rtol=1e-5, atol=1e-4)
