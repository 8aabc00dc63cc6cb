"""profile_train's `fwd+loss` stage against the JAX package's, on the CPU.

The stage (`scripts.profile_train.stages`) evaluates the reference
recipe's loss of the live-BN training forward. Here, in fp32 at 64x64,
batch 2, on the JAX package's `init_yolov3` weights (PRNGKey 0) carried
across by `from_jax_variables`, and on the script's own seeded numpy
inputs (`train_inputs`: images in [0, 1], label grids uniform in
[0, 0.01]), its value equals JAX's `compute_loss(yolov3_forward(...,
train=True))["total"]` within tests/test_torch_loss.py's tolerance, 1e-5
relative. The `loss(fmaps)` stage gives the same value from the maps the
stage precomputes. One JAX compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from yolov3_tensorflow_tpu.models.yolov3 import init_yolov3, yolov3_forward
from yolov3_tensorflow_tpu.ops.losses import compute_loss
from yolov3_tensorflow_tpu_torch.models.convert import from_jax_variables
from yolov3_tensorflow_tpu_torch.scripts import bench_train, profile_train
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

SIZE = 64
BATCH = 2
RTOL = 1e-5                          # tests/test_torch_loss.py's
CPU = torch.device("cpu")


def test_fwd_loss_matches_jax():
    cfg = bench_train.reference_config()
    cfg.model.compute_dtype = "float32"
    m = cfg.model
    anchors = np.asarray(cfg.anchors, np.float32)
    variables = jax.device_get(init_yolov3(jax.random.PRNGKey(0),
                                           m.num_classes))
    images, y_true = profile_train.train_inputs(BATCH, SIZE, m.num_classes,
                                                CPU)

    @jax.jit
    def jax_loss(v, im, yt):
        fmaps, _ = yolov3_forward(v, im, train=True,
                                  compute_dtype=jnp.float32,
                                  bn_momentum=m.batch_norm_decay,
                                  bn_eps=m.batch_norm_epsilon)
        return compute_loss(fmaps, yt, anchors, m.num_classes,
                            (SIZE, SIZE), use_label_smooth=m.use_label_smooth,
                            use_focal_loss=m.use_focal_loss,
                            max_gt=cfg.data.max_boxes_per_image,
                            box_loss=m.box_loss)["total"]

    want = float(jax_loss(variables, images.numpy(),
                          tuple(y.numpy() for y in y_true)))

    tv = from_jax_variables(variables, device=CPU)
    step, optimizer = bench_train.train_setup(cfg)
    state = {"params": tv["params"], "batch_stats": tv["batch_stats"],
             "opt_state": optimizer.init(tv["params"]), "step": 0}
    fns = {name: fn for name, fn, _ in profile_train.stages(
        cfg, step, optimizer, state, images, y_true)}
    got = float(fns["fwd+loss"]())
    assert abs(got - want) <= RTOL * abs(want), (got, want)
    assert float(fns["loss(fmaps)"]()) == got
