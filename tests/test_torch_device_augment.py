"""Augmentation on the device (`data/device_augment.py`) and the loader's
device modes (`data/loader.py`), against the JAX package on the CPU.

- `_axis_weights` equals JAX's for each of the 5 interpolation codes (both
  regimes of area) within 1e-6, on crops that reach past the image (the
  random_expand canvas), up- and downscale, letterboxed or not.
- `_color_distort_device` and `augment_batch` match JAX's on seeded tiles
  and plans (every interpolation code, mixup on and off, flips, letterbox
  and plain resize): within 1/255 everywhere and equal on at least 99.5% of
  the pixels (the port's resampling products run in float64, JAX's in
  float32; a pixel moves only where the sum lies within rounding of .5).
- The host side is a copy: `stage_image` and `pack_plans` give JAX's bytes,
  and `plan_example`'s plan fields, boxes and `y_true` are bit-identical to
  JAX's, in train and val mode, with and without mixup.
- The port's loader in device-augment and device-encode mode gives JAX's
  batches: ids, `staged`, `staged2`, `params`, sizes and the padded ground
  truth (or the grids, without device_encode).

JAX is imported inside a fixture, not at the top: the GPU machine has no
jax, and there this file runs its `cuda` test alone
(`python -m pytest --noconftest -m cuda tests/test_torch_device_augment.py`),
which holds `augment_batch` on the GPU to the CPU's within the same pixel
contract.
"""

import types

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data import device_augment as tda
from yolov3_tensorflow_tpu_torch.data import loader as tload
from yolov3_tensorflow_tpu_torch.data.augment import letterbox_params
from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from yolov3_tensorflow_tpu.data import device_augment, loader
    return types.SimpleNamespace(jax=jax, jnp=jnp, da=device_augment,
                                 loader=loader)


def pixel_contract(got: np.ndarray, want: np.ndarray) -> None:
    """Images in [0, 1]: within 1/255 everywhere, equal on >= 99.5%."""
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.float64) - want) * 255.0
    assert diff.max() <= 1.0 + 1e-4, diff.max()
    assert (diff < 1e-3).mean() >= 0.995, (diff < 1e-3).mean()


def random_plans(seed: int, batch: int, s_len: int, out_size, codes,
                 letterbox: bool, mixup: bool):
    """Seeded tiles and plans: crops reaching up to 30 px past the tile
    (random_expand canvas), 20..1.5*S px wide (up- and downscale), colour
    jitter in the host sampler's ranges, every third example flipped."""
    rng = np.random.default_rng(seed)
    out_w, out_h = out_size
    staged = rng.integers(0, 256, (batch, s_len, s_len, 3), dtype=np.uint8)
    staged2 = rng.integers(0, 256, (batch, s_len, s_len, 3), dtype=np.uint8)
    plans = []
    for i in range(batch):
        cw, ch = (int(v) for v in rng.integers(20, int(1.5 * s_len), 2))
        x0, y0 = (int(v) for v in rng.integers(-30, s_len // 2, 2))
        if letterbox:
            _, rw, rh, dw, dh = letterbox_params(cw, ch, out_w, out_h)
        else:
            rw, rh, dw, dh = out_w, out_h, 0, 0
        plans.append(tda.ExamplePlan(
            staged=staged[i], staged2=staged2[i] if mixup else None,
            lam=float(rng.uniform(0.2, 1.0)) if mixup else 1.0,
            color=(float(rng.uniform(-32, 32)), float(rng.uniform(-18, 18)),
                   float(rng.uniform(0.5, 1.5)), float(rng.uniform(0.5, 1.5))),
            crop_x0=x0, crop_y0=y0, crop_w=cw, crop_h=ch, rw=rw, rh=rh,
            dw=dw, dh=dh, interp=int(codes[i % len(codes)]),
            flip=i % 3 == 0))
    return staged, staged2, tda.pack_plans(plans)


def port_augment(staged, staged2, params, out_size, device=None, **kw):
    dev = device or torch.device("cpu")
    out = tda.augment_batch(
        torch.from_numpy(staged).to(dev), torch.from_numpy(staged2).to(dev),
        {k: torch.from_numpy(v).to(dev) for k, v in params.items()},
        out_size, **kw)
    return out.cpu().numpy()


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_axis_weights_equal(jref, interp):
    jnp = jref.jnp
    cases = [  # out, S, crop0, csz, rsz, dpad, decimate
        (64, 96, 0, 96, 64, 0, True), (64, 96, -20, 130, 48, 8, True),
        (80, 64, 10, 30, 80, 0, False), (80, 64, -5, 40, 60, 10, False),
        (48, 128, 30, 120, 48, 0, False), (96, 48, 0, 48, 96, 0, True)]
    # each case alone, then cases of one source length as two axes of one
    # call (x, y), as augment_batch builds them
    for axes in [[c] for c in cases] + [cases[0:2], cases[2:4]]:
        s_len, decim = axes[0][1], axes[0][6]
        params = [torch.tensor([[c[k] for c in axes]]) for k in (2, 3, 4, 5)]
        got = tda._axis_weights(tuple(c[0] for c in axes), s_len, *params,
                                torch.tensor([interp]), torch.tensor([decim]))
        assert len(got) == len(axes)
        for (w, rows), (out_len, _, c0, csz, rsz, dpad, _) in zip(got, axes):
            want, want_rows = jref.da._axis_weights(
                out_len, s_len, jnp.int32(c0), jnp.int32(csz),
                jnp.int32(rsz), jnp.int32(dpad), jnp.int32(interp),
                area_decimate=decim)
            np.testing.assert_array_equal(rows[0].numpy(),
                                          np.asarray(want_rows))
            np.testing.assert_allclose(w[0].numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)


def test_augment_batch_op_count_fixed():
    """The batch is not looped over, nor are the interpolation codes: one
    code at batch 2 and every code at batch 12 dispatch the same operations,
    fewer than 450 (the host's eager cost of the step's prologue)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counts = []
    for batch, codes in ((2, [1]), (12, range(5))):
        staged, staged2, params = random_plans(7, batch, 48, (40, 32), codes,
                                               True, True)
        with Count() as count:
            port_augment(staged, staged2, params, (40, 32), mixup=True,
                         distort=True)
        counts.append(count.n)
    assert counts[0] == counts[1] < 450, counts


def test_color_distort_equal(jref):
    staged, _, params = random_plans(2, 6, 40, (32, 32), [1], True, False)
    x = staged.astype(np.float32)
    got = tda._color_distort_device(torch.from_numpy(x),
                                    torch.from_numpy(params["color"]))
    fn = jref.jax.jit(jref.jax.vmap(jref.da._color_distort_device))
    want = np.asarray(fn(x, params["color"]))
    pixel_contract(got.numpy() / 255.0, want / 255.0)


@pytest.mark.parametrize("mixup,letterbox", [(False, True), (True, False),
                                             (True, True)])
def test_augment_batch_matches_jax(jref, mixup, letterbox):
    out_size = (96, 64)
    staged, staged2, params = random_plans(
        3, 10, 112, out_size, range(5), letterbox, mixup)
    if not mixup:
        staged2 = staged
    got = port_augment(staged, staged2, params, out_size, mixup=mixup,
                       distort=True)
    want = np.asarray(jref.da.augment_batch(
        staged, staged2, params, out_size, mixup=mixup, distort=True))
    assert got.shape == (10, 64, 96, 3)
    pixel_contract(got, want)
    got = port_augment(staged, staged2, params, out_size, mixup=mixup,
                       distort=False)
    want = np.asarray(jref.da.augment_batch(
        staged, staged2, params, out_size, mixup=mixup, distort=False))
    pixel_contract(got, want)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_dev")
    return generate_dataset(str(root), num_images=6, seed=4,
                            img_size=(120, 100), max_shapes=4)


def test_stage_and_pack_equal(jref):
    rng = np.random.default_rng(6)
    for h, w in ((50, 70), (130, 90)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        boxes = np.array([[2, 3, 40, 45, 1.0]], np.float32)
        got = tda.stage_image(img, 96, boxes)
        want = jref.da.stage_image(img, 96, boxes)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert tload.tile_extent(img.shape, 96) == \
            jref.loader.tile_extent(img.shape, 96)
    _, _, params = random_plans(5, 4, 64, (64, 64), range(5), True, True)
    plans = [tda.ExamplePlan(None, None, float(params["lam"][i]),
                             tuple(params["color"][i]), *params["crop"][i],
                             *params["rect"][i][2:], *params["rect"][i][:2],
                             int(params["interp"][i]),
                             bool(params["flip"][i])) for i in range(4)]
    got, want = tda.pack_plans(plans), jref.da.pack_plans(plans)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("mode,pair,emit_gt", [
    ("train", False, False), ("train", True, False), ("train", True, True),
    ("val", False, True)])
def test_plan_example_equal(jref, dataset, mode, pair, emit_gt):
    lines = open(dataset["annotation_file"]).read().splitlines()
    for seed in range(3):
        line = (lines[seed], lines[seed + 2]) if pair else lines[seed]
        args = (line, 3, (96, 64), ANCHORS, mode, seed != 1)
        kw = dict(staged_size=128, emit_gt=emit_gt)
        got = tload.plan_example(*args, np.random.default_rng(seed), **kw)
        want = jref.loader.plan_example(*args, np.random.default_rng(seed),
                                        **kw)
        assert got[0] == want[0]
        for key, value in vars(want[1]).items():
            g = getattr(got[1], key)
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(g, value)
            else:
                assert g == value and type(g) is type(value), key
        for g, w in zip(got[2], want[2]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        # emit_gt on parse_example too
        got = tload.parse_example(*args, np.random.default_rng(seed),
                                  emit_gt=emit_gt)
        want = jref.loader.parse_example(*args, np.random.default_rng(seed),
                                         emit_gt=emit_gt)
        np.testing.assert_array_equal(got[1], want[1])
        for g, w in zip(got[2], want[2]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("device_encode", [False, True])
def test_device_loader_batches_equal(jref, dataset, device_encode):
    kw = dict(mode="train", multi_scale=True, multi_scale_interval=1,
              multi_scale_sizes=(64, 96, 128), use_mix_up=True,
              num_threads=2, seed=2, device_augment=True, staged_size=128,
              device_encode=device_encode, max_boxes=6)
    args = (dataset["annotation_file"], 3, ANCHORS, 3, (96, 96))
    got = list(tload.DataLoader(*args, **kw).epoch(1))
    want = list(jref.loader.DataLoader(*args, **kw).epoch(1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.images is None and w.images is None
        assert tuple(g.img_size) == tuple(w.img_size)
        for key in ("image_ids", "staged", "staged2", "gt_boxes",
                    "gt_labels", "gt_mask"):
            gv, wv = getattr(g, key), getattr(w, key)
            assert (gv is None) == (wv is None), key
            if wv is not None:
                assert gv.dtype == wv.dtype, key
                np.testing.assert_array_equal(gv, wv)
        assert list(g.params) == list(w.params)
        for k in w.params:
            np.testing.assert_array_equal(g.params[k], w.params[k])
        if device_encode:
            assert g.y_true is None and w.y_true is None
        else:
            for gy, wy in zip(g.y_true, w.y_true):
                np.testing.assert_array_equal(gy, wy)


@pytest.mark.cuda
def test_cuda_augment_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for out_size, mixup in (((416, 416), True), ((608, 320), False)):
        staged, staged2, params = random_plans(
            8, 10, 608, out_size, range(5), True, mixup)
        kw = dict(mixup=mixup, distort=True)
        pixel_contract(port_augment(staged, staged2, params, out_size, dev,
                                    **kw),
                       port_augment(staged, staged2, params, out_size, **kw))
