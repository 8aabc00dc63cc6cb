"""The port's host data path against the JAX package's, on the CPU: the
copied annotation parser, label encoder, augmentation functions and
synthetic dataset give the same bytes on the same seeded inputs, and the
threaded loader gives the same batches (images, label grids, ids and sizes)
for the same seed, in train mode (mixup, color distortion, multi-scale) and
in val mode."""

from pathlib import Path

import cv2
import numpy as np
import pytest

from yolov3_tensorflow_tpu.data import annotations as ja
from yolov3_tensorflow_tpu.data import augment as jaug
from yolov3_tensorflow_tpu.data import encoder as jenc
from yolov3_tensorflow_tpu.data import loader as jload
from yolov3_tensorflow_tpu.data import synthetic as jsyn
from yolov3_tensorflow_tpu_torch.config import DEFAULT_ANCHORS
from yolov3_tensorflow_tpu_torch.data import annotations as ta
from yolov3_tensorflow_tpu_torch.data import augment as taug
from yolov3_tensorflow_tpu_torch.data import encoder as tenc
from yolov3_tensorflow_tpu_torch.data import loader as tload
from yolov3_tensorflow_tpu_torch.data import synthetic as tsyn

ANCHORS = np.asarray(DEFAULT_ANCHORS, np.float32)


def equal(got, want):
    """Recursive exact equality of nests of arrays, tuples and scalars."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif hasattr(want, "__dataclass_fields__"):
        assert type(got).__name__ == type(want).__name__
        assert list(vars(got)) == list(vars(want))
        for key, value in vars(want).items():
            equal(getattr(got, key), value)
    else:
        assert got == want


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    port = tsyn.generate_dataset(str(root / "port"), num_images=8, seed=3,
                                 img_size=(120, 100), max_shapes=3)
    ref = jsyn.generate_dataset(str(root / "jax"), num_images=8, seed=3,
                                img_size=(120, 100), max_shapes=3)
    return root, port, ref


def test_synthetic_dataset_byte_equal(dataset):
    root, port, ref = dataset
    names = sorted(p.name for p in (root / "jax").iterdir())
    assert names == sorted(p.name for p in (root / "port").iterdir())
    assert len(names) == 10                  # 8 jpgs, annotations, names
    for name in names:
        got = (root / "port" / name).read_bytes()
        want = (root / "jax" / name).read_bytes()
        if name.endswith(".txt"):
            want = want.replace(str(root / "jax").encode(),
                                str(root / "port").encode())
        assert got == want, name
    rng_a, rng_b = (np.random.default_rng(5) for _ in range(2))
    equal(tsyn.draw_example(rng_a, (96, 96), 3, 80),
          jsyn.draw_example(rng_b, (96, 96), 3, 80))
    assert tsyn.SYNTH_CLASS_NAMES == jsyn.SYNTH_CLASS_NAMES


def test_annotations_equal(dataset):
    _, port, _ = dataset
    lines = ta.read_annotation_file(port["annotation_file"])
    assert lines == ja.read_annotation_file(port["annotation_file"])
    for line in lines + [line.encode() for line in lines[:2]]:
        got, want = ta.parse_line(line), ja.parse_line(line)
        equal(got, want)
    for bad in ("0 a.jpg 10 10", "0 a.jpg 10 10 1 2 3 4"):
        with pytest.raises(ValueError) as e1:
            ta.parse_line(bad)
        with pytest.raises(ValueError) as e2:
            ja.parse_line(bad)
        assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("size", [(416, 416), (96, 64), (608, 320)])
@pytest.mark.parametrize("mixup", [False, True])
def test_encode_labels_equal(size, mixup):
    rng = np.random.default_rng(size[0] + mixup)
    n = 12
    xy = rng.uniform(0, min(size) - 40, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 200, (n, 2))], 1)
    boxes[0, 2:4] = size                   # a center on the far edges
    boxes = boxes.astype(np.float32)
    if mixup:
        boxes = np.concatenate([boxes, rng.uniform(0.2, 1, (n, 1))
                                .astype(np.float32)], 1)
    labels = rng.integers(0, 80, n)
    equal(tenc.encode_labels(boxes, labels, size, 80, ANCHORS),
          jenc.encode_labels(boxes, labels, size, 80, ANCHORS))
    equal(tenc.encode_labels(boxes[:0], labels[:0], size, 80, ANCHORS),
          jenc.encode_labels(boxes[:0], labels[:0], size, 80, ANCHORS))
    equal(tenc.anchor_iou(boxes[:, 2:4] - boxes[:, 0:2], ANCHORS),
          jenc.anchor_iou(boxes[:, 2:4] - boxes[:, 0:2], ANCHORS))


def _image(seed, hw=(90, 120)):
    return np.random.default_rng(seed).integers(0, 255, hw + (3,),
                                                dtype=np.uint8)


def _boxes(seed, n=4, w=120, h=90, weight=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, [w - 30, h - 30], (n, 2))
    b = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], 1)
    if weight:
        b = np.concatenate([b, rng.uniform(0.3, 1, (n, 1))], 1)
    return b.astype(np.float32)


# each case: module -> result on a generator made from the case's seed
AUGMENT_CASES = {
    "sample_mixup_lam": lambda m, r: m.sample_mixup_lam(r),
    "mixup_boxes": lambda m, r: m.mixup_boxes(_boxes(1), _boxes(2), 0.3),
    "mix_up": lambda m, r: m.mix_up(_image(1), _image(2, (70, 140)),
                                    _boxes(1), _boxes(2), r),
    "crop_boxes": lambda m, r: m.crop_boxes(_boxes(3, 8, weight=True),
                                            (10, 5, 80, 60),
                                            return_mask=True),
    "crop_boxes_any_center": lambda m, r: m.crop_boxes(
        _boxes(3, 8), (10, 5, 80, 60), require_center_inside=False),
    "random_crop": lambda m, r: m.random_crop_with_constraints(
        _boxes(4, 6, weight=True), (120, 90), r),
    "random_crop_labels": lambda m, r: m.random_crop_with_constraints(
        _boxes(4, 6), (120, 90), r, labels=np.arange(6)),
    "random_crop_no_boxes": lambda m, r: m.random_crop_with_constraints(
        _boxes(4, 6)[:0], (120, 90), r, labels=np.arange(0)),
    "sample_color_distort": lambda m, r: m.sample_color_distort(r),
    "random_color_distort": lambda m, r: m.random_color_distort(_image(5),
                                                                r),
    "apply_color_distort": lambda m, r: m.apply_color_distort(
        _image(6), m.ColorDistortParams(12.0, -7.0, 1.3, 0.6)),
    "resize_letterbox": lambda m, r: m.resize_with_boxes(
        _image(7), _boxes(7), 96, 64, interp=2, letterbox=True),
    "resize_plain": lambda m, r: m.resize_with_boxes(
        _image(7), _boxes(7), 64, 96, interp=3, letterbox=False),
    "remap_boxes_resize": lambda m, r: m.remap_boxes_resize(
        _boxes(8, weight=True), 120, 90, 416, 416, True),
    "random_flip": lambda m, r: m.random_flip(_image(9), _boxes(9), r,
                                              px=0.5, py=0.5),
    "flip_boxes": lambda m, r: m.flip_boxes(_boxes(9), 90, 120, True, True),
    "random_expand": lambda m, r: m.random_expand(_image(10), _boxes(10), r,
                                                  max_ratio=3),
    "random_expand_free_ratio": lambda m, r: m.random_expand(
        _image(10), _boxes(10), r, fill=128, keep_ratio=False),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(AUGMENT_CASES))
def test_augment_equal(case, seed):
    fn = AUGMENT_CASES[case]
    got = fn(taug, np.random.default_rng(seed))
    want = fn(jaug, np.random.default_rng(seed))
    equal(got, want)


def test_multi_scale_size_equal():
    for step in range(0, 200, 7):
        for kw in ({}, {"sizes": ((64, 64), (96, 96))}, {"enabled": False}):
            assert (tload.multi_scale_size(step, 10, 3, (416, 416), **kw)
                    == jload.multi_scale_size(step, 10, 3, (416, 416), **kw))
    assert tload.MULTI_SCALE_SIZES == jload.MULTI_SCALE_SIZES


LOADERS = {
    "train": dict(mode="train", multi_scale=True, multi_scale_interval=1,
                  multi_scale_sizes=(64, 96), use_mix_up=True,
                  use_color_distort=True),
    "train_plain": dict(mode="train", use_mix_up=False,
                        use_color_distort=False, letterbox=False),
    "val": dict(mode="val"),
}


@pytest.mark.parametrize("kind", sorted(LOADERS))
def test_loader_batches_equal(dataset, kind):
    _, port, _ = dataset
    kw = dict(LOADERS[kind], num_threads=3, prefetch=2, seed=2)
    args = (port["annotation_file"], 3, ANCHORS, 3, (96, 96))
    tl = tload.DataLoader(*args, **kw)
    jl = jload.DataLoader(*args, **kw)
    assert len(tl) == len(jl) == 3 and tl.num_examples() == 8
    for epoch in (0, 1):
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            equal(g.image_ids, w.image_ids)
            equal(g.images, w.images)
            equal(g.y_true, w.y_true)
            assert tuple(g.img_size) == tuple(w.img_size)
            assert g.images.shape[1:3] == tuple(g.img_size)[::-1]
        if kind == "train":
            assert len({b.img_size for b in got}) > 1   # multi-scale moved


def test_loader_shards_equal(dataset):
    _, port, _ = dataset
    args = (port["annotation_file"], 3, ANCHORS, 4, (64, 64))
    for kw in ({"shard_within_batch": (1, 2)}, {"shard_batches": (1, 2),
                                                 "mode": "val"}):
        got = list(tload.DataLoader(*args, num_threads=2, **kw).epoch(0))
        want = list(jload.DataLoader(*args, num_threads=2, **kw).epoch(0))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            equal(g.images, w.images)
            equal(g.y_true, w.y_true)


@pytest.mark.parametrize("mode", ["device_augment", "device_encode"])
def test_device_data_path_refused(dataset, mode):
    """The device-resident modes, refused before they were ported, now
    give batches of their own kind (tests/test_torch_device_augment.py
    holds them equal to the JAX loader's)."""
    _, port, _ = dataset
    batch = next(iter(tload.DataLoader(port["annotation_file"], 3, ANCHORS,
                                       2, (64, 64), num_threads=2,
                                       **{mode: True}).epoch(0)))
    if mode == "device_augment":
        assert batch.images is None and batch.staged.dtype == np.uint8
        assert batch.staged.shape == (2, 512, 512, 3)
        assert len(batch.y_true) == 3
    else:
        assert batch.y_true is None and batch.images.shape == (2, 64, 64, 3)
        assert batch.gt_boxes.shape == (2, 64, 5) and batch.gt_mask.any()


def test_missing_image_raises(tmp_path):
    ann = tmp_path / "a.txt"
    ann.write_text(f"0 {tmp_path / 'none.jpg'} 10 10 0 1 1 5 5\n")
    loader = tload.DataLoader(str(ann), 1, ANCHORS, 1, (64, 64), mode="val",
                              num_threads=1)
    with pytest.raises(FileNotFoundError):
        list(loader.epoch(0))
    assert not Path(tmp_path / "none.jpg").exists()
    assert cv2.imread(str(tmp_path / "none.jpg")) is None
