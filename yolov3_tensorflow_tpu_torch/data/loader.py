"""Threaded host data loader, copied from the JAX package's `data/loader.py`
(tests hold its batches equal to the JAX loader's for the same seed, in
every mode):

- per-image work (imread -> augment -> encode) fans out over a thread pool
  (cv2 and numpy release the GIL)
- a background producer keeps a bounded prefetch queue full
- multi-scale training picks the batch resolution from a deterministic
  step-indexed PRNG over the 10 sizes {320..608}, one size every
  `multi_scale_interval` batches
- mixup pairs a line with another random line of its batch with
  probability 0.5

Batches are numpy; the trainer moves them to the device. In the device-
resident modes the loader sends less and the device does the rest:
`device_augment` gives staged uint8 tiles and the packed transform
parameters of `plan_example` instead of float images
(`data/device_augment.py` makes the pixels), and `device_encode` gives the
padded post-augmentation ground truth instead of the label grids
(`data/device_encode.py` makes them).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import cv2
import numpy as np

from yolov3_tensorflow_tpu_torch.data import augment
from yolov3_tensorflow_tpu_torch.data.annotations import (parse_line,
                                                          read_annotation_file)
from yolov3_tensorflow_tpu_torch.data.device_augment import (ExamplePlan,
                                                            pack_plans,
                                                            stage_image)
from yolov3_tensorflow_tpu_torch.data.encoder import (encode_labels,
                                                      pad_ground_truth)

MULTI_SCALE_SIZES: Tuple[Tuple[int, int], ...] = tuple(
    (x * 32, x * 32) for x in range(10, 20))


def multi_scale_size(step: int, interval: int = 10, seed: int = 0,
                     base_size: Tuple[int, int] = (416, 416),
                     enabled: bool = True,
                     sizes: Optional[Sequence[Tuple[int, int]]] = None
                     ) -> Tuple[int, int]:
    """Deterministic multi-scale schedule: one size per `interval` batches.

    `sizes` overrides the bucket set (default: the absolute {320..608}
    grid, sized for a 416 base)."""
    if not enabled:
        return base_size
    buckets = tuple(sizes) if sizes else MULTI_SCALE_SIZES
    rng = np.random.default_rng((seed, step // interval))
    return buckets[int(rng.integers(0, len(buckets)))]


@dataclass
class Batch:
    image_ids: np.ndarray   # [B] int64
    images: np.ndarray      # [B, H, W, 3] float32 RGB in [0, 1]; None in
                            # device-augment mode (see staged/params)
    y_true: Tuple[np.ndarray, np.ndarray, np.ndarray]  # strides 32/16/8;
                            # None in device-encode mode (see gt_*)
    # device-augment mode: staged uint8 tiles and the packed transform
    # parameters; device_augment.augment_batch makes the images
    staged: np.ndarray = None      # [B, S, S, 3] uint8 BGR
    staged2: np.ndarray = None     # [B, S, S, 3] uint8 BGR (mixup partners;
                                   # `staged` itself when mixup is off)
    params: dict = None            # device_augment.pack_plans arrays
    img_size: Tuple[int, int] = None   # (w, h) of this batch
    # device-encode mode: the padded ground truth that
    # device_encode.encode_labels_device scatters into the grids
    gt_boxes: np.ndarray = None    # [B, M, 5] xyxy + mixup weight
    gt_labels: np.ndarray = None   # [B, M] int32
    gt_mask: np.ndarray = None     # [B, M] bool


def parse_example(line: Union[str, Tuple[str, str]], num_classes: int,
                  img_size: Tuple[int, int], anchors: np.ndarray,
                  mode: str, letterbox: bool, rng: np.random.Generator,
                  use_color_distort: bool = True, emit_gt: bool = False):
    """Load + augment + encode one example.

    `line` is a single annotation line, or a pair for mixup. img_size is
    (width, height). Returns (img_idx, image, y_true_list), or
    (img_idx, image, (boxes, labels)), the raw post-augmentation ground
    truth, when emit_gt=True (device-encode mode).
    """
    if isinstance(line, tuple):
        a1, a2 = parse_line(line[0]), parse_line(line[1])
        img1, img2 = cv2.imread(a1.path), cv2.imread(a2.path)
        if img1 is None:
            raise FileNotFoundError(f"cannot read image: {a1.path}")
        if img2 is None:
            raise FileNotFoundError(f"cannot read image: {a2.path}")
        img, boxes = augment.mix_up(img1, img2, a1.boxes, a2.boxes, rng)
        labels = np.concatenate([a1.labels, a2.labels])
        img_idx = a2.index
    else:
        ann = parse_line(line)
        img = cv2.imread(ann.path)
        if img is None:
            raise FileNotFoundError(f"cannot read image: {ann.path}")
        boxes = np.concatenate(
            [ann.boxes, np.ones((ann.boxes.shape[0], 1), np.float32)], axis=-1)
        labels = ann.labels
        img_idx = ann.index

    if mode == "train":
        if use_color_distort:
            img = augment.random_color_distort(img, rng)
        if rng.uniform() > 0.5:
            img, boxes = augment.random_expand(img, boxes, rng, max_ratio=4)
        h, w = img.shape[:2]
        boxes, labels, crop = augment.random_crop_with_constraints(
            boxes, (w, h), rng, labels=labels)
        x0, y0, cw, ch = crop
        img = img[y0:y0 + ch, x0:x0 + cw]
        interp = int(rng.integers(0, 5))
        img, boxes = augment.resize_with_boxes(
            img, boxes, img_size[0], img_size[1], interp=interp,
            letterbox=letterbox)
        img, boxes = augment.random_flip(img, boxes, rng, px=0.5)
    else:
        img, boxes = augment.resize_with_boxes(
            img, boxes, img_size[0], img_size[1], interp=1,
            letterbox=letterbox)

    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    if emit_gt:
        return img_idx, img, (boxes, labels)
    y_true = encode_labels(boxes, labels, img_size, num_classes, anchors)
    return img_idx, img, y_true


def plan_example(line: Union[str, Tuple[str, str]], num_classes: int,
                 img_size: Tuple[int, int], anchors: np.ndarray,
                 mode: str, letterbox: bool, rng: np.random.Generator,
                 use_color_distort: bool = True, staged_size: int = 512,
                 emit_gt: bool = False):
    """Device-augment twin of `parse_example`: decode + draw + box geometry
    on the host, pixels deferred to the device (data/device_augment.py).

    Consumes the PRNG stream in exactly `parse_example`'s order (shared
    sampler functions), so a fixed (seed, epoch, step, slot) key produces
    the same transform in both modes. Returns
    (img_idx, ExamplePlan, y_true_list), or (img_idx, ExamplePlan,
    (boxes, labels)) when emit_gt=True (device-encode mode).
    """
    if isinstance(line, tuple):
        a1, a2 = parse_line(line[0]), parse_line(line[1])
        img1, img2 = cv2.imread(a1.path), cv2.imread(a2.path)
        if img1 is None:
            raise FileNotFoundError(f"cannot read image: {a1.path}")
        if img2 is None:
            raise FileNotFoundError(f"cannot read image: {a2.path}")
        lam = augment.sample_mixup_lam(rng)
        tile1, boxes1 = stage_image(img1, staged_size, a1.boxes)
        tile2, boxes2 = stage_image(img2, staged_size, a2.boxes)
        boxes = augment.mixup_boxes(boxes1, boxes2, lam)
        labels = np.concatenate([a1.labels, a2.labels])
        img_idx = a2.index
        h1, w1 = tile_extent(img1.shape, staged_size)
        h2, w2 = tile_extent(img2.shape, staged_size)
        h, w = max(h1, h2), max(w1, w2)
    else:
        ann = parse_line(line)
        img = cv2.imread(ann.path)
        if img is None:
            raise FileNotFoundError(f"cannot read image: {ann.path}")
        bw = np.concatenate(
            [ann.boxes, np.ones((ann.boxes.shape[0], 1), np.float32)], axis=-1)
        tile1, boxes = stage_image(img, staged_size, bw)
        tile2, lam = None, 1.0
        labels = ann.labels
        img_idx = ann.index
        h, w = tile_extent(img.shape, staged_size)

    color = (0.0, 0.0, 1.0, 1.0)
    if mode == "train":
        if use_color_distort:
            cp = augment.sample_color_distort(rng)
            color = (cp.delta, cp.hue_delta, cp.sat_mult, cp.val_mult)
        if rng.uniform() > 0.5:
            oh, ow, oy, ox = augment.sample_expand(rng, h, w, max_ratio=4)
        else:
            oh, ow, oy, ox = h, w, 0, 0
        boxes = boxes.copy()
        boxes[:, 0:4] += np.array([ox, oy, ox, oy], boxes.dtype)
        boxes, labels, (cx, cy, cw, ch) = augment.random_crop_with_constraints(
            boxes, (ow, oh), rng, labels=labels)
        interp = int(rng.integers(0, 5))
        boxes = augment.remap_boxes_resize(boxes, cw, ch, img_size[0],
                                           img_size[1], letterbox)
        fx, _ = augment.sample_flip(rng, px=0.5)
        boxes = augment.flip_boxes(boxes, img_size[1], img_size[0], fx, False)
        crop = (cx - ox, cy - oy, cw, ch)
    else:
        boxes = augment.remap_boxes_resize(boxes, w, h, img_size[0],
                                           img_size[1], letterbox)
        crop = (0, 0, w, h)
        interp, fx = 1, False

    if letterbox:
        _, rw, rh, dw, dh = augment.letterbox_params(
            crop[2], crop[3], img_size[0], img_size[1])
    else:
        rw, rh, dw, dh = img_size[0], img_size[1], 0, 0

    plan = ExamplePlan(
        staged=tile1, staged2=tile2, lam=lam, color=color,
        crop_x0=int(crop[0]), crop_y0=int(crop[1]), crop_w=int(crop[2]),
        crop_h=int(crop[3]), rw=rw, rh=rh, dw=dw, dh=dh, interp=interp,
        flip=fx)
    if emit_gt:
        return img_idx, plan, (boxes, labels)
    y_true = encode_labels(boxes, labels, img_size, num_classes, anchors)
    return img_idx, plan, y_true


def tile_extent(shape, staged_size: int) -> Tuple[int, int]:
    """Valid (h, w) of an image once staged into a staged_size tile."""
    h, w = shape[:2]
    if max(h, w) > staged_size:
        r = staged_size / max(h, w)
        return max(int(h * r), 1), max(int(w * r), 1)
    return h, w


class DataLoader:
    """Epoch iterator producing ready-to-copy numpy batches.

    Deterministic given `seed`: shuffling, multi-scale sizes, mixup pairing
    and all augmentation draws derive from per-(epoch, step, slot) PRNG keys.
    """

    def __init__(self, annotation_file: str, num_classes: int,
                 anchors: np.ndarray, batch_size: int,
                 img_size: Tuple[int, int] = (416, 416), mode: str = "train",
                 letterbox: bool = True, multi_scale: bool = False,
                 multi_scale_interval: int = 10, use_mix_up: bool = False,
                 use_color_distort: bool = True, num_threads: int = 10,
                 prefetch: int = 5, seed: int = 0,
                 drop_remainder: bool = False,
                 shard_within_batch: Tuple[int, int] = (0, 1),
                 shard_batches: Tuple[int, int] = (0, 1),
                 device_augment: bool = False, staged_size: int = 512,
                 device_encode: bool = False, max_boxes: int = 64,
                 multi_scale_sizes: Optional[Sequence] = None):
        """`shard_within_batch=(i, P)` makes this loader produce only its
        1/P slice of every global batch (every process sees the same
        step, plan and multi-scale schedule; `batch_size` stays the global
        batch). `shard_batches=(i, P)` yields only plan batches i, i+P, ...
        `device_augment` stages every image into a `staged_size` tile;
        `device_encode` pads the ground truth to `max_boxes` rows.
        """
        self.lines = read_annotation_file(annotation_file)
        self.num_classes = num_classes
        self.anchors = np.asarray(anchors, np.float32)
        self.batch_size = batch_size
        self.img_size = tuple(img_size)
        self.mode = mode
        self.letterbox = letterbox
        self.multi_scale = multi_scale and mode == "train"
        self.multi_scale_interval = multi_scale_interval
        self.multi_scale_sizes = (
            tuple((int(s), int(s)) if np.isscalar(s) else tuple(s)
                  for s in multi_scale_sizes) if multi_scale_sizes else None)
        self.use_mix_up = use_mix_up and mode == "train"
        self.use_color_distort = use_color_distort
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.shard_within_batch = tuple(shard_within_batch)
        self.shard_batches = tuple(shard_batches)
        self.device_augment = device_augment
        self.staged_size = int(staged_size)
        self.device_encode = device_encode
        self.max_boxes = int(max_boxes)
        if self.shard_within_batch[1] > 1 \
                and batch_size % self.shard_within_batch[1] != 0:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"process count {self.shard_within_batch[1]}")

    def _num_global_batches(self) -> int:
        n = len(self.lines)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        nb = self._num_global_batches()
        idx, cnt = self.shard_batches
        if cnt > 1:
            nb = max(0, (nb - idx + cnt - 1) // cnt)
        return nb

    def num_examples(self) -> int:
        return len(self.lines)

    def _epoch_plan(self, epoch: int) -> List[List[Union[str, Tuple[str, str]]]]:
        """Shuffle + batch + mixup-pair the epoch's lines, deterministically."""
        rng = np.random.default_rng((self.seed, epoch))
        order = (rng.permutation(len(self.lines)) if self.mode == "train"
                 else np.arange(len(self.lines)))
        batches: List[List[Union[str, Tuple[str, str]]]] = []
        nb = self._num_global_batches()
        for b in range(nb):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch: List[Union[str, Tuple[str, str]]] = [self.lines[i] for i in idx]
            if self.use_mix_up and len(batch) > 1:
                paired: List[Union[str, Tuple[str, str]]] = []
                for j, line in enumerate(batch):
                    if rng.uniform() < 0.5:
                        others = [k for k in range(len(batch)) if k != j]
                        mate = batch[int(others[int(rng.integers(0, len(others)))])]
                        paired.append((line, mate if isinstance(mate, str) else mate[0]))
                    else:
                        paired.append(line)
                batch = paired
            batches.append(batch)
        return batches

    def _make_batch(self, epoch: int, step: int,
                    batch_lines: Sequence[Union[str, Tuple[str, str]]],
                    pool: ThreadPoolExecutor) -> Batch:
        img_size = multi_scale_size(
            step, self.multi_scale_interval, self.seed, self.img_size,
            enabled=self.multi_scale, sizes=self.multi_scale_sizes)

        # a sharded loader materializes only its contiguous slice of the
        # global batch; PRNG slots stay global row indices, so augmentation
        # is bit-identical to the unsharded run
        slot0 = 0
        pi, pc = self.shard_within_batch
        if pc > 1:
            per = self.batch_size // pc
            slot0 = pi * per
            batch_lines = batch_lines[slot0:slot0 + per]

        def work(slot_and_line):
            slot, line = slot_and_line
            rng = np.random.default_rng((self.seed, epoch, step, slot))
            if self.device_augment:
                return plan_example(line, self.num_classes, img_size,
                                    self.anchors, self.mode, self.letterbox,
                                    rng, self.use_color_distort,
                                    self.staged_size,
                                    emit_gt=self.device_encode)
            return parse_example(line, self.num_classes, img_size,
                                 self.anchors, self.mode, self.letterbox, rng,
                                 self.use_color_distort,
                                 emit_gt=self.device_encode)

        results = list(pool.map(work, enumerate(batch_lines, start=slot0)))
        ids = np.asarray([r[0] for r in results], np.int64)
        if self.device_encode:
            y_true = None
            padded = [pad_ground_truth(b, l, self.max_boxes)
                      for _, _, (b, l) in results]
            gt = {"gt_boxes": np.stack([p[0] for p in padded]),
                  "gt_labels": np.stack([p[1] for p in padded]),
                  "gt_mask": np.stack([p[2] for p in padded])}
        else:
            y_true = tuple(
                np.stack([r[2][s] for r in results]) for s in range(3))
            gt = {}
        if self.device_augment:
            plans = [r[1] for r in results]
            staged = np.stack([p.staged for p in plans])
            if any(p.staged2 is not None for p in plans):
                zero = np.zeros_like(plans[0].staged)
                staged2 = np.stack([p.staged2 if p.staged2 is not None
                                    else zero for p in plans])
            else:
                staged2 = staged       # ignored when mixup is off
            return Batch(ids, None, y_true, staged=staged, staged2=staged2,
                         params=pack_plans(plans), img_size=img_size, **gt)
        images = np.stack([r[1] for r in results])
        return Batch(ids, images, y_true, img_size=img_size, **gt)

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Iterate one epoch with background prefetching."""
        plan = self._epoch_plan(epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: List[BaseException] = []

        bi, bc = self.shard_batches
        wi, wc = self.shard_within_batch

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for step, batch_lines in enumerate(plan):
                        if bc > 1 and step % bc != bi:
                            continue  # not this shard's batch
                        if wc > 1 and len(batch_lines) < self.batch_size:
                            continue  # ragged remainder can't split evenly
                        q.put(self._make_batch(epoch, step, batch_lines, pool))
            except BaseException as e:  # surfaced to the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if error:
            raise error[0]

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch(0)
