"""Label encoding on the device (counterpart of
`yolov3_tensorflow_tpu/data/device_encode.py`): the host sends padded
ground truth, the device builds the dense label grids.

The host encoder (`data/encoder.py:encode_labels`) makes three dense
[H/s, W/s, 3, 6+C] fp32 grids per image, about 3.6 MB per image at 416^2
with COCO-80, more than the image itself. In device-encode mode the loader
pads the post-augmentation ground truth to a static [M, 5] box array (plus
labels and a validity mask, about 2 KB per image) and the grids are
scattered here, for the whole batch in a few tensor operations.

Parity contract (tests/test_torch_device_encode.py): grids bit-equal to the
host `encode_labels` on the same padded inputs, with its collision rule.
The host loop only ever sets channels, so when two boxes land in the same
(cell, anchor) slot the last one in annotation order wins the coordinates,
objectness and mixup weight, while the class bits of all of them stay set
(a union). Both are reproduced without a loop over boxes: every box that a
later valid box shadows is dropped before the coordinates are written, so
their index list is unique (on CUDA, `index_put_` with repeated indices has
no defined winner), and the class bits are written as ones wherever any
valid box lands, where repeats are harmless. Dropped and padded rows go to
one extra trash row per image, which is sliced off (torch has no
`mode="drop"`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from yolov3_tensorflow_tpu_torch.models.decode import device_anchors

_STRIDES = (32, 16, 8)


def encode_labels_device(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                         gt_mask: torch.Tensor, img_size: Tuple[int, int],
                         num_classes: int, anchors) -> List[torch.Tensor]:
    """Batched label encoding on the tensors' device.

    gt_boxes: [B, M, 5] xyxy + per-box mixup weight (pad rows all-zero);
    gt_labels: [B, M] integer; gt_mask: [B, M] bool; img_size: (width,
    height). Returns the 3 dense grids [B, H/s, W/s, 3, 6+C] for strides
    32/16/8, the contract of stacking the host `encode_labels`.
    """
    w_img, h_img = int(img_size[0]), int(img_size[1])
    dev = gt_boxes.device
    anchors = device_anchors(anchors, dev)
    nch = 6 + num_classes
    b, m = gt_boxes.shape[:2]
    boxes = gt_boxes.to(torch.float32)
    mask = gt_mask.to(torch.bool)
    centers = (boxes[..., 0:2] + boxes[..., 2:4]) * 0.5       # [B, M, 2]
    sizes = boxes[..., 2:4] - boxes[..., 0:2]                 # [B, M, 2]

    # width/height-only anchor IoU (encoder.anchor_iou's formula)
    wh = torch.minimum(sizes[..., None, :], anchors)          # [B, M, 9, 2]
    inter = wh[..., 0] * wh[..., 1]
    union = (sizes[..., None, 0] * sizes[..., None, 1]
             + anchors[:, 0] * anchors[:, 1] - inter)
    best = torch.argmax(inter / (union + 1e-10), dim=-1)      # [B, M]
    scale = 2 - torch.div(best, 3, rounding_mode="floor")     # 6..8 -> 0
    k = torch.remainder(best, 3)             # slot within the scale's group

    # class channels are zero here; a second write unions the class bits
    rows = torch.cat([centers, sizes, torch.ones_like(boxes[..., :1]),
                      boxes.new_zeros((b, m, num_classes)),
                      boxes[..., 4:5]], dim=-1)               # [B, M, 6+C]
    cls_ch = 5 + gt_labels.to(torch.int64).clamp(0, num_classes - 1)
    later = torch.ones((m, m), dtype=torch.bool, device=dev).triu(1)
    image = torch.arange(b, device=dev)[:, None]               # [B, 1]
    grids = []
    for s_idx, stride in enumerate(_STRIDES):
        gw, gh = w_img // stride, h_img // stride
        trash = gh * gw * 3
        x = torch.div(centers[..., 0], stride, rounding_mode="floor").to(
            torch.int64).clamp(0, gw - 1)
        y = torch.div(centers[..., 1], stride, rounding_mode="floor").to(
            torch.int64).clamp(0, gh - 1)
        flat = (y * gw + x) * 3 + k                           # [B, M]
        sel = mask & (scale == s_idx)
        # the last valid box into a slot wins: drop box i when some later
        # valid box j targets the same slot
        same = ((flat[:, None, :] == flat[:, :, None]) & sel[:, None, :]
                & later)
        keep = sel & ~same.any(dim=2)
        grid = boxes.new_zeros((b, trash + 1, nch))
        grid[..., -1] = 1.0                                   # mixup default
        grid.index_put_((image, torch.where(keep, flat, trash)), rows)
        # class-bit union over every valid writer, shadowed ones included
        grid.index_put_((image, torch.where(sel, flat, trash), cls_ch),
                        boxes.new_ones(()))
        grids.append(grid[:, :trash].reshape(b, gh, gw, 3, nch))
    return grids
