"""Synthetic scenes drawn on the device from the seed.

A copy, batched on the device, of the program's synthetic dataset
(`data/synthetic.py:draw_example`): a smooth gray gradient with noise,
then filled circles, boxes and triangles (the kind is the label modulo 3)
in a jittered per-kind color, each with its tight box as ground truth.
Unlike the host original, shapes may overlap (a later one is drawn over an
earlier one, whose box stays in the ground truth, as an occluded object's
annotation does), and one call draws a whole batch.
"""

from __future__ import annotations

from typing import Dict

import torch

# base BGR color per kind, as the original's
BASE_COLORS = ((60, 60, 220), (80, 200, 80), (220, 140, 40))


def draw(gen: torch.Generator, n: int, hw, *, num_classes: int,
         boxes_min: int, boxes_max: int) -> Dict[str, torch.Tensor]:
    """n scenes of size hw = (H, W) on the generator's device: "images"
    uint8 BGR [n, H, W, 3], "boxes" float32 [n, M, 4] xyxy pixels, "labels"
    int64 [n, M], "mask" bool [n, M], M = boxes_max, with boxes_min to
    boxes_max shapes an image, each 12% to 42% of the shorter side."""
    dev = gen.device
    h, w = int(hw[0]), int(hw[1])
    m = boxes_max

    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    base = 90 + 75 * u(n, 1, 1, 1)
    gx, gy = 80 * u(n, 1, 1, 1) - 40, 80 * u(n, 1, 1, 1) - 40
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1, 1)
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w, 1)
    img = base + gx * (xs / w - 0.5) + gy * (ys / h - 0.5)
    img = img + 6 * torch.randn(n, h, w, 3, generator=gen, device=dev)

    count = boxes_min + (u(n) * (boxes_max - boxes_min + 1)).long().clamp(
        max=boxes_max - boxes_min)
    mask = torch.arange(m, device=dev)[None] < count[:, None]
    labels = (u(n, m) * num_classes).long().clamp(max=num_classes - 1)
    short = min(h, w)
    size = short * (0.12 + 0.30 * u(n, m))
    cx = size / 2 + 8 + u(n, m) * (w - size - 16)
    cy = size / 2 + 8 + u(n, m) * (h - size - 16)
    boxes = torch.stack([cx - size / 2, cy - size / 2, cx + size / 2,
                         cy + size / 2], -1)
    base_c = torch.tensor(BASE_COLORS, dtype=torch.float32, device=dev)
    color = (base_c[labels % 3] + 18 * torch.randn(n, m, 3, generator=gen,
                                                   device=dev)).clamp(30, 255)
    for j in range(m):
        x0, y0, x1, y1 = (boxes[:, j, i].view(n, 1, 1) for i in range(4))
        c_x, c_y = cx[:, j].view(n, 1, 1), cy[:, j].view(n, 1, 1)
        r = size[:, j].view(n, 1, 1) / 2
        y, x = ys[..., 0], xs[..., 0]
        inside_box = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        circle = (x - c_x) ** 2 + (y - c_y) ** 2 <= r ** 2
        tri = inside_box & ((x - c_x).abs() * (y1 - y0)
                            <= (y - y0) * r)
        kind = (labels[:, j] % 3).view(n, 1, 1)
        shape = torch.where(kind == 0, circle,
                            torch.where(kind == 1, inside_box, tri))
        shape &= mask[:, j].view(n, 1, 1)
        img = torch.where(shape[..., None], color[:, j].view(n, 1, 1, 3), img)
    images = img.clamp(0, 255).to(torch.uint8)
    boxes = torch.where(mask[..., None], boxes, 0.0)
    return {"images": images, "boxes": boxes, "labels": labels,
            "mask": mask}


def to_rgb_float(images_bgr: torch.Tensor) -> torch.Tensor:
    """uint8 BGR [n, H, W, 3] -> float32 RGB in [0, 1], as a network
    input."""
    return images_bgr.flip(-1).float().div_(255.0)
