"""Darknet `.weights` import and export.

Counterpart of `yolov3_tensorflow_tpu/utils/weights.py`. The model publishes
its darknet layer order (`models.yolov3.darknet_layer_order`: 52 backbone
convs, then 23 head convs, with head conv_6/14/22 bias-carrying), and the
importer maps by name.

File layout: a header of 5 int32s, then per conv layer, float32:
  BN conv:    beta (darknet "biases"), gamma ("scales"), moving mean,
              moving variance, then the kernel
  plain conv: bias, then the kernel
Darknet stores kernels as (out, in, h, w), which is this package's OIHW
layout, so no transpose is needed.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.models.yolov3 import (BACKBONE_PLAN,
                                                       _head_input_channels,
                                                       darknet_layer_order,
                                                       head_plan)


def load_darknet_weights(variables: Dict[str, Any], weights_path: str,
                         num_classes: int = 80) -> Dict[str, Any]:
    """Fill a variable tree (for its shapes and devices, e.g. from
    `models.yolov3.init_yolov3`) from a darknet .weights file.

    Returns a new {"params", "batch_stats"} tree of fp32 tensors, each on
    its counterpart's device. Raises ValueError when the file is too short
    for the architecture or has floats left over, so a truncated or
    misaligned file never loads.
    """
    with open(weights_path, "rb") as f:
        np.fromfile(f, dtype=np.int32, count=5)            # header
        blob = np.fromfile(f, dtype=np.float32)

    params = {k: {n: dict(p) for n, p in v.items()}
              for k, v in variables["params"].items()}
    stats = {k: {n: dict(s) for n, s in v.items()}
             for k, v in variables["batch_stats"].items()}
    ptr = 0

    def read(like: torch.Tensor, shape) -> torch.Tensor:
        nonlocal ptr
        count = int(np.prod(shape))
        if ptr + count > blob.size:
            raise ValueError(
                f"darknet weights file too short: need {ptr + count} floats, "
                f"have {blob.size}")
        out = torch.from_numpy(blob[ptr:ptr + count].reshape(shape).copy())
        ptr += count
        return out.to(like.device)

    for scope, name, has_bn in darknet_layer_order(num_classes):
        p = params[scope][name]
        w = p["w"]
        cout = w.shape[0]
        if has_bn:
            s = stats[scope][name]
            p["beta"] = read(w, (cout,))
            p["gamma"] = read(w, (cout,))
            s["mean"] = read(w, (cout,))
            s["var"] = read(w, (cout,))
        else:
            p["b"] = read(w, (cout,))
        p["w"] = read(w, tuple(w.shape))                   # (out, in, h, w)

    if ptr != blob.size:
        raise ValueError(
            f"darknet weights file has {blob.size - ptr} unread floats: "
            f"architecture mismatch (expected num_classes={num_classes}?)")
    return {"params": params, "batch_stats": stats}


def save_darknet_weights(variables: Dict[str, Any], weights_path: str,
                         num_classes: int = 80) -> None:
    """Inverse of `load_darknet_weights`: writes the same bytes as the JAX
    package's `save_darknet_weights` for the same values."""

    def host(t: torch.Tensor) -> bytes:
        return t.detach().to("cpu", torch.float32).contiguous().numpy() \
            .tobytes()

    chunks = [np.zeros(5, np.int32).tobytes()]
    params, stats = variables["params"], variables["batch_stats"]
    for scope, name, has_bn in darknet_layer_order(num_classes):
        p = params[scope][name]
        if has_bn:
            s = stats[scope][name]
            chunks += [host(t) for t in (p["beta"], p["gamma"], s["mean"],
                                         s["var"])]
        else:
            chunks.append(host(p["b"]))
        chunks.append(host(p["w"]))
    with open(weights_path, "wb") as f:
        f.writelines(chunks)


def expected_weight_count(num_classes: int = 80) -> int:
    """Total float32 count of a darknet file for this architecture
    (excluding the 5-int32 header), from the layer plan."""
    total, cin = 0, 3
    for op in BACKBONE_PLAN:
        if op[0] == "conv":
            _, cout, k, _ = op
            total += cout * cin * k * k + 4 * cout
            cin = cout
    head_cin = _head_input_channels(num_classes)
    for i, cout, k, has_bn in head_plan(num_classes):
        total += cout * head_cin[i] * k * k + (4 if has_bn else 1) * cout
    return total
