"""Carrying variables across from the JAX package, and the spread head.

`from_jax_variables` turns the JAX `{"params", "batch_stats"}` tree (nested
dicts of numpy arrays, e.g. `jax.device_get(init_yolov3(...))`) into this
package's tree, so that tests can give both packages the same weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.models.yolov3 import DETECTION_CONVS


def from_jax_variables(variables: Dict[str, Any], *,
                       device: torch.device) -> Dict[str, Any]:
    """JAX variable tree (numpy leaves) -> torch tree on `device`.

    4-D leaves are conv kernels and go from HWIO to OIHW; every other leaf
    keeps its shape. Values are copied unchanged (fp32 stays fp32)."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, copy=True))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device)

    return convert(variables)


def spread_head(variables: Dict[str, Any], *, seed: int = 0
                ) -> Dict[str, Any]:
    """Spread the detection logits of randomly initialized weights.

    Why this exists: with random-init weights every detection logit stays
    near 0, so every score is about sigmoid(0)^2 = 0.25 and the serving
    threshold (0.3) leaves no valid candidate: NMS would never run on real
    work. This deterministic transform scales the three detection convs'
    kernels (head conv_6 / conv_14 / conv_22) by 8 and draws their
    biases from a numpy generator seeded with `seed`: class logits around
    -3.5, the objectness logit around +1, box logits around 0. On random
    inputs each image then has tens (96^2) to a hundred (416^2) detections,
    and at an IoU threshold of 0.45 NMS suppresses a fifth (96^2) to four
    fifths (416^2) of the candidates that pass the score threshold.

    Works on either package's tree (numpy or torch leaves): the kernels
    are only scaled, so HWIO and OIHW need no distinction. Returns a new
    tree; the input is not modified.
    """
    rng = np.random.default_rng(seed)
    params = dict(variables["params"])
    params["head"] = dict(params["head"])
    for name in DETECTION_CONVS:
        p = params["head"][name]
        need = p["b"].shape[0] // 3              # 5 + num_classes per anchor
        b = np.empty((3, need), np.float32)
        b[:, 0:4] = rng.normal(0.0, 0.5, (3, 4))          # tx ty tw th
        b[:, 4] = rng.normal(1.0, 1.0, 3)                 # objectness
        b[:, 5:] = rng.normal(-3.5, 1.0, (3, need - 5))   # class logits
        b = b.reshape(-1)
        if isinstance(p["b"], torch.Tensor):
            b = torch.from_numpy(b).to(p["b"].device)
        params["head"][name] = {"w": p["w"] * 8.0, "b": b}
    return {**variables, "params": params}
