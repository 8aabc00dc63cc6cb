"""Weights drawn from the seed, on the device, in a few large calls.

The shapes are the reference's `conv_table` (Darknet-53 and the FPN head
at their published widths). Kernels are glorot-uniform, as darknet-trained
YOLOv3 ports initialise them; the batch-norm parameters and moving
statistics are drawn near their initial values (gamma and var in
[0.9, 1.1], beta and mean in [-0.02, 0.02]) so that folding them is real
work; wider draws compound over the 23 residual blocks until every
anchor's score saturates. `spread=True` follows the program's spread head
(`models/convert.py:spread_head`): the three detection kernels times 8
and their biases spread as box logits N(0, 0.5), objectness N(1, 1) and
class logits N(-3.5, 1), so that at the serving score 0.3 each image keeps
tens of candidates and NMS has real work, as on a trained detector.

The seed must not change that work. Drawn at random, a seed with a few
high class biases on the finest scale gave its images several times the
candidates of another seed, and the NMS kernel several times its time. So
each group of biases is the same set of values in every seed, the
normal's quantiles, in an order the seed draws (each anchor slot the same
class biases, each scale the same objectness and box biases), and
`calibrate` then shifts every class bias by the one amount that gives a
cell's own first images a stated number of candidates.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import Net, conv_table, flat_rows


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A torch.Generator on `device` seeded from any whole number; each
    `stream` (weights 0, inputs 1, ...) draws apart from the others."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def draw(seed: int, num_classes: int, device, *, spread: bool
         ) -> Dict[str, dict]:
    """The {"params", "batch_stats"} tree for `seed`, float32 on
    `device`."""
    gen = generator(seed, device, stream=0)
    table = conv_table(num_classes)
    sizes = [cout * cin * k * k for _, _, cin, cout, k, _, _ in table]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    n_bn = sum(row[3] for row in table if row[6])
    v = torch.rand(4, n_bn, generator=gen, device=device)
    c = num_classes
    # per detection conv: each anchor slot the same set of class biases,
    # each conv the same objectness and box biases, in the seed's orders
    spread_b = [torch.cat([quantiles(gen, 12, 0.0, 0.5, device).view(3, 4),
                           quantiles(gen, 3, 1.0, 1.0, device).view(3, 1),
                           torch.stack([quantiles(gen, c, -3.5, 1.0, device)
                                        for _ in range(3)])], 1)
                for _ in range(3)]
    params: Dict[str, dict] = {"backbone": {}, "head": {}}
    stats: Dict[str, dict] = {"backbone": {}, "head": {}}
    ofs = bn_ofs = det = 0
    for (scope, name, cin, cout, k, _, has_bn), size in zip(table, sizes):
        limit = math.sqrt(6.0 / (k * k * cin + k * k * cout))
        w = (u[ofs:ofs + size] * 2 - 1).mul_(limit).view(cout, cin, k, k)
        ofs += size
        if has_bn:
            r = v[:, bn_ofs:bn_ofs + cout]
            bn_ofs += cout
            params[scope][name] = {"w": w, "gamma": 0.9 + 0.2 * r[0],
                                   "beta": 0.04 * r[1] - 0.02}
            stats[scope][name] = {"mean": 0.04 * r[2] - 0.02,
                                  "var": 0.9 + 0.2 * r[3]}
            continue
        b = torch.zeros(cout, device=device)
        if spread:
            w = w * 8.0
            b = spread_b[det]
            b = b.reshape(-1)
        det += 1
        params[scope][name] = {"w": w, "b": b}
    return {"params": params, "batch_stats": stats}


def quantiles(gen: torch.Generator, n: int, mean: float, std: float, device
              ) -> torch.Tensor:
    """The n quantiles (i + 1/2) / n of N(mean, std) in an order the
    generator draws."""
    p = (torch.arange(n, device=device, dtype=torch.float32) + 0.5) / n
    q = mean + std * torch.special.ndtri(p)
    return q[torch.randperm(n, generator=gen, device=device)]


def calibrate(variables, images: torch.Tensor, anchors, num_classes: int, *,
              k_select: int, score_thresh: float, target: float,
              block: int = 4) -> float:
    """Shift the class biases of the detection convs, in place, by the
    amount at which `images` [N, H, W, 3] (network input) average `target`
    valid (anchor, class) pairs among each image's k_select best anchors
    (by sigmoid(objectness) * sigmoid(best class logit)) at score_thresh;
    the network runs in float32 in blocks of `block` images. Returns the
    shift."""
    from benchmark.check import tf32_off
    net = Net(variables, num_classes)
    conf, cls = [], []
    with torch.no_grad(), tf32_off():
        for i in range(0, len(images), block):
            maps = net(images[i:i + block])
            rows = flat_rows(maps, anchors, tuple(images.shape[1:3]))
            conf.append(rows["conf"])
            cls.append(rows["cls"])
    conf, cls = torch.sigmoid(torch.cat(conf)), torch.cat(cls)

    def valid(shift: float) -> float:
        sel = conf * torch.sigmoid(cls.amax(-1) + shift)
        top = sel.topk(k_select, dim=1).indices
        s = conf.gather(1, top)[..., None] * torch.sigmoid(
            cls.gather(1, top[..., None].expand(-1, -1, num_classes))
            + shift)
        return float((s >= score_thresh).sum()) / len(images)

    lo, hi = -8.0, 8.0
    for _ in range(32):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if valid(mid) < target else (lo, mid)
    shift = (lo + hi) / 2
    head = variables["params"]["head"]
    for p in head.values():
        if "b" in p:
            b = p["b"].view(3, 5 + num_classes)
            b[:, 5:] += shift
    return shift
