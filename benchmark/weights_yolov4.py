"""YOLOv4's weights drawn from the seed, on the device, in a few large
calls: `weights.py`'s scheme over the YOLOv4 reference's `conv_table`.

Kernels are glorot-uniform. The moving statistics are not drawn: `settle`
sets them to the moments of the cell's own first images, in the reference
in float32, as a trained network's running statistics hold its data's
moments. Drawn near their initial values (mean 0, var 1), they leave the
signal to shrink: Mish's slope is ~0.6 near 0, and over the 72 backbone
convs the stride-32 map's spread fell to ~1e-7 of its bias (at 64^2, 96x128
and 128^2 on the CPU), so every image gave the same scores. With the
statistics settled, each batch norm's output is N(beta, gamma^2) a channel,
and gamma and beta set how far a rounding error grows (the mean-field gain
a layer, gamma^2 E[act'(h)^2] / Var(act(h)): at N(0, 1) 1.22 for Mish and
1.35 for the LeakyReLU, and the reference rounded to bfloat16 (the witness)
was off its float32 maps by 50-70% of their largest value) and how much of
each activation's input lies below 0, where both activations bend. Drawn
within 10% of GAMMA = 0.25 and within 0.02 of BETA = 0.5, 2.4-2.6% of the
LeakyReLU's inputs and 2.7-3.5% of Mish's are below 0 (2-5% in each layer;
the cell's 608^2 images on the card, `control_yolov4.py --variants
negatives`), so a fault in either negative branch moves the answers. At
gamma ~0.5, beta ~1 (2.4-2.8% below 0) the cell's comparison failed on the
card (`bad_image_share` 0.27-0.95 over three seeds) where the witness in
the program's place read 0.05-0.22: the program's folded chain rounds each
conv's folded bias to bfloat16, an offset a channel that does not average
out over the pixels. On the CPU (128^2, 4 images) the class logits' error
was 2.1% of their spread in the program's chain against the witness's
1.5% (1.65% with the bias kept in float32); at gamma ~0.25, beta ~0.5 it
is 1.3% against 0.93%, and the program reads under half of each limit of
the cell. At gamma ~0.25, beta ~1 almost nothing was below 0 (0.1%).
`spread=True` is `weights.py`'s spread head but for the
kernels: the detection biases are the quantiles of box N(0, 0.5),
objectness N(1, 1) and class N(-3.5, 1) in the seed's order, and the
kernels keep their draw. YOLOv3's are taken times 8 to give its detection
logits a spread over the pixels of 0.1-0.5 (class) and 0.5-1.0 (box) at
128^2; with the moving statistics settled, YOLOv4's give 0.25-0.3 as drawn
(0.6-0.8 at gamma 0.5), and times 8 would make boxes e^+-2 times their
anchors or more. `calibrate` then shifts every class bias by the one amount
that gives the cell's first images a stated number of candidates.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.yolov4 import Net, conv_table, flat_rows
from benchmark.weights import generator, quantiles

GAMMA = 0.25
BETA = 0.5


def draw(seed: int, num_classes: int, device, *, spread: bool
         ) -> Dict[str, dict]:
    """The {"params", "batch_stats"} tree for `seed`, float32 on `device`,
    moving statistics at mean 0, var 1 until `settle` sets them; each batch
    norm's gamma within 10% of GAMMA and beta within 0.02 of BETA."""
    gen = generator(seed, device, stream=0)
    table = conv_table(num_classes)
    sizes = [cout * cin * k * k for _, _, cin, cout, k, _, _ in table]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    n_bn = sum(row[3] for row in table if row[6])
    v = torch.rand(2, n_bn, generator=gen, device=device)
    c = num_classes
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
            params[scope][name] = {"w": w,
                                   "gamma": GAMMA * (0.9 + 0.2 * r[0]),
                                   "beta": BETA - 0.02 + 0.04 * r[1]}
            stats[scope][name] = {"mean": torch.zeros_like(r[0]),
                                  "var": torch.ones_like(r[0])}
            continue
        b = spread_b[det].reshape(-1) if spread else torch.zeros(
            cout, device=device)
        det += 1
        params[scope][name] = {"w": w, "b": b}
    return {"params": params, "batch_stats": stats}


def settle(variables, images: torch.Tensor, num_classes: int) -> None:
    """Set every moving mean and variance, in place, to the moments its
    batch norm sees over `images` [N, H, W, 3] (network input) with every
    batch norm before it normalized by its own moments: the reference's
    training-mode forward in float32, one batch."""
    from benchmark.check import tf32_off
    net = Net(variables, num_classes, moments=True)
    with torch.no_grad(), tf32_off():
        net(images)
    for scope, convs in net.moments.items():
        for name, m in convs.items():
            variables["batch_stats"][scope][name] = {
                "mean": m["mean"].clone(), "var": m["var"].clone()}


def calibrate(variables, images: torch.Tensor, anchors, num_classes: int, *,
              k_select: int, score_thresh: float, target: float,
              block: int = 4) -> float:
    """`weights.calibrate` over the YOLOv4 reference: shift the class
    biases of the detection convs, in place, by the amount at which
    `images` average `target` valid (anchor, class) pairs among each
    image's k_select best anchors at score_thresh. Returns the shift."""
    from benchmark.check import tf32_off
    net = Net(variables, num_classes)
    conf, cls = [], []
    with torch.no_grad(), tf32_off():
        for i in range(0, len(images), block):
            rows = flat_rows(net(images[i:i + block]), anchors,
                             tuple(images.shape[1:3]), num_classes)
            conf.append(rows["conf"])
            cls.append(rows["cls"])
    conf, cls = torch.sigmoid(torch.cat(conf)), torch.cat(cls)

    def valid(shift: float) -> float:
        sel = conf * torch.sigmoid(cls.amax(-1) + shift)
        top = sel.topk(min(k_select, sel.shape[1]), dim=1).indices
        s = conf.gather(1, top)[..., None] * torch.sigmoid(
            cls.gather(1, top[..., None].expand(-1, -1, num_classes))
            + shift)
        return float((s >= score_thresh).sum()) / len(images)

    lo, hi = -8.0, 8.0
    for _ in range(32):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if valid(mid) < target else (lo, mid)
    shift = (lo + hi) / 2
    for p in variables["params"]["head"].values():
        if "b" in p:
            b = p["b"].view(3, 5 + num_classes)
            b[:, 5:] += shift
    return shift
