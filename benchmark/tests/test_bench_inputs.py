"""Weights and traffic are drawn from the seed: the same seed gives the
same, another seed other; seeds beyond 32 bits work."""

import pytest
import torch

from benchmark import scenes, weights
from benchmark.reference.model import conv_table

BIG = 2 ** 31 + 12345


def flat(tree):
    out = []
    for part in ("params", "batch_stats"):
        for scope in tree[part].values():
            for conv in scope.values():
                out += [v.reshape(-1) for v in conv.values()]
    return torch.cat(out)


@pytest.mark.parametrize("spread", [False, True])
def test_weights_follow_the_seed(spread):
    a = flat(weights.draw(BIG, 20, "cpu", spread=spread))
    b = flat(weights.draw(BIG, 20, "cpu", spread=spread))
    c = flat(weights.draw(BIG + 1, 20, "cpu", spread=spread))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_weights_shapes_are_the_published_widths():
    tree = weights.draw(7, 80, "cpu", spread=True)
    table = conv_table(80)
    assert len(table) == 75
    for scope, name, cin, cout, k, _, has_bn in table:
        p = tree["params"][scope][name]
        assert tuple(p["w"].shape) == (cout, cin, k, k)
        assert ("gamma" in p) == has_bn
    assert tree["params"]["head"]["conv_22"]["w"].shape[0] == 255
    n = sum(v.numel() for scope in tree["params"].values()
            for conv in scope.values() for v in conv.values())
    assert 61_000_000 < n < 63_000_000


def draw(seed, n=3):
    return scenes.draw(weights.generator(seed, "cpu", stream=1), n, (64, 96),
                       num_classes=20, boxes_min=1, boxes_max=6)


def test_scenes_follow_the_seed():
    a, b, c = draw(BIG), draw(BIG), draw(BIG + 1)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["images"], c["images"])


def test_scenes_boxes_lie_in_the_image():
    s = draw(5, n=8)
    assert s["images"].dtype == torch.uint8
    assert tuple(s["images"].shape) == (8, 64, 96, 3)
    counts = s["mask"].sum(1)
    assert int(counts.min()) >= 1 and int(counts.max()) <= 6
    b = s["boxes"][s["mask"]]
    assert bool((b[:, 0] >= 0).all() and (b[:, 2] <= 96).all())
    assert bool((b[:, 1] >= 0).all() and (b[:, 3] <= 64).all())
    assert bool(((b[:, 2] - b[:, 0]) > 5).all())
    assert int(s["labels"].max()) < 20


@pytest.mark.parametrize("seed", [BIG, 3])
def test_calibration_sets_the_candidates_not_the_seed(seed):
    """Whatever the seed, the calibration images average the stated
    number of valid (anchor, class) pairs among their best anchors."""
    from benchmark.reference.model import Net, flat_rows
    anchors = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
               [116, 90], [156, 198], [373, 326]]
    v = weights.draw(seed, 80, "cpu", spread=True)
    x = scenes.to_rgb_float(scenes.draw(weights.generator(seed, "cpu", 1), 4,
                                        (64, 64), num_classes=80,
                                        boxes_min=1, boxes_max=4)["images"])
    before = v["params"]["head"]["conv_6"]["b"].clone()
    shift = weights.calibrate(v, x, anchors, 80, k_select=64,
                              score_thresh=0.3, target=100)
    after = v["params"]["head"]["conv_6"]["b"].view(3, 85)
    assert torch.allclose(after[:, 5:], before.view(3, 85)[:, 5:] + shift)
    assert torch.equal(after[:, :5], before.view(3, 85)[:, :5])
    with torch.no_grad():
        rows = flat_rows(Net(v, 80)(x), anchors, (64, 64))
    conf = torch.sigmoid(rows["conf"])
    top = (conf * torch.sigmoid(rows["cls"].amax(-1))).topk(64, 1).indices
    s = conf.gather(1, top)[..., None] * torch.sigmoid(
        rows["cls"].gather(1, top[..., None].expand(-1, -1, 80)))
    assert abs(float((s >= 0.3).sum()) / 4 - 100) <= 2
