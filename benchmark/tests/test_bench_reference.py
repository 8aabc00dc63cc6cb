"""The plain reference against the program at a tiny size on the CPU: the
forward, the label grids, the loss and a train step in float32, and each
cell's comparison on the program's own bf16 path."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, scenes, weights
from benchmark.reference import model as ref
from benchmark.tests.tiny import CELLS, run_cell

ANCHORS = [[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
           [116, 90], [156, 198], [373, 326]]
HW = (64, 64)


def images(n=2, seed=3):
    s = scenes.draw(weights.generator(seed, "cpu", stream=1), n, HW,
                    num_classes=20, boxes_min=1, boxes_max=4)
    return scenes.to_rgb_float(s["images"]), s


def close(a, b, rtol):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rtol * scale


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_program_in_float32(train):
    from yolov3_tensorflow_tpu_torch.models.yolov3 import yolov3_forward
    v = weights.draw(11, 20, "cpu", spread=False)
    x, _ = images()
    net = ref.Net(v, 20, train=train)
    ours = net(x)
    theirs, stats = yolov3_forward(v, x, train=train,
                                   compute_dtype=torch.float32)
    for a, b in zip(ours, theirs):
        close(a, b, 1e-4)
    if train:
        for scope in stats:
            for name, s in stats[scope].items():
                close(net.new_stats[scope][name]["var"], s["var"], 1e-4)


def test_label_grids_match_the_device_encoder():
    from yolov3_tensorflow_tpu_torch.data.device_encode import \
        encode_labels_device
    _, s = images(n=4)
    gt = torch.cat([s["boxes"], s["mask"][..., None].float()], -1)
    theirs = encode_labels_device(gt, s["labels"], s["mask"], (64, 64), 20,
                                  np.asarray(ANCHORS, np.float32))
    ours = ref.label_grids(s["boxes"], s["labels"], s["mask"], HW, 20,
                           ANCHORS)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


def test_loss_matches_the_program_in_float32():
    from yolov3_tensorflow_tpu_torch.ops.losses import compute_loss
    v = weights.draw(12, 20, "cpu", spread=False)
    x, s = images(n=3)
    maps = ref.Net(v, 20)(x)
    grids = ref.label_grids(s["boxes"], s["labels"], s["mask"], HW, 20,
                            ANCHORS)
    ours = ref.yolo_loss(maps, grids, ANCHORS, 20, HW, label_smooth=True,
                         focal=True)
    theirs = compute_loss(maps, grids, np.asarray(ANCHORS, np.float32), 20,
                          HW, use_label_smooth=True, use_focal_loss=True)
    for k in ("xy", "wh", "conf", "class", "total"):
        assert float(ours[k]) == pytest.approx(float(theirs[k]), rel=1e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_is_correct_on_the_program_path(cell):
    ctx, out = run_cell(cell)
    assert ctx.checks.correct, ctx.checks.as_dict()
    assert out["attempted"] >= 1 and out["failed"] == 0
    reported = {m["name"] for m in harness.resolve(
        harness.load_spec(), cell)["end_to_end"]}
    assert set(out["metrics"]) == reported


def test_train_first_step_agrees_in_float32():
    _, out = run_cell("voc416-train-b64")
    got = out["readings"]
    assert got["loss1_gap"] < 1e-5
    assert got["grad_median_gap"] < 1e-3
    assert got["stats1_gap"] < 1e-3


def test_letterbox_matches_the_program():
    from yolov3_tensorflow_tpu_torch.ops.preprocess import device_letterbox
    frames = scenes.draw(weights.generator(4, "cpu", stream=1), 2, (48, 64),
                         num_classes=80, boxes_min=1, boxes_max=3)["images"]
    ours = ref.letterbox(frames, (64, 64), bgr=True)
    theirs = device_letterbox(frames.flip(-1), (64, 64))
    assert float((ours - theirs).abs().max()) < 1e-6


def test_reference_detections_of_a_served_image():
    v = weights.draw(13, 80, "cpu", spread=True)
    x, _ = images(n=1)
    r = check.reference_detections(v, x, 80, ANCHORS, k_select=64,
                                   k_pool=256, score_thresh=0.3,
                                   iou_thresh=0.45)[0]
    assert len(r["det_boxes"]) > 0
    assert bool((r["det_scores"] >= 0.3).all())
    same = check.compare_image(check.kept_as_dets(r), r, margin=0.0)
    assert (same["gap"], same["wrong"]) == (0.0, 0)
    assert same["reported"] == len(r["det_boxes"]) and same["confident"]


def test_batched_greedy_nms_is_the_greedy_of_each_group():
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(7, 50, 2, generator=g) * 100
    boxes = torch.cat([xy, xy + torch.rand(7, 50, 2, generator=g) * 40 + 1],
                      -1)
    s, order = torch.sort(torch.rand(7, 50, generator=g), dim=1,
                          descending=True, stable=True)
    boxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    together = ref.greedy_nms_sorted(boxes, s, 0.2, 0.45, block=3)
    alone = torch.stack([ref.greedy_nms(boxes[i], s[i], 0.2, 0.45)
                         for i in range(7)])
    assert torch.equal(together, alone)


def random_class(seed, n=40):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(n, 2, generator=g) * 100
    boxes = torch.cat([xy, xy + torch.rand(n, 2, generator=g) * 40 + 1], -1)
    return boxes, torch.rand(n, generator=g)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tie_states_bracket_the_greedy(seed):
    boxes, s = random_class(seed)
    keep = ref.greedy_nms(boxes, s, 0.3, 0.45)
    none = torch.zeros(len(s), dtype=torch.bool)
    exact = check.tie_states(boxes, s, none, 0.3, 0.45, 0.0, 0.0)
    assert torch.equal(exact == 1, keep) and not bool((exact == 2).any())
    state = check.tie_states(boxes, s, none, 0.3, 0.45, 0.05, 0.05)
    assert bool(keep[state == 1].all())          # sure: kept
    assert not bool(keep[state == 0].any())      # dropped for sure: dropped
    assert int((state == 1).sum()) > 0 and int((state == 0).sum()) > 0


def test_tie_states_doubt_a_near_tie():
    boxes = torch.tensor([[0., 0., 10., 10.], [0., 0., 10., 10.5],
                          [50., 50., 60., 60.], [50., 50., 60., 61.]])
    s = torch.tensor([0.80, 0.79, 0.80, 0.60])
    none = torch.zeros(4, dtype=torch.bool)
    state = check.tie_states(boxes, s, none, 0.3, 0.45, 0.05, 0.05)
    # two boxes within 0.05 of each other: either may be kept; a box 0.2
    # under a kept one that it overlaps is dropped for sure
    assert state.tolist() == [2, 2, 1, 0]
    near = torch.tensor([False, False, True, False])
    assert check.tie_states(boxes, s, near, 0.3, 0.45, 0.05,
                            0.05).tolist() == [2, 2, 2, 2]


def test_both_ways_count_what_the_program_adds_or_leaves_out():
    v = weights.draw(13, 80, "cpu", spread=True)
    x, _ = images(n=1)
    weights.calibrate(v, x, ANCHORS, 80, k_select=64, score_thresh=0.3,
                      target=100)
    r = check.reference_detections(v, x, 80, ANCHORS, k_select=64,
                                   k_pool=256, score_thresh=0.3,
                                   iou_thresh=0.45, tie=0.01,
                                   iou_tie=0.02)[0]
    assert len(r["sure_labels"]) > 1
    same = check.compare_image(check.kept_as_dets(r), r, margin=0.05)
    assert (same["missed"], same["extra"]) == (0, 0)
    b, s, l = check.kept_as_dets(r)
    keep = r["sure_labels"].numpy()
    first = np.isin(l, keep[:1])
    less = check.compare_image((b[~first], s[~first], l[~first]), r,
                               margin=0.05)
    assert less["missed"] >= 1 and less["extra"] == 0
    far = b + 200.0
    more = check.compare_image((np.concatenate([b, far]),
                                np.concatenate([s, s]),
                                np.concatenate([l, l])), r, margin=0.05)
    assert more["missed"] == 0 and more["extra"] == len(l)


def test_k1_faults_break_the_keep_masks():
    scores = torch.tensor([[[0.9], [0.8], [0.2]]])            # [1, 3, 1]
    keep = torch.tensor([[[True, False, False]]])             # [1, 1, 3]
    assert check.plant_keep(keep, scores, 0.3, ("k1_keep_all",)).tolist() \
        == [[[True, True, False]]]
    both = torch.tensor([[[True, True, False]]])
    assert check.plant_keep(both, scores, 0.3, ("k1_keep_first",)).tolist() \
        == [[[True, False, False]]]
