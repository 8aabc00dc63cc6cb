"""The comparisons that decide `correct`: the program's detections against
the reference's, and the program's first training steps against the
reference's.

Detections. For each sampled image the reference recomputes, from the
benchmark's own weights and input, every anchor's box and class scores and
its own detections. A program detection's gap is the distance between the
score it reports and the reference's score, same class, at an anchor whose
box is the same box (`same_box`); with no such anchor it reads 1, an
answer the reference cannot find. Over the sample:

- wrong_share: the share of the program's detections whose gap is over
  WRONG_GAP (the widest gap swings by nature: a score's logit carries the
  rounding of 75 layers and of the x8 spread of the detection kernels);
- bad_image_share: the share of images more than WRONG_IMAGE of whose
  detections are wrong (one in thousands is rounding on the exact path,
  which reports up to 3,000 an image), or for which the program reports
  nothing while the reference has a detection clear of its cut-off (the
  score threshold, and on the exact path the class's last candidate or
  last kept row) by `margin`;
- missed_share and extra_share, both ways between the program's kept
  set and the reference's, on the serving paths (selection, K1): the
  share of the reference's detections that are kept for sure and that the
  program does not report, and the share of the program's detections
  that the reference suppresses for sure or never selects. "For sure"
  (`tie_states`) leaves out what rounding may decide: a score within
  `tie` of the threshold or of a score that it competes with, a selection
  score within `tie` of the last selected anchor's, an overlap within
  `iou_tie` of the IoU threshold, and what any of these decides in turn;
- score_gap (the widest gap), mean_gap and empty_share are read beside
  them.

Training. The first steps' readings (the train loop's `compare`): each
step's loss, as a relative gap; per leaf the gap between the two sides'
norms of the first gradient as the optimizer holds it after step 1 (the
momentum trace of one step is the clipped gradient) and of each leaf's
change over the steps, over the larger of the reference leaf's norm and
the median leaf's; and the moving statistics after step 1 (`stats_gap`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.model import (Net, flat_rows, greedy_nms,
                                       greedy_nms_sorted, iou_matrix)

BOX_PX = 1.0
BOX_REL = 0.05
WRONG_GAP = 0.1        # a detection whose score is off by more is wrong
WRONG_IMAGE = 0.01     # an image with a larger share of wrong ones is bad
SMALL_GRAD = 1e-3      # a leaf whose reference gradient norm is under this
                       # share of the median leaf's moves by round-off only


Dets = Tuple[np.ndarray, np.ndarray, np.ndarray]   # boxes [n,4], scores, labels


def reference_image(box: torch.Tensor, conf: torch.Tensor, cls: torch.Tensor,
                    *, k_select: int, k_pool: int, score_thresh: float,
                    iou_thresh: float, per_class_topk: int = 0,
                    max_out: int = 0, tie: float = 0.0,
                    iou_tie: float = 0.0) -> Dict[str, torch.Tensor]:
    """One image's reference detections, returned on the CPU.

    box [A, 4], conf [A], cls [A, C] (logits). The serving paths select the
    k_select best anchors by sigmoid(conf) * sigmoid(max class logit) and
    suppress each class among them; the exact path (per_class_topk) takes
    each class's own best per_class_topk anchors by score, suppresses them
    and keeps at most max_out. Returns the anchors a program detection is
    matched against ("pool_boxes" / "pool_scores", the k_pool best by
    selection score; on the exact path "all_boxes", "all_scores" and each
    class's candidates "class_top", taken twice as deep), and the
    reference's detections "det_boxes", "det_scores", "det_labels" with the
    score each must clear ("det_cut"). On the serving paths also the
    candidates that are kept for sure ("sure_*") and those that may be
    kept ("maybe_*": the sure ones and those rounding may decide), by
    `tie_states` with `tie` and `iou_tie`."""
    def cat(xs, shape):
        return torch.cat(xs) if xs else torch.zeros(shape)

    box_dev = box.float()
    scores_dev = torch.sigmoid(conf.float())[:, None] * torch.sigmoid(
        cls.float())                                                # [A, C]
    box, cls = box_dev.cpu(), cls.float().cpu()
    scores = scores_dev.cpu()
    sel = torch.sigmoid(conf.float().cpu()) * torch.sigmoid(cls.amax(-1))
    order = torch.sort(sel, descending=True, stable=True).indices
    pool = order[:k_pool]
    out = {"pool_boxes": box[pool], "pool_scores": scores[pool]}
    det_b, det_s, det_l, det_cut = [], [], [], []
    if per_class_topk:
        by_class = scores_dev.T                                    # [C, A]
        ranked = torch.sort(by_class, dim=1, descending=True,
                            stable=True).indices
        top = ranked[:, :per_class_topk]                           # [C, k]
        top_s = by_class.gather(1, top)
        keep = greedy_nms_sorted(box_dev[top], top_s, score_thresh,
                                 iou_thresh)
        keep &= keep.cumsum(1) <= max_out     # each class's max_out best
        # the cut-offs: the threshold, the last of the class's top-k and,
        # where the class filled its max_out rows, the last kept
        cut = top_s[:, -1].clamp(min=score_thresh)
        last = torch.where(keep, top_s, float("inf")).amin(1)
        cut = torch.where(keep.sum(1) == max_out, torch.maximum(cut, last),
                          cut)
        c_idx, r_idx = keep.nonzero(as_tuple=True)
        # matching looks twice as deep: the program's own top-k may reach
        # past the reference's where scores crowd its last rank
        out.update(all_boxes=box, all_scores=scores,
                   class_top=ranked[:, :2 * per_class_topk].cpu())
        det_b.append(box_dev[top[c_idx, r_idx]].cpu())
        det_s.append(top_s[c_idx, r_idx].cpu())
        det_l.append(c_idx.cpu())
        det_cut.append(cut[c_idx].cpu())
    else:
        top = order[:k_select]
        for c in torch.nonzero((scores[top] >= score_thresh).any(0)).flatten():
            c = int(c)
            kept = top[greedy_nms(box[top], scores[top, c], score_thresh,
                                  iou_thresh)]
            det_b.append(box[kept])
            det_s.append(scores[kept, c])
            det_l.append(torch.full((len(kept),), c))
            det_cut.append(torch.full((len(kept),), score_thresh))
        # the anchors rounding may select: within `tie` of the last one
        last = sel[order[min(k_select, len(order)) - 1]]
        deep = order[:k_pool][sel[order[:k_pool]] >= last - tie]
        near_sel = (sel[deep] - last).abs() < tie
        sets = {"sure": ([], [], []), "maybe": ([], [], [])}
        for c in torch.nonzero((scores[deep] >= score_thresh - tie).any(0)
                               ).flatten().tolist():
            state = tie_states(box[deep], scores[deep, c], near_sel,
                               score_thresh, iou_thresh, tie, iou_tie)
            for key, want in (("sure", state == 1), ("maybe", state > 0)):
                b, s, lab = sets[key]
                b.append(box[deep][want])
                s.append(scores[deep, c][want])
                lab.append(torch.full((int(want.sum()),), c))
        for key, (b, s, lab) in sets.items():
            out.update({f"{key}_boxes": cat(b, (0, 4)),
                        f"{key}_scores": cat(s, (0,)),
                        f"{key}_labels": cat(lab, (0,)).long()})

    out.update(det_boxes=cat(det_b, (0, 4)), det_scores=cat(det_s, (0,)),
               det_labels=cat(det_l, (0,)).long(),
               det_cut=cat(det_cut, (0,)))
    return out


def tie_states(boxes: torch.Tensor, scores: torch.Tensor,
               near_sel: torch.Tensor, score_thresh: float, iou_thresh: float,
               tie: float, iou_tie: float) -> torch.Tensor:
    """One class's greedy NMS, each candidate marked 1 (kept for sure), 0
    (dropped for sure) or 2 (rounding may decide). boxes [n, 4], scores
    [n], near_sel [n]: the candidate's selection is in doubt. In score
    order: a candidate is dropped for sure when a candidate kept for sure
    scores over it by `tie` or more and overlaps it by more than
    iou_thresh + iou_tie, or when it lies `tie` or more under the
    threshold. Otherwise it is in doubt where a candidate that may be kept
    (either state 1 or 2, or one not yet decided within `tie` of its
    score) overlaps it by more than iou_thresh - iou_tie, where its score
    lies within `tie` of the threshold or where its selection is in doubt;
    else it is kept for sure. With tie = iou_tie = 0 the kept set is
    `greedy_nms`'s."""
    n = len(scores)
    s = scores.double().numpy()
    over = iou_matrix(boxes, boxes).double().numpy()
    near = near_sel.numpy()
    order = np.argsort(-s, kind="stable")
    state = np.zeros(n, np.int8)
    for pos, i in enumerate(order):
        if s[i] < score_thresh - tie:
            continue
        up = order[:pos]
        clear = up[(state[up] == 1) & (s[up] >= s[i] + tie)]
        if (over[i, clear] > iou_thresh + iou_tie).any():
            continue
        later = order[pos + 1:]
        rivals = np.concatenate([up[state[up] > 0],
                                 later[s[later] > s[i] - tie]])
        doubt = tie > 0 and (
            (over[i, rivals] > iou_thresh - iou_tie).any()
            or abs(s[i] - score_thresh) < tie or near[i])
        state[i] = 2 if doubt else 1
    return torch.from_numpy(state)


def compare_image(prog: Dets, ref: Dict[str, torch.Tensor], *, margin: float
                  ) -> Dict[str, float]:
    """One image's counts (see the module docstring): the widest gap and
    the sum of the gaps, the detections reported and those off by more
    than WRONG_GAP, and whether the reference has a detection clear of
    its cut-off by `margin`."""
    boxes = torch.as_tensor(np.asarray(prog[0], np.float32)).reshape(-1, 4)
    scores = torch.as_tensor(np.asarray(prog[1], np.float32)).reshape(-1)
    labels = torch.as_tensor(np.asarray(prog[2])).long().reshape(-1)
    gap, wrong, gap_sum = 0.0, 0, 0.0
    for c in labels.unique().tolist():
        mine = labels == c
        if "class_top" in ref and 0 <= c < len(ref["class_top"]):
            top = ref["class_top"][c]        # the exact path's candidates
            pool_b, pool_s = ref["all_boxes"][top], ref["all_scores"][top, c]
        elif 0 <= c < ref["pool_scores"].shape[1]:
            pool_b, pool_s = ref["pool_boxes"], ref["pool_scores"][:, c]
        else:
            pool_b, pool_s = ref["pool_boxes"][:0], ref["pool_scores"][:0, 0]
        for b, s in zip(boxes[mine].split(256), scores[mine].split(256)):
            near = same_box(b, pool_b)                                # [n, P]
            g = torch.where(near, (s[:, None] - pool_s[None]).abs(),
                            1.0).amin(-1) if len(pool_b) else torch.ones_like(s)
            g = torch.where(torch.isfinite(g), g, torch.ones_like(g))
            gap = max(gap, float(g.max()))
            gap_sum += float(g.sum())
            wrong += int((g > WRONG_GAP).sum())
    confident = bool((ref["det_scores"] >= ref["det_cut"] + margin).any())
    out = {"gap": gap, "gap_sum": gap_sum, "wrong": wrong,
           "reported": len(boxes), "confident": confident}
    if "sure_labels" in ref:
        # both ways: the sure ones the program lacks, and what it reports
        # that may not be kept
        sure = (ref["sure_boxes"], ref["sure_scores"], ref["sure_labels"])
        maybe = (ref["maybe_boxes"], ref["maybe_scores"], ref["maybe_labels"])
        out["sure"] = len(sure[2])
        out["missed"] = int((~matched(sure, (boxes, scores, labels))).sum())
        out["extra"] = int((~matched((boxes, scores, labels), maybe)).sum())
    return out


def matched(a, b) -> torch.Tensor:
    """[len(a)]: detection a[i] (boxes, scores, labels) has one in b of
    its class with the same box (`same_box`) and a score within
    WRONG_GAP."""
    hit = torch.zeros(len(a[2]), dtype=torch.bool)
    for c in a[2].unique().tolist():
        mine, theirs = a[2] == c, b[2] == c
        if not theirs.any():
            continue
        near = same_box(a[0][mine], b[0][theirs]) & (
            (a[1][mine][:, None] - b[1][theirs][None]).abs() <= WRONG_GAP)
        hit[mine] = near.any(-1)
    return hit


def same_box(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, m]: box a[i] is box b[j] up to rounding: every corner within
    BOX_PX pixels plus a share of b[j]'s longer side, BOX_REL and a
    hundredth of the size's log-distance from a mid-sized anchor (64 px):
    a size is exp(logit) times an anchor, and the logit's rounding grows
    with it, so a box thousands of times its anchor is known to a few
    percent only. (IoU is no measure of a box a few pixels wide whose
    center moved by a fraction of one.)"""
    side = (b[:, 2:] - b[:, :2]).amax(-1).clamp(min=1e-6)          # [m]
    tol = BOX_PX + (BOX_REL + 0.01 * torch.log(side / 64.0).abs()) * side
    return ((a[:, None, :] - b[None, :, :]).abs().amax(-1)
            <= tol[None, :])


def compare_detections(prog: Sequence[Dets], refs: Sequence[Dict],
                       *, margin: float) -> Dict[str, float]:
    """The module docstring's numbers over the sampled images."""
    got = [compare_image(p, r, margin=margin) for p, r in zip(prog, refs)]
    reported = max(sum(g["reported"] for g in got), 1)
    empty = [g["confident"] and g["reported"] == 0 for g in got]
    bad = [g["wrong"] > WRONG_IMAGE * g["reported"] or e
           for g, e in zip(got, empty)]
    out = {"score_gap": max([0.0] + [g["gap"] for g in got]),
           "mean_gap": sum(g["gap_sum"] for g in got) / reported,
           "wrong_share": sum(g["wrong"] for g in got) / reported,
           "bad_image_share": sum(bad) / max(len(got), 1),
           "empty_share": sum(empty) / max(sum(g["confident"]
                                               for g in got), 1)}
    if got and all("sure" in g for g in got):
        out["sure"] = sum(g["sure"] for g in got)
        out["missed_share"] = sum(g["missed"] for g in got) / max(
            out["sure"], 1)
        out["extra_share"] = sum(g["extra"] for g in got) / reported
    return out


def plant(dets: Dict[str, torch.Tensor], faults, num_classes: int,
          drop=slice(1, None, 2)) -> Dict[str, torch.Tensor]:
    """A detector's output with a test's fault planted: the rows of the
    images `drop` selects left out ("half_batch"), or every label moved
    to the next class ("alter_answer")."""
    out = {k: v.clone() for k, v in dets.items()}
    if "half_batch" in faults:
        out["valid"][drop] = False
    if "alter_answer" in faults:
        out["labels"] = (out["labels"] + 1) % num_classes
    return out


def plant_keep(keep: torch.Tensor, scores: torch.Tensor,
               score_thresh: float, faults) -> torch.Tensor:
    """K1's keep masks [B, C, K] with a test's fault planted: every valid
    candidate kept ("k1_keep_all": nothing suppressed), or only each
    class's best ("k1_keep_first"). scores [B, K, C]."""
    s = scores.transpose(1, 2)
    if "k1_keep_all" in faults:
        keep = s >= score_thresh
    if "k1_keep_first" in faults:
        best = torch.where(keep, s, float("-inf")).argmax(-1, keepdim=True)
        keep = keep & torch.zeros_like(keep).scatter_(-1, best, True)
    return keep


def reference_detections(variables, images: torch.Tensor, num_classes: int,
                         anchors, *, precision: str = "fp32",
                         block: int = 8, **select) -> List[Dict]:
    """`reference_image` of every image [N, H, W, 3] (network input, float
    in [0, 1]), the network run in blocks of `block` images in float32
    (TF32 off) or, for the control, in float8."""
    net = Net(variables, num_classes, precision=precision)
    out = []
    with torch.no_grad(), tf32_off():
        for i in range(0, len(images), block):
            out += detections_of_maps(net(images[i:i + block]), anchors,
                                      **select)
    return out


def detections_of_maps(maps, anchors, **select) -> List[Dict]:
    """`reference_image` of every image of the reference's raw maps."""
    n, hg, wg, _ = maps[0].shape
    rows = flat_rows(maps, anchors, (32 * hg, 32 * wg))
    return [reference_image(rows["box"][i], rows["conf"][i], rows["cls"][i],
                            **select) for i in range(n)]


class tf32_off:
    """Float32 matmuls and convolutions in float32, not TF32, inside the
    block."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


def kept_as_dets(ref: Dict[str, torch.Tensor]) -> Dets:
    """A reference's own detections in the program's form (the control
    puts a reference in the program's place)."""
    return (ref["det_boxes"].numpy(), ref["det_scores"].numpy(),
            ref["det_labels"].numpy())


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip: Sequence[str] = ()) -> Dict[str, float]:
    """Each leaf's gap: |prog - ref| over max(ref, the median leaf's ref)
    of its norms; leaves in `skip` left out, a leaf the program lacks read
    as norm 0."""
    names = [k for k in ref if k not in set(skip)]
    med = float(np.median([ref[k] for k in names]))
    gaps = {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}
    return {k: g if np.isfinite(g) else float("inf") for k, g in gaps.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             skip: Sequence[str] = ()) -> Tuple[float, float]:
    """(the worst leaf's gap, the median leaf's gap) of `leaf_gaps`."""
    gaps = list(leaf_gaps(prog, ref, skip).values())
    return max(gaps), float(np.median(gaps))


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 skip: Sequence[str] = (), n: int = 3) -> List[list]:
    """The n leaves of the largest `leaf_gaps`, each [name, gap]."""
    gaps = leaf_gaps(prog, ref, skip)
    return [[k, gaps[k]] for k in sorted(gaps, key=gaps.get)[::-1][:n]]


def stats_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              start: Dict[str, torch.Tensor]) -> float:
    """The moving statistics after step 1 (each batch norm's batch mean and
    variance, folded in at 1 - momentum): per leaf the norm of the two
    sides' difference over the norm of the reference's change; the median
    leaf. The forward's precision shows here with little averaging, where
    a loss sums it over a million cells."""
    gaps = [float((prog[k].float() - ref[k].float()).norm()
                  / (ref[k].float() - start[k].float()).norm().clamp(
                      min=1e-30)) for k in ref]
    return float(np.median(gaps))


def small_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is nought to rounding: under
    SMALL_GRAD of the median leaf's norm."""
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v < SMALL_GRAD * med]


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The widest relative gap between the two sides' losses, step by
    step."""
    return max(abs(p - r) / max(abs(r), 1e-30) if np.isfinite(p)
               else float("inf") for p, r in zip(prog, ref))
