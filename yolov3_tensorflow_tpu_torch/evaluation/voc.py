"""PASCAL-VOC detection metrics (host-side numpy), copied from the JAX
package's `evaluation/voc.py` (a test holds the copy equal to its original).

Greedy confidence-ordered TP/FP marking at an IoU threshold with per-GT
dedup, then AP as either the VOC07 11-point metric or the area under the
precision envelope. The matcher's IoU keeps the legacy +1 pixel convention.
Callers hold the parsed ground truth explicitly (no module-level cache).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from yolov3_tensorflow_tpu_torch.data.annotations import parse_line


def parse_gt_records(gt_filename: str, target_img_size: Tuple[int, int],
                     letterbox_resize: bool = True
                     ) -> Dict[int, List[List[float]]]:
    """Re-parse an annotation file, mapping GT boxes into network-input
    coordinates (letterbox or plain resize).

    target_img_size: (width, height). Returns {img_id: [[x0,y0,x1,y1,label]]}.
    """
    new_w, new_h = target_img_size
    gt: Dict[int, List[List[float]]] = {}
    with open(gt_filename) as f:
        for line in f:
            if not line.strip():
                continue
            ann = parse_line(line)
            objects = []
            if letterbox_resize:
                ratio = min(new_w / ann.width, new_h / ann.height)
                dw = (new_w - int(ratio * ann.width)) // 2
                dh = (new_h - int(ratio * ann.height)) // 2
                for box, label in zip(ann.boxes, ann.labels):
                    objects.append([box[0] * ratio + dw, box[1] * ratio + dh,
                                    box[2] * ratio + dw, box[3] * ratio + dh,
                                    int(label)])
            else:
                sx, sy = new_w / ann.width, new_h / ann.height
                for box, label in zip(ann.boxes, ann.labels):
                    objects.append([box[0] * sx, box[1] * sy,
                                    box[2] * sx, box[3] * sy, int(label)])
            gt[ann.index] = objects
    return gt


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve, both VOC variants."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = recall >= t
            p = float(np.max(precision[mask])) if mask.any() else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    changed = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[changed + 1] - mrec[changed]) * mpre[changed + 1]))


def voc_eval(gt_dict: Dict[int, List[List[float]]],
             val_preds: Sequence[Sequence[float]], class_idx: int,
             iou_thres: float = 0.5, use_07_metric: bool = False
             ) -> Tuple[float, float, float, float, float]:
    """Per-class VOC evaluation.

    val_preds rows: [img_id, x0, y0, x1, y1, score, label].
    Returns (npos, nd, recall, precision, AP); degenerate (no predictions)
    returns (1e-6, 1e-6, 0, 0, 0).
    """
    class_gt: Dict[int, Dict[str, object]] = {}
    npos = 0
    for img_id, objs in gt_dict.items():
        boxes = np.array([o[:4] for o in objs if int(o[-1]) == class_idx])
        npos += len(boxes)
        class_gt[img_id] = {"bbox": boxes, "det": [False] * len(boxes)}

    preds = [p for p in val_preds if int(p[-1]) == class_idx]
    if not preds:
        return 1e-6, 1e-6, 0.0, 0.0, 0.0
    img_ids = [p[0] for p in preds]
    confidence = np.array([p[-2] for p in preds])
    bb_all = np.array([[p[1], p[2], p[3], p[4]] for p in preds])

    order = np.argsort(-confidence)
    bb_all = bb_all[order]
    img_ids = [img_ids[i] for i in order]

    nd = len(img_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec = class_gt.get(img_ids[d], {"bbox": np.empty((0, 4)), "det": []})
        bb = bb_all[d]
        gts = rec["bbox"]
        ovmax, jmax = -np.inf, -1
        if len(gts):
            # legacy +1 pixel convention
            ix0 = np.maximum(gts[:, 0], bb[0])
            iy0 = np.maximum(gts[:, 1], bb[1])
            ix1 = np.minimum(gts[:, 2], bb[2])
            iy1 = np.minimum(gts[:, 3], bb[3])
            iw = np.maximum(ix1 - ix0 + 1.0, 0.0)
            ih = np.maximum(iy1 - iy0 + 1.0, 0.0)
            inter = iw * ih
            union = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                     + (gts[:, 2] - gts[:, 0] + 1.0) * (gts[:, 3] - gts[:, 1] + 1.0)
                     - inter)
            overlaps = inter / union
            jmax = int(np.argmax(overlaps))
            ovmax = float(overlaps[jmax])
        if ovmax > iou_thres and not rec["det"][jmax]:
            tp[d] = 1.0
            rec["det"][jmax] = True
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / max(float(npos), 1e-12)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(recall, precision, use_07_metric)
    final_rec = float(tp[-1]) / max(float(npos), 1e-12)
    final_prec = float(tp[-1]) / float(nd)
    return float(npos), float(nd), final_rec, final_prec, ap


def evaluate_map(gt_dict: Dict[int, List[List[float]]],
                 val_preds: Sequence[Sequence[float]], num_classes: int,
                 iou_thres: float = 0.5, use_07_metric: bool = False
                 ) -> Dict[str, object]:
    """All-class mAP summary."""
    per_class = {}
    rec_w, prec_w, ap_sum = 0.0, 0.0, 0.0
    rec_n, prec_n = 0.0, 0.0
    for c in range(num_classes):
        npos, nd, rec, prec, ap = voc_eval(gt_dict, val_preds, c, iou_thres,
                                           use_07_metric)
        per_class[c] = {"npos": npos, "nd": nd, "recall": rec,
                        "precision": prec, "ap": ap}
        rec_w += rec * npos
        rec_n += npos
        prec_w += prec * nd
        prec_n += nd
        ap_sum += ap
    return {
        "per_class": per_class,
        "recall": rec_w / max(rec_n, 1e-12),
        "precision": prec_w / max(prec_n, 1e-12),
        "mAP": ap_sum / max(num_classes, 1),
    }
