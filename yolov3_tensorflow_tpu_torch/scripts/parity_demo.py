"""One-command real-weights parity harness (counterpart of the JAX
package's `scripts/parity_demo.py`).

The reference's correctness evidence is darknet-converted COCO weights
reproducing its committed demo detections (its
data/demo_data/results/{dog,kite,messi}.jpg). No pretrained weights ship
with this repository, so the harness packages the whole check into one
command for the day a real `yolov3.weights` (or a checkpoint of this
package) is at hand:

    python -m yolov3_tensorflow_tpu_torch.scripts.parity_demo \
        --weights yolov3.weights --images dog.jpg kite.jpg messi.jpg

For each image it
  1. runs the exact detection path at the reference demo settings
     (416x416 letterbox, score 0.3, NMS IoU 0.45, max 200 boxes),
  2. writes a rendered jpg and a numeric detections JSON side by side
     under --out_dir, for diffing against the reference's renders,
  3. re-runs with the serving path (--serving_mode) and reports box-level
     agreement (greedy same-label matching at IoU >= 0.9 within a score
     tolerance) between the exact and serving paths,
  4. with --expect coco (the default, for real weights) requires the
     well-known COCO detections: dog.jpg {dog, bicycle, truck}, kite.jpg
     {person, kite}, messi.jpg {person, sports ball}.

With synthetic weights use --expect off (class presence means nothing
then); the harness still runs every step and still requires the
exact-vs-serving agreement, which does not depend on the weights.

Runs on the GPU by default (--device cpu without one). Exit code 0 = every
requested check passed, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import cv2
import numpy as np
import torch

# the reference repository's demo images, relative to its checkout
REFERENCE_DEMO_DIR = os.path.join("data", "demo_data")

# objects visible in the reference's committed demo renders (COCO names)
EXPECTED_COCO = {
    "dog": {"dog", "bicycle", "truck"},
    "kite": {"person", "kite"},
    "messi": {"person", "sports ball"},
}


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix [N, M] between two xyxy box sets."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def match_detections(ref, other, *, iou_thresh=0.9, score_tol=0.05):
    """Greedy one-to-one agreement between two detection sets.

    Each set is (boxes [N,4], scores [N], labels [N]). A ref detection is
    matched when some unused other-detection has the same label,
    IoU >= iou_thresh and |score delta| <= score_tol. Returns
    (matched_count, ref_count, other_count)."""
    rb, rs, rl = ref
    ob, os_, ol = other
    used = np.zeros(len(os_), bool)
    iou = iou_xyxy(np.asarray(rb, np.float32).reshape(-1, 4),
                   np.asarray(ob, np.float32).reshape(-1, 4))
    matched = 0
    for i in np.argsort(-np.asarray(rs)):
        cand = np.where((~used) & (np.asarray(ol) == rl[i])
                        & (iou[i] >= iou_thresh)
                        & (np.abs(np.asarray(os_) - rs[i]) <= score_tol))[0]
        if len(cand):
            used[cand[np.argmax(iou[i][cand])]] = True
            matched += 1
    return matched, len(rs), len(os_)


def detect_one(detect, img_path: str, new_size, classes):
    """Run a built detector on one image; returns (dets, rendered_bgr)."""
    from yolov3_tensorflow_tpu_torch.cli.detect_image import (invert_boxes,
                                                              preprocess)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import \
        detections_to_numpy
    from yolov3_tensorflow_tpu_torch.utils.viz import (get_color_table,
                                                       plot_one_box)

    img_ori = cv2.imread(img_path)
    if img_ori is None:
        raise FileNotFoundError(img_path)
    inp, inv = preprocess(img_ori, new_size, True)
    boxes, scores, labels = detections_to_numpy(detect(torch.from_numpy(inp)),
                                                0)
    boxes = invert_boxes(boxes, inv)

    rendered = img_ori.copy()
    color_table = get_color_table(len(classes))
    for box, score, label in zip(boxes, scores, labels):
        plot_one_box(rendered, box,
                     label=f"{classes[int(label)]}, {score * 100:.2f}%",
                     color=color_table[int(label)])
    return (boxes, scores, labels), rendered


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights", required=True,
                   help="darknet .weights file or a checkpoint directory of "
                        "this package")
    p.add_argument("--images", nargs="*", default=None,
                   help="demo images (default: the reference's "
                        "dog/kite/messi jpgs under data/demo_data)")
    p.add_argument("--out_dir", default="docs/results/parity_demo")
    p.add_argument("--new_size", nargs=2, type=int, default=[416, 416],
                   help="input resolution [width, height]")
    p.add_argument("--class_name_path", default="")
    p.add_argument("--score_thresh", type=float, default=0.3)
    p.add_argument("--nms_thresh", type=float, default=0.45)
    p.add_argument("--max_boxes", type=int, default=200)
    p.add_argument("--expect", choices=["coco", "off"], default="coco",
                   help="'coco': assert the well-known demo objects are "
                        "detected (requires real COCO weights); 'off' for "
                        "synthetic weights")
    p.add_argument("--agreement_min", type=float, default=0.95,
                   help="required exact-vs-serving matched fraction")
    p.add_argument("--serving_mode", default="packed",
                   choices=["packed", "split", "prefilter"],
                   help="serving path to compare against the exact path")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from yolov3_tensorflow_tpu_torch.cli.common import (load_anchors,
                                                        load_classes,
                                                        load_variables,
                                                        resolve_device)
    from yolov3_tensorflow_tpu_torch.ops.postprocess import build_detector

    device = resolve_device(args.device)
    anchors = load_anchors("")
    classes = load_classes(args.class_name_path)
    num_classes = len(classes)
    name_to_id = {v: k for k, v in classes.items()}
    variables = load_variables(args.weights, num_classes, device)

    images = args.images or [
        os.path.join(REFERENCE_DEMO_DIR, f"{stem}.jpg")
        for stem in ("dog", "kite", "messi")]
    os.makedirs(args.out_dir, exist_ok=True)

    img_hw = (args.new_size[1], args.new_size[0])
    common = dict(device=device, max_out=args.max_boxes,
                  score_thresh=args.score_thresh, iou_thresh=args.nms_thresh)
    detect_exact = build_detector(variables, anchors, num_classes, img_hw,
                                  mode="exact", **common)
    detect_serving = build_detector(variables, anchors, num_classes, img_hw,
                                    mode=args.serving_mode, **common)

    summary = {"weights": args.weights, "images": {}, "ok": True,
               "settings": {"new_size": args.new_size,
                            "score_thresh": args.score_thresh,
                            "nms_thresh": args.nms_thresh,
                            "serving_mode": args.serving_mode}}
    failures = []
    for img_path in images:
        stem = os.path.splitext(os.path.basename(img_path))[0]
        (boxes, scores, labels), rendered = detect_one(
            detect_exact, img_path, args.new_size, classes)
        serving_dets, _ = detect_one(detect_serving, img_path,
                                     args.new_size, classes)

        out_jpg = os.path.join(args.out_dir, f"{stem}.jpg")
        cv2.imwrite(out_jpg, rendered)
        dets_json = {
            "image": img_path,
            "detections": [
                {"box_xyxy": [float(v) for v in b],
                 "score": float(s), "label": int(lb),
                 "class": classes[int(lb)]}
                for b, s, lb in zip(boxes, scores, labels)],
        }
        with open(os.path.join(args.out_dir, f"{stem}_detections.json"),
                  "w") as f:
            json.dump(dets_json, f, indent=2)

        matched, n_ref, n_other = match_detections(
            (boxes, scores, labels), serving_dets)
        agreement = matched / max(n_ref, 1)
        det_names = {classes[int(lb)] for lb, s in zip(labels, scores)
                     if s >= args.score_thresh}
        entry = {"n_exact": int(n_ref), "n_serving": int(n_other),
                 "matched": int(matched), "agreement": agreement,
                 "classes": sorted(det_names)}
        summary["images"][stem] = entry
        print(f"{stem}: {n_ref} detections ({sorted(det_names)}), "
              f"exact-vs-{args.serving_mode} agreement "
              f"{matched}/{n_ref} = {agreement:.3f}")

        if n_ref and agreement < args.agreement_min:
            failures.append(f"{stem}: exact-vs-{args.serving_mode} agreement "
                            f"{agreement:.3f} < {args.agreement_min}")
        if args.expect == "coco" and stem in EXPECTED_COCO:
            known = {c for c in EXPECTED_COCO[stem] if c in name_to_id}
            missing = known - det_names
            if missing:
                failures.append(f"{stem}: expected classes missing: "
                                f"{sorted(missing)}")

    summary["ok"] = not failures
    summary["failures"] = failures
    with open(os.path.join(args.out_dir, "parity_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if failures:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1
    print(f"parity demo OK -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
