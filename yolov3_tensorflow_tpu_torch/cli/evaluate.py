"""Full-dataset VOC evaluation of a checkpoint (counterpart of
`yolov3_tensorflow_tpu/cli/evaluate.py`).

  python -m yolov3_tensorflow_tpu_torch.cli.evaluate \
      --eval_file val.txt --restore_path ./ckpt/best_model_... \
      [eval.batch_size=16 ...]
  (on the GPU by default; add --device cpu to evaluate without one)

Each batch is copied to the device without blocking, goes through the
trainer's eval step (forward, loss, decode and the per-class NMS, the
per-group kernel `csrc/nms.cu` once per batch on a GPU), and comes back in
one copy, losses and detections together.
"""

from __future__ import annotations

import argparse

from yolov3_tensorflow_tpu_torch.cli.common import (load_variables,
                                                    resolve_device, str2bool)
from yolov3_tensorflow_tpu_torch.config import load_config
from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
from yolov3_tensorflow_tpu_torch.evaluation.metrics import (
    AverageMeter, detections_to_pred_rows)
from yolov3_tensorflow_tpu_torch.evaluation.voc import (evaluate_map,
                                                        parse_gt_records)
from yolov3_tensorflow_tpu_torch.ops.losses import LOSS_TERMS
from yolov3_tensorflow_tpu_torch.train.trainer import (make_eval_step,
                                                       to_device, to_host)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="YOLOv3 evaluation (PyTorch).")
    p.add_argument("--eval_file", type=str, required=True)
    p.add_argument("--restore_path", type=str, required=True,
                   help="darknet .weights file or a checkpoint directory "
                        "of this package")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--anchor_path", type=str, default="")
    p.add_argument("--class_name_path", type=str, default="")
    p.add_argument("--img_size", nargs="*", type=int, default=[416, 416])
    p.add_argument("--letterbox_resize", type=str2bool, default=True)
    p.add_argument("--num_threads", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("overrides", nargs="*", default=[])
    return p


def run_eval(args) -> dict:
    """The full evaluation pipeline; returns the evaluate_map result dict
    (plus per-term mean losses under "losses"). Used by main() and by the
    overfit gate (scripts/overfit_gate.py), so asserting on the returned mAP
    exercises exactly the CLI's loader -> eval_step -> VOC path."""
    device = resolve_device(args.device)
    cfg = load_config(args.config or None, args.overrides)
    cfg.data.val_file = args.eval_file
    cfg.data.anchor_path = args.anchor_path
    cfg.data.class_name_path = args.class_name_path
    cfg.data.img_size = tuple(args.img_size)
    cfg.data.letterbox_resize = args.letterbox_resize
    cfg.finalize()

    variables = load_variables(args.restore_path, cfg.model.num_classes,
                               device)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"]}
    eval_step = make_eval_step(cfg)

    loader = DataLoader(
        args.eval_file, cfg.model.num_classes, cfg.anchors,
        cfg.eval.batch_size, cfg.data.img_size, mode="val",
        letterbox=cfg.data.letterbox_resize, num_threads=args.num_threads)

    meters = {k: AverageMeter() for k in LOSS_TERMS}
    rows = []
    for batch in loader.epoch(0):
        losses, dets = eval_step(
            state, to_device(batch.images, device),
            tuple(to_device(y, device) for y in batch.y_true))
        losses_np, dets_np = to_host(losses, dets)
        rows.extend(detections_to_pred_rows(dets_np, batch.image_ids))
        for k in meters:
            meters[k].update(float(losses_np[k]), batch.images.shape[0])

    gt = parse_gt_records(args.eval_file, cfg.data.img_size,
                          cfg.data.letterbox_resize)
    result = evaluate_map(gt, rows, cfg.model.num_classes,
                          cfg.eval.eval_threshold, cfg.eval.use_voc_07_metric)
    result["losses"] = {k: m.average for k, m in meters.items()}
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result = run_eval(args)
    meters = result["losses"]
    for c, r in result["per_class"].items():
        print(f"EVAL: Class {c}: Recall: {r['recall']:.4f}, "
              f"Precision: {r['precision']:.4f}, AP: {r['ap']:.4f}")
    print(f"EVAL: Recall: {result['recall']:.4f}, "
          f"Precison: {result['precision']:.4f}, mAP: {result['mAP']:.4f}")
    print("EVAL: loss: total: {:.2f}, xy: {:.2f}, wh: {:.2f}, conf: {:.2f}, "
          "class: {:.2f}".format(*[meters[k] for k in LOSS_TERMS]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
