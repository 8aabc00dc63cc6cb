"""Validate int8 PTQ accuracy and serving-path detection identity on a
trained checkpoint (counterpart of `scripts/validate_quantized.py`, less
its approximate top-k section: the port has no approximate top-k).

On a checkpoint and its annotation file it reports

1. bf16 mAP through the exact eval NMS path (decode of every anchor, the
   per-group NMS kernel on the GPU)
2. int8 PTQ mAP (`yolov3_forward_int8`) and int8-chained mAP
   (`yolov3_forward_int8_chained`, plain head) through the same path
3. the packed serving head (box_topk 64, max_out 128) against the exact
   prefilter path (box_topk 128) at serving thresholds: detection
   identity rate
4. the stem-int8 hybrid (`--stem_upto`, 12 as the JAX bench builds it):
   mAP through the exact eval path, and identity against the prefilter

Calibration takes the first `--calib_images` images (8, as the JAX
script takes them).

  python -m yolov3_tensorflow_tpu_torch.scripts.validate_quantized \\
      --ckpt build/overfit/ckpt/overfit_final \\
      --data build/overfit/data/train.txt \\
      --names build/overfit/data/synth.names [--device cpu]

Prints one JSON line (the keys of the JAX script's
docs/results/quantize_validation.json, less the approx ones, plus
"device" and "calib_images"); writes <out>/quantize_validation.json.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory of this package or darknet "
                        ".weights file")
    p.add_argument("--data", required=True, help="annotation txt")
    p.add_argument("--names", default="")
    p.add_argument("--img_size", type=int, default=416)
    p.add_argument("--stem_upto", type=int, default=12,
                   help="conv index boundary of the stem-int8 hybrid under "
                        "test (build_detector's default, 12)")
    p.add_argument("--calib_images", type=int, default=8,
                   help="calibrate on the first N images of the set")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--out", default="build/overfit")
    return p


def identity_vs_exact(exact_f, cand_f, batches, iou_min: float = 0.98):
    """Detection identity: (exact detections, how many the candidate path
    has with the same label at IoU >= iou_min in a greedy one-to-one match,
    the largest score deviation of a match)."""
    total = matched = 0
    score_dev = 0.0
    for images in batches:
        de = {k: v.float().cpu().numpy() for k, v in exact_f(images).items()}
        da = {k: v.float().cpu().numpy() for k, v in cand_f(images).items()}
        for i in range(images.shape[0]):
            ve, va = de["valid"][i] > 0.5, da["valid"][i] > 0.5
            eb, el, es = de["boxes"][i][ve], de["labels"][i][ve], \
                de["scores"][i][ve]
            ab, al, as_ = da["boxes"][i][va], da["labels"][i][va], \
                da["scores"][i][va]
            used = np.zeros(len(ab), bool)
            total += len(eb)
            for bx, lb, sc in zip(eb, el, es):
                best, best_iou = -1, iou_min
                for j in range(len(ab)):
                    if used[j] or al[j] != lb:
                        continue
                    ix0 = np.maximum(bx[:2], ab[j][:2])
                    ix1 = np.minimum(bx[2:], ab[j][2:])
                    iw = np.maximum(ix1 - ix0, 0.0)
                    inter = iw[0] * iw[1]
                    ua = (np.prod(bx[2:] - bx[:2])
                          + np.prod(ab[j][2:] - ab[j][:2]) - inter)
                    iou = inter / max(ua, 1e-9)
                    if iou >= best_iou:
                        best, best_iou = j, iou
                if best >= 0:
                    used[best] = True
                    matched += 1
                    score_dev = max(score_dev, float(abs(sc - as_[best])))
    return total, matched, score_dev


def packed_to_raw(fmaps, num_classes: int):
    """Packed logit maps -> the plain [N, Hg, Wg, 3*(5+C)] layout of the
    exact eval path (tx ty tw th, conf, classes per anchor), fp32."""
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import \
        head_row_width
    row = head_row_width(num_classes)
    c = num_classes
    raws = []
    for f in fmaps:
        n, hg, wg, _ = f.shape
        fr = f.reshape(n, hg, wg, 3, row).float()
        raws.append(torch.cat([fr[..., c + 1:c + 5], fr[..., c:c + 1],
                               fr[..., :c]], dim=-1)
                    .reshape(n, hg, wg, 3 * (5 + c)))
    return raws


@torch.inference_mode()
def run(args) -> dict:
    """The whole validation; returns the summary dict."""
    from yolov3_tensorflow_tpu_torch.cli.common import (load_variables,
                                                        resolve_device)
    from yolov3_tensorflow_tpu_torch.config import Config
    from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
    from yolov3_tensorflow_tpu_torch.evaluation.metrics import \
        detections_to_pred_rows
    from yolov3_tensorflow_tpu_torch.evaluation.voc import (evaluate_map,
                                                            parse_gt_records)
    from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
    from yolov3_tensorflow_tpu_torch.models.yolov3 import (
        channels_last_weights, fold_batch_norm, yolov3_forward_folded)
    from yolov3_tensorflow_tpu_torch.ops.fast_postprocess import (
        decode_tables, pack_serving_head, postprocess_packed,
        postprocess_prefilter, yolov3_forward_packed)
    from yolov3_tensorflow_tpu_torch.ops.nms import batched_nms_auto
    from yolov3_tensorflow_tpu_torch.ops.quantize import (
        build_stem_int8_packed, calibrate_activation_scales, quantize_model,
        quantize_model_chained, yolov3_forward_int8,
        yolov3_forward_int8_chained, yolov3_forward_stem_int8_packed)

    device = resolve_device(args.device)
    cfg = Config()
    if args.names:
        cfg.data.class_name_path = args.names
    cfg.data.val_file = args.data
    cfg.finalize()
    num_classes = cfg.model.num_classes
    anchors = np.asarray(cfg.anchors, np.float32)
    size = (args.img_size, args.img_size)                   # (h, w)

    variables = load_variables(args.ckpt, num_classes, device)
    loader = DataLoader(args.data, num_classes, anchors, 8, size, mode="val",
                        letterbox=True, num_threads=8)
    host_batches = list(loader.epoch(0))
    batches = [torch.from_numpy(b.images).to(device) for b in host_batches]
    calib = np.concatenate([b.images for b in host_batches])[
        :args.calib_images]

    folded = channels_last_weights(fold_batch_norm(variables,
                                                   dtype=torch.bfloat16))
    scales = calibrate_activation_scales(variables, calib)
    qparams = quantize_model(variables, scales)
    qchained = quantize_model_chained(variables, scales)
    hp = build_stem_int8_packed(variables, scales, num_classes,
                                upto=args.stem_upto)
    packed_params = pack_serving_head(folded, num_classes)
    tables = decode_tables(size, anchors, device=device)
    e = cfg.eval

    def exact_eval(forward):
        def step(images):
            boxes, confs, probs = predict_boxes(forward(images), anchors,
                                                num_classes, size)
            return batched_nms_auto(boxes, confs * probs, max_out=e.nms_topk,
                                    pre_topk=e.pre_nms_topk,
                                    score_thresh=e.score_threshold,
                                    iou_thresh=e.nms_threshold)
        return step

    def run_map(step):
        rows = []
        for images, b in zip(batches, host_batches):
            dets = {k: v.cpu().numpy() for k, v in step(images).items()}
            rows.extend(detections_to_pred_rows(dets, b.image_ids))
        gt = parse_gt_records(args.data, size, True)
        return float(evaluate_map(gt, rows, num_classes, e.eval_threshold,
                                  e.use_voc_07_metric)["mAP"])

    map_bf16 = run_map(exact_eval(lambda x: yolov3_forward_folded(
        folded, x, compute_dtype=torch.bfloat16)))
    map_int8 = run_map(exact_eval(
        lambda x: yolov3_forward_int8(qparams, x)))
    map_int8_chained = run_map(exact_eval(
        lambda x: yolov3_forward_int8_chained(qchained, x, head="plain")))
    map_stem8 = run_map(exact_eval(lambda x: packed_to_raw(
        yolov3_forward_stem_int8_packed(hp, x), num_classes)))

    def exact_f(images):
        fmaps = yolov3_forward_folded(folded, images,
                                      compute_dtype=torch.bfloat16)
        return postprocess_prefilter(
            fmaps, anchors, num_classes, size, max_out=50, box_topk=128,
            pre_topk=128, score_thresh=0.3, iou_thresh=0.45, tables=tables)

    def packed_serving(forward):
        def f(images):
            return postprocess_packed(
                forward(images), anchors, num_classes, size, max_out=128,
                box_topk=64, score_thresh=0.3, iou_thresh=0.45,
                tables=tables)
        return f

    p_total, p_matched, p_score_dev = identity_vs_exact(
        exact_f, packed_serving(lambda x: yolov3_forward_packed(
            packed_params, x)), batches)
    s_total, s_matched, s_score_dev = identity_vs_exact(
        exact_f, packed_serving(lambda x: yolov3_forward_stem_int8_packed(
            hp, x)), batches)

    return {
        "checkpoint": args.ckpt,
        "dataset": args.data,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "images": sum(b.images.shape[0] for b in host_batches),
        "calib_images": int(calib.shape[0]),
        "mAP_bf16": round(map_bf16, 4),
        "mAP_int8": round(map_int8, 4),
        "mAP_int8_chained": round(map_int8_chained, 4),
        "int8_map_delta": round(map_bf16 - map_int8, 4),
        "packed_serving_identity": round(p_matched / max(p_total, 1), 4),
        "packed_serving_exact_dets": p_total,
        "packed_serving_max_score_dev": round(p_score_dev, 5),
        "stem_int8_upto": args.stem_upto,
        "mAP_stem_int8": round(map_stem8, 4),
        "stem_int8_map_delta": round(map_bf16 - map_stem8, 4),
        "stem_int8_identity": round(s_matched / max(s_total, 1), 4),
        "stem_int8_exact_dets": s_total,
        "stem_int8_max_score_dev": round(s_score_dev, 5),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    summary = run(args)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "quantize_validation.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
