"""Where does a trained gate's precision at the eval threshold come from?
(counterpart of `scripts/analyze_recipe_precision.py`)

Precision at the eval config counts every detection above the NMS score
threshold 0.01 (`config.eval.score_threshold`), so it speaks of the
low-confidence tail, not of the ranking (mAP sorts by confidence). For
each overfit-gate directory laid out as `scripts/overfit_gate.py` writes
it (`data/train.txt`, `data/synth.names`, `ckpt/overfit_final`), on its
own images, through the real eval path (the eval step's forward,
`train.trainer.make_eval_forward`: the live-BN forward, decode and the
per-class NMS, the per-group kernel K2 once per batch on a GPU), it gives:

  1. precision, recall and mAP at post-hoc score cutoffs 0.01 ... 0.5
     (`evaluation.voc.evaluate_map` on the detections kept): if precision
     recovers while mAP stays, the low precision is a thresholding
     artifact, not a ranking fault;
  2. every anchor above 0.01 with its score decomposed into sigmoid(conf)
     and its best class probability (`models.decode.predict_boxes` on the
     same feature maps): a conf that stays high on easy negatives (the
     focal loss) against class probabilities held up by label smoothing.

By default the gates are the port's under `build/` (`build/overfit_ref`
for the reference recipe, `build/overfit`, `build/overfit_dev`);
`--gate LABEL=DIR` names others. A directory without a checkpoint is
skipped. Writes the results as JSON to `--out` (default
`build/recipe_precision_sweep.json`) and a note to `--note` (default
`build/recipe_precision_note.md`), and prints the JSON last.

  python -m yolov3_tensorflow_tpu_torch.scripts.analyze_recipe_precision \\
      [--gate reference=build/overfit_ref ...] [--img_size 416] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from yolov3_tensorflow_tpu_torch.cli.common import (device_name,
                                                    load_variables,
                                                    resolve_device)
from yolov3_tensorflow_tpu_torch.config import load_config
from yolov3_tensorflow_tpu_torch.data.loader import DataLoader
from yolov3_tensorflow_tpu_torch.evaluation.metrics import \
    detections_to_pred_rows
from yolov3_tensorflow_tpu_torch.evaluation.voc import (evaluate_map,
                                                        parse_gt_records)
from yolov3_tensorflow_tpu_torch.models.decode import predict_boxes
from yolov3_tensorflow_tpu_torch.train.trainer import (make_eval_forward,
                                                       to_device, to_host)

GATES = (("reference", os.path.join("build", "overfit_ref")),
         ("adam", os.path.join("build", "overfit")),
         ("device", os.path.join("build", "overfit_dev")))
CUTOFFS = (0.01, 0.03, 0.05, 0.1, 0.2, 0.3, 0.5)
TAIL = 0.01                            # the decomposed anchors' cutoff


def gate_config(out_dir: str, img_size: int):
    """The evaluation config of a gate directory, as cli.evaluate builds
    it."""
    cfg = load_config(None, [])
    cfg.data.val_file = os.path.join(out_dir, "data", "train.txt")
    cfg.data.class_name_path = os.path.join(out_dir, "data", "synth.names")
    cfg.data.img_size = (img_size, img_size)
    cfg.finalize()
    return cfg


def eval_gate(out_dir: str, img_size: int, device: torch.device) -> Dict:
    """Run the gate's checkpoint over its images. Returns {"cfg", "rows"
    (voc_eval prediction rows [img_id, x0, y0, x1, y1, score, label]),
    "gt", "anchors" ([N, 2]: sigmoid(conf), best class probability of
    every anchor whose product passes TAIL), "pairs" ([M, 3]: image id,
    label, conf * class prob of every (anchor, class) pair above TAIL,
    the scores the NMS chose the detections from), "batches"}."""
    cfg = gate_config(out_dir, img_size)
    variables = load_variables(os.path.join(out_dir, "ckpt",
                                            "overfit_final"),
                               cfg.model.num_classes, device)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"]}
    forward = make_eval_forward(cfg)
    anchors = np.asarray(cfg.anchors, np.float32)
    loader = DataLoader(cfg.data.val_file, cfg.model.num_classes,
                        cfg.anchors, cfg.eval.batch_size, cfg.data.img_size,
                        mode="val", letterbox=cfg.data.letterbox_resize,
                        num_threads=4)
    rows, anchor_parts, pair_parts, batches = [], [], [], 0
    for batch in loader.epoch(0):
        images = to_device(batch.images, device)
        fmaps, dets = forward(state, images)
        _, confs, probs = predict_boxes(fmaps, anchors,
                                        cfg.model.num_classes,
                                        cfg.data.img_size)
        scores = confs * probs                           # [N, A, C]
        best = probs.amax(dim=-1)
        conf = confs[..., 0]
        (dets_np, ) = to_host(dets)
        rows.extend(detections_to_pred_rows(dets_np, batch.image_ids))
        sel = conf * best > TAIL
        anchor_parts.append(torch.stack([conf[sel], best[sel]], -1)
                            .float().cpu().numpy())
        img, _, label = (scores > TAIL).nonzero(as_tuple=True)
        ids = torch.as_tensor(np.asarray(batch.image_ids),
                              device=scores.device)[img]
        pair_parts.append(torch.stack(
            [ids.float(), label.float(), scores[scores > TAIL].float()], -1)
            .cpu().numpy())
        batches += 1
    gt = parse_gt_records(cfg.data.val_file, cfg.data.img_size,
                          cfg.data.letterbox_resize)
    return {"cfg": cfg, "rows": rows, "gt": gt, "batches": batches,
            "anchors": np.concatenate(anchor_parts, 0),
            "pairs": np.concatenate(pair_parts, 0)}


def sweep(run: Dict) -> Dict[str, Dict]:
    """Recall, precision and mAP of the detections at each cutoff."""
    cfg = run["cfg"]
    out = {}
    for cut in CUTOFFS:
        kept = [r for r in run["rows"] if r[5] >= cut]
        res = evaluate_map(run["gt"], kept, cfg.model.num_classes,
                           cfg.eval.eval_threshold,
                           cfg.eval.use_voc_07_metric)
        out[str(cut)] = {"n_dets": len(kept), "recall": res["recall"],
                         "precision": res["precision"], "mAP": res["mAP"]}
    return out


def decomposition(cp: np.ndarray) -> Dict:
    """JAX's summary of the above-TAIL anchors' (conf, best prob)."""
    if not len(cp):
        return {}
    return {
        "n_anchors_above_001": int(len(cp)),
        "conf_quantiles_50_90_99": [float(q) for q in
                                    np.quantile(cp[:, 0], [.5, .9, .99])],
        "prob_quantiles_50_90_99": [float(q) for q in
                                    np.quantile(cp[:, 1], [.5, .9, .99])],
        "frac_conf_gt_0.1": float((cp[:, 0] > 0.1).mean()),
        "frac_prob_gt_0.1": float((cp[:, 1] > 0.1).mean()),
        "frac_conf_gt_0.5": float((cp[:, 0] > 0.5).mean()),
    }


def analyze(label: str, out_dir: str, img_size: int,
            device: torch.device) -> Dict:
    run = eval_gate(out_dir, img_size, device)
    result = {"dir": out_dir, "eval_batches": run["batches"],
              "sweep": sweep(run),
              "decomposition": decomposition(run["anchors"])}
    for cut, s in result["sweep"].items():
        print(f"[{label}] cut {float(cut):.2f}: n={s['n_dets']:6d} recall "
              f"{s['recall']:.4f} precision {s['precision']:.4f} mAP "
              f"{s['mAP']:.4f}", flush=True)
    print(f"[{label}] decomposition: {result['decomposition']}", flush=True)
    return result


def note(results: Dict, card: str) -> str:
    """The markdown note of the results."""
    lines = ["# Recipe precision: the low-confidence tail of the gates", "",
             f"`python -m yolov3_tensorflow_tpu_torch.scripts."
             f"analyze_recipe_precision`, on {card}.", ""]
    for label, r in results.items():
        lines += [f"## {label} (`{r['dir']}`)", "",
                  "| cutoff | detections | recall | precision | mAP |",
                  "|---|---|---|---|---|"]
        lines += [f"| {cut} | {s['n_dets']} | {s['recall']:.4f} | "
                  f"{s['precision']:.4f} | {s['mAP']:.4f} |"
                  for cut, s in r["sweep"].items()]
        lines += ["", f"Anchors above {TAIL}: {r['decomposition']}", ""]
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gate", action="append", default=[],
                   metavar="LABEL=DIR",
                   help="a gate directory to analyze (repeatable; default "
                        + ", ".join(f"{k}={v}" for k, v in GATES) + ")")
    p.add_argument("--img_size", type=int, default=416,
                   help="the gate's square image size")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N; cpu for the tests)")
    p.add_argument("--out", default=os.path.join(
        "build", "recipe_precision_sweep.json"))
    p.add_argument("--note", default=os.path.join(
        "build", "recipe_precision_note.md"))
    return p


def main(argv: Optional[List[str]] = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    gates = []
    for spec in args.gate:
        label, sep, path = spec.partition("=")
        if not sep:
            p.error(f"--gate takes LABEL=DIR, got {spec!r}")
        gates.append((label, path))
    results = {}
    with torch.inference_mode():
        for label, out_dir in gates or GATES:
            if not os.path.isdir(os.path.join(out_dir, "ckpt")):
                print(f"[{label}] missing checkpoint dir {out_dir}, skipped",
                      flush=True)
                continue
            results[label] = analyze(label, out_dir, args.img_size, device)
    card = device_name(device)
    for path, text in ((args.out, json.dumps(
            {"device": card, "gates": results}, indent=2)),
            (args.note, note(results, card))):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    print(json.dumps({"device": card, "gates": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
