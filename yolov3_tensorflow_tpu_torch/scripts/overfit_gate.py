"""Overfit-to-mAP gate: prove the whole train->eval stack end to end
(counterpart of `scripts/overfit_gate.py`).

Generates a deterministic synthetic dataset (data/synthetic.py), trains the
port's real Trainer on it (real loader, augmentation, encoder, loss,
optimizer and checkpoints), saves `overfit_final`, and requires the real
`cli.evaluate.run_eval` path to report mAP >= target on the training
images. A sign, coordinate, loss or NMS fault anywhere in the chain fails
the gate.

  python -m yolov3_tensorflow_tpu_torch.scripts.overfit_gate   # full run (GPU)
  python -m yolov3_tensorflow_tpu_torch.scripts.overfit_gate --preset quick \
      --device cpu                                    # small run on the CPU

Writes <out_dir>/overfit_result*.json and prints one JSON summary line.
Exit code 0 iff mAP >= --target_map.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", default="build/overfit")
    p.add_argument("--preset", choices=["full", "quick"], default="full",
                   help="full: 50 imgs @416, 300 epochs. quick: 16 imgs "
                        "@160, 60 epochs")
    p.add_argument("--num_images", type=int, default=0,
                   help="override preset image count")
    p.add_argument("--epochs", type=int, default=0,
                   help="override preset epoch count")
    p.add_argument("--img_size", type=int, default=0,
                   help="override preset square image size")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--target_map", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--focal", type=lambda v: v.lower() in ("1", "true"),
                   default=False,
                   help="enable the focal conf loss (the adam recipe "
                        "defaults to the plain BCE conf loss)")
    p.add_argument("--val_every", type=int, default=0,
                   help="validate every N epochs during training (0 = only "
                        "the final gate evaluation)")
    p.add_argument("--recipe", choices=["adam", "reference"], default="adam",
                   help="'adam': adam + cosine, strategies off. "
                        "'reference': momentum 0.9 + piecewise LR + 3-epoch "
                        "warmup, with mixup, label smoothing, focal conf "
                        "loss and multi-scale training all on")
    p.add_argument("--device_augment",
                   type=lambda v: v.lower() in ("1", "true"), default=False,
                   help="run the loader in device-augment mode (pixels on "
                        "the device, data/device_augment.py)")
    p.add_argument("--device_encode",
                   type=lambda v: v.lower() in ("1", "true"), default=False,
                   help="also build the y_true grids on the device from "
                        "padded GT boxes (data/device_encode.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train and evaluate on (cuda, "
                        "cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    quick = args.preset == "quick"
    num_images = args.num_images or (16 if quick else 50)
    epochs = args.epochs or (60 if quick else 300)
    size = args.img_size or (160 if quick else 416)

    from yolov3_tensorflow_tpu_torch.cli import evaluate as evaluate_cli
    from yolov3_tensorflow_tpu_torch.cli.common import resolve_device
    from yolov3_tensorflow_tpu_torch.config import Config
    from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
    from yolov3_tensorflow_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    out_dir = os.path.abspath(args.out_dir)
    data = generate_dataset(os.path.join(out_dir, "data"),
                            num_images=num_images, seed=args.seed,
                            img_size=(size, size))

    cfg = Config()
    cfg.data.train_file = data["annotation_file"]
    cfg.data.val_file = data["annotation_file"]
    cfg.data.class_name_path = data["names_file"]
    cfg.data.img_size = (size, size)
    cfg.data.letterbox_resize = True
    cfg.data.device_augment = args.device_augment
    cfg.data.device_encode = args.device_encode
    cfg.data.staged_size = size
    cfg.train.batch_size = args.batch_size
    cfg.train.total_epochs = epochs
    if args.recipe == "reference":
        # the reference recipe, with the piecewise boundaries at 30% and 50%
        # of the run (its 100-epoch schedule's [30, 50]) and a 3-epoch warmup
        cfg.data.multi_scale_train = True
        if size != 416:
            # the bucket grid {320..608} is sized for a 416 base; other gate
            # sizes take the proportional grid (0.77x..1.46x in 32 px steps)
            s32 = size // 32
            xs = range(max(2, round(s32 * 10 / 13)),
                       max(3, round(s32 * 19 / 13)) + 1)
            cfg.data.multi_scale_sizes = tuple(x * 32 for x in xs)
            # device-augment staging must fit the largest bucket
            cfg.data.staged_size = max(size,
                                       max(cfg.data.multi_scale_sizes))
        cfg.data.use_mix_up = True
        cfg.model.use_label_smooth = True
        cfg.model.use_focal_loss = True
        cfg.train.optimizer = "momentum"
        cfg.train.momentum = 0.9
        cfg.train.lr_type = "piecewise"
        cfg.train.learning_rate_init = args.lr
        cfg.train.pw_boundaries = [max(1, int(epochs * 0.3)),
                                   max(2, int(epochs * 0.5))]
        cfg.train.pw_values = [args.lr, args.lr * 0.3, args.lr * 0.1]
        cfg.train.use_warm_up = True
        cfg.train.warm_up_epoch = 3
    else:
        cfg.data.multi_scale_train = False
        cfg.data.use_mix_up = False
        cfg.model.use_label_smooth = False
        cfg.model.use_focal_loss = args.focal
        cfg.train.optimizer = "adam"
        cfg.train.lr_type = "cosine_decay"
        cfg.train.learning_rate_init = args.lr
        cfg.train.lr_lower_bound = args.lr / 50
        cfg.train.use_warm_up = True
        cfg.train.warm_up_epoch = 2
    cfg.train.update_part = None          # train the whole model
    cfg.train.restore_exclude = None
    cfg.train.train_evaluation_step = 0
    cfg.train.val_evaluation_epoch = args.val_every
    cfg.train.save_epoch = 0
    cfg.train.save_dir = os.path.join(out_dir, "ckpt")
    cfg.train.log_dir = os.path.join(out_dir, "logs")
    cfg.train.progress_log_path = os.path.join(out_dir, "progress.log")
    cfg.finalize()

    t0 = time.time()
    trainer = Trainer(cfg, seed=args.seed, device=device)
    try:
        state = trainer.fit()
    finally:
        trainer.close()
    train_secs = time.time() - t0
    ckpt_path = trainer.store.save("overfit_final", state, include_opt=False)

    # the gate: the real cli.evaluate path on the saved checkpoint
    eval_args = evaluate_cli.build_parser().parse_args([
        "--eval_file", data["annotation_file"],
        "--restore_path", ckpt_path,
        "--class_name_path", data["names_file"],
        "--img_size", str(size), str(size),
        "--device", str(device),
    ])
    result = evaluate_cli.run_eval(eval_args)

    # downsampled training-loss curve from the trainer's JSONL metric mirror
    curve = []
    metrics_path = os.path.join(cfg.train.log_dir, "metrics.jsonl")
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            totals = [json.loads(line) for line in f
                      if '"train_batch_statistics/loss_total"' in line]
        stride = max(1, len(totals) // 40)
        curve = [{"step": t["step"], "loss": round(t["value"], 3)}
                 for t in totals[::stride]]

    summary = {
        "gate": "overfit_map",
        "recipe": args.recipe,
        "device_augment": args.device_augment,
        "device_encode": args.device_encode,
        "device": str(device),
        "preset": args.preset,
        "num_images": num_images,
        "img_size": size,
        "epochs": epochs,
        "steps": int(state["step"]),
        "train_seconds": round(train_secs, 1),
        "mAP": round(float(result["mAP"]), 4),
        "recall": round(float(result["recall"]), 4),
        "precision": round(float(result["precision"]), 4),
        "per_class_ap": {str(c): round(float(r["ap"]), 4)
                         for c, r in result["per_class"].items()},
        "final_loss": round(float(result["losses"]["total"]), 3),
        "target_map": args.target_map,
        "passed": bool(result["mAP"] >= args.target_map),
        "checkpoint": ckpt_path,
        "loss_curve": curve,
    }
    suffix = "" if args.recipe == "adam" else f"_{args.recipe}"
    if args.device_augment or args.device_encode:
        suffix += "_device"
    name = f"overfit_result{suffix}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "loss_curve"}))
    return 0 if summary["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
