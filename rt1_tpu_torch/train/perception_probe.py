"""Perception-capacity probe and encoder pretraining (counterpart of
`scripts/perception_probe.py`): `python -m rt1_tpu_torch.train.perception_probe`.

For each (width / depth coefficient, resolution) arm, pretrain the RT-1
tokenizer's encoder on block and effector state regression from rendered
frames (`train/pretrain_vision.py`: the labels are free) and record the
position error it attains: what an encoder and resolution can resolve,
apart from the behaviour-cloning dynamics. Each arm's encoder is saved
(`save_encoder`, `encoder_<arm>.pt` and its `.json` metrics) so that the
best one can seed a learning-proof arm through `--pretrained_encoder`.

The arms and flags are the JAX script's. Results accumulate in
`<out_dir>/probe_results.json` (an arm already recorded is skipped); the
summary without the per-step history goes to `<out_dir>/probe_summary.json`
(the JAX script writes it into its repository's `artifacts/`) and is
printed as the last line. Runs on `cuda` unless `--device cpu` is given.

  python -m rt1_tpu_torch.train.perception_probe --out_dir /tmp/perception_probe \\
      --frames 12000 --steps 3000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

# (name, width coefficient, depth coefficient, (H, W)). small@64x96 is the
# baseline point; the others vary resolution and width one axis at a time;
# b3 is the flagship's coefficients (select it with --arms).
ARMS = [
    ("small_64x96", 0.35, 0.35, (64, 96)),
    ("small_96x160", 0.35, 0.35, (96, 160)),
    ("wide_64x96", 0.70, 0.35, (64, 96)),
    ("small_128x224", 0.35, 0.35, (128, 224)),
    ("b3_128x224", 1.2, 1.4, (128, 224)),
]


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "perception_probe"))
    p.add_argument("--frames", type=int, default=12000)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arms", default="", help="comma-separated arm names; empty = all")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch import resolve_device
    from rt1_tpu_torch.train.pretrain_vision import (generate_state_regression_dataset,
                                                     pretrain_encoder, save_encoder)

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    wanted = args.arms.split(",") if args.arms else None
    selected = [a for a in ARMS if wanted is None or a[0] in wanted]
    results_path = os.path.join(args.out_dir, "probe_results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    for name, wc, dc, hw in selected:
        if name in results:
            print(json.dumps({"arm": name, "status": "already_recorded"}), flush=True)
            continue
        t0 = time.time()
        images, targets, target_names = generate_state_regression_dataset(
            args.frames, seed=args.seed, image_hw=hw)
        gen_s = time.time() - t0
        t1 = time.time()
        model, metrics = pretrain_encoder(
            images, targets, num_steps=args.steps, batch_size=args.batch, seed=args.seed,
            width_coefficient=wc, depth_coefficient=dc, device=device,
            log=lambda text: print(json.dumps({"arm": name, "log": text}), flush=True))
        enc_path = os.path.join(args.out_dir, f"encoder_{name}.pt")
        save_encoder(model, metrics, enc_path)
        results[name] = {
            "width_coefficient": wc,
            "depth_coefficient": dc,
            "resolution": list(hw),
            "frames": args.frames,
            "steps": args.steps,
            "val_rmse_mm": metrics["val_rmse_mm"],
            "history": metrics["history"],
            "target_names": target_names,
            "dataset_seconds": round(gen_s, 1),
            "train_seconds": round(time.time() - t1, 1),
            "encoder_path": enc_path,
            "device": str(device),
        }
        with open(results_path + ".tmp", "w") as f:
            json.dump(results, f, indent=2)
        os.replace(results_path + ".tmp", results_path)
        print(json.dumps({"arm": name, "val_rmse_mm": metrics["val_rmse_mm"],
                          "seconds": round(time.time() - t0, 1)}), flush=True)
    summary = {name: {k: v for k, v in r.items() if k != "history"}
               for name, r in results.items()}
    with open(os.path.join(args.out_dir, "probe_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
