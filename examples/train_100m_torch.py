"""Train a ~100M-param llama-style model for a few hundred steps with
checkpoint / restart, through the PyTorch port's ``launch.train`` at
``examples/train_100m.py``'s settings.

  PYTHONPATH=src python examples/train_100m_torch.py [--steps 200] \\
      [--device cpu]

~100M params: d_model=768, 12 layers, 8k vocab. Runs on the card unless
``--device cpu``. The loss should fall from ~9 to well under 7 within the
first tens of steps.
"""
import argparse

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="build/ckpt_100m")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    train_main([
        "--arch", "llama3.2-1b",
        "--steps", str(args.steps),
        "--seq", "256",
        "--batch", "8",
        "--d-model", "768",
        "--layers", "12",
        "--vocab", "8192",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
    ] + (["--device", args.device] if args.device else []))
