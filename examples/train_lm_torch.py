"""End-to-end training driver example on the PyTorch/CUDA port: train a
reduced stablelm-family LM for a few hundred steps with checkpointing,
through the same driver that trains the published config on a card.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]

The twin of ``examples/train_lm.py``: the same flags and driver arguments,
on ``repro_torch.launch.train`` (the CUDA card unless ``--device cpu``).
Loss falls from ~ln(V) toward the entropy of the structured synthetic
bigram stream. Interrupt and re-run to exercise restart-from-checkpoint;
the checkpoint format is the reference's, so either driver resumes the
other's. Checkpoints go to ``build/train_lm_torch`` inside this checkout
unless ``--ckpt-dir`` names another directory, so that two checkouts
never resume each other's runs.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import train as T  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "train_lm_torch"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    T.main(
        [
            "--arch", "stablelm-3b", "--smoke",
            "--steps", str(args.steps),
            "--batch", "16", "--seq", "128", "--lr", "3e-3",
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
            "--device", args.device,
        ]
    )


if __name__ == "__main__":
    main()
