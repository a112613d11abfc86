"""End-to-end training demo on the PyTorch port: a reduced qwen3-family
model trained on the learnable "cyclic" stream with checkpointing,
through the same driver as the full-width runs
(``repro_torch.launch.train``).

    python3 examples/torch_train_lm.py [--steps 300]       # card
    python3 examples/torch_train_lm.py --device cpu --steps 20

The port of ``examples/train_lm.py``.  The loss trajectory is printed
every 20 steps; CE falls well below the ln(vocab) random floor.  The
checkpoints go to a temporary directory that is removed at the end.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args, _ = ap.parse_known_args()
    with tempfile.TemporaryDirectory(prefix="torch_train_lm-") as ckpt:
        rc = train_main([
            "--arch", "qwen3-0.6b", "--reduced",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "128",
            "--lr", "1e-3",
            "--ckpt-dir", ckpt,
            "--ckpt-every", "100",
            "--log-every", "20",
            "--data-pattern", "cyclic",
            "--device", args.device,
        ])
    sys.exit(rc)
