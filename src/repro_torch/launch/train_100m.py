"""Train a ~100M-parameter llama-family model on the synthetic pipeline
with checkpoint/resume — counterpart of the JAX package's
``examples/train_100m.py``.

  PYTHONPATH=src python -m repro_torch.launch.train_100m [--steps 300] \\
      [--device cpu]

(~100M params: 12 layers x d_model 768 + the reduced 4096-token vocab.)
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
    args = ap.parse_args(argv)
    return train_main([
        "--arch", "llama3-8b", "--reduced",
        "--d-model", "768", "--n-layers", "12",
        "--steps", str(args.steps), "--batch", "4", "--seq", "256",
        "--ckpt", args.ckpt, "--ckpt-every", "50",
        "--log-every", "5", "--device", args.device,
    ])


if __name__ == "__main__":
    main()
