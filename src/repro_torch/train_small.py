"""Train a small decoder LM with the port's whole training stack: the
packed synthetic data stream -> the model zoo -> the Adam train step.

    PYTHONPATH=src python -m repro_torch.train_small [--steps N] [--arch A]
                                                     [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (and raises
without a card).  Prints the loss trend; exits 0 only if the mean loss of
the last 5 steps is below that of the first 5.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training.data import DataConfig, PackedStream
from repro_torch.training.optimizer import make_train_step, tree_leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the CUDA card otherwise")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    init_state, train_step = make_train_step(model, "adam")
    state = init_state(torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device}")

    data = PackedStream(DataConfig(cfg.vocab_size, args.seq, args.batch))
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'OK — decreasing' if last < first else 'NOT decreasing'})")
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
