"""Train a tiny LM of one registered architecture with the port.

The port's mirror of ``examples/train_tiny_lm.py``: synthetic bigram data,
AdamW, grad accumulation, async checkpoints, the loss falling.  On the
card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py \\
        --arch granite-moe-1b-a400m [--device cpu]
"""
import argparse
import tempfile
from typing import List, Optional

import torch

from repro_torch.config import ParallelConfig, get_arch
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import (AdamWConfig, checkpoint, init_opt_state,
                               make_train_step)


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Returns the loss of every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    print(f"arch={args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size}) on {dev}")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=20, total_steps=args.steps)
    state = init_opt_state(params)
    step = make_train_step(cfg, ParallelConfig(grad_accum=2), opt_cfg)

    ckpt_dir = tempfile.mkdtemp(prefix="eda-tiny-")
    writers, losses = [], []
    for i, batch in enumerate(lm_batches(args.batch, args.seq,
                                         cfg.vocab_size, steps=args.steps)):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"lr {float(m['lr']):.2e}")
        if (i + 1) % 100 == 0:
            writers.append(checkpoint.save(ckpt_dir, i + 1,
                                           {"params": params},
                                           blocking=False))
    for w in writers:
        w.join()
    print(f"checkpoints: {checkpoint.all_steps(ckpt_dir)} in {ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
