"""Training launcher (the port of ``repro/launch/train.py``).

On the CPU, at the reduced config (the default)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 3 --device cpu

On the card, at full width and depth (random weights from ``--seed``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --full \\
      --steps 8 --batch 4 --seq 4096 --grad-accum 2

It prints the JAX launcher's JSON.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--reduced`` is the default, ``--full`` turns it
off.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pipe = TokenPipeline(cfg, batch=args.batch, seq_len=args.seq, seed=args.seed)
    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps))
    res = train(
        cfg,
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq,
        pipeline=pipe,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        optimizer=opt,
        grad_accum=args.grad_accum,
        seed=args.seed,
        device=args.device,
    )
    print(
        json.dumps(
            {
                "arch": cfg.name,
                "steps": res.final_step,
                "loss_first": res.losses[0],
                "loss_last": res.losses[-1],
                "restarts": res.restarts,
                "straggler": res.straggler,
            },
            indent=1,
        )
    )


if __name__ == "__main__":
    main()
