"""End-to-end training on the PyTorch port: train a ~100M-parameter
qwen3-family model for a few hundred steps with the production stack:
the deterministic data pipeline, AdamW, checkpoint and auto-resume, the
straggler monitor, and the Blaze gradient path (eager micro-batch
accumulation).

The port's copy of ``examples/train_lm.py``, at its defaults: qwen3's
geometry at d 512, 8 layers of 8 heads (4 kv heads) of 64, d_ff 1536, a
32k vocabulary, all in f32; 300 steps of 8 sequences of 256 tokens in 2
micro-batches, ``warmup_cosine(3e-4, steps // 10, steps)``.  Weights come
from a ``torch.Generator`` seeded 0 (made on the CPU, then moved, so every
device starts from the same model).  On the card (the default; without
CUDA it raises) every attention call runs K4's f32 form, in the forward and
in the remat recompute (the backward recomputes the plain attention), and
every step after the first is one replay of the captured step
(``train(jit=True)``); ``--device cpu`` runs the plain versions op by op.

Run:  PYTHONPATH=src python3 examples_torch/train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.containers import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime.train_loop import train


def config():
    """~100M params: qwen3's geometry scaled to d=512, 8 layers, 32k vocab."""
    return dataclasses.replace(
        get_arch("qwen3-0.6b"),
        name="qwen3-100m",
        d_model=512, n_heads=8, n_kv_heads=4, d_head=64, d_ff=1536,
        vocab=32_768, n_stages=8, n_layers=8,
        param_dtype="float32", compute_dtype="float32",
    )


def run(device=None, steps: int = 300, batch: int = 8, seq: int = 256,
        grad_accum: int = 2, params=None, cfg=None, horizon: int | None = None,
        jit: bool = True):
    """Train ``steps`` steps on ``device`` (the card unless ``"cpu"``) and
    return ``runtime.train_loop.train``'s result.  ``cfg`` and ``params``
    replace the ~100M config and the seeded weights; ``horizon`` (default
    ``steps``) is the step count the learning-rate schedule spans, so that
    a short run takes the first steps of a longer one; ``jit=False`` runs
    the step eagerly on the card too."""
    device = resolve_device(device)  # the card unless "cpu": before the model is built
    cfg = cfg or config()
    horizon = horizon or steps
    if params is None:
        params = M.init(torch.Generator().manual_seed(0), cfg)
    pipe = TokenPipeline(cfg, batch=batch, seq_len=seq, seed=0)
    opt = AdamW(lr=warmup_cosine(3e-4, horizon // 10, horizon))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        return train(cfg, steps=steps, batch=batch, seq_len=seq, pipeline=pipe,
                     ckpt_dir=ckpt_dir, ckpt_every=max(steps // 5, 25), optimizer=opt,
                     grad_accum=grad_accum, params=params, jit=jit, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device, steps=args.steps, batch=args.batch, seq=args.seq,
              grad_accum=args.grad_accum)
    print(f"steps: {res.final_step}  restarts: {res.restarts}")
    print(f"loss: {res.losses[0]:.3f} → {res.losses[-1]:.3f}")
    print(f"step-time: median {res.straggler['median_s']*1e3:.0f} ms, "
          f"p99 {res.straggler['p99_s']*1e3:.0f} ms, "
          f"stragglers flagged: {res.straggler['stragglers']}")
    assert res.losses[-1] < res.losses[0], "loss must decrease"
    return res


if __name__ == "__main__":
    main()
