"""Serving on the PyTorch port: batched prefill and greedy decode with KV and
recurrent-state caches, across three architecture families (attention,
hybrid, RWKV).

The port's copy of ``examples/serve_lm.py``: the reduced qwen3-0.6b,
zamba2-7b and rwkv6-1.6b (the reference's ``.reduced()`` rule: f32, two
stages), 4 prompts of 16 tokens, caches of 64 rows, 24 greedy steps,
through ``repro_torch.launch.serve_lm.generate``.  Weights come from a
``torch.Generator`` seeded 0 (made on the CPU, then moved, so every device
serves the same model), the prompts from numpy's seed 0.  On the card (the
default; without CUDA it raises) every attention call runs K4, every
Mamba-2 layer K5 and every RWKV-6 layer K6; ``--device cpu`` runs their
plain versions.

Run:  PYTHONPATH=src python3 examples_torch/serve_lm.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.containers import resolve_device
from repro_torch.launch.serve_lm import generate
from repro_torch.models import model as M

ARCHS = ("qwen3-0.6b", "zamba2-7b", "rwkv6-1.6b")
BATCH, PROMPT, MAX_LEN, GEN = 4, 16, 64, 24


def run(device=None, params: dict | None = None, cfg: dict | None = None,
        archs=ARCHS, batch: int = BATCH, prompt_len: int = PROMPT,
        max_len: int = MAX_LEN, gen: int = GEN) -> dict:
    """Each arch's greedy tokens ``[batch, gen]``, decode seconds and the
    f32 logits that chose them (``generate(return_logits=True)``), on
    ``device`` (the card unless ``"cpu"``).  ``cfg`` and ``params`` map an
    arch to its config and weights in place of the reduced config and the
    seeded ones."""
    dev = resolve_device(device)
    out = {}
    for arch in archs:
        c = (cfg or {}).get(arch) or get_arch(arch).reduced()
        p = (params or {}).get(arch)
        if p is None:
            p = M.init(torch.Generator().manual_seed(0), c)
        p = M.map_tree(lambda t: t.to(dev), p)
        prompts = torch.from_numpy(np.random.RandomState(0).randint(
            0, c.vocab, (batch, prompt_len)).astype(np.int64)).to(dev)
        toks, dt, logits = generate(c, p, prompts, max_len=max_len, gen=gen,
                                    return_logits=True)
        out[arch] = {"tokens": toks.cpu(), "seconds": dt, "logits": logits.cpu(),
                     "prompts": prompts.cpu()}
        del p
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device)
    for arch, r in res.items():
        toks, dt = r["tokens"], r["seconds"]
        print(f"{arch:14s} generated {tuple(toks.shape)} in {dt:.2f}s "
              f"({toks.numel() / dt:.0f} tok/s) sample={toks[0, :8].tolist()}")
    return res


if __name__ == "__main__":
    main()
