#!/usr/bin/env python3
"""Whether the captured training step captures with either setting of
``torch.utils.checkpoint``'s ``preserve_rng_state`` (the model's remat
calls leave it at its default, True).

Run from the repository root, on a card::

    python3 profiling/train_rng_probe.py

For each setting it forces the value on every ``checkpoint`` call of
``models/model.py``, builds a ``TrainGraph`` over reduced qwen3-0.6b in
bf16 (a batch of 2 × 32 tokens) and takes 3 steps (the warm-up, the
capture, 2 replays), then prints whether it captured and the last loss,
or the error the capture raised.
"""
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.runtime import train_loop as T  # noqa: E402


def main() -> int:
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    real = M.checkpoint
    try:
        for preserve in (False, True):
            def forced(*a, preserve=preserve, **kw):
                kw["preserve_rng_state"] = preserve
                return real(*a, **kw)

            M.checkpoint = forced
            opt = AdamW(lr=1e-3)
            params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
            state = opt.init(params)
            batch = TokenPipeline(cfg, batch=2, seq_len=32).device_batch(0, dev)
            graph = T.TrainGraph(T.make_train_step(cfg, opt, device=dev), params, state,
                                 batch, name=cfg.name)
            try:
                for _ in range(3):
                    loss = float(graph.step(batch))
                print(f"preserve_rng_state={preserve}: captured, {graph.replays} replays, "
                      f"loss {loss}", flush=True)
            except RuntimeError as e:
                print(f"preserve_rng_state={preserve}: {e}"[:2000], flush=True)
            del graph, params, state
            torch.cuda.synchronize()
    finally:
        M.checkpoint = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
