"""LM serving launcher: batched prefill, then decode with a KV cache (the port
of ``repro/launch/serve_lm.py``).

On the card, at full width and depth (random weights from ``--seed``)::

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-0.6b \\
      --batch 8 --prompt-len 512 --gen 32

On the CPU, at the reduced config::

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-0.6b \\
      --reduced --device cpu

It prints the JAX launcher's JSON fields.  ``--device`` defaults to
``cuda`` and raises without a card; ``--reduced`` is off by default.  An
architecture fed by a frontend's embeddings (``embed_inputs=False``:
qwen2-vl-2b, musicgen-medium) has no tokens to feed back, so it is served
by :func:`serve_embeddings` on random embeddings from ``--seed``: a prompt
of ``[B, P, d]``, then one ``[B, 1, d]`` a step.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.containers import resolve_device
from repro_torch.models import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts: torch.Tensor, max_len: int, gen: int, *,
             greedy: bool = True, seed: int = 0, return_logits: bool = False):
    """Prefill ``prompts [B, P]`` into caches of ``max_len`` rows, then take
    ``gen`` decode steps: ``(tokens [B, gen], decode seconds)``, and with
    ``return_logits`` also the f32 logits ``[B, gen + 1, V]`` that chose
    each token (the prefill's first, then each step's; the last step's
    logits choose no token).  Greedy picks the argmax; otherwise tokens are
    sampled from the softmax with a ``torch.Generator`` seeded by ``seed``.
    The decode time starts after the prefill has finished on the device.
    ``max_len`` must hold the prompt and every step's token (``P + gen``):
    a smaller cache raises ``ValueError`` before anything is allocated, and
    so does a config whose inputs are embeddings (:func:`serve_embeddings`
    serves those)."""
    if not cfg.embed_inputs:
        raise ValueError(f"{cfg.name} takes embeddings, not tokens: generate feeds its "
                         "argmax tokens back; serve it with serve_embeddings")
    b, plen = prompts.shape
    if max_len < plen + gen:
        raise ValueError(f"max_len {max_len} < prompt {plen} + gen {gen}: the caches "
                         "cannot hold every step")
    dev = prompts.device
    caches = M.make_caches(cfg, b, max_len, dev)
    logits, caches = M.prefill(params, cfg, prompts, caches)
    steps = [logits]
    rng = torch.Generator(device=dev).manual_seed(seed)
    tok = logits.argmax(-1)[:, None]
    out = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        logits, caches = M.decode_step(params, cfg, tok, caches, plen + i)
        if return_logits:
            steps.append(logits)
        if greedy:
            tok = logits.argmax(-1)[:, None]
        else:
            tok = torch.multinomial(torch.softmax(logits, -1), 1, generator=rng)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = torch.cat(out, dim=1)
    if return_logits:
        return toks, dt, torch.stack(steps, dim=1)
    return toks, dt


def serve_embeddings(cfg, params, prompt: torch.Tensor, steps: torch.Tensor,
                     max_len: int):
    """Prefill ``prompt [B, P, d]`` into caches of ``max_len`` rows, then
    one decode step on each ``steps[:, i:i + 1]`` of ``steps [B, n, d]``:
    ``(f32 logits [B, n + 1, V], decode seconds)``, the prefill's last
    position's first.  For configs fed by a frontend's embeddings; the
    decode time starts after the prefill has finished on the device."""
    b, plen, _ = prompt.shape
    n = steps.shape[1]
    if max_len < plen + n:
        raise ValueError(f"max_len {max_len} < prompt {plen} + steps {n}: the caches "
                         "cannot hold every step")
    dev = prompt.device
    caches = M.make_caches(cfg, b, max_len, dev)
    logits, caches = M.prefill(params, cfg, prompt, caches)
    out = [logits]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n):
        logits, caches = M.decode_step(params, cfg, steps[:, i:i + 1], caches, plen + i)
        out.append(logits)
    _sync(dev)
    return torch.stack(out, dim=1), time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced same-family config (default: full width and depth)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init(rng, cfg)
    if not cfg.embed_inputs:
        shape = (args.batch, args.prompt_len + args.gen, cfg.d_model)
        embeds = torch.randn(shape, generator=rng, device=dev).to(cfg.cdtype)
        logits, dt = serve_embeddings(cfg, params, embeds[:, :args.prompt_len],
                                      embeds[:, args.prompt_len:],
                                      args.prompt_len + args.gen + 1)
        print(json.dumps({
            "arch": cfg.name,
            "logits_shape": list(logits.shape),
            "decode_steps": args.gen,
            "decode_s": dt,
            "tok_per_s": args.batch * args.gen / dt,
            "sample": logits[0, :16].argmax(-1).tolist(),
        }, indent=1))
        return
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=rng, device=dev)
    toks, dt = generate(cfg, params, prompts, args.prompt_len + args.gen + 1,
                        args.gen, seed=args.seed)
    print(json.dumps({
        "arch": cfg.name,
        "generated_shape": list(toks.shape),
        "decode_steps": args.gen,
        "decode_s": dt,
        "tok_per_s": args.batch * args.gen / dt,
        "sample": toks[0, :16].tolist(),
    }, indent=1))


if __name__ == "__main__":
    main()
