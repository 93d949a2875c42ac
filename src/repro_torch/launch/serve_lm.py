"""LM serving launcher: batched prefill, then decode with a KV cache (the port
of ``repro/launch/serve_lm.py``).

On the card, at full width and depth (random weights from ``--seed``)::

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-0.6b \\
      --batch 8 --prompt-len 512 --gen 32

On the CPU, at the reduced config::

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-0.6b \\
      --reduced --device cpu

It prints the JAX launcher's JSON fields, and ``captured``.  ``--device``
defaults to ``cuda`` and raises without a card; ``--reduced`` is off by
default.  On the card every decode step is one replay of a CUDA graph
(:class:`DecodeGraph`, the counterpart of the reference's
``jax.jit(decode_step)``); ``--eager`` runs the step op by op instead, to
compare the two.  The prefill is eager either way: it runs once.  An
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
from repro_torch.core.program import GraphStats, add_launches, launch_counts
from repro_torch.models import model as M
from repro_torch.models.attention import KVCache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


stats = GraphStats()  # every DecodeGraph of the process


class DecodeGraph:
    """``M.decode_step`` of one batch over its caches as a CUDA graph, one
    replay a step: the counterpart of the reference's ``jax.jit(decode_step)``
    with a traced position.

    It keeps static inputs (``inputs``: tokens ``[B, 1]`` or embeddings
    ``[B, 1, d]``) and the position as a 0-d int32 tensor on the device
    (``position``), which the step reads there (``M.forward``) and then moves
    on by one, inside the graph; ``pos`` is the host's copy.  The caches are
    updated in place by each replay.  Before the capture one step runs on a
    side stream over clones of the position and of every recurrent cache (the
    Mamba-2 conv tail and SSD state, the RWKV-6 shift rows and wkv state), so
    the live state does not move; its one KV row per layer, at ``pos``, is
    written again by the first replay before anything reads it.  The capture
    runs under sync-debug ``"error"`` into a private pool; a capture that
    fails raises naming the model and position, and nothing falls back to the
    eager step.

    ``captured_launches`` holds the captured step's kernel launches (K4, K5,
    K6, by form), taken from the wrappers' counts around the capture; each
    replay adds them to ``replay_launches`` and to the module's ``stats``,
    and leaves the wrappers' counts alone (no wrapper runs).  :meth:`step`
    raises ``ValueError`` before a step that would write past a KV cache's
    rows, as ``attn_apply`` does for an ``int`` position.
    ``logits`` is a static output: a caller that keeps a step's logits clones
    them before the next step.

    With ``capture=False`` the same step runs op by op (the eager twin, on
    any device, the CPU's included), its logits copied into a static buffer
    as the graph's are.  Drop the object with the caches: the graph and its
    pool go with it."""

    def __init__(self, cfg, params, caches: list, inputs: torch.Tensor, position: int, *,
                 capture: bool = True):
        if capture and inputs.device.type != "cuda":
            raise ValueError(f"DecodeGraph: capture needs a CUDA device, inputs are on "
                             f"{inputs.device}")
        self.cfg, self.params, self.caches = cfg, params, caches
        self.inputs = inputs.clone()
        self.pos = int(position)
        self.position = torch.tensor(self.pos, dtype=torch.int32, device=inputs.device)
        self.rows = min((c.k.shape[1] for c in caches if isinstance(c, KVCache)),
                        default=None)
        self.graph = None
        self.logits = None
        self.captured_launches: dict = {}  # one replay's launches, by wrapper and form
        self.replays = 0
        self.replay_launches: dict = {}
        self._check()
        if capture:
            self._capture()

    def _run(self, caches: list, position: torch.Tensor) -> torch.Tensor:
        logits, _ = M.decode_step(self.params, self.cfg, self.inputs, caches, position)
        position += 1
        return logits

    def _check(self) -> None:
        s = self.inputs.shape[1]
        if self.rows is not None and self.pos + s > self.rows:
            raise ValueError(f"KV cache of {self.rows} rows: cannot write {s} rows at "
                             f"cache_len {self.pos}")

    def warm_up(self) -> None:
        """One step over clones of the position and the recurrent caches."""
        clones = [c if isinstance(c, KVCache) else type(c)(*(t.clone() for t in c))
                  for c in self.caches]
        self._run(clones, self.position.clone())

    def _capture(self) -> None:
        dev = self.inputs.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.warm_up()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        debug = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                                  capture_error_mode="thread_local"):
                # a host sync inside the step raises here rather than
                # breaking the capture
                torch.cuda.set_sync_debug_mode("error")
                try:
                    logits = self._run(self.caches, self.position)
                finally:
                    torch.cuda.set_sync_debug_mode(debug)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.cfg.name}'s decode step at "
                               f"position {self.pos} failed: {e}") from e
        after = launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}
        self.graph, self.logits = graph, logits
        stats.captured(self.captured_launches)

    def step(self, inputs: torch.Tensor) -> torch.Tensor:
        """One decode step on ``inputs`` at ``pos``: the logits ``[B, V]``
        (the static output; clone to keep them)."""
        self._check()
        self.inputs.copy_(inputs)
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            add_launches(self.replay_launches, self.captured_launches)
            stats.replayed(self.captured_launches)
        else:
            logits = self._run(self.caches, self.position)
            if self.logits is None:
                self.logits = torch.empty_like(logits)
            self.logits.copy_(logits)
        self.pos += 1
        return self.logits

    def seek(self, pos: int) -> None:
        """Put the next step at position ``pos`` (the caches are the
        caller's to match)."""
        self.pos = int(pos)
        self.position.fill_(self.pos)


def _resolve_capture(capture: bool | None, device: torch.device) -> bool:
    """``capture`` resolved on ``device``: None captures on the card and
    runs the eager step on the CPU; True on the CPU raises."""
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, not {device}")
    return bool(capture)


def _decode_graph(cfg, params, caches, inputs, position, capture):
    """The captured step :func:`generate` and :func:`serve_embeddings`
    replay, or None for the eager step."""
    if not _resolve_capture(capture, inputs.device):
        return None
    return DecodeGraph(cfg, params, caches, inputs, position)


def generate(cfg, params, prompts: torch.Tensor, max_len: int, gen: int, *,
             greedy: bool = True, seed: int = 0, return_logits: bool = False,
             capture: bool | None = None):
    """Prefill ``prompts [B, P]`` into caches of ``max_len`` rows, then take
    ``gen`` decode steps: ``(tokens [B, gen], decode seconds)``, and with
    ``return_logits`` also the f32 logits ``[B, gen + 1, V]`` that chose
    each token (the prefill's first, then each step's; the last step's
    logits choose no token).  Greedy picks the argmax; otherwise tokens are
    sampled from the softmax with a ``torch.Generator`` seeded by ``seed``.
    The decode time starts after the prefill has finished on the device,
    and after the step's capture.  ``capture`` (None: on the card, not on
    the CPU) runs every step as one replay of a :class:`DecodeGraph`;
    False runs ``M.decode_step`` op by op at a host position; True on the
    CPU raises ``ValueError``.  Token choice stays outside the graph, as
    the reference samples outside its jit.  ``max_len`` must hold the
    prompt and every step's token (``P + gen``): a smaller cache raises
    ``ValueError`` before anything is allocated, and so does a config whose
    inputs are embeddings (:func:`serve_embeddings` serves those)."""
    if not cfg.embed_inputs:
        raise ValueError(f"{cfg.name} takes embeddings, not tokens: generate feeds its "
                         "argmax tokens back; serve it with serve_embeddings")
    b, plen = prompts.shape
    if max_len < plen + gen:
        raise ValueError(f"max_len {max_len} < prompt {plen} + gen {gen}: the caches "
                         "cannot hold every step")
    dev = prompts.device
    _resolve_capture(capture, dev)
    caches = M.make_caches(cfg, b, max_len, dev)
    logits, caches = M.prefill(params, cfg, prompts, caches)
    steps = [logits]
    rng = torch.Generator(device=dev).manual_seed(seed)
    tok = logits.argmax(-1)[:, None]
    graph = _decode_graph(cfg, params, caches, tok, plen, capture) if gen else None
    out = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        if graph is not None:
            logits = graph.step(tok)
        else:
            logits, caches = M.decode_step(params, cfg, tok, caches, plen + i)
        if return_logits:
            steps.append(logits.clone() if graph is not None else logits)
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
                     max_len: int, *, capture: bool | None = None):
    """Prefill ``prompt [B, P, d]`` into caches of ``max_len`` rows, then
    one decode step on each ``steps[:, i:i + 1]`` of ``steps [B, n, d]``:
    ``(f32 logits [B, n + 1, V], decode seconds)``, the prefill's last
    position's first.  For configs fed by a frontend's embeddings; the
    decode time starts after the prefill has finished on the device and
    after the step's capture (``capture`` as :func:`generate`'s)."""
    b, plen, _ = prompt.shape
    n = steps.shape[1]
    if max_len < plen + n:
        raise ValueError(f"max_len {max_len} < prompt {plen} + steps {n}: the caches "
                         "cannot hold every step")
    dev = prompt.device
    _resolve_capture(capture, dev)
    caches = M.make_caches(cfg, b, max_len, dev)
    logits, caches = M.prefill(params, cfg, prompt, caches)
    out = [logits]
    graph = _decode_graph(cfg, params, caches, steps[:, :1], plen, capture) if n else None
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n):
        if graph is not None:
            out.append(graph.step(steps[:, i:i + 1]).clone())
        else:
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
    ap.add_argument("--eager", action="store_true",
                    help="run each decode step op by op, not as a CUDA-graph replay")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    capture = False if args.eager else None
    captured = _resolve_capture(capture, dev)
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
                                      args.prompt_len + args.gen + 1, capture=capture)
        print(json.dumps({
            "arch": cfg.name,
            "captured": captured,
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
                        args.gen, seed=args.seed, capture=capture)
    print(json.dumps({
        "arch": cfg.name,
        "captured": captured,
        "generated_shape": list(toks.shape),
        "decode_steps": args.gen,
        "decode_s": dt,
        "tok_per_s": args.batch * args.gen / dt,
        "sample": toks[0, :16].tolist(),
    }, indent=1))


if __name__ == "__main__":
    main()
