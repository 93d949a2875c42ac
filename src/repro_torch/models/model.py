"""Model assembly: blocks → layers → LM (the port of ``repro/models/
model.py``: dense and sliding-window attention, MoE, Mamba-2 and RWKV-6).

The JAX package stacks each stage's parameters and scans over them; the
port keeps one parameter dict and one cache per layer and runs a Python
loop, in the same layer order (stage by stage, slot by slot, then the tail).
zamba2's shared attention block is one dict, ``params["shared_attn"]``,
that every ``SHARED_ATTN`` position of ``params["layers"]`` refers to; each
application keeps its own KV cache, as the reference's per-slot caches do.

Public entry points:
  init(gen, cfg)                                → params
  forward(params, cfg, tokens|embeds, ...)      → (hidden [B, S, d], caches, aux)
  logits_fn(params, cfg, hidden)                → f32 logits
  loss_fn(params, cfg, inputs, labels, ...)     → mean cross-entropy, chunked over S
  prefill(...) / decode_step(...)               → the serving path with caches
  make_caches(cfg, batch, max_len, device)      → one cache per layer
  param_count(params), active_param_count(params, cfg),
  distinct_leaves(tree), map_tree(fn, tree), reference_leaves(params, cfg)
The MoE blocks call ``MOE.moe_apply`` through the module, so a caller may
wrap it (to record routes).

Sharded: given parameters and inputs as ``DTensor``s on a ``DeviceMesh``
(``distributed/sharding.py``), the same functions run sharded, with the
reference's constraints (``sharding.constrain``, a no-op on plain tensors):
the residual stream sequence-parallel over (dp, model) between blocks, norm
outputs likewise, the embedding's vocab-parallel gather resharded at once,
the head's logits vocab-parallel (the log-sum-exp reduced over model).
Plain tensors (positions, masks) mix in as replicated ones
(``sharding.mixing``); the kernels, the MoE dispatch and the cache writes
run on each rank's shards.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.distributed.tensor import DTensor, Partial
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    ATTN_LOCAL_MOE,
    ATTN_MOE,
    MAMBA2,
    RWKV6,
    SHARED_ATTN,
    ArchConfig,
)
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import embed_init, dense_init, mlp, mlp_init, rmsnorm, rmsnorm_init

_MOE_KINDS = (ATTN_MOE, ATTN_LOCAL_MOE)
_ATTN_KINDS = (ATTN, ATTN_LOCAL, SHARED_ATTN) + _MOE_KINDS


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    """Model-visible parallel info: the MoE dispatch grouping."""

    dispatch_groups: int = 1


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Every layer's block kind, in order; raises for an unknown kind."""
    kinds = list(cfg.stage_pattern) * cfg.n_stages + list(cfg.tail_pattern)
    for kind in kinds:
        if kind not in _ATTN_KINDS + (MAMBA2, RWKV6):
            raise ValueError(f"unknown block kind {kind!r}")
    return kinds


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    def ln():
        return rmsnorm_init(cfg.d_model, cfg.pdtype, gen.device)

    if kind in _MOE_KINDS:
        return {"ln1": ln(), "attn": A.attn_init(gen, cfg), "ln2": ln(),
                "moe": MOE.moe_init(gen, cfg)}
    if kind in _ATTN_KINDS:
        return {"ln1": ln(), "attn": A.attn_init(gen, cfg), "ln2": ln(),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype)}
    if kind == MAMBA2:
        return {"ln1": ln(), "mamba": SSM.mamba_init(gen, cfg)}
    if kind == RWKV6:
        return {"ln1": ln(), "ln2": ln(), "rwkv": RW.rwkv_init(gen, cfg)}
    raise ValueError(kind)


def block_apply(params: dict, cfg: ArchConfig, kind: str, h: torch.Tensor,
                positions: torch.Tensor, *, cache=None,
                cache_len: int | torch.Tensor | None = None,
                par: ParallelCfg = ParallelCfg(), attn_impl: str = "auto",
                scan_impl: str = "auto"):
    """Pre-norm residual block; returns ``(h, cache, aux)``, the cache (if
    any) updated in place, ``aux`` the MoE balance loss (the float 0.0
    for the other kinds, so a dense step launches nothing for it).
    Attention kinds: attention (``attn_impl``; the ``*_local`` kinds over
    the window), then the SwiGLU MLP or, for the MoE kinds, the expert
    layer (``par.dispatch_groups``); Mamba-2: the SSM mixer; RWKV-6:
    time-mix, then channel-mix (``scan_impl`` for both recurrences)."""
    def norm_sp(ln, x):
        # the norm's f32 internals stay sequence-sharded; the gather the
        # block's products need then moves the compute dtype
        return SH.relayout(constrain(rmsnorm(ln, x), SH.DP, SH.MODEL, None),
                           SH.DP, None, None)

    def out_sp(x):
        # back to sequence-sharded before the residual add: a row-parallel
        # product's partial sum then reduce-scatters
        return constrain(x, SH.DP, SH.MODEL, None)

    aux = 0.0
    if kind in _ATTN_KINDS:
        a_out, new_kv = A.attn_apply(
            params["attn"], cfg, norm_sp(params["ln1"], h), positions,
            local=kind in (ATTN_LOCAL, ATTN_LOCAL_MOE), cache=cache,
            cache_len=cache_len, attn_impl=attn_impl,
        )
        h = h + out_sp(a_out)
        if kind in _MOE_KINDS:
            m_out, aux = MOE.moe_apply(params["moe"], cfg, norm_sp(params["ln2"], h),
                                       dispatch_groups=par.dispatch_groups)
        else:
            m_out = mlp(params["mlp"], norm_sp(params["ln2"], h))
        return h + out_sp(m_out), new_kv, aux
    if kind == MAMBA2:
        m_out, cache = SSM.mamba_apply(params["mamba"], cfg, norm_sp(params["ln1"], h),
                                       cache=cache, scan_impl=scan_impl)
        return h + out_sp(m_out), cache, aux
    if kind == RWKV6:
        tm_out, shift_tm, _ = RW.time_mix(params["rwkv"]["tm"], cfg,
                                          norm_sp(params["ln1"], h), cache,
                                          scan_impl=scan_impl)
        h = h + out_sp(tm_out)
        cm_out, shift_cm = RW.channel_mix(params["rwkv"]["cm"], cfg,
                                          norm_sp(params["ln2"], h), cache)
        if cache is not None:  # after channel-mix has read the old row
            SH.write_into(cache.shift_tm, shift_tm)
            SH.write_into(cache.shift_cm, shift_cm)
        return h + out_sp(cm_out), cache, aux
    raise ValueError(kind)


def make_caches(cfg: ArchConfig, batch: int, max_len: int, device) -> list:
    """One cache per layer, in layer order: a ``KVCache`` of ``max_len``
    rows for each attention application, a ``MambaCache`` or ``RWKVCache``
    for each recurrent layer (their size does not depend on ``max_len``)."""
    def one(kind):
        if kind in _ATTN_KINDS:
            return A.make_cache(cfg, batch, max_len, device)
        if kind == MAMBA2:
            return SSM.make_mamba_cache(cfg, batch, device)
        return RW.make_rwkv_cache(cfg, batch, device)

    return [one(kind) for kind in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# Model init / forward
# ---------------------------------------------------------------------------


def init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters drawn from ``gen``, on ``gen``'s device.  Every
    ``SHARED_ATTN`` layer is the one dict ``params["shared_attn"]``."""
    kinds = layer_kinds(cfg)
    params: dict = {}
    if SHARED_ATTN in kinds:
        params["shared_attn"] = block_init(gen, cfg, SHARED_ATTN)
    params["layers"] = [params["shared_attn"] if kind == SHARED_ATTN
                        else block_init(gen, cfg, kind) for kind in kinds]
    params["embed"] = embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype)
    params["final_norm"] = rmsnorm_init(cfg.d_model, cfg.pdtype, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg.pdtype)
    return params


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat_policy="dots"``: keep
    the outputs of matrix products without batch dimensions (``aten.mm``:
    every ``x @ W``), recompute the rest, as JAX's
    ``dots_with_no_batch_dims_saveable``.  A batched product (``aten.bmm``:
    the attention's ``[B, H, S, S]`` scores in the plain version) has batch
    dimensions, so JAX's policy does not keep it and neither does this."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(params: dict, cfg: ArchConfig, inputs: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            caches: list | None = None, cache_len: int | torch.Tensor | None = None,
            par: ParallelCfg = ParallelCfg(), attn_impl: str = "auto",
            scan_impl: str = "auto", remat: bool = False,
            remat_policy: str = "full", scan_layers: bool = True):
    """``(hidden [B, S, d], caches, aux)`` of tokens ``[B, S]`` (or embeds
    ``[B, S, d]`` where the config does not embed).  With ``caches``, the
    inputs continue a sequence of ``cache_len`` tokens already cached, and
    every cache is updated in place.  ``positions`` default to ``cache_len +
    arange(S)`` for every row (an M-RoPE config: the same in all three
    coordinates, ``[3, B, S]``).  ``cache_len`` is an ``int`` or a 0-d
    integer tensor on the inputs' device, which nothing reads on the host
    (``attention.attn_apply``; a captured decode step's position); a tensor
    with ``DTensor`` inputs raises ``ValueError``.  ``attn_impl`` goes to the attention
    kernels (``ops.attention``), ``scan_impl`` to the recurrences
    (``ops.ssd``, ``ops.rwkv6``), ``par.dispatch_groups`` to the MoE
    blocks.  ``aux`` is the sum of every MoE block's balance loss (0
    without MoE blocks).

    Training options, as the reference's: ``remat=True`` checkpoints each
    stage (the ``len(cfg.stage_pattern)`` layers the reference's scan step
    runs; the tail is not checkpointed) with
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so a
    backward recomputes the stage from its input; ``remat_policy="dots"``
    keeps the products' outputs (:func:`_save_dots`), ``"full"`` keeps
    nothing.  ``scan_layers`` is accepted for the reference's signature:
    the port always loops over its layers, so both values run the same
    code."""
    del scan_layers
    if remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be 'full' or 'dots', got {remat_policy!r}")
    with SH.mixing(inputs):
        if cfg.embed_inputs:
            if isinstance(params["embed"], DTensor):
                h = _sharded_embed(params["embed"], inputs).to(cfg.cdtype)
            else:
                h = params["embed"][inputs].to(cfg.cdtype)
        elif inputs.dim() != 3:
            raise ValueError(f"{cfg.name} takes embeddings [B, S, d], not inputs of shape "
                             f"{tuple(inputs.shape)}")
        else:
            h = inputs.to(cfg.cdtype)
        # the sequence-parallel residual stream: each stage's saved
        # activation (the remat boundary) is sharded over (dp, model)
        h = constrain(h, SH.DP, SH.MODEL, None)
        b, s = h.shape[0], h.shape[1]
        on_device = isinstance(cache_len, torch.Tensor)
        if on_device and isinstance(h, DTensor):
            raise ValueError("forward: a tensor cache_len needs plain tensors; the "
                             "sharded route takes an int")
        if positions is None:
            start = cache_len if on_device else 0 if cache_len is None else int(cache_len)
            positions = (torch.arange(s, device=h.device) + start).expand(b, s)
            if cfg.mrope_sections is not None:
                positions = positions.expand(3, b, s)
        kinds = layer_kinds(cfg)

        def run_layers(h, aux, lo, hi):
            with SH.mixing(h):  # also where a backward recomputes the stage
                for i in range(lo, hi):
                    h, _, a = block_apply(params["layers"][i], cfg, kinds[i], h, positions,
                                          cache=None if caches is None else caches[i],
                                          cache_len=cache_len, par=par,
                                          attn_impl=attn_impl, scan_impl=scan_impl)
                    h = constrain(h, SH.DP, SH.MODEL, None)
                    aux = aux + a
            return h, aux

        n_slots = len(cfg.stage_pattern)
        staged = cfg.n_stages * n_slots
        aux = 0.0
        if remat and torch.is_grad_enabled():
            context = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                       if remat_policy == "dots" else None)
            for lo in range(0, staged, n_slots):
                h, aux = checkpoint(run_layers, h, aux, lo, lo + n_slots,
                                    use_reentrant=False,
                                    **({"context_fn": context} if context else {}))
        else:
            h, aux = run_layers(h, aux, 0, staged)
        h, aux = run_layers(h, aux, staged, len(kinds))
        h = rmsnorm(params["final_norm"], h)
        if not isinstance(aux, torch.Tensor):
            aux = torch.zeros((), device=h.device)
    return h, caches, aux


def _sharded_embed(embed: DTensor, tokens: DTensor) -> DTensor:
    """``embed[tokens]`` vocab-parallel: each rank gathers the rows of its
    vocab shard (zeros for tokens outside it), a partial sum over model that
    the caller reshards to (dp, sequence on model) at once."""
    embed = SH.relayout(embed, SH.MODEL, None)
    tokens = SH.relayout(tokens, SH.DP, None)
    split = SH.is_sharded(embed, 0)
    first = SH.shard_offset(embed, 0)
    model = SH.axis_index(embed.device_mesh, SH.MODEL)
    out = tuple(p if i != model or not split else Partial()
                for i, p in enumerate(SH.fitted_placements(
                    embed.device_mesh, (*tokens.shape, embed.shape[1]), (SH.DP, None, None))))

    def local(table, ids):
        if not split:
            return table[ids]
        ids = ids - first
        inside = (ids >= 0) & (ids < table.shape[0])
        return table[ids.clamp(0, table.shape[0] - 1)] * inside[..., None].to(table.dtype)

    return SH.run_local(local, out, (embed, tokens), (embed.placements, tokens.placements))


def _head_matrix(params: dict, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]  # [d, V]


def _narrow_on_card(h2: torch.Tensor, head: torch.Tensor) -> bool:
    return h2.device.type == "cuda" and h2.dtype == head.dtype != torch.float32


class _HeadProduct(torch.autograd.Function):
    """``h2 [N, d] · head [d, V]`` in f32 from bf16 operands on the card, with
    its gradient: the f32 gradient of the logits is rounded to the operands'
    dtype for the two backward products (f32 sums), as mixed-precision
    training does; the reference's f32 upcast would make all three
    products f32 ones, ~15 times slower on the card."""

    @staticmethod
    def forward(ctx, h2, head):
        ctx.save_for_backward(h2, head)
        return torch.mm(h2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h2, head = ctx.saved_tensors
        g = g.to(h2.dtype)
        grad_h = torch.mm(g, head.T, out_dtype=torch.float32).to(h2.dtype)
        grad_head = torch.mm(h2.T, g, out_dtype=torch.float32).to(head.dtype)
        return grad_h, grad_head


def _head_product(h2: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """f32 logits ``h2 [N, d] · head [d, V]``.  The JAX model upcasts both
    operands to f32; a bf16 product is exact in f32, so on the card the port
    asks cuBLAS for an f32 result from the bf16 operands (``torch.mm`` with
    ``out_dtype``) and never writes an f32 copy of the ``[V, d]`` head.
    Sharded, the product is vocab-parallel: ``h2`` over dp, the head's
    vocab over model, each rank multiplying its shards."""
    if isinstance(h2, DTensor):
        h2 = SH.relayout(h2, SH.DP, None)
        head = SH.relayout(head, None, SH.MODEL)
        out = SH.fitted_placements(h2.device_mesh, (h2.shape[0], head.shape[1]),
                                   (SH.DP, SH.MODEL))
        return SH.run_local(_head_product, out, (h2, head), (h2.placements, head.placements))
    if not _narrow_on_card(h2, head):
        return h2.float() @ head.float()
    if torch.is_grad_enabled() and (h2.requires_grad or head.requires_grad):
        return _HeadProduct.apply(h2, head)
    return torch.mm(h2, head, out_dtype=torch.float32)


def _softcap(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.final_softcap > 0:
        return cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def logits_fn(params: dict, cfg: ArchConfig, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits ``hidden · W_head`` (:func:`_head_product`), softcapped
    where the config says."""
    logits = _head_product(hidden.reshape(-1, hidden.shape[-1]), _head_matrix(params, cfg))
    return _softcap(cfg, logits.reshape(*hidden.shape[:-1], -1))


def _chunk_nll(cfg: ArchConfig, hc: torch.Tensor, lc: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of one chunk: ``hc [B, c, d]``, labels
    ``lc [B, c]`` (``< 0`` masked)."""
    if isinstance(hc, DTensor) and SH.is_sharded(head, 1):
        return _sharded_chunk_nll(cfg, hc, lc, head)
    with SH.mixing(hc):
        logits = _softcap(cfg, _head_product(hc.reshape(-1, hc.shape[-1]), head))
        logits = logits.reshape(*lc.shape, -1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc.clamp(min=0).long()[..., None])[..., 0]
        return torch.where(lc >= 0, lse - gold, 0.0).sum()


def _sharded_chunk_nll(cfg: ArchConfig, hc: DTensor, lc: DTensor,
                       head: DTensor) -> DTensor:
    """:func:`_chunk_nll` with the vocab over model: each rank's logits
    ``[B/dp, c, V/model]`` stay local, and only ``[B, c]`` rows cross the
    wire: the row maximum (a max over model), then each rank's sum of
    exponentials and its share of the gold logit (sums over model)."""
    hc = SH.relayout(hc, SH.DP, None, None)
    lc = SH.relayout(lc, SH.DP, None)
    model = SH.axis_index(hc.device_mesh, SH.MODEL)
    first = SH.shard_offset(head, 1)
    row = tuple(lc.placements)  # [B, c]: batch over dp, whole on model

    def logits_of(h, w):
        return _softcap(cfg, _head_product(h.reshape(-1, h.shape[-1]), w)).reshape(
            *h.shape[:-1], -1)

    def row_max(h, w):
        return logits_of(h, w).amax(-1)

    with torch.no_grad():
        m = SH.run_local(row_max, tuple(Partial("max") if i == model else p
                                        for i, p in enumerate(row)),
                         (hc.detach(), head.detach()), (hc.placements, head.placements))
        m = SH.relayout(m, SH.DP, None)

    def shares(h, w, mx, lab):
        lg = logits_of(h, w)
        ids = lab.clamp(min=0).long() - first
        inside = (ids >= 0) & (ids < lg.shape[-1])
        gold = lg.gather(-1, ids.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.exp(lg - mx[..., None]).sum(-1), torch.where(inside, gold, 0.0)

    part = tuple(Partial() if i == model else p for i, p in enumerate(row))
    sumexp, gold = SH.run_local(shares, (part, part), (hc, head, m, lc),
                                (hc.placements, head.placements, m.placements,
                                 lc.placements))
    with SH.mixing(hc):
        lse = m + torch.log(sumexp)
        return torch.where(lc >= 0, lse - gold, 0.0).sum()


def loss_fn(params: dict, cfg: ArchConfig, inputs: torch.Tensor, labels: torch.Tensor,
            *, par: ParallelCfg = ParallelCfg(), aux_coef: float = 0.01,
            remat: bool = True, remat_policy: str = "full", loss_chunk: int = 512,
            scan_layers: bool = True, attn_impl: str = "auto",
            scan_impl: str = "auto") -> torch.Tensor:
    """Mean softmax cross-entropy of ``labels [B, S]`` (``< 0`` masked) under
    the model, plus ``aux_coef · aux``, as the reference's ``loss_fn``.

    The cross-entropy runs over ``loss_chunk`` positions at a time (the last
    chunk shorter where ``loss_chunk`` does not divide S, which adds nothing
    to the sums the reference's padded chunk adds), so at most ``[B, chunk,
    V]`` f32 logits are live: under grad mode each chunk is checkpointed and
    its logits recomputed in the backward.  Off the card (or in f32) the
    head is upcast to f32 once for every chunk, as the reference upcasts
    it; on the card bf16 operands give f32 logits (:func:`_head_product`).
    ``forward``'s options (``remat``, ``remat_policy``, ``scan_layers``,
    ``attn_impl``, ``scan_impl``) pass through."""
    hidden, _, aux = forward(params, cfg, inputs, par=par, remat=remat,
                             remat_policy=remat_policy, scan_layers=scan_layers,
                             attn_impl=attn_impl, scan_impl=scan_impl)
    head = _head_matrix(params, cfg)
    if not _narrow_on_card(hidden, head):
        head = head.float()
    hidden = SH.relayout(hidden, SH.DP, None, None)  # one gather, then local chunks
    head = SH.relayout(head, None, SH.MODEL)  # one FSDP gather for every chunk
    s = hidden.shape[1]
    c = min(loss_chunk, s)
    with SH.mixing(hidden):
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for lo in range(0, s, c):
            args = (cfg, hidden[:, lo:lo + c], labels[:, lo:lo + c], head)
            if torch.is_grad_enabled():
                total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
            else:
                total = total + _chunk_nll(*args)
        count = (labels >= 0).sum().clamp(min=1)
        return SH.relayout(total / count + aux_coef * aux)  # sharded: replicated


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def prefill(params: dict, cfg: ArchConfig, inputs: torch.Tensor, caches: list, *,
            par: ParallelCfg = ParallelCfg(), attn_impl: str = "auto",
            scan_impl: str = "auto"):
    """Fill the caches from a prompt (tokens ``[B, P]``, or embeds ``[B, P,
    d]`` where the config does not embed); ``(last-token logits [B, V],
    caches)``."""
    hidden, caches, _ = forward(params, cfg, inputs, caches=caches, cache_len=0,
                                par=par, attn_impl=attn_impl, scan_impl=scan_impl)
    return logits_fn(params, cfg, hidden[:, -1:])[:, 0], caches


def decode_step(params: dict, cfg: ArchConfig, inputs: torch.Tensor, caches: list,
                cache_len: int | torch.Tensor, *, par: ParallelCfg = ParallelCfg(),
                attn_impl: str = "auto", scan_impl: str = "auto"):
    """One token for every sequence: ``inputs [B, 1]`` (or embeds ``[B, 1,
    d]``) at position ``cache_len`` (an ``int``, or a 0-d integer tensor on
    the device: :func:`forward`); ``(logits [B, V], caches)``."""
    hidden, caches, _ = forward(params, cfg, inputs, caches=caches,
                                cache_len=cache_len, par=par, attn_impl=attn_impl,
                                scan_impl=scan_impl)
    return logits_fn(params, cfg, hidden[:, -1:])[:, 0], caches


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def distinct_leaves(tree) -> list[torch.Tensor]:
    """The tree's tensors in order, each once: zamba2's shared block, which
    every ``SHARED_ATTN`` layer refers to, appears once, as in JAX's pytree
    (where it is one entry).  Trees made by :func:`map_tree` from one tree
    list their tensors in the same order."""
    return list({id(x): x for x in _leaves(tree)}.values())


def map_tree(fn, tree):
    """``fn`` of every tensor of a tree of dicts, lists and tuples, keeping
    its sharing: a dict or tensor that appears at several places (zamba2's
    shared block) maps once, and its image appears at each of them."""
    memo: dict[int, object] = {}

    def go(x):
        if id(x) in memo:
            return memo[id(x)]
        if isinstance(x, torch.Tensor):
            out = fn(x)
        elif isinstance(x, dict):
            out = {k: go(v) for k, v in x.items()}
        elif isinstance(x, (list, tuple)):
            out = type(x)(go(v) for v in x)
        else:
            raise TypeError(f"map_tree: unexpected {type(x).__name__}")
        memo[id(x)] = out
        return out

    return go(tree)


def reference_leaves(params: dict, cfg: ArchConfig) -> list[list[torch.Tensor]]:
    """The tree's distinct tensors grouped as the leaves of the reference's
    pytree: the reference stacks a stage slot's parameters over its
    ``n_stages`` stages, so each tensor of a (non-shared) stage slot forms
    one group with the same tensor of that slot in every stage, in stage
    order; every other tensor (the shared block's, the tail's, the
    embedding, the norms and the head) is a group of its own.  A collective
    that narrows a leaf with one scale (``dp_train``'s int8 wire) narrows a
    group so."""
    n_slots = len(cfg.stage_pattern)
    groups, grouped = [], set()
    for j, kind in enumerate(cfg.stage_pattern):
        if kind == SHARED_ATTN:
            continue
        stages = [list(_leaves(params["layers"][st * n_slots + j]))
                  for st in range(cfg.n_stages)]
        for tensors in zip(*stages):
            groups.append(list(tensors))
            grouped.update(id(t) for t in tensors)
    return groups + [[t] for t in distinct_leaves(params) if id(t) not in grouped]


def param_count(params: dict) -> int:
    """Parameters, each tensor counted once: zamba2's shared block, which
    every ``SHARED_ATTN`` layer refers to, counts once, as in JAX's pytree."""
    return sum(x.numel() for x in distinct_leaves(params))


def active_param_count(params: dict, cfg: ArchConfig) -> int:
    """Parameters a token uses (the ``N`` of ``6·N·D``): :func:`param_count`
    with each MoE layer's expert weights counted at ``top_k / E``, as the
    reference counts them (integer division per tensor)."""
    experts = {id(layer["moe"][name]) for layer in params["layers"] if "moe" in layer
               for name in ("w_gate", "w_up", "w_down")}
    return sum(x.numel() * cfg.top_k // max(cfg.n_experts, 1) if id(x) in experts
               else x.numel() for x in distinct_leaves(params))
