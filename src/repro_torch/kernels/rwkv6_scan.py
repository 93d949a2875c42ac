"""RWKV-6 wkv scan: the chunked recurrence of rwkv6's time-mix blocks.

The counterpart of the TPU kernel ``repro/kernels/rwkv6_scan.py::
rwkv6_scan``.  On a CUDA tensor :func:`rwkv6_scan` launches the hand-written
kernel in ``csrc/rwkv6_scan.cu`` (the source says how it is built and why);
on CPU tensors it runs :func:`rwkv6_scan_plain`, the port of the reference's
``ops.rwkv6_chunked``: the same decomposition in plain PyTorch.

On the card the kernel has two forms, chosen by :func:`form` from ``S``:
``"decode"`` (one step: the state read and written once, in place, on the
CUDA cores) and ``"prefill"`` (chunks on the tensor cores, each f32 operand
split into bf16 parts; ``tests/test_torch_rwkv6.py`` emulates that
arithmetic in plain PyTorch).

The decay floor is part of the function: ``log w`` is clamped at ``−88 / L``
with ``L = min(chunk, S)``, as the reference clamps it, so a prefill (L =
64) and a decode step (L = 1) floor differently.  The wrapper computes the
floor and passes it to the kernel.  Unlike the TPU kernel, this one reads an
optional ``init_state`` and writes the final state into ``out_state``, which
may be the same tensor: a serving cache is updated in place.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_DIM = 64  # the kernel's largest K and V
DTYPES = (torch.float32, torch.bfloat16)
FORMS = ("decode", "prefill")  # the kernel's forms, in the C entry's numbering


def form(s: int) -> str:
    """The kernel form a call of ``S = s`` steps takes."""
    return "decode" if s == 1 else "prefill"


def decay_floor(chunk: int, s: int) -> float:
    """The floor of ``log w``: ``−88 / min(chunk, S)`` (``ops.rwkv6_chunked``)."""
    return -88.0 / min(chunk, s)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, *, init_state: torch.Tensor | None = None,
                     out_state: torch.Tensor | None = None, chunk: int = 64
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 wkv in chunked form, in f32 (``ops.rwkv6_chunked``).  Per chunk,
    with ``λ`` the running sum of the floored ``log w``::

        out_t = r_t·(Λ_t ∘ S_prev) + Σ_{s<t} (r_t ∘ Λ_t/Λ_{s+1})·k_s v_s
                + (r_t ∘ u)·k_t v_t

    Padded steps take ``w = 1``.  Returns ``(out`` in ``v``'s dtype``, S_T``
    f32``)``; with ``out_state`` the final state is copied there and
    returned.
    """
    bsz, s, h, kd = r.shape
    vd = v.shape[-1]
    L = min(chunk, s)
    nch = -(-s // L)
    pad = nch * L - s
    f32 = torch.float32

    def chunks(t, value=0.0):  # [B, S, H, D] -> [nch, B, L, H, D] in f32
        t = torch.nn.functional.pad(t.to(f32), (0, 0, 0, 0, 0, pad), value=value)
        return t.reshape((bsz, nch, L) + t.shape[2:]).transpose(0, 1)

    rs, ks, vs, ws = chunks(r), chunks(k), chunks(v), chunks(w, 1.0)
    state = (torch.zeros((bsz, h, kd, vd), dtype=f32, device=r.device)
             if init_state is None else init_state.to(f32))
    uf = u.to(f32)
    floor = decay_floor(chunk, s)
    strict = torch.tril(torch.ones((L, L), dtype=f32, device=r.device), diagonal=-1)
    outs = []
    for rc, kc, vc, wc in zip(rs, ks, vs, ws):
        # Floored at e^(−88/L): a chunk's decay then stays inside f32's range,
        # so the factored exp(±λ) below is finite.
        logw = torch.clamp_min(torch.log(torch.clamp_min(wc, 1e-30)), floor)
        lam = torch.cumsum(logw, dim=1)  # λ_t
        r_dec = rc * torch.exp(lam - logw)  # r_t ∘ e^{λ_{t-1}}
        out = torch.einsum("blhk,bhkv->blhv", r_dec, state)
        scores = torch.einsum("blhk,bshk->bhls", r_dec, kc * torch.exp(-lam))
        out = out + torch.einsum("bhls,bshv->blhv", scores * strict, vc)
        diag = torch.einsum("blhk,blhk->blh", rc * uf[None, None], kc)
        out = out + diag[..., None] * vc
        lam_tot = lam[:, -1]  # [B, H, K]
        state = state * torch.exp(lam_tot)[..., None] + torch.einsum(
            "blhk,blhv->bhkv", kc * torch.exp(lam_tot[:, None] - lam), vc)
        outs.append(out)
    out = torch.stack(outs, 1).reshape(bsz, nch * L, h, vd)[:, :s]
    if out_state is not None:
        state = out_state.copy_(state)
    return out.to(v.dtype), state


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, *, init_state: torch.Tensor | None = None,
               out_state: torch.Tensor | None = None, chunk: int = 64
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, S, H, V], S_T [B, H, K, V] f32)`` of the wkv recurrence over
    ``r, k [B, S, H, K]``, ``v [B, S, H, V]`` (all f32 or all bf16; ``out``
    in ``v``'s dtype), ``w [B, S, H, K]`` f32 and ``u [H, K]`` f32.

    ``init_state [B, H, K, V]`` f32 is the state before step 0 (zeros when
    None).  With ``out_state`` (contiguous f32, possibly ``init_state``
    itself) the final state is written there and returned.  ``chunk`` sets
    the decay floor, ``−88 / min(chunk, S)``, and the chunk length; the
    kernel's chunks are ``min(64, chunk, S)`` steps, never longer than the
    floor's ``L``, so its factored ``exp(±λ)`` stays finite.
    """
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape or v.dim() != 4:
        raise ValueError(f"need r, k, w [B, S, H, K] and v [B, S, H, V], got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(w.shape)}, "
                         f"{tuple(v.shape)}")
    bsz, s, h, kd = r.shape
    vd = v.shape[-1]
    if tuple(v.shape[:3]) != (bsz, s, h) or tuple(u.shape) != (h, kd):
        raise ValueError(f"r {tuple(r.shape)}, v {tuple(v.shape)}, u {tuple(u.shape)}: "
                         "need matching B, S, H and u [H, K]")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    state_shape = (bsz, h, kd, vd)
    for name, st in (("init_state", init_state), ("out_state", out_state)):
        if st is not None and tuple(st.shape) != state_shape:
            raise ValueError(f"{name} {tuple(st.shape)}: need {state_shape}")
    tensors = [t for t in (r, k, v, w, u, init_state, out_state) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv6_scan_plain(r, k, v, w, u, init_state=init_state, out_state=out_state,
                                chunk=chunk)
    if not all(t.device == r.device for t in tensors) or r.device.type != "cuda":
        raise ValueError("rwkv6_scan: need every tensor on one CUDA device (or all on "
                         "the CPU)")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"need r, k, v all f32 or all bf16, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"need w and u in f32, got {w.dtype}, {u.dtype}")
    if not (0 < kd <= MAX_DIM and 0 < vd <= MAX_DIM):
        raise ValueError(f"K = {kd}, V = {vd}: the kernel takes 1 to {MAX_DIM}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    for name, st in (("init_state", init_state), ("out_state", out_state)):
        if st is not None and (st.dtype != torch.float32 or not st.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous f32 tensor")
    out = torch.empty((bsz, s, h, vd), dtype=v.dtype, device=r.device)
    state = out_state if out_state is not None else torch.empty(
        state_shape, dtype=torch.float32, device=r.device)
    if bsz * h == 0:
        return out, state
    if s == 0:  # no step: the state is the initial one
        return out, state.copy_(init_state) if init_state is not None else state.zero_()
    u = u.contiguous()
    kind = form(s)
    if kind == "decode":  # 16-byte loads and stores of the state
        vec = vd % 4 == 0 and all(st.data_ptr() % 16 == 0 for st in (init_state, state)
                                  if st is not None)
    else:  # 16-byte copies of r, k, v rows
        elt = r.element_size()
        vec = kd * elt % 16 == 0 and vd * elt % 16 == 0 and all(
            t.data_ptr() % 16 == 0 and all(st * elt % 16 == 0 for st in t.stride()[:3])
            for t in (r, k, v))
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            out.data_ptr(), state.data_ptr(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
            *out.stride()[:3], bsz, s, h, kd, vd, min(64, chunk, s),
            decay_floor(chunk, s), int(v.dtype == torch.bfloat16), FORMS.index(kind),
            int(vec))
    dev = r.device.index
    if dev == torch.cuda.current_device():  # the launch goes to the current device
        err = _kernel()(*args, _build.raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args, _build.raw_stream(dev))
    _build.check(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    rwkv6_scan.forms[kind] += 1
    return out, state


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The C entry point, built, loaded and typed once per process."""
    ll, i32, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    return _build.entry("rwkv6_scan", "blaze_rwkv6_scan", [
        vp, vp, vp, vp, vp, vp, vp, vp, *[ll] * 15, *[i32] * 6, ctypes.c_float,
        *[i32] * 3, vp,
    ])


rwkv6_scan.launches = 0  # kernel launches since the caller last reset it
rwkv6_scan.forms = dict.fromkeys(FORMS, 0)  # the same, by form
