"""Mamba-2 SSD scan: the chunked linear recurrence of zamba2's Mamba-2 blocks.

The counterpart of the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``.
On a CUDA tensor :func:`ssd_scan` launches the hand-written kernel in
``csrc/ssd_scan.cu`` (the source says how it is built and why); on CPU
tensors it runs :func:`ssd_scan_plain`, the port of the reference's
``ops.ssd_chunked``: the same block decomposition in plain PyTorch.

Unlike the TPU kernel, which takes no initial state (the reference's decode
path goes through ``ops.ssd_chunked`` instead), this one reads an optional
``init_state`` at the first chunk and writes the final state into
``out_state``, which may be the same tensor: a serving cache is updated in
place.  ``x``, ``b`` and ``c`` are read through their ``[batch, seq, head]``
strides, so the model's slices of its conv output go in with no copy.

On the card the kernel has two forms, chosen by :func:`form` from ``S``:
``"decode"`` (one step: the state read and written once, in place) and
``"prefill"`` (64-step chunks on the tensor cores, each f32 operand split
into bf16 parts; ``tests/test_torch_ssd.py`` emulates that arithmetic in
plain PyTorch).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_DIM = 64  # the kernel's largest head dim P and state size N
DTYPES = (torch.float32, torch.bfloat16)
FORMS = ("decode", "prefill")  # the kernel's forms, in the C entry's numbering


def form(s: int) -> str:
    """The kernel form a call of ``S = s`` steps takes."""
    return "decode" if s == 1 else "prefill"


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, init_state: torch.Tensor | None = None,
                   out_state: torch.Tensor | None = None, chunk: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD in chunked matmul form, in f32 (``ops.ssd_chunked``):

    intra-chunk ``Y₁[t] = Σ_{s≤t} exp(Δ_t − Δ_s)·(C_t·B_s)·dt_s·x_s``;
    inter-chunk ``Y₂[t] = exp(Δ_t)·C_t·h_prev``, ``h`` carried over chunks,
    with ``Δ`` the running sum of ``a·dt`` inside a chunk.  Padded steps take
    ``dt = 0``, so they leave the state as it is.  Returns ``(y`` in ``x``'s
    dtype``, h_T`` f32``)``; with ``out_state`` the final state is copied
    there and returned.
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    L = min(chunk, s)
    nch = -(-s // L)
    pad = nch * L - s
    f32 = torch.float32

    def chunks(t, heads=False):  # [B, S, ...] -> [nch, B, L, ...] in f32
        t = t.to(f32)
        if heads:
            t = t.repeat_interleave(rep, dim=2)
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((bsz, nch, L) + t.shape[2:]).transpose(0, 1)

    xs, dts, bs, cs = chunks(x), chunks(dt), chunks(b, True), chunks(c, True)
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    af = a.to(f32)
    tri = torch.tril(torch.ones((L, L), dtype=f32, device=x.device))
    ys = []
    for xc, dtc, bc, cc in zip(xs, dts, bs, cs):
        cum = torch.cumsum(af * dtc, dim=1)  # Δ_t [B, L, H]
        total = cum[:, -1]  # [B, H]
        cb = torch.einsum("blhn,bshn->bhls", cc, bc)
        cum_h = cum.transpose(1, 2)  # [B, H, L]
        # Clamped at 0: the entries above the diagonal would be exp(+large)
        # = inf before the mask, and inf·0 = NaN.
        dec = torch.exp(torch.clamp_max(cum_h[..., :, None] - cum_h[..., None, :], 0.0))
        dx = dtc[..., None] * xc  # [B, L, H, P]
        y = torch.einsum("bhls,bshp->blhp", cb * dec * tri, dx)
        y = y + torch.einsum("blhn,bhpn,blh->blhp", cc, state, torch.exp(cum))
        sdec = torch.exp(total[:, None, :] - cum)  # [B, L, H]
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "blhp,blhn,blh->bhpn", dx, bc, sdec)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(bsz, nch * L, h, p)[:, :s]
    if out_state is not None:
        state = out_state.copy_(state)
    return y.to(x.dtype), state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, init_state: torch.Tensor | None = None,
             out_state: torch.Tensor | None = None, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, H, P], h_T [B, H, P, N] f32)`` of the SSD recurrence over
    ``x [B, S, H, P]``, ``dt [B, S, H]`` f32, ``a [H]`` f32, ``b, c [B, S, G,
    N]`` (``x``, ``b``, ``c`` all f32 or all bf16; ``y`` in ``x``'s dtype).

    ``init_state [B, H, P, N]`` f32 is the state before step 0 (zeros when
    None).  With ``out_state`` (contiguous f32, possibly ``init_state``
    itself) the final state is written there and returned.  ``chunk``
    applies on the CPU only, as the plain version's chunk length; the kernel
    always works in 64-step chunks, which changes only the rounding.
    """
    if x.dim() != 4 or dt.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"need x [B, S, H, P], dt [B, S, H], b, c [B, S, G, N], got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b.shape[:2]) != (bsz, s) or g == 0 or h % g):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}: need matching B, S, H and H a multiple of G")
    state_shape = (bsz, h, p, n)
    for name, st in (("init_state", init_state), ("out_state", out_state)):
        if st is not None and tuple(st.shape) != state_shape:
            raise ValueError(f"{name} {tuple(st.shape)}: need {state_shape}")
    tensors = [t for t in (x, dt, a, b, c, init_state, out_state) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, a, b, c, init_state=init_state, out_state=out_state,
                              chunk=chunk)
    if not all(t.device == x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("ssd_scan: need every tensor on one CUDA device (or all on "
                         "the CPU)")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"need x, b, c all f32 or all bf16, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"need dt and a in f32, got {dt.dtype}, {a.dtype}")
    if not (0 < p <= MAX_DIM and 0 < n <= MAX_DIM):
        raise ValueError(f"P = {p}, N = {n}: the kernel takes 1 to {MAX_DIM}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    for name, st in (("init_state", init_state), ("out_state", out_state)):
        if st is not None and (st.dtype != torch.float32 or not st.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous f32 tensor")
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = out_state if out_state is not None else torch.empty(
        state_shape, dtype=torch.float32, device=x.device)
    if bsz * h == 0:
        return y, state
    if s == 0:  # no step: the state is the initial one
        return y, state.copy_(init_state) if init_state is not None else state.zero_()
    a = a.contiguous()
    kind = form(s)
    if kind == "decode":  # 16-byte loads and stores of the state
        vec = n % 4 == 0 and all(st.data_ptr() % 16 == 0 for st in (init_state, state)
                                 if st is not None)
    else:  # 16-byte loads of x, B and C rows
        vec = all(t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0
                                                 for st in t.stride()[:3])
                  for t in (x, b, c))
    args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), state.data_ptr(),
            *x.stride()[:3], *dt.stride()[:3], *b.stride()[:3], *c.stride()[:3],
            *y.stride()[:3], bsz, s, h, g, p, n, int(x.dtype == torch.bfloat16),
            FORMS.index(kind), int(vec))
    dev = x.device.index
    if dev == torch.cuda.current_device():  # the launch goes to the current device
        err = _kernel()(*args, _build.raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args, _build.raw_stream(dev))
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    ssd_scan.forms[kind] += 1
    return y, state


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The C entry point, built, loaded and typed once per process."""
    ll, i32, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    return _build.entry("ssd_scan", "blaze_ssd_scan", [
        vp, vp, vp, vp, vp, vp, vp, vp, *[ll] * 15, *[i32] * 9, vp,
    ])


ssd_scan.launches = 0  # kernel launches since the caller last reset it
ssd_scan.forms = dict.fromkeys(FORMS, 0)  # the same, by form
