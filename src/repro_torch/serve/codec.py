"""Bit-faithful JSON payload codec for query results (the port of
``repro/serve/codec.py``).

JSON's only number is a double, and float32 results that round-trip through
it can silently stop being bit-equal to the arrays the session produced —
which would make the serving layer's core contract ("results bit-equal to
direct ``session`` execution") untestable over the wire.  Arrays therefore
travel as raw little-endian bytes, base64-encoded, with dtype and shape
alongside::

    {"__nd__": {"dtype": "float32", "shape": [64], "data": "<base64>"}}

``encode_payload`` maps any pytree-ish result (dicts, lists/tuples, numpy
arrays, numpy scalars, torch tensors on any device, plain scalars) into
JSON-safe structures; ``decode_payload`` inverts it exactly.  A tensor goes
through ``.cpu().numpy()`` and comes back as a numpy array.  A tensor whose
dtype numpy lacks (``bfloat16``, the ``float8`` types) travels as its raw
bytes under its torch dtype's name and comes back as a CPU torch tensor of
that dtype with the same bits.  A 0-d tensor or array becomes a Python
scalar, which holds any float32 or bfloat16 value exactly.  Tuples become
lists — JSON has no tuple — so servers should shape results as dicts of
named fields.
"""
from __future__ import annotations

import base64

import numpy as np
import torch

__all__ = ["decode_payload", "encode_payload"]


def _tag(dtype: str, shape, raw: bytes) -> dict:
    return {
        "__nd__": {
            "dtype": dtype,
            "shape": list(shape),
            "data": base64.b64encode(raw).decode("ascii"),
        }
    }


def _encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":  # normalise to little-endian on the wire
        a = a.astype(a.dtype.newbyteorder("<"))
    return _tag(a.dtype.name, a.shape, a.tobytes())


def _numpy_has(dtype: torch.dtype) -> bool:
    """Whether ``.numpy()`` takes a tensor of ``dtype``."""
    try:
        torch.empty((0,), dtype=dtype).numpy()
    except TypeError:
        return False
    return True


def _torch_only(name: str) -> torch.dtype | None:
    """The torch dtype called ``name`` where numpy has none (``bfloat16``,
    the ``float8`` types), whatever extension of numpy's a process loaded."""
    dtype = getattr(torch, name, None)
    if isinstance(dtype, torch.dtype) and not _numpy_has(dtype):
        return dtype
    return None


def _encode_tensor(t: torch.Tensor):
    t = t.detach().cpu()
    if t.ndim == 0:
        return t.item()
    if _numpy_has(t.dtype):
        return _encode_array(t.numpy())
    # No numpy dtype: the element bytes as they are (the host is
    # little-endian, as the wire is), under the torch dtype's name.
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return _tag(str(t.dtype).removeprefix("torch."), t.shape, raw)


def encode_payload(obj):
    """Recursively JSON-encode a result payload, arrays as tagged bytes."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj
    if isinstance(obj, np.generic):  # numpy scalar -> python scalar
        return obj.item()
    if isinstance(obj, np.ndarray):
        return _encode_array(obj)
    if isinstance(obj, torch.Tensor):
        return _encode_tensor(obj)
    if isinstance(obj, dict):
        return {str(k): encode_payload(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_payload(v) for v in obj]
    # Anything else array-like goes through numpy.
    arr = np.asarray(obj)
    if arr.ndim == 0:
        return arr.item()
    return _encode_array(arr)


def _decode_array(nd: dict):
    raw = base64.b64decode(nd["data"])
    tdt = _torch_only(nd["dtype"])
    if tdt is None:
        return np.frombuffer(raw, dtype=np.dtype(nd["dtype"])).reshape(nd["shape"]).copy()
    if not raw:
        return torch.empty(nd["shape"], dtype=tdt)
    flat = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy())
    return flat.view(tdt).reshape(nd["shape"])


def decode_payload(obj):
    """Invert :func:`encode_payload`; tagged arrays come back as numpy (a
    dtype numpy lacks, as a CPU torch tensor of that dtype)."""
    if isinstance(obj, dict):
        nd = obj.get("__nd__")
        if nd is not None and set(nd) == {"dtype", "shape", "data"}:
            return _decode_array(nd)
        return {k: decode_payload(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_payload(v) for v in obj]
    return obj
