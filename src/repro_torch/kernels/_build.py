"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into ``build/repro_torch/<name>-<digest>.so`` at the repository
root, where ``<digest>`` hashes the flags, the source and every shared header,
so an edited source builds anew and an unchanged one is reused.  The sources
expose a plain C interface: every pointer and the stream pass as
``ctypes.c_void_p``, and every entry returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

Nothing builds at import: the first call of :func:`load` builds what it needs,
and :func:`build` starts several ``nvcc`` processes at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    ``PATH``, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> None:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  The compiler's
    report (registers, shared memory, spills) lands beside each library as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, out, tmp, proc in procs:
        report, _ = proc.communicate()
        out.with_suffix(".so.log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{report}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """One C entry point with its argument types declared (pointers and the
    stream as ``c_void_p``, so ``ctypes`` never cuts them to 32 bits)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def raw_stream(index: int) -> int:
    """PyTorch's current stream on device ``index`` as a ``cudaStream_t``
    (``torch.cuda.current_stream()`` builds a Python ``Stream`` object
    first)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def check(err: int, what: str) -> None:
    """Raise if a launch was refused (``cudaGetLastError()`` not 0)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
