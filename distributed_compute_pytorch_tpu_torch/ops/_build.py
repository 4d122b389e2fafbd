"""Build and bind the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled with ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds rather than minutes. Device code that
two kernels share lives in ``csrc/*.cuh`` headers (``-I csrc``). The
libraries go to ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, the headers and the flags,
so a checkout builds what it needs at first use from its own sources alone
and a changed source or header never loads a stale library. The first :func:`load` builds
every kernel at once, one ``nvcc`` process per source, in parallel.

A failed build raises with the compiler's output; nothing falls back.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("flash_fwd", "kv_pool_insert", "paged_decode", "flash_bwd_dq",
           "flash_bwd_dkv", "fused_adamw", "kv_insert", "dense_decode",
           "paged_verify")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from csrc/ at "
                       "first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> dict:
    """Compile every kernel whose library is missing, all ``nvcc``
    processes started together. Returns ``{"seconds": wall, "built":
    [names], "ptxas": {name: compiler log}}``; raises ``RuntimeError``
    naming each kernel that failed to build."""
    t0 = time.monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in KERNELS if not _lib_path(n).exists()]
    procs = {}
    if todo:
        nvcc = nvcc_path()
        for name in todo:
            tmp = _lib_path(name).with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc rc {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {"seconds": time.monotonic() - t0, "built": todo, "ptxas": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building every kernel first
    if any library is missing). Raises if the first load would happen
    inside a CUDA graph capture: a capture must find its kernels loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            import torch
            if (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"CUDA kernel {name} first used inside a CUDA graph "
                    f"capture: run the program once eagerly before "
                    f"capturing it")
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} "
                           f"(cudaError {rc})")


_ARG = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
        "f": ctypes.c_float, "s": ctypes.POINTER(ctypes.c_longlong)}


def bind(name: str, spec: str, entry: str | None = None):
    """The C entry ``entry`` (default ``name``) of kernel ``name``, its
    ``argtypes`` declared from one letter per argument: ``p`` a pointer (or
    the stream, both ``c_void_p``), ``i`` a ``c_int``, ``l`` a
    ``c_longlong``, ``f`` a ``c_float``, ``s`` a ``long long`` strides
    array. Returns ``(lib, fn)``."""
    lib = load(name)
    fn = getattr(lib, entry or name)
    if fn.argtypes is None:
        fn.argtypes = [_ARG[c] for c in spec]
        fn.restype = ctypes.c_int
    return lib, fn


def strides_arg(*strides: int):
    """A host ``long long[]`` of element strides for a C entry."""
    return (ctypes.c_longlong * len(strides))(*strides)


def pos_arg(pos, device):
    """``(int32 tensor, stride)`` of a slot position for a C entry that
    reads row ``b``'s slot at ``pos[b * stride]``: a Python int becomes a
    one-element tensor on ``device``; a 0-dim tensor is read by every row
    (stride 0); a ``[B]`` tensor at its own stride, which must be 0 (an
    expanded scalar) or 1. Raises on another dtype, device or stride."""
    import torch
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=device)
    if pos.device != device or pos.dtype != torch.int32:
        raise ValueError(f"pos must be an int32 tensor on {device}, got "
                         f"{pos.dtype} on {pos.device}")
    stride = 0 if pos.ndim == 0 else pos.stride(0)
    if stride not in (0, 1):
        raise ValueError(f"pos must have stride 0 or 1, got {stride}")
    return pos, stride


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
