"""Filesystem helpers — a copy of
``distributed_compute_pytorch_tpu/utils/fsio.py`` (the port imports
nothing of the JAX package)."""

from __future__ import annotations

import os
import tempfile
from typing import IO, Callable


def atomic_write(path: str, write: Callable[[IO], None], mode: str = "wb",
                 suffix: str = ".tmp") -> None:
    """Write via a same-directory tempfile + ``os.replace``: readers never
    observe a torn file, and a crash mid-write leaves the previous version
    intact."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
