"""Checkpoints — port of ``distributed_compute_pytorch_tpu/train/checkpoint.py``
(the v1 single-file format, for one device).

A checkpoint is one ``.npz`` of path-flattened leaves (``"::"``-joined
keys) plus a ``__manifest__`` JSON with the format (1), the epoch, an
``extra`` dict and a CRC-32 per leaf, written atomically. The params go
under ``.params::`` in the JAX package's GPT-2 layout
(``interop.gpt2_params_to_jax``), so the JAX ``checkpoint.restore_params``,
the JAX ``dcp-serve``/``dcp-generate`` and the port's ``cli_serve`` all
read a checkpoint the port trained. The rest is the port's own:

- ``.step`` (int64): updates taken;
- ``.seed`` (int64): the dropout seed (``train/step.py``);
- ``.opt_state::count`` (int64) and ``.opt_state::{mu,nu}::<param name>``
  (f32): the optimizer's update count (a device ``int32`` in the live
  state) and moments by the port's parameter names, the same for
  ``adamw`` and ``adamw_fused``.

Every leaf read is verified against its CRC-32
(``interop.read_checkpoint``), and all of them before any is copied into
the live state. A restore copies into the live state's tensors, the
count included, and never replaces one: a captured train step holds
them by address (``train/step.py``). ``keep_last=N`` rotates older files to
``{path}.prev-K``; :func:`restore_with_fallback` walks them newest first.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from distributed_compute_pytorch_tpu_torch.interop import (
    CheckpointCorruptError, _crc, _np, gpt2_params_from_jax,
    gpt2_params_to_jax, read_checkpoint, unflatten)
from distributed_compute_pytorch_tpu_torch.utils.fsio import atomic_write

_FORMAT_VERSION = 1
_SEP = "::"
_PARAMS = ".params"
_OPT = ".opt_state"


def _rotate(path: str, keep_last: int) -> None:
    """Shift ``path`` -> ``path.prev-1`` -> ... -> ``path.prev-(N-1)``,
    dropping the oldest (reference ``_rotate``)."""
    if keep_last <= 1 or not os.path.exists(path):
        return
    oldest = f"{path}.prev-{keep_last - 1}"
    if os.path.exists(oldest):
        os.unlink(oldest)
    for k in range(keep_last - 2, 0, -1):
        src = f"{path}.prev-{k}"
        if os.path.exists(src):
            os.replace(src, f"{path}.prev-{k + 1}")
    os.replace(path, f"{path}.prev-1")


def _flatten_tree(tree: dict, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}"
        if isinstance(v, dict):
            _flatten_tree(v, key, out)
        else:
            out[key] = v


def state_leaves(state) -> dict[str, np.ndarray]:
    """The checkpoint's leaves of a ``train/step.py::TrainState``."""
    flat = {".step": np.asarray(state.step, np.int64),
            ".seed": np.asarray(state.seed, np.int64),
            f"{_OPT}{_SEP}count": np.asarray(int(state.opt_state.count),
                                             np.int64)}
    _flatten_tree(gpt2_params_to_jax(state.params), _PARAMS, flat)
    for kind, leaves in state.opt_state.moments().items():
        for name, t in leaves.items():
            flat[f"{_OPT}{_SEP}{kind}{_SEP}{name}"] = _np(t)
    return flat


def save(path: str, state, *, epoch: int = 0, extra: dict | None = None,
         keep_last: int = 1) -> None:
    """Write ``state`` to ``path`` atomically, keeping ``keep_last``
    checkpoints (rotated ``.prev-K`` files)."""
    flat = state_leaves(state)
    manifest = {"format": _FORMAT_VERSION, "epoch": epoch,
                "extra": extra or {},
                "checksums": {k: _crc(v) for k, v in flat.items()}}
    _rotate(path, keep_last)
    atomic_write(path, lambda f: np.savez(
        f, __manifest__=json.dumps(manifest), **flat))


def load_manifest(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__manifest__"]))


def load_into(state, flat: dict) -> None:
    """Copy verified leaves into ``state`` in place (the params keep their
    storage, so an ``adamw_fused`` flat buffer stays whole). Raises
    ``KeyError``/``ValueError`` naming the first missing or mis-shaped
    leaf — the model or optimizer changed since the save."""
    params = gpt2_params_from_jax(unflatten(flat, _PARAMS))
    if set(params) != set(state.params):
        raise KeyError(f"checkpoint params do not match the model: missing "
                       f"{sorted(set(state.params) - set(params))[:4]}")
    moments = state.opt_state.moments()
    wanted = {f"{_OPT}{_SEP}{kind}{_SEP}{name}": t
              for kind, leaves in moments.items()
              for name, t in leaves.items()}
    for key in (".step", ".seed", f"{_OPT}{_SEP}count", *wanted):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
    pairs = [(state.params[n], v, f"{_PARAMS}::{n}")
             for n, v in params.items()]
    pairs += [(t, torch.from_numpy(flat[k]), k) for k, t in wanted.items()]
    for dst, src, key in pairs:
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} was saved with shape "
                f"{tuple(src.shape)} but the state wants "
                f"{tuple(dst.shape)} — model configuration changed since "
                f"the save")
    with torch.no_grad():
        for dst, src, _ in pairs:
            dst.copy_(src)
        state.opt_state.count.fill_(int(flat[f"{_OPT}{_SEP}count"]))
    state.step = int(flat[".step"])
    state.seed = int(flat[".seed"])


def restore_with_fallback(path: str, state) -> dict:
    """Restore the newest checkpoint at ``path`` that verifies into
    ``state`` (the live file, then ``.prev-1``, ``.prev-2``, ...) and
    return ITS manifest; raises the last failure when none does."""
    candidates = [path]
    k = 1
    while os.path.exists(f"{path}.prev-{k}"):
        candidates.append(f"{path}.prev-{k}")
        k += 1
    last_err: Exception | None = None
    for cand in candidates:
        try:
            flat, manifest = read_checkpoint(cand)
        except (CheckpointCorruptError, OSError, ValueError) as e:
            last_err = e
            continue
        if last_err is not None:
            print(f"[checkpoint] WARNING: newest checkpoint corrupt "
                  f"({last_err}); restored fallback {cand}",
                  file=sys.stderr, flush=True)
        load_into(state, flat)
        return manifest
    raise last_err if last_err is not None else FileNotFoundError(path)
