"""Checkpoints — port of ``distributed_compute_pytorch_tpu/train/checkpoint.py``
(the v1 single-file format).

A checkpoint is one ``.npz`` of path-flattened leaves (``"::"``-joined
keys) plus a ``__manifest__`` JSON with the format (1), the epoch, an
``extra`` dict and a CRC-32 per leaf, written atomically. The params go
under ``.params::`` and the model state (the ConvNet's BatchNorm running
stats, ``.model_state::batchnorm::{mean,var}``) under ``.model_state::``
in the JAX package's layout and names (``interop.params_to_jax``: GPT-2's
or the ConvNet's), so the JAX ``checkpoint.restore_params``, the JAX
``dcp-serve``/``dcp-generate``, the port's ``cli_serve`` and
``interop.load_jax_checkpoint`` all read a checkpoint the port trained.
The rest is the port's own:

- ``.step`` (int64): updates taken;
- ``.seed`` (int64): the dropout seed (``train/step.py``);
- ``.opt_state::count`` (int64) and ``.opt_state::<kind>::<param name>``
  (f32): the optimizer's update count (a device ``int32`` in the live
  state) and slots by the port's parameter names: ``mu``/``nu`` for
  ``adamw`` and ``adamw_fused``, ``e_g``/``e_x`` for ``adadelta``,
  ``trace`` for ``sgd``.

Every leaf read is verified against its CRC-32
(``interop.read_checkpoint``), and all of them before any is copied into
the live state. A restore copies into the live state's tensors, the
count included, and never replaces one: a captured train step holds
them by address (``train/step.py``). ``keep_last=N`` rotates older files to
``{path}.prev-K``; :func:`restore_with_fallback` walks them newest first.

A sharded state (ZeRO-1's moments, FSDP's masters and moments) is saved in
LOGICAL form, as the reference saves its v1 file (``:7-15``): every rank
takes part in gathering the leaves (:func:`state_leaves` is a collective
then) and rank 0 alone writes (``save(..., write=...)``). A restore reads
the logical leaves and hands each rank its shard, so a run resumes in any
layout from a checkpoint of any other. The reference's v2 sharded format
(``--ckpt_sharded``, ``save_sharded``) is not ported: :func:`save_sharded`
raises naming its queue item.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from distributed_compute_pytorch_tpu_torch.core.config import queued
from distributed_compute_pytorch_tpu_torch.interop import (
    CheckpointCorruptError, _crc, _np, params_from_jax, params_to_jax,
    read_checkpoint, unflatten)
from distributed_compute_pytorch_tpu_torch.utils.fsio import atomic_write

_FORMAT_VERSION = 1
_SEP = "::"
_PARAMS = ".params"
_MODEL_STATE = ".model_state"
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
    """The checkpoint's leaves of a ``train/step.py::TrainState``, in
    logical form: gathered over the ranks where the state is sharded, so
    every rank of the group calls it together."""
    opt = state.opt_state
    flat = {".step": np.asarray(state.step, np.int64),
            ".seed": np.asarray(state.seed, np.int64),
            f"{_OPT}{_SEP}count": np.asarray(int(opt.count), np.int64)}
    params, model_state = params_to_jax({**opt.param_leaves(),
                                         **state.model_state})
    _flatten_tree(params, _PARAMS, flat)
    _flatten_tree(model_state, _MODEL_STATE, flat)
    for kind, leaves in opt.moments().items():
        for name, t in leaves.items():
            flat[f"{_OPT}{_SEP}{kind}{_SEP}{name}"] = _np(t)
    return flat


def save(path: str, state, *, epoch: int = 0, extra: dict | None = None,
         keep_last: int = 1, write: bool = True) -> None:
    """Write ``state`` to ``path`` atomically, keeping ``keep_last``
    checkpoints (rotated ``.prev-K`` files). Every rank of a sharded
    state calls it (the leaves are gathered); only ranks with ``write``
    write."""
    flat = state_leaves(state)
    if not write:
        return
    manifest = {"format": _FORMAT_VERSION, "epoch": epoch,
                "extra": extra or {},
                "checksums": {k: _crc(v) for k, v in flat.items()}}
    _rotate(path, keep_last)
    atomic_write(path, lambda f: np.savez(
        f, __manifest__=json.dumps(manifest), **flat))


def save_sharded(*args, **kwargs):
    """The reference's v2 sharded checkpoint (``:207``): not ported."""
    raise NotImplementedError(queued("--ckpt_sharded"))


def load_manifest(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__manifest__"]))


def load_into(state, flat: dict) -> None:
    """Copy verified logical leaves into ``state`` in place (the flat
    buffers keep their storage; each rank keeps its shard of a sharded
    state). Raises ``KeyError``/``ValueError`` naming the first missing or
    mis-shaped leaf — the model or optimizer changed since the save."""
    opt = state.opt_state
    shapes = {n: shape for n, (_, shape) in opt.layout.offsets.items()}
    leaves = params_from_jax(unflatten(flat, _PARAMS),
                             unflatten(flat, _MODEL_STATE))
    want = set(shapes) | set(state.model_state)
    if set(leaves) != want:
        raise KeyError(f"checkpoint params do not match the model: missing "
                       f"{sorted(want - set(leaves))[:4]}")
    moments = {kind: {name: f"{_OPT}{_SEP}{kind}{_SEP}{name}"
                      for name in shapes} for kind in opt.slots}
    for key in (".step", ".seed", f"{_OPT}{_SEP}count",
                *(k for d in moments.values() for k in d.values())):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
    checks = [(v, shapes[n] if n in shapes
               else tuple(state.model_state[n].shape), f"{_PARAMS}::{n}")
              for n, v in leaves.items()]
    checks += [(flat[k], shapes[n], k) for d in moments.values()
               for n, k in d.items()]
    for src, shape, key in checks:
        if tuple(src.shape) != tuple(shape):
            raise ValueError(
                f"checkpoint leaf {key!r} was saved with shape "
                f"{tuple(src.shape)} but the state wants {tuple(shape)} — "
                f"model configuration changed since the save")
    opt.load(params={n: leaves[n] for n in shapes},
             moments={kind: {n: torch.from_numpy(flat[k])
                             for n, k in d.items()}
                      for kind, d in moments.items()})
    with torch.no_grad():
        for n, buf in state.model_state.items():
            buf.copy_(leaves[n])
        opt.count.fill_(int(flat[f"{_OPT}{_SEP}count"]))
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
