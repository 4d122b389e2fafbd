"""The flat f32 layout every optimizer of the port keeps its state in, and
how that layout shards over ranks (new in the port: the JAX package keeps
pytrees of leaves and lets XLA lay them out).

A :class:`FlatLayout` lists the parameters by unit (one unit, the whole
model, unless FSDP splits it, ``parallel/api.py::fsdp_units``); each unit
is a contiguous run of the flat buffer, padded with zeros to a multiple of
``world x ALIGN`` elements (``parallel/collectives.py``) and split into
``world`` equal shards, rank ``r`` holding the ``r``-th. A
:class:`FlatOptimizer` keeps, in a :class:`FlatState`:

- ``params``: the f32 masters, every parameter a view into it (the
  ``p.data`` of the model's parameter), or under FSDP only this rank's
  shards, one leaf a unit;
- ``grads``: the f32 gradients, every ``.grad`` a view into it (autograd
  accumulates into a ``.grad`` in place, so it is zeroed in place, never
  set to ``None``); a replicated world's buffer has ``extra`` slots past
  the masters' for the step's loss;
- ``slots``: the optimizer's state by kind (``mu``/``nu``, ``e_g``/
  ``e_x``, ``trace``) at the size of the update: the whole buffer when
  replicated, this rank's shard under ZeRO-1 and FSDP, so moments never
  exist whole on a card;
- ``decay``: AdamW's decay mask, per element of the update.

The update runs over ``upd_p`` and ``upd_g``: the whole buffers; under
ZeRO-1 this rank's shard of the masters and the reduce-scattered
gradient shard (``shard_grads``). :meth:`FlatState.moments` and
:meth:`FlatState.param_leaves` give the logical leaves by parameter name,
gathered over the ranks where sharded (every rank of the group must call
them together); :meth:`FlatState.load` copies logical leaves in, each rank
keeping its shard.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from distributed_compute_pytorch_tpu_torch.parallel import collectives as coll

MODES = ("replicated", "zero1", "fsdp")


def device_count(device) -> torch.Tensor:
    """A fresh update count: a device ``int32`` zero (reference
    ``FusedAdamWState.count``)."""
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclass(frozen=True)
class Unit:
    """One unit of a layout: its parameters ``(name, shape, offset in the
    unit)``, its offset in the whole flat buffer, its padded size and its
    shard's size and offset in a rank's shard buffer."""
    name: str
    leaves: tuple
    offset: int
    padded: int
    shard: int
    shard_offset: int


class FlatLayout:
    """Where each parameter lies in the flat buffer and which part is this
    rank's (module docstring). ``mode``: ``"replicated"`` (one rank holds
    and updates everything; ``world`` 1), ``"zero1"`` (every rank holds
    the whole masters and updates its shard; one unit) or ``"fsdp"``
    (every rank holds and updates only its shards). ``group``: the
    process group the shards are spread over; ``extra``: slots past the
    gradients for the step's own use."""

    def __init__(self, units: list, shapes: dict, *, mode: str = "replicated",
                 world: int = 1, rank: int = 0, group=None, extra: int = 0):
        if mode not in MODES:
            raise ValueError(f"layout mode must be one of {MODES}, got "
                             f"{mode!r}")
        if mode == "zero1" and len(units) != 1:
            raise ValueError("a ZeRO-1 layout is one unit")
        if mode == "replicated" and world != 1:
            raise ValueError("a replicated layout has one rank")
        self.mode, self.world, self.rank = mode, world, rank
        self.group, self.extra = group, extra
        self.units, self.offsets = [], {}
        off = shard_off = 0
        for name, leaf_names in units:
            leaves, u_off = [], 0
            for n in leaf_names:
                shape = tuple(shapes[n])
                leaves.append((n, shape, u_off))
                self.offsets[n] = (off + u_off, shape)
                u_off += math.prod(shape)
            padded = coll.padded_size(u_off, world)
            unit = Unit(name, tuple(leaves), off, padded, padded // world,
                        shard_off)
            self.units.append(unit)
            off += padded
            shard_off += unit.shard
        self.size, self.shard_size = off, shard_off

    @classmethod
    def of(cls, params: dict, units: list | None = None, **kw):
        """The layout of ``params`` (``{name: tensor}``): ``units`` (default
        one unit of every parameter in order)."""
        units = units or [("model", list(params))]
        return cls(units, {n: p.shape for n, p in params.items()}, **kw)

    @property
    def names(self) -> list:
        return list(self.offsets)

    def view(self, full: torch.Tensor, name: str) -> torch.Tensor:
        off, shape = self.offsets[name]
        return full[off:off + math.prod(shape)].view(shape)

    def views(self, full: torch.Tensor) -> dict:
        """``{name: view}`` of every parameter in a whole flat buffer."""
        return {n: self.view(full, n) for n in self.offsets}

    def flatten(self, leaves: dict, device) -> torch.Tensor:
        """A whole f32 flat buffer on ``device`` holding ``leaves``
        (``{name: tensor}``, every parameter), zero in the pads."""
        full = torch.zeros(self.size, dtype=torch.float32, device=device)
        with torch.no_grad():
            for n in self.offsets:
                self.view(full, n).copy_(leaves[n])
        return full

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole flat buffer: a view for one unit, a
        copy of the units' shards in order otherwise."""
        parts = [full[u.offset + self.rank * u.shard:
                      u.offset + (self.rank + 1) * u.shard]
                 for u in self.units]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def unit_shard(self, shards: torch.Tensor, unit: Unit) -> torch.Tensor:
        """``unit``'s shard in a rank's shard buffer (a view)."""
        return shards[unit.shard_offset:unit.shard_offset + unit.shard]

    def gather(self, shards: torch.Tensor) -> torch.Tensor:
        """The whole flat buffer from every rank's ``shards`` (one
        all-gather a unit over the group; a collective every rank of the
        group calls)."""
        if self.world == 1:
            return shards
        full = torch.empty(self.size, dtype=shards.dtype,
                           device=shards.device)
        for u in self.units:
            coll.all_gather(full[u.offset:u.offset + u.padded],
                            self.unit_shard(shards, u), self.group)
        return full


@dataclass(eq=False)
class FlatState:
    """An optimizer's state (module docstring): the device ``int32``
    update ``count``, the flat ``params``, ``grads`` and ``slots``, the
    ``layout``, the ``leaves`` the train state holds (the model's
    parameters, or FSDP's unit shards), AdamW's per-element ``decay``
    (f32 0/1 or ``None``), the update's views ``upd_p`` and ``upd_g``, and
    ZeRO-1's ``shard_grads``."""
    count: torch.Tensor
    params: torch.Tensor
    grads: torch.Tensor
    slots: dict
    layout: FlatLayout
    leaves: dict
    decay: torch.Tensor | None
    upd_p: torch.Tensor
    upd_g: torch.Tensor
    shard_grads: torch.Tensor | None = None

    def view(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        """Parameter ``name``'s view of a whole flat buffer."""
        return self.layout.view(flat, name)

    def _whole(self, buf: torch.Tensor) -> torch.Tensor:
        return buf if self.layout.world == 1 else self.layout.gather(buf)

    def nbytes(self) -> dict:
        """This rank's bytes of f32 masters, optimizer slots (``moments``)
        and gradient buffers."""
        grads = self.grads.numel() + (0 if self.shard_grads is None
                                      else self.shard_grads.numel())
        return {"masters": 4 * self.params.numel(),
                "moments": 4 * sum(t.numel() for t in self.slots.values()),
                "grads": 4 * grads}

    def moments(self) -> dict:
        """``{kind: {name: tensor}}``: views of the slots when replicated,
        gathered copies when sharded (every rank calls it together)."""
        return {k: self.layout.views(self._whole(s))
                for k, s in self.slots.items()}

    def param_leaves(self) -> dict:
        """``{name: tensor}`` of the f32 masters: the live views, or under
        FSDP gathered copies (every rank calls it together)."""
        full = (self.layout.gather(self.params)
                if self.layout.mode == "fsdp" else self.params)
        return self.layout.views(full)

    @torch.no_grad()
    def load(self, params: dict | None = None,
             moments: dict | None = None) -> None:
        """Copy logical leaves in place (``params``: ``{name: tensor}``;
        ``moments``: ``{kind: {name: tensor}}``), each rank keeping its
        part; the buffers keep their storage."""
        layout, dev = self.layout, self.params.device
        if params is not None:
            full = layout.flatten(params, dev)
            self.params.copy_(layout.shard(full)
                              if layout.mode == "fsdp" else full)
        for kind, leaves in (moments or {}).items():
            full = layout.flatten(leaves, dev)
            self.slots[kind].copy_(full if layout.world == 1
                                   else layout.shard(full))


class FlatOptimizer:
    """The base of the port's optimizers: :meth:`init` lays the state out
    flat (module docstring), :meth:`update` is one update of the flat
    ``upd_p`` from ``upd_g`` in place, and :meth:`apply` the whole
    replicated step from a ``{name: gradient}`` dict. ``kinds``: the
    slots; ``elementwise``: whether the update is elementwise over the
    buffer, so that it may run on a shard (a global-norm clip is not)."""

    kinds: tuple = ()
    elementwise = True

    def decay_leaves(self, params: dict) -> dict | None:
        """``{name: bool}``: which parameters decay, or ``None`` (no
        mask)."""
        del params
        return None

    def init(self, params: dict, layout: FlatLayout | None = None
             ) -> FlatState:
        """The state of ``params`` (``{name: tensor}``, f32, one device) in
        ``layout`` (default: replicated, one unit). Replicated and ZeRO-1:
        each parameter's ``data`` and ``.grad`` become views of the flat
        buffers. FSDP: the buffers hold this rank's shards, one leaf
        (an ``nn.Parameter``) a unit, and the parameters' own storage is
        freed (the step gathers the units)."""
        ps = list(params.values())
        if not ps:
            raise ValueError("no parameters")
        dev = ps[0].device
        if any(p.dtype != torch.float32 or p.device != dev for p in ps):
            raise ValueError("the optimizer keeps f32 master parameters on "
                             "one device")
        layout = layout or FlatLayout.of(params)
        full = layout.flatten(params, dev)
        fsdp = layout.mode == "fsdp"
        flat_p = layout.shard(full).clone() if fsdp else full
        flat_g = torch.zeros(flat_p.numel() + layout.extra,
                             dtype=torch.float32, device=dev)
        upd_size = layout.shard_size if layout.world > 1 else layout.size
        shard_grads = upd_p = None
        if layout.mode == "zero1":
            upd_p = layout.shard(flat_p)
            upd_g = shard_grads = torch.zeros_like(upd_p)
        else:
            upd_p, upd_g = flat_p, flat_g[:flat_p.numel()]
        mask = self.decay_leaves(params)
        decay = None
        if mask is not None:
            whole = layout.flatten({n: torch.full(p.shape, float(mask[n]))
                                    for n, p in params.items()}, dev)
            decay = whole if layout.world == 1 else layout.shard(whole)
            decay = decay.clone()
        with torch.no_grad():
            if fsdp:
                leaves = {}
                for u in layout.units:
                    leaf = nn.Parameter(torch.empty(0, device=dev))
                    leaf.data = layout.unit_shard(flat_p, u)
                    leaf.grad = layout.unit_shard(flat_g, u)
                    leaves[u.name] = leaf
                for p in ps:
                    p.data = torch.empty(0, device=dev)
            else:
                leaves = params
                for name, p in params.items():
                    p.data = layout.view(flat_p, name)
                    p.grad = layout.view(flat_g, name)
        return FlatState(
            count=device_count(dev), params=flat_p, grads=flat_g,
            slots={k: torch.zeros(upd_size, dtype=torch.float32, device=dev)
                   for k in self.kinds},
            layout=layout, leaves=leaves, decay=decay, upd_p=upd_p,
            upd_g=upd_g, shard_grads=shard_grads)

    def update(self, state: FlatState, ok: torch.Tensor | None = None,
               gn2: torch.Tensor | None = None) -> None:
        """One update of ``state.upd_p`` from ``state.upd_g``, in place;
        with a device bool ``ok`` only where it holds (the old bits kept
        otherwise) and the count advancing by ``ok``. ``gn2``: the global
        gradient sum of squares where the step has it (a clip reads it)."""
        raise NotImplementedError

    def check(self, state: FlatState, grads: dict | None = None) -> None:
        """Raise when a leaf of the state, its ``.grad`` or a tensor of
        ``grads`` (``{name: tensor}``) no longer lies in the flat buffers:
        autograd replaces a ``.grad`` that was set to ``None``, and the
        update would never see the new one."""
        layout = state.layout
        if layout.mode == "fsdp":
            spans = [(u.name, layout.unit_shard(state.params, u),
                      layout.unit_shard(state.grads, u))
                     for u in layout.units]
        else:
            spans = [(n, state.view(state.params, n),
                      state.view(state.grads, n)) for n in layout.names]
        for name, pv, gv in spans:
            leaf = state.leaves[name]
            g = leaf.grad if grads is None else grads.get(name)
            if (leaf.data_ptr() != pv.data_ptr() or g is None
                    or g.data_ptr() != gv.data_ptr() or g.shape != gv.shape):
                raise RuntimeError(
                    f"the parameter or gradient of {name!r} no longer lies "
                    f"in the optimizer's flat buffer (zero grads in place, "
                    f"never set them to None)")

    @torch.no_grad()
    def apply(self, grads: dict, state: FlatState, params: dict,
              ok: torch.Tensor | None = None) -> None:
        """One replicated update from ``grads`` (``{name: tensor}``): a
        gradient that is not its parameter's view of ``state.grads`` is
        copied there first."""
        if set(grads) != set(state.layout.names) or set(params) != set(
                grads):
            raise ValueError("apply: params/grads do not match the leaves "
                             "init laid out")
        for name, g in grads.items():
            view = state.view(state.grads, name)
            if g.data_ptr() != view.data_ptr():
                view.copy_(g)
        self.update(state, ok)
