"""Optimizers: AdamW and Adafactor over named parameter trees
(counterpart of ``repro/optim/optimizer.py``).

A tree is an ``nn.Module`` (its parameters), a nested dict (and list) of
tensors, or a dict of tensors keyed by name.  :func:`named_leaves`
flattens any of them to ``{name: tensor}`` in the reference's tree order:
dict keys sorted as JAX sorts them, and the layers of a list that the
reference stacks on a leading axis (a module's ``STACKED`` lists, e.g. the
transformer's ``blocks``) innermost, so that sums over the leaves run in
the reference's order.  AdamW's state holds one tensor per parameter,
keyed by its name (``interop.adam_state`` splits ``repro``'s stacked
moments); Adafactor's is keyed by the reference's leaves, stacked layers
and all (:class:`AdafactorState` says why).

Updates run under ``torch.no_grad()`` and write the parameters and the
states *in place*, where the reference returns new arrays (its train step
donates them): a second copy of the model and its moments is no option
at published widths.  Parameters stay in their dtype (no f32 master copy
of a bf16 parameter, as in the reference: ``(p.f32 - lr*u).astype(p.dtype)``),
and every product and sum is rounded where the reference rounds it (no
fused multiply-add).  The bias corrections ``1 - b**t`` and Adafactor's
``1 - t**(-decay)`` are computed in f32 from an f32 step, as JAX computes
them.

Over a mesh (:class:`MeshUpdate`) the parameters are ``DTensor``s (or
whole tensors) and the states ``DTensor``s; every rank updates its blocks
with the same per-leaf bodies as one device (``_adamw_leaf``,
``_adafactor_leaf``, the clip of ``Optimizer.clip_``), given the mesh's
sums.  The global norm sums each leaf's squares over the axes that split it (not
over its replicas), and Adafactor's row and column means, and its
update's RMS, reduce over the axes that split the dims they average.
With ZeRO-1 each data rank keeps, and updates, only its block of a leaf's
state on the dim the plan gives (``launch.steps.zero_axes_of``), then
all-gathers the new parameters into their compute layout.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import NamedSharding, axis_block, block_slices

__all__ = ["named_leaves", "reference_leaves", "global_norm", "clip_by_global_norm", "cosine_schedule", "AdamState",
           "AdafactorState", "Optimizer", "make_optimizer", "MeshUpdate"]

_ROWS = 1 << 26   # AdamW updates a larger leaf in row slices of about this many elements


def named_leaves(tree) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters or a tree's tensors, in
    the reference's tree order (see the module's docstring); names join
    the path with dots (``blocks.3.attn.wq``)."""
    return {name: t for _, name, _, t in _entries(tree)}


def reference_leaves(tree) -> Dict[str, list]:
    """``{the reference's leaf name: [names]}``: a leaf of a stacked list
    (``blocks.ln1.scale``) lists its layers' names in layer order
    (``blocks.0.ln1.scale``, ...); any other leaf lists its own name."""
    out: Dict[str, list] = {}
    for _, name, ref, _ in _entries(tree):
        out.setdefault(ref, []).append(name)
    return out


def _entries(tree):
    out = []
    _collect(tree, (), (), (), out)
    out.sort(key=lambda e: e[0])
    return out


def _collect(node, key, path, ref, out, layer=None):
    """Append ``(sort key, name, reference name, tensor)`` of every tensor
    under ``node``: a dict key sorts as ``(1, name)``, a list index as
    ``(0, i)`` in place, and the index of a stacked layer as ``(2, i)``
    after the leaf's path (and is left out of its reference name)."""
    if isinstance(node, torch.Tensor):
        out.append((key if layer is None else key + ((2, layer),), ".".join(path), ".".join(ref), node))
        return
    if isinstance(node, (list, tuple, nn.ModuleList)):
        for i, child in enumerate(node):
            _collect(child, key + ((0, i),), path + (str(i),), ref + (str(i),), out, layer)
        return
    if isinstance(node, nn.Module):
        items = list(node.named_parameters(recurse=False)) + list(node.named_children())
        stacked = getattr(node, "STACKED", ())
    else:
        items, stacked = list(node.items()), ()
    for name, child in items:
        if name in stacked:
            for i, sub in enumerate(child):
                _collect(sub, key + ((1, name),), path + (name, str(i)), ref + (name,), out, i)
        else:
            _collect(child, key + ((1, name),), path + (name,), ref + (name,), out, layer)


def _leaves_like(tree, names) -> Dict[str, torch.Tensor]:
    """``tree``'s leaves by name: a dict keyed by ``names`` passes through,
    any other tree is flattened by :func:`named_leaves`."""
    if isinstance(tree, dict) and set(tree) == set(names) and all(
            isinstance(t, torch.Tensor) for t in tree.values()):
        return tree
    return named_leaves(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in the reference's order) of each
    leaf's f32 sum of squares."""
    return torch.sqrt(_sq_sum(named_leaves(tree).values()))


def _sq_sum(leaves) -> torch.Tensor:
    """The sum, in the order given, of each leaf's f32 sum of squares."""
    total = None
    for x in leaves:
        part = torch.sum(torch.square(x.float()))
        total = part if total is None else total + part
    return total


def _clip_scale(leaves, max_norm: float, sq_sum=_sq_sum):
    """(``min(1, max_norm / max(norm, 1e-9))``, the norm) of ``leaves``,
    whose global sum of squares ``sq_sum`` gives."""
    norm = torch.sqrt(sq_sum(leaves))
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0), norm


def clip_by_global_norm(tree, max_norm: float):
    """(``{name: x * min(1, max_norm / max(norm, 1e-9))}`` with the scale
    cast to each leaf's dtype, the norm)."""
    leaves = named_leaves(tree)
    scale, norm = _clip_scale(leaves.values(), max_norm)
    return {k: x * scale.to(x.dtype) for k, x in leaves.items()}, norm


def cosine_schedule(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1) -> Callable:
    """step -> lr (an f32 scalar tensor): linear warm-up, then a cosine
    decay to ``min_ratio * base_lr`` at ``total``; in f32, as the reference."""
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def _lr(lr, device):
    """A Python lr stays a Python number (an f32 scalar in the product, as
    JAX's weak type); a tensor moves to the parameters' device."""
    return lr.to(device=device, dtype=torch.float32) if isinstance(lr, torch.Tensor) else lr


def _apply(p: torch.Tensor, u: torch.Tensor, lr):
    """``p <- (p.f32 - lr * u).astype(p.dtype)`` in place; ``u`` is spent."""
    u.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(u)
    else:
        p.copy_(p.float().sub_(u))


# ---------------------------------------------------------------------------
# AdamW.
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor                 # i32 scalar
    m: Dict[str, torch.Tensor]         # name -> f32 first moment
    v: Dict[str, torch.Tensor]         # name -> f32 second moment


def _adamw_init(params) -> AdamState:
    leaves = named_leaves(params)
    z = lambda p: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)  # noqa: E731
    dev = next(iter(leaves.values())).device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     {k: z(p) for k, p in leaves.items()}, {k: z(p) for k, p in leaves.items()})


def _row_slices(t: torch.Tensor):
    """Views of ``t`` over its first axis, about ``_ROWS`` elements each
    (the whole of a small leaf): the update's temporaries stay that small."""
    if t.dim() == 0 or t.numel() <= _ROWS:
        return [slice(None)]
    step = max(1, _ROWS // max(1, t[0].numel()))
    return [slice(i, i + step) for i in range(0, t.shape[0], step)]


def _adamw_leaf(p, g, m, v, t, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """AdamW on one leaf ``p`` (or a rank's block of it) in place, in row
    slices: its gradient ``g`` and moments ``m``, ``v`` alike laid out;
    ``t`` the f32 step."""
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    lr = _lr(lr, p.device)
    for sl in _row_slices(p):
        gs, ms, vs, ps = g[sl].float(), m[sl], v[sl], p[sl]
        ms.mul_(b1).add_(gs * (1 - b1))
        vs.mul_(b2).add_(gs.mul((1 - b2)).mul_(gs))
        u = (ms / bc1).div_((vs / bc2).sqrt_().add_(eps))
        u.add_(ps.float() * weight_decay)
        _apply(ps, u, lr)


@torch.no_grad()
def _adamw_update(grads, state: AdamState, params, lr, **hparams):
    leaves = named_leaves(params)
    grads = _leaves_like(grads, leaves)
    state.step.add_(1)
    t = state.step.to(torch.float32)
    for name, p in leaves.items():
        _adamw_leaf(p, grads[name], state.m[name], state.v[name], t, lr, **hparams)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018): factored second moments over the last
# two axes, no first moment.
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    """Keyed by the reference's leaf names (:func:`reference_leaves`): the
    reference factors a *stacked* leaf over its last two axes and clips
    the update by the RMS of the whole stacked leaf, so that a layer's
    rank-1 norm scale ``[d]`` is factored over ``[L, d]`` with the other
    layers'.  A stacked leaf's factors keep the layer axis in front."""

    step: torch.Tensor                 # i32 scalar
    vr: Dict[str, torch.Tensor]        # row factors (or the full v of a leaf of rank < 2)
    vc: Dict[str, torch.Tensor]        # column factors (a zero placeholder [1] for rank < 2)


def _fact_init(shape, device):
    f32 = torch.float32
    if len(shape) >= 2:
        return (torch.zeros(shape[:-1], dtype=f32, device=device),
                torch.zeros((*shape[:-2], shape[-1]), dtype=f32, device=device))
    return torch.zeros(shape, dtype=f32, device=device), torch.zeros((1,), dtype=f32, device=device)


def _reference_shape(leaves, names, ref):
    """The reference's shape of leaf ``ref``: a stacked leaf's layers in front."""
    p = leaves[names[0]]
    return tuple(p.shape) if names == [ref] else (len(names), *p.shape)


def _adafactor_init(params) -> AdafactorState:
    leaves = named_leaves(params)
    pairs = {ref: _fact_init(_reference_shape(leaves, names, ref), leaves[names[0]].device)
             for ref, names in reference_leaves(params).items()}
    dev = next(iter(leaves.values())).device
    return AdafactorState(torch.zeros((), dtype=torch.int32, device=dev),
                          {k: a for k, (a, _) in pairs.items()}, {k: b for k, (_, b) in pairs.items()})


def _mean(x, dims, keepdim=False):
    """``torch.mean`` over ``dims`` (None: every dim)."""
    return torch.mean(x) if dims is None else torch.mean(x, dim=dims, keepdim=keepdim)


def _adafactor_leaf(p, g, vr, vc, t, lr, mean=_mean, decay=0.8, eps=1e-30, weight_decay=0.0, clip_thr=1.0):
    """Adafactor on one reference leaf ``p`` (a stacked leaf's layers in
    front; or a rank's block of it) in place, its factors ``vr``, ``vc``;
    ``t`` the f32 step.  ``mean(x, dims, keepdim)`` is the mean over
    ``dims`` of the whole leaf's ``x`` (dims counted from the leaf's first,
    None for all): ``torch.mean`` of the whole leaf, or under a mesh the
    block's sum reduced over the axes that split those dims."""
    beta = 1.0 - t ** (-decay)
    g = g.float()
    g2 = (g * g).add_(eps)
    nd = g.dim()
    if nd >= 2:
        vr.mul_(beta).add_((1 - beta) * mean(g2, (nd - 1,)))
        vc.mul_(beta).add_((1 - beta) * mean(g2, (nd - 2,)))
        r = vr / torch.clamp_min(mean(vr, (nd - 2,), keepdim=True), eps)
        u = g / torch.sqrt(torch.clamp_min(r[..., None] * vc[..., None, :], eps))
    else:
        vr.mul_(beta).add_((1 - beta) * g2)
        u = g / torch.sqrt(torch.clamp_min(vr, eps))
    del g2, g
    rms = torch.sqrt(mean(u * u, None))
    u.div_(torch.clamp_min(rms / clip_thr, 1.0))
    u.add_(p.float() * weight_decay)
    _apply(p, u, _lr(lr, p.device))


@torch.no_grad()
def _adafactor_update(grads, state: AdafactorState, params, lr, **hparams):
    leaves = named_leaves(params)
    grads = _leaves_like(grads, leaves)
    state.step.add_(1)
    t = state.step.to(torch.float32)
    for ref, names in reference_leaves(params).items():
        stacked = names != [ref]
        if stacked:       # the reference's stacked leaf [L, ...]: copies, written back below
            p = torch.stack([leaves[n] for n in names])
            g = torch.stack([grads[n] for n in names])
        else:
            p, g = leaves[ref], grads[ref]
        _adafactor_leaf(p, g, state.vr[ref], state.vc[ref], t, lr, **hparams)
        del g
        if stacked:
            for i, n in enumerate(names):
                leaves[n].copy_(p[i])
    return params, state


# ---------------------------------------------------------------------------
# Facade.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable           # (grads, state, params, lr) -> (params, state), in place
    clip_norm: float = 1.0
    hparams: dict = dataclasses.field(default_factory=dict)   # the update's keywords (b1, decay, ...)

    @torch.no_grad()
    def clip_(self, grads, sq_sum=_sq_sum):
        """Scale the tensors ``grads`` in place by ``min(1, clip_norm /
        max(norm, 1e-9))`` of their global norm, whose square ``sq_sum``
        gives (default: each tensor's f32 sum of squares, summed in order)."""
        if self.clip_norm:
            scale, _ = _clip_scale(grads, self.clip_norm, sq_sum)
            for g in grads:
                g.mul_(scale.to(g.dtype))

    def step(self, grads, state, params, lr):
        """Clip ``grads`` by their global norm (scaled in place: the caller's
        gradients are spent), then update ``params`` and ``state`` in place;
        returns them."""
        names = named_leaves(params)
        grads = _leaves_like(grads, names)
        self.clip_([grads[k] for k in names])
        return self.update(grads, state, params, lr)


def make_optimizer(name: str, clip_norm: float = 1.0, **kw) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", _adamw_init, functools.partial(_adamw_update, **kw), clip_norm, kw)
    if name == "adafactor":
        return Optimizer("adafactor", _adafactor_init, functools.partial(_adafactor_update, **kw), clip_norm, kw)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Over a mesh.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Unit:
    """One state entry: its key, the port's leaves it covers (a stacked
    leaf's layers in order), its logical shape (layers in front when
    stacked), the spec of its update's layout over that shape, and the dim
    that ZeRO adds the data axis on (None without)."""

    key: str
    names: list
    stacked: bool
    shape: tuple
    spec: tuple
    zdim: Optional[int]


def _local(p):
    return p.to_local() if isinstance(p, DTensor) else p


def _spec_of(p):
    return NamedSharding.of(p).spec if isinstance(p, DTensor) else (None,) * p.dim()


def _dtensor_zeros(shape, sharding, device, dtype=torch.float32) -> DTensor:
    local = torch.zeros([n for _, n in block_slices(shape, sharding)], dtype=dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=torch.Size(shape), stride=torch.empty(shape, device="meta").stride())


def _factor_specs(spec):
    """(vr, vc) specs of a leaf's update spec: ``_opt_axes_safe``'s rule."""
    if len(spec) >= 2:
        return spec[:-1], spec[:-2] + (spec[-1],)
    return spec, (None,)


class MeshUpdate:
    """The optimizer ``opt`` over the parameters ``params`` (a module of
    ``DTensor``s placed by ``params_sharding``, or whole tensors) on
    ``mesh``.  ``zero`` maps the reference's leaf names to the dim that
    ZeRO-1 shards over ``zero_axis`` (``launch.steps`` makes it from
    ``zero_axes_of``); without it every rank of a leaf's replicas updates
    its block alike.

    State keys follow the single-device optimizer: AdamW's by parameter
    name, Adafactor's by the reference's leaf; under ZeRO AdamW's too are
    keyed by the reference's (stacked) leaf, as the plan shards it."""

    def __init__(self, opt: "Optimizer", params, mesh, zero=None, zero_axis: str = "data"):
        self.opt, self.mesh, self.zero_axis = opt, mesh, zero_axis
        leaves = named_leaves(params)
        self.units = []
        refs = reference_leaves(params)
        for ref, names in refs.items():
            stacked = names != [ref]
            p = leaves[names[0]]
            spec = _spec_of(p)
            for n in names[1:]:
                if _spec_of(leaves[n]) != spec:
                    raise ValueError(f"{n}: the layers of {ref} are laid out differently")
            shape = (len(names), *p.shape) if stacked else tuple(p.shape)
            spec = ((None,) + spec) if stacked else spec
            zdim = None if zero is None else zero.get(ref)
            if zdim is not None:
                if spec[zdim] is not None or shape[zdim] % mesh.size(mesh.mesh_dim_names.index(zero_axis)):
                    raise ValueError(f"{ref}: ZeRO cannot split dim {zdim} of {shape} laid out as {spec}")
                spec = spec[:zdim] + (zero_axis,) + spec[zdim + 1:]
            if opt.name == "adamw" and zdim is None:
                self.units += [_Unit(n, [n], False, tuple(leaves[n].shape), _spec_of(leaves[n]), None)
                               for n in names]
            else:
                self.units.append(_Unit(ref, names, stacked, shape, spec, zdim))

    # -- layout -------------------------------------------------------------

    def _axes(self, unit: _Unit, dims) -> tuple:
        """The mesh axes that split any of ``dims`` of the unit."""
        out = []
        for d in dims:
            entry = unit.spec[d]
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                if a not in out:
                    out.append(a)
        return tuple(out)

    def _sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        for a in axes:
            dist.all_reduce(x, group=self.mesh.get_group(a))
        return x

    def _mean(self, unit: _Unit, x: torch.Tensor, dims, keepdim=False) -> torch.Tensor:
        """The mean over ``dims`` of the unit's whole ``x`` from this rank's
        block of it: the block's sum, summed over the axes that split those
        dims, over their global length (``_adafactor_leaf``'s ``mean``)."""
        dims = tuple(range(len(unit.shape))) if dims is None else tuple(dims)
        total = self._sum(torch.sum(x, dim=dims, keepdim=keepdim), self._axes(unit, dims))
        return total / math.prod(unit.shape[d] for d in dims)

    def _sq_sum(self, blocks) -> torch.Tensor:
        """The global sum of squares of the units' gradients from this
        rank's ``blocks`` (in the units' order): the parts of units split
        alike summed here, then each such sum over the axes that split it."""
        by_axes = {}
        for u, g in zip(self.units, blocks):
            axes = self._axes(u, range(len(u.shape)))
            part = torch.sum(torch.square(g.float()))
            by_axes[axes] = part if axes not in by_axes else by_axes[axes] + part
        total = None
        for axes, part in by_axes.items():
            part = self._sum(part, axes)
            total = part if total is None else total + part
        return total

    def _zrange(self, unit: _Unit):
        return axis_block(unit.shape[unit.zdim], self.mesh, self.zero_axis)

    def block(self, unit: _Unit, tensors) -> torch.Tensor:
        """The unit's block of ``{name: tensor}`` (the compute layout's
        local blocks): ZeRO's cut of each layer, then a stacked leaf's
        layers stacked (a copy the size of the block alone); a single leaf
        without ZeRO is its own local block (a view)."""
        names, cut = unit.names, None
        if unit.zdim is not None:
            lo, n = self._zrange(unit)
            if unit.stacked and unit.zdim == 0:
                names = names[lo:lo + n]
            else:
                cut = (unit.zdim - 1 if unit.stacked else unit.zdim, lo, n)
        parts = [_local(tensors[k]) for k in names]
        if cut is not None:
            parts = [x.narrow(*cut) for x in parts]
        if unit.stacked:
            return torch.stack(parts)
        return parts[0] if cut is None else parts[0].clone()

    def reduced_block(self, unit: _Unit, tensors, axes) -> torch.Tensor:
        """:meth:`block` of gradients that are this rank's parts of a sum
        over ``axes`` (``ParallelCtx.deferred``), summed over the
        axes the leaf is replicated on: into ZeRO's block by a
        reduce-scatter over the ZeRO axis (each rank receives its block's
        parts alone), by an all-reduce over the others."""
        from repro_torch.distributed.collectives import reduce_scatter

        compute = unit.spec if unit.zdim is None else unit.spec[:unit.zdim] + (None,) + unit.spec[unit.zdim + 1:]
        used = {a for e in compute if e is not None for a in ((e,) if isinstance(e, str) else e)}
        axes = [a for a in axes if a not in used]
        if unit.zdim is not None and self.zero_axis in axes:
            group = self.mesh.get_group(self.zero_axis)
            if not unit.stacked:
                x = reduce_scatter(_local(tensors[unit.names[0]]), group, unit.zdim)
            elif unit.zdim == 0:    # whole layers to a data rank
                x = reduce_scatter(torch.stack([_local(tensors[k]) for k in unit.names]), group, 0)
            else:                   # a layer at a time: the temporaries stay a layer's size
                x = torch.stack([reduce_scatter(_local(tensors[k]), group, unit.zdim - 1) for k in unit.names])
            axes.remove(self.zero_axis)
        else:
            x = self.block(unit, tensors)
        return self._sum(x, axes)

    def _write(self, unit: _Unit, params, new: torch.Tensor):
        """The unit's updated block back into the parameters' local blocks
        (all-gathered over the ZeRO axis first)."""
        if unit.zdim is not None:
            group = self.mesh.get_group(self.zero_axis)
            parts = [torch.empty_like(new) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, new.contiguous(), group=group)
            new = torch.cat(parts, unit.zdim)
        if unit.stacked:
            for i, n in enumerate(unit.names):
                _local(params[n]).copy_(new[i])
        elif unit.zdim is not None or new.data_ptr() != _local(params[unit.names[0]]).data_ptr():
            _local(params[unit.names[0]]).copy_(new)

    # -- state --------------------------------------------------------------

    def init(self, params):
        leaves = named_leaves(params)
        dev = _local(next(iter(leaves.values()))).device
        step = torch.zeros((), dtype=torch.int32, device=dev)
        if self.opt.name == "adamw":
            m, v = {}, {}
            for u in self.units:
                for tree in (m, v):
                    tree[u.key] = (torch.zeros_like(leaves[u.key], dtype=torch.float32,
                                                    memory_format=torch.contiguous_format)
                                   if u.zdim is None else
                                   _dtensor_zeros(u.shape, NamedSharding(self.mesh, u.spec), dev))
            return AdamState(step, m, v)
        vr, vc = {}, {}
        for u in self.units:
            r_shape, c_shape = (u.shape[:-1], (*u.shape[:-2], u.shape[-1])) if len(u.shape) >= 2 else (u.shape, (1,))
            r_spec, c_spec = _factor_specs(u.spec)
            vr[u.key] = _dtensor_zeros(r_shape, NamedSharding(self.mesh, r_spec), dev)
            vc[u.key] = _dtensor_zeros(c_shape, NamedSharding(self.mesh, c_spec), dev)
        return AdafactorState(step, vr, vc)

    # -- the step -----------------------------------------------------------

    @torch.no_grad()
    def step(self, grads, state, params, lr):
        """``grads``: ``{unit key: block}`` from :meth:`block` (spent);
        updates ``params`` and ``state`` in place and returns them."""
        leaves = named_leaves(params)
        self.opt.clip_([grads[u.key] for u in self.units], self._sq_sum)
        state.step.add_(1)
        t = state.step.to(torch.float32)
        for u in self.units:
            p = self.block(u, leaves)
            if self.opt.name == "adamw":
                _adamw_leaf(p, grads[u.key], _local(state.m[u.key]), _local(state.v[u.key]), t, lr,
                            **self.opt.hparams)
            else:
                _adafactor_leaf(p, grads[u.key], _local(state.vr[u.key]), _local(state.vc[u.key]), t, lr,
                                functools.partial(self._mean, u), **self.opt.hparams)
            self._write(u, leaves, p)
        return params, state
