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
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, NamedTuple

import torch
from torch import nn

__all__ = ["named_leaves", "reference_leaves", "global_norm", "clip_by_global_norm", "cosine_schedule", "AdamState",
           "AdafactorState", "Optimizer", "make_optimizer"]

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
    return _norm(named_leaves(tree).values())


def _norm(leaves) -> torch.Tensor:
    """sqrt of the sum, in the order given, of each leaf's f32 sum of squares."""
    total = None
    for x in leaves:
        part = torch.sum(torch.square(x.float()))
        total = part if total is None else total + part
    return torch.sqrt(total)


def _clip_scale(leaves, max_norm: float):
    norm = _norm(leaves)
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
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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


@torch.no_grad()
def _adamw_update(grads, state: AdamState, params, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    leaves = named_leaves(params)
    grads = _leaves_like(grads, leaves)
    state.step.add_(1)
    t = state.step.to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    for name, p in leaves.items():
        g_all, m_all, v_all = grads[name], state.m[name], state.v[name]
        for sl in _row_slices(p):
            g, m, v, pp = g_all[sl].float(), m_all[sl], v_all[sl], p[sl]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.mul((1 - b2)).mul_(g))
            u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            u.add_(pp.float() * weight_decay)
            _apply(pp, u, _lr(lr, p.device))
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


@torch.no_grad()
def _adafactor_update(grads, state: AdafactorState, params, lr, decay=0.8, eps=1e-30,
                      weight_decay=0.0, clip_thr=1.0):
    leaves = named_leaves(params)
    grads = _leaves_like(grads, leaves)
    state.step.add_(1)
    t = state.step.to(torch.float32)
    beta = 1.0 - t ** (-decay)
    for ref, names in reference_leaves(params).items():
        stacked = names != [ref]
        if stacked:       # the reference's stacked leaf [L, ...]: copies, written back below
            p = torch.stack([leaves[n] for n in names])
            g = torch.stack([grads[n] for n in names]).float()
        else:
            p, g = leaves[ref], grads[ref].float()
        vr, vc = state.vr[ref], state.vc[ref]
        g2 = (g * g).add_(eps)
        if p.dim() >= 2:
            vr.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
            vc.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))
            r = vr / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps)
            u = g / torch.sqrt(torch.clamp_min(r[..., None] * vc[..., None, :], eps))
        else:
            vr.mul_(beta).add_((1 - beta) * g2)
            u = g / torch.sqrt(torch.clamp_min(vr, eps))
        del g2, g
        rms = torch.sqrt(torch.mean(u * u))
        u.div_(torch.clamp_min(rms / clip_thr, 1.0))
        u.add_(p.float() * weight_decay)
        _apply(p, u, _lr(lr, p.device))
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

    def step(self, grads, state, params, lr):
        """Clip ``grads`` by their global norm (scaled in place: the caller's
        gradients are spent), then update ``params`` and ``state`` in place;
        returns them."""
        if self.clip_norm:
            names = named_leaves(params)
            grads = _leaves_like(grads, names)
            scale, _ = _clip_scale([grads[k] for k in names], self.clip_norm)
            with torch.no_grad():
                for g in grads.values():
                    g.mul_(scale.to(g.dtype))
        return self.update(grads, state, params, lr)


def make_optimizer(name: str, clip_norm: float = 1.0, **kw) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", _adamw_init, functools.partial(_adamw_update, **kw), clip_norm)
    if name == "adafactor":
        return Optimizer("adafactor", _adafactor_init, functools.partial(_adafactor_update, **kw), clip_norm)
    raise ValueError(name)
