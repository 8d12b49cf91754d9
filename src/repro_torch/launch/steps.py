"""Train steps of the three model families (counterpart of the train half
of ``repro/launch/steps.py``).

Each ``make_*_train_step`` returns ``(step, optimizer)``;
``step(params, opt_state, batch) -> (params, opt_state, metrics)`` takes
the gradients by autograd and updates ``params`` (a module) and
``opt_state`` in place, returning them (the reference's jitted step
donates both).  ``metrics`` holds the loss and the loss function's own
metrics as detached scalars on the parameters' device: no host sync.

The dry run's cell machinery (``Cell``, ``abstract_init``,
``rules_for_shape``, ``zero_axes_of``, ``build_cell``, ``all_cells`` and
the probes) reads XLA artifacts and is not ported here.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, RecSysConfig, SchNetConfig,
                                      TransformerConfig)
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import recsys as R
from repro_torch.models import schnet as S
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizer import named_leaves

__all__ = ["shape_by_name", "make_lm_train_step", "make_gnn_train_step", "make_recsys_train_step"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def shape_by_name(family: str, name: str):
    table = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}[family]
    return {s.name: s for s in table}[name]


def _grads(loss: torch.Tensor, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d leaf by name; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives them."""
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(leaves.items(), gs)}


def _detached(loss, metrics) -> dict:
    return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}


def make_lm_train_step(cfg: TransformerConfig, ctx: ParallelCtx, lr: float = 1e-4, params_axes=None,
                       params_sds=None):
    """The LM step: ``lm_loss`` and its gradients, over ``cfg.grad_accum``
    microbatches when it is above 1 (the gradients summed in their own
    dtype, as ``jnp.add`` sums them, then divided by k; the metrics then
    hold the loss alone, as the reference's), then the config's optimizer.
    ZeRO sharding needs a mesh: without one it is a no-op, with one it
    raises ``NotImplementedError`` until the distributed slice."""
    opt = make_optimizer(cfg.optimizer)
    if cfg.zero_sharding and params_axes is not None and ctx.mesh is not None:
        raise NotImplementedError("ZeRO sharding needs the port's distributed layer, which is not ported yet")

    def step(params, opt_state, batch):
        leaves = named_leaves(params)
        k = max(1, cfg.grad_accum)
        if k == 1:
            loss, metrics = T.lm_loss(params, batch, cfg, ctx)
            grads = _grads(loss, leaves)
            metrics = _detached(loss, metrics)
        else:
            grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
            total = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for mb in zip(*(v.chunk(k) for v in batch.values())):
                loss, _ = T.lm_loss(params, dict(zip(batch, mb)), cfg, ctx)
                for n, g in _grads(loss, leaves).items():
                    grads[n].add_(g)
                total = total + loss.detach()
            grads = {n: g / k for n, g in grads.items()}
            metrics = {"loss": total / k}
        opt.step(grads, opt_state, params, lr)
        return params, opt_state, metrics

    return step, opt


def make_gnn_train_step(cfg: SchNetConfig, ctx: ParallelCtx, lr: float = 1e-3, n_graphs: int = 0):
    """SchNet's step: ``schnet_loss`` (energies of ``n_graphs`` molecules
    or per-node targets) and AdamW."""
    opt = make_optimizer("adamw")

    def step(params, opt_state, batch):
        loss, metrics = S.schnet_loss(params, batch, cfg, ctx, n_graphs)
        opt.step(_grads(loss, named_leaves(params)), opt_state, params, lr)
        return params, opt_state, _detached(loss, metrics)

    return step, opt


def make_recsys_train_step(cfg: RecSysConfig, ctx: ParallelCtx, lr: float = 1e-3):
    """A recommendation model's step: ``bce_loss`` and AdamW.  The tables'
    gradients are dense, as JAX's are: AdamW decays every row."""
    opt = make_optimizer("adamw")

    def step(params, opt_state, batch):
        loss, metrics = R.bce_loss(params, cfg, batch, ctx)
        opt.step(_grads(loss, named_leaves(params)), opt_state, params, lr)
        return params, opt_state, _detached(loss, metrics)

    return step, opt
