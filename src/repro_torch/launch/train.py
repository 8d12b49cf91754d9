"""Fault-tolerant training driver (counterpart of ``repro/launch/train.py``).

    init-or-resume -> [step, monitor, checkpoint] x N

Fault tolerance, as the reference's:
  * auto-resume from the latest atomic checkpoint;
  * the straggler monitor flags persistently slow ranks; the driver logs
    the policy's decision;
  * a step that raises, or whose loss is not finite, restores the last
    checkpoint in place and continues from its step, at most
    ``max_restarts`` times.

Over a mesh, every rank runs ``train_lm`` with the same arguments: the
parameters are initialised from the seed on every rank and distributed by
``params_sharding`` (each rank keeping its blocks), each step takes every
rank's block of the batch, and checkpoints are saved (gathered, written by
one rank), restored and restarted over the mesh.  ``main`` builds
``local_mesh()`` when it is started as one of several ranks (``torchrun``'s
``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``/``MASTER_PORT``), as the
reference does when JAX sees several devices.

Usage (smoke scale on the CPU; without ``--device`` it runs on the card):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 20 --smoke --ckpt-dir /tmp/ckpt --device cpu
Over a (data, model) mesh of 4 ranks on the CPU:
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2.5-3b --smoke --steps 20 --device cpu --mesh 2,2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import device_put_batch, lm_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ParallelCtx, distribute_module
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.launch.steps import make_lm_train_step
from repro_torch.models import transformer as T

__all__ = ["train_lm", "main"]


def train_lm(cfg, mesh, steps: int, ckpt_dir: str | None, batch_size: int = 8, seq_len: int = 128,
             lr: float = 3e-4, ckpt_interval: int = 10, max_restarts: int = 3, log_every: int = 5,
             seed: int = 0, device=None):
    """Train ``cfg`` from ``init_transformer(cfg, seed)`` (or the latest
    checkpoint in ``ckpt_dir``) up to ``steps`` steps of ``batch_size`` x
    ``seq_len`` tokens drawn by ``lm_batches`` from ``seed``'s 500,000
    uniform tokens, as the reference's, on ``device`` (None = the card).
    Returns (the model, the losses of the steps taken).  With a
    ``DeviceMesh`` every rank calls it alike; the model comes back with
    ``DTensor`` parameters."""
    dev = resolve_device(device)
    ctx = ParallelCtx(mesh, dict(cfg.rules))
    step_fn, opt = make_lm_train_step(cfg, ctx, lr=lr)
    params, axes = T.init_transformer(cfg, seed=seed, device=dev)
    distribute_module(params, axes, ctx)
    opt_state = opt.init(params)
    state = {"params": params, "opt": opt_state}

    mgr = CheckpointManager(ckpt_dir, interval=ckpt_interval, use_async=False) if ckpt_dir else None
    start_step = 0
    if mgr is not None:
        start_step, _ = mgr.restore_latest(state)
        if start_step:
            print(f"[train] resumed from step {start_step}")

    data = lm_batches(np.random.default_rng(seed).integers(0, cfg.vocab_size, size=500_000).astype(np.int32),
                      batch_size, seq_len, seed=seed)

    monitor = StragglerMonitor()
    restarts = 0
    losses = []
    step = start_step
    while step < steps:
        batch = device_put_batch(next(data), dev)
        monitor.step_begin()
        try:
            _, _, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
        except Exception as e:  # noqa: BLE001 — the restart policy's boundary: restore, or re-raise
            restarts += 1
            if mgr is None or restarts > max_restarts:
                raise
            print(f"[train] step {step} failed ({e}); restoring last checkpoint")
            step, _ = mgr.restore_latest(state)
            continue
        flagged = monitor.step_end(step)
        if flagged:
            print(f"[train] straggler ranks flagged at step {step}: {flagged} "
                  f"(policy: evict + re-mesh via distributed.elastic)")
        losses.append(loss)
        step += 1
        if step % log_every == 0:
            print(f"[train] step {step}: loss {loss:.4f}")
        if mgr is not None and mgr.should_save(step):
            mgr.save(step, state)
    if mgr is not None:
        mgr.save(steps, state)
        mgr.close()
    return params, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-trainable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain path on the CPU")
    ap.add_argument("--mesh", default=None,
                    help="data,model sizes of the mesh when started as several ranks (default: local_mesh(), "
                         "every rank on the model axis)")
    args = ap.parse_args()

    cfg = (config_registry.get_smoke_config(args.arch) if args.smoke
           else config_registry.get_config(args.arch))
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        import torch.distributed as dist

        from repro_torch.distributed.mesh_utils import local_mesh, make_mesh

        dev = resolve_device(args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        mesh = (make_mesh(tuple(int(n) for n in args.mesh.split(",")), ("data", "model"), dev.type) if args.mesh
                else local_mesh(device=dev.type))
    t0 = time.time()
    _, losses = train_lm(cfg, mesh, args.steps, args.ckpt_dir, batch_size=args.batch, seq_len=args.seq,
                         device=args.device)
    if losses:
        print(f"[train] {len(losses)} steps in {time.time() - t0:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"[train] nothing to do: the checkpoint is at step {args.steps} already")


if __name__ == "__main__":
    main()
