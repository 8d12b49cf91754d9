"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes and record its memory, counts and roofline terms (counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
        --shape train_4k [--multi-pod] [--out experiments/dryrun] [--device cpu]

With no filters it sweeps all 40 cells on the single-pod (16, 16) mesh
(``--both-meshes``: then on the multi-pod (2, 16, 16) mesh too).  Results
land in one JSON per cell.  No card is needed: the tensors are fake.

Where the reference lowers and compiles each cell for 512 forced host
devices and reads XLA's memory and cost analysis, the port traces the
program of one rank, rank 0, under ``FakeTensorMode`` with a fake process
group of the production world (256 or 512 ranks): nothing is allocated
and no collective moves data, but every op and collective the rank would
run is dispatched and counted (``roofline.Tracer``).  Rank 0 holds the
largest block where a split is uneven, so its figures are per-device
upper bounds.

An LM is traced at one layer, and its counts extended to full depth as
the reference extends its (rolled-scan) module by a probe:

    counts = cell(1 layer) + (L - 1) x (layer + tiling)

``layer`` is what one layer adds at the probe's attention chunks
(``steps.build_lm_probe``: the step cut to two layers less the step cut
to one), with all that goes with a layer: its block forward and
backward, its leaves' optimizer update and ZeRO's collectives of them.
``tiling`` is what one block costs more at the config's chunks than at
the probe's (the 1-layer cell at each; the forward computes every tile
at any tiling, the backward skips the tiles above the causal diagonal,
so their count depends on the tiling).  The tile loop makes a trace at
the config's chunks slow (1,024 tiles a layer at 32k positions), so only
the 1-layer cell is traced at them.  Every block of an LM has the same
shapes (asserted), so one layer stands for each.  The record's ``probe``
block holds ``layer + tiling``: one layer's counts at the config's
chunks.

Memory (``memory``): ``argument_bytes`` are what the step takes on the
rank at full depth: its parameter and optimizer-state blocks, the KV
cache's blocks, and the batch whole (the port's entry points take the
logical batch on every rank, where the reference's step takes its
shard; ``steps.Cell.inputs`` gathers it before the trace, so no
collective of the batch is counted); ``output_bytes`` the step's results
(those it updates in place among them, ``alias_bytes``: the donated
arguments); ``temp_bytes`` the traced peak of the bytes the step
allocates beyond its arguments, less its new results, at full depth by
the rule ``temp(L) = temp(1 layer) + (L - 1) x (peak(2 layers) - peak(1
layer))``, the 1-layer cell at the config's chunks (the tiles'
temporaries depend on them) and the per-layer step at the probe's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import warnings
from typing import Optional

_MESH_TAGS = {False: "16x16", True: "2x16x16"}


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in which this process is
    rank 0 (``torch.testing``'s fake backend: collectives move nothing),
    destroyed on exit.  Only the dry run's process ever sees it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own process group; this process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _trace(cell):
    """(the :class:`~repro_torch.launch.roofline.Trace` of one call of
    ``cell``, the bytes of its results that the call allocated).  The
    batch is gathered (``Cell.inputs``) before the trace starts."""
    from repro_torch.launch.roofline import Tracer
    from repro_torch.launch.steps import storage_bytes

    inputs = cell.inputs()
    held = storage_bytes(inputs)
    with Tracer() as tracer, warnings.catch_warnings():
        # ``optim.optimizer`` compares data pointers, which fake tensors report as 0
        warnings.filterwarnings("ignore", message="Accessing the data pointer of FakeTensor")
        out = cell.fn(*inputs)
    new_out = sum(n for k, n in storage_bytes(out).items() if k not in held)
    return tracer.trace, new_out


def _sum(*terms):
    """``sum(coef * counts)`` over ``(coef, counts)`` pairs of count dicts."""
    out = {}
    for coef, counts in terms:
        for k, v in counts.items():
            out[k] = out.get(k, 0.0) + coef * v
    return out


def extend_lm(c1, c1_out, a1, a2, layers: int):
    """An LM cell's counts and temporaries at ``layers`` from its traces
    (see the module's docstring): ``c1`` the cell at one layer and the
    config's chunks (``c1_out`` the bytes of its new results), ``a1`` and
    ``a2`` the probe at one and two layers.  Returns (a
    :class:`~repro_torch.launch.roofline.Trace` of the counts, the
    temporaries' bytes, the record's ``probe`` block)."""
    from repro_torch.launch.roofline import Trace

    tiling = _sum((1, c1.counts()), (-1, a1.counts()))
    layer = Trace.from_counts(_sum((1, a2.counts()), (-1, a1.counts()), (1, tiling)))
    full = Trace.from_counts(_sum((1, c1.counts()), (layers - 1, layer.counts())))
    mem_layer = a2.peak_bytes - a1.peak_bytes
    temp = c1.peak_bytes - c1_out + (layers - 1) * mem_layer
    return full, temp, {"probe_flops": layer.flops, "probe_bytes": layer.bytes_accessed,
                        "probe_collective": dict(layer.per_collective), "layers": layers, "tiling": tiling,
                        "memory_per_layer": mem_layer}


def _check_blocks_alike(model):
    """Every layer of a stacked leaf has one shape and dtype, locally too."""
    from repro_torch.launch.steps import _local
    from repro_torch.optim.optimizer import named_leaves, reference_leaves

    leaves = named_leaves(model)
    for ref, names in reference_leaves(model).items():
        kinds = {(tuple(leaves[n].shape), leaves[n].dtype, tuple(_local(leaves[n]).shape)) for n in names}
        if len(kinds) != 1:
            raise AssertionError(f"{ref}: the layers differ ({sorted(map(str, kinds))}); one probe cannot stand "
                                 f"for each")


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Optional[str], *, device="cuda",
             mesh_shape=None, batch=None) -> dict:
    """Trace one cell on rank 0 of a fake world and write its record to
    ``out_dir`` (None: no file).  ``mesh_shape`` replaces the production
    mesh (("data", "model") for two dims, ("pod", "data", "model") for
    three); ``batch`` the shape's batch (``steps.build_cell``).  A cell
    that fails is recorded with ``ok: false`` and its traceback."""
    import math

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell, build_lm_probe, storage_bytes

    if mesh_shape is None:
        tag, world = _MESH_TAGS[multi_pod], 512 if multi_pod else 256
    else:
        tag, world = "x".join(map(str, mesh_shape)), math.prod(mesh_shape)
    record = {"arch": arch, "shape": shape_name, "mesh": tag, "ok": False}
    t0 = time.time()
    try:
        with fake_world(world):
            if mesh_shape is None:
                mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            else:
                axes = ("pod", "data", "model")[-len(mesh_shape):]
                mesh = make_mesh(mesh_shape, axes, device)
            with FakeTensorMode(allow_non_fake_inputs=True):
                build = lambda **kw: build_cell(arch, shape_name, mesh, device=device, batch=batch, **kw)  # noqa: E731
                cell = build()
                family = getattr(cell.cfg, "family", "lm")
                args_b = sum(storage_bytes(cell.inputs()).values())
                alias_b = sum(storage_bytes([cell.args[i] for i in cell.donate]).values())
                t_build = time.time()
                probe_info = None
                if family == "lm":
                    _check_blocks_alike(cell.args[0])
                    c1, new_out = _trace(build(n_layers=1))
                    a1, a2 = (_trace(build_lm_probe(arch, shape_name, mesh, n_layers=n, device=device, batch=batch))[0]
                              for n in (1, 2))
                    full, temp_b, probe_info = extend_lm(c1, new_out, a1, a2, cell.cfg.n_layers)
                else:
                    full, new_out = _trace(cell)
                    temp_b = full.peak_bytes - new_out
                t_trace = time.time()
            out_b = alias_b + new_out
            total = args_b + out_b + temp_b - alias_b
            roof = RL.analyze_terms(full.flops, full.bytes_accessed, full.per_collective, world,
                                    model_flops=RL.model_flops_for(cell.cfg, cell.shape),
                                    resident_bytes=float(total), flops_by_dtype=full.flops_by_dtype)
        record.update(
            ok=True,
            build_s=round(t_build - t0, 1),
            trace_s=round(t_trace - t_build, 1),
            memory={"argument_bytes": args_b, "output_bytes": out_b, "temp_bytes": temp_b,
                    "alias_bytes": alias_b, "per_device_total": total},
            flops_by_dtype=dict(full.flops_by_dtype),
            roofline=roof.to_dict(),
            probe=probe_info,
        )
    except Exception as e:  # noqa: BLE001 - the dry run reports, it does not die
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = round(time.time() - t0, 1)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json"), "w") as f:
            json.dump(record, f, indent=2, default=str)
    return record


def summary(rec: dict) -> str:
    """One line of a cell's record: GB a device, the three terms in ms, the
    bottleneck and the useful ratio (or the error)."""
    status = "OK " if rec["ok"] else "FAIL"
    head = f"[{status}] {rec['arch']:24s} {rec['shape']:16s} {rec['mesh']:8s} {rec['total_s']:7.1f}s"
    if not rec["ok"]:
        return f"{head} {rec['error'][:160]}"
    r = rec["roofline"]
    useful = r["useful_ratio"] and round(r["useful_ratio"], 3)
    return (f"{head} mem/dev={rec['memory']['per_device_total'] / 1e9:.2f}GB"
            f" compute={r['compute_s'] * 1e3:.2f}ms"
            f" mem[{(r['memory_lower_s'] or 0) * 1e3:.2f},{r['memory_s'] * 1e3:.2f}]ms"
            f" coll={r['collective_s'] * 1e3:.2f}ms"
            f" bound={r['bottleneck_lower']}/{r['bottleneck']} useful={useful}")


def _run_one(job):
    arch, shape, mp, out, device = job
    return run_cell(arch, shape, mp, out, device=device)


def _cost_order(job):
    """Longest first: 32k-position prefills walk 1,024 tiles a layer."""
    return (job[1] != "prefill_32k", job[1] != "train_4k")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Trace every (arch x shape) cell on rank 0 of the production meshes, under fake tensors "
                    "and a fake process group, and record memory, counts and roofline terms. The reference's "
                    "--save-hlo has no counterpart: PyTorch compiles no HLO (roofline.collective_bytes_from_hlo "
                    "reads the reference's).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose JSON already records ok=true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda, the default, needs a CUDA build of torch; cpu anywhere)")
    ap.add_argument("--workers", type=int, default=1, help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)

    from repro_torch.launch.steps import all_cells

    cells = all_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    jobs = []
    for mp in meshes:
        for arch, shape in cells:
            if args.skip_existing:
                p = os.path.join(args.out, f"{arch}__{shape}__{_MESH_TAGS[mp]}.json")
                if os.path.exists(p):
                    with open(p) as f:
                        if json.load(f).get("ok"):
                            print(f"[SKIP] {arch:24s} {shape:16s} {_MESH_TAGS[mp]}", flush=True)
                            continue
            jobs.append((arch, shape, mp, args.out, args.device))

    n_fail, t0 = 0, time.time()
    if args.workers > 1:
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(args.workers, mp_context=multiprocessing.get_context("spawn"))
        with pool:
            for rec in (f.result() for f in concurrent.futures.as_completed(
                    [pool.submit(_run_one, j) for j in sorted(jobs, key=_cost_order)])):
                n_fail += not rec["ok"]
                print(summary(rec), flush=True)
    else:
        for job in jobs:
            rec = _run_one(job)
            n_fail += not rec["ok"]
            print(summary(rec), flush=True)
    print(f"swept {len(jobs)} cells, {n_fail} failed, in {time.time() - t0:.1f} s", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
