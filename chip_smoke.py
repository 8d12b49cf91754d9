#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # one H100, MS MARCO passage scale

Phases, one line each: the card; the build of every kernel from
``src/repro_torch/kernels/csrc``; each kernel against its plain version
at small shapes; then the main path at MS MARCO passage v1 scale
(8,841,823 passages, 768-d dense, 30,522-term sparse with 128 nnz per
passage and 32 per query, batches of 16): fused dense+sparse retrieval
through ``RetrievalPipeline`` on the ``cuda`` backend and dense ip
through ``mips_topk``, with the launch counters set to 0 just before and
read just after.  The last lines are the ``kernels`` JSON, the card's
name and power limit, and ``{"ok": true, ...}``.  Any failure raises and
exits non-zero.  The data is synthetic, made on the card from ``--seed``.

Tolerance, kernel against plain version: f32 scores agree within
``TOL_REL`` times the row's largest |score| (summation order differs:
sequential FMAs in the kernel, cuBLAS or a CPU reduction in the plain
version); ids are equal wherever the construction plants a margin, and
elsewhere may differ only between neighbours whose plain scores lie
within that tolerance of each other.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

TOL_REL = 1e-5
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM data sheet, f32 on CUDA cores
BATCHES = 8                      # served batches on the main path
MSMARCO = dict(n=8_841_823, d=768, v=30_522, nnz=128, nnz_q=32, b=16)
SOURCES = "src/repro_torch/kernels/csrc/topk_scan.cu"


def log(*parts):
    print(*parts, flush=True)


def make_corpus(torch, n, d, v, nnz, n_plant, seed, device, dtype):
    """Fused corpus: random unit-scale dense rows with column 0 zeroed and
    random COO rows over ids [1, v).  ``n_plant`` rows spread over the
    whole range get a single dense entry ``t_j = 1 + j/4096`` in column 0
    and a single COO entry (id 0, ``6 - j/512``), so against a planted
    query (column 0 = 2, id 0 weighted 8) their scores are exact, distinct
    and far above every other row: the top-k ids are pinned for k <=
    n_plant (the torch form of benchmarks/common.py planted_margin_*)."""
    g = torch.Generator(device=device).manual_seed(seed)
    dense = torch.randn(n, d, generator=g, device=device).mul_(1.0 / math.sqrt(d))
    dense[:, 0] = 0.0
    idx = torch.randint(1, v, (n, nnz), generator=g, device=device, dtype=torch.int32)
    val = torch.rand(n, nnz, generator=g, device=device)
    planted = (torch.arange(n_plant, device=device) * max(n // n_plant, 1)) % n
    j = torch.arange(n_plant, device=device, dtype=torch.float32)
    dense[planted] = 0.0
    dense[planted, 0] = 1.0 + j / 4096.0
    idx[planted] = v
    val[planted] = 0.0
    idx[planted, 0] = 0
    val[planted, 0] = 6.0 - j / 512.0
    return dense.to(dtype), idx, val.to(dtype), planted


def make_queries(torch, b, d, v, nnz_q, seed, device, planted=True):
    g = torch.Generator(device=device).manual_seed(seed)
    qd = torch.randn(b, d, generator=g, device=device).mul_(1.0 / math.sqrt(d))
    qi = torch.randint(1, v, (b, nnz_q), generator=g, device=device, dtype=torch.int32)
    qv = torch.rand(b, nnz_q, generator=g, device=device)
    qd[:, 0] = 2.0 if planted else 0.0
    if planted:
        qi[:, 0] = 0
        qv[:, 0] = 8.0
    return qd, qi, qv


class Checker:
    """Kernel vs plain version; keeps the worst |error| per kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.max_err = {}
        self.cases = 0

    def __call__(self, kernel, name, got, want, exact_ids=True):
        torch = self.torch
        gs, gi = (x.cpu() for x in got)
        ws, wi = (x.cpu() for x in want)
        assert gs.shape == ws.shape and gi.shape == wi.shape, (name, gs.shape, ws.shape)
        fin = torch.isfinite(ws)
        assert torch.equal(fin, torch.isfinite(gs)), f"{name}: -inf tails differ"
        scale = torch.where(fin, ws.abs(), torch.zeros_like(ws)).amax(1, keepdim=True).clamp_min(1e-30)
        err = torch.where(fin, (gs - ws).abs(), torch.zeros_like(ws))
        assert bool((err <= TOL_REL * scale).all()), \
            f"{name}: score error {float((err / scale).max()):.3g} of row scale > {TOL_REL}"
        bad = gi != wi
        if exact_ids:
            assert not bool(bad.any()), f"{name}: ids differ at {int(bad.sum())} places"
        elif bool(bad.any()):
            gap = (ws[:, :-1] - ws[:, 1:]).abs() <= 2 * TOL_REL * scale
            near = torch.zeros_like(bad)
            near[:, 1:] |= gap
            near[:, :-1] |= gap
            assert not bool((bad & ~near).any()), f"{name}: ids differ beyond near-ties"
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), float(err.max()))
        self.cases += 1


def cuda_ms(torch, fn, reps):
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def small_phase(torch, dev, check):
    """Both kernels against their plain versions at small shapes."""
    from repro_torch.core.backends import CudaBackend, ReferenceBackend
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ref

    n, d, v, nnz, n_valid = 5003, 64, 1000, 16, 4900
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        dense, idx, val, planted = make_corpus(torch, n, d, v, nnz, 2048, 1, dev, dtype)
        # duplicate a few planted rows into their successors: equal scores,
        # the lower id must come first
        dup = planted[1:64:7]
        dense[dup + 1], idx[dup + 1], val[dup + 1] = dense[dup], idx[dup], val[dup]
        for b in (5, 16):
            qd, qi, qv = make_queries(torch, b, d, v, 8, 2 + b, dev)
            table = torch.zeros(b, v + 1, device=dev)
            table.scatter_add_(1, qi.long(), qv)
            table[:, v] = 0.0
            for k in (1, 10, 100, 2048):
                for space in ("ip", "l2"):
                    check("mips_topk", f"mips {space} {tag} b{b} k{k}",
                          mk.mips_topk(qd, dense, k, n_valid=n_valid, space=space),
                          ref.mips_topk_ref(qd, dense, k, n_valid=n_valid, space=space))
                for label, args in (
                        ("dense-only", (None, qd, None, None, dense, k, 0.7, None)),
                        ("sparse-only", (table, None, idx, val, None, k, None, None)),
                        ("fused", (table, qd, idx, val, dense, k, 0.6, 0.4))):
                    kw = dict(w_dense=args[6], w_sparse=args[7], n_valid=n_valid)
                    check("fused_topk", f"fused {label} {tag} b{b} k{k}",
                          fk.fused_topk(*args[:6], **kw),
                          ref.fused_topk_table_ref(*args[:6], **kw))
        # unplanted queries: general scoring, ids may swap only at near-ties
        qd, qi, qv = make_queries(torch, 16, d, v, 8, 99, dev, planted=False)
        table = torch.zeros(16, v + 1, device=dev).scatter_add_(1, qi.long(), qv)
        check("mips_topk", f"mips ip random {tag}", mk.mips_topk(qd, dense, 50),
              ref.mips_topk_ref(qd, dense, 50), exact_ids=False)
        args = (table, qd, idx, val, dense, 50)
        check("fused_topk", f"fused random {tag}",
              fk.fused_topk(*args, w_dense=0.6, w_sparse=0.4),
              ref.fused_topk_table_ref(*args, w_dense=0.6, w_sparse=0.4), exact_ids=False)
        # k > n_valid through the backend pins the reference's tail
        qd, _, _ = make_queries(torch, 4, d, v, 8, 7, dev)
        got = CudaBackend().topk(DenseSpace("ip"), qd, dense, 60, n_valid=40)
        want = ReferenceBackend().topk(DenseSpace("ip"), qd, dense, 60, n_valid=40)
        check("mips_topk", f"backend tail {tag}", got, want)
        # a width that is not a multiple of 4 takes the kernel's scalar loads
        odd = dense[:, :61].contiguous()
        qd, qi, qv = make_queries(torch, 16, 61, v, 8, 11, dev)
        for space in ("ip", "l2"):
            check("mips_topk", f"mips {space} d=61 {tag}", mk.mips_topk(qd, odd, 100, space=space),
                  ref.mips_topk_ref(qd, odd, 100, space=space))
        table = torch.zeros(16, v + 1, device=dev).scatter_add_(1, qi.long(), qv)
        args = (table, qd, idx, val, odd, 100)
        check("fused_topk", f"fused d=61 {tag}", fk.fused_topk(*args, w_dense=0.6, w_sparse=0.4),
              ref.fused_topk_table_ref(*args, w_dense=0.6, w_sparse=0.4))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=MSMARCO["n"], help="corpus rows")
    ap.add_argument("--device", default="cuda", help="'cpu' rehearses the control flow and fails at the end")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core.backends import resolve_backend
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro_torch.core.sparse import SparseVectors
    from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels.ops import fused_topk as ops_fused
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = "not measured (cpu rehearsal)"
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
        log(f"phase card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        t0 = time.perf_counter()
        _build.build_all()
        log(f"phase build: {time.perf_counter() - t0:.1f} s for {SOURCES}")
        ptxas = _build.PTXAS_LOG.get("topk_scan", "")
        regs = [int(w) for line in ptxas.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(line.split()[line.split().index("spill") - 2]) for line in ptxas.splitlines()
                     if " bytes spill stores" in line)
        log(f"  ptxas: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
            f"{spills} bytes of spill stores")

    check = Checker(torch)
    small_phase(torch, dev, check)
    log(f"phase small: {check.cases} cases agree (tolerance {TOL_REL} of row scale)")

    # ---- full scale: the main path -------------------------------------
    cfg = dict(MSMARCO, n=args.n)
    n, d, v, nnz, b = cfg["n"], cfg["d"], cfg["v"], cfg["nnz"], cfg["b"]
    torch.manual_seed(args.seed)
    t0 = time.perf_counter()
    dense, idx, val, _ = make_corpus(torch, n, d, v, nnz, 2048, args.seed, dev, torch.float32)
    corpus = FusedVectors(dense, SparseVectors(idx, val))
    batches = []
    for i in range(BATCHES):
        qd, qi, qv = make_queries(torch, b, d, v, cfg["nnz_q"], args.seed + 100 + i, dev)
        batches.append(FusedVectors(qd, SparseVectors(qi, qv)))
    g = torch.Generator().manual_seed(args.seed)
    w_dense, w_sparse = (0.2 + 0.8 * torch.rand(2, generator=g)).tolist()
    if on_card:
        torch.cuda.synchronize()
    log(f"phase data: n={n} d={d} v={v} nnz={nnz} resident "
        f"{sum(t.numel() * t.element_size() for t in (dense, idx, val)) / 1e9:.2f} GB, "
        f"made in {time.perf_counter() - t0:.1f} s; weights {w_dense:.4f}/{w_sparse:.4f}")

    space = FusedSpace(v, w_dense, w_sparse)
    pipe = RetrievalPipeline(BruteForceGenerator(space, corpus, backend="cuda"),
                             cand_qty=100, final_qty=10)
    dense_gen = BruteForceGenerator(DenseSpace("ip"), dense, backend="cuda")
    assert type(resolve_backend("cuda", space, corpus)).__name__ == "CudaBackend"

    mk.launches = 0
    fk.launches = 0
    fused_s, dense_s, results, dense_results = [], [], [], []
    for q in batches:
        t0 = time.perf_counter()
        results.append(pipe.run(q))
        if on_card:
            torch.cuda.synchronize()
        fused_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dense_results.append(dense_gen.generate(q.dense, 100))
        if on_card:
            torch.cuda.synchronize()
        dense_s.append(time.perf_counter() - t0)
    launches = {"mips_topk": mk.launches, "fused_topk": fk.launches}
    log(f"phase main path: {BATCHES} batches of {b}; launches {launches}; "
        f"fused pipeline median {1e3 * statistics.median(fused_s):.3f} ms/batch, "
        f"dense median {1e3 * statistics.median(dense_s):.3f} ms/batch (host clock, synchronised)")
    if on_card:
        assert all(c > 0 for c in launches.values()), f"a kernel was not launched: {launches}"

    # correctness at full scale, against the plain versions
    for r in results:
        assert r.scores.shape == (b, 10) and bool(torch.isfinite(r.scores).all())
    q = batches[0]
    table = ref.query_table(q.sparse, v)
    fused_args = (table, q.dense, idx, val, dense)
    fused_kw = dict(w_dense=w_dense, w_sparse=w_sparse)
    want = ref.fused_topk_table_ref(*fused_args, 100, tile_n=1 << 16, **fused_kw)
    check("fused_topk", "full fused k=100 (pipeline)", tuple(results[0]),
          (want[0][:, :10], want[1][:, :10]))
    check("fused_topk", "full fused k=100", tuple(ops_fused(q.sparse, q.dense, corpus.sparse, dense, v, 100,
                                                           **fused_kw)), want)
    want2000 = ref.fused_topk_table_ref(*fused_args, 2000, tile_n=1 << 16, **fused_kw)
    check("fused_topk", "full fused k=2000", fk.fused_topk(*fused_args, 2000, **fused_kw), want2000)
    want_dense = ref.mips_topk_ref(q.dense, dense, 100, tile_n=1 << 18)
    check("mips_topk", "full dense k=100 (generator)", tuple(dense_results[0]), want_dense)
    rq, _, _ = make_queries(torch, b, d, v, 8, args.seed + 7, dev, planted=False)
    check("mips_topk", "full dense k=100 random queries", mk.mips_topk(rq, dense, 100),
          ref.mips_topk_ref(rq, dense, 100, tile_n=1 << 18), exact_ids=False)
    log(f"phase full check: fused k=100 and k=2000, dense k=100 (planted and random) agree")

    # ---- timings ------------------------------------------------------
    reps = 5 if on_card else 1
    timer = (lambda fn, r: cuda_ms(torch, fn, r)) if on_card else (lambda fn, r: float("nan"))
    mips_ms = timer(lambda: mk.mips_topk(q.dense, dense, 100), reps)
    mips_plain = timer(lambda: ref.mips_topk_ref(q.dense, dense, 100, tile_n=1 << 18), 1)

    def library_topk():
        parts_s, parts_i = [], []
        for r0 in range(0, n, 1 << 20):
            s, i = torch.topk(q.dense @ dense[r0:r0 + (1 << 20)].T, 100)
            parts_s.append(s)
            parts_i.append(i + r0)
        s, p = torch.topk(torch.cat(parts_s, 1), 100)
        return s, torch.gather(torch.cat(parts_i, 1), 1, p)

    mips_lib = timer(library_topk, reps)
    fused_ms = timer(lambda: fk.fused_topk(*fused_args, 100, **fused_kw), reps)
    fused_plain = timer(lambda: ref.fused_topk_table_ref(*fused_args, 100, tile_n=1 << 16, **fused_kw), 1)

    dense_bytes = n * d * 4 + b * d * 4 + b * 100 * 8
    dense_ops = 2 * b * n * d
    fused_bytes = n * d * 4 + n * nnz * 8 + b * d * 4 + b * (v + 1) * 4 + b * 100 * 8
    fused_ops = 2 * b * n * (d + nnz) + 3 * b * n

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    kernels = []
    for name, replaces, ms, plain, lib, (bms, by) in (
            ("mips_topk", "src/repro/kernels/mips_topk.py:92", mips_ms, mips_plain, mips_lib,
             bound(dense_bytes, dense_ops)),
            ("fused_topk", "src/repro/kernels/fused_topk.py:146", fused_ms, fused_plain, None,
             bound(fused_bytes, fused_ops))):
        kernels.append({"name": name, "route": "cuda", "source": SOURCES, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": check.max_err[name],
                        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                        "library_ms": lib})
    log(f"phase timings (B={b}, k=100, f32, CUDA events, median of {reps}): "
        + "; ".join(f"{k['name']} {k['ms']:.3f} ms vs bound {k['bound_ms']:.3f} ms ({k['bound_by']}), "
                    f"plain {k['plain_ms']:.3f} ms, library {k['library_ms']}" for k in kernels))
    # where the fused time goes: the sparse part alone (the table gather),
    # the query-table glue of ops.fused_topk, and the k=2000 launch
    sparse_ms = timer(lambda: fk.fused_topk(table, None, idx, val, None, 100), reps)
    glue_ms = timer(lambda: ref.query_table(q.sparse, v), reps)
    k2000_ms = timer(lambda: fk.fused_topk(*fused_args, 2000, **fused_kw), 1)
    log(f"phase breakdown: sparse-only fused_topk {sparse_ms:.3f} ms "
        f"({n * nnz * b * 4 / 1e9:.1f} GB of query-table reads, bound {n * nnz * 8 / HBM_BYTES_PER_S * 1e3:.3f} ms "
        f"by its {n * nnz * 8 / 1e9:.2f} GB COO stream); query table {glue_ms:.3f} ms; "
        f"fused_topk k=2000 {k2000_ms:.3f} ms")
    del dense, idx, val, corpus
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if not on_card:
        print("chip_smoke: cpu rehearsal finished; kernels were not launched", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
