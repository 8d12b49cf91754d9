#!/usr/bin/env python3
"""Time the ring's tensor-map path (B1 ``mips_topk`` at k = 100 and
``topk_large`` at k = 4096, D = 768) built from two source trees, in
turns on one card, and hold their answers equal bit for bit; and B2
(``fused_topk``) at k = 100 and 2,000, B = 16: the parent's scan route
(``topk_scan.cu``'s ``fused_topk_launch``) against the change's ring
route (``fused_topk.cu``), answers equal bit for bit.

    git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/ab_ring.py build/parent/src/repro_torch/kernels/csrc

The first tree is the parent's ``csrc``; the second (default: this
checkout's) the change's.  Both libraries are loaded through this
checkout's wrappers, so the two trees must share the C entry points of
``mips_topk.cu``, ``topk_large.cu`` and ``topk_scan.cu``; the change's
tree has ``fused_topk.cu`` too.  The corpus is 8,841,823 random rows of
768 f32 and 128 COO slots (ids over 30,522 terms, f32 values; MS MARCO
passage scale, 36.2 GB, made on the card), the queries 16 random dense
rows and 32 terms each; each time is the median of CUDA events over 5
calls (3 for ``topk_large`` and B2), in the order parent, change,
change, parent.  Needs one card and ``nvcc``; the libraries go to
``build/ab/`` (gitignored).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N, D, V, NNZ, NNZ_Q = 8_841_823, 768, 30_522, 128, 32


def build(trees):
    """One nvcc per (tree, source), all at once; the loaded libraries by tree."""
    from repro_torch.kernels import _build

    jobs = {}
    for side, tree in trees.items():
        out = ROOT / "build" / "ab" / side
        out.mkdir(parents=True, exist_ok=True)
        for name in ("mips_topk", "topk_large", "topk_scan") + (("fused_topk",) if side == "change" else ()):
            lib = out / f"lib{name}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(tree / f"{name}.cu")]
            jobs[side, name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for (side, name), (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {side}'s {name}.cu:\n{log}")
        libs.setdefault(side, {})[name] = ctypes.CDLL(str(lib))
    return libs


def cuda_ms(torch, fn, reps):
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="the parent's csrc directory")
    ap.add_argument("change", type=Path, nargs="?", default=ROOT / "src" / "repro_torch" / "kernels" / "csrc")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_ring: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import topk_large as lk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build({"parent": args.parent, "change": args.change})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    corpus = torch.randn(N, D, generator=g, device=dev)
    idx = torch.randint(1, V, (N, NNZ), generator=g, device=dev, dtype=torch.int32)
    val = torch.rand(N, NNZ, generator=g, device=dev)
    for b in (16, 1):
        q = torch.randn(b, D, generator=g, device=dev)
        qi = torch.randint(1, V, (b, NNZ_Q), generator=g, device=dev)
        table = torch.zeros(b, V + 1, device=dev).scatter_add_(1, qi, torch.rand(b, NNZ_Q, generator=g, device=dev))
        same = lambda fn: {"parent": fn, "change": fn}
        runs = {"b1": (same(lambda: mk.mips_topk(q, corpus, 100)), 5),
                "topk_large": (same(lambda: lk.topk_large(None, q, None, None, corpus, 4096)), 3)}
        if b == 16:   # B2: the parent's scan route against the change's ring
            for k in (100, 2000):
                args = (table, q, idx, val, corpus, k)
                runs[f"b2 k={k} (parent: scan, change: ring)"] = (
                    {"parent": lambda args=args: fk.fused_scan(*args, w_dense=0.6, w_sparse=0.4),
                     "change": lambda args=args: fk.fused_filter(*args, w_dense=0.6, w_sparse=0.4)[:2]}, 3)
        times, answers = {}, {}
        for side in ("parent", "change", "change", "parent"):
            _build.load = lambda name, side=side: libs[side][name]
            for what, (fns, reps) in runs.items():
                answers[side, what] = fns[side]()
                times.setdefault((side, what), []).append(cuda_ms(torch, fns[side], reps))
        for what in runs:
            (ps, pi), (cs, ci) = answers["parent", what], answers["change", what]
            if not (torch.equal(pi, ci) and torch.equal(ps.view(torch.int32), cs.view(torch.int32))):
                raise AssertionError(f"{what} at B={b}: the parent's and the change's answers differ")
            print(f"ab_ring B={b} {what}: parent " + " / ".join(f"{t:.3f}" for t in times["parent", what])
                  + " ms, change " + " / ".join(f"{t:.3f}" for t in times["change", what])
                  + " ms; answers equal bit for bit", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
