#!/usr/bin/env python3
"""Time the ring's tensor-map path from two checkouts in turns on one
card, and hold their answers equal bit for bit: B1 (``mips_topk``) at
k = 100 and ``topk_large`` at k = 4096, D = 768, at B = 1, 16, 32, 64 and
128; B2 (``fused_topk``) at k = 100, B = 16.  Each side runs in a process
of its own, through its own checkout's wrappers and kernels (so the two
may differ in their C entry points), in the order parent, change, change,
parent.

    git archive <parent> src | tar -x -C build/parent
    python3 tools/ab_ring.py build/parent

The first argument is the root of the parent's checkout (holding
``src/``); the second (default: this checkout's root) the change's.  With
``--variants`` the change's side also times B1 and ``topk_large`` at B =
32, 64 and 128 launched as a block a group (``cluster=False``), its
answers equal too.  The corpus is 8,841,823 random rows of 768 f32
and 128 COO slots (ids over 30,522 terms, f32 values; MS MARCO passage
scale, 36.2 GB, made on the card from a seed, the same in every process),
the queries random dense rows and 32 terms each; each time is the median
of CUDA events over 5 calls (3 for ``topk_large`` and B2).  Needs one card
and ``nvcc``; each side builds into its checkout's ``build/`` and the
answers go to ``build/ab/`` (both gitignored).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, D, V, NNZ, NNZ_Q = 8_841_823, 768, 30_522, 128, 32
BATCHES = (16, 1, 32, 64, 128)
VARIANT_BATCHES = (32, 64, 128)


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


def csrc_digest(root: Path) -> str:
    """The first 16 hex digits of a SHA-256 over a checkout's kernel sources, by name."""
    h = hashlib.sha256()
    for f in sorted((root / "src" / "repro_torch" / "kernels" / "csrc").iterdir()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def side(root: Path, out: Path, variants: bool) -> int:
    """One process: this side's checkout's kernels timed, answers saved."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import topk_large as lk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    corpus = torch.randn(N, D, generator=g, device=dev)
    idx = torch.randint(1, V, (N, NNZ), generator=g, device=dev, dtype=torch.int32)
    val = torch.rand(N, NNZ, generator=g, device=dev)
    runs = {}
    for b in BATCHES:
        q = torch.randn(b, D, generator=g, device=dev)
        runs[f"B={b} b1 k=100"] = (lambda q=q: mk.mips_topk(q, corpus, 100), 5)
        runs[f"B={b} topk_large k=4096"] = (lambda q=q: lk.topk_large(None, q, None, None, corpus, 4096), 3)
        if b == 16:
            qi = torch.randint(1, V, (b, NNZ_Q), generator=g, device=dev)
            table = torch.zeros(b, V + 1, device=dev).scatter_add_(1, qi, torch.rand(b, NNZ_Q, generator=g,
                                                                                     device=dev))
            runs[f"B={b} b2 k=100"] = (lambda t=table, q=q: fk.fused_topk(t, q, idx, val, corpus, 100,
                                                                         w_dense=0.6, w_sparse=0.4), 3)
        if variants and b in VARIANT_BATCHES:
            runs[f"B={b} b1 k=100 a block a group"] = (
                lambda q=q: mk.mips_filter(q, corpus, 100, cluster=False)[:2], 5)
            runs[f"B={b} topk_large k=4096 a block a group"] = (
                lambda q=q: lk.topk_large(None, q, None, None, corpus, 4096, cluster=False), 3)
    times, answers = {}, {}
    for what, (fn, reps) in runs.items():
        s, i = fn()
        answers[what] = (s.cpu(), i.cpu())
        times[what] = cuda_ms(torch, fn, reps)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(answers, out)
    out.with_suffix(".json").write_text(json.dumps(times))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, nargs="?", help="the root of the parent's checkout")
    ap.add_argument("change", type=Path, nargs="?", default=ROOT, help="the root of the change's checkout")
    ap.add_argument("--variants", action="store_true", help="the change's other launches at B = 32 to 128")
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side is not None:
        return side(args.side.resolve(), args.out, args.variants)
    if args.parent is None:
        ap.error("the parent's checkout is needed")

    import torch

    if not torch.cuda.is_available():
        print("ab_ring: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    same = lambda a, b: torch.equal(a[1], b[1]) and torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    times, answers = {}, {}
    for turn, name in enumerate(("parent", "change", "change", "parent")):
        out = ROOT / "build" / "ab" / f"{turn}-{name}.pt"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--side", str(trees[name]), "--out", str(out)]
        if args.variants and name == "change":
            cmd.append("--variants")
        subprocess.run(cmd, check=True, timeout=900)
        for what, ms in json.loads(out.with_suffix(".json").read_text()).items():
            times.setdefault((name, what), []).append(ms)
        got = torch.load(out)
        first = answers.setdefault(name, got)
        for what, x in got.items():   # each side's second turn gives its first turn's answers
            if not same(first[what], x):
                raise AssertionError(f"{what}: the {name}'s two turns disagree")
    parent, change = answers["parent"], answers["change"]
    for what, got in change.items():
        base = parent.get(what) or parent[what.removesuffix(" a block a group")]
        if not same(base, got):
            raise AssertionError(f"{what}: the parent's and the change's answers differ")
        line = f"ab_ring {what}: "
        if what in parent:
            line += "parent " + " / ".join(f"{t:.3f}" for t in times["parent", what]) + " ms, "
        print(line + "change " + " / ".join(f"{t:.3f}" for t in times["change", what])
              + " ms; answers equal bit for bit", flush=True)
    print("ab_ring csrc sha256: " + ", ".join(f"{name} {csrc_digest(tree)}" for name, tree in trees.items()),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
