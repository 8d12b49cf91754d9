#!/usr/bin/env python3
"""Time the ring's tensor-map paths from two checkouts in turns on one
card, and hold their answers equal bit for bit: B1 (``mips_topk``) at
k = 100 and ``topk_large`` at k = 4096, D = 768, at B = 1, 16, 32, 64 and
128; B2 (``fused_topk``) at k = 100, B = 16, 64 and 128; B4
(``sparse_dense.fused_score``) at B = 16, 64 and 128; ``topk_large`` over
the fused space at k = 4096, B = 16.  Each side runs in a process of its
own, through its own checkout's wrappers and kernels (so the two may
differ in their C entry points), in the order parent, change, change,
parent.

    git archive <parent> src | tar -x -C build/parent
    python3 tools/ab_ring.py build/parent

The first argument is the root of the parent's checkout (holding
``src/``); the second (default: this checkout's root) the change's.  With
``--variants`` the change's side also times B1 and ``topk_large`` at B =
32, 64 and 128 launched as a block a group (``cluster=False``), and B2 at
B = 32, 64, 96, 128, 129 and 200 both in clusters (``cluster=True``) and
a block a group, its answers equal too, after every run that both sides
make (so that those find both processes in the same state); with
``--fused-only`` both sides time the fused paths alone (B2, B4,
``topk_large`` fused), as when the "parent" is a variant of the change's
own tree; ``--only REGEX`` keeps the runs whose names match (both sides
draw the same data all the same).  For every ``dense_kernel`` and
``fused_kernel`` that both sides built: ptxas's registers and spill
bytes, and whether the kernel's SASS is the same on both, its addresses
and encodings left out (``cuobjdump -sass``).  The corpus is 8,841,823
random rows of 768 f32 and 128 COO slots (ids over 30,522 terms, f32
values; MS MARCO passage scale, 36.2 GB, made on the card from a seed,
the same in every process), the queries random dense rows and 32 terms
each; each time is the median of CUDA events over 5 calls (3 for
``topk_large``, B2 and B4).  B4's [B, N] scores are compared by their
SHA-256; where the parent's differ from the change's, the first two
queries' scores over the first 65,536 rows show by how many ULPs (a sum
taken in another order), and the run goes on.  Needs one card and
``nvcc``; each side builds into its checkout's ``build/`` and the
answers go to ``build/ab/`` (both gitignored).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, D, V, NNZ, NNZ_Q = 8_841_823, 768, 30_522, 128, 32
BATCHES = (16, 1, 32, 64, 128)
VARIANT_BATCHES = (32, 64, 128)
FUSED_BATCHES = (16, 64, 128)
B2_SWEEP = (32, 64, 96, 128, 129, 200)   # --variants: B2 in clusters beside a block a group
KERNELS = re.compile(r"(dense|fused)_kernel")


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


def scores_print(torch, s):
    """B4's [B, N] scores as (SHA-256 of their bytes, the first two queries' first 65,536 scores)."""
    return hashlib.sha256(s.cpu().numpy().tobytes()).hexdigest(), s[:2, :65536].cpu()


def kernel_reports(build, names) -> dict:
    """For each ``dense_kernel`` / ``fused_kernel`` entry of the libraries
    ``names`` built in this process's checkout: (registers, spill bytes
    stored, SHA-256 of its SASS without addresses and encodings), by its
    demangled name with every namespace left out (the two sides may
    declare a type in another one)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    filt = shutil.which("cu++filt") or shutil.which("c++filt") or "/usr/local/cuda/bin/cu++filt"
    ptxas, sass = {}, {}
    for name in names:
        lib = build._library_path(name)
        current = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
            if m:
                current = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and current:
                ptxas.setdefault(current, [None, None])[1] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and current:
                ptxas.setdefault(current, [None, None])[0] = int(m.group(1))
        try:
            dump = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True, text=True,
                                  timeout=300).stdout
        except (OSError, subprocess.SubprocessError):
            dump = ""
        current = None
        for line in dump.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = m.group(1)
                sass[current] = hashlib.sha256()
                continue
            text = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
            if current and text and not text.startswith("."):
                sass[current].update(text.encode() + b"\n")
    out = {}
    for mangled in sorted(set(ptxas) | set(sass)):
        if not KERNELS.search(mangled):
            continue
        try:
            nice = subprocess.run([filt, mangled], check=True, capture_output=True, text=True,
                                  timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            nice = mangled
        regs, spills = ptxas.get(mangled, [None, None])
        out[re.sub(r"\b[A-Za-z_]\w*::", "", nice)] = (regs, spills, sass[mangled].hexdigest()[:16] if mangled in sass
                                           else "not dumped")
    return out


def side(root: Path, out: Path, variants: bool, fused_only: bool, only: str | None) -> int:
    """One process: this side's checkout's kernels timed, answers saved."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import sparse_dense as sd
    from repro_torch.kernels import topk_large as lk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    corpus = torch.randn(N, D, generator=g, device=dev)
    idx = torch.randint(1, V, (N, NNZ), generator=g, device=dev, dtype=torch.int32)
    val = torch.rand(N, NNZ, generator=g, device=dev)
    runs, extra = {}, {}   # extra: the change's variants, timed after the runs both sides make
    for b in BATCHES + tuple(x for x in B2_SWEEP if x not in BATCHES):   # the same draws on every side
        q = torch.randn(b, D, generator=g, device=dev)
        if not fused_only and b in BATCHES:
            runs[f"B={b} b1 k=100"] = (lambda q=q: mk.mips_topk(q, corpus, 100), 5)
            runs[f"B={b} topk_large k=4096"] = (lambda q=q: lk.topk_large(None, q, None, None, corpus, 4096), 3)
        qi = torch.randint(1, V, (b, NNZ_Q), generator=g, device=dev)
        table = torch.zeros(b, V + 1, device=dev).scatter_add_(1, qi, torch.rand(b, NNZ_Q, generator=g, device=dev))
        fused = (table, q, idx, val, corpus)
        if b in FUSED_BATCHES:
            runs[f"B={b} b2 k=100"] = (lambda a=fused: fk.fused_topk(*a, 100, w_dense=0.6, w_sparse=0.4), 3)
            runs[f"B={b} b4"] = (lambda a=fused: sd.fused_score(*a, 0.6, 0.4), 3)
            if b == 16:
                runs[f"B={b} topk_large fused k=4096"] = (
                    lambda a=fused: lk.topk_large(*a, 4096, w_dense=0.6, w_sparse=0.4), 3)
        if variants and b in B2_SWEEP:
            for tag, cl in (("in clusters", True), ("a block a group", False)):
                extra[f"B={b} b2 k=100 {tag}"] = (
                    lambda a=fused, cl=cl: fk.fused_filter(*a, 100, w_dense=0.6, w_sparse=0.4, cluster=cl)[:2], 3)
        if variants and b in VARIANT_BATCHES and not fused_only:
            extra[f"B={b} b1 k=100 a block a group"] = (
                lambda q=q: mk.mips_filter(q, corpus, 100, cluster=False)[:2], 5)
            extra[f"B={b} topk_large k=4096 a block a group"] = (
                lambda q=q: lk.topk_large(None, q, None, None, corpus, 4096, cluster=False), 3)
    runs.update(extra)
    if only is not None:
        runs = {what: run for what, run in runs.items() if re.search(only, what)}
    times, answers = {}, {}
    for what, (fn, reps) in runs.items():
        got = fn()
        answers[what] = scores_print(torch, got) if " b4" in what else (got[0].cpu(), got[1].cpu())
        del got
        times[what] = cuda_ms(torch, fn, reps)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(answers, out)
    out.with_suffix(".json").write_text(json.dumps(times))
    libs = [name for name in ("mips_topk", "topk_large", "fused_topk", "fused_score") if name in _build._LIBS]
    out.with_suffix(".kernels.json").write_text(json.dumps(kernel_reports(_build, libs)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, nargs="?", help="the root of the parent's checkout")
    ap.add_argument("change", type=Path, nargs="?", default=ROOT, help="the root of the change's checkout")
    ap.add_argument("--variants", action="store_true", help="the change's other launches at B = 32 to 128")
    ap.add_argument("--fused-only", action="store_true", help="B2, B4 and topk_large fused alone")
    ap.add_argument("--only", help="time only the runs whose names match this regular expression")
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side is not None:
        return side(args.side.resolve(), args.out, args.variants, args.fused_only, args.only)
    if args.parent is None:
        ap.error("the parent's checkout is needed")

    import torch

    if not torch.cuda.is_available():
        print("ab_ring: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    def same(a, b):
        if isinstance(a[0], str):   # B4's scores: their SHA-256
            return a[0] == b[0]
        return torch.equal(a[1], b[1]) and torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))

    def ulps(a, b):
        """Where B4's scores differ: how many of the first rows' scores, by how many ULPs at most."""
        x, y = a[1].view(torch.int32).long(), b[1].view(torch.int32).long()
        x, y = torch.where(x < 0, -2 ** 31 - x, x), torch.where(y < 0, -2 ** 31 - y, y)   # ordered as floats
        return int((x != y).sum()), int((x - y).abs().max())

    times, answers = {}, {}
    for turn, name in enumerate(("parent", "change", "change", "parent")):
        out = ROOT / "build" / "ab" / f"{turn}-{name}.pt"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--side", str(trees[name]), "--out", str(out)]
        if args.variants and name == "change":
            cmd.append("--variants")
        if args.fused_only:
            cmd.append("--fused-only")
        if args.only is not None:
            cmd += ["--only", args.only]
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
        stem = re.sub(r" (a block a group|in clusters)$", "", what)
        base = parent.get(what) or parent.get(stem) or change.get(stem) or change[f"{stem} in clusters"]
        verdict = "answers equal bit for bit"
        if not same(base, got):
            if not isinstance(got[0], str):
                raise AssertionError(f"{what}: the parent's and the change's answers differ")
            n, most = ulps(base, got)
            verdict = (f"scores differ from the parent's: {n} of the first 2 x 65,536 by at most {most} ULPs "
                       "(another order of sums)")
        line = f"ab_ring {what}: "
        if what in parent:
            line += "parent " + " / ".join(f"{t:.3f}" for t in times["parent", what]) + " ms, "
        print(line + "change " + " / ".join(f"{t:.3f}" for t in times["change", what]) + f" ms; {verdict}",
              flush=True)
    reports = {name: json.loads((ROOT / "build" / "ab" / f"{turn}-{name}.kernels.json").read_text())
               for turn, name in ((0, "parent"), (1, "change"))}
    for kernel in sorted(set(reports["parent"]) & set(reports["change"])):
        (pr, ps, psass), (cr, cs, csass) = reports["parent"][kernel], reports["change"][kernel]
        print(f"ab_ring kernel {kernel}: parent {pr} registers, {ps} bytes spilled; change {cr} registers, {cs} "
              f"bytes spilled; " + ("the same SASS" if psass == csass != "not dumped" else
                                    f"SASS {psass} / {csass}"), flush=True)
    print("ab_ring kernels built on one side only: " + ", ".join(
        f"{name} {len(set(reports[name]) - set(reports[other]))}"
        for name, other in (("parent", "change"), ("change", "parent"))), flush=True)
    print("ab_ring csrc sha256: " + ", ".join(f"{name} {csrc_digest(tree)}" for name, tree in trees.items()),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
