"""Roofline terms on one H100 (counterpart of ``repro/launch/roofline.py``):
the serving scan's cost model, and the dry run's terms of a traced step.

The reference's constants describe a TPU v5e; these describe the card the
port runs on, each with its source.  The reference reads its dry-run
counts from compiled XLA (``compiled.cost_analysis()`` and the optimized
HLO text); PyTorch compiles no HLO, so the port counts one rank's
program as it runs under ``FakeTensorMode`` (:class:`Tracer`, which
records a :class:`Trace`): matmul FLOPs by operand dtype, the bytes every
dispatched op reads and writes, the bytes of each collective by the
reference's five kinds, and the peak of the bytes its tensors hold.
``collective_bytes_from_hlo`` stays, to read HLO text such as the
reference's ``--save-hlo`` output.

The collective term divides by NVLink 4 (:data:`NVLINK_BW` a link a
direction, :data:`NVLINK_LINKS` links a GPU), the counterpart of the
reference's ICI constants.  NVLink joins the 8 GPUs of one node; the
production meshes span 256 and 512 GPUs, so their ``"data"`` and
``"pod"`` axes, and the ``"model"`` axis of 16, cross nodes (InfiniBand,
a fraction of NVLink's rate): there the term is a lower bound.
"""

from __future__ import annotations

import dataclasses
import re
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW", "NVLINK_LINKS", "SMEM_BYTES",
           "topk_tile_seconds", "serving_scan_seconds", "serving_visit_seconds",
           "collective_bytes_from_hlo", "Roofline", "analyze_terms", "cost_dict", "analyze",
           "model_flops_for", "Trace", "Tracer", "peak_flops"]

# NVIDIA H100 SXM data sheet: f32 on the CUDA cores (the scan kernels run
# with TF32 off), dense rate, at the full 700 W power limit.
PEAK_FLOPS = 67e12
# NVIDIA H100 SXM data sheet: bf16 (and f16) on the tensor cores, dense
# (without sparsity), at the full 700 W power limit.
PEAK_FLOPS_BF16 = 989.4e12
# NVIDIA H100 SXM data sheet: HBM3 bandwidth.
HBM_BW = 3.35e12
# CUDA C++ Programming Guide, compute capability 9.0: shared memory one
# thread block may use (of the SM's 228 KB), the on-chip working set a
# tile has to fit, where the TPU model had its VMEM.
SMEM_BYTES = 227 * 1024
# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s a GPU both directions
# over 18 links, so 25 GB/s a link a direction.
NVLINK_BW = 25e9
NVLINK_LINKS = 18


def topk_tile_seconds(tile_n: int, *, b: int, k: int, bytes_per_row: float,
                      flops_per_row: float) -> float:
    """Roofline seconds for ONE corpus tile of a score + select scan:
    ``tile_n`` rows streamed from HBM (``bytes_per_row`` each) and scored
    (``flops_per_row`` each), then folded into the running top-k with K
    rounds of compare and select over the ``[B, K + tile_n]``
    concatenation.  The tile's time is the larger of the compute and the
    HBM term, the quantity ``core.backends.auto_tile_n`` minimises per
    corpus row."""
    compute = (flops_per_row * tile_n + b * k * (k + tile_n)) / PEAK_FLOPS
    memory = (bytes_per_row * tile_n) / HBM_BW
    return max(compute, memory)


def serving_scan_seconds(n_rows: int, *, b: int, k: int, bytes_per_row: float,
                         flops_per_row: float, tile_n: Optional[int] = None,
                         n_shards: int = 1) -> float:
    """Roofline seconds for one batched exact top-k scan over ``n_rows``
    rows, split across ``n_shards`` scanned in parallel (the slowest
    shard sets the scan term), each shard streamed in ``tile_n``-row tiles
    (:func:`topk_tile_seconds` per tile), and the per-shard lists merged
    afterwards (a ``[B, K * n_shards]`` select).  ``bytes_per_row``
    carries the corpus residency dtype."""
    if n_rows <= 0:
        return 0.0
    n_shards = max(1, int(n_shards))
    shard_rows = -(-n_rows // n_shards)          # ceil
    if tile_n is None or tile_n <= 0:
        tile_n = min(shard_rows, 8192)
    tile_n = min(tile_n, shard_rows)
    n_tiles = -(-shard_rows // tile_n)
    scan = n_tiles * topk_tile_seconds(tile_n, b=b, k=k,
                                       bytes_per_row=bytes_per_row,
                                       flops_per_row=flops_per_row)
    merge = (b * k * n_shards * (k + 1.0)) / PEAK_FLOPS if n_shards > 1 else 0.0
    return scan + merge


def serving_visit_seconds(n_visits: float, *, b: int, bytes_per_row: float,
                          flops_per_visit: float) -> float:
    """Roofline seconds for a batched graph traversal that scores
    ``n_visits`` candidates per query: the rows are gathered, not
    streamed, so every visit pays its full ``bytes_per_row`` from HBM."""
    if n_visits <= 0:
        return 0.0
    compute = (b * n_visits * flops_per_visit) / PEAK_FLOPS
    memory = (b * n_visits * bytes_per_row) / HBM_BW
    return max(compute, memory)


# ---------------------------------------------------------------------------
# The dry run's terms (the reference's HLO half).
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "token": 0, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """Total bytes of an HLO shape string like 'bf16[8,128]{1,0}' or a tuple
    '(f32[4], f32[4])'."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, int]:
    """Sum per-op-kind output bytes of the collective ops in HLO text (an
    op's ``-start`` form counts as the op); each op counted once, as the
    reference counts it."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        m = re.match(r"%?[\w.\-]+ = (.+?) ([a-z\-]+)\(", line.strip())
        if not m:
            continue
        op = m.group(2)
        # the reference's test: ``op.rstrip("-start")`` strips characters, not the suffix
        if op in _COLLECTIVES or op.rstrip("-start") in _COLLECTIVES:
            key = op[:-6] if op.endswith("-start") else op
            if key in out:
                out[key] += _shape_bytes(m.group(1))
    return out


# Peak dense rates by operand dtype (data sheet, as above); an op of any
# other dtype runs at the f32 rate.
_PEAK_BY_DTYPE = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16}


def peak_flops(dtype: str) -> float:
    """The card's dense rate for matmul operands of ``dtype`` (a torch
    dtype's name, ``"bfloat16"``)."""
    return _PEAK_BY_DTYPE.get(dtype, PEAK_FLOPS)


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    per_collective: Dict[str, int]
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None
    # resident-traffic lower bound: every live byte touched once a step.
    # ``bytes_accessed`` counts every eager op's operands and results, an
    # upper bound on HBM traffic (an op's operands may stay in L2).
    memory_lower_bytes: Optional[float] = None
    memory_lower_s: Optional[float] = None
    bottleneck_lower: Optional[str] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze_terms(flops: float, bytes_accessed: float, per_collective: Dict[str, int], n_chips: int,
                  model_flops: Optional[float] = None, resident_bytes: Optional[float] = None,
                  flops_by_dtype: Optional[Dict[str, float]] = None) -> Roofline:
    """Roofline terms from (possibly layer-corrected) per-device counts.

    The compute term divides each dtype's FLOPs by the card's rate for it
    (:func:`peak_flops`; without ``flops_by_dtype``, all of ``flops`` at
    the bf16 rate, the reference's assumption); the memory term the bytes
    by HBM's; the collective term the collectives' output bytes by every
    NVLink link of the GPU (a lower bound across nodes: see the module's
    docstring).  ``model_flops`` is the GLOBAL analytic count, so the
    useful-compute ratio compares it against ``flops * n_chips``."""
    coll = float(sum(per_collective.values()))
    if flops_by_dtype:
        compute_s = sum(f / peak_flops(dt) for dt, f in flops_by_dtype.items())
    else:
        compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll / (NVLINK_LINKS * NVLINK_BW)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = (model_flops / (flops * n_chips)) if (model_flops and flops) else None
    mem_lo_s = (resident_bytes / HBM_BW) if resident_bytes else None
    bottleneck_lo = None
    if mem_lo_s is not None:
        terms_lo = {"compute": compute_s, "memory": mem_lo_s, "collective": collective_s}
        bottleneck_lo = max(terms_lo, key=terms_lo.get)
    return Roofline(flops, bytes_accessed, coll, n_chips, compute_s, memory_s, collective_s, bottleneck,
                    dict(per_collective), model_flops, useful, resident_bytes, mem_lo_s, bottleneck_lo)


def cost_dict(trace: "Trace") -> dict:
    """``{"flops", "bytes accessed"}`` of a :class:`Trace` (the keys of
    XLA's ``cost_analysis()``, which the reference reads here)."""
    return {"flops": float(trace.flops), "bytes accessed": float(trace.bytes_accessed)}


def analyze(trace: "Trace", n_chips: int, model_flops: Optional[float] = None,
            hlo_text: Optional[str] = None) -> Roofline:
    """:func:`analyze_terms` of one traced call; ``hlo_text``, when given,
    supplies the collective bytes instead (the reference's HLO text)."""
    cost = cost_dict(trace)
    per = collective_bytes_from_hlo(hlo_text) if hlo_text is not None else dict(trace.per_collective)
    return analyze_terms(cost["flops"], cost["bytes accessed"], per, n_chips, model_flops,
                         flops_by_dtype=trace.flops_by_dtype)


def model_flops_for(cfg, shape) -> Optional[float]:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D forward (dense); active
    params for MoE; per-family analytic counts otherwise (the reference's
    arithmetic)."""
    fam = getattr(cfg, "family", "lm")
    if fam == "lm":
        n_active = cfg.active_param_count()
        if shape.kind == "train":
            tokens = shape.seq_len * shape.global_batch
            return 6.0 * n_active * tokens
        if shape.kind == "prefill":
            tokens = shape.seq_len * shape.global_batch
            return 2.0 * n_active * tokens
        # decode: one token per sequence + attention over the cache
        tokens = shape.global_batch
        attn = (2.0 * cfg.n_layers * shape.global_batch * shape.seq_len *
                cfg.padded_heads * cfg.resolved_head_dim * 2)
        return 2.0 * n_active * tokens + attn
    if fam == "gnn":
        d = cfg.d_hidden
        if shape.kind == "batched":
            e = shape.n_edges * shape.batch_graphs
            n = shape.n_nodes * shape.batch_graphs
        elif shape.kind == "sampled":
            f1, f2 = shape.fanout
            e = shape.batch_nodes * (f1 + f1 * f2)
            n = shape.batch_nodes * (1 + f1 + f1 * f2)
        else:
            e, n = shape.n_edges, shape.n_nodes
        per_inter = 2.0 * (e * d + n * 3 * d * d + e * cfg.n_rbf * d)
        return 3.0 * cfg.n_interactions * per_inter
    # recsys: embedding bytes dominate; FLOPs = MLP + interaction
    b = shape.batch if shape.kind != "retrieval" else 1
    flops = 0.0
    dims = list(cfg.mlp)
    for a, bdim in zip(dims[:-1], dims[1:]):
        flops += 2.0 * b * a * bdim
    if cfg.seq_len:
        flops += 2.0 * b * cfg.seq_len * cfg.embed_dim * cfg.embed_dim * 4
    if shape.kind == "retrieval":
        flops += 2.0 * shape.n_candidates * cfg.embed_dim
    mult = 3.0 if shape.kind == "train" else 1.0
    return mult * flops


# ---------------------------------------------------------------------------
# The tracer: one rank's program, counted as it runs.
# ---------------------------------------------------------------------------

# c10d's ops (in place: the first argument holds the result) and the
# functional collectives (the result is returned), by the reference's
# kinds.  Broadcast and point-to-point sends move a tensor between ranks
# as a collective-permute does.  The port's ``reduce_scatter`` is an
# all-to-all and a sum, so it is booked as an all-to-all.
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute", "recv_": "collective-permute",
}
_FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}


@dataclasses.dataclass
class Trace:
    """What one rank's call did (:class:`Tracer`): matmul FLOPs by operand
    dtype (``torch.utils.flop_counter``'s formulas), the bytes every
    dispatched op reads and writes (operands and results; views, metadata
    queries, tensors on the meta device and collectives move none here),
    each collective kind's output bytes, and the bytes of tensor storages
    the call allocated: the most held at once (``peak_bytes``) and those
    still held at its end (``live_bytes``)."""

    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_accessed: float = 0.0
    per_collective: Dict[str, int] = dataclasses.field(default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    peak_bytes: int = 0
    live_bytes: int = 0
    ops: int = 0

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def collective_bytes(self) -> int:
        return int(sum(self.per_collective.values()))

    def counts(self) -> dict:
        """The additive counts: ``{"flops:<dtype>", "bytes", "coll:<kind>"}``."""
        out = {f"flops:{k}": float(v) for k, v in self.flops_by_dtype.items()}
        out["bytes"] = float(self.bytes_accessed)
        out.update((f"coll:{k}", float(v)) for k, v in self.per_collective.items())
        return out

    @classmethod
    def from_counts(cls, counts: dict) -> "Trace":
        t = cls()
        for k, v in counts.items():
            if k.startswith("flops:"):
                t.flops_by_dtype[k[6:]] = v
            elif k.startswith("coll:"):
                t.per_collective[k[5:]] = v
            else:
                t.bytes_accessed = v
        return t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors in an op's arguments or results (nested tuples, lists
    and dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


class Tracer(TorchDispatchMode):
    """A dispatch mode that counts one rank's call into :attr:`trace`.

    Enter it inside the ``FakeTensorMode`` the arguments were made in (or
    around real tensors: it counts the same way).  A ``DTensor`` op is
    left to ``DTensor``, whose ops on the local blocks, and whose
    collectives, come back here, so every count is this rank's.  A
    storage counts as allocated from the op that first returns it (and
    did not write it in place: an operand's storage is not new) to its
    release (a weak reference's callback); the arguments' storages, made
    before, are not counted."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        self._storages = {}     # id -> a weak reference that releases the storage's bytes
        self._live = 0
        self._ops = {}          # op -> (its namespace's role, collective kind, FLOP formula)

    def _release(self, key, n):
        self._storages.pop(key, None)
        self._live -= n

    def _hold(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        ref = self._storages.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self._storages[key] = weakref.ref(st, lambda _, key=key, n=n: self._release(key, n))
        self._live += n
        if self._live > self.trace.peak_bytes:
            self.trace.peak_bytes = self._live

    def _op(self, func):
        info = self._ops.get(func)
        if info is None:
            ns = func.namespace
            if ns == "c10d":
                info = ("c10d", _C10D_KINDS.get(func._opname), None)
            elif ns in ("_c10d_functional", "c10d_functional"):
                info = ("functional", _FUNCTIONAL_KINDS.get(func._opname), None)
            elif func.is_view or ns == "prim":
                info = ("none", None, None)
            else:
                info = ("op", None, _flop_registry().get(func.overloadpacket))
            self._ops[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        tr = self.trace
        tr.ops += 1
        role, kind, formula = self._op(func)
        if role == "none":
            return out      # a view or a metadata query: no bytes move
        if role == "c10d":
            if kind is not None:
                tr.per_collective[kind] += sum(_nbytes(t) for t in _tensors(args[0]))
            return out
        outs = list(_tensors(out))
        if role == "functional":
            if kind is not None:
                tr.per_collective[kind] += sum(_nbytes(t) for t in outs)
            for t in outs:
                self._hold(t)
            return out
        if not outs or outs[0].device.type == "meta":
            return out      # a query, or shapes alone
        ins = list(_tensors(args))
        if kwargs:
            ins += _tensors(kwargs)
        tr.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        written = {id(t.untyped_storage()) for t in ins}    # in place: into an operand's storage
        for t in outs:
            if id(t.untyped_storage()) not in written:
                self._hold(t)
        if formula is not None:
            operand = next((t for t in ins if t.dim() >= 2), ins[0])
            dt = str(operand.dtype).replace("torch.", "")
            tr.flops_by_dtype[dt] = tr.flops_by_dtype.get(dt, 0) + formula(*args, **kwargs, out_val=out)
        return out

    def __exit__(self, *exc):
        self.trace.live_bytes = self._live
        return super().__exit__(*exc)


def _flop_registry():
    from torch.utils.flop_counter import flop_registry

    return flop_registry
