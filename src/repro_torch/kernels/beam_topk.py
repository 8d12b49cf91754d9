"""Graph-ANN hops through the CUDA kernel in ``csrc/beam_hop.cu``
(``beam_hop_launch``): :func:`beam_hop`, one hop, the counterpart of
``repro/kernels/beam_topk.py: beam_hop_pallas``, and :func:`beam_search`,
a whole traversal in one launch, the counterpart of ``beam_search_pallas``;
plus the packed visited-mask helpers.

A hop gathers the ``ef * R`` neighbours of the beam, tests them against
the packed visited mask, drops in-hop duplicates (first occurrence by
position wins, valid or not), scores the survivors with the fused
kernel's arithmetic, merges them into the top-``ef`` beam and emits
``(word, addend)`` mark-deltas; a traversal commits each hop's deltas
before the next.

The visited mask is ``int32[B, ceil(N/32)]`` holding the bit patterns of
the reference's ``uint32`` words (``torch.uint32`` has only partial
operator support): bit 31 is ``INT32_MIN``, and adding disjoint bits
equals or-ing them, so a commit is one ``scatter_add_``.  At the numpy
boundary ``.view(np.uint32)`` turns one into the other.

For tensors on the CPU the wrappers run the plain version
(``ref.beam_hop_plain``, hop by hop); for CUDA tensors they launch the
kernel or raise.  ``launches`` counts kernel launches, nowhere else: one
per :func:`beam_hop` call and one per :func:`beam_search` call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.fused_topk import _weights
from repro_torch.kernels.mips_topk import _DTYPES, ptr, require_cuda

# Cap on the hop's candidate block C = ef * R: repro's VMEM-derived cap,
# so the port accepts and refuses exactly the budgets the reference does.
# A query's state (about 50 bytes per candidate) stays in the leader
# block's shared memory up to about C = 4096 and moves to a global
# scratch buffer beyond.
MAX_BEAM_CANDIDATES = 32768

launches = 0


def visited_words(n: int) -> int:
    """32-bit words per query row in the packed visited mask."""
    return (n + 31) // 32


def check_beam_budget(ef: int, r: int):
    """Refuse candidate blocks beyond the kernel's budget."""
    if ef * r > MAX_BEAM_CANDIDATES:
        raise ValueError(
            f"beam candidate block ef*R = {ef}*{r} = {ef * r} exceeds the "
            f"kernel budget {MAX_BEAM_CANDIDATES} (the reference's cap on a "
            "hop's candidate block); lower ef or the graph degree")


def bit_i32(bits: torch.Tensor) -> torch.Tensor:
    """``1 << bits`` (bits in [0, 32)) as the int32 bit pattern of the
    uint32 word: bit 31 becomes ``INT32_MIN``."""
    one = torch.ones_like(bits, dtype=torch.int64) << bits.long()
    return torch.where(one >= 1 << 31, one - (1 << 32), one).to(torch.int32)


def mark_visited(visited: torch.Tensor, ids: torch.Tensor,
                 n_valid: int) -> torch.Tensor:
    """A new mask: ``visited`` (int32[B, W]) with the bits of ``ids``
    (int32[B, K]) set; ids outside [0, n_valid) are ignored and repeated
    ids tolerated (or-semantics)."""
    ok = (ids >= 0) & (ids < n_valid)
    key, _ = torch.where(ok, ids.clamp(0, n_valid - 1), -1).sort(dim=1)
    first = torch.ones_like(key, dtype=torch.bool)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    safe = key.clamp(min=0)
    word = (safe >> 5).long()
    bit = bit_i32(safe & 31)
    fresh = (torch.gather(visited, 1, word) & bit) == 0
    add = torch.where(first & (key >= 0) & fresh, bit, torch.zeros_like(bit))
    return visited.scatter_add(1, word, add)


def unpack_visited(visited: torch.Tensor, n: int) -> torch.Tensor:
    """bool[B, N] view of the packed mask (test and oracle helper)."""
    b, w = visited.shape
    shifts = torch.arange(32, dtype=torch.int32, device=visited.device)
    bits = (visited[:, :, None] >> shifts) & 1
    return bits.reshape(b, w * 32)[:, :n].bool()


def _declare(lib):
    fn = lib.beam_hop_launch
    if fn.argtypes is None:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [v, i, v, i, v, v, i, i, v, i, v, i, v, v, i, i, v, i, i,
                       i, i, f, f, i, i, v, v, v, v, v, v]
        fn.restype = ctypes.c_int
        lib.beam_hop_scratch_bytes.argtypes = [i, i]
        lib.beam_hop_scratch_bytes.restype = ctypes.c_longlong
    return fn


def scratch_bytes(ef: int, r: int) -> int:
    """Bytes of global scratch per query that a launch with beam ``ef``
    and degree ``r`` takes: 0 while a query's state fits the leader
    block's shared memory.  Loads the CUDA library."""
    lib = _build.load("beam_hop")
    _declare(lib)
    return int(lib.beam_hop_scratch_bytes(ef, r))


def _check(c_idx, c_dense, beam_s, neighbors, w_dense, w_sparse, dense_kind):
    """The refusals both wrappers share; returns (weighted, w_dense,
    w_sparse) as the launch takes them."""
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    if not (has_dense or has_sparse):
        raise ValueError("beam_hop: no components to score")
    if has_sparse and dense_kind != "ip":
        raise ValueError("beam_hop: sparse/fused traversal supports "
                         "dense_kind='ip' only (like fused_topk)")
    if dense_kind not in ("ip", "l2"):
        raise ValueError(f"beam_hop serves dense ip/l2, not {dense_kind!r}")
    weights = _weights(w_dense, w_sparse, has_dense, has_sparse)
    check_beam_budget(beam_s.shape[1], neighbors.shape[1])
    if neighbors.device.type not in ("cpu", "cuda"):
        raise ValueError(f"beam_hop runs on cpu or cuda, not {neighbors.device}")
    return weights


def _launch(qdensified, q_dense, beam_s, beam_i, visited, neighbors, c_idx,
            c_val, c_dense, n_valid: int, weights, dense_kind: str, hops: int,
            commit: bool):
    """One launch of ``hops`` hops for CUDA tensors: ``(beam_s, beam_i,
    words, addend)``; with ``commit`` the hops update ``visited`` in
    place and words/addend are None."""
    global launches
    has_dense, has_sparse = c_dense is not None, c_idx is not None
    weighted, wd, ws = weights
    dev = neighbors.device
    b, ef = beam_s.shape
    r = neighbors.shape[1]
    n = int(n_valid)
    c = ef * r
    w = visited_words(n)
    require_cuda("beam_s", beam_s, (torch.float32,), 2, dev)
    require_cuda("beam_i", beam_i, (torch.int32,), 2, dev)
    require_cuda("visited", visited, (torch.int32,), 2, dev)
    require_cuda("neighbors", neighbors, (torch.int32,), 2, dev)
    if beam_i.shape != (b, ef) or visited.shape != (b, w):
        raise ValueError(f"beam {tuple(beam_i.shape)} / visited "
                         f"{tuple(visited.shape)} do not fit B={b}, ef={ef}, "
                         f"W={w}")
    if not 1 <= n <= neighbors.shape[0]:
        raise ValueError(f"n_valid={n} outside 1..{neighbors.shape[0]} "
                         "graph rows")
    qd = qdt = None
    d = nnz = vp1 = 0
    if has_dense:
        qdt = q_dense.float().contiguous()     # upcast before the first multiply
        require_cuda("q_dense", qdt, (torch.float32,), 2, dev)
        require_cuda("c_dense", c_dense, _DTYPES, 2, dev)
        d = c_dense.shape[1]
        if qdt.shape != (b, d) or c_dense.shape[0] < n:
            raise ValueError("dense shapes disagree: q_dense "
                             f"{tuple(qdt.shape)}, c_dense {tuple(c_dense.shape)}")
    if has_sparse:
        qd = qdensified.float().contiguous()
        require_cuda("qdensified", qd, (torch.float32,), 2, dev)
        require_cuda("c_idx", c_idx, (torch.int32,), 2, dev)
        require_cuda("c_val", c_val, _DTYPES, 2, dev)
        nnz, vp1 = c_idx.shape[1], qd.shape[1]
        if c_val.shape != c_idx.shape or c_idx.shape[0] < n or qd.shape[0] != b:
            raise ValueError("sparse shapes disagree: qdensified "
                             f"{tuple(qd.shape)}, c_idx {tuple(c_idx.shape)}, "
                             f"c_val {tuple(c_val.shape)}")
    fn = _declare(_build.load("beam_hop"))
    per_query = scratch_bytes(ef, r)
    scratch = (torch.empty((b, per_query), dtype=torch.uint8, device=dev)
               if per_query else None)
    out_s = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, ef), dtype=torch.int32, device=dev)
    words = addend = None
    if not commit:
        words = torch.empty((b, c), dtype=torch.int32, device=dev)
        addend = torch.empty((b, c), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(qd), vp1, ptr(qdt), d, ptr(beam_s), ptr(beam_i), b, ef,
                 ptr(visited), w, ptr(neighbors), r,
                 ptr(c_idx if has_sparse else None),
                 ptr(c_val if has_sparse else None),
                 int(has_sparse and c_val.dtype == torch.bfloat16), nnz,
                 ptr(c_dense), int(has_dense and c_dense.dtype == torch.bfloat16),
                 n, int(dense_kind == "l2"), int(weighted), wd, ws, int(hops),
                 int(commit), ptr(scratch),
                 ptr(out_s), ptr(out_i), ptr(words), ptr(addend),
                 ctypes.c_void_p(stream))
        _build.check(err, "beam_hop_launch")
        launches += 1
    return out_s, out_i, words, addend


def beam_hop(qdensified, q_dense, beam_s, beam_i, visited, neighbors,
             c_idx, c_val, c_dense, *, n_valid: int, w_dense=None,
             w_sparse=None, dense_kind: str = "ip"):
    """One hop: ``(beam_s f32[B, ef], beam_i i32[B, ef], words i32[B, C],
    addend i32[B, C])``, C = ef * R.

    ``beam_s``/``beam_i`` are the running beam (any order), with sentinel
    slots (id outside [0, n_valid)) scoring f32-min.  ``visited``
    int32[B, ceil(n_valid/32)] is read only: commit the deltas with
    ``visited.scatter_add_(1, words.long(), addend)``.  ``neighbors``
    i32[N, R].  Components follow ``fused_topk``: ``qdensified`` [B, V+1]
    (zero trash column) with ``c_idx``/``c_val`` [N, NNZ], ``q_dense``
    [B, Dd] with ``c_dense`` [N, Dd]; ``None`` drops a part; sparse and
    fused spaces take ``dense_kind='ip'`` only.  A candidate is valid iff
    its beam slot and its own id lie in [0, n_valid), its bit is clear and
    no earlier position of the hop's raw candidate list holds the same id;
    invalid ones score f32-min with id ``n_valid`` and get a zero addend.
    The merge keeps the top ef of ``[beam, candidates]`` by (score
    descending, slot ascending)."""
    weights = _check(c_idx, c_dense, beam_s, neighbors, w_dense, w_sparse, dense_kind)
    if neighbors.device.type == "cpu":
        return ref.beam_hop_plain(
            qdensified, q_dense, beam_s, beam_i, visited, neighbors, c_idx,
            c_val, c_dense, n_valid=n_valid, w_dense=w_dense,
            w_sparse=w_sparse, dense_kind=dense_kind)
    return _launch(qdensified, q_dense, beam_s, beam_i, visited, neighbors,
                   c_idx, c_val, c_dense, n_valid, weights, dense_kind, 1, False)


def beam_search(qdensified, q_dense, beam_s, beam_i, visited, neighbors,
                c_idx, c_val, c_dense, *, n_valid: int, hops: int,
                w_dense=None, w_sparse=None, dense_kind: str = "ip"):
    """``hops`` hops from ``(beam_s, beam_i, visited)`` on a copy of the
    mask; returns the final ``(beam_s, beam_i, visited)``.  For CUDA
    tensors one launch runs every hop, committing each hop's marks in the
    kernel; on the CPU the plain hop runs hop by hop, its deltas committed
    with one ``scatter_add_`` (valid candidates are unique and unseen, so
    the add is an or).  Both give the hop-by-hop result bit for bit."""
    weights = _check(c_idx, c_dense, beam_s, neighbors, w_dense, w_sparse, dense_kind)
    visited = visited.clone()
    if neighbors.device.type == "cpu":
        for _ in range(int(hops)):
            beam_s, beam_i, words, addend = ref.beam_hop_plain(
                qdensified, q_dense, beam_s, beam_i, visited, neighbors, c_idx,
                c_val, c_dense, n_valid=n_valid, w_dense=w_dense,
                w_sparse=w_sparse, dense_kind=dense_kind)
            visited.scatter_add_(1, words.long(), addend)
        return beam_s, beam_i, visited
    if int(hops) < 1:
        return beam_s, beam_i, visited
    beam_s, beam_i, _, _ = _launch(
        qdensified, q_dense, beam_s, beam_i, visited, neighbors, c_idx, c_val,
        c_dense, n_valid, weights, dense_kind, int(hops), True)
    return beam_s, beam_i, visited
