"""The query-term index that the fused kernels read in place of the
densified query table (``csrc/topk_scan.cuh``: ``index_row``).

For each group of ``group`` queries (16 in the fused score kernel, the
launch plan's ``qb`` in the fused top-k kernel) over term ids
``0 .. V`` (column ``V`` is the pad id's):

- ``words`` int32 ``[groups, ceil((V+1)/32), 2]``: per 32 term ids the
  presence bits (bit ``t % 32`` of word ``t // 32``; a term is present
  when any query of the group holds a nonzero value for it, NaN and inf
  included, so that they behave as in the table) and the compact
  table row of the word's first present term (1 + the present terms
  before the word);
- ``table`` f32 ``[groups, V + 2, group]``: row ``1 + r`` holds the
  group's values of its ``r``-th present term; row 0 is zero and stands
  for every absent term.  Rows past the group's present terms stay zero.

A term's row is ``words[t // 32, 1] + popcount(bits below t % 32)`` when
its bit is set, else 0.  The kernels index ids outside ``[0, V]`` as
repro's ``qdensified[:, c_idx]``: a negative id counts from the end of
the ``V + 1`` columns once, then ids clamp to ``[0, V]``.

``build_index`` builds it on the card in two kernel launches from one
call (``index_kernel_bits`` and ``index_kernel_rows`` in
``csrc/topk_scan.cuh``), where a dozen PyTorch calls would cost the host
more than the entry-set scan of a graph batch; ``query_index`` is its
plain version, which the tests and ``chip_smoke.py`` hold it against.
Neither synchronises with the host.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparse import accum_f32
from repro_torch.kernels import _build


def _declare(lib):
    fn = lib.query_index_launch
    if fn.argtypes is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [v, i, i, i, i, i, v, v, v]
        fn.restype = ctypes.c_int
    return fn


def build_index(qdensified: torch.Tensor, group: int, block: int | None = None):
    """``query_index`` on the card: the same words, and the same compact
    table rows 0 .. S (rows past a group's S present terms are left
    uninitialised: no kernel reads them).  ``qdensified`` is a contiguous
    f32 or bf16 CUDA tensor."""
    block = group if block is None else block
    if group < 1 or block % group:
        raise ValueError(f"block {block} is not a multiple of the group {group}")
    b, v1 = qdensified.shape
    dev = qdensified.device
    groups = -(-b // block) * block // group
    words = torch.empty((groups, -(-v1 // 32), 2), dtype=torch.int32, device=dev)
    table = torch.empty((groups, v1 + 1, group), dtype=torch.float32, device=dev)
    fn = _declare(_build.load("topk_scan"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.c_void_p(qdensified.data_ptr()), int(qdensified.dtype == torch.bfloat16),
                 b, v1 - 1, group, groups, ctypes.c_void_p(words.data_ptr()),
                 ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(stream))
    _build.check(err, "query_index_launch")
    return words, table


def query_index(qdensified: torch.Tensor, group: int, block: int | None = None):
    """(words, table) of ``qdensified`` [B, V+1] (f32 or bf16) in groups
    of ``group`` queries; B is padded with zero queries to a multiple of
    ``block`` (default ``group``), which ``group`` divides."""
    block = group if block is None else block
    if group < 1 or block % group:
        raise ValueError(f"block {block} is not a multiple of the group {group}")
    b, v1 = qdensified.shape
    dev = qdensified.device
    rows = -(-b // block) * block
    t = accum_f32(qdensified)
    t = torch.nn.functional.pad(t, (0, 0, 0, rows - b)).view(rows // group, group, v1)
    present = (t != 0).any(1)                     # [G, V+1]; NaN != 0 too
    n_words = -(-v1 // 32)
    p = torch.nn.functional.pad(present, (0, n_words * 32 - v1)).view(-1, n_words, 32)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    bits = (p.to(torch.int64) << shifts).sum(-1)                     # < 2**32
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    count = p.sum(-1, dtype=torch.int32)
    first = (torch.cumsum(count, -1, dtype=torch.int32) - count + 1).to(torch.int32)
    words = torch.stack([bits, first], -1).contiguous()              # [G, W, 2]
    # present column t goes to row cumsum(present)[t]; absent ones to row 0
    row = torch.where(present, torch.cumsum(present, -1), 0)         # [G, V+1]
    vals = torch.where(present[:, None, :], t, 0.0).transpose(1, 2)  # [G, V+1, group]
    table = torch.zeros((rows // group, v1 + 1, group), dtype=torch.float32, device=dev)
    table.scatter_(1, row[:, :, None].expand(-1, -1, group), vals)
    return words, table


def index_rows(words: torch.Tensor, vocab: int, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' ``index_row``: the compact-table row
    of every id in ``ids`` for every group, int64 ``[groups, *ids.shape]``
    (0 where the group does not hold the term).  Ids outside ``[0,
    vocab]`` index as repro's: a negative id counts from the end once,
    then ids clamp to ``[0, vocab]``."""
    u = ids.long()
    u = torch.where(u < 0, u + vocab + 1, u).clamp(0, vocab)
    w = words.long()                                                # [G, W, 2]
    flat = u.reshape(-1)
    bits = w[:, flat // 32, 0] & 0xFFFFFFFF                         # [G, M]
    first = w[:, flat // 32, 1]
    b = flat % 32
    hit = ((bits >> b) & 1) == 1
    rows = torch.where(hit, first + _popcount32(bits & ((1 << b) - 1)), 0)
    return rows.reshape(words.shape[0], *ids.shape)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value in [0, 2**32) (int64), as ``__popc``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def table_from_index(words: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """The densified table [groups * group, V+1] that the index encodes:
    every column read back through ``index_rows``."""
    g, _, group = table.shape
    rows = index_rows(words, vocab, torch.arange(vocab + 1, device=table.device))   # [G, V+1]
    picked = torch.gather(table, 1, rows[:, :, None].expand(-1, -1, group))         # [G, V+1, group]
    return picked.transpose(1, 2).reshape(g * group, vocab + 1)
