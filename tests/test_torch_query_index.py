"""The query-term index that the fused CUDA kernels read in place of the
densified query table (``repro_torch/kernels/query_index.py``), held on
the CPU against the table itself and against repro's
``fused_score_pallas`` (Pallas interpret mode, as repro's own tests run
it).

The kernels cannot run here; ``chip_smoke.py`` holds them against their
plain versions on the card.  Here: (1) the index encodes each group's
``[group, V+1]`` table exactly (read back column by column through the
plain version of the kernels' ``index_row``), over batch sizes, group
widths, vocabularies whose V+1 is not a multiple of 32, duplicated query
terms, an all-pad query, a nonzero pad column, bf16 tables and non-finite
entries; (2) the plain emulation of the kernels' sparse arithmetic
through the index gives ``ref.fused_table_scores``'s sparse part bit for
bit (the same values reach the same reduction; a miss reads zeros), and
repro's ``fused_score_pallas`` within ``F32_RTOL`` (2e-6) of the row's
largest |score| (XLA and PyTorch sum in other orders); (3) the plain
version indexes out-of-range ids as repro's plain version does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import SparseVectors as JSparse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ref
from repro_torch.kernels import fused_topk as fk
from repro_torch.kernels.query_index import index_rows, query_index, table_from_index

from _torch_parity import assert_scores_close

pytestmark = pytest.mark.torch


def _table_np(b, v, nnz_q, seed, *, pad_query=True, pad_column=True, nonfinite=False):
    """Densified query table [b, V+1] f32 from COO queries drawn with
    repeated ids (values of a repeated id add up, as densify adds them):
    optionally the last query all pad (ids V, values 0), a nonzero value in
    the pad column V, and an inf and a NaN entry."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=(b, nnz_q))
    ids[:, nnz_q // 2:] = ids[:, :nnz_q - nnz_q // 2]       # every query repeats its terms
    vals = rng.uniform(0.1, 1.0, size=(b, nnz_q)).astype(np.float32)
    table = np.zeros((b, v + 1), np.float32)
    for q in range(b):
        np.add.at(table[q], ids[q], vals[q])
    table[:, v] = 0.0
    if pad_query:
        table[-1] = 0.0
    if pad_column and b > 1:
        table[0, v] = 0.75
    if nonfinite:
        table[0, 1] = np.inf
        table[b // 2, 2] = np.nan
    return table


def _equal_with_nan(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("v", [60, 1000, 30_522])
@pytest.mark.parametrize("group", [4, 16])
@pytest.mark.parametrize("b", [1, 5, 16, 128])
def test_index_reconstructs_the_table(b, group, v):
    assert (v + 1) % 32
    table = torch.from_numpy(_table_np(b, v, 32, seed=b * 7 + v, nonfinite=b > 4))
    words, compact = query_index(table, group)
    groups = -(-b // group)
    assert words.shape == (groups, -(-(v + 1) // 32), 2) and words.dtype == torch.int32
    assert compact.shape == (groups, v + 2, group) and compact.dtype == torch.float32
    back = table_from_index(words, compact, v)
    _equal_with_nan(back[:b], table)
    assert not bool(back[b:].any())
    # row 0 is the misses' zero row; each group's present terms fill rows 1..S
    assert not bool(compact[:, 0].any())
    present = ((table != 0) | ~torch.isfinite(table))
    present = torch.nn.functional.pad(present, (0, 0, 0, groups * group - b))
    counts = present.view(groups, group, v + 1).any(1).sum(1)
    last = words[:, -1, 1].long() - 1 + torch.tensor(
        [bin(int(x) & 0xFFFFFFFF).count("1") for x in words[:, -1, 0]])
    assert torch.equal(last, counts)


@pytest.mark.parametrize("block", [16, 64])
def test_index_pads_to_the_block(block):
    """The score kernel reads ceil(B / block) * block / 16 groups: the
    padded groups are empty (every lookup misses)."""
    table = torch.from_numpy(_table_np(20, 300, 8, seed=3))
    words, compact = query_index(table, 16, block)
    assert words.shape[0] == block // 16 * (-(-20 // block))
    _equal_with_nan(table_from_index(words, compact, 300)[:20], table)
    assert not bool(words[-(-20 // 16):, :, 0].any())   # the groups past B hold no term
    with pytest.raises(ValueError, match="multiple of the group"):
        query_index(table, 16, 24)


def test_bf16_table_upcasts():
    t32 = torch.from_numpy(_table_np(16, 1000, 32, seed=5))
    t16 = t32.to(torch.bfloat16)
    words, compact = query_index(t16, 16)
    _equal_with_nan(table_from_index(words, compact, 1000), t16.float())


def test_lookup_of_out_of_range_ids():
    """Ids outside [0, V] look up the column repro's
    ``qdensified[:, c_idx]`` reads: ids past V and -1 the pad column V, a
    negative id its column counted from the end, ids below -(V+1) column
    0."""
    v = 100
    table = torch.from_numpy(_table_np(4, v, 6, seed=11))       # column V nonzero in query 0
    words, _ = query_index(table, 4)
    ids = torch.tensor([v, v + 1, 2 ** 31 - 1, -1, -7, v - 6, -(v + 1), -(2 ** 31), 0],
                       dtype=torch.int32)
    rows = index_rows(words, v, ids)
    assert bool((rows[:, :4] == rows[:, :1]).all()) and int(rows[0, 0]) > 0
    assert torch.equal(rows[:, 4], rows[:, 5])
    assert bool((rows[:, 6:] == rows[:, 8:]).all())


def _coo_np(n, v, nnz, seed, *, skew=False, out_of_range=False):
    rng = np.random.default_rng(seed)
    if skew:   # Zipf: rank r drawn with probability proportional to 1 / r
        p = 1.0 / np.arange(1, v + 1)
        ids = rng.choice(v, size=(n, nnz), p=p / p.sum())
    else:
        ids = rng.integers(0, v, size=(n, nnz))
    ids[rng.uniform(size=(n, nnz)) < 0.2] = v                     # pad slots
    if out_of_range:
        ids[0, 0], ids[1, 1], ids[2, 2], ids[3, 3], ids[4, 4] = v + 5, -1, 2 ** 31 - 1, -7, -(v + 1)
    return ids.astype(np.int32), rng.uniform(size=(n, nnz)).astype(np.float32)


CASES = [  # (b, v, nnz_q, n, nnz, group, skew)
    (5, 60, 8, 203, 16, 4, False), (16, 1000, 32, 300, 128, 16, True),
    (16, 1000, 32, 257, 7, 4, False), (128, 2000, 128, 64, 128, 16, False),
    (3, 30_522, 32, 50, 128, 16, True)]


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_the_table_and_repro(case):
    b, v, nnz_q, n, nnz, group, skew = case
    table_np = _table_np(b, v, nnz_q, seed=n + b, pad_column=False)   # repro's densify zeroes V
    ids_np, vals_np = _coo_np(n, v, nnz, seed=n, skew=skew)
    table, ids, vals = (torch.from_numpy(x) for x in (table_np, ids_np, vals_np))
    words, compact = query_index(table, group)
    got = ref.index_sparse_scores(words, compact, ids, vals, v, b)
    assert got.shape == (b, n) and got.dtype == torch.float32
    want = ref.fused_table_scores(table, None, ids, vals, None)
    assert torch.equal(got, want)
    # repro's fused_score_pallas with the dense weight 0 gives the sparse part
    q_sp = JSparse(jnp.arange(v, dtype=jnp.int32)[None].repeat(b, 0), jnp.asarray(table_np[:, :v]))
    c_sp = JSparse(jnp.asarray(ids_np), jnp.asarray(vals_np))
    qd, cd = jnp.zeros((b, 8), jnp.float32), jnp.zeros((n, 8), jnp.float32)
    pallas = jops.fused_scores(q_sp, qd, c_sp, cd, v, 0.0, 1.0, tile_n=64)
    assert_scores_close(np.asarray(pallas), got.numpy(), ctx=case)


def test_emulation_with_nonfinite_and_out_of_range():
    """inf and NaN in the table and the values, and ids above V and
    below 0, give what the plain version's table gather gives."""
    v = 80
    table = torch.from_numpy(_table_np(6, v, 8, seed=2, nonfinite=True))
    ids_np, vals_np = _coo_np(40, v, 9, seed=4, out_of_range=True)
    vals_np[3, 4], vals_np[5, 0] = np.inf, np.nan
    ids, vals = torch.from_numpy(ids_np), torch.from_numpy(vals_np)
    words, compact = query_index(table, 4)
    got = ref.index_sparse_scores(words, compact, ids, vals, v, 6)
    _equal_with_nan(got, ref.fused_table_scores(table, None, ids, vals, None))


def test_plain_version_indexes_out_of_range_ids_as_repro():
    """Ids past V read column V; negative ids count from the end, then
    clamp to 0, as repro's ``qdensified[:, c_idx]`` does."""
    v = 50
    table_np = _table_np(3, v, 8, seed=9)
    ids_np, vals_np = _coo_np(6, v, 8, seed=10)
    ids_np[:, :6] = [[v + 1, 2 ** 31 - 1, -1, -7, -(v + 1), -(2 ** 31)]] * 6
    got = ref.fused_table_scores(torch.from_numpy(table_np), None, torch.from_numpy(ids_np),
                                 torch.from_numpy(vals_np), None)
    qd, cd = jnp.zeros((3, 4), jnp.float32), jnp.zeros((6, 4), jnp.float32)
    want = jref.fused_score_ref(jnp.asarray(table_np), qd, jnp.asarray(ids_np), jnp.asarray(vals_np),
                                cd, 0.0, 1.0)
    assert_scores_close(np.asarray(want), got.numpy(), ctx="out-of-range ids")


@pytest.mark.parametrize("b,width", [(1, 1), (16, 1), (32, 2), (33, 3), (64, 4), (65, 1), (128, 1)])
def test_score_block_width(b, width):
    """The fused ring's blocks that share one read of the corpus, each a group of 16 queries with its own
    query-term index: B2 launches a cluster of ceil(b / 16) of them from 17 to ``CLUSTER_QUERIES`` queries
    and a block a group elsewhere; the fused score kernel (B4) a block a group at every B."""
    assert fk.GROUP == 16 and fk.CLUSTER_QUERIES == 64
    grid = fk.fused_grid(b, "box", 132)
    assert grid.width == width and grid.padded == width * grid.rows and grid.groups == -(-b // 16)
    b4 = fk.fused_grid(b, "box", 132, cluster=False)
    assert (b4.width, b4.rows, b4.blocks) == (1, -(-b // 16), 132)


def test_kernel_sources_use_the_index():
    ring = (_build.CSRC / "ring.cuh").read_text()
    scan = (_build.CSRC / "topk_scan.cu").read_text()
    header = (_build.CSRC / "topk_scan.cuh").read_text()
    assert "stage_hits" in header and "index_kernel" in header and "kWordsSmemCap" in header
    assert "topk::index_row" in ring and "stage_hits<" in scan and "query_index_launch" in scan
    assert "qdt" not in ring and "qdt" not in scan
    assert f"constexpr int kQB = {fk.GROUP};" in ring   # the fused ring's (B2's and B4's) index groups
    # the dense-only scan's code depends on the argument struct's layout
    assert "static_assert(sizeof(ScanArgs) == 128" in scan
