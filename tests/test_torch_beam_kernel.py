"""repro_torch's beam-hop module on the CPU (the plain versions) held
against repro's ``beam_hop_pallas`` run as repro's own tests run it
(Pallas interpret mode) and against ``repro.kernels.ref.beam_hop_ref``,
hop for hop, on the same numpy inputs.

The CUDA kernel cannot run here; ``chip_smoke.py`` (phase "beam small")
holds it against these plain versions on the card.  Tolerances: beam
scores within ``F32_RTOL`` (2e-6) of the row's largest |score|; beam ids,
mark-deltas and the unpacked visited set equal.  The packed mask is
int32 here and uint32 in repro: the same bits, compared through
``.view(np.int32)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph_ann as jga
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.beam_topk import (beam_hop_pallas, mark_visited as j_mark,
                                     unpack_visited as j_unpack)
from repro_torch.kernels import _build
from repro_torch.kernels import beam_topk as tb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_parity import assert_scores_close, np_of, to_torch

pytestmark = pytest.mark.torch

NEG = float(np.finfo(np.float32).min)


@pytest.fixture
def no_library(monkeypatch):
    """Fail if anything tries to build or load the CUDA library."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = tb.launches
    yield
    assert tb.launches == before


def _planted(n, v, nnz, dd, b, seed):
    """numpy (corpus, queries) of ``benchmarks/common.py:
    planted_cluster_fused`` over 8 clusters: [dense, idx, val] each."""
    from benchmarks.common import planted_cluster_fused

    c, q = planted_cluster_fused(n, v, nnz, dd, b, 5, seed=seed)
    return ([np.asarray(c.dense), np.asarray(c.sparse.indices), np.asarray(c.sparse.values)],
            [np.asarray(q.dense), np.asarray(q.sparse.indices), np.asarray(q.sparse.values)])


def _init(rng, n, ef, b, sentinels=0):
    """Score-descending init beam: random ids (repeats allowed), the last
    ``sentinels`` slots holding id n (and one id -1) at f32-min."""
    ids = rng.integers(0, n, (b, ef)).astype(np.int32)
    s = -np.sort(-rng.standard_normal((b, ef)).astype(np.float32), axis=1)
    if sentinels:
        ids[:, ef - sentinels:] = n
        ids[0, ef - 1] = -1
        s[:, ef - sentinels:] = NEG
    return s, ids


def _case(space, dtype, n=120, r=4, ef=8, b=3, seed=0, graph="random"):
    """Inputs of one hop-parity case: (kw for both packages, n, r)."""
    rng = np.random.default_rng(seed)
    v, nnz, dd = 48, 8, 32
    (cd, ci, cv), (qdense, qi, qv) = _planted(n, v, nnz, dd, b, seed)
    if graph == "random":
        nbr = rng.integers(0, n, (n, r)).astype(np.int32)
    elif graph == "padded":        # short rows, sentinel pad, repeated ids
        lists = [list(rng.integers(0, n, rng.integers(0, r + 1))) * 2
                 for _ in range(n)]
        nbr = np.asarray(jga.flat_adjacency(lists, n, r))
    else:                          # starved: few rows have a neighbour
        lists = [[(i + 1) % n] if i % 7 == 0 else [] for i in range(n)]
        nbr = np.asarray(jga.flat_adjacency(lists, n, r))
    qd = np.zeros((b, v + 1), np.float32)
    np.add.at(qd, (np.arange(b)[:, None], qi), qv)
    qd[:, v] = 0.0
    dense = cd.astype(np.float32) if dtype == "f32" else np_of(jnp.asarray(cd, jnp.bfloat16))
    vals = cv.astype(np.float32) if dtype == "f32" else np_of(jnp.asarray(cv, jnp.bfloat16))
    kw = dict(qdensified=qd, q_dense=qdense.astype(np.float32), neighbors=nbr,
              c_idx=ci.astype(np.int32), c_val=vals, c_dense=dense,
              w_dense=0.5, w_sparse=1.5, dense_kind="ip")
    if space in ("dense-ip", "dense-l2"):
        kw.update(qdensified=None, c_idx=None, c_val=None, w_dense=None,
                  w_sparse=None, dense_kind=space[-2:])
    elif space == "sparse":
        kw.update(q_dense=None, c_dense=None, w_dense=None, w_sparse=None)
    return kw, rng


def _jnp(x):
    if x is None:
        return None
    if x.dtype == np.uint16:
        return jnp.asarray(x.view(jnp.bfloat16))
    return jnp.asarray(x)


def _torch(x):
    return None if x is None else to_torch(x)


SPACES = ["dense-ip", "dense-l2", "sparse", "fused"]


@pytest.mark.parametrize("graph,sentinels", [("random", 0), ("padded", 3), ("starved", 5)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("space", SPACES)
def test_hop_matches_repro(space, dtype, graph, sentinels, no_library):
    """Hop for hop over 4 hops: the port's wrapper (plain version on the
    CPU) against ``beam_hop_pallas`` in interpret mode, and the port's
    ``beam_hop_ref`` against repro's, from the same starting state."""
    seed = 100 * SPACES.index(space) + 10 * ("f32", "bf16").index(dtype) + len(graph)
    kw, rng = _case(space, dtype, seed=seed, graph=graph)
    n, b, ef = kw["neighbors"].shape[0], 3, 8
    s, ids = _init(rng, n, ef, b, sentinels)
    jvis = j_mark(jnp.zeros((b, tb.visited_words(n)), jnp.uint32), jnp.asarray(ids), n)
    tvis = tb.mark_visited(torch.zeros((b, tb.visited_words(n)), dtype=torch.int32),
                           torch.from_numpy(ids), n)
    np.testing.assert_array_equal(np.asarray(jvis).view(np.int32), tvis.numpy())
    names = ("qdensified", "q_dense", "neighbors", "c_idx", "c_val", "c_dense")
    jargs = {k: _jnp(kw[k]) for k in names}
    targs = {k: _torch(kw[k]) for k in names}
    opts = dict(n_valid=n, w_dense=kw["w_dense"], w_sparse=kw["w_sparse"],
                dense_kind=kw["dense_kind"])
    j_beam = (jnp.asarray(s), jnp.asarray(ids))
    t_beam = (torch.from_numpy(s), torch.from_numpy(ids))
    jr_beam, tr_beam = j_beam, t_beam
    jr_vis, tr_vis = j_unpack(jvis, n), tb.unpack_visited(tvis, n)
    rows = jnp.arange(b)[:, None]
    j_hop = jax.jit(functools.partial(beam_hop_pallas, **opts))
    j_ref = jax.jit(functools.partial(jref.beam_hop_ref, **opts))
    for hop in range(4):
        ctx = f"{space} {dtype} {graph} hop {hop}"
        js, ji, jw, ja = j_hop(jargs["qdensified"], jargs["q_dense"], *j_beam, jvis,
                                         jargs["neighbors"], jargs["c_idx"], jargs["c_val"],
                                         jargs["c_dense"])
        ts, ti, tw, ta = tb.beam_hop(targs["qdensified"], targs["q_dense"], *t_beam, tvis,
                                     targs["neighbors"], targs["c_idx"], targs["c_val"],
                                     targs["c_dense"], **opts)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy(), err_msg=ctx)
        assert_scores_close(np.asarray(js), ts.numpy(), ctx=ctx)
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy(), err_msg=ctx)
        np.testing.assert_array_equal(np.asarray(ja).view(np.int32), ta.numpy(), err_msg=ctx)
        jvis = jvis.at[rows, jw].add(ja, mode="drop")
        tvis = tvis.scatter_add(1, tw.long(), ta)
        np.testing.assert_array_equal(np.asarray(jvis).view(np.int32), tvis.numpy(), err_msg=ctx)
        # the independent oracles, from their own (equal) states
        jrs, jri, jr_vis = j_ref(jargs["qdensified"], jargs["q_dense"], *jr_beam,
                                 jr_vis, jargs["neighbors"], jargs["c_idx"],
                                 jargs["c_val"], jargs["c_dense"])
        trs, tri, tr_vis = tref.beam_hop_ref(targs["qdensified"], targs["q_dense"], *tr_beam,
                                             tr_vis, targs["neighbors"], targs["c_idx"],
                                             targs["c_val"], targs["c_dense"], **opts)
        np.testing.assert_array_equal(np.asarray(jri), tri.numpy(), err_msg=ctx)
        assert_scores_close(np.asarray(jrs), trs.numpy(), ctx=ctx)
        np.testing.assert_array_equal(np.asarray(jr_vis), tr_vis.numpy(), err_msg=ctx)
        # the packed path and the table path agree with each other too
        np.testing.assert_array_equal(tb.unpack_visited(tvis, n).numpy(), tr_vis.numpy())
        j_beam, t_beam = (js, ji), (ts, ti)
        jr_beam, tr_beam = (jrs, jri), (trs, tri)


def test_first_occurrence_kills_later_valid_copy(no_library):
    """Dedup runs over the raw list: a sentinel slot's (invalid) copy of
    an id, earlier in the list, kills a later valid copy of it."""
    n, d = 16, 4
    nbr = np.zeros((n, 2), np.int32)
    nbr[n - 1] = [7, 8]               # read by the sentinel slot (clipped to n-1)
    nbr[3] = [7, 9]                   # the valid copy of 7 comes later
    corpus = np.eye(n, d, dtype=np.float32) + 1.0
    q = np.ones((1, d), np.float32)
    ids = np.asarray([[n, 3]], np.int32)          # slot 0 is a sentinel
    s = np.asarray([[NEG, NEG]], np.float32)
    vis = torch.zeros((1, 1), dtype=torch.int32)
    _, ti, tw, ta = tb.beam_hop(None, torch.from_numpy(q), torch.from_numpy(s),
                                torch.from_numpy(ids), vis, torch.from_numpy(nbr), None,
                                None, torch.from_numpy(corpus), n_valid=n)
    js, ji, jw, ja = beam_hop_pallas(None, jnp.asarray(q), jnp.asarray(s), jnp.asarray(ids),
                                     jnp.zeros((1, 1), jnp.uint32), jnp.asarray(nbr), None,
                                     None, jnp.asarray(corpus), n_valid=n)
    np.testing.assert_array_equal(np.asarray(ja).view(np.int32), ta.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    # candidates [7, 8 | 7, 9]: only 9 is valid (the second 7 is a dup)
    assert ta.numpy().tolist() == [[0, 0, 0, 1 << 9]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mark_and_unpack_round_trip(seed):
    """``mark_visited`` sets exactly the bits ``repro``'s does (repeats
    and out-of-range ids included, bit 31 as INT32_MIN), and
    ``unpack_visited`` reads them back as repro's does."""
    rng = np.random.default_rng(seed)
    n, b, k = 200, 4, 40
    ids = rng.integers(-3, n + 5, (b, k)).astype(np.int32)
    ids[:, :4] = [31, 63, 31, 199]       # bit 31 of two words, a repeat
    base = rng.integers(0, 2, (b, tb.visited_words(n)), dtype=np.uint32) << 31
    want = j_mark(jnp.asarray(base), jnp.asarray(ids), n)
    got = tb.mark_visited(torch.from_numpy(base.view(np.int32)), torch.from_numpy(ids), n)
    np.testing.assert_array_equal(np.asarray(want).view(np.int32), got.numpy())
    np.testing.assert_array_equal(np.asarray(j_unpack(want, n)), tb.unpack_visited(got, n).numpy())
    assert got.dtype == torch.int32 and int(got.min()) < 0     # a set bit 31


def test_bit_patterns():
    got = tb.bit_i32(torch.arange(32, dtype=torch.int32))
    want = (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_budget_and_argument_refusals(no_library):
    tb.check_beam_budget(64, 16)
    tb.check_beam_budget(tb.MAX_BEAM_CANDIDATES, 1)
    with pytest.raises(ValueError, match="candidate block"):
        tb.check_beam_budget(tb.MAX_BEAM_CANDIDATES, 2)
    z = torch.zeros((1, 4096))
    beam = (torch.zeros((1, 4096)), torch.zeros((1, 4096), dtype=torch.int32))
    nbr = torch.zeros((10, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="candidate block"):
        tb.beam_hop(None, z, *beam, torch.zeros((1, 1), dtype=torch.int32), nbr, None,
                    None, torch.zeros((10, 4096)), n_valid=10)
    with pytest.raises(ValueError, match="no components"):
        tb.beam_hop(None, None, *beam, None, nbr, None, None, None, n_valid=10)
    with pytest.raises(ValueError, match="dense_kind='ip'"):
        tb.beam_hop(z, z, *beam, None, nbr, nbr, z, z, n_valid=10, w_dense=1.0,
                    w_sparse=1.0, dense_kind="l2")
    with pytest.raises(ValueError, match="requires w_dense and w_sparse"):
        tb.beam_hop(z, z, *beam, None, nbr, nbr, z, z, n_valid=10)
    # repro refuses the same budgets
    from repro.kernels.beam_topk import MAX_BEAM_CANDIDATES
    assert MAX_BEAM_CANDIDATES == tb.MAX_BEAM_CANDIDATES


def _key(x):
    """``topk::order_key``: int64 keys in ``lax.top_k``'s order of f32
    scores, the total order of their bit patterns."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.int64)


def _kernel_merge(beam_s, beam_i, cand_s, cand_i, valid):
    """The kernel's merge (``csrc/beam_hop.cu``, step 4) for one query in
    numpy: the ef beam entries, the valid candidates whose order key is
    above the beam's worst, and, when fewer than ef entries of the beam and
    the valid candidates rank above f32-min, that many of the invalid
    candidates (f32-min, in slot order); the top ef of those by (order key
    descending, slot ascending).  Returns the top ef (scores, ids) and the
    number of entries ranked."""
    ef, c = beam_s.shape[0], cand_s.shape[0]
    pos = np.flatnonzero(valid)
    neg = _key(NEG)
    above = int((_key(beam_s) > neg).sum() + (_key(cand_s[pos]) > neg).sum())
    keep = pos[_key(cand_s[pos]) > _key(beam_s).min()]
    need = min(max(ef - above, 0), c - pos.size)
    slot = np.concatenate([np.arange(ef), ef + keep, ef + np.flatnonzero(~valid)[:need]])
    s = np.concatenate([beam_s, cand_s[keep], np.full(need, NEG, np.float32)])
    order = np.lexsort((slot, -_key(s)))[:ef]
    return s[order], np.concatenate([beam_i, cand_i])[slot[order]], slot.size


def _merge_case(rng, ef, c, valid_share, extremes, nan=False, zeros=False):
    """A beam in any order (random, f32-min and -inf scores, ids -1 and n
    among them) and C candidates, a share of them valid; invalid ones are
    (f32-min, n), ``extremes`` makes some valid ones score f32-min or
    -inf, ``nan`` some beam entries and valid candidates NaN (0 * inf in a
    sparse part: 0x7fffffff on the card, 0xffc00000 on an x86 CPU, and
    NumPy's 0x7fc00000), ``zeros`` some of them +0 and -0."""
    n = 10_000
    beam_s = rng.standard_normal(ef).astype(np.float32)
    beam_i = rng.integers(0, n, ef).astype(np.int32)
    pick = rng.uniform(size=ef)
    beam_s[pick < 0.3], beam_i[pick < 0.3] = NEG, n
    beam_s[(pick >= 0.3) & (pick < 0.4)] = -np.inf
    beam_i[0] = -1
    valid = rng.uniform(size=c) < valid_share
    cand_s = np.where(valid, rng.standard_normal(c), NEG).astype(np.float32)
    if extremes:
        x = rng.uniform(size=c)
        cand_s[valid & (x < 0.3)] = NEG
        cand_s[valid & (x > 0.8)] = -np.inf
    if nan:
        nans = np.array([0x7FFFFFFF, 0xFFC00000, 0x7FC00000], np.uint32).view(np.float32)
        bn = (pick >= 0.4) & (pick < 0.5)
        beam_s[bn] = nans[rng.integers(0, 3, int(bn.sum()))]
        cn = valid & (rng.uniform(size=c) < 0.3)
        cand_s[cn] = nans[rng.integers(0, 3, int(cn.sum()))]
        cand_s[valid & (rng.uniform(size=c) < 0.1)] = np.inf
    if zeros:
        bz, cz = rng.uniform(size=ef), rng.uniform(size=c)
        beam_s[bz < 0.2], beam_s[(bz >= 0.2) & (bz < 0.4)] = 0.0, -0.0
        cand_s[valid & (cz < 0.3)], cand_s[valid & (cz >= 0.3) & (cz < 0.6)] = 0.0, -0.0
    cand_i = np.where(valid, rng.integers(0, n, c), n).astype(np.int32)
    return beam_s, beam_i, cand_s, cand_i, valid


def _assert_merge_is_top_k(beam_s, beam_i, cand_s, cand_i, valid):
    """The emulated kernel merge and the plain hop's merge (``select_topk``
    over [beam, candidates], ``ref._hop``) against repro's: ``lax.top_k``
    over the whole row (``beam_hop_ref``), ids equal and scores bit for
    bit."""
    from repro_torch.core.brute_force import select_topk

    ef = beam_s.shape[0]
    row = np.concatenate([beam_s, cand_s])
    ids = np.concatenate([beam_i, cand_i])
    want_s, pos = jax.lax.top_k(jnp.asarray(row), ef)
    want_s, want_i = np.asarray(want_s).view(np.uint32), ids[np.asarray(pos)]
    got_s, got_i, _ = _kernel_merge(beam_s, beam_i, cand_s, cand_i, valid)
    np.testing.assert_array_equal(want_s, got_s.view(np.uint32))
    np.testing.assert_array_equal(want_i, got_i)
    plain_s, plain_pos = select_topk(torch.from_numpy(row)[None], ef)
    np.testing.assert_array_equal(want_s, plain_s[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(want_i, ids[plain_pos[0].numpy()])


@pytest.mark.parametrize("ef,r,valid_share,extremes", [
    (64, 16, 0.04, False), (64, 16, 0.04, True), (16, 4, 0.0, False), (16, 4, 0.02, True),
    (8, 4, 1.0, True), (32, 8, 0.5, True), (2048, 16, 0.001, True), (1, 1, 1.0, False)])
def test_merge_over_valid_candidates_equals_full_sort(ef, r, valid_share, extremes):
    """Sorting the beam and the valid candidates (plus as many invalid ones
    as can reach the top) gives the top ef of repro's full merge
    (``lax.top_k`` over [beam, candidates]): starved beams, beam ids -1 and
    n, unsorted beams, valid candidates scoring f32-min or -inf."""
    rng = np.random.default_rng(ef * 7 + r + int(100 * valid_share) + extremes)
    for _ in range(4):
        _assert_merge_is_top_k(*_merge_case(rng, ef, ef * r, valid_share, extremes))


@pytest.mark.parametrize("ef,r,valid_share", [
    (64, 16, 0.04), (16, 4, 0.02), (8, 4, 1.0), (32, 8, 0.5), (2048, 16, 0.001), (4, 2, 0.0)])
def test_merge_with_nan_scores_equals_lax_top_k(ef, r, valid_share):
    """NaN scores (beam entries and valid candidates) and +0 / -0 rank as
    ``lax.top_k`` ranks them, by their bits: a NaN with the sign bit clear
    above +inf, one with it set below -inf, +0 above -0, then by slot.  The
    kernel's filter and rank count keep them, a starved beam still takes
    the right number of invalid entries, and the plain hop's merge agrees."""
    rng = np.random.default_rng(ef * 13 + r + int(1000 * valid_share))
    for nan, zeros in ((True, False), (False, True), (True, True), (True, True)):
        beam_s, beam_i, cand_s, cand_i, valid = _merge_case(rng, ef, ef * r, valid_share, True,
                                                            nan=nan, zeros=zeros)
        _assert_merge_is_top_k(beam_s, beam_i, cand_s, cand_i, valid)
    beam_s[:] = np.nan       # an all-NaN beam: no candidate gets ahead of it
    _assert_merge_is_top_k(beam_s, beam_i, cand_s, cand_i, valid)
    beam_s[:] = -0.0         # an all -0 beam: +0 candidates get ahead of it
    _assert_merge_is_top_k(beam_s, beam_i, cand_s, cand_i, valid)


def test_sort_size():
    """The merge ranks the beam and only the valid candidates that beat
    its worst score; a starved beam adds as many invalid candidates as
    can reach the top; never more than ef + C entries (the full sort's
    count)."""
    rng = np.random.default_rng(3)
    beam_s, beam_i, cand_s, cand_i, valid = _merge_case(rng, 64, 1024, 0.04, False)
    beam_s[:], beam_i[:] = rng.standard_normal(64).astype(np.float32) + 2, 7
    beats = int((cand_s[valid] > beam_s.min()).sum())
    assert 0 < beats < valid.sum()
    assert _kernel_merge(beam_s, beam_i, cand_s, cand_i, valid)[2] == 64 + beats
    beam_s[:] = NEG              # every valid candidate joins, and 64 - V invalid ones
    v = int(valid.sum())
    assert _kernel_merge(beam_s, beam_i, cand_s, cand_i, valid)[2] == 64 + v + (64 - v)
    valid[:] = False
    assert _kernel_merge(beam_s, beam_i, cand_s, cand_i, valid)[2] == 128 <= 64 + 1024


@pytest.mark.parametrize("bad_id", ["V+1", "2**31-1", "-1", "-7", "-(V+1)"])
def test_hop_indexes_out_of_range_ids_as_repro(bad_id, no_library):
    """COO ids outside [0, V] in the corpus: the plain hop and the wrapper
    (its plain path on CPU tensors) index the query table as repro's
    ``beam_hop_ref`` does (``qrow[irow]``: a negative id counts from the
    end once, then ids clamp to [0, V]), in the sparse and fused spaces."""
    for space in ("sparse", "fused"):
        kw, rng = _case(space, "f32", seed=41)
        v = kw["qdensified"].shape[1] - 1
        bad = {"V+1": v + 1, "2**31-1": 2 ** 31 - 1, "-1": -1, "-7": -7, "-(V+1)": -(v + 1)}[bad_id]
        kw["c_idx"] = kw["c_idx"].copy()
        kw["c_idx"][::2, 1] = bad                    # every other row
        kw["qdensified"][:, :v] += 0.25              # every column but V weighs in
        n, b, ef = kw["neighbors"].shape[0], 3, 8
        s, ids = _init(rng, n, ef, b, 2)
        names = ("qdensified", "q_dense", "neighbors", "c_idx", "c_val", "c_dense")
        opts = dict(n_valid=n, w_dense=kw["w_dense"], w_sparse=kw["w_sparse"],
                    dense_kind=kw["dense_kind"])
        jargs = {k: _jnp(kw[k]) for k in names}
        targs = {k: _torch(kw[k]) for k in names}
        tvis = tb.mark_visited(torch.zeros((b, tb.visited_words(n)), dtype=torch.int32),
                               torch.from_numpy(ids), n)
        jtable = jnp.asarray(tb.unpack_visited(tvis, n).numpy())
        js, ji, jt = jref.beam_hop_ref(jargs["qdensified"], jargs["q_dense"], jnp.asarray(s),
                                       jnp.asarray(ids), jtable, jargs["neighbors"],
                                       jargs["c_idx"], jargs["c_val"], jargs["c_dense"], **opts)
        hop_args = (targs["qdensified"], targs["q_dense"], torch.from_numpy(s),
                    torch.from_numpy(ids), tvis, targs["neighbors"], targs["c_idx"],
                    targs["c_val"], targs["c_dense"])
        for fn in (tref.beam_hop_plain, tb.beam_hop):
            ts, ti, tw, ta = fn(*hop_args, **opts)
            ctx = f"{space} {bad_id} {fn.__name__}"
            np.testing.assert_array_equal(np.asarray(ji), ti.numpy(), err_msg=ctx)
            assert_scores_close(np.asarray(js), ts.numpy(), ctx=ctx)
            after = tb.unpack_visited(tvis.scatter_add(1, tw.long(), ta), n)
            np.testing.assert_array_equal(np.asarray(jt), after.numpy(), err_msg=ctx)
        assert bool((np.asarray(js) > NEG).any())


@pytest.mark.parametrize("space", SPACES)
def test_beam_topk_matches_repro(space, no_library):
    """``ops.beam_topk`` (seed the mask, hop, rewrite sentinels to the
    degenerate tail) against repro's, from a starved entry beam."""
    kw, rng = _case(space, "f32", n=96, graph="padded", seed=5)
    n, b, ef, k = 96, 3, 8, 6
    s, ids = _init(rng, n, ef, b, sentinels=5)
    names = ("qdensified", "q_dense", "neighbors", "c_idx", "c_val", "c_dense")
    opts = dict(w_dense=kw["w_dense"], w_sparse=kw["w_sparse"], dense_kind=kw["dense_kind"])
    jargs = [_jnp(kw[k_]) for k_ in names]
    targs = [_torch(kw[k_]) for k_ in names]
    want = jops.beam_topk(jargs[0], jargs[1], jnp.asarray(s), jnp.asarray(ids), *jargs[2:],
                          k, 3, n, **opts)
    got = tops.beam_topk(targs[0], targs[1], torch.from_numpy(s), torch.from_numpy(ids),
                         *targs[2:], k, 3, n, **opts)
    np.testing.assert_array_equal(np.asarray(want.indices), got.indices.numpy())
    assert_scores_close(np.asarray(want.scores), got.scores.numpy())
    assert got.indices.dtype == torch.int32
    with pytest.raises(ValueError, match="exceeds the beam width"):
        tops.beam_topk(targs[0], targs[1], torch.from_numpy(s), torch.from_numpy(ids),
                       *targs[2:], ef + 1, 3, n, **opts)


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper's launch branch: with the
    library refused, the call raises instead of running the plain hop."""
    called = []
    monkeypatch.setattr(tref, "beam_hop_plain", lambda *a, **k: called.append(1))

    class FakeCuda:
        shape = (10, 2)
        device = torch.device("cuda")

    z = torch.zeros((1, 2))
    with pytest.raises((ValueError, RuntimeError, AttributeError)):
        tb.beam_hop(None, z, z, torch.zeros((1, 2), dtype=torch.int32),
                    torch.zeros((1, 1), dtype=torch.int32), FakeCuda(), None, None, z,
                    n_valid=10)
    assert not called
