"""B1's ring route on its row layout (``csrc/ring.cuh`` RowStage: a tile's
whole rows by one bulk copy, for corpora of at most 32 columns whose rows
no tensor map can describe, such as DIN's and DIEN's D = 18) through its
plain emulation (``ref.mips_filter_ref``, the plan the wrapper gives the
row layout: twice the blocks), held against repro's B1,
``mips_topk_pallas`` run in interpret mode as repro's own tests run it,
and against repro's reference backend; and the routing that sends such
corpora to the ring and the rest to the scan route.

Widths: d = 1, 3, 5, 18 and 31 in f32 and d = 5 and 18 in bf16 (crossing
as uint16 bits), every one of them a row that is not a multiple of 16
bytes.  N = 3,001 rows leaves a ragged last tile of 185 rows, whose bytes
end off a 16-byte boundary at every odd d; n_valid below N is odd too.
The inputs are small integers, so every score is exact in f32 (and the
corpus exact in bf16): ids equal and scores equal bit for bit, 0 ULPs.
The width sweep draws nonzero integers: the sign of a sum whose every
product is -0 (a zero query at d = 1) is the library's choice, and the
references disagree on it (repro's Pallas B1 and its reference backend
order such rows differently from each other, PyTorch's CPU product gives
-0 at some shapes and +0 at others, the kernels sum from +0); nonzero
factors give sums that are never -0, on which all of them agree.
At d = 18, the adversarial cases of the filter: a corpus sorted by score,
all scores equal, n_valid below k with a valid row at -inf, NaN of both
signs and +-0 (against the reference backend only: repro's Pallas B1 ranks
every NaN first, see ``test_torch_mips_filter.py``), and a sample that
misses every good row, so that the lists overflow and are sorted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jb
from repro.core.spaces import DenseSpace as JDense
from repro.kernels import ops as jops
from repro_torch.core import backends as tb
from repro_torch.core import pipeline as tp
from repro_torch.core.spaces import DenseSpace
from repro_torch.kernels import _build
from repro_torch.kernels import mips_topk as mk
from repro_torch.kernels import ref as tref

from _torch_parity import np_of, to_torch

pytestmark = pytest.mark.torch

N, B = 3001, 3
WIDTHS = [("f32", d) for d in (1, 3, 5, 18, 31)] + [("bf16", d) for d in (5, 18)]
# (k, n_valid, plan overrides): a sample and a filter (k = 1, 10), a filter
# forced at k = 100 and 356 (the plan makes such a small corpus all sample)
KS = [(1, None, {}), (10, 2989, {}), (100, None, dict(stride=3, blocks=5)), (356, 2601, dict(stride=2, blocks=3))]


@pytest.fixture
def no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = (mk.launches, mk.ring_launches, mk.row_launches, mk.scan_launches)
    yield
    assert (mk.launches, mk.ring_launches, mk.row_launches, mk.scan_launches) == before


def _bits(x):
    return np.asarray(np_of(x), np.float32).view(np.int32)


def _pair(c, q, dtype):
    """numpy f32 corpus and queries -> (jnp corpus, jnp queries, torch corpus, torch queries)."""
    jc = jnp.asarray(c, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    jq = jnp.asarray(q)
    return jc, jq, to_torch(jc), to_torch(jq)


def _equal(want_s, want_i, got_s, got_i, ctx):
    np.testing.assert_array_equal(np.asarray(want_i), np_of(got_i), err_msg=ctx)
    np.testing.assert_array_equal(_bits(want_s), _bits(got_s), err_msg=ctx)


def _nonzero(rng, shape, m):
    """Integers in [-m, m] but 0: no product is a zero, no sum -0."""
    x = rng.integers(1, m + 1, shape) * rng.choice([-1, 1], shape)
    return x.astype(np.float32)


def _run(tq, tc, k, n_valid, space, over):
    """The row layout's emulation under the wrapper's plan, and the CPU wrapper on it."""
    assert mk.ring_layout(tc) == "rows"
    nv = N if n_valid is None else n_valid
    plan = mk.filter_plan(N, nv, k, 2 * 132, **over)
    got_s, got_i, stats = tref.mips_filter_ref(tq, tc, k, plan, n_valid=n_valid, space=space)
    wrap_s, wrap_i, wrap_st = mk.mips_filter(tq, tc, k, n_valid=n_valid, space=space, **over)
    assert torch.equal(wrap_i, got_i) and torch.equal(wrap_s.view(torch.int32), got_s.view(torch.int32))
    assert torch.equal(wrap_st, stats)
    return got_s, got_i, stats, plan


@pytest.mark.parametrize("k,n_valid,over", KS, ids=[f"k{k}" for k, _, _ in KS])
@pytest.mark.parametrize("space", ["ip", "l2"])
@pytest.mark.parametrize("dtype,d", WIDTHS, ids=[f"{t}-d{d}" for t, d in WIDTHS])
def test_rows_match_repro(dtype, d, space, k, n_valid, over, no_library):
    rng = np.random.default_rng(1000 * d + k)
    c = _nonzero(rng, (N, d), 2)
    q = _nonzero(rng, (B, d), 3)
    jc, jq, tc, tq = _pair(c, q, dtype)
    got_s, got_i, stats, plan = _run(tq, tc, k, n_valid, space, over)
    ctx = f"{dtype} d={d} {space} k={k}"
    if k <= 100:   # repro's Pallas B1 in interpret mode (its max / argmax rounds grow with k)
        want = jops.mips_topk(jq, jc, k, tile_n=512, space=space, n_valid=n_valid)
        _equal(want.scores, want.indices, got_s, got_i, ctx)
    ref = jb.ReferenceBackend().topk(JDense(space), jq, jc, k, n_valid=n_valid)
    _equal(ref.scores, ref.indices, got_s, got_i, ctx)
    plain_s, plain_i = tref.mips_topk_ref(tq, tc, k, n_valid=n_valid, space=space)
    assert torch.equal(plain_i, got_i) and torch.equal(plain_s.view(torch.int32), got_s.view(torch.int32))
    assert plan.stride > 1 and plan.blocks > 0, plan   # every case runs the filter
    assert int(stats[:, 0].sum()) == 0 and bool((stats[:, 1] >= plan.k_sample + plan.masked).all())


def _sorted(rng, d):
    c, q = rng.integers(-2, 3, (N, d)).astype(np.float32), rng.integers(-3, 4, (B, d)).astype(np.float32)
    return c[np.argsort(c @ q[0], kind="stable")], q


def _descending(rng, d):
    c, q = _sorted(rng, d)
    return c[::-1].copy(), q


def _all_equal(rng, d):
    return np.ones((N, d), np.float32), np.ones((B, d), np.float32)


def _masked(rng, d):   # n_valid below k; a valid row at -inf
    c, q = rng.integers(-2, 3, (N, d)).astype(np.float32), rng.integers(1, 3, (B, d)).astype(np.float32)
    c[3, 0] = -np.inf
    return c, q


def _nan_zeros(rng, d):   # scores <= 0 but +NaN rows (top) and -NaN rows (bottom); zero rows (ip +0)
    c, q = rng.integers(-2, 1, (N, d)).astype(np.float32), rng.integers(1, 3, (B, d)).astype(np.float32)
    c[rng.choice(N, 30, replace=False), 0] = np.float32("nan")
    c[rng.choice(N, 30, replace=False), 1] = -np.float32("nan")
    c[rng.uniform(size=N) < 0.05] = 0.0
    c[7::97] = q[0]          # l2: these rows score -0 for query 0
    return c, q


def _blind(rng, d):   # the sample's tiles score 0, every other row more: every row passes, the lists overflow
    c, q = rng.integers(1, 3, (N, d)).astype(np.float32), rng.integers(1, 3, (B, d)).astype(np.float32)
    c[(np.arange(N) // mk.TILE) % 4 == 0] = 0.0
    return c, q


# name: (the data, k, n_valid, plan overrides)
CASES = {
    "sorted ascending": (_sorted, 64, None, dict(stride=4, blocks=3)),
    "sorted descending": (_descending, 64, None, dict(stride=4, blocks=3)),
    "all equal": (_all_equal, 64, 2999, dict(stride=4, blocks=3)),
    "n_valid < k, a row at -inf": (_masked, 64, 41, {}),
    "NaN of both signs, +0 and -0": (_nan_zeros, 64, None, dict(stride=4, blocks=3)),
    "lists overflow": (_blind, 64, None, dict(stride=4, blocks=2)),
}


@pytest.mark.parametrize("space", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_rows_adversarial(case, dtype, space, no_library):
    make, k, n_valid, over = CASES[case]
    c, q = make(np.random.default_rng(len(case)), 18)
    jc, jq, tc, tq = _pair(c, q, dtype)
    nv = N if n_valid is None else n_valid
    got_s, got_i, stats, plan = _run(tq, tc, k, n_valid, space, over)
    plain_s, plain_i = tref.mips_topk_ref(tq, tc, k, n_valid=n_valid, space=space)
    assert torch.equal(plain_i, got_i) and torch.equal(plain_s.view(torch.int32), got_s.view(torch.int32))
    if nv >= k:   # the reference backend masks with -inf: its tail differs below n_valid rows
        ref = jb.ReferenceBackend().topk(JDense(space), jq, jc, k, n_valid=n_valid)
        _equal(ref.scores, ref.indices, got_s, got_i, case)
    head = k if nv >= k else nv - 1
    if not case.startswith("NaN"):   # repro's Pallas B1 ranks every NaN first
        want = jops.mips_topk(jq, jc, head, tile_n=512, space=space, n_valid=n_valid)
        _equal(want.scores, want.indices, got_s[:, :head], got_i[:, :head], case)
    if case == "lists overflow":
        assert bool((stats[:, 0] > 0).all()), stats
    else:
        assert int(stats[:, 0].sum()) == 0, stats
    if case == "all equal":   # the k lowest rows
        assert got_i.tolist() == [list(range(k))] * B
    if case.startswith("NaN"):
        assert bool(got_s.isnan().any()) or space == "l2"
    if nv < k:   # the masked rows by row id, all ahead of the valid row at -inf
        assert got_i[0, nv - 1:].tolist() == list(range(nv, k + 1)) and 3 not in got_i[0].tolist()


def test_routing(no_library):
    """The route is a function of shape, dtype and alignment alone: rows of a
    multiple of 16 bytes take the tensor-map layout, other rows of at most
    32 columns the row layout (both two blocks an SM), anything else the
    scan route; on the CPU every route is its plain version."""
    f32, bf16 = torch.float32, torch.bfloat16
    for d, dtype, layout in ((18, f32, "rows"), (18, bf16, "rows"), (1, f32, "rows"), (31, bf16, "rows"),
                             (30, f32, "rows"), (768, f32, "box"), (16, f32, "box"), (32, bf16, "box"),
                             (8, bf16, "box"), (61, f32, None), (33, f32, None), (36, bf16, None)):
        c = torch.zeros(64, d, dtype=dtype)
        assert c.data_ptr() % 16 == 0
        assert mk.ring_layout(c) == layout, (d, dtype)
        assert mk.ring_fits(c) == (layout is not None)
        assert mk._ring_blocks(c, 132) == 264
    # a view 4 bytes off its storage: the scan route, whatever its width
    for d, dtype in ((18, f32), (18, bf16), (64, f32)):
        base = torch.zeros(64 * d + 8, dtype=dtype)
        off = base[4 // base.element_size():][:64 * d].view(64, d)
        assert off.data_ptr() % 16 == 4 and mk.ring_layout(off) is None and not mk.ring_fits(off)
    # the CPU entry points run the plain version, on every route
    rng = np.random.default_rng(3)
    for d in (18, 61):
        c = torch.from_numpy(rng.integers(-2, 3, (700, d)).astype(np.float32))
        q = torch.from_numpy(rng.integers(-3, 4, (4, d)).astype(np.float32))
        want = tref.mips_topk_ref(q, c, 20)
        for got in (mk.mips_topk(q, c, 20), mk.mips_scan(q, c, 20)):
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_din_width_through_the_backend(dtype, no_library):
    """The slice as a whole on the CPU: dense ip over DIN's width (D = 18)
    through the port's generator on the ``cuda`` backend, as the
    recommendation funnel serves it (bf16 by ``with_corpus_dtype``), against
    repro's reference backend over the same rows."""
    rng = np.random.default_rng(18)
    c = rng.integers(-2, 3, (N, 18)).astype(np.float32)
    q = rng.integers(-3, 4, (16, 18)).astype(np.float32)
    gen = tp.BruteForceGenerator(DenseSpace("ip"), torch.from_numpy(c), backend="cuda")
    if dtype == "bf16":
        gen = gen.with_corpus_dtype("bfloat16")
    assert mk.ring_layout(gen.corpus) == "rows"
    got = gen.generate(torch.from_numpy(q), 100)
    jc = jnp.asarray(c, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = jb.ReferenceBackend().topk(JDense("ip"), jnp.asarray(q), jc, 100)
    _equal(want.scores, want.indices, got.scores, got.indices, dtype)
    exact = tb.CudaBackend().topk(DenseSpace("ip"), torch.from_numpy(q), gen.corpus, 100)
    assert torch.equal(exact.indices, got.indices)
