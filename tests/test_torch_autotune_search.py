"""The search half of repro_torch.serving.autotune held against
repro.serving.autotune: the genome operators draw for draw, the roofline
proxy, the NSGA-II machinery, the evolution loop and the load test.

Where the two packages part, on purpose (``ROADMAP.md`` queue C):

* the port drops a ``tile_n`` gene on a kernel genome (``"pallas"``)
  where repro keeps it.  Both consume the generator alike, so every
  genome is equal once repro's is read with that gene dropped
  (:func:`_as_port`), and the generators' states stay equal.  The
  sequences part where :func:`mutate` picks that gene of a kernel genome
  (the port's repaired genome equals its parent and draws again) and
  where :func:`crossover` gives a streaming child the tile of a kernel
  parent (repro's child has it, the port's has none).
* ``measure_config`` accepts the identity ``"cuda"`` for a kernel genome,
  and only for one.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from repro.launch import roofline as j_roofline
from repro_torch.launch import roofline as t_roofline
from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors
from repro_torch.core.sparse import SparseVectors

pytestmark = pytest.mark.torch

ja = importlib.import_module("repro.serving.autotune")          # both packages export a
ta = importlib.import_module("repro_torch.serving.autotune")    # function of this name too


def _as_port(cfg):
    """repro's genome in the port's types, its kernel tile gene dropped."""
    d = cfg.to_dict()
    if d["backend"] == "pallas":
        d["tile_n"] = None
    return ta.ServingConfig(**d)


def _state(rng):
    return rng.bit_generator.state["state"]


@pytest.mark.parametrize("k", [1, 10, 50])
@pytest.mark.parametrize("seed", range(4))
def test_random_config_draws_equal_repro_draw_for_draw(seed, k):
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    kernel_tiles = 0
    for _ in range(60):
        want, got = ja.random_config(jr, k), ta.random_config(tr, k)
        assert got == _as_port(want)
        assert _state(tr) == _state(jr)
        assert ta.check_config(got, k) is None
        kernel_tiles += want.backend == "pallas" and want.tile_n is not None
    assert kernel_tiles > 0, "no kernel genome with a tile drawn: the legality difference is untested"


def _non_kernel_parents(seed, k, n=40):
    rng = np.random.default_rng(seed + 100)
    cfgs = [ja.random_config(rng, k) for _ in range(n)]
    return [c for c in cfgs if c.backend != "pallas"]


@pytest.mark.parametrize("seed", range(4))
def test_mutate_equals_repro_on_genomes_both_rules_allow(seed):
    """Parents without a kernel tile: every mutation (including a flip to
    ``"pallas"``, whose tile the port drops) equal, generators in step."""
    k = 10
    for parent in _non_kernel_parents(seed, k):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(8):
            want = ja.mutate(parent, jr, k)
            got = ta.mutate(_as_port(parent), tr, k)
            assert got == _as_port(want)
            assert _state(tr) == _state(jr)


def test_mutate_parts_from_repro_on_a_kernel_tile_pick():
    """The recorded place where the sequences part: repro's mutation of a
    ``"pallas"`` genome that picks its tile gene returns a new tile; the
    port's repair drops the tile, finds the parent again and draws on."""
    k = 10
    parent = ja.ServingConfig(backend="pallas", tile_n=None)
    knobs = ja._knobs_for("pallas")
    assert ta._knobs_for("pallas") == knobs           # the pick draws alike
    parted = 0
    for seed in range(200):
        jr = np.random.default_rng(seed)
        if knobs[int(np.random.default_rng(seed).integers(len(knobs)))] != "tile_n":
            continue
        tr = np.random.default_rng(seed)
        want = ja.mutate(parent, jr, k)
        got = ta.mutate(_as_port(parent), tr, k)
        if want.tile_n is not None and want.backend == "pallas":
            assert got != _as_port(want) or _state(tr) != _state(jr)
            assert got.tile_n is None and ta.check_config(got, k) is None
            parted += 1
    assert parted > 0


@pytest.mark.parametrize("seed", range(4))
def test_crossover_equals_repro(seed):
    """Parents both rules allow; every draw equal (the generator sees one
    draw a gene either way)."""
    k = 10
    pool = _non_kernel_parents(seed, k)
    jr, tr = np.random.default_rng(seed + 7), np.random.default_rng(seed + 7)
    for a, b in zip(pool[::2], pool[1::2]):
        want = ja.crossover(a, b, jr, k)
        got = ta.crossover(_as_port(a), _as_port(b), tr, k)
        assert got == _as_port(want)
        assert _state(tr) == _state(jr)


def test_crossover_parts_from_repro_on_a_kernel_parents_tile():
    """The other recorded parting: a child that takes the backend of a
    streaming parent and the tile gene of a ``"pallas"`` parent gets
    repro's pallas tile there and none here; the draws stay in step."""
    k = 10
    a = ja.ServingConfig(backend="pallas", tile_n=1024)
    b = ja.ServingConfig(backend="streaming", tile_n=512)
    parted = 0
    for seed in range(64):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        want = ja.crossover(a, b, jr, k)
        got = ta.crossover(_as_port(a), _as_port(b), tr, k)
        assert _state(tr) == _state(jr)
        if want.backend == "streaming" and want.tile_n == 1024:
            assert got == ta.ServingConfig(**{**want.to_dict(), "tile_n": None})
            parted += 1
        else:
            assert got == _as_port(want)
    assert parted > 0


def test_repaired_kernel_genomes_carry_no_tile():
    d = ta.ServingConfig(backend="streaming", tile_n=512).to_dict()
    d["backend"] = "pallas"
    got = ta._repair(d, np.random.default_rng(0), 10)
    assert got == ta.ServingConfig(backend="pallas")
    d = ja.ServingConfig(backend="streaming", tile_n=512).to_dict()
    d["backend"] = "pallas"
    assert ja._repair(d, np.random.default_rng(0), 10).tile_n == 512     # repro keeps it


# ---------------------------------------------------------------------------
# The roofline proxy.
# ---------------------------------------------------------------------------

@pytest.fixture
def port_roofline(monkeypatch):
    """repro's proxy on the port's Hopper terms."""
    monkeypatch.setattr(j_roofline, "serving_scan_seconds", t_roofline.serving_scan_seconds)
    monkeypatch.setattr(j_roofline, "serving_visit_seconds", t_roofline.serving_visit_seconds)


@pytest.mark.parametrize("repeat_fraction", [0.0, 0.5, 0.99])
@pytest.mark.parametrize("n_docs,dim", [(4096, 64), (1_048_576, 768), (8_841_823, 768)])
def test_proxy_objectives_equal_repro_on_the_port_roofline(port_roofline, n_docs, dim, repeat_fraction):
    rng = np.random.default_rng(n_docs % 97)
    cfgs = [ja.random_config(rng, 10) for _ in range(80)]
    cfgs += [ja.ServingConfig(backend="graph_ann", ef=64, hops=None),
             ja.ServingConfig(backend="napp", num_search=8, rerank_qty=256, batch_size=128),
             ja.ServingConfig(backend="streaming", tile_n=512, n_shards=4, max_queue=32)]
    for cfg in cfgs:
        port = _as_port(cfg)
        if port != cfg:          # a kernel tile: compare on the genome the port keeps
            cfg = ja.ServingConfig(**port.to_dict())
        want = ja.proxy_objectives(cfg, n_docs=n_docs, dim=dim, k=10, repeat_fraction=repeat_fraction)
        got = ta.proxy_objectives(port, n_docs=n_docs, dim=dim, k=10, repeat_fraction=repeat_fraction)
        assert got == want, cfg


def test_proxy_model_constants_are_repros():
    assert ta._PROXY_BATCH_OVERHEAD_S == ja._PROXY_BATCH_OVERHEAD_S
    assert ta._PROXY_FLOOD_BACKLOG == ja._PROXY_FLOOD_BACKLOG
    assert ta._GRAPH_DEGREE == ja._GRAPH_DEGREE


# ---------------------------------------------------------------------------
# NSGA-II machinery on equal objective vectors.
# ---------------------------------------------------------------------------

def _objectives(seed, n=40, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        return [tuple(float(x) for x in rng.integers(0, 4, 3)) for _ in range(n)]
    return [tuple(float(x) for x in rng.standard_normal(3)) for _ in range(n)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_sorting_and_crowding_equal_repro(seed, ties):
    objs = _objectives(seed, ties=ties)
    fronts = ta.nondominated_sort(objs)
    assert fronts == ja.nondominated_sort(objs)
    for front in fronts:
        assert ta.crowding_distance(objs, front) == ja.crowding_distance(objs, front)
    assert ta._rank_order(objs) == ja._rank_order(objs)
    for a in objs[:10]:
        for b in objs[:10]:
            assert ta.dominates(a, b) == ja.dominates(a, b)


def test_crowding_of_small_fronts_is_infinite():
    objs = _objectives(0, n=3)
    assert ta.crowding_distance(objs, [0, 2]) == {0: math.inf, 2: math.inf}


@pytest.mark.parametrize("budget", [1, 4, 20, 100])
def test_roofline_prune_equals_repro(port_roofline, budget):
    rng = np.random.default_rng(budget)
    cfgs = [ja.random_config(rng, 10) for _ in range(40)]
    cfgs = [ja.ServingConfig(**_as_port(c).to_dict()) for c in cfgs]
    kw = dict(n_docs=1_048_576, dim=768, k=10, repeat_fraction=0.5)
    want, n_want = ja.roofline_prune(cfgs, budget, **kw)
    got, n_got = ta.roofline_prune([_as_port(c) for c in cfgs], budget, **kw)
    assert n_got == n_want and got == [_as_port(c) for c in want]


def _points(mod, seed, n=30, ties=False):
    objs = _objectives(seed, n, ties)
    return [mod.MeasuredPoint(config=mod.ServingConfig(batch_size=1 + i), qps=q, p50_ms=1.0,
                              p99_ms=-lat, recall=r, identity="reference")
            for i, (q, lat, r) in enumerate(objs)]


@pytest.mark.parametrize("ties", [False, True])
def test_pareto_front_equals_repro(ties):
    want = ja.pareto_front(_points(ja, 3, ties=ties))
    got = ta.pareto_front(_points(ta, 3, ties=ties))
    assert [p.to_row() for p in got] == [p.to_row() for p in want]
    assert ta.pareto_front([]) == []


# ---------------------------------------------------------------------------
# The evolution loop, with a deterministic stand-in for the load test.
# ---------------------------------------------------------------------------

def _fake_measure(cfg):
    qps, neg_lat, recall = ta.proxy_objectives(cfg, n_docs=4096, dim=64, k=10)
    return ta.MeasuredPoint(config=cfg, qps=qps, p50_ms=-neg_lat * 500.0, p99_ms=-neg_lat * 1000.0,
                            recall=recall, identity="cuda" if cfg.backend == "pallas" else cfg.backend)


@pytest.mark.parametrize("seed", range(3))
def test_autotune_is_deterministic_in_its_seed(seed):
    kw = dict(k=10, n_docs=4096, dim=64, seed=seed, generations=3, population=10, measure_budget=3)
    r1, r2 = ta.autotune(_fake_measure, **kw), ta.autotune(_fake_measure, **kw)
    assert [p.config for p in r1.archive] == [p.config for p in r2.archive]
    assert [p.config for p in r1.front] == [p.config for p in r2.front]
    assert r1.counts == r2.counts
    c = r1.counts
    assert c["pruned"] + c["measured"] == c["generated"]
    objs = [p.objectives() for p in r1.archive]
    for p in r1.front:
        assert not any(ta.dominates(o, p.objectives()) for o in objs)


def test_autotune_replays_on_recorded_numbers():
    """A second search on the first one's measurements asks for the same
    genomes in the same order (the chip smoke's check)."""
    asked = []
    kw = dict(k=10, n_docs=4096, dim=64, seed=5, generations=2, population=12, measure_budget=4)
    first = ta.autotune(lambda cfg: asked.append(cfg) or _fake_measure(cfg), **kw)
    recorded = {cfg.key(): _fake_measure(cfg) for cfg in asked}
    again = []
    second = ta.autotune(lambda cfg: again.append(cfg) or recorded[cfg.key()], **kw)
    assert again == asked and second.counts == first.counts


def test_autotune_explore_and_seed_points():
    explore = [ta.ServingConfig(backend="pallas"), ta.ServingConfig(backend="pallas", tile_n=512),
               ta.ServingConfig(backend="napp", num_search=8, rerank_qty=64)]
    seed_point = _fake_measure(ta.ServingConfig(batch_size=4))
    seen = []
    r = ta.autotune(lambda cfg: seen.append(cfg) or _fake_measure(cfg), k=10, n_docs=4096, dim=64,
                    seed=0, generations=1, population=3, measure_budget=3,
                    explore_configs=explore, seed_points=[seed_point])
    assert seed_point in r.archive
    assert seen == [explore[0], explore[2], seen[2]]      # the kernel tile is illegal here
    assert r.counts["generated"] == 1 + 3


def test_unmeasurable_configs_are_skipped():
    r = ta.autotune(lambda cfg: None, k=10, n_docs=4096, dim=64, seed=0, generations=1,
                    population=4, measure_budget=2)
    assert r.archive == [] and r.front == [] and r.counts["measured"] == 2


# ---------------------------------------------------------------------------
# The load test on the CPU (the cuda backend's plain versions).
# ---------------------------------------------------------------------------

def _served_setup(fused=False, n=512, d=16, nq=24, v=64):
    rng = np.random.default_rng(0)
    dense = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    qd = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    if fused:
        idx = torch.from_numpy(rng.integers(0, v, (n, 4)).astype(np.int32))
        val = torch.from_numpy(rng.random((n, 4)).astype(np.float32))
        qi = torch.from_numpy(rng.integers(0, v, (nq, 3)).astype(np.int32))
        qv = torch.from_numpy(rng.random((nq, 3)).astype(np.float32))
        space = FusedSpace(v, 0.5, 1.5)
        corpus = FusedVectors(dense, SparseVectors(idx, val))
        queries = FusedVectors(qd, SparseVectors(qi, qv))
    else:
        space, corpus, queries = DenseSpace("ip"), dense, qd
    from repro_torch.core.backends import ReferenceBackend
    from repro_torch.core.spaces import map_tensors
    head = map_tensors(lambda x: x[:16], queries)
    warm = map_tensors(lambda x: x[16:], queries)
    oracle = ReferenceBackend().topk(space, head, corpus, 5).indices
    return dict(space=space, corpus=corpus, queries=head, warmup_queries=warm,
                workload=np.arange(24) % 16, k=5, oracle_indices=oracle, check_n=8)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["reference", "pallas", "streaming"])
def test_measure_config_serves_each_exact_path(backend, fused):
    """Every request row of a dense or fused batch is served; the kernel
    genome is served by the ``cuda`` backend and published as such."""
    setup = _served_setup(fused)
    cfg = ta.ServingConfig(backend=backend, batch_size=4, max_wait_s=0.002, cache_size=64)
    p = ta.measure_config(cfg, **setup)
    assert p is not None and p.recall == 1.0
    assert p.identity.startswith("cuda" if backend == "pallas" else backend)
    assert p.corpus_dtype == "float32" and p.qps > 0


def test_measure_config_refuses_a_fallback_identity(monkeypatch):
    """A kernel genome served by anything but ``cuda`` is refused, as
    repro refuses any identity that does not name the genome's path."""
    from repro_torch.core.backends import ReferenceBackend

    setup = _served_setup()
    monkeypatch.setattr(ta.ServingConfig, "make_backend", lambda self: ReferenceBackend())
    with pytest.raises(RuntimeError, match="refusing to publish"):
        ta.measure_config(ta.ServingConfig(backend="pallas", batch_size=4, max_wait_s=0.002), **setup)


def test_served_as_declared_accepts_cuda_for_kernel_genomes_only():
    ok = ta._served_as_declared
    assert ok(ta.ServingConfig(backend="pallas"), "cuda")
    assert ok(ta.ServingConfig(backend="pallas"), "pallas")
    assert not ok(ta.ServingConfig(backend="pallas"), "reference")
    assert not ok(ta.ServingConfig(backend="reference"), "cuda")
    assert not ok(ta.ServingConfig(backend="streaming"), "cuda")
    assert ok(ta.ServingConfig(backend="graph_ann", ef=64), "graph_ann(degree=16,...)")
    assert not ok(ta.ServingConfig(backend="napp", num_search=8, rerank_qty=64), None)


def test_measure_config_with_a_sharded_genome():
    setup = _served_setup()
    cfg = ta.ServingConfig(backend="reference", n_shards=2, batch_size=8, max_wait_s=0.002)
    p = ta.measure_config(cfg, **setup)
    assert p is not None and p.recall == 1.0 and p.identity == "reference"


def test_serving_package_exports_the_search():
    import repro_torch.serving as serving

    for name in ("autotune", "measure_config", "pareto_front", "proxy_objectives",
                 "roofline_prune", "random_config", "mutate", "crossover", "dominates",
                 "nondominated_sort", "crowding_distance", "AutotuneResult"):
        assert name in serving.__all__ and getattr(serving, name) is getattr(ta, name)
