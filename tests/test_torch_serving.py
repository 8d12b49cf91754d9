"""repro_torch.serving's batcher, router, service and stats, and the
``launch/serve.py`` shim, held against ``repro``'s on the CPU.

Served answers must equal the port's own offline run of the same batches
bit for bit (ids and score bits), and ``repro``'s served answers with ids
equal and scores within ``F32_RTOL``.  Batches are made deterministic with
an injected clock that moves only when the test moves it
(``_torch_parity.FrozenClock``), so that the counters of both packages
(requests, batches, close reasons, batch fill, cache hits and misses,
rejected and shed requests) can be compared exactly; latencies are not
compared.  The kernel backend ``cuda`` runs its plain versions here.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jp
from repro.core.spaces import DenseSpace as JDense
from repro.core.spaces import FusedSpace as JFused
from repro.launch.serve import BatchingServer as JBatchingServer
from repro import serving as js
from repro_torch import serving as ts
from repro_torch.core import backends as tb
from repro_torch.core import pipeline as tp
from repro_torch.core.spaces import DenseSpace, FusedSpace
from repro_torch.launch.serve import BatchingServer
from repro_torch.serving import (EndpointSpec, LiveCorpus, LiveGenerator, RetrievalService,
                                 ServiceOverloaded)

from _torch_parity import (FrozenClock, assert_scores_close, batched_offline, fused_to_torch,
                           jnp_fused, planted_fused_np, serve_in_order)

pytestmark = pytest.mark.torch

N, D, NQ, BS = 96, 16, 40, 16


def _dense_np(seed=0, n=N, nq=NQ):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32),
            rng.standard_normal((nq, D)).astype(np.float32))


def _pipes(corpus, cand_qty=20, final_qty=10):
    jpipe = jp.RetrievalPipeline(jp.BruteForceGenerator(JDense("ip"), jnp.asarray(corpus)),
                                 cand_qty=cand_qty, final_qty=final_qty)
    tpipe = tp.RetrievalPipeline(tp.BruteForceGenerator(DenseSpace("ip"), torch.from_numpy(corpus)),
                                 cand_qty=cand_qty, final_qty=final_qty)
    return jpipe, tpipe


def _rows_equal(got, want, ctx=""):
    """Bitwise equality of served numpy rows (score bits, ids)."""
    assert len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.indices, w.indices), f"ids {ctx} row {i}"
        assert np.array_equal(np.asarray(g.scores).view(np.int32),
                              np.asarray(w.scores).view(np.int32)), f"score bits {ctx} row {i}"


def _rows_match(jrows, trows, ctx=""):
    """repro's rows against the port's: ids equal, scores within F32_RTOL."""
    assert len(jrows) == len(trows), ctx
    for i, (j, t) in enumerate(zip(jrows, trows)):
        np.testing.assert_array_equal(np.asarray(j.indices), t.indices, err_msg=f"ids {ctx} row {i}")
        assert_scores_close(np.asarray(j.scores)[None], t.scores[None], ctx=f"{ctx} row {i}")


def _serve(lib, pipe, items, pad, spec, name="ep", **svc_kw):
    clock = FrozenClock()
    svc = lib.RetrievalService(time_fn=clock, **svc_kw)
    try:
        svc.register_pipeline(name, pipe, pad, spec=spec)
        rows = [f.result() for f in serve_in_order(svc, name, items, clock)]
        return rows, svc.snapshot().endpoints[name]
    finally:
        svc.close()


class TestServedEqualsOffline:
    @pytest.mark.parametrize("backend", ["cuda", "pallas", "reference", "streaming"])
    def test_dense(self, backend):
        """40 requests: two full batches of 16 and a padded tail of 8."""
        c, q = _dense_np()
        jpipe, tpipe = _pipes(c)
        tq = [torch.from_numpy(x) for x in q]
        pad = torch.zeros(D)
        got, ep = _serve(ts, tpipe, tq, pad, EndpointSpec(batch_size=BS, backend=backend),
                         cache_size=0)
        bound = tpipe.with_backend(backend)
        _rows_equal(got, batched_offline(bound.run, tq, pad, BS), backend)
        jrows, jep = _serve(js, jpipe, [jnp.asarray(x) for x in q], jnp.zeros(D),
                            js.EndpointSpec(batch_size=BS), cache_size=0)
        _rows_match(jrows, got, backend)
        assert (ep.n_batches, ep.closed_by_size, ep.closed_by_deadline) == (3, 2, 1)
        assert ep.mean_batch_fill == pytest.approx(NQ / (3 * BS)) == jep.mean_batch_fill
        assert ep.backend == tb.backend_identity(bound.backend)

    def test_fused_on_the_kernel_backend(self):
        (cd, ci, cv), (qd, qi, qv) = planted_fused_np(128, 40, 6, 8, 24, 10, seed=3)
        jspace, tspace = JFused(40, 0.6, 0.4), FusedSpace(40, 0.6, 0.4)
        jc, jq = jnp_fused((cd, ci, cv)), jnp_fused((qd, qi, qv))
        tc, tq = fused_to_torch(jc), fused_to_torch(jq)
        tpipe = tp.RetrievalPipeline(tp.BruteForceGenerator(tspace, tc, backend="cuda"),
                                     cand_qty=20, final_qty=10)
        jpipe = jp.RetrievalPipeline(jp.BruteForceGenerator(jspace, jc), cand_qty=20, final_qty=10)
        items = [type(tq)(tq.dense[i], type(tq.sparse)(tq.sparse.indices[i], tq.sparse.values[i]))
                 for i in range(24)]
        pad = items[0]
        got, ep = _serve(ts, tpipe, items, pad, EndpointSpec(batch_size=BS), cache_size=0)
        _rows_equal(got, batched_offline(tpipe.run, items, pad, BS), "fused")
        jitems = [jax.tree.map(lambda x, i=i: x[i], jq) for i in range(24)]
        jrows, _ = _serve(js, jpipe, jitems, jitems[0], js.EndpointSpec(batch_size=BS), cache_size=0)
        _rows_match(jrows, got, "fused")
        assert ep.backend == "cuda" and ep.corpus_dtype == "float32"

    def test_partial_batch_padding(self):
        """3 requests in a 16-slot batch: the pad rows are scored and
        dropped without touching the real rows."""
        c, q = _dense_np(seed=1)
        _, tpipe = _pipes(c)
        tq = [torch.from_numpy(x) for x in q[:3]]
        pad = torch.full((D,), 7.0)
        got, ep = _serve(ts, tpipe, tq, pad, EndpointSpec(batch_size=BS), cache_size=0)
        _rows_equal(got, batched_offline(tpipe.run, tq, pad, BS), "partial")
        assert ep.n_batches == 1 and ep.mean_batch_fill == pytest.approx(3 / BS)

    def test_requests_move_to_the_pad_device_and_dtype(self):
        """numpy requests (as a front end receives them) are stacked and
        cast to the pad query's dtype, one copy per leaf."""
        c, q = _dense_np(seed=2)
        _, tpipe = _pipes(c)
        pad = torch.zeros(D)
        got, _ = _serve(ts, tpipe, [x.astype(np.float64) for x in q[:5]], pad,
                        EndpointSpec(batch_size=4), cache_size=0)
        want = batched_offline(tpipe.run, [torch.from_numpy(x) for x in q[:5]], pad, 4)
        _rows_equal(got, want, "numpy requests")


def _tokens_runner(lib):
    if lib is js:
        return lambda batch, tokens: batch + tokens.sum(axis=-1, keepdims=True)
    return lambda batch, tokens: batch + tokens.sum(dim=-1, keepdim=True)


def test_q_tokens_ride_on_their_own_row_as_in_repro():
    outs = {}
    for lib, arr in ((js, jnp.asarray), (ts, torch.as_tensor)):
        clock = FrozenClock()
        with lib.RetrievalService(cache_size=0, time_fn=clock) as svc:
            svc.register_runner("tok", _tokens_runner(lib), arr(np.zeros(2, np.float32)),
                                pad_q_tokens=arr(np.zeros(3, np.int32)),
                                spec=lib.EndpointSpec(batch_size=4))
            futs = serve_in_order(svc, "tok", [arr(np.full(2, i / 4, np.float32)) for i in range(6)],
                                  clock, q_tokens=[arr(np.full(3, i, np.int32)) for i in range(6)])
            outs[lib] = [f.result() for f in futs]
    for i, (j, t) in enumerate(zip(outs[js], outs[ts])):
        assert isinstance(t, np.ndarray)
        np.testing.assert_array_equal(np.asarray(j), t)
        np.testing.assert_array_equal(t, np.full(2, i / 4 + 3 * i, np.float32))


def test_tokens_without_pad_rejected_loudly():
    with RetrievalService(cache_size=0) as svc:
        svc.register_runner("plain", lambda b, _t: b, torch.zeros(2),
                            spec=EndpointSpec(batch_size=2, max_wait_s=0.005))
        with pytest.raises(ValueError, match="pad_q_tokens"):
            svc.submit(torch.zeros(2), q_tokens=torch.zeros(3, dtype=torch.int32), endpoint="plain")


def _counters(snap, name):
    ep = snap.endpoints[name]
    return dict(n_requests=ep.n_requests, n_batches=ep.n_batches, size=ep.closed_by_size,
                deadline=ep.closed_by_deadline, drain=ep.closed_by_drain,
                fill=round(ep.mean_batch_fill, 12), queue_waits=ep.queue_wait.count,
                e2e=ep.e2e.count, hits=snap.cache_hits, misses=snap.cache_misses,
                rejected=ep.rejected, shed=ep.shed, depth_limit=ep.depth_limit,
                total=snap.n_requests)


def _cache_schedule(lib, corpus, queries):
    """10 requests (batches 4, 4 and a tail of 2), the same 10 again (all
    from the cache), then 3 new ones (one batch, closed by its deadline)."""
    jpipe, tpipe = _pipes(corpus)
    pipe, arr = (jpipe, jnp.asarray) if lib is js else (tpipe, torch.from_numpy)
    clock = FrozenClock()
    with lib.RetrievalService(cache_size=64, time_fn=clock) as svc:
        svc.register_pipeline("dense", pipe, arr(np.zeros(D, np.float32)),
                              spec=lib.EndpointSpec(batch_size=4, max_wait_s=0.01))
        first = [f.result() for f in serve_in_order(svc, "dense", [arr(x) for x in queries[:10]], clock)]
        again = [f.result() for f in serve_in_order(svc, "dense", [arr(x) for x in queries[:10]], clock)]
        serve_in_order(svc, "dense", [arr(x) for x in queries[10:13]], clock)
        return _counters(svc.snapshot(), "dense"), first, again


def test_counters_equal_repro_under_a_deterministic_schedule():
    c, q = _dense_np(seed=4)
    jc, jfirst, _ = _cache_schedule(js, c, q)
    tc, tfirst, tagain = _cache_schedule(ts, c, q)
    assert tc == jc
    assert (tc["n_batches"], tc["size"], tc["deadline"], tc["hits"], tc["misses"]) == (4, 2, 2, 10, 13)
    _rows_match(jfirst, tfirst, "cached schedule")
    for a, b in zip(tfirst, tagain):          # a hit is the stored row itself
        assert a is b and not a.scores.flags.writeable


def _overload_schedule(lib, policy):
    """A runner parked in its first batch, a queue of depth 2 filled, then
    two more submits under ``policy``."""
    arr = jnp.asarray if lib is js else torch.as_tensor
    gate, entered = threading.Event(), threading.Event()

    def gated(batch, _tokens):
        entered.set()
        assert gate.wait(timeout=30)
        return batch

    def query(v):
        return arr(np.full(2, v, np.float32))

    svc = lib.RetrievalService(cache_size=0)
    outcome = {"rejected_raised": 0, "shed_failed": 0, "blocked": 0, "served": []}
    try:
        svc.register_runner("gated", gated, query(0.0),
                            spec=lib.EndpointSpec(batch_size=1, max_wait_s=0.001, max_queue=2,
                                                  overload=policy))
        futs = [svc.submit(query(1.0), endpoint="gated")]
        assert entered.wait(timeout=10)
        futs += [svc.submit(query(v), endpoint="gated") for v in (2.0, 3.0)]
        outcome["depth_before"] = svc.snapshot().endpoints["gated"].queue_depth
        threads = []
        for v in (4.0, 5.0):
            if policy == "block":
                t = threading.Thread(target=lambda v=v: futs.append(svc.submit(query(v), endpoint="gated")))
                t.start()
                threads.append(t)
            else:
                try:
                    futs.append(svc.submit(query(v), endpoint="gated"))
                except (ServiceOverloaded, js.ServiceOverloaded):
                    outcome["rejected_raised"] += 1
        if threads:
            time.sleep(0.1)
            outcome["blocked"] = sum(t.is_alive() for t in threads)
    finally:
        gate.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for f in futs:
        try:
            outcome["served"].append(float(np.asarray(f.result(timeout=30))[0]))
        except (ServiceOverloaded, js.ServiceOverloaded):
            outcome["shed_failed"] += 1
    outcome["served"].sort()
    svc.close()
    return outcome, _counters(svc.snapshot(), "gated")


@pytest.mark.parametrize("policy", ["reject", "shed_oldest", "block"])
def test_overload_counters_equal_repro(policy):
    j_out, j_counts = _overload_schedule(js, policy)
    t_out, t_counts = _overload_schedule(ts, policy)
    assert t_out == j_out
    assert t_counts == j_counts
    expect = {"reject": (2, 0, 3), "shed_oldest": (0, 2, 3), "block": (0, 0, 5)}[policy]
    assert (t_counts["rejected"], t_counts["shed"], t_counts["n_batches"]) == expect
    assert t_counts["depth_limit"] == 2 and t_out["depth_before"] == 2


def test_snapshot_accounting_and_reset():
    c, q = _dense_np(seed=5)
    _, tpipe = _pipes(c)
    clock = FrozenClock()
    with RetrievalService(cache_size=64, time_fn=clock) as svc:
        svc.register_pipeline("dense", tpipe, torch.zeros(D), spec=EndpointSpec(batch_size=8))
        serve_in_order(svc, "dense", [torch.from_numpy(x) for x in q[:24]], clock)
        snap = svc.snapshot()
        ep = snap.endpoints["dense"]
        assert snap.n_requests == 24 and ep.n_batches == 3 and ep.closed_by_size == 3
        assert ep.queue_wait.count == 24 and ep.execute.count == 3 and ep.e2e.count == 24
        assert ep.queue_depth == 0 and ep.tile_cache == tb.tile_cache_info()
        assert ep.ann_index_cache == tb.ann_index_cache_info()
        svc.reset_stats()
        snap0 = svc.snapshot()
        assert snap0.n_requests == 0 and snap0.endpoints["dense"].n_batches == 0
        serve_in_order(svc, "dense", [torch.from_numpy(q[30])], clock)
        assert svc.snapshot().endpoints["dense"].n_batches == 1


def test_runner_failure_fails_the_batch_not_the_worker():
    calls = {"n": 0}

    def flaky(batch, _tokens):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("kernel launch failed")
        return batch * 2

    with RetrievalService(cache_size=0) as svc:
        svc.register_runner("flaky", flaky, torch.zeros(4), spec=EndpointSpec(batch_size=2,
                                                                               max_wait_s=0.01))
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            svc.submit(torch.ones(4), endpoint="flaky").result(timeout=10)
        ok = svc.submit(torch.ones(4), endpoint="flaky").result(timeout=10)
    np.testing.assert_array_equal(ok, np.full(4, 2.0, np.float32))


def test_close_drains_and_refuses():
    c, q = _dense_np(seed=6)
    _, tpipe = _pipes(c)
    svc = RetrievalService(cache_size=0)
    svc.register_pipeline("dense", tpipe, torch.zeros(D), spec=EndpointSpec(batch_size=64,
                                                                             max_wait_s=30.0))
    futs = svc.submit_many([torch.from_numpy(x) for x in q[:3]], endpoint="dense")
    svc.close()
    want = batched_offline(tpipe.run, [torch.from_numpy(x) for x in q[:3]], torch.zeros(D), 64)
    _rows_equal([f.result(timeout=1) for f in futs], want, "drain")
    ep = svc.snapshot().endpoints["dense"]
    assert ep.closed_by_drain == ep.n_batches >= 1 and ep.n_requests == 3
    with pytest.raises(RuntimeError):
        svc.submit(torch.from_numpy(q[0]), endpoint="dense")


def test_router_resolution_as_repro():
    with RetrievalService(cache_size=0) as svc:
        svc.register_runner("a", lambda b, _t: b, torch.zeros(2))
        assert svc.router.resolve(None).name == "a"
        svc.register_runner("b", lambda b, _t: b, torch.zeros(2))
        with pytest.raises(ValueError, match="endpoint required"):
            svc.submit(torch.zeros(2))
        with pytest.raises(KeyError, match="unknown endpoint"):
            svc.submit(torch.zeros(2), endpoint="c")
        with pytest.raises(ValueError, match="already registered"):
            svc.register_runner("a", lambda b, _t: b, torch.zeros(2))
        assert svc.endpoints() == ("a", "b")


def _live_schedule(lib, corpus, queries, upsert_rows):
    """A live endpoint: 8 requests, the same 8 from the cache, an upsert
    of the top hit of each of the first 4 queries, the same 8 again (no
    hit may come from the old generation); then 2 requests admitted
    before an upsert and served after it, stored under the generation
    that served them, and replayed from the cache."""
    arr = jnp.asarray if lib is js else torch.from_numpy
    if lib is js:
        live = js.LiveCorpus(JDense("ip"), arr(corpus), max_append=10 ** 9)
    else:
        live = LiveCorpus(DenseSpace("ip"), arr(corpus), backend="cuda", append_backend="cuda",
                          max_append=10 ** 9, device="cpu")
    clock = FrozenClock()
    items = [arr(x) for x in queries]
    with lib.RetrievalService(cache_size=64, time_fn=clock) as svc:
        svc.register_pipeline("live", None, arr(np.zeros(D, np.float32)),
                              spec=lib.EndpointSpec(batch_size=4, live=live))
        before = [f.result() for f in serve_in_order(svc, "live", items[:8], clock)]
        serve_in_order(svc, "live", items[:8], clock)
        hits0 = svc.snapshot().cache_hits
        ids = np.array([int(r.indices[0]) for r in before[:4]])
        live.upsert(ids, arr(upsert_rows[:len(ids)]))
        after = [f.result() for f in serve_in_order(svc, "live", items[:8], clock)]
        hits1 = svc.snapshot().cache_hits
        # admitted at generation 1, served at generation 2
        futs = svc.submit_many(items[8:10], endpoint="live")
        live.upsert(ids[:1], arr(upsert_rows[4:5]))
        while not all(f.done() for f in futs):
            if svc.router.resolve("live").queue_depth() == 0:
                clock.advance(1.0)
            time.sleep(0.002)
        late = [f.result() for f in futs]
        replay = [f.result() for f in serve_in_order(svc, "live", items[8:10], clock)]
        snap = svc.snapshot()
    return dict(before=before, after=after, late=late, replay=replay, hits0=hits0, hits1=hits1,
                hits=snap.cache_hits, misses=snap.cache_misses,
                generation=snap.endpoints["live"].generation, live=live)


def test_live_endpoint_never_serves_an_old_generation_from_the_cache():
    c, q = _dense_np(seed=7, n=64, nq=10)
    rows = -np.abs(np.random.default_rng(8).standard_normal((5, D))).astype(np.float32) * 0.01
    j = _live_schedule(js, c, q, rows)
    t = _live_schedule(ts, c, q, rows)
    for key in ("before", "after", "late", "replay"):
        _rows_match(j[key], t[key], key)
    assert (t["hits0"], t["hits1"], t["hits"], t["misses"], t["generation"]) == \
        (j["hits0"], j["hits1"], j["hits"], j["misses"], j["generation"]) == (8, 8, 10, 18, 2)
    # the answers after the upsert are the new generation's, not the cache's
    assert any(not np.array_equal(a.indices, b.indices) for a, b in zip(t["before"], t["after"]))
    pipe = tp.RetrievalPipeline(LiveGenerator(t["live"]))
    _rows_equal(t["replay"], t["late"], "re-keyed under the serving generation")
    want = batched_offline(pipe.run, [torch.from_numpy(x) for x in q[8:10]], torch.zeros(D), 4)
    _rows_equal(t["late"], want, "late batch")


def test_live_answers_under_racing_upserts_equal_their_served_generation():
    """A writer upserts fresh ids (2x twins of the queries, in turn) while
    four clients flood a cached live endpoint.  Each answer was stored in
    the cache under the generation that served it, found between its
    submit and its completion; replaying the upserts on a second corpus,
    every answer equals the plain live path on that generation's
    snapshot, ids and score bits."""
    from repro_torch.core import segments
    from repro_torch.serving.batcher import stack_requests

    c, q = _dense_np(seed=11, n=64, nq=48)
    items = [torch.from_numpy(x) for x in q]
    step = 4

    def upsert_args(t):
        j = (np.arange(step) + step * t) % len(items)
        return len(c) + step * t + np.arange(step), torch.from_numpy(2 * q[j])

    def corpus():
        return LiveCorpus(DenseSpace("ip"), torch.from_numpy(c), backend="cuda", append_backend="cuda",
                          max_append=10 ** 9, device="cpu")

    live = corpus()
    gens, results, done, n_up = [None] * len(items), [None] * len(items), threading.Event(), [0]

    def writer():
        while not done.is_set():
            live.upsert(*upsert_args(n_up[0]))
            n_up[0] += 1
            time.sleep(0.002)

    with RetrievalService(cache_size=256) as svc:
        svc.register_pipeline("live", None, torch.zeros(D), spec=EndpointSpec(batch_size=4, live=live))

        def client(k):
            for i in range(k, len(items), 4):
                g0 = live.generation
                fut = svc.submit(items[i], endpoint="live")
                fut.add_done_callback(lambda f, i=i, g0=g0: gens.__setitem__(i, (g0, live.generation)))
                results[i] = fut

        w = threading.Thread(target=writer)
        w.start()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        results = [f.result(timeout=60) for f in results]
        done.set()
        w.join()
        bt = svc.router.resolve("live")
        served = []
        for i, (g0, g1) in enumerate(gens):
            hit = [g for g in range(g0, g1 + 1)
                   if svc.cache.get(svc.cache.key("live", (items[i], None), backend=bt.backend,
                                                  corpus_dtype=bt.corpus_dtype, generation=g)) is not None]
            assert len(hit) == 1, (i, g0, g1, hit)
            served.append(hit[0])
        assert svc.snapshot().cache_hits == 0
    assert n_up[0] >= 2 and len(set(served)) >= 2
    replay = corpus()
    for gen in range(max(served) + 1):
        if gen:
            replay.upsert(*upsert_args(gen - 1))
        snap = replay.snapshot()
        todo = [i for i, g in enumerate(served) if g == gen]
        for lo in range(0, len(todo), 4):
            part = todo[lo:lo + 4]
            batch = stack_requests([items[i] for i in part] + [torch.zeros(D)] * (4 - len(part)))
            want = segments.live_topk(DenseSpace("ip"), snap, batch, 100, main_backend="reference",
                                      append_backend="reference")
            for r, i in enumerate(part):
                row = type(want)(want.scores[r, :10].numpy(), want.indices[r, :10].numpy())
                _rows_equal([results[i]], [row], f"request {i} at generation {gen}")


@pytest.fixture
def fresh_tile_cache():
    tb.clear_tile_cache()
    yield
    tb.clear_tile_cache()


def test_auto_tile_n_is_legal_and_warm(fresh_tile_cache):
    from repro_torch.launch import roofline

    for n, bpr in ((10 ** 6, 64.0), (10 ** 6, 3072.0), (100, 64.0), (5000, 16.0)):
        t = tb.auto_tile_n(n, b=16, k=10, bytes_per_row=bpr, flops_per_row=2 * bpr)
        assert t == tb.legal_tile(n, t) and 1 <= t <= min(n, 16384)
        assert t == min(n, t) and (t == n or t & (t - 1) == 0)
        # the working set fits half a block's shared memory unless no tile does
        fits = t * (2 * bpr + 4 * 16) <= roofline.SMEM_BYTES // 2
        assert fits or t in (128, n)
    assert tb.tile_cache_info() == {"size": 4, "hits": 0, "misses": 4}
    assert tb.auto_tile_n(10 ** 6, b=16, k=10, bytes_per_row=64.0, flops_per_row=128.0) > 0
    assert tb.tile_cache_info()["hits"] == 1


def test_auto_tile_n_counters_exact_under_threads(fresh_tile_cache):
    keys = [dict(n_rows=10 ** 5 + i, b=16, k=10, bytes_per_row=64.0, flops_per_row=128.0)
            for i in range(5)]
    calls, n_threads = 200, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(seed):
            for i in range(calls):
                tb.auto_tile_n(**keys[(seed + i) % len(keys)])
        threads = [threading.Thread(target=work, args=(s,)) for s in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    info = tb.tile_cache_info()
    assert info["hits"] + info["misses"] == calls * n_threads
    assert info["misses"] == len(keys) == info["size"]
    tb.clear_tile_cache()
    assert tb.tile_cache_info() == {"size": 0, "hits": 0, "misses": 0}


def test_batching_server_shim_warns_and_answers_as_repro():
    """13 queries: one batch of 8 closed by size (the window is long enough
    for the first 8 to arrive), then the tail of 5 on the window."""
    rng = np.random.default_rng(9)
    c = rng.standard_normal((128, D)).astype(np.float32)
    qs = rng.standard_normal((13, D)).astype(np.float32)
    tc = torch.from_numpy(c)

    def fn(q):
        return torch.topk(q @ tc.T, 5)

    jcorp = jnp.asarray(c)
    jfn = jax.jit(lambda q: jax.lax.top_k(q @ jcorp.T, 5))
    with pytest.warns(DeprecationWarning, match="EndpointSpec"):
        srv = BatchingServer(fn, batch_size=8, pad_query=torch.zeros(D), window_s=0.5)
    with pytest.warns(DeprecationWarning, match="EndpointSpec"):
        jsrv = JBatchingServer(jfn, batch_size=8, pad_query=jnp.zeros(D), window_s=0.5)
    try:
        out = srv.serve([torch.from_numpy(x) for x in qs])
        jout = jsrv.serve([jnp.asarray(x) for x in qs])
    finally:
        srv.close()
        jsrv.close()
    want_s, want_i = fn(torch.from_numpy(qs[:8]))
    for i in range(8):
        assert np.array_equal(out[i][0], want_s[i].numpy())
        assert np.array_equal(out[i][1], want_i[i].numpy())
    for i in range(13):
        np.testing.assert_array_equal(out[i][1], np.asarray(jout[i][1]))
        assert_scores_close(np.asarray(jout[i][0])[None], out[i][0][None], ctx=f"shim row {i}")
    assert (srv.stats.n_requests, srv.stats.n_batches) == (jsrv.stats.n_requests, jsrv.stats.n_batches) == (13, 2)
    assert srv.stats.mean_latency_ms > 0


ROOFLINE_CASES = [dict(n_rows=n, b=b, k=k, bytes_per_row=bpr, flops_per_row=2 * bpr)
                  for n, b, k, bpr in ((10 ** 6, 16, 10, 64.0), (10 ** 6, 16, 100, 3072.0),
                                       (5000, 4, 10, 16.0), (100, 1, 1, 64.0), (8_841_823, 16, 100, 4096.0))]


def _tpu_constants(monkeypatch):
    """The port's roofline module on repro's TPU figures."""
    from repro.launch import roofline as jr
    from repro_torch.launch import roofline as tr

    monkeypatch.setattr(tr, "PEAK_FLOPS", jr.PEAK_FLOPS)
    monkeypatch.setattr(tr, "HBM_BW", jr.HBM_BW)
    monkeypatch.setattr(tr, "SMEM_BYTES", jr.VMEM_BYTES)
    return jr, tr


def test_roofline_terms_are_repros_formulas(monkeypatch):
    """On repro's constants, the port's terms are repro's, number for number."""
    jr, tr = _tpu_constants(monkeypatch)
    for case in ROOFLINE_CASES:
        n, kw = case["n_rows"], {k: v for k, v in case.items() if k != "n_rows"}
        for tile in (128, 1024, 8192):
            assert tr.topk_tile_seconds(tile, **kw) == jr.topk_tile_seconds(tile, **kw)
        for tile in (None, 0, 1024):
            for shards in (1, 3, 4):
                assert tr.serving_scan_seconds(n, tile_n=tile, n_shards=shards, **kw) == \
                    jr.serving_scan_seconds(n, tile_n=tile, n_shards=shards, **kw)
        assert tr.serving_visit_seconds(n / 1000, b=kw["b"], bytes_per_row=kw["bytes_per_row"],
                                        flops_per_visit=kw["flops_per_row"]) == \
            jr.serving_visit_seconds(n / 1000, b=kw["b"], bytes_per_row=kw["bytes_per_row"],
                                     flops_per_visit=kw["flops_per_row"])
    assert tr.serving_scan_seconds(0, b=1, k=1, bytes_per_row=1.0, flops_per_row=1.0) == 0.0
    assert tr.serving_visit_seconds(0, b=1, bytes_per_row=1.0, flops_per_visit=1.0) == 0.0


def test_auto_tile_n_is_repros_sweep(monkeypatch, fresh_tile_cache):
    """On repro's constants, the port's sweep picks repro's tiles."""
    from repro.core import backends as jbk

    _tpu_constants(monkeypatch)
    jbk.clear_tile_cache()
    try:
        for case in ROOFLINE_CASES:
            for resident in (0.0, 1e6):
                assert tb.auto_tile_n(resident_bytes=resident, **case) == \
                    jbk.auto_tile_n(resident_bytes=resident, **case), case
    finally:
        jbk.clear_tile_cache()
