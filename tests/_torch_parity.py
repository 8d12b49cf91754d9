"""Shared helpers for the tests that hold ``repro_torch`` against ``repro``.

Inputs are made once with numpy and fed to both packages: to ``repro`` as
jnp arrays, to ``repro_torch`` through ``repro_torch.interop`` on the CPU.

Tolerance for f32 scores across the two frameworks: ``|torch - jax| <=
F32_RTOL * max|score of the row|``.  Summation order differs between
PyTorch's and XLA's CPU reductions (JAX 0.9.0's own Pallas-interpret and
reference paths already differ by about 2.3e-7 relative), so bitwise
equality is never claimed; a row-scale bound keeps scores that sum to
near zero from turning a few ULPs of the row into a large ratio.  Ids
must be equal.
"""

from __future__ import annotations

import functools
import os
import queue
import sys
import time
import traceback
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch import interop
from repro_torch.serving.batcher import stack_requests

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # benchmarks/

F32_RTOL = 2e-6


def np_of(x):
    """numpy view of a jnp array or CPU tensor; bf16 becomes its uint16 bits."""
    if hasattr(x, "detach"):
        return interop.to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def to_torch(x):
    """A jnp array (or None) -> CPU tensor with the same values and dtype."""
    return None if x is None else interop.tensor(np_of(x), "cpu")


def sparse_to_torch(sp):
    if sp is None:
        return None
    return interop.sparse_vectors(np.asarray(sp.indices), np_of(sp.values), "cpu")


def fused_to_torch(fv):
    d = None if fv.dense is None else np_of(fv.dense)
    if fv.sparse is None:
        return interop.fused_vectors(d, device="cpu")
    return interop.fused_vectors(d, np.asarray(fv.sparse.indices),
                                 np_of(fv.sparse.values), device="cpu")


def assert_scores_close(want, got, rtol: float = F32_RTOL, ctx=""):
    """f32 scores within ``rtol`` of each row's largest |score|; -inf
    tails must align exactly."""
    w = np.asarray(want, np.float64)
    g = np.asarray(got, np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(fin, np.isfinite(g), err_msg=f"tails {ctx}")
    np.testing.assert_array_equal(w[~fin], g[~fin], err_msg=f"tails {ctx}")
    w = w.reshape(-1, w.shape[-1]) if w.ndim else w.reshape(1, 1)
    g = g.reshape(w.shape)
    fin = np.isfinite(w)
    scale = np.max(np.where(fin, np.abs(w), 0.0), axis=-1, keepdims=True)
    err = np.abs(np.where(fin, g, 0.0) - np.where(fin, w, 0.0))
    assert np.all(err <= rtol * np.maximum(scale, 1e-30)), \
        f"score error {np.max(err / np.maximum(scale, 1e-30)):.3g} of row scale > {rtol} {ctx}"


def assert_topk_match(want, got, rtol: float = F32_RTOL, ctx=""):
    """Ids equal; scores within the f32 tolerance above."""
    np.testing.assert_array_equal(np.asarray(want[1]), np.asarray(got[1]),
                                  err_msg=f"ids {ctx}")
    assert_scores_close(want[0], got[0], rtol, ctx)


def planted_fused_np(n, v, nnz, dd, b, k, seed=0, dups=()):
    """numpy form of ``benchmarks/common.py: planted_margin_fused`` (dense
    rows, COO ids/values for corpus and queries), with rows ``r`` in
    ``dups`` overwritten by a copy of row ``r - 1`` to plant exact ties."""
    from benchmarks.common import planted_margin_fused

    corpus, queries = planted_margin_fused(n, v, nnz, dd, b, k, seed=seed)
    c = [np.array(corpus.dense), np.array(corpus.sparse.indices),
         np.array(corpus.sparse.values)]
    for r in dups:
        for a in c:
            a[r] = a[r - 1]
    q = [np.asarray(queries.dense), np.asarray(queries.sparse.indices),
         np.asarray(queries.sparse.values)]
    return c, q


def jnp_fused(parts, dtype=None):
    """(dense, idx, val) numpy -> repro FusedVectors in ``dtype`` (None:
    f32)."""
    import jax.numpy as jnp

    from repro.core.sparse import SparseVectors
    from repro.core.spaces import FusedVectors

    d, i, v = parts
    dtype = jnp.float32 if dtype is None else dtype
    return FusedVectors(jnp.asarray(d, dtype),
                        SparseVectors(jnp.asarray(i, jnp.int32), jnp.asarray(v, dtype)))


def apply_schedule_torch(live, ops, make_rows=lambda rows: rows):
    """Drive a ``repro_torch`` ``LiveCorpus`` through a schedule of
    ``tests/_mutation.py`` (rows as numpy, mapped through ``make_rows``)."""
    for op in ops:
        if op[0] == "insert":
            live.insert(make_rows(op[1]))
        elif op[0] == "delete":
            live.delete(op[1])
        elif op[0] == "upsert":
            live.upsert(op[1], make_rows(op[2]))
        else:
            raise ValueError(f"unknown op {op[0]!r}")
    return live


def assert_torch_topk_equal(got, want, ctx=""):
    """Bitwise equality of two port ``TopK`` results (score bits, ids)."""
    assert got.scores.shape == want.scores.shape, (got.scores.shape, want.scores.shape, ctx)
    assert torch.equal(got.indices, want.indices), f"ids diverge {ctx}"
    assert torch.equal(got.scores.view(torch.int32), want.scores.view(torch.int32)), \
        f"score bits diverge {ctx}"


class FrozenClock:
    """A serving clock that moves only when a test moves it: batches close
    on size, and a partial batch closes on its deadline only once the
    clock is advanced, so that batch composition is deterministic."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


def serve_in_order(svc, endpoint, queries, clock, q_tokens=None, timeout=120.0):
    """Submit ``queries`` to ``endpoint`` of a service running on
    ``clock`` and return the futures once done.  The batches are the
    submission order cut into ``batch_size`` pieces: full ones close on
    size; the partial tail closes on its deadline, which the clock reaches
    only after the worker has taken every queued request."""
    import time

    batcher = svc.router.resolve(endpoint)
    futs = svc.submit_many(queries, q_tokens, endpoint)
    end = time.monotonic() + timeout
    while not all(f.done() for f in futs):
        if batcher.queue_depth() == 0:
            clock.advance(1.0)
        time.sleep(0.002)
        assert time.monotonic() < end, "served requests did not finish"
    return futs


def batched_offline(run, items, pad, batch_size):
    """``run`` over per-request queries ``items`` in the batches a served
    endpoint forms from them in submission order (the tail padded with
    ``pad``): each request's row of its batch's result, as numpy."""
    rows = []
    for lo in range(0, len(items), batch_size):
        part = list(items[lo:lo + batch_size])
        n_real = len(part)
        out = run(stack_requests(part + [pad] * (batch_size - n_real)))
        for i in range(n_real):
            rows.append(type(out)(*(np.asarray(x[i]) for x in out)))
    return rows


class PinnedRoutes:
    """The two packages' MoE routing decisions, call by call, for end-to-end
    comparisons of models with experts.

    Given equal inputs, a router decides alike in both packages (ids equal,
    ``tests/test_torch_moe.py``).  End to end, the residual stream that
    reaches a router differs by the dtype's rounding (an ULP of bf16 here and
    there), and that can flip a decision whose two experts' probabilities
    lie that close; the flipped token's output then differs by a whole
    expert.  This records ``repro``'s ids at every ``route`` call (through
    ``jax.debug.callback``, in call order; install it before ``repro``'s
    function is traced).  At the port's matching call it asserts that every
    decision that differs is such a near-tie (the two experts' probabilities
    within ``near`` times the token's largest, in the port's f32
    probabilities), counts it in ``flips``, and routes the port as ``repro``
    did: ``repro``'s ids with the port's own probabilities for the weights
    and the aux loss.  The rest of the network is then compared on equal
    routes."""

    def __init__(self, monkeypatch, near: float):
        import jax
        from repro.models import moe as JM
        from repro_torch.models import moe as TM

        self.near, self.ref, self.calls, self.flips = near, [], 0, 0
        j_route, self._t_route = JM.route, TM.route

        def record(x, wg, k):
            out = j_route(x, wg, k)
            jax.debug.callback(lambda ids: self.ref.append(np.asarray(ids)), out[0], ordered=True)
            return out

        monkeypatch.setattr(JM, "route", record)
        monkeypatch.setattr(TM, "route", self._pin)

    def _pin(self, x, wg, k):
        ids, w, aux = self._t_route(x, wg, k)
        want = torch.from_numpy(np.array(self.ref[self.calls])).to(ids.device)
        self.calls += 1
        differ = (ids != want).any(dim=-1)
        if not bool(differ.any()):
            return ids, w, aux
        probs = torch.softmax(x.float() @ wg, dim=-1)
        for r in differ.nonzero()[:, 0].tolist():
            got_p, want_p = probs[r, ids[r].long()], probs[r, want[r].long()]
            gap = float((got_p - want_p).abs().max())
            assert gap <= self.near * float(probs[r].max()), \
                f"route call {self.calls - 1}, token {r}: ids {ids[r].tolist()} against repro's " \
                f"{want[r].tolist()}, probabilities {gap:.3g} apart: not a near-tie"
        self.flips += int(differ.sum())
        e = wg.shape[1]
        wv = torch.gather(probs, 1, want.long())
        wv = wv / torch.clamp_min(wv.sum(dim=-1, keepdim=True), 1e-9)
        f_e = torch.nn.functional.one_hot(want.long(), e).float().sum(dim=1).mean(dim=0)
        return want, wv.to(x.dtype), e * torch.sum(f_e * probs.mean(dim=0))

    def done(self):
        """Every recorded call was matched by one of the port's."""
        assert self.calls == len(self.ref) > 0, (self.calls, len(self.ref))


def lm_params(jcfg, seed: int = 0):
    """Random weights for ``repro``'s transformer config ``jcfg`` in its
    parameter tree (jnp arrays; the shapes of ``init_transformer``, traced
    by ``jax.eval_shape``), drawn with numpy at the reference's scales
    (embed and lm_head 0.02, a weight N(0, 1/fan_in)) and the router
    ``wg`` in f32, but with norm scales 1 + N(0, 0.1^2) and QKV biases
    N(0, 0.1^2) so that they count.  Quicker than ``init_transformer``,
    whose eager draws compile for seconds."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    rng = np.random.default_rng(seed)
    dtype = jnp.dtype(jcfg.dtype)
    shapes = jax.eval_shape(lambda k: JT.init_transformer(k, jcfg)[0], jax.random.PRNGKey(0))

    def draw(path, leaf):
        names = [p.key for p in path]
        name, shape = names[-1], leaf.shape
        z = rng.standard_normal(shape)
        if name in ("embed", "lm_head"):
            a = 0.02 * z
        elif name == "scale":
            a = 1.0 + 0.1 * z
        elif name in ("bq", "bk", "bv"):
            a = 0.1 * z
        elif name == "wo":                                   # [L, h, k, d]
            a = z / np.sqrt(shape[1] * shape[2])
        elif "moe" in names and name != "wg":                # [L, E, in, out]
            a = z / np.sqrt(shape[2])
        else:                                                # [L, in, ...]
            a = z / np.sqrt(shape[1])
        return jnp.asarray(a, jnp.float32 if name == "wg" else dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def lm_configs(arch, dtype="float32", **kw):
    """(repro config, port config) of ``arch``'s smoke config in ``dtype``,
    with the fields ``kw`` replaced in both."""
    import dataclasses

    import repro.configs as jc
    import repro_torch.configs as tc

    return (dataclasses.replace(jc.get_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(tc.get_smoke_config(arch), dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _lm_f32_params(arch, kw):
    return lm_params(lm_configs(arch, **dict(kw))[0])


def lm_reference_params(arch, dtype, **kw):
    """:func:`lm_params` of ``arch``'s smoke config (with ``kw``): the f32
    draws, made once per process, every leaf but the f32 router cast to
    ``dtype`` (bf16 rounded once, as ``init_transformer`` casts)."""
    import jax
    import jax.numpy as jnp

    p = _lm_f32_params(arch, tuple(sorted(kw.items())))
    dt = jnp.dtype(dtype)
    return jax.tree_util.tree_map_with_path(lambda path, a: a if path[-1].key == "wg" else a.astype(dt), p)


def lm_model(p, tcfg):
    """The port's ``Transformer`` on the CPU holding ``repro``'s tree ``p``."""
    import jax

    return interop.transformer_params(jax.tree.map(np_of, p), tcfg, "cpu")


def ulp_diff(want, got) -> int:
    """Largest distance in units in the last place between two f32 or bf16
    arrays of one dtype (numpy, bf16 as ``uint16`` bits, or CPU tensors),
    over the ordered bit patterns (so -0 and +0 are 1 apart)."""
    w, g = np_of(want), np_of(got)
    assert w.shape == g.shape and w.dtype == g.dtype, (w.shape, g.shape, w.dtype, g.dtype)
    if w.dtype == np.uint16:
        w, g = w.view(np.int16).astype(np.int64), g.view(np.int16).astype(np.int64)
        lo = np.int64(-1 << 15)
    else:
        w, g = w.view(np.int32).astype(np.int64), g.view(np.int32).astype(np.int64)
        lo = np.int64(-1 << 31)
    order = lambda x: np.where(x < 0, lo - x, x)   # monotone in the value
    return int(np.max(np.abs(order(w) - order(g)), initial=0))


def assert_leaf_close(want, got, rtol, ctx="", floor=0.0):
    """|got - want| <= rtol * max(max|want|, floor) over the whole leaf
    (the leaf's scale), both finite."""
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    g = (got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)).astype(np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(g)), ctx
    scale = max(float(np.abs(w).max(initial=0.0)), floor, 1e-30)
    err = float(np.abs(g - w).max(initial=0.0))
    assert err <= rtol * scale, f"error {err / scale:.3g} of the leaf's scale > {rtol:.3g} {ctx}"


# ---------------------------------------------------------------------------
# Training: the train steps' tolerance and comparisons.
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-5      # of each leaf's largest |value|: losses, gradients, updated parameters, optimizer states
# A gradient that vanishes in exact arithmetic (a bias in front of a softmax, whose
# logits it shifts alike) is rounding noise in both packages: such a leaf is held
# against GRAD_FLOOR times the largest gradient of the whole model instead.
GRAD_FLOOR = 1e-3


def grad_floor(grads) -> float:
    """``GRAD_FLOOR`` times the largest |value| over a ``{name: tensor}``."""
    return GRAD_FLOOR * max(float(g.detach().abs().max()) for g in grads.values())


def lm_batch(vocab, b=8, s=64, seed=0):
    """An LM batch of uniform tokens, the targets the tokens shifted by one."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, 1)}


def port_tree(jtree, model):
    """``repro``'s tree of a transformer's shape (gradients, updated
    parameters) as the port's ``{name: tensor}``."""
    import jax

    carried = interop.transformer_params(jax.tree.map(np_of, jtree), model.cfg, "cpu")
    return dict(carried.named_parameters())


def assert_tree_close(want, got, ctx="", floor=0.0):
    """Two ``{name: tensor}`` with the same names in the same order, each
    leaf within ``TRAIN_TOL`` of ``max(its largest |value|, floor)``."""
    assert list(want) == list(got), ctx
    for k in want:
        assert_leaf_close(want[k].detach().numpy(), got[k], TRAIN_TOL, f"{ctx} {k}", floor)


def assert_adamw_close(want, got, old, new, step, lr, ctx="", rel_floor=0.0, b1=0.9, b2=0.95, eps=1e-8):
    """AdamW's updated parameters ``got`` against the reference's ``want``
    ({name: tensor}): each element within ``TRAIN_TOL`` of its leaf's largest
    |value| plus ``lr`` times the largest move of the reference's update
    ``u(g) = m_hat / (sqrt(v_hat) + eps)`` when its (clipped) gradient ``g``
    moves by ``TRAIN_TOL`` of the leaf's largest |g| (at least ``rel_floor``
    times the largest |g| of the model).  ``g`` comes from the
    reference's moments before (``old``, None at the first step) and
    after (``new``) the step: ``g = (m_new - b1 m_old) / (1 - b1)``."""
    assert list(want) == list(got), ctx
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    m0s = {k: 0.0 if old is None else old.m[k].double().numpy() for k in want}
    gs = {k: (new.m[k].double().numpy() - b1 * m0s[k]) / (1 - b1) for k in want}
    floor = rel_floor * max(float(np.abs(g).max()) for g in gs.values())
    for k in want:
        w, t = want[k].detach().double().numpy(), got[k].detach().double().numpy()
        m0, g = m0s[k], gs[k]
        v0 = 0.0 if old is None else old.v[k].double().numpy()

        def u(x):
            return ((b1 * m0 + (1 - b1) * x) / bc1) / (np.sqrt((b2 * v0 + (1 - b2) * x * x) / bc2) + eps)

        d = TRAIN_TOL * max(np.abs(g).max(), floor)
        moves = np.maximum(np.abs(u(g + d) - u(g)), np.abs(u(g - d) - u(g)))
        bound = TRAIN_TOL * np.abs(w).max() + lr * moves
        err = np.abs(t - w)
        worst = np.argmax(err - bound)
        assert np.all(err <= bound), f"{ctx} {k}: error {err.flat[worst]:.3g} > bound {bound.flat[worst]:.3g}"


def assert_step_close(opt_name, want_p, got_p, old, new, step, lr, ctx=""):
    """Parameters after a step: :func:`assert_adamw_close` for AdamW, ``TRAIN_TOL``
    for Adafactor (its factored ``r vc`` sits far from the floor ``eps``)."""
    if opt_name == "adamw":
        assert_adamw_close(want_p, got_p, old, new, step, lr, ctx)
    else:
        assert_tree_close(want_p, got_p, ctx)




# ---- ranks: the port's SPMD code on gloo ranks on the CPU -------------------

RANK_TIMEOUT_S = 60.0   # the rendezvous and each collective; a dead peer fails the others


def _rank_main(body, rank, world, store, args_path, results):
    """One spawned rank: a single thread, the gloo group, ``body`` on the
    arguments pickled at ``args_path``; its result or its traceback goes
    to ``results``."""
    torch.set_num_threads(1)
    import pickle

    import torch.distributed as dist

    from repro_torch.distributed.mesh_utils import init_rank

    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        init_rank(rank, world, store, timeout_s=RANK_TIMEOUT_S)
        results.put((rank, True, body(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(body, world: int, tmp_path, *args, timeout: float = 180.0):
    """``[body(rank, world, *args) for rank in range(world)]``, each in a
    spawned process joined to one gloo group of ``world`` ranks through a
    ``file://`` store under ``tmp_path`` (no port: xdist workers cannot
    collide).  ``body`` is a module-level function of a module that imports
    no JAX (a rank imports that module); its result is pickled back.  A
    rank that raises fails this call with its traceback as soon as it is
    reported, and every rank is stopped; so is one that dies silently or
    outlives ``timeout``.  ``args`` go through a file: a start whose
    arguments overflow the pipe to a new process waits for that process
    to import its modules, and the starts would run one after another."""
    import pickle

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    stem = os.path.join(str(tmp_path), uuid.uuid4().hex)
    with open(stem + ".args", "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main, args=(body, r, world, stem + ".store", stem + ".args", results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                silent = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                if silent:
                    raise AssertionError(f"ranks {silent} died without a result "
                                         f"(exit codes {[procs[r].exitcode for r in silent]})")
                if time.monotonic() > deadline:
                    raise AssertionError(f"ranks {sorted(set(range(world)) - set(got))} took over {timeout} s")
                continue
            if not ok:
                raise AssertionError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(got) == world else 0.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        results.close()
    return [got[r] for r in range(world)]


# ---- repro on forced host devices: the reference side of the mesh tests ----

class ReproMesh:
    """``tests/_torch_mesh_ref.<fn>(*args)`` running in a subprocess that
    sees ``n_devices`` forced host devices (JAX fixes its device count when
    it starts, so the test process, which sees one, cannot run it); the
    arguments and the result go through pickle files under ``tmp_path``.
    It starts at once, so that the port's ranks can run meanwhile;
    :meth:`result` waits for it."""

    def __init__(self, fn: str, tmp_path, *args, n_devices: int = 8, timeout: float = 300.0):
        import pickle
        import subprocess
        import sys

        stem = os.path.join(str(tmp_path), uuid.uuid4().hex)
        self.out_path, self.timeout = stem + ".out", timeout
        with open(stem + ".in", "wb") as f:
            pickle.dump(args, f)
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
                   JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([os.path.join(os.path.dirname(here), "src"), here]))
        code = ("import pickle\nimport _torch_mesh_ref as m\n"
                f"args = pickle.load(open({stem + '.in'!r}, 'rb'))\n"
                f"pickle.dump(m.{fn}(*args), open({self.out_path!r}, 'wb'))\n")
        self.proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def result(self):
        import pickle
        import subprocess

        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise AssertionError(f"repro's mesh reference took over {self.timeout} s")
        if self.proc.returncode != 0:
            raise AssertionError(f"repro's mesh reference failed:\n{out[-2000:]}\n{err[-4000:]}")
        with open(self.out_path, "rb") as f:
            return pickle.load(f)
