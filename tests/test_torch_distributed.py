"""repro_torch.distributed on gloo ranks: the sharded exact top-k, the
distributed top-k merge, the hierarchical gradient reduction, and
``ParallelCtx`` with a ``DeviceMesh`` against ``repro``'s on the same
inputs (the counterparts of ``tests/test_distributed.py``'s multi-device
cases, which force 8 host devices; here 8 spawned ranks on a (2, 4)
mesh).

The ranks run once for the module (``run_ranks``); each test asserts its
own case.  This module imports no JAX at the top: each rank imports it.
``repro`` runs in the test process, on one CPU device.
"""

import numpy as np
import pytest
import torch

from _torch_parity import run_ranks

pytestmark = pytest.mark.torch

B, N, D, K = 6, 512, 32, 8


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, D)).astype(np.float32)
    c = rng.standard_normal((N, D)).astype(np.float32)
    # margin-planted: query b's top K rows are scaled copies of it, 0.5 apart in score
    planted = c.copy()
    rows = rng.permutation(N)[:B * K].reshape(B, K)
    for b in range(B):
        for j, r in enumerate(rows[b]):
            planted[r] = q[b] * (8.0 + 0.5 * (K - j)) / float(q[b] @ q[b]) ** 0.5
    grads = {"w": (np.arange(16, dtype=np.float32) * 0.5), "b": np.full((3, 5), 2.0, np.float32)}
    return q, c, planted, grads


def _dist_body(rank, world, q, c, planted, grads):
    from torch.distributed.tensor import DTensor

    from repro_torch.core.brute_force import sharded_exact_topk
    from repro_torch.core.spaces import DenseSpace
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.distributed.sharding import NamedSharding, distribute
    from repro_torch.optim.compression import int8_compress, int8_decompress

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    qt = torch.from_numpy(q)
    out = {}

    def top(name, *a, **kw):
        r = sharded_exact_topk(*a, **kw)
        out[name] = (r.scores.numpy(), r.indices.numpy())

    top("ip", DenseSpace("ip"), qt, torch.from_numpy(c), K, mesh)
    top("planted", DenseSpace("ip"), qt, torch.from_numpy(planted), K, mesh)
    top("l2", DenseSpace("l2"), qt, torch.from_numpy(c), K, mesh)
    top("streaming", DenseSpace("ip"), qt, torch.from_numpy(c), K, mesh, tile_n=32)
    top("over data", DenseSpace("ip"), qt, torch.from_numpy(c), K, mesh, corpus_axis="data")
    dt = distribute(torch.from_numpy(c), NamedSharding(mesh, ("model", None)))
    assert isinstance(dt, DTensor) and dt.to_local().shape == (N // 4, D)
    top("dtensor", DenseSpace("ip"), qt, dt, K, mesh)

    # distributed_topk: each rank of the model axis scores its column block
    per = N // 4
    base = mesh.get_local_rank("model") * per
    s = qt @ torch.from_numpy(c[base:base + per]).T
    v, i = C.distributed_topk(s, base, K, "model", mesh=mesh)
    out["distributed_topk"] = (v.numpy(), i.numpy())

    # the gradient all-reduce over ("pod", "data") = (2, 4)
    dp = make_mesh((2, 4), ("pod", "data"), "cpu")
    mine = {k: torch.from_numpy(g) + rank for k, g in grads.items()}
    const = {"w": torch.ones(16) * 3.0}
    roundtrip = lambda x: int8_decompress(int8_compress(x))  # noqa: E731
    tree = lambda t: {k: g.numpy() for k, g in t.items()}  # noqa: E731
    out["dp mean"] = tree(C.dp_allreduce_grads(mine, dp))
    out["dp const"] = C.dp_allreduce_grads(const, dp)["w"].numpy()
    out["dp const int8"] = C.dp_allreduce_grads(const, dp, compress=roundtrip)["w"].numpy()
    out["dp int8"] = tree(C.dp_allreduce_grads(mine, dp, compress=roundtrip))
    out["dp data only"] = tree(C.dp_allreduce_grads(mine, mesh))
    out["dp absent"] = tree(C.dp_allreduce_grads(mine, mesh, dp_axes=("pod",)))
    out["psum"] = {k: C.hierarchical_psum(g, "data", "pod", mesh=dp).numpy() for k, g in mine.items()}
    out["rank"], out["coord"] = rank, mesh.get_coordinate()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    q, c, planted, grads = _inputs()
    return run_ranks(_dist_body, 8, tmp_path_factory.mktemp("dist"), q, c, planted, grads)


def _repro_topk(kind, q, c, k=K):
    import jax.numpy as jnp

    from repro.core import DenseSpace as JDense
    from repro.core import exact_topk

    r = exact_topk(JDense(kind), jnp.asarray(q), jnp.asarray(c), k)
    return np.asarray(r.scores), np.asarray(r.indices)


def _assert_same_on_every_rank(ranks, name):
    first = ranks[0][name]
    for r in ranks[1:]:
        for a, b in zip(first, r[name]):
            assert np.array_equal(a, b), (name, r["rank"])


@pytest.mark.parametrize("case, kind, corpus", [
    ("ip", "ip", "c"), ("planted", "ip", "planted"), ("l2", "l2", "c"), ("streaming", "ip", "c"),
    ("over data", "ip", "c"), ("dtensor", "ip", "c")])
def test_sharded_exact_topk_matches_repro(ranks, case, kind, corpus):
    q, c, planted, _ = _inputs()
    want_s, want_i = _repro_topk(kind, q, planted if corpus == "planted" else c)
    _assert_same_on_every_rank(ranks, case)
    got_s, got_i = ranks[0][case]
    assert np.array_equal(got_i, want_i), case
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    if corpus == "planted":   # the margins are planted: the answer is the planted rows, in order
        assert np.all(np.diff(got_s, axis=1) < -0.4)


def test_distributed_topk_matches_repro(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed.collectives import distributed_topk
    from repro.distributed.mesh_utils import make_mesh

    q, c, _, _ = _inputs()
    mesh = make_mesh((1,), ("model",))
    fn = jax.shard_map(lambda s: distributed_topk(s, 0, K, "model"), mesh=mesh, in_specs=(P(None, "model"),),
                       out_specs=(P(), P()), check_vma=False)
    want_v, want_i = jax.jit(fn)(jnp.asarray(q) @ jnp.asarray(c).T)
    _assert_same_on_every_rank(ranks, "distributed_topk")
    got_v, got_i = ranks[0]["distributed_topk"]
    assert np.array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=1e-5)


def test_hierarchical_compressed_psum(ranks):
    """``test_hierarchical_compressed_psum``'s case (3.0 on every rank),
    then rank-dependent gradients against their mean."""
    _, _, _, grads = _inputs()
    for r in ranks:
        np.testing.assert_allclose(r["dp const"], 3.0, rtol=1e-6)
        np.testing.assert_allclose(r["dp const int8"], 3.0, rtol=2e-2)
        for k, g in grads.items():
            mean = g + np.float32(3.5)           # the ranks add 0..7
            np.testing.assert_allclose(r["dp mean"][k], mean, rtol=1e-6)
            np.testing.assert_allclose(r["dp int8"][k], mean, rtol=2e-2, atol=2e-2 * np.abs(mean).max())
            # ("data", "model") = (2, 4): the mean over data of ranks m and 4 + m
            np.testing.assert_allclose(r["dp data only"][k], g + np.float32(r["coord"][1] + 2), rtol=1e-6)
            np.testing.assert_array_equal(r["dp absent"][k], g + np.float32(r["rank"]))
            np.testing.assert_allclose(r["psum"][k], 8 * g + np.float32(28), rtol=1e-6)


# repro's reductions on 8 forced host devices, the device at row-major mesh
# position r holding grads + r (an array whose per-device buffers differ under
# a replicated sharding: dp_allreduce_grads' shard_map takes its input
# replicated, so this is how each device gets its own gradient); printed per
# position as JSON on the last line.
_REPRO_REDUCTIONS = """
import json
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.mesh_utils import make_mesh
from repro.distributed.collectives import dp_allreduce_grads, hierarchical_psum
from repro.optim.compression import int8_compress, int8_decompress

grads = {"w": np.arange(16, dtype=np.float32) * 0.5, "b": np.full((3, 5), 2.0, np.float32)}
roundtrip = lambda x: int8_decompress(int8_compress(x))

def per_rank(mesh, tree):
    devs = list(mesh.devices.flat)
    def leaf(g):
        bufs = [jax.device_put(g + np.float32(r), d) for r, d in enumerate(devs)]
        return jax.make_array_from_single_device_arrays(g.shape, NamedSharding(mesh, P()), bufs)
    return {k: leaf(v) for k, v in tree.items()}

def by_rank(mesh, tree):
    pos = {d.id: r for r, d in enumerate(mesh.devices.flat)}
    out = {}
    for k, a in tree.items():
        rows = [None] * len(pos)
        for s in a.addressable_shards:
            rows[pos[s.device.id]] = np.asarray(s.data).tolist()
        out[k] = rows
    return out

dp = make_mesh((2, 4), ("pod", "data"))
dm = make_mesh((2, 4), ("data", "model"))
psum = jax.shard_map(lambda g: {k: hierarchical_psum(v, "data", "pod") for k, v in g.items()}, mesh=dp,
                     in_specs=(P(),), out_specs=P(), check_vma=False)
print(json.dumps({
    "dp mean": by_rank(dp, dp_allreduce_grads(per_rank(dp, grads), dp)),
    "dp int8": by_rank(dp, dp_allreduce_grads(per_rank(dp, grads), dp, compress=roundtrip)),
    "dp data only": by_rank(dm, dp_allreduce_grads(per_rank(dm, grads), dm)),
    "dp absent": by_rank(dm, dp_allreduce_grads(per_rank(dm, grads), dm, dp_axes=("pod",))),
    "psum": by_rank(dp, psum(per_rank(dp, grads))),
}))
"""


@pytest.fixture(scope="module")
def repro_reductions():
    import json

    from conftest import run_subprocess_devices

    return json.loads(run_subprocess_devices(_REPRO_REDUCTIONS, 8, timeout=120).strip().splitlines()[-1])


@pytest.mark.parametrize("case, rtol", [("dp mean", 1e-6), ("dp int8", 2e-2), ("dp data only", 1e-6),
                                        ("dp absent", 1e-6), ("psum", 1e-6)])
def test_gradient_reductions_match_repro_rank_by_rank(ranks, repro_reductions, case, rtol):
    """Each rank's ``dp_allreduce_grads`` / ``hierarchical_psum`` against
    ``repro``'s on the device at the same mesh position, every device
    holding its own gradient (grads + rank)."""
    _, _, _, grads = _inputs()
    for r in ranks:
        for k, g in grads.items():
            want = np.asarray(repro_reductions[case][k][r["rank"]], np.float32).reshape(g.shape)
            np.testing.assert_allclose(r[case][k], want, rtol=rtol, err_msg=f"{case} {k} rank {r['rank']}")


# ---- ParallelCtx with a mesh: pure Python, against repro's on a stand-in mesh -----------------

SHAPES = {(2, 4): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def _meshes(shape):
    """(the port's ``DeviceMesh``, built without a process group as rank 0
    would hold it; ``repro``'s stand-in, whose ``spec``, ``axis_size`` and
    ``mesh_axes`` read only ``axis_names`` and ``devices.shape``)."""
    from types import SimpleNamespace

    from torch.distributed.device_mesh import DeviceMesh

    axes = SHAPES[shape]
    mesh = DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape), mesh_dim_names=axes,
                      _init_backend=False, _rank=0)
    return mesh, SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_parallel_ctx_with_a_mesh_matches_repro(shape):
    import repro.configs as jc
    from repro.distributed.sharding import ParallelCtx as JCtx
    import repro_torch.configs as tc
    import repro_torch.configs.base  # noqa: F401
    from repro_torch.distributed.sharding import ParallelCtx

    mesh, stand_in = _meshes(shape)
    for arch in jc.all_archs():
        rules = tc.get_config(arch).rules
        assert rules == jc.get_config(arch).rules
        ctx, jctx = ParallelCtx(mesh, rules), JCtx(stand_in, rules)
        for logical in list(rules) + ["absent", None]:
            assert ctx.spec(logical, None, logical) == tuple(jctx.spec(logical, None, logical)), (arch, logical)
            assert ctx.mesh_axes(logical) == jctx.mesh_axes(logical), (arch, logical)
            if logical is not None:
                assert ctx.axis_size(logical) == jctx.axis_size(logical), (arch, logical)
    ctx = ParallelCtx(mesh, tc.base.DEFAULT_LM_RULES)
    if shape == (2, 16, 16):
        assert ctx.spec("batch", "seq_act", None) == (("pod", "data"), "model", None)
        assert ctx.axis_size("batch") == 32


@pytest.mark.parametrize("family", ["lm", "recsys", "gnn"])
def test_params_sharding_matches_repro_spec_leaf_by_leaf(family):
    """The port's ``params_sharding`` of each model's axes tree against
    ``repro``'s ``ctx.spec(*axes)`` for the same leaf (``repro``'s own
    ``params_sharding`` builds a ``NamedSharding`` and needs a real mesh)."""
    import jax

    import repro.configs as jc
    from repro.distributed.sharding import ParallelCtx as JCtx
    from repro.models import recsys as JR
    from repro.models import schnet as JS
    from repro.models import transformer as JT
    from repro_torch.distributed.sharding import ParallelCtx, params_sharding

    arch = {"lm": "phi3.5-moe-42b-a6.6b", "recsys": "din", "gnn": "schnet"}[family]
    cfg = jc.get_smoke_config(arch)
    init = {"lm": JT.init_transformer, "recsys": JR.init_recsys, "gnn": JS.init_schnet}[family]
    box = {}

    def params_only(key):            # the axes tree is Python data, kept aside while tracing
        p, box["axes"] = init(key, cfg)
        return p

    jax.eval_shape(params_only, jax.random.PRNGKey(0))
    axes = box["axes"]
    for shape in SHAPES:
        mesh, stand_in = _meshes(shape)
        got = params_sharding(_plain(axes), ParallelCtx(mesh, cfg.rules))
        jctx = JCtx(stand_in, cfg.rules)
        checked = 0
        for path, leaf in jax.tree_util.tree_flatten_with_path(axes, is_leaf=lambda x: isinstance(x, tuple))[0]:
            node = got
            for p in path:
                node = node[getattr(p, "key", getattr(p, "idx", None))]
            assert node.spec == tuple(jctx.spec(*leaf)), (path, shape)
            assert node.mesh is mesh
            checked += 1
        assert checked > 3


def _plain(tree):
    """repro's axes tree (dicts, lists and NamedTuples) as nested dicts."""
    if isinstance(tree, tuple) and all(a is None or isinstance(a, str) for a in tree):
        return tree
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    return {i: _plain(v) for i, v in enumerate(tree)}


def test_parallel_ctx_refuses_a_mesh_that_is_not_a_device_mesh():
    from repro_torch.distributed.sharding import ParallelCtx

    with pytest.raises(TypeError, match="DeviceMesh"):
        ParallelCtx(object(), {})


def test_placements_and_blocks():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import NamedSharding, block_slices

    mesh, _ = _meshes((2, 16, 16))
    sh = NamedSharding(mesh, (("pod", "data"), "model", None))
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert sh.replicated_axes() == ()
    assert NamedSharding(mesh, (None, "data")).placements == (Replicate(), Shard(1), Replicate())
    assert block_slices((100, 40, 3), sh) == [(0, 4), (0, 3), (0, 3)]   # rank 0: ceil(ceil(100/2)/16), ceil(40/16)
    with pytest.raises(ValueError, match="mesh's axis order"):
        NamedSharding(mesh, (("data", "pod"),)).placements
