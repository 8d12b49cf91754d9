"""repro_torch.models.schnet held against repro.models.schnet on the CPU:
the activation and the radial basis, one interaction, the whole network
and its loss in both forms (atomic numbers with a per-molecule energy
readout, node features with a per-node head) with an edge mask and ids out
of range, ``radius_graph`` on one molecule and batched (against
``jax.vmap``), the embedding of ``examples/molecule_retrieval.py``, the
init's shapes, axes and scales, and ``interop.schnet_params``' refusals.

Inputs are made once with numpy from a seed; the weights are ``repro``'s,
carried by ``interop.schnet_params``.  Ids must be equal; f32 values agree
within ``F32_RTOL`` (2e-6) of the row's largest |value| (the last axis).
Elementwise, the radial basis's centres and gamma equal the reference's
bit for bit, its exponent's argument too; its values and ``ssp``'s differ
only by the last bits of ``exp`` and ``log1p``, which XLA's CPU code and
PyTorch's compute differently (``exp`` differs by one ULP in about 9% of
f32 inputs, and XLA flushes results below f32's smallest normal to zero):
the basis within one ULP of its value (or both below the smallest normal),
``ssp`` within 2^-21 of max(|x|, 1) (two roundings in ``logaddexp`` and
one in the shift by log 2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core import DenseSpace as JDense, exact_topk as jexact
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.models import schnet as JS
import repro_torch.configs as tc
from repro_torch import interop
from repro_torch.core.brute_force import exact_topk
from repro_torch.core.spaces import DenseSpace
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.models import schnet as TS

from _torch_parity import F32_RTOL, np_of

pytestmark = pytest.mark.torch

JCTX, TCTX = JCtx(None, {}), ParallelCtx(None, {})
TINY = np.finfo(np.float32).tiny


def assert_close(want, got, rtol=F32_RTOL, ctx=""):
    w = np.asarray(want, np.float64)
    g = (got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)).astype(np.float64)
    assert w.shape == g.shape, (w.shape, g.shape, ctx)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(g)), ctx
    w2, g2 = w.reshape(-1, w.shape[-1] if w.ndim else 1), g.reshape(-1, g.shape[-1] if g.ndim else 1)
    scale = np.maximum(np.abs(w2).max(axis=-1, keepdims=True), 1e-30)
    err = np.abs(g2 - w2)
    assert np.all(err <= rtol * scale), f"error {np.max(err / scale):.3g} of row scale > {rtol} {ctx}"


def configs(node_features=False, **kw):
    jcfg, tcfg = jc.get_smoke_config("schnet"), tc.get_smoke_config("schnet")
    if node_features:
        kw["d_feat_in"] = 12
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def model_pair(node_features=False, seed=0, **kw):
    jcfg, tcfg = configs(node_features, **kw)
    p, _ = JS.init_schnet(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, p, interop.schnet_params(jax.tree.map(np_of, p), tcfg, "cpu")


def graph_np(n=24, e=80, graphs=3, seed=0, bad_ids=True):
    """A padded graph: atomic numbers and 12 node features, random edges
    with a mask, sorted molecule ids, and (``bad_ids``) a sender past the
    nodes, a negative one, and receivers past the nodes and negative."""
    rng = np.random.default_rng(seed)
    g = dict(node_z=rng.integers(1, 100, n).astype(np.int32),
             node_feat=rng.normal(size=(n, 12)).astype(np.float32),
             senders=rng.integers(0, n, e).astype(np.int32),
             receivers=rng.integers(0, n, e).astype(np.int32),
             distances=rng.uniform(0.5, 9.5, e).astype(np.float32),
             edge_mask=rng.uniform(size=e) > 0.15,
             graph_ids=np.sort(rng.integers(0, graphs, n)).astype(np.int32))
    if bad_ids:
        g["senders"][:2] = [n + 3, -2]
        g["receivers"][2:4] = [n, -1]
    return g


def graph_batches(g, node_features, targets):
    keys = ["senders", "receivers", "distances", "edge_mask"]
    keys += ["node_feat"] if node_features else ["node_z", "graph_ids"]
    jb = JS.GraphBatch(**{k: jnp.asarray(g[k]) for k in keys}, targets=jnp.asarray(targets))
    tb = TS.GraphBatch(**{k: torch.from_numpy(g[k]) for k in keys}, targets=torch.from_numpy(targets))
    return jb, tb


# ---------------------------------------------------------------------------
# Elementwise pieces.
# ---------------------------------------------------------------------------

def test_ssp_matches_repro():
    x = (np.random.default_rng(0).normal(size=50_000) * 10).astype(np.float32)
    x[:6] = [0.0, -0.0, 20.0, -20.0, 88.0, -100.0]
    want = np.asarray(JS.ssp(jnp.asarray(x)), np.float64)
    got = TS.ssp(torch.from_numpy(x)).numpy().astype(np.float64)
    assert got[0] == want[0] == 0.0
    assert np.all(np.abs(got - want) <= 2.0 ** -21 * np.maximum(np.abs(x), 1.0))


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (8, 10.0), (8, 8.0)])
def test_rbf_centres_bit_for_bit(n_rbf, cutoff):
    """The centres and gamma equal repro's f32 ``linspace`` and
    ``1 / (c1 - c0)^2`` bit for bit: eager, under ``jit`` and inside a
    ``lax.scan`` body, as ``schnet_apply`` calls ``rbf_expand``."""
    centers, gamma = TS.rbf_centers(n_rbf, cutoff)
    eager = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    jitted = np.asarray(jax.jit(lambda: jnp.linspace(0.0, cutoff, n_rbf))())
    scanned = np.asarray(jax.lax.scan(lambda c, _: (c, jnp.linspace(0.0, cutoff, n_rbf)),
                                      0.0, None, length=2)[1][1])
    for want in (eager, jitted, scanned):
        np.testing.assert_array_equal(centers.numpy().view(np.int32), want.view(np.int32))
    jgamma = np.asarray(1.0 / (jnp.asarray(eager)[1] - jnp.asarray(eager)[0]) ** 2)
    assert gamma.dtype == torch.float32 and gamma.numpy().view(np.int32) == jgamma.view(np.int32)
    if n_rbf == 300:
        assert not np.array_equal(torch.linspace(0.0, cutoff, n_rbf).numpy(), eager)


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (8, 10.0)])
def test_rbf_expand_matches_repro(n_rbf, cutoff):
    d = np.random.default_rng(1).uniform(0, 12, 4000).astype(np.float32)
    d[:3] = [0.0, cutoff, cutoff / (n_rbf - 1)]
    want = np.asarray(JS.rbf_expand(jnp.asarray(d), n_rbf, cutoff))
    got = TS.rbf_expand(torch.from_numpy(d), n_rbf, cutoff).numpy()
    assert got.shape == want.shape == (4000, n_rbf)
    both_tiny = (want < TINY) & (got < TINY)
    ok = both_tiny | (np.abs(got.astype(np.float64) - want) <= 2.0 ** -23 * want)
    assert ok.all(), f"{int((~ok).sum())} values beyond one ULP"
    assert got[0, 0] == got[1, -1] == got[2, 1] == 1.0


# ---------------------------------------------------------------------------
# Interactions, the network, the loss.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("node_features", [False, True], ids=["atoms", "node_feat"])
def test_cfconv_matches_repro(node_features):
    jcfg, tcfg, p, model = model_pair(node_features)
    g = graph_np()
    jb, tb = graph_batches(g, node_features, np.zeros(3, np.float32))
    x = np.random.default_rng(2).normal(size=(len(g["node_z"]), jcfg.d_hidden)).astype(np.float32)
    blk = jax.tree.map(lambda a: a[1], p["blocks"])
    want = JS.cfconv(blk, jnp.asarray(x), jb, jcfg, JCTX)
    with torch.no_grad():
        got = TS.cfconv(model.blocks[1], torch.from_numpy(x), tb, tcfg, TCTX)
    assert_close(want, got)


@pytest.mark.parametrize("node_features", [False, True], ids=["atoms", "node_feat"])
@pytest.mark.parametrize("cutoff,n_rbf", [(10.0, 8), (10.0, 300)])
def test_schnet_apply_matches_repro(node_features, cutoff, n_rbf):
    jcfg, tcfg, p, model = model_pair(node_features, cutoff=cutoff, n_rbf=n_rbf)
    jb, tb = graph_batches(graph_np(seed=3), node_features, np.zeros(3, np.float32))
    want = JS.schnet_apply(p, jb, jcfg, JCTX)
    with torch.no_grad():
        got = model(tb)
    assert_close(want, got)


@pytest.mark.parametrize("node_features", [False, True], ids=["energy", "node"])
def test_schnet_loss_matches_repro(node_features):
    jcfg, tcfg, p, model = model_pair(node_features, seed=1)
    g = graph_np(seed=4)
    targets = np.random.default_rng(5).normal(size=len(g["node_z"]) if node_features else 3)
    jb, tb = graph_batches(g, node_features, targets.astype(np.float32))
    want, jm = JS.schnet_loss(p, jb, jcfg, JCTX, n_graphs=3)
    with torch.no_grad():
        got, m = TS.schnet_loss(model, tb, tcfg, TCTX, n_graphs=3)
    assert_close(np.float32(want), got.reshape(()))
    assert set(m) == set(jm) == {"mse"}


def test_energy_readout_drops_out_of_range_graph_ids():
    jcfg, tcfg, p, model = model_pair()
    x = np.random.default_rng(6).normal(size=(10, jcfg.d_hidden)).astype(np.float32)
    gid = np.array([0, 0, 1, 1, 1, 3, -1, 2, 2, 7], np.int32)
    want = JS.energy_readout(p, jnp.asarray(x), jnp.asarray(gid), 4)
    with torch.no_grad():
        got = TS.energy_readout(model, torch.from_numpy(x), torch.from_numpy(gid), 4)
    assert_close(want, got)


# ---------------------------------------------------------------------------
# radius_graph and the example's embedding.
# ---------------------------------------------------------------------------

def _molecules(m=5, n=12, families=3, seed=0):
    """``examples/molecule_retrieval.py``'s molecules: perturbed copies of
    template conformations, with the family's atom types."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(families, n, 3)) * 3.0
    types = rng.integers(1, 10, size=(families, n))
    fam = rng.integers(0, families, m)
    pos = (templates[fam] + rng.normal(size=(m, n, 3)) * 0.05).astype(np.float32)
    return pos, types[fam].astype(np.int32), fam


def test_radius_graph_one_molecule_matches_repro():
    pos, _, _ = _molecules(m=1)
    ws, wr, wd = JS.radius_graph(jnp.asarray(pos[0]), 6)
    ts, tr, td = TS.radius_graph(torch.from_numpy(pos[0]), 6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(wr))
    assert ts.dtype == tr.dtype == torch.int32
    assert_close(np.asarray(wd)[None], td[None])


def test_radius_graph_batched_matches_vmap():
    """A leading molecule axis, as ``jax.vmap`` gives it.  Molecule 2's
    atom 5 copies atom 4: for atom 5, atom 4 ties it at distance 0 and
    ranks first (the lower id), so the dropped rank-0 slot is atom 4 and
    atom 5's first neighbour is itself, at distance 0, in both packages."""
    pos, _, _ = _molecules(m=6)
    pos[2, 5] = pos[2, 4]
    ws, wr, wd = jax.vmap(lambda x: JS.radius_graph(x, 6))(jnp.asarray(pos))
    ts, tr, td = TS.radius_graph(torch.from_numpy(pos), 6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(wr))
    assert_close(wd, td)
    assert int(ts[2, 5 * 6]) == 5 and float(td[2, 5 * 6]) == 0.0


def _jax_embed(p, cfg, pos, z):
    """``examples/molecule_retrieval.py``'s ``embed_all``."""
    def one(x, zz):
        send, recv, dist = JS.radius_graph(x, k=6)
        batch = JS.GraphBatch(node_z=zz, senders=send, receivers=recv, distances=dist)
        h = JS.schnet_apply(p, batch, cfg, JCTX)
        v = jnp.concatenate([jnp.mean(h, axis=0), jnp.std(h, axis=0)])
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-9)
    return jax.jit(jax.vmap(one))(jnp.asarray(pos), jnp.asarray(z))


def assert_ids_up_to_near_ties(want_ids, got_ids, scores, ctx=""):
    """Ids equal, or different only between neighbours whose scores lie
    within ``F32_RTOL`` of the row's largest |score| (``chip_smoke.py``'s
    ``Checker`` rule for data without planted margins)."""
    want_ids, got_ids, s = (np.asarray(x) for x in (want_ids, got_ids, scores))
    bad = want_ids != got_ids
    scale = np.abs(s).max(axis=1, keepdims=True)
    gap = np.abs(s[:, :-1] - s[:, 1:]) <= F32_RTOL * scale
    near = np.zeros_like(bad)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert not (bad & ~near).any(), f"ids differ beyond near-ties {ctx}"


def test_molecule_embeddings_match_the_example():
    """The batched embedding equals the example's per-molecule ``vmap``.
    Exact top-6 in ip space over the unit vectors ranks as cosine space, in
    the port and in repro, up to near-ties: cosine divides each unit vector
    by its norm again, which moves a score by an ULP or two, and members of
    a family score within a few ULPs of each other."""
    jcfg, tcfg, p, model = model_pair(cutoff=8.0)
    pos, z, fam = _molecules(m=96, families=8, seed=1)
    want = _jax_embed(p, jcfg, pos, z)
    with torch.no_grad():
        got = TS.molecule_embeddings(model, torch.from_numpy(pos), torch.from_numpy(z), tcfg, TCTX, k=6)
    assert got.shape == (96, 2 * tcfg.d_hidden)
    assert_close(want, got)
    assert torch.allclose(got.norm(dim=1), torch.ones(96), atol=1e-6)
    ip = exact_topk(DenseSpace("ip"), got, got, 6)
    cos = exact_topk(DenseSpace("cosine"), got, got, 6)
    jcos = jexact(JDense("cosine"), want, want, 6)
    assert_ids_up_to_near_ties(cos.indices, ip.indices, ip.scores, "ip vs cosine")
    assert_ids_up_to_near_ties(jcos.indices, ip.indices, ip.scores, "ip vs repro's cosine")
    assert (ip.indices[:, 0] == torch.arange(96)).all()
    assert np.mean(fam[ip.indices[:, 1:].numpy()] == fam[:, None]) > 0.6


def test_full_rescore_reranks_by_the_full_vector():
    """The molecule funnel's rerank stage against a direct computation."""
    from repro_torch.core.brute_force import TopK

    emb = torch.nn.functional.normalize(torch.randn(40, 8, generator=torch.Generator().manual_seed(0)), dim=1)
    cands = TopK(torch.tensor([[3.0, 2.0, 1.0, -torch.inf]]), torch.tensor([[5, 9, 1, 2]], dtype=torch.int32))
    out = TS.FullRescore(emb).rerank(emb[:1], cands, 3)
    direct = emb[[5, 9, 1]] @ emb[0]
    order = torch.argsort(direct, descending=True)
    assert out.indices[0].tolist() == [[5, 9, 1][i] for i in order.tolist()]
    assert torch.allclose(out.scores[0], direct[order], rtol=F32_RTOL, atol=0.0)


# ---------------------------------------------------------------------------
# Init and interop.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("node_features", [False, True], ids=["embed", "in_proj"])
def test_init_shapes_and_axes_match_repro(node_features):
    jcfg, tcfg = configs(node_features)
    shapes = jax.eval_shape(lambda k: JS.init_schnet(k, jcfg)[0], jax.random.PRNGKey(0))
    _, jaxes = JS.init_schnet(jax.random.PRNGKey(0), jcfg)
    model, axes = TS.init_schnet(tcfg, device="meta")
    assert axes == jaxes
    like = interop._like(model)
    assert set(like) == set(shapes)
    for name in set(shapes) - {"blocks"}:
        got = like[name]
        if isinstance(got, torch.Tensor):
            assert tuple(got.shape) == shapes[name].shape
        else:
            assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in shapes[name].items()}
    assert len(like["blocks"]) == tcfg.n_interactions
    for k, sub in shapes["blocks"].items():
        for leaf in ("w", "b"):
            assert (tcfg.n_interactions, *like["blocks"][0][k][leaf].shape) == sub[leaf].shape


def test_full_config_shapes_on_meta():
    model, _ = TS.init_schnet(tc.get_config("schnet"), device="meta")
    assert tuple(model.blocks[0]["filter1"]["w"].shape) == (300, 64)
    assert len(model.blocks) == 3 and tuple(model.embed.shape) == (100, 64)


def test_init_draws_at_reference_scales():
    cfg = dataclasses.replace(tc.get_config("schnet"), max_z=400)
    model, _ = TS.init_schnet(cfg, seed=2, device="cpu")
    model.requires_grad_(False)
    assert abs(float(model.embed.std()) - 0.1) < 5e-3
    w = model.blocks[2]["filter1"]["w"]
    assert abs(float(w.std()) * 300 ** 0.5 - 1.0) < 0.05 and not model.blocks[2]["filter1"]["b"].any()


def _np_params(node_features=False):
    jcfg, tcfg = configs(node_features)
    p, _ = JS.init_schnet(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(np_of, p), tcfg


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype", "stack", "form"])
def test_schnet_params_refuses(fault):
    p, cfg = _np_params()
    if fault == "missing":
        del p["head2"]
    elif fault == "extra":
        p["blocks"]["gate"] = p["blocks"]["atom_in"]
    elif fault == "shape":
        p["blocks"]["filter1"]["w"] = p["blocks"]["filter1"]["w"][:, :-1]
    elif fault == "dtype":
        p["embed"] = p["embed"].astype(np.float16)
    elif fault == "stack":
        p["blocks"]["atom_out"]["b"] = p["blocks"]["atom_out"]["b"][:1]
    else:
        p["in_proj"] = p.pop("embed")
    with pytest.raises(ValueError):
        interop.schnet_params(p, cfg, "cpu")


def test_schnet_params_splits_the_interaction_axis():
    p, cfg = _np_params(node_features=True)
    model = interop.schnet_params(p, cfg, "cpu")
    for i in range(cfg.n_interactions):
        np.testing.assert_array_equal(model.blocks[i]["filter2"]["w"].detach().numpy(),
                                      p["blocks"]["filter2"]["w"][i])
    np.testing.assert_array_equal(model.in_proj["w"].detach().numpy(), p["in_proj"]["w"])
