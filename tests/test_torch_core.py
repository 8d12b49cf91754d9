"""repro_torch core (sparse, spaces, brute_force, device rule, package
boundary) held against repro on the same numpy inputs.

Tolerances: f32 scores within ``F32_RTOL`` (2e-6) of each row's largest
|score| (see ``_torch_parity``); exact quantities (ids, COO layout,
densified tables of f32 inputs) must be equal.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brute_force as jbf
from repro.core import sparse as jsp
from repro.core import spaces as jspaces
from repro_torch import interop
from repro_torch.core import brute_force as tbf
from repro_torch.core import sparse as tsp
from repro_torch.core import spaces as tspaces
from repro_torch.device import resolve_device

from _torch_parity import (assert_scores_close, assert_topk_match, np_of,
                           sparse_to_torch, to_torch)

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parent.parent


def _sparse_rows(rng, rows, v, density):
    x = rng.uniform(size=(rows, v)) * (rng.uniform(size=(rows, v)) < density)
    return x.astype(np.float32)


@pytest.mark.parametrize("seed,rows,v,nnz", [(0, 6, 40, 8), (1, 3, 17, 17)])
def test_from_dense_and_densify(seed, rows, v, nnz):
    rng = np.random.default_rng(seed)
    x = _sparse_rows(rng, rows, v, 0.4)
    x[0, :4] = 0.5                       # equal magnitudes: lower id first
    want = jsp.from_dense(jnp.asarray(x), nnz)
    got = tsp.from_dense(interop.tensor(x, "cpu"), nnz)
    np.testing.assert_array_equal(np.asarray(want.indices), got.indices.numpy())
    np.testing.assert_array_equal(np.asarray(want.values), got.values.numpy())
    assert got.indices.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jsp.densify(want, v)),
                                  tsp.densify(got, v).numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_sparse_inner_products(dtype):
    rng = np.random.default_rng(2)
    v = 30
    q = jsp.from_dense(jnp.asarray(_sparse_rows(rng, 4, v, 0.5), dtype), 12)
    d = jsp.from_dense(jnp.asarray(_sparse_rows(rng, 9, v, 0.3), dtype), 10)
    tq, td = sparse_to_torch(q), sparse_to_torch(d)
    want = jsp.sparse_inner_qbatch_docs(q, d, v)
    assert_scores_close(want, tsp.sparse_inner_qbatch_docs(tq, td, v))
    assert_scores_close(want, tsp.sparse_inner_tiled(tq, td, v, tile_n=4))
    q4 = jsp.SparseVectors(q.indices, q.values)
    d4 = jsp.SparseVectors(d.indices[:4], d.values[:4])
    assert_scores_close(jsp.sparse_inner_one_to_one(q4, d4, v)[None],
                        tsp.sparse_inner_one_to_one(
                            tq, tsp.SparseVectors(td.indices[:4], td.values[:4]), v)[None])
    if dtype == jnp.float32:
        assert_scores_close(jsp.l2_normalize_sparse(q).values,
                            tsp.l2_normalize_sparse(tq).values)


@pytest.mark.parametrize("kind", ["ip", "l2", "cosine", "lp"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dense_scores(kind, dtype):
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.standard_normal((5, 24)), dtype)
    c = jnp.asarray(rng.standard_normal((40, 24)), dtype)
    want = jspaces.dense_scores(kind, q, c)
    got = tspaces.dense_scores(kind, to_torch(q), to_torch(c))
    assert got.dtype == torch.float32
    assert_scores_close(want, got)


def test_dense_scores_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    tspaces.dense_scores("ip", torch.ones(1, 2), torch.ones(3, 2))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("weights", [(0.6, 0.4), (1.0, 1.0), (-0.5, 1.5), (0.3,)])
def test_weighted_mix(weights):
    rng = np.random.default_rng(4)
    parts = [rng.standard_normal((3, 7)).astype(np.float32) for _ in weights]
    want = jspaces.weighted_mix([jnp.asarray(p) for p in parts], list(weights))
    got = tspaces.weighted_mix([torch.from_numpy(p) for p in parts], list(weights))
    assert_scores_close(want, got)


def _fused_pair(seed, n=50, v=25, nnz=6, dd=8, b=3):
    rng = np.random.default_rng(seed)
    c = jspaces.FusedVectors(jnp.asarray(rng.standard_normal((n, dd)), jnp.float32),
                             jsp.from_dense(jnp.asarray(_sparse_rows(rng, n, v, 0.3)), nnz))
    q = jspaces.FusedVectors(jnp.asarray(rng.standard_normal((b, dd)), jnp.float32),
                             jsp.from_dense(jnp.asarray(_sparse_rows(rng, b, v, 0.5)), nnz))
    return c, q, v


@pytest.mark.parametrize("parts", ["both", "dense", "sparse"])
def test_fused_space_score_batch(parts):
    c, q, v = _fused_pair(5)
    keep = lambda fv: jspaces.FusedVectors(fv.dense if parts != "sparse" else None,
                                           fv.sparse if parts != "dense" else None)
    c, q = keep(c), keep(q)
    tc = tspaces.FusedVectors(to_torch(c.dense), sparse_to_torch(c.sparse))
    tq = tspaces.FusedVectors(to_torch(q.dense), sparse_to_torch(q.sparse))
    want = jspaces.FusedSpace(v, 0.7, 0.3).score_batch(q, c)
    assert_scores_close(want, tspaces.FusedSpace(v, 0.7, 0.3).score_batch(tq, tc))
    with pytest.raises(ValueError):
        tspaces.FusedSpace(v).score_batch(tspaces.FusedVectors(None, None), tc)


def test_cast_corpus_and_refusals():
    c, _, _ = _fused_pair(6)
    tc = tspaces.FusedVectors(to_torch(c.dense), sparse_to_torch(c.sparse))
    want = jspaces.cast_corpus(c, "bf16")
    got = tspaces.cast_corpus(tc, "bf16")
    np.testing.assert_array_equal(np_of(want.dense), np_of(got.dense))
    np.testing.assert_array_equal(np_of(want.sparse.values), np_of(got.sparse.values))
    assert got.sparse.indices.dtype == torch.int32
    assert tspaces.corpus_dtype(got) == jspaces.corpus_dtype(want) == "bfloat16"
    assert tspaces.corpus_dtype(tc) == "float32"
    for spec in ("f32", "fp32", "float32", torch.float32, np.float32, "bf16",
                 torch.bfloat16):
        assert tspaces.canonical_dtype(spec) in tspaces.CORPUS_DTYPES
    for bad in ("float16", torch.float64, "int8"):
        with pytest.raises(ValueError):
            tspaces.canonical_dtype(bad)
    with pytest.raises(ValueError, match="widening"):          # bf16 -> f32
        tspaces.cast_corpus(got, "float32")
    with pytest.raises(ValueError, match="outside"):           # f16 source
        tspaces.cast_corpus(torch.zeros(3, 2, dtype=torch.float16), "bf16")
    with pytest.raises(ValueError):
        jspaces.cast_corpus(want, "float32")                   # same refusal


def test_exact_topk_ties_and_n_valid():
    rng = np.random.default_rng(7)
    c = rng.standard_normal((60, 6)).astype(np.float32)
    c[[11, 12, 40]] = c[9]                 # exact ties: lower ids first
    q = rng.standard_normal((3, 6)).astype(np.float32)
    q[0] = c[9] * 5
    space_j, space_t = jspaces.DenseSpace("ip"), tspaces.DenseSpace("ip")
    for k, n_valid in [(5, None), (10, 41), (60, 55)]:    # 60 > n_valid: -inf tail
        want = jbf.exact_topk(space_j, jnp.asarray(q), jnp.asarray(c), k, n_valid)
        got = tbf.exact_topk(space_t, torch.from_numpy(q), torch.from_numpy(c), k, n_valid)
        assert got.indices.dtype == torch.int32
        assert_topk_match(want, got, ctx=(k, n_valid))


def test_concat_merge_and_pad():
    rng = np.random.default_rng(8)
    parts = [(rng.standard_normal((2, 4)).astype(np.float32),
              rng.integers(0, 99, (2, 4)).astype(np.int32)) for _ in range(3)]
    parts[1][0][0, 0] = parts[0][0][0, 0]          # a tie across parts
    jt = jbf.merge_topk(jbf.concat_topk([jbf.TopK(jnp.asarray(s), jnp.asarray(i))
                                         for s, i in parts]), 5)
    tt = tbf.merge_topk(tbf.concat_topk([tbf.TopK(torch.from_numpy(s), torch.from_numpy(i))
                                         for s, i in parts]), 5)
    assert_topk_match(jt, tt)
    c, _, _ = _fused_pair(9, n=13)
    tc = tspaces.FusedVectors(to_torch(c.dense), sparse_to_torch(c.sparse))
    jp, jn = jbf.pad_corpus(c, 8)
    tp, tn = tbf.pad_corpus(tc, 8)
    assert jn == tn == 13
    np.testing.assert_array_equal(np.asarray(jp.sparse.indices), tp.sparse.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jp.dense), tp.dense.numpy())


def test_device_rule(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        interop.tensor(np.zeros(3, np.float32))       # device=None means cuda


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_package_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core.pipeline, repro_torch.interop, "
            "repro_torch.kernels.ops, repro_torch.core.fusion, repro_torch.core.graph_ann, "
            "repro_torch.kernels.beam_topk, repro_torch.serving, repro_torch.serving.stats, "
            "repro_torch.serving.batcher, repro_torch.serving.router, repro_torch.serving.funnel, "
            "repro_torch.serving.autotune, repro_torch.serving.spec, repro_torch.serving.service, "
            "repro_torch.serving.sharded, repro_torch.launch.serve, repro_torch.launch.roofline; "
            "from repro_torch.serving import (RetrievalService, ContinuousBatcher, Router, "
            "EndpointSpec, FunnelPipeline, StageBudget, ShardedPipeline, shard_corpus, "
            "ServingStats, ServiceSnapshot, EndpointSnapshot, LatencySummary, ServingConfig, "
            "TunedProfile, check_config); "
            "from repro_torch.launch.serve import BatchingServer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
