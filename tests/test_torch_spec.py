"""repro_torch.serving.{autotune (the genome half), spec}: legality of
``ServingConfig`` genomes and ``EndpointSpec`` values held against
``repro``'s, reason string for reason string, and tuned profiles that
keep ``repro``'s tags and JSON.

The intended differences are asserted on their own:

- a ``tile_n`` gene on ``"pallas"`` is refused: the CUDA kernels choose
  their own launch shape;
- ``EndpointSpec(jit=True)`` is refused: ``repro`` wraps the runner in
  ``jax.jit``, which has no counterpart;
- ``"cuda"`` is a registered backend name in the port only.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.serving import spec as jspec
from repro.serving.funnel import StageBudget as JStageBudget
from repro_torch.core.backends import CudaBackend, StreamingBackend
from repro_torch.core.spaces import DenseSpace, FusedSpace
from repro_torch.serving import autotune as ta
from repro_torch.serving import (EndpointSpec, MeasuredPoint, RetrievalService, ServingConfig,
                                 StageBudget, TunedProfile, check_config)

pytestmark = pytest.mark.torch

ja = importlib.import_module("repro.serving.autotune")   # repro.serving.autotune is also a function

# every gene's menu, with values outside it that a legality rule refuses
DOMAINS = {
    "backend": ta.GENOME_BACKENDS + ("nope",),
    "tile_n": (None, 0, -4, 512, 8192),
    "corpus_dtype": ("float32", "bfloat16", "float16"),
    "n_shards": (0, 1, 2, 4),
    "batch_size": (0, 1, 16, 128),
    "max_wait_s": (0.0, -1.0, 0.0005, 0.01),
    "cache_size": (-1, 0, 4096),
    "max_queue": (None, 0, 8, 32, 128),
    "overload": ("block", "reject", "shed_oldest", "drop"),
    "ef": (None, 0, 8, 16, 128),
    "hops": (None, 0, 2, 8),
    "kernel": (False, True),
    "num_search": (None, 0, 4, 16),
    "rerank_qty": (None, 5, 64, 256),
    "rerank_keep": (None, 5, 10, 50),
    "rerank_budget_ms": (None, 0.0, -2.0, 2.0, 20.0),
}
BASES = {
    "reference": {},
    "streaming": {"backend": "streaming"},
    "pallas": {"backend": "pallas"},
    "graph_ann": {"backend": "graph_ann", "ef": 64},
    "graph_ann_kernel": {"backend": "graph_ann", "ef": 64, "kernel": True},
    "napp": {"backend": "napp", "num_search": 8, "rerank_qty": 128},
}


def _pair(fields):
    return ja.ServingConfig(**fields), ta.ServingConfig(**fields)


def _intended(fields, k):
    """The port's reason where it differs from repro's on purpose, else None."""
    if fields.get("backend") == "nope":   # the port's registry also names "cuda"
        return ("unknown backend 'nope'; registered: "
                "('cuda', 'graph_ann', 'napp', 'pallas', 'reference', 'streaming')")
    if fields.get("tile_n") is not None and fields.get("backend") == "pallas":
        return "tile_n does not apply to pallas: the CUDA kernels choose their own launch shape"
    return None


def _assert_same_legality(fields, k):
    jcfg, tcfg = _pair(fields)
    want = ja.check_config(jcfg, k)
    got = check_config(tcfg, k)
    intended = _intended(fields, k)
    if intended is not None and got == intended:
        return "intended"
    assert got == want, (fields, k)
    return want


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("gene", sorted(DOMAINS))
def test_one_gene_at_a_time_as_repro(base, gene):
    seen = set()
    for value in DOMAINS[gene]:
        for k in (1, 10, 100):
            fields = dict(BASES[base], **{gene: value})
            seen.add(_assert_same_legality(fields, k))
    assert seen   # every value was compared


def test_random_genomes_as_repro():
    rng = np.random.default_rng(0)
    reasons = {}
    for _ in range(3000):
        fields = {g: vals[int(rng.integers(len(vals)))] for g, vals in DOMAINS.items()
                  if rng.random() < 0.5}
        k = int(rng.choice([1, 10, 64, 300]))
        why = _assert_same_legality(fields, k)
        reasons[why] = reasons.get(why, 0) + 1
    assert None in reasons and len(reasons) > 20   # legal and many illegal kinds were reached


def test_tile_n_on_pallas_is_refused_where_repro_accepts():
    jcfg, tcfg = _pair({"backend": "pallas", "tile_n": 1024})
    assert ja.check_config(jcfg, 10) is None
    why = check_config(tcfg, 10)
    assert "CUDA kernels choose their own launch shape" in why
    with pytest.raises(ValueError, match="own launch shape"):
        tcfg.make_backend()
    # without the gene, "pallas" names the cuda backend
    assert isinstance(ta.ServingConfig(backend="pallas").make_backend(), CudaBackend)
    assert ta.ServingConfig(backend="streaming", tile_n=512).make_backend() == StreamingBackend(512)
    assert check_config(ta.ServingConfig(backend="cuda"), 10) is None


def test_capability_check_against_a_corpus():
    corpus = torch.zeros(32, 4)
    cfg = ta.ServingConfig(backend="pallas")
    assert check_config(cfg, 5, DenseSpace("ip"), corpus) is None
    assert "ip/l2" in check_config(cfg, 5, DenseSpace("cosine"), corpus)
    assert "FusedVectors" in check_config(cfg, 5, FusedSpace(8), corpus)


def test_beam_budget_comes_from_the_port_kernel():
    why = check_config(ta.ServingConfig(backend="graph_ann", ef=4096, kernel=True), 10)
    assert why is not None and "exceeds the kernel budget" in why


SPEC_CASES = [
    {},
    {"batch_size": 0},
    {"batch_size": 32, "max_queue": 16},
    {"max_queue": 0},
    {"max_wait_s": 0.0},
    {"overload": "drop"},
    {"overload": "shed_oldest", "max_queue": 64},
    {"corpus_dtype": "bf16"},
    {"corpus_dtype": "float16"},
    {"corpus_dtype": "mixed(bfloat16,float32)"},
    {"rerank_keep": 0},
    {"rerank_keep": 10},
    {"budget": "rerank_s=0.002"},
    {"budget": "total_s=0.05"},
    {"backend": "reference", "live": "live"},
    {"profile": "profile", "live": "live"},
    {"budget": "bad"},
]


def _spec_kwargs(case, lib):
    kw = dict(case)
    budget = kw.get("budget")
    if isinstance(budget, str):
        if budget == "bad":
            kw["budget"] = 0.5
        else:
            name, value = budget.split("=")
            kw["budget"] = (JStageBudget if lib is jspec else StageBudget)(**{name: float(value)})
    if kw.get("live") == "live":
        kw["live"] = object()
    if kw.get("profile") == "profile":
        kw["profile"] = (ja if lib is jspec else ta).TunedProfile(
            (ja if lib is jspec else ta).ServingConfig())
    return kw


def _outcome(factory, kw):
    try:
        factory(**kw)
        return None
    except (ValueError, TypeError) as exc:
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("case", SPEC_CASES, ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "default")
def test_endpoint_spec_legality_as_repro(case):
    want = _outcome(jspec.EndpointSpec, _spec_kwargs(case, jspec))
    got = _outcome(EndpointSpec, _spec_kwargs(case, None))
    assert got == want
    # the keyword shim takes the same decisions
    want = _outcome(jspec.EndpointSpec.from_kwargs, _spec_kwargs(case, jspec))
    got = _outcome(EndpointSpec.from_kwargs, _spec_kwargs(case, None))
    assert got == want


def test_jit_is_refused_where_repro_accepts():
    assert jspec.EndpointSpec(jit=True).jit
    with pytest.raises(ValueError, match="no counterpart in the port"):
        EndpointSpec(jit=True)
    with RetrievalService(cache_size=0) as svc:
        with pytest.raises(ValueError, match="no counterpart in the port"):
            svc.register_runner("r", lambda b, _t: b, torch.zeros(2), jit=True)
        assert svc.endpoints() == ()
    spec = EndpointSpec(batch_size=8)
    with pytest.raises(ValueError, match="no counterpart in the port"):
        dataclasses.replace(spec, jit=True)


def test_spec_and_kwargs_together_are_ambiguous():
    with RetrievalService(cache_size=0) as svc:
        with pytest.raises(ValueError, match="ambiguous"):
            svc.register_runner("r", lambda b, _t: b, torch.zeros(2), spec=EndpointSpec(),
                                batch_size=4)


GENOMES = [
    {},
    {"backend": "pallas", "corpus_dtype": "bfloat16", "batch_size": 32, "cache_size": 4096},
    {"backend": "streaming", "tile_n": 2048, "n_shards": 2, "max_queue": 128, "overload": "reject"},
    {"backend": "graph_ann", "ef": 64, "hops": 4, "kernel": True},
    {"backend": "napp", "num_search": 8, "rerank_qty": 128, "max_wait_s": 0.002},
    {"backend": "pallas", "rerank_keep": 20, "rerank_budget_ms": 5.0},
]


@pytest.mark.parametrize("fields", GENOMES, ids=lambda f: f.get("backend", "reference"))
def test_profile_tag_and_json_equal_repro(fields):
    jcfg, tcfg = _pair(fields)
    jprof = ja.TunedProfile(jcfg, qps=1234.5, p50_ms=3.25, p99_ms=9.5, recall=0.97,
                            identity="pallas(tile_n=auto)")
    tprof = TunedProfile(tcfg, qps=1234.5, p50_ms=3.25, p99_ms=9.5, recall=0.97,
                         identity="pallas(tile_n=auto)")
    assert tprof.tag == jprof.tag and tprof.tag.startswith("profile:")
    assert tprof.to_json() == jprof.to_json()
    assert tcfg.key() == jcfg.key() and tcfg.to_dict() == jcfg.to_dict()
    # a profile written by repro loads here and expands to a valid spec
    loaded = TunedProfile.from_json(jprof.to_json())
    assert loaded == tprof and loaded.tag == jprof.tag
    spec = loaded.to_spec()
    jspec_ = jprof.to_spec()
    assert (spec.batch_size, spec.max_wait_s, spec.max_queue, spec.overload, spec.corpus_dtype,
            spec.rerank_keep) == (jspec_.batch_size, jspec_.max_wait_s, jspec_.max_queue,
                                  jspec_.overload, jspec_.corpus_dtype, jspec_.rerank_keep)
    assert spec.profile is loaded
    assert (spec.budget is None) == (jspec_.budget is None)
    if spec.budget is not None:
        assert spec.budget.rerank_s == jspec_.budget.rerank_s
    if fields.get("backend") == "pallas":
        assert isinstance(spec.backend, CudaBackend)


def test_measured_point_rows_as_repro():
    jcfg, tcfg = _pair(GENOMES[2])
    jp_ = ja.MeasuredPoint(jcfg, qps=900.0, p50_ms=2.0, p99_ms=7.5, recall=1.0,
                           identity="streaming(tile_n=2048)", corpus_dtype="float32")
    tp_ = MeasuredPoint(tcfg, qps=900.0, p50_ms=2.0, p99_ms=7.5, recall=1.0,
                        identity="streaming(tile_n=2048)", corpus_dtype="float32")
    assert tp_.to_row() == jp_.to_row()
    assert MeasuredPoint.from_row(jp_.to_row()) == tp_
    assert tp_.objectives() == jp_.objectives()
    prof = TunedProfile.from_point(tp_, source="test")
    assert prof.tag == ja.TunedProfile.from_point(jp_, source="test").tag


def test_profile_registration_binds_knobs_and_tags_snapshots():
    from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline

    prof = TunedProfile(ServingConfig(backend="pallas", batch_size=4, max_wait_s=0.002,
                                      max_queue=8, overload="reject"))
    pipe = RetrievalPipeline(BruteForceGenerator(DenseSpace("ip"), torch.randn(64, 8)))
    with RetrievalService(cache_size=0) as svc:
        svc.register_pipeline("tuned", pipe, torch.zeros(8), profile=prof)
        out = svc.submit(torch.ones(8), endpoint="tuned").result(timeout=30)
        ep = svc.snapshot().endpoints["tuned"]
        batcher = svc.router.resolve("tuned")
    assert out.indices.shape == (10,)
    assert ep.profile == prof.tag and ep.backend == "cuda" and ep.depth_limit == 8
    assert (batcher.batch_size, batcher.max_wait_s, batcher.overload) == (4, 0.002, "reject")
    with pytest.raises(ValueError, match="n_shards"):
        with RetrievalService(cache_size=0) as svc:
            svc.register_pipeline("x", pipe, torch.zeros(8), profile=TunedProfile(
                ServingConfig(backend="pallas", n_shards=2)))
