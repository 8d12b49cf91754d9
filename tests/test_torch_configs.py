"""repro_torch.configs and repro_torch.distributed.sharding held against
repro's: every architecture's published config and smoke config field for
field (rules included), the analytic parameter counts, the registry, and
the one-device ``ParallelCtx``.  Configs are pure data: equality is exact.
"""

import dataclasses

import jax
import pytest
import torch

import repro.configs as jc
from repro.configs import paper_retrieval as jpaper
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.distributed.sharding import params_sharding as j_params_sharding
import repro_torch.configs as tc
from repro_torch.configs import paper_retrieval as tpaper
from repro_torch.configs import base as tbase
from repro_torch.distributed.sharding import ParallelCtx, params_sharding

pytestmark = pytest.mark.torch

ARCHS = list(jc.ARCHS)


def _fields(cfg):
    """A config dataclass as a plain nested value (nested dataclasses,
    tuples and rule dicts compared by value, not by class)."""
    if dataclasses.is_dataclass(cfg):
        return (type(cfg).__name__, {f.name: _fields(getattr(cfg, f.name))
                                     for f in dataclasses.fields(cfg)})
    if isinstance(cfg, (tuple, list)):
        return tuple(_fields(x) for x in cfg)
    if isinstance(cfg, dict):
        return {k: _fields(v) for k, v in cfg.items()}
    return cfg


def test_registry_lists_the_same_archs():
    assert tc.all_archs() == jc.all_archs()
    assert set(tc.ARCHS) == set(jc.ARCHS)
    assert all(tc.ARCHS[a] == jc.ARCHS[a].replace("repro.", "repro_torch.", 1) for a in jc.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_repro(arch):
    assert _fields(tc.get_config(arch)) == _fields(jc.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_equals_repro(arch):
    assert _fields(tc.get_smoke_config(arch)) == _fields(jc.get_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_repro(arch):
    for get in ("get_config", "get_smoke_config"):
        want, got = getattr(jc, get)(arch), getattr(tc, get)(arch)
        assert got.param_count() == want.param_count()
        if hasattr(want, "active_param_count"):
            assert got.active_param_count() == want.active_param_count()


def test_smollm_360m_param_count():
    cfg = tc.get_config("smollm-360m")
    assert cfg.param_count() == 361_758_720
    assert cfg.param_count() - cfg.vocab_size * cfg.d_model == 314_572_800


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule", "ogb_products"])
def test_config_for_shape_equals_repro(shape):
    assert _fields(tc.get_config("schnet", shape)) == _fields(jc.get_config("schnet", shape))


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_smoke_config("gpt-5")


def test_paper_retrieval_config_equals_repro():
    assert _fields(tpaper.CONFIG) == _fields(jpaper.CONFIG)
    assert _fields(tpaper.smoke_config()) == _fields(jpaper.smoke_config())


def test_rule_tables_and_shapes_equal_repro():
    from repro.configs import base as jbase

    for name in ("DEFAULT_LM_RULES", "DEFAULT_GNN_RULES", "DEFAULT_RECSYS_RULES",
                 "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        assert _fields(getattr(tbase, name)) == _fields(getattr(jbase, name)), name


def test_rules_are_copied_per_config():
    """Each config's rules are its own dict, as in repro (a default
    factory), so editing one does not edit the defaults."""
    a, b = tbase.TransformerConfig("a", 1, 8, 1, 1, 8, 8), tbase.TransformerConfig("b", 1, 8, 1, 1, 8, 8)
    assert a.rules == tbase.DEFAULT_LM_RULES and a.rules is not b.rules


# ---------------------------------------------------------------------------
# ParallelCtx without a mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b", "arctic-480b"])
def test_parallel_ctx_without_mesh_is_the_identity(arch):
    rules = tc.get_config(arch).rules
    ctx, jctx = ParallelCtx(None, rules), JCtx(None, rules)
    x = torch.arange(6.0).reshape(2, 3)
    assert ctx.constrain(x, "batch", "embed") is x
    assert ctx.sharding("batch", "heads") is None and jctx.sharding("batch", "heads") is None
    assert ctx.spec("batch", None, "heads") == (None, None, None) == tuple(jctx.spec("batch", None, "heads"))
    for logical in ("batch", "heads", "ff", "vocab", "experts"):
        assert ctx.axis_size(logical) == jctx.axis_size(logical) == 1
        assert ctx.mesh_axes(logical) is None and jctx.mesh_axes(logical) is None


def test_params_sharding_without_mesh_equals_repro():
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT

    cfg_j, cfg_t = jc.get_smoke_config("minicpm3-4b"), tc.get_smoke_config("minicpm3-4b")
    _, axes_j = JT.init_transformer(jax.random.PRNGKey(0), cfg_j)
    _, axes_t = TT.init_transformer(cfg_t, device="meta")
    assert axes_t == axes_j
    want = j_params_sharding(axes_j, JCtx(None, cfg_j.rules))
    got = params_sharding(axes_t, ParallelCtx(None, cfg_t.rules))
    assert got == want
