"""The port's LM train step held against ``repro``'s on the CPU, in f32:
``lm_loss`` and its gradients against ``jax.value_and_grad``, and one
whole ``make_lm_train_step`` step (gradients, clip, optimizer) for the
smoke configs of smollm-360m, qwen2.5-3b (non-zero QKV biases),
minicpm3-4b (MLA), phi3.5-moe (Adafactor, ``grad_accum`` 4) and
arctic-480b (Adafactor, ``grad_accum`` 8, a dense residual beside the
experts), and a step taken by both packages from the same non-zero
optimizer state (carried by ``interop.adam_state`` and
``interop.adafactor_state``).  The other families' steps are in
``test_torch_train_families.py``, remat, accumulation and the backward's
memory contract in ``test_torch_train_memory.py``.

Tolerance: ``TRAIN_TOL`` = 1e-5 of each leaf's largest |value| (a loss:
of itself), for the loss, every gradient leaf, every updated parameter
and every optimizer-state leaf, with one addition for AdamW's
parameters.  AdamW divides each moment by ``sqrt(v) + 1e-8``: where that
is small, the update moves far for a small move of the gradient (a
gradient of 2.7e-8 beside one of 7.6e-3 in smollm's ``wo`` leaves its
update anywhere within the gradients' own tolerance).  So each updated
element is held within ``TRAIN_TOL`` of its leaf's scale *plus* how far
the reference's own update of that element moves when its gradient moves
by the gradient tolerance (``_torch_parity.assert_adamw_close``, in f64
from the reference's moments).  The reference's gradients and steps are
jitted (eager they take seconds a call).  With experts, routes are pinned
by ``_torch_parity.PinnedRoutes`` (a near-tie that flips is counted and
routed as ``repro`` routed it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.distributed.sharding import ParallelCtx as JCtx
from repro.launch import steps as JST
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.distributed.sharding import ParallelCtx
from repro_torch.launch import steps as TST
from repro_torch.models import transformer as TT

from _torch_parity import (TRAIN_TOL, PinnedRoutes, assert_leaf_close, assert_step_close, assert_tree_close,
                           lm_batch, lm_configs, lm_model, lm_reference_params, np_of, port_tree)

pytestmark = pytest.mark.torch

ARCHS = ["smollm-360m", "qwen2.5-3b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b", "arctic-480b"]


def pins_for(arch, monkeypatch):
    return PinnedRoutes(monkeypatch, TRAIN_TOL) if jc.get_smoke_config(arch).is_moe else None


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax(arch, monkeypatch):
    """``lm_loss`` and every gradient leaf against ``jax.value_and_grad``
    (the aux loss's gradient included, with experts)."""
    jcfg, tcfg = lm_configs(arch)
    p = lm_reference_params(arch, "float32")
    pins = pins_for(arch, monkeypatch)
    batch = lm_batch(jcfg.vocab_size)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(lambda q, b: JT.lm_loss(q, b, jcfg, JCtx(None, jcfg.rules)),
                                                  has_aux=True))(p, {k: jnp.asarray(v) for k, v in batch.items()})
    model = lm_model(p, tcfg)
    loss, parts = TT.lm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                             ParallelCtx(None, tcfg.rules))
    loss.backward()
    assert_leaf_close(np.asarray(jl), loss, TRAIN_TOL, "loss")
    assert_leaf_close(np.asarray(jparts["aux"]), parts["aux"], TRAIN_TOL, "aux")
    grads = {n: p_.grad for n, p_ in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    assert_tree_close(port_tree(jg, model), grads, arch)
    if pins is not None:
        pins.done()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_repro(arch, monkeypatch):
    """One whole step of ``make_lm_train_step`` (the config's optimizer
    and ``grad_accum``): the loss, every updated parameter and every
    optimizer-state leaf (AdamW's moments split by ``interop.adam_state``,
    Adafactor's factors by ``interop.adafactor_state``)."""
    jcfg, tcfg = lm_configs(arch)
    p = lm_reference_params(arch, "float32")
    pins = pins_for(arch, monkeypatch)
    batch = lm_batch(jcfg.vocab_size, seed=1)
    jstep, jopt = JST.make_lm_train_step(jcfg, JCtx(None, jcfg.rules), lr=1e-3)
    jp, js, jm = jax.jit(jstep)(p, jopt.init(p), {k: jnp.asarray(v) for k, v in batch.items()})
    model = lm_model(p, tcfg)
    tstep, topt = TST.make_lm_train_step(tcfg, ParallelCtx(None, tcfg.rules), lr=1e-3)
    state = topt.init(model)
    out, state2, tm = tstep(model, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out is model and state2 is state
    assert set(tm) == set(jm) == ({"loss"} if tcfg.grad_accum > 1 else {"loss", "ce", "aux"})
    assert topt.name == jcfg.optimizer
    assert_leaf_close(np.asarray(jm["loss"]), tm["loss"], TRAIN_TOL, "loss")
    carry = interop.adam_state if topt.name == "adamw" else interop.adafactor_state
    want = carry(jax.tree.map(np_of, js), model, "cpu")
    assert int(state.step) == int(want.step) == 1
    assert_step_close(topt.name, port_tree(jp, model), dict(model.named_parameters()), None, want, 1, 1e-3,
                      f"{arch} params")
    for field in state._fields[1:]:
        assert_tree_close(getattr(want, field), getattr(state, field), f"{arch} {field}")
    if pins is not None:
        pins.done()


@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b-a6.6b"])
def test_both_packages_step_from_the_same_state(arch, monkeypatch):
    """Two ``repro`` steps; the state after the first carried into the port
    (``interop``), which then takes the second: parameters and state equal
    to ``repro``'s after its second within ``TRAIN_TOL``."""
    jcfg, tcfg = lm_configs(arch)
    p = lm_reference_params(arch, "float32")
    pins = pins_for(arch, monkeypatch)
    jstep, jopt = JST.make_lm_train_step(jcfg, JCtx(None, jcfg.rules), lr=1e-3)
    jstep = jax.jit(jstep)
    b1, b2 = lm_batch(jcfg.vocab_size, seed=2), lm_batch(jcfg.vocab_size, seed=3)
    jp, js, _ = jstep(p, jopt.init(p), {k: jnp.asarray(v) for k, v in b1.items()})
    model = lm_model(jp, tcfg)
    carry = interop.adam_state if jcfg.optimizer == "adamw" else interop.adafactor_state
    state = carry(jax.tree.map(np_of, js), model, "cpu")
    old = carry(jax.tree.map(np_of, js), model, "cpu")
    if pins is not None:       # the port takes only the second step
        pins.ref.clear()
    jp2, js2, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b2.items()})
    tstep, _ = TST.make_lm_train_step(tcfg, ParallelCtx(None, tcfg.rules), lr=1e-3)
    _, _, tm = tstep(model, state, {k: torch.from_numpy(v) for k, v in b2.items()})
    assert_leaf_close(np.asarray(jm["loss"]), tm["loss"], TRAIN_TOL, "loss")
    want = carry(jax.tree.map(np_of, js2), model, "cpu")
    assert int(state.step) == 2
    assert_step_close(jcfg.optimizer, port_tree(jp2, model), dict(model.named_parameters()), old, want, 2, 1e-3,
                      "params")
    for field in state._fields[1:]:
        assert_tree_close(getattr(want, field), getattr(state, field), field)
    if pins is not None:
        pins.done()
