"""repro_torch.checkpoint on the CPU: the reference's on-disk layout
(one ``.npy`` per leaf keyed by its path, ``manifest.json``, an atomic
rename), a bit-exact round trip of f32, bf16 and i32 leaves through
modules, NamedTuple optimizer states and dicts, a shape mismatch refused,
retention and resume, a torn directory skipped, an async save that keeps
the state of the moment ``save`` was called while the parameters change
in place right after it, and directories that ``repro`` wrote restored
into the port's structures (``interop.restore_repro_checkpoint``: bf16
bit for bit, the stacked layer axis split).
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.optim import optimizer as JO
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.checkpoint import manager as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizer as TO

from _torch_parity import lm_configs, lm_model, lm_reference_params, np_of

pytestmark = pytest.mark.torch


def small_tree(seed=0):
    """A module-free tree: f32, bf16 (with -0, inf, NaN and a subnormal) and i32 leaves in dicts and a list."""
    g = torch.Generator().manual_seed(seed)
    bf = torch.randn(3, 5, generator=g).to(torch.bfloat16)
    bf[0, :4] = torch.tensor([-0.0, float("inf"), float("nan"), 1e-40]).to(torch.bfloat16)
    return {"params": {"w": torch.randn(3, 4, generator=g), "b16": bf,
                       "layers": [{"a": torch.ones(2)}, {"a": torch.zeros(2)}]},
            "step_count": torch.tensor(7, dtype=torch.int32)}


def zeros_like_tree(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    return [zeros_like_tree(v) for v in tree]


def same_bits(a, b) -> bool:
    """Two leaves (tensors or arrays as written to disk) of one dtype and shape with equal bytes."""
    a, b = TCK.host_array(a), TCK.host_array(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def bits_equal(a, b):
    fa, fb = TCK.flatten_with_paths(a), TCK.flatten_with_paths(b)
    assert list(fa) == list(fb)
    return all(same_bits(x, y) for x, y in zip(fa.values(), fb.values()))


def model_and_state(arch="smollm-360m", dtype="bfloat16", optimizer="adamw", seed=0):
    import dataclasses

    _, tcfg = lm_configs(arch, dtype)
    tcfg = dataclasses.replace(tcfg, optimizer=optimizer)
    model, _ = TT.init_transformer(tcfg, seed=seed, device="cpu")
    opt = TO.make_optimizer(optimizer)
    state = opt.init(model)
    for t in state[1:]:
        for v in t.values():
            v.normal_(generator=torch.Generator().manual_seed(seed + 1))
    state.step.fill_(5)
    return model, state


def test_layout_and_bit_exact_round_trip(tmp_path):
    """A model (bf16), its AdamW state and a plain tree saved and restored
    into zeroed copies, bit for bit; the directory holds what the
    reference's layout says, bf16 as ``|V2`` with ``bfloat16`` in the
    manifest."""
    model, state = model_and_state()
    tree = {"params": model, "opt": state, "extra": small_tree()}
    path = save_checkpoint(str(tmp_path), 12, tree)
    assert os.path.basename(path) == "step_0000000012"
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["step"] == 12
    info = manifest["leaves"]["params/blocks/0/attn/wq"]
    assert info["dtype"] == "bfloat16" and info["file"] == "params__blocks__0__attn__wq.npy"
    assert np.load(os.path.join(path, info["file"])).dtype.str == "|V2"
    assert manifest["leaves"]["opt/.m/blocks/1/ffn/w_in"]["dtype"] == "float32"
    assert manifest["leaves"]["opt/.step"] == {"file": "opt__.step.npy", "dtype": "int32", "shape": []}
    assert sorted(os.listdir(path)) == sorted([i["file"] for i in manifest["leaves"].values()] + ["manifest.json"])
    m2, s2 = model_and_state(seed=9)
    target = {"params": m2, "opt": s2, "extra": zeros_like_tree(small_tree())}
    assert restore_checkpoint(path, target) is target
    assert bits_equal(tree, target)
    assert not any(n.startswith(".tmp_ckpt_") for n in os.listdir(tmp_path))


def test_shape_mismatch_rejected(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, small_tree())
    bad = zeros_like_tree(small_tree())
    bad["params"]["w"] = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(path, bad)


def test_a_failed_save_leaves_no_directory(tmp_path, monkeypatch):
    """A save that fails half-way removes its temp directory and leaves the
    last good checkpoint as it was."""
    save_checkpoint(str(tmp_path), 1, small_tree())

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(TCK.np, "save", broken)
    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 2, small_tree())
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001"]


def test_manager_retention_and_resume(tmp_path):
    tree = small_tree()
    mgr = CheckpointManager(str(tmp_path), interval=2, max_to_keep=2)
    for step in range(1, 9):
        if mgr.should_save(step):
            mgr.save(step, tree)
    assert mgr.all_steps() == [6, 8]
    target = zeros_like_tree(tree)
    step, restored = mgr.restore_latest(target)
    assert step == 8 and restored is target and bits_equal(tree, target)


def test_torn_checkpoint_skipped(tmp_path):
    tree = small_tree()
    mgr = CheckpointManager(str(tmp_path), interval=1)
    mgr.save(3, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009"))     # no manifest
    os.makedirs(os.path.join(str(tmp_path), ".tmp_ckpt_abc"))        # a temp dir left by a crash
    step, _ = mgr.restore_latest(zeros_like_tree(tree))
    assert step == 3


def test_restore_with_empty_dir(tmp_path):
    tree = small_tree()
    step, restored = CheckpointManager(str(tmp_path)).restore_latest(tree)
    assert step == 0 and restored is tree


def test_async_save_keeps_the_state_of_the_call(tmp_path, monkeypatch):
    """``save`` copies every leaf to the host before the background thread
    writes: parameters and moments updated in place right after ``save``
    returns (while the write is held back) leave the checkpoint as they
    were at the call."""
    model, state = model_and_state(dtype="float32")
    tree = {"params": model, "opt": state}
    want = {k: TCK.host_array(v, copy=True) for k, v in TCK.flatten_with_paths(tree).items()}
    gate = threading.Event()
    orig = TM.write_leaves

    def held(*a, **k):
        assert gate.wait(30)
        return orig(*a, **k)

    monkeypatch.setattr(TM, "write_leaves", held)
    mgr = CheckpointManager(str(tmp_path), interval=1, use_async=True)
    mgr.save(4, tree)
    with torch.no_grad():              # the next step, in place
        for p in model.parameters():
            p.add_(1.0)
        for t in state[1:]:
            for v in t.values():
                v.mul_(-3.0)
        state.step.add_(1)
    gate.set()
    mgr.close()
    got = TCK.load_leaves(os.path.join(str(tmp_path), "step_0000000004"))
    assert list(got) == list(want)
    for k, a in want.items():
        assert same_bits(got[k], a), k


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_repro_written_directory_restored(tmp_path, optimizer):
    """A directory that ``repro`` wrote of its bf16 parameters and its
    optimizer state, restored into the port's ``Transformer`` and state:
    every parameter bit for bit the reference's layer (its stacked axis
    split), the state equal to ``interop``'s carry of the same state."""
    arch = "qwen2.5-3b"
    jcfg, tcfg = lm_configs(arch, "bfloat16", optimizer=optimizer)
    p = lm_reference_params(arch, "bfloat16")
    jopt = JO.make_optimizer(optimizer)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), p)
    p, js = jopt.step(g, jopt.init(p), p, 1e-3)        # a state that is not zero
    path = j_save(str(tmp_path), 3, {"params": p, "opt": js})
    model, state = model_and_state(arch, "bfloat16", optimizer, seed=4)
    step = interop.restore_repro_checkpoint(path, {"params": model, "opt": state})
    assert step == 3 and int(state.step) == 1
    want = lm_model(p, tcfg)
    for (k, w), (k2, t) in zip(want.named_parameters(), model.named_parameters()):
        assert k == k2 and t.dtype == torch.bfloat16
        assert torch.equal(w.view(torch.int16), t.view(torch.int16)), k
    carry = interop.adam_state if optimizer == "adamw" else interop.adafactor_state
    carried = carry(jax.tree.map(np_of, js), model, "cpu")
    for field in state._fields[1:]:
        for k, v in getattr(carried, field).items():
            assert torch.equal(v, getattr(state, field)[k]), (field, k)
    bad = {"params": model_and_state("smollm-360m", "bfloat16", seed=5)[0]}
    with pytest.raises((ValueError, KeyError)):
        interop.restore_repro_checkpoint(path, bad)


def test_loaded_leaves_are_a_whole_mapping_each_read_once(tmp_path, monkeypatch):
    """``load_leaves`` gives every leaf through ``items``, ``values``,
    ``get`` and ``in``, bit for bit; a leaf asked for again is read from its
    file once.  ``restore_repro_checkpoint``, which asks for a stacked leaf
    once a layer, reads each file once and restores every layer."""
    tree = small_tree()
    path = save_checkpoint(str(tmp_path / "port"), 2, tree)
    want = TCK.flatten_with_paths(tree)
    reads = []
    load = np.load
    monkeypatch.setattr(TCK.np, "load", lambda f, *a, **k: reads.append(f) or load(f, *a, **k))
    got = TCK.load_leaves(path)
    assert len(got) == len(want) and list(got) == list(want)
    assert all(k in got for k in want) and "missing" not in got and got.get("missing") is None
    assert [k for k, _ in got.items()] == list(want)
    for (k, a), v in zip(want.items(), got.values()):
        assert same_bits(a, v) and same_bits(a, got.get(k)), k
    assert len(reads) == len(want)

    arch = "qwen2.5-3b"
    p = lm_reference_params(arch, "float32")
    jpath = j_save(str(tmp_path / "repro"), 1, {"params": p})
    model, _ = model_and_state(arch, "float32", seed=3)
    reads.clear()
    assert interop.restore_repro_checkpoint(jpath, {"params": model}) == 1
    assert len(reads) == len(set(reads)) == len(TCK.load_leaves(jpath))
    _, tcfg = lm_configs(arch, "float32")
    for (k, w), (_, t) in zip(lm_model(p, tcfg).named_parameters(), model.named_parameters()):
        assert torch.equal(w, t), k
