"""The port's training driver (``launch/train.py``) on the CPU at smoke
size: the loss falls on a repeating token stream; a second run resumes
from the last checkpoint and takes only the steps left; a step with a
non-finite loss restores the last checkpoint and continues, bounded by
``max_restarts``; the command line runs and resumes.  And the straggler
monitor (a copy of ``repro``'s) flags what ``repro``'s flags on the same
durations.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.distributed.straggler import StragglerMonitor as JMonitor
from repro_torch import configs as reg
from repro_torch.checkpoint.checkpoint import load_leaves
from repro_torch.distributed.straggler import StragglerMonitor as TMonitor
from repro_torch.launch import train as TR

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny_cfg():
    cfg = reg.get_smoke_config("smollm-360m")
    return dataclasses.replace(cfg, n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=2,
                               n_kv_heads=1, head_dim=32, attn_chunk_q=16, attn_chunk_kv=16, remat=True)


def test_loss_decreases_on_a_repeating_stream(tiny_cfg, monkeypatch):
    """Batches drawn from a stream that repeats a 40-token phrase: 30 steps
    of remat'd training bring the loss well below its start."""
    phrase = np.random.default_rng(0).integers(0, 256, 40).astype(np.int32)
    orig = TR.lm_batches
    monkeypatch.setattr(TR, "lm_batches", lambda stream, b, s, seed: orig(np.tile(phrase, 200), b, s, seed=seed))
    model, losses = TR.train_lm(tiny_cfg, None, steps=30, ckpt_dir=None, batch_size=8, seq_len=32, lr=3e-3,
                                device="cpu")
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert next(model.parameters()).device.type == "cpu"


def test_resume_from_checkpoint(tiny_cfg, tmp_path, monkeypatch):
    """Steps 1-10 with checkpoints at 5 and 10; a second run to 14 resumes
    at 10 and takes 4 steps, from the saved state bit for bit."""
    d = str(tmp_path / "ckpt")
    model, losses = TR.train_lm(tiny_cfg, None, steps=10, ckpt_dir=d, batch_size=4, seq_len=32,
                                ckpt_interval=5, device="cpu")
    assert len(losses) == 10
    saved = load_leaves(os.path.join(d, "step_0000000010"))
    for name, p in model.named_parameters():
        assert torch.equal(saved["params/" + name.replace(".", "/")], p.detach()), name
    assert int(saved["opt/.step"]) == 10
    seen = {}
    orig = TR.make_lm_train_step

    def spy(cfg, ctx, lr):
        step, opt = orig(cfg, ctx, lr=lr)

        def wrapped(params, state, batch):
            if not seen:     # the state the resumed run starts from
                seen.update({n: p.detach().clone() for n, p in params.named_parameters()},
                            step=int(state.step))
            return step(params, state, batch)

        return wrapped, opt

    monkeypatch.setattr(TR, "make_lm_train_step", spy)
    _, losses2 = TR.train_lm(tiny_cfg, None, steps=14, ckpt_dir=d, batch_size=4, seq_len=32, ckpt_interval=5,
                             device="cpu")
    assert len(losses2) == 4
    assert seen.pop("step") == 10
    for name, p in seen.items():
        assert torch.equal(saved["params/" + name.replace(".", "/")], p), name
    assert sorted(os.listdir(d)) == ["step_0000000005", "step_0000000010", "step_0000000014"]


def test_non_finite_loss_restores_the_last_checkpoint(tiny_cfg, tmp_path, monkeypatch):
    """A NaN loss at step 7 (after the step 5 checkpoint): the driver
    restores step 5 in place and trains on to 10; a second NaN at every
    step exhausts ``max_restarts`` and raises."""
    calls = {"n": 0}
    orig = TR.make_lm_train_step

    def faulty(cfg, ctx, lr, nan_at):
        step, opt = orig(cfg, ctx, lr=lr)

        def wrapped(params, state, batch):
            calls["n"] += 1
            params, state, metrics = step(params, state, batch)
            if calls["n"] in nan_at:
                metrics = dict(metrics, loss=torch.tensor(float("nan")))
            return params, state, metrics

        return wrapped, opt

    d = str(tmp_path / "ckpt")
    monkeypatch.setattr(TR, "make_lm_train_step", lambda cfg, ctx, lr: faulty(cfg, ctx, lr, {8}))
    _, losses = TR.train_lm(tiny_cfg, None, steps=10, ckpt_dir=d, batch_size=4, seq_len=32, ckpt_interval=5,
                            device="cpu")
    # steps 1-7 (the 8th call fails), then steps 6-10 again from the step 5 checkpoint
    assert calls["n"] == 8 + 5 and len(losses) == 7 + 5 and all(np.isfinite(losses))
    calls["n"] = 0
    monkeypatch.setattr(TR, "make_lm_train_step", lambda cfg, ctx, lr: faulty(cfg, ctx, lr, set(range(2, 99))))
    with pytest.raises(FloatingPointError):
        TR.train_lm(tiny_cfg, None, steps=20, ckpt_dir=str(tmp_path / "other"), batch_size=4, seq_len=32,
                    ckpt_interval=1, max_restarts=2, device="cpu")
    assert calls["n"] == 4        # one good step, then three failures: two restarts, then the raise


def test_command_line_runs_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu``, twice:
    the second run resumes from the first's last step."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m", "--smoke", "--steps", "6",
           "--batch", "2", "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "6 steps in" in first.stdout
    cmd[cmd.index("--steps") + 1] = "8"
    second = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 6" in second.stdout and "2 steps in" in second.stdout


def test_straggler_monitor_flags_as_repro():
    """Both monitors on the same per-rank durations (a rank that slows for
    good, one that recovers, one that alternates): flags, events and the
    EWMA equal."""
    rng = np.random.default_rng(0)
    durations = []
    for step in range(40):
        d = {r: 1.0 + 0.1 * rng.random() for r in range(4)}
        if step >= 10:
            d[3] = 5.0
        if 5 <= step < 9:
            d[1] = 4.0
        if step % 2:
            d[2] = 3.0
        durations.append(d)
    clocks = [{"t": 0.0}, {"t": 0.0}]
    mons = [cls(threshold=2.0, patience=3, time_fn=lambda c=c: c["t"]) for cls, c in zip((JMonitor, TMonitor), clocks)]
    for step, d in enumerate(durations):
        out = []
        for mon, c in zip(mons, clocks):
            mon.step_begin()
            c["t"] += 1.0
            out.append(mon.step_end(step, d if step % 5 else None))
        assert out[0] == out[1], step
        if step == 20:
            for mon in mons:
                mon.reset_rank(3)
    assert [vars(e) for e in mons[0].events] == [vars(e) for e in mons[1].events]
    assert mons[0].ewma == mons[1].ewma
    assert any(e.rank == 3 for e in mons[1].events) and any(e.rank == 1 for e in mons[1].events)
