"""The dry run (``repro_torch/launch/dryrun.py`` and the cell machinery of
``launch/steps.py``) on the CPU: rank 0 of a fake process group traced
under ``FakeTensorMode``.

Held here: the production meshes on fake worlds of 256 and 512 ranks;
the reference's smoke cells (qwen2.5-3b ``decode_32k``, schnet
``molecule``, bst ``retrieval_cand``) traced on a ("data", "model") =
(2, 4) mesh with FLOPs, collective bytes and a bottleneck; arctic-480b's
``train_4k`` step (ZeRO-1 beside experts split over "data") traced at
one layer; the LM layer correction at a cut depth of 3 layers (one layer
plus 2 x the probe's layer equals the 3-layer trace exactly in every
count, and ``extend_lm``'s counts and temporaries, from the traces
``run_cell`` takes, equal the 3-layer trace at the config's chunks
exactly); the forward's FLOPs at the probe's chunks and at the config's,
equal, and the backward's, apart by exactly the tiles above the causal
diagonal that the finer tiling skips; and ``main``'s ``--help`` and one
record.  The per-rank argument blocks of all 40 cells against the
reference's are in ``test_torch_dryrun_cells.py``.
"""

import json
import os

import pytest
import torch

pytestmark = pytest.mark.torch

MESH = (2, 4)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_production_meshes_on_fake_worlds(multi_pod):
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh

    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        shape = tuple(mesh.mesh.shape)
        names = mesh.mesh_dim_names
        coord = mesh.get_coordinate()
    assert shape == ((2, 16, 16) if multi_pod else (16, 16))
    assert names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert list(coord) == [0] * len(shape)
    with fake_world(world // 2), pytest.raises(ValueError):
        make_production_mesh(multi_pod=multi_pod, device="cpu")


@pytest.mark.parametrize("arch,shape", [("qwen2.5-3b", "decode_32k"), ("schnet", "molecule"),
                                        ("bst", "retrieval_cand")])
def test_smoke_cells_trace(arch, shape):
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell(arch, shape, False, None, device="cpu", mesh_shape=MESH)
    assert rec["ok"], rec.get("traceback")
    r = rec["roofline"]
    assert r["flops"] > 0 and r["collective_bytes"] > 0 and r["n_chips"] == 8
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["model_flops"] > 0 and r["useful_ratio"] > 0
    m = rec["memory"]
    assert m["per_device_total"] == m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]
    assert m["argument_bytes"] > 0 and m["temp_bytes"] > 0
    assert (rec["probe"] is None) == (arch != "qwen2.5-3b")


def _traces(arch, shape, layers, probe):
    """(Trace, new result bytes) of the cell (with ``probe``: the probe) at
    each depth in ``layers``, on rank 0 of a fake world over MESH."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.launch.dryrun import _trace, fake_world
    from repro_torch.launch.steps import build_cell, build_lm_probe

    build = build_lm_probe if probe else build_cell
    with fake_world(MESH[0] * MESH[1]):
        mesh = make_mesh(MESH, ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            return {n: _trace(build(arch, shape, mesh, device="cpu", n_layers=n)) for n in layers}


def test_a_zero_step_beside_experts_over_data_traces():
    """arctic-480b's ``train_4k`` step at one layer: ZeRO-1
    cuts its optimizer state over "data" except the experts, which expert
    parallelism already splits over "data"; Adafactor's update of every
    leaf runs, and the gradients are reduce-scattered (booked as
    all-to-all)."""
    t = _traces("arctic-480b", "train_4k", (1,), True)[1][0]
    assert t.flops > 0 and t.per_collective["all-to-all"] > 0


_LAYER_CASES = [("qwen2.5-3b", "decode_32k"), ("minicpm3-4b", "decode_32k"), ("smollm-360m", "train_4k"),
                ("phi3.5-moe-42b-a6.6b", "train_4k")]


@pytest.mark.parametrize("arch,shape", _LAYER_CASES, ids=[f"{a}-{s}" for a, s in _LAYER_CASES])
def test_one_layer_plus_probes_is_the_three_layer_trace(arch, shape):
    """The probe at 1, 2 and 3 layers: ``extend_lm`` from the first two
    (no tiling term: one chunking) gives the third's counts exactly, and
    its temporaries (a train step's exactly, a decode step's within 0.1%,
    as ``test_extend_lm_equals_the_three_layer_trace`` says); phi3.5-moe's layer brings ZeRO's collectives of
    its optimizer state beside its block."""
    from repro_torch.launch.dryrun import extend_lm

    t = _traces(arch, shape, (1, 2, 3), True)
    (a1, out1), (a2, _), (a3, out3) = t[1], t[2], t[3]
    full, temp, info = extend_lm(a1, out1, a1, a2, 3)
    want = a3.counts()
    assert sum(v for k, v in want.items() if k.startswith("flops:")) > 0
    assert sum(v for k, v in want.items() if k.startswith("coll:")) > 0
    assert full.counts() == want
    want_temp = a3.peak_bytes - out3    # a decode step's second layer holds 64 KB the third does not add
    assert out1 == out3 and want_temp <= temp <= want_temp * 1.001
    if shape == "train_4k":
        assert temp == want_temp
    assert all(v == 0 for v in info["tiling"].values())
    assert info["probe_flops"] == a2.flops - a1.flops


@pytest.mark.parametrize("arch,shape", [("smollm-360m", "train_4k"), ("qwen2.5-3b", "decode_32k")])
def test_extend_lm_equals_the_three_layer_trace(arch, shape):
    """``run_cell``'s rule from one layer at the config's chunks and one and
    two at the probe's: the counts of 3 layers exactly, their temporaries
    within 0.1% (the train step's exactly; a decode step's second layer
    holds 64 KB the third does not add, so the rule is that much above)."""
    from repro_torch.launch.dryrun import extend_lm

    probe = _traces(arch, shape, (1, 2), True)
    real = _traces(arch, shape, (1, 3), False)
    (c1, c1_out), (c3, c3_out) = real[1], real[3]
    full, temp, info = extend_lm(c1, c1_out, probe[1][0], probe[2][0], 3)
    assert full.counts() == pytest.approx(c3.counts(), rel=1e-12, abs=0)
    want = c3.peak_bytes - c3_out
    assert c1_out == c3_out and want <= temp <= want * 1.001
    if shape == "train_4k":
        assert temp == want
    assert info["layers"] == 3 and info["probe_flops"] == pytest.approx((c3.flops - c1.flops) / 2, rel=1e-12)
    if shape == "train_4k":   # the config's 1024-row tiles skip backward tiles the probe's one tile computes
        assert info["tiling"]["flops:float32"] < 0 and info["tiling"]["flops:bfloat16"] == 0
    else:
        assert all(v == 0 for k, v in info["tiling"].items() if k.startswith("flops:"))


def _one_device_flops(cfg, fn):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.roofline import Tracer
    from repro_torch.models import transformer as T

    with FakeTensorMode(allow_non_fake_inputs=True):
        model, _ = T.init_transformer(cfg, 0, "cpu")
        tokens = torch.zeros((2, 256), dtype=torch.int64)
        with Tracer() as tracer:
            fn(model, tokens)
    return tracer.trace.flops_by_dtype


def test_tiling_changes_forward_flops_not_at_all_and_backward_by_the_skipped_tiles():
    """At a small config (qwen2.5-3b's smoke width, 2 x 256 tokens, the
    config's chunks 32, the probe's one tile): the prefill's FLOPs are
    equal; the train step's differ by the backward's 5 products on each
    tile above the diagonal, which 32-row tiles skip and one tile cannot."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import ParallelCtx
    from repro_torch.launch.steps import make_lm_train_step, probe_chunks
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), attn_chunk_q=32, attn_chunk_kv=32, remat=False)
    ctx = ParallelCtx(None, cfg.rules)

    def prefill(c):
        return lambda m, t: T.prefill_step(m, t, c, ctx)

    def train(c):
        step, opt = make_lm_train_step(c, ctx)
        return lambda m, t: step(m, opt.init(m), {"tokens": t, "targets": t})

    wide = probe_chunks(cfg)
    assert _one_device_flops(cfg, prefill(cfg)) == _one_device_flops(wide, prefill(wide))
    fine, one = _one_device_flops(cfg, train(cfg)), _one_device_flops(wide, train(wide))
    assert one.keys() == fine.keys()
    b, s, h, dh = 2, 256, cfg.padded_heads, cfg.resolved_head_dim
    n = s // 32
    above = n * (n - 1) // 2                           # tiles wholly above the causal diagonal
    skipped = cfg.n_layers * above * 5 * 2 * b * h * 32 * 32 * dh
    assert one["float32"] - fine["float32"] == skipped
    assert {k: v for k, v in one.items() if k != "float32"} == {k: v for k, v in fine.items() if k != "float32"}


def test_main_help_and_one_record(tmp_path, capsys):
    from repro_torch.launch import dryrun

    with pytest.raises(SystemExit) as e:
        dryrun.main(["--help"])
    assert e.value.code == 0
    assert "--save-hlo has no counterpart" in " ".join(capsys.readouterr().out.split())

    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--out", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "[OK ] qwen2.5-3b" in out and "16x16" in out
    with open(os.path.join(tmp_path, "qwen2.5-3b__decode_32k__16x16.json")) as f:
        rec = json.load(f)
    assert rec["ok"] and rec["mesh"] == "16x16"
    assert {"arch", "shape", "mesh", "ok", "build_s", "trace_s", "total_s", "memory", "roofline", "probe",
            "flops_by_dtype"} <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "per_device_total"}
    assert rec["roofline"]["n_chips"] == 256
    assert {"probe_flops", "probe_bytes", "probe_collective", "layers"} <= set(rec["probe"])

    with pytest.raises(SystemExit) as e:   # an existing ok record is skipped
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--out", str(tmp_path), "--device", "cpu",
                     "--skip-existing"])
    assert e.value.code == 0 and "[SKIP]" in capsys.readouterr().out


def test_a_failing_cell_is_recorded_and_main_exits_1(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import dryrun, steps

    def broken(*a, **k):
        raise RuntimeError("an injected failure")

    monkeypatch.setattr(steps, "build_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "schnet", "--shape", "molecule", "--out", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 1
    assert "[FAIL] schnet" in capsys.readouterr().out
    with open(os.path.join(tmp_path, "schnet__molecule__16x16.json")) as f:
        rec = json.load(f)
    assert not rec["ok"] and "an injected failure" in rec["error"] and "Traceback" in rec["traceback"]
    import torch.distributed as dist

    assert not dist.is_initialized()     # the fake world is gone with the cell
