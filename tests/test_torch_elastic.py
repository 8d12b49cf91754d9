"""repro_torch.distributed.elastic, restoring a checkpoint onto shardings
and the production mesh, on 8 gloo ranks (the counterparts of
``tests/test_distributed.py::test_elastic_remesh_roundtrip`` and
``test_checkpoint_restore_across_topologies``): ``plan_remesh`` against
``repro``'s, a tree re-meshed 8 -> 4 -> 8 ranks bit for bit, and a
checkpoint that ``repro`` wrote restored onto an 8-rank ``("model",)``
mesh, each rank holding a distinct block.

The ranks run once for the module; each test asserts its own case.  This
module imports no JAX at the top: each rank imports it.
"""

import numpy as np
import pytest
import torch

from _torch_parity import run_ranks

pytestmark = pytest.mark.torch

AXES = {"w": ("rows", None), "b": (None,), "h": {"m": (None, "rows")}}
RULES = {"rows": "model"}


def _tree_np():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32), "b": np.ones(8, np.float32),
            "h": {"m": rng.standard_normal((3, 12)).astype(np.float32)}}


def _elastic_body(rank, world, tree_np, ckpt):
    from repro_torch import interop
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.elastic import plan_remesh, remesh
    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.distributed.sharding import NamedSharding, ParallelCtx, params_sharding
    from repro_torch.launch.mesh import make_production_mesh

    def whole(tree):
        out = {}
        for k, v in tree.items():
            out[k] = whole(v) if isinstance(v, dict) else \
                interop.to_numpy(C.gather_full(v.to_local(), NamedSharding.of(v), v.shape))
        return out

    def blocks(tree):
        return {k: blocks(v) if isinstance(v, dict) else interop.to_numpy(v.to_local()) for k, v in tree.items()}

    out = {"rank": rank}
    tree = {"w": torch.from_numpy(tree_np["w"]), "b": torch.from_numpy(tree_np["b"]),
            "h": {"m": torch.from_numpy(tree_np["h"]["m"]).to(torch.bfloat16)}}
    topo8, topo4 = plan_remesh(8, prefer_model=4), plan_remesh(4, prefer_model=4)
    placed8, ctx8 = remesh(tree, AXES, RULES, None, topo8, "cpu")
    out["8 blocks"] = blocks(placed8)
    placed4, ctx4 = remesh(placed8, AXES, RULES, ctx8, topo4, "cpu")
    out["4 blocks"] = None if placed4 is None else blocks(placed4)
    out["4 whole"] = None if placed4 is None else whole(placed4)
    back8, _ = remesh(placed4, AXES, RULES, ctx4, topo8, "cpu")
    out["back"] = whole(back8)
    out["bf16"] = back8["h"]["m"].dtype == torch.bfloat16

    mesh = make_mesh((8,), ("model",), "cpu")
    target = {"w": torch.zeros(16, 8), "b": torch.zeros(8)}
    sh = params_sharding({"w": ("rows", None), "b": None}, ParallelCtx(mesh, {"rows": "model"}))
    restored = restore_checkpoint(ckpt, target, sh)
    out["restored block"] = restored["w"].to_local().numpy()
    out["restored whole"] = C.gather_full(restored["w"].to_local(), sh["w"], (16, 8)).numpy()
    out["restored b"] = restored["b"].numpy()
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device="cpu")
        except ValueError as e:
            out["production", multi_pod] = str(e)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint written by ``repro``: ``w`` [16, 8] and ``b`` [8]."""
    import jax.numpy as jnp

    from repro.checkpoint import save_checkpoint

    tree = {"w": jnp.arange(128.0).reshape(16, 8), "b": jnp.arange(8.0) - 3.5}
    return save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), 1, tree), {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def ranks(ckpt, tmp_path_factory):
    return run_ranks(_elastic_body, 8, tmp_path_factory.mktemp("elastic"), _tree_np(), ckpt[0])


@pytest.mark.parametrize("devices, prefer", [(8, 4), (4, 4), (6, 4), (7, 4), (16, 8), (12, 8), (1, 4), (2, 1)])
def test_plan_remesh_matches_repro(devices, prefer):
    from repro.distributed.elastic import plan_remesh as j_plan
    from repro_torch.distributed.elastic import plan_remesh

    got, want = plan_remesh(devices, prefer), j_plan(devices, prefer)
    assert got.shape == want.shape and got.axes == want.axes and got.n_devices == want.n_devices == devices


def test_remesh_round_trip_8_4_8(ranks):
    """8 -> 4 -> 8 ranks bit for bit (``test_elastic_remesh_roundtrip``);
    on 4 ranks, ranks 4-7 hold nothing and 0-3 a 2-row block of ``w``."""
    tree = _tree_np()
    for r in ranks:
        assert np.array_equal(r["back"]["w"], tree["w"]) and np.array_equal(r["back"]["b"], tree["b"])
        want_m = torch.from_numpy(tree["h"]["m"]).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(r["back"]["h"]["m"], want_m)     # bf16 as its bits
        assert r["bf16"]
        model = r["rank"] % 4
        assert np.array_equal(r["8 blocks"]["w"], tree["w"][2 * model:2 * model + 2])
        assert np.array_equal(r["8 blocks"]["b"], tree["b"])
        if r["rank"] >= 4:
            assert r["4 blocks"] is None
        else:
            assert np.array_equal(r["4 blocks"]["w"], tree["w"][2 * r["rank"]:2 * r["rank"] + 2])
            assert r["4 blocks"]["h"]["m"].shape == (3, 3)
            assert np.array_equal(r["4 whole"]["w"], tree["w"])


def test_restore_repro_checkpoint_onto_an_8_rank_mesh(ranks, ckpt):
    """A checkpoint ``repro`` wrote, restored onto ``("model",) = (8,)``
    with rows sharded (``test_checkpoint_restore_across_topologies``):
    each rank holds its own 2-row block, and together they are the saved
    leaf bit for bit; a leaf without a sharding comes back whole."""
    _, saved = ckpt
    blocks = [r["restored block"] for r in ranks]
    for r in ranks:
        assert np.array_equal(r["restored block"], saved["w"][2 * r["rank"]:2 * r["rank"] + 2])
        assert np.array_equal(r["restored whole"], saved["w"])
        assert np.array_equal(r["restored b"], saved["b"])
    assert len({b.tobytes() for b in blocks}) == 8


def test_make_production_mesh_needs_its_world(ranks):
    for r in ranks:
        assert "256 ranks" in r["production", False] and "this one has 8" in r["production", False]
        assert "512 ranks" in r["production", True]
