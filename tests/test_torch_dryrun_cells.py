"""Rank 0's argument blocks of every dry-run cell (``launch/steps.py``
``build_cell``) against the reference's per-device shards.

For each of the 40 (arch x shape) cells, on a ("data", "model") mesh of
(2, 4) and of (16, 16): every argument leaf that the port's rank 0 holds
(parameters placed by ``params_sharding``, a stacked layer leaf as its
layers' blocks, the optimizer state as the step's ``init`` places it,
the batch or the KV cache as ``DTensor`` blocks) has the shape and
dtype of ``in_shardings``' ``shard_shape`` for the reference's leaf of
that name (``tests/_torch_mesh_ref.py`` ``cells_reference``, on 8 and
256 forced host devices), and the rank's argument bytes are the
reference's summed shard bytes.

One deliberate difference: ZeRO-1's optimizer state.  The reference's
``zero_axes_of`` names the mesh axis "data" where ``params_sharding``
reads logical axis names, which map "data" to no split, so its state
shards are not cut over "data"; the port's step cuts them as the plan
means (``MeshUpdate``).  For phi3.5-moe and arctic-480b ``train_4k`` the
state leaves the plan cuts hold 1/data of the reference's block on the
plan's dim (Adafactor's factors where that dim survives), and the bytes
are the reference's less that cut.  The reference's side works the cuts
out from its own ``zero_axes_of`` (``_torch_mesh_ref._zero_cuts``),
leaving out each leaf whose sharding already takes "data" (arctic-480b's
experts, split over "data" by expert parallelism).
"""

import math

import pytest

from _torch_parity import ReproMesh

pytestmark = pytest.mark.torch

MESHES = {"2x4": ((2, 4), 8), "16x16": ((16, 16), 256)}


def _cells():
    from repro_torch.launch.steps import all_cells

    return all_cells()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the reference's shards by mesh, the port's rank 0 by mesh): the
    reference's processes run while the port builds its cells."""
    tmp = tmp_path_factory.mktemp("cells")
    procs = {tag: ReproMesh("cells_reference", tmp, [(shape, ("data", "model"))], n_devices=n, timeout=600)
             for tag, (shape, n) in MESHES.items()}
    port = {tag: _port_side(shape) for tag, (shape, _) in MESHES.items()}
    return {tag: p.result() for tag, p in procs.items()}, port


def _port_side(shape):
    """{(arch, shape name): (arg_shapes, argument bytes)} of every cell on
    rank 0 of a fake world over ``shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.launch.dryrun import fake_world

    out = {}
    with fake_world(math.prod(shape)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            for arch, name in _cells():
                cell = ST.build_cell(arch, name, mesh, device="cpu")
                out[arch, name] = (ST.arg_shapes(cell), sum(ST.storage_bytes(cell.args).values()))
    return out


_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8, "int32": 4, "int64": 8, "bool": 1}


def _zero_cut(path, shape, zero, data, want):
    """The reference's block of an optimizer-state leaf with ZeRO's cut of
    the reference's dim over ``data`` ranks (see the module's docstring)."""
    if zero is None or not path.startswith("1.") or path == "1.step":
        return shape
    kind, ref = path.split(".", 2)[1:]
    dim = zero.get(ref)
    if dim is None:
        return shape
    nd = len(want["0." + ref][0])
    if kind == "vr":
        dim = dim if nd == 1 or dim < nd - 1 else None
    elif kind == "vc":
        dim = None if nd == 1 else dim if dim < nd - 2 else (nd - 2 if dim == nd - 1 else None)
    if dim is None:
        return shape
    out = list(shape)
    out[dim] = -(-out[dim] // data)
    return tuple(out)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", _cells())
def test_rank_zero_blocks_are_the_reference_shards(sides, mesh, arch, shape):
    reference, port = sides
    (mshape, _) = MESHES[mesh]
    want = reference[mesh]["shards"][tuple(mshape), arch, shape]
    zero = reference[mesh]["zero"][tuple(mshape), arch, shape]
    got, nbytes = port[mesh][arch, shape]
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))
    expect = {p: (_zero_cut(p, tuple(s), zero, mshape[0], want), dt) for p, (s, dt) in want.items()}
    for p in want:
        assert got[p] == expect[p], p
    want_bytes = sum(math.prod(s) * _ITEMSIZE[dt] for s, dt in expect.values())
    assert nbytes == want_bytes
    if zero is None:
        assert nbytes == reference[mesh]["bytes"][tuple(mshape), arch, shape]
    else:
        assert nbytes < reference[mesh]["bytes"][tuple(mshape), arch, shape]


def test_cells_and_model_flops_match_the_reference_run(sides):
    """The subprocess's own ``all_cells`` and ``model_flops_for`` under the
    forced devices: the port's lists and counts."""
    reference, _ = sides
    from repro_torch import configs
    from repro_torch.launch.roofline import model_flops_for
    from repro_torch.launch.steps import shape_by_name

    ref = reference["2x4"]
    assert ref["cells"] == _cells()
    for (arch, name), flops in ref["flops"].items():
        cfg = configs.get_config(arch, name)
        assert model_flops_for(cfg, shape_by_name(cfg.family, name)) == pytest.approx(flops, rel=1e-12, abs=0)
