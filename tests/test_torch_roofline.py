"""The dry run's roofline terms (``repro_torch/launch/roofline.py``, the
reference's HLO half) against ``repro``'s, and the port's tracer.

Held against ``repro.launch.roofline`` on the same inputs: the HLO
parser (``_shape_bytes``, ``collective_bytes_from_hlo``: the reference's
own test text, tuple shapes, ``-start`` ops, unknown dtypes), exactly;
``model_flops_for`` on every one of the 40 cells, within 1e-12
relative; ``Roofline``'s fields (``to_dict``'s keys); and ``all_cells``,
in order.  The tracer (``Tracer``, which stands where the reference
reads XLA's ``cost_analysis``) is held against counts written out by
hand: matmul FLOPs by operand dtype, bytes read and written, the peak of
the bytes its tensors hold, and each collective's bytes under the kind
the port books it (its ``reduce_scatter`` is an all-to-all and a sum).
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.torch

_HLO_REF = """
  %all-reduce.1 = f32[8,128]{1,0} all-reduce(%x), replica_groups={}
  %ag = bf16[2,64]{1,0} all-gather(%y), dimensions={0}
  %not-a-collective = f32[4]{0} add(%a, %b)
  %aa = (f32[16]{0}, f32[16]{0}) all-to-all(%p, %q)
"""
_HLO_MORE = """
  %ars = (f32[8]{0}, bf16[4,4]{1,0}) all-reduce-start(%x), replica_groups={}
  %ard = f32[8]{0} all-reduce-done(%ars)
  %ags = (bf16[2,64]{1,0}, bf16[4,64]{1,0}) all-gather-start(%y), dimensions={0}
  %cps = (s32[16]{0}, s32[16]{0}, u32[], u32[]) collective-permute-start(%z), source_target_pairs={{0,1}}
  %rs = f16[128]{0} reduce-scatter(%w), dimensions={0}
  %rss = f16[128]{0} reduce-scatter-start(%w), dimensions={0}
  %a2as = (f32[16]{0}) all-to-all-start(%p)
  ROOT %t = (pred[3,5]{1,0}, s4[10]{0}, token[]) tuple(%a, %b, %c)
  %odd = q99[1000]{0} all-reduce(%v)
"""
_SHAPES = ("pred[3,5]", "bf16[8,128]{1,0}", "(f32[4], f32[4])", "(s32[2,3]{1,0}, u8[7], token[])", "f64[]",
           "c64[2,2]", "f8e4m3fn[16]", "x17[4]", "")


@pytest.mark.parametrize("kind,text", [("hlo", _HLO_REF), ("hlo", _HLO_MORE), ("hlo", "")]
                         + [("shape", s) for s in _SHAPES],
                         ids=["ref-test-text", "tuples-and-starts", "empty"] + [f"shape-{i}" for i in range(len(_SHAPES))])
def test_hlo_parser_matches_repro(kind, text):
    from repro.launch import roofline as JR

    from repro_torch.launch import roofline as TR

    if kind == "hlo":
        assert TR.collective_bytes_from_hlo(text) == JR.collective_bytes_from_hlo(text)
    else:
        assert TR._shape_bytes(text) == JR._shape_bytes(text)
    assert TR._DTYPE_BYTES == JR._DTYPE_BYTES and TR._COLLECTIVES == JR._COLLECTIVES
    assert TR._SHAPE_RE.pattern == JR._SHAPE_RE.pattern


def test_roofline_fields_are_repros():
    from repro.launch import roofline as JR

    from repro_torch.launch import roofline as TR

    want = [f.name for f in dataclasses.fields(JR.Roofline)]
    assert [f.name for f in dataclasses.fields(TR.Roofline)] == want
    per = {"all-gather": 100, "all-reduce": 50, "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    r = TR.analyze_terms(1e12, 4e9, per, 256, model_flops=1e14, resident_bytes=1e9,
                         flops_by_dtype={"bfloat16": 8e11, "float32": 2e11})
    assert list(r.to_dict()) == want
    assert r.compute_s == pytest.approx(8e11 / 989.4e12 + 2e11 / 67e12, rel=1e-12)
    assert r.memory_s == pytest.approx(4e9 / 3.35e12, rel=1e-12)
    assert r.collective_s == pytest.approx(150 / (18 * 25e9), rel=1e-12)
    assert r.useful_ratio == pytest.approx(1e14 / (1e12 * 256), rel=1e-12)
    assert r.bottleneck == "compute" and r.bottleneck_lower == "compute"
    # without dtypes every FLOP runs at the bf16 rate, as the reference assumes of its TPU
    assert TR.analyze_terms(1e12, 0, per, 1).compute_s == pytest.approx(1e12 / 989.4e12, rel=1e-12)


def test_cell_list_is_repros():
    from repro.launch.steps import all_cells as repro_cells

    from repro_torch.launch.steps import all_cells

    cells = all_cells()
    assert cells == repro_cells() and len(cells) == 40 and len({a for a, _ in cells}) == 10


def _cells():
    from repro_torch.launch.steps import all_cells

    return all_cells()


@pytest.mark.parametrize("arch,shape", _cells())
def test_model_flops_for_matches_repro(arch, shape):
    from repro import configs as jc
    from repro.launch import roofline as JR
    from repro.launch.steps import shape_by_name as j_shape

    from repro_torch import configs as tc
    from repro_torch.launch import roofline as TR
    from repro_torch.launch.steps import shape_by_name as t_shape

    jcfg, tcfg = jc.get_config(arch, shape), tc.get_config(arch, shape)
    want = JR.model_flops_for(jcfg, j_shape(jcfg.family, shape))
    got = TR.model_flops_for(tcfg, t_shape(tcfg.family, shape))
    assert want > 0 and got == pytest.approx(want, rel=1e-12, abs=0)


def test_tracer_counts_a_program():
    """FLOPs by operand dtype, bytes of operands and results (a view moves
    none), the peak of held bytes (arguments not counted; a tensor's bytes
    leave with it), the in-place op's result not a new allocation."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.roofline import Tracer, cost_dict

    with FakeTensorMode():
        a = torch.empty(64, 32, dtype=torch.bfloat16)
        b = torch.empty(32, 16, dtype=torch.bfloat16)
        x = torch.empty(8, 128)
        with Tracer() as tracer:
            c = a @ b                               # 2*64*32*16 bf16 FLOPs; reads 4096+1024 B, writes 2048 B
            y = x.t()                               # a view: nothing
            z = torch.bmm(x.view(1, 8, 128), y.reshape(1, 128, 8))   # views: only bmm reads and writes
            del z
            w = torch.empty(1000, dtype=torch.float64)   # 8000 B held
            w.add_(1.0)                             # in place: no new storage
            del w
    t = tracer.trace
    assert t.flops_by_dtype == {"bfloat16": 2 * 64 * 32 * 16, "float32": 2 * 8 * 128 * 8}
    assert cost_dict(t) == {"flops": float(2 * 64 * 32 * 16 + 2 * 8 * 128 * 8), "bytes accessed": t.bytes_accessed}
    mm = 4096 + 1024 + 2048
    bmm = 4096 + 4096 + 8 * 8 * 4
    assert t.bytes_accessed == mm + bmm + 8000 + 2 * 8000     # empty writes its 8000 B, add_ reads and writes them
    # c (2048) held throughout; bmm's result (256) gone before w (8000) is made
    assert t.peak_bytes == 2048 + 8000 and t.live_bytes == 2048
    assert c.shape == (64, 16)


def test_tracer_books_collectives_by_kind():
    """On rank 0 of a fake world of 4 ranks over a (2, 2) mesh: an
    all-reduce, an all-gather and the port's reduce-scatter (booked as the
    all-to-all it is), each by its output bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh_utils import make_mesh
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.roofline import Tracer

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty(8, 16)
            with Tracer() as tracer:
                C.psum(x, mesh, "data")
                C.gather_axis(x, mesh, "model", 0)
                C.scatter_axis(x, mesh, "model", 0)
    per = tracer.trace.per_collective
    assert per == {"all-reduce": 512, "all-gather": 2 * 512, "reduce-scatter": 0, "all-to-all": 512,
                   "collective-permute": 0}
    assert tracer.trace.collective_bytes == 4 * 512
