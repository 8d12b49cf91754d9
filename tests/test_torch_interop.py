"""repro_torch.interop: arrays taken from repro objects become the port's
types without changing a bit (bf16 moves as its uint16 pattern), and the
learned FusedSpace parameters carry across.  Exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spaces import FusedSpace as JFusedSpace
from repro_torch import interop
from repro_torch.core.sparse import SparseVectors
from repro_torch.core.spaces import FusedSpace, FusedVectors

from _torch_parity import np_of

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bits_round_trip(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((7, 5)), dtype)
    t = interop.tensor(np_of(x), "cpu")
    assert t.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    np.testing.assert_array_equal(interop.to_numpy(t), np_of(x))
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


def test_tensor_owns_its_memory():
    a = np.arange(6, dtype=np.float32)
    t = interop.tensor(a, "cpu")
    a[0] = 99.0
    assert float(t[0]) == 0.0
    with pytest.raises(ValueError, match="uint16"):
        interop.tensor(np.zeros(3, np.float32), "cpu", bf16=True)


def test_sparse_and_fused_vectors():
    idx = np.array([[3, 1, 9], [0, 9, 9]], np.int64)          # ids become i32
    val = np.array([[0.5, 0.25, 0.0], [1.0, 0.0, 0.0]], np.float32)
    sp = interop.sparse_vectors(idx, val, "cpu")
    assert isinstance(sp, SparseVectors) and sp.indices.dtype == torch.int32
    np.testing.assert_array_equal(sp.indices.numpy(), idx)
    fv = interop.fused_vectors(np.ones((2, 4), np.float32), idx, val, device="cpu")
    assert isinstance(fv, FusedVectors) and fv.dense.shape == (2, 4)
    assert interop.fused_vectors(None, idx, val, device="cpu").dense is None
    assert interop.fused_vectors(np.ones((2, 4), np.float32), device="cpu").sparse is None
    bits = np_of(jnp.asarray(val, jnp.bfloat16))
    fb = interop.fused_vectors(bits, idx, bits, device="cpu")
    assert fb.dense.dtype == fb.sparse.values.dtype == torch.bfloat16


def test_fused_space_parameters():
    js = JFusedSpace(30522, 0.62, 0.38, "ip")
    ts = interop.fused_space(js.vocab_size, js.w_dense, js.w_sparse, js.dense_kind)
    assert ts == FusedSpace(30522, 0.62, 0.38, "ip")
    assert (ts.vocab_size, ts.w_dense, ts.w_sparse, ts.dense_kind) == \
        (js.vocab_size, js.w_dense, js.w_sparse, js.dense_kind)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        interop.sparse_vectors(np.zeros((1, 2), np.int32), np.zeros((1, 2), np.float32))
