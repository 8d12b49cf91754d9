"""Exact dense ip / l2 top-k through the CUDA kernel in
``csrc/topk_scan.cu`` (``mips_topk_launch``), the counterpart of
``repro/kernels/mips_topk.py: mips_topk_pallas``.

For tensors on the CPU the wrapper runs the plain version
(``ref.mips_topk_ref``); for CUDA tensors it launches the kernel or
raises.  ``launches`` counts kernel launches, nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_K = 2048
TILE = 256          # corpus rows per tile (kThreads in topk_scan.cuh)
_BLOCKS_PER_SM = 4  # scan blocks to aim for, per SM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def check_k(k: int, n: int):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}; the kernel's shared-"
                         "memory candidate list holds at most "
                         f"{MAX_K} results per query")
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} corpus rows")


def plan(b: int, n: int, k: int, n_sms: int):
    """Launch shape: (queries per block, candidate-list slots, corpus
    splits, rows per split).  The list holds k plus one tile, rounded up
    to a power of two for the bitonic sort; 16 queries share a block
    while their lists stay within 64 KB of shared memory, else 4."""
    buf = 1 << (k + TILE - 1).bit_length()
    qb = 16 if buf <= 512 else 4
    target = cdiv(_BLOCKS_PER_SM * n_sms, cdiv(b, qb))
    n_splits = max(1, min(cdiv(n, 4 * TILE), target))
    rows = cdiv(cdiv(n, n_splits), TILE) * TILE
    return qb, buf, cdiv(n, rows), rows


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda(name: str, t: torch.Tensor, dtypes, ndim: int,
                 device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{tuple(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _declare(lib):
    fn = lib.mips_topk_launch
    if fn.argtypes is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [v, v, i, i, i, i, i, i, i, v, v, i, i, i, i, v, v, v]
        fn.restype = ctypes.c_int
    return fn


def mips_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
              n_valid: int | None = None, space: str = "ip"):
    """queries [B, D], corpus [N, D] (f32 or bf16) -> (scores f32[B, K],
    ids i32[B, K]), score descending, ties toward the lower row id.  Rows
    at or past ``n_valid`` score f32-min.  Any N: no padding needed."""
    global launches
    if corpus.device.type == "cpu":
        return ref.mips_topk_ref(queries, corpus, k, n_valid=n_valid,
                                 space=space)
    if corpus.device.type != "cuda":
        raise ValueError(f"mips_topk runs on cpu or cuda, not {corpus.device}")
    if space not in ("ip", "l2"):
        raise ValueError(f"mips_topk serves ip/l2, not {space!r}")
    dev = corpus.device
    n, d = corpus.shape
    b = queries.shape[0]
    check_k(k, n)
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    q = queries.float().contiguous()      # upcast before the first multiply
    require_cuda("queries", q, (torch.float32,), 2, dev)
    require_cuda("corpus", corpus, _DTYPES, 2, dev)
    if q.shape[1] != d:
        raise ValueError(f"queries have {q.shape[1]} dims, corpus {d}")
    qb, buf, n_splits, rows = plan(b, n, k, _sms(dev))
    part_s = torch.empty((b, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, n_splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _declare(_build.load("topk_scan"))
    with torch.cuda.device(dev), _build.LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(q), ptr(corpus), _DTYPES[corpus.dtype], b, n, d,
                 n_valid, k, int(space == "l2"), ptr(part_s), ptr(part_i),
                 n_splits, rows, qb, buf, ptr(out_s), ptr(out_i),
                 ctypes.c_void_p(stream))
        _build.check(err, "mips_topk_launch")
        launches += 1
    return out_s, out_i
