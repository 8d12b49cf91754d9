"""Admission queue + continuous batcher, with overload admission control
(counterpart of ``repro/serving/batcher.py``).

One :class:`ContinuousBatcher` per endpoint owns an admission queue and a
worker thread.  The worker closes a batch on whichever knob trips first:

  * **size** — ``batch_size`` requests are waiting (throughput knob);
  * **deadline** — ``max_wait_s`` elapsed since the batch opened
    (latency knob);
  * **drain** — the service is shutting down and flushes what's queued.

Partial batches are padded to the fixed ``batch_size`` with the
endpoint's pad query (one launch shape per endpoint — the padded rows are
scored and discarded), run through the endpoint's batched runner, and
the rows fan back out to per-request futures as numpy.  A runner failure
(a kernel that fails to build or launch included) fails every future in
the batch; the worker survives and keeps serving.

Devices and streams: requests may carry host tensors (or numpy arrays),
as a front end receives them.  A batch is stacked where the requests
live and moved to the pad query's device with one copy per leaf.  When
that device is a CUDA card, the worker thread runs its batches on a CUDA
stream of its own, created in that thread: the kernel wrappers launch on
the current stream, so one endpoint's host copy never waits behind
another endpoint's scan.  Each batch first waits (on the card, not the
host) for the work already queued on the default stream, where callers
built the corpus and the pad query; the copy of the results to the host
is the one point where the worker waits for its stream.

Admission control: ``max_queue`` bounds the per-endpoint queue depth.
At the limit the configured ``overload`` policy decides what gives:

  * ``"block"`` (default) — the submitting thread waits for space:
    backpressure propagates to the caller, nothing is lost;
  * ``"reject"`` — ``submit`` raises :class:`ServiceOverloaded`
    immediately: the caller sees the overload synchronously and can back
    off or hedge to another replica;
  * ``"shed_oldest"`` — the oldest *queued* request is evicted (its
    future fails with :class:`ServiceOverloaded`) and the new one is
    admitted: freshest-first under overload, bounding queue wait.

Rejected/shed totals are surfaced per endpoint through
``ServingStats.snapshot()`` alongside the live queue depth and its limit.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.spaces import tensor_leaves
from repro_torch.serving.stats import ServingStats

__all__ = ["Request", "ContinuousBatcher", "ServiceOverloaded",
           "OVERLOAD_POLICIES", "stack_requests"]

_POLL_S = 0.02   # stop-flag poll while the queue is idle

OVERLOAD_POLICIES = ("block", "reject", "shed_oldest")


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_map(fn, x):
    """``fn`` over the array leaves of a result or query: tensors, numpy
    arrays and numbers, through named tuples (``TopK``, ``SparseVectors``,
    ``FusedVectors``), tuples, lists and dicts; None parts stay None."""
    if x is None:
        return None
    if _is_record(x):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def _first_device(x) -> Optional[torch.device]:
    """Device of the first tensor leaf of a pad query (None when it is not
    made of tensors)."""
    try:
        leaves = tensor_leaves(x)
    except TypeError:
        return None
    return leaves[0].device if leaves else None


def stack_requests(rows: list):
    """Stack per-request queries (tensors or numpy arrays, or named tuples,
    tuples, lists or dicts of them) along a new leading axis, leaf by leaf,
    on the requests' device: the batch a served endpoint forms."""
    first = rows[0]
    if first is None:
        if any(r is not None for r in rows):
            raise ValueError("requests disagree on which query parts are present")
        return None
    if _is_record(first) or isinstance(first, (tuple, list)):
        parts = [stack_requests([r[i] for r in rows]) for i in range(len(first))]
        return type(first)(*parts) if _is_record(first) else type(first)(parts)
    if isinstance(first, dict):
        return {k: stack_requests([r[k] for r in rows]) for k in first}
    return torch.stack([torch.as_tensor(r) for r in rows])


def _pad_out(real, pad, n_pad: int):
    """``real`` (stacked requests) moved to the pad's device and dtype, one
    copy per leaf, with ``n_pad`` copies of ``pad`` appended."""
    if real is None:
        return None
    if _is_record(real) or isinstance(real, (tuple, list)):
        parts = [_pad_out(r, p, n_pad) for r, p in zip(real, pad)]
        return type(real)(*parts) if _is_record(real) else type(real)(parts)
    if isinstance(real, dict):
        return {k: _pad_out(real[k], pad[k], n_pad) for k in real}
    pad = torch.as_tensor(pad)
    real = real.to(device=pad.device, dtype=pad.dtype)
    if not n_pad:
        return real
    return torch.cat([real, pad.unsqueeze(0).expand(n_pad, *pad.shape)])


def _host(x) -> np.ndarray:
    """One leaf of a batch's result as numpy; a CUDA tensor's copy waits
    for the current stream, which is where the worker synchronises.
    numpy has no bf16: a sub-f32 float (a bf16 cross-encoder's scores) is
    widened to f32, which is exact."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


@contextlib.contextmanager
def _worker_stream(device: Optional[torch.device]):
    """A CUDA stream of the calling thread's own made current for the
    block (none off the card)."""
    if device is None or device.type != "cuda":
        yield None
        return
    stream = torch.cuda.Stream(device=device)
    with torch.cuda.stream(stream):
        yield stream


class ServiceOverloaded(RuntimeError):
    """An admission queue is at its depth limit: raised by ``submit`` under
    policy ``"reject"``, set on the evicted request's future under
    ``"shed_oldest"``."""


@dataclasses.dataclass
class Request:
    """One in-flight query: representation + (optional) raw tokens for the
    re-ranking stages, the future the result lands in, and timestamps."""

    query_repr: Any
    q_tokens: Optional[Any]
    endpoint: str
    future: Future
    t_admit: float
    cache_key: Optional[bytes] = None
    # live-corpus generation the cache_key was stamped with at submit
    # time (None on frozen endpoints): if the batch ends up served from
    # a newer snapshot, the service re-keys the stored result to the
    # generation that actually produced it
    generation: Optional[int] = None


class _AdmissionQueue:
    """Bounded FIFO where admission, overload policy, and close are one
    atomic decision under one lock (a plain ``queue.Queue`` can't shed its
    oldest entry or refuse puts after close without racing the worker)."""

    def __init__(self, name: str, max_depth: Optional[int] = None,
                 policy: str = "block"):
        if policy not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload policy {policy!r} not in {OVERLOAD_POLICIES}")
        if max_depth is not None and max_depth < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        self._name = name
        self._max = max_depth
        self._policy = policy
        self._items: "collections.deque[Request]" = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def qsize(self) -> int:
        return len(self._items)       # len() is atomic on deque

    def put(self, item: Request) -> Optional[Request]:
        """Admit ``item``; returns the evicted request under shed_oldest
        (else None).  Raises :class:`ServiceOverloaded` (reject at depth)
        or RuntimeError (closed — also wakes blocked putters)."""
        with self._lock:
            while True:
                if self._closed:
                    raise RuntimeError(f"batcher {self._name!r} is closed")
                if self._max is None or len(self._items) < self._max:
                    self._items.append(item)
                    self._not_empty.notify()
                    return None
                if self._policy == "reject":
                    raise ServiceOverloaded(
                        f"endpoint {self._name!r}: admission queue at depth "
                        f"limit {self._max}")
                if self._policy == "shed_oldest":
                    shed = self._items.popleft()
                    self._items.append(item)
                    self._not_empty.notify()
                    return shed
                # block: wait for the worker to make space (bounded wait so
                # a missed notify can never wedge the submitter)
                self._not_full.wait(timeout=_POLL_S)

    def get(self, timeout: float) -> Optional[Request]:
        deadline = time.monotonic() + timeout
        with self._lock:
            while not self._items:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._not_empty.wait(timeout=remaining)
            item = self._items.popleft()
            self._not_full.notify()
            return item

    def drain(self) -> List[Request]:
        with self._lock:
            items = list(self._items)
            self._items.clear()
            self._not_full.notify_all()
            return items

    def close(self):
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()


class ContinuousBatcher:
    def __init__(
        self,
        name: str,
        run_fn: Callable[[Any, Optional[Any]], Any],
        pad_query_repr: Any,
        pad_q_tokens: Optional[Any] = None,
        *,
        batch_size: int = 16,
        max_wait_s: float = 0.01,
        max_queue: Optional[int] = None,
        overload: str = "block",
        backend: Optional[str] = None,
        corpus_dtype: Optional[str] = None,
        profile: Optional[str] = None,
        stats: Optional[ServingStats] = None,
        on_result: Optional[Callable[[Request, Any], None]] = None,
        time_fn: Callable[[], float] = time.monotonic,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.name = name
        self.run_fn = run_fn
        self.pad_query_repr = pad_query_repr
        self.pad_q_tokens = pad_q_tokens
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue
        self.overload = overload
        # execution-backend identity and corpus residency dtype of the
        # endpoint's runner: surfaced in stats snapshots and folded into
        # this endpoint's cache keys (two endpoints over one corpus that
        # differ only in dtype are different precision tiers and must
        # never alias)
        self.backend = backend
        self.corpus_dtype = corpus_dtype
        # tuned-profile tag (TunedProfile.tag) when this endpoint's knobs
        # came from an autotuned profile: provenance in snapshots + keys
        self.profile = profile
        self.stats = stats if stats is not None else ServingStats()
        self.on_result = on_result
        self._time_fn = time_fn
        self._queue = _AdmissionQueue(name, max_queue, overload)
        self._device = _first_device(pad_query_repr)
        self._stream = None     # the worker's CUDA stream, set in its thread
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"batcher-{name}", daemon=True)
        self.stats.register_endpoint(name, self._queue.qsize,
                                     depth_limit=max_queue, backend=backend,
                                     corpus_dtype=corpus_dtype,
                                     profile=profile)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, request: Request):
        if self.pad_q_tokens is None and request.q_tokens is not None:
            raise ValueError(
                f"endpoint {self.name!r} was registered without "
                "pad_q_tokens, so per-request q_tokens would be silently "
                "dropped; register the endpoint with a pad_q_tokens value")
        try:
            shed = self._queue.put(request)
        except ServiceOverloaded:
            self.stats.record_overload(self.name, "rejected")
            raise
        if shed is not None:
            self.stats.record_overload(self.name, "shed")
            if shed.future.set_running_or_notify_cancel():
                shed.future.set_exception(ServiceOverloaded(
                    f"endpoint {self.name!r}: request shed from a full "
                    f"admission queue (depth limit {self.max_queue})"))

    def queue_depth(self) -> int:
        return self._queue.qsize()

    # -- worker side --------------------------------------------------------
    def _loop(self):
        with _worker_stream(self._device) as stream:
            self._stream = stream
            while not self._stop.is_set():
                batch, closed_by = self._gather()
                if batch:
                    self._safe_execute(batch, closed_by)
            # drain: everything still queued is flushed in fixed-size batches
            leftover = self._queue.drain()
            for i in range(0, len(leftover), self.batch_size):
                self._safe_execute(leftover[i:i + self.batch_size], "drain")

    def _safe_execute(self, batch: List[Request], closed_by: str):
        """The worker must survive anything a batch throws at it."""
        try:
            self._execute(batch, closed_by)
        except Exception as exc:            # noqa: BLE001
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(exc)

    def _gather(self):
        """Block for the first request, then fill until size or deadline."""
        first = self._queue.get(timeout=_POLL_S)
        if first is None:
            return [], None
        batch = [first]
        deadline = self._time_fn() + self.max_wait_s
        while len(batch) < self.batch_size:
            if self._stop.is_set():
                return batch, "drain"
            remaining = deadline - self._time_fn()
            if remaining <= 0:
                return batch, "deadline"
            nxt = self._queue.get(timeout=min(remaining, _POLL_S))
            if nxt is None:
                continue   # re-check stop flag and deadline
            batch.append(nxt)
        return batch, "size"

    def _assemble(self, batch: List[Request]):
        n_pad = self.batch_size - len(batch)
        stacked = _pad_out(stack_requests([r.query_repr for r in batch]),
                           self.pad_query_repr, n_pad)
        if self.pad_q_tokens is None:
            return stacked, None
        return stacked, _pad_out(stack_requests([r.q_tokens for r in batch]),
                                 self.pad_q_tokens, n_pad)

    def _execute(self, batch: List[Request], closed_by: str):
        t0 = self._time_fn()
        try:
            if self._stream is not None:
                # order this batch after what callers queued on the
                # default stream (the corpus, the pad query)
                self._stream.wait_stream(torch.cuda.default_stream(self._device))
            stacked, tokens = self._assemble(batch)
            if getattr(self.run_fn, "budget_aware", False):
                # budget-aware runners (the served funnel) get the time
                # this batch already spent queued — enforcement starts
                # at batch close, so an end-to-end budget covers the
                # request's whole life, not just compute
                elapsed = max(t0 - min(r.t_admit for r in batch), 0.0)
                out = self.run_fn(stacked, tokens, elapsed_s=elapsed)
            else:
                out = self.run_fn(stacked, tokens)
            out = _tree_map(_host, out)
        except Exception as exc:            # noqa: BLE001 — fan out to futures
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(exc)
            return
        t1 = self._time_fn()
        self.stats.record_batch(
            self.name, served=len(batch), capacity=self.batch_size,
            closed_by=closed_by,
            queue_waits_s=[t0 - r.t_admit for r in batch],
            exec_s=t1 - t0)
        for i, r in enumerate(batch):
            result = _tree_map(lambda x, i=i: x[i], out)
            if self.on_result is not None:
                self.on_result(r, result)
            self.stats.record_e2e(self.name, self._time_fn() - r.t_admit)
            # a client may have cancelled the future while it was queued;
            # claiming it as running makes set_result race-free
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(result)

    def close(self):
        """Stop accepting (wakes blocked submitters), flush the queue, join
        the worker.  Requests admitted before close are still served."""
        self._queue.close()
        self._stop.set()
        self._thread.join()
