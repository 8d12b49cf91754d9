"""The served FlexNeuART funnel: staged candgen -> fusion -> neural rerank
(counterpart of ``repro/serving/funnel.py``).

The paper's system is a multi-stage funnel mixing classic and neural
ranking signals: k-NN candidate generation over mixed dense+sparse
spaces, learned fusion weights, then neural re-ranking.  This module
makes that composition ONE served endpoint with per-stage latency
budgets and per-stage observability:

* :class:`FunnelPipeline` composes a candidate generator (any backend
  tier — exact, ``graph_ann``, ``napp``, the kernel beam; a
  :class:`~repro_torch.serving.sharded.ShardedPipeline`; a live-corpus
  generator), an optional learned-weight *fusion* re-ranker, and an
  optional *neural rerank* stage: any objects with
  ``rerank(q_tokens, cands, keep)``, such as
  :class:`~repro_torch.core.pipeline.LinearReranker`,
  :class:`~repro_torch.core.pipeline.TreeReranker` and the
  cross-encoder :class:`~repro_torch.models.encoder.CrossEncoderReranker`.
  ``run`` is bit-identical to the offline
  :func:`~repro_torch.core.pipeline.apply_rerankers` composition —
  verified in ``tests/test_torch_funnel.py`` — so serving through the
  funnel never changes answers, it only adds budgets and stats.
* :class:`StageBudget` attaches *soft* per-stage deadlines.  Stages that
  already ran and overran are **counted** (never un-run); the rerank
  stage — the one expensive enough to matter — is *predictively* skipped
  when its learned cost estimate (an EWMA over past executions) no
  longer fits the stage or end-to-end budget.  Degradation is graceful
  and loud: the endpoint serves the fused candidates truncated to the
  funnel's output width, the fallback is counted per stage in
  :class:`~repro_torch.serving.stats.EndpointSnapshot`, and no request ever
  errors because a budget tripped.
* One snapshot per batch: the candidate stage resolves the live-corpus
  seam via :func:`~repro_torch.core.pipeline.pin_snapshot`, so the fusion and
  rerank stages score candidate ids from exactly the corpus state that
  produced them.

The serving integration (``RetrievalService.register_pipeline`` accepts
a funnel like any pipeline, directly or through an
:class:`~repro_torch.serving.spec.EndpointSpec`) times each stage on the
batcher worker thread and records into ``ServingStats``; the admission
queue's wait at batch close is handed to ``run`` as ``elapsed_s`` so the
total budget covers the request's whole life, not just compute.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.brute_force import TopK
from repro_torch.core.pipeline import pin_snapshot
from repro_torch.core.spaces import tensor_leaves

__all__ = ["FUNNEL_STAGES", "StageBudget", "StageTrace", "FunnelPipeline"]

# Stage names, in flow order — the keys under which EndpointSnapshot
# reports per-stage latency, fallback, overrun, and occupancy.
FUNNEL_STAGES = ("candgen", "fusion", "rerank")

# EWMA smoothing for the learned rerank-cost estimate: heavy enough that
# one scheduler hiccup can't flip the skip decision, light enough that a
# genuinely slowed-down reranker is noticed within a few batches.
_EWMA_ALPHA = 0.3


@dataclasses.dataclass(frozen=True)
class StageBudget:
    """Soft per-stage deadlines, in seconds (``None`` = unbounded).

    ``candgen_s`` / ``fusion_s`` overruns are counted (those stages must
    run — there is nothing earlier to degrade to).  ``rerank_s`` bounds
    the rerank stage: once the funnel's cost estimate exceeds it, the
    stage is skipped and the batch is served from the fused candidates
    (counted as a fallback).  ``total_s`` is the end-to-end soft
    deadline covering queue wait + all stages: the rerank stage is
    skipped when the remaining budget no longer fits its estimated
    cost."""

    candgen_s: Optional[float] = None
    fusion_s: Optional[float] = None
    rerank_s: Optional[float] = None
    total_s: Optional[float] = None

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None and not v > 0:
                raise ValueError(
                    f"StageBudget.{f.name} must be positive (or None for "
                    f"unbounded), got {v!r}")


_NO_BUDGET = StageBudget()


def _settled(result):
    """``result`` once its stage's work is done: on the card, the current
    stream (the batcher worker's) is synchronised, so that a stage clock
    read next measures the stage and not only its launches."""
    leaves = tensor_leaves(result)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.current_stream(leaves[0].device).synchronize()
    return result


@dataclasses.dataclass(frozen=True)
class StageTrace:
    """What one funnel run did, stage by stage: wall seconds per executed
    stage (``None`` = stage absent or skipped), whether the rerank stage
    fell back to fused candidates, which stages overran their soft
    deadline, and the human-readable skip reason (diagnostics — the
    counters in the endpoint snapshot are the contract)."""

    candgen_s: float
    fusion_s: Optional[float] = None
    rerank_s: Optional[float] = None
    fallback: bool = False
    overruns: Tuple[str, ...] = ()
    fallback_reason: Optional[str] = None


class FunnelPipeline:
    """candgen -> learned fusion -> neural rerank, as one served unit.

    ``generator`` is anything with ``generate(query_repr, k) -> TopK``
    (a plain candidate generator, a ``ShardedPipeline`` — its merged
    global candidates are then fused and reranked ONCE, after the merge
    — or a ``LiveGenerator``, pinned to one snapshot per run).
    ``fusion`` and ``rerank`` implement the ``Reranker`` protocol;
    ``cand_qty`` / ``fusion_qty`` / ``rerank_keep`` are the funnel
    widths (``cand_qty`` candidates -> ``fusion_qty`` fused ->
    ``rerank_keep`` served).

    Mutable on purpose (unlike ``RetrievalPipeline``): the funnel learns
    its rerank stage's cost online to make the budget decision *before*
    paying the cost.  The estimate is lock-guarded — a funnel registered
    behind several endpoints shares one estimate, which is the point:
    the stage's cost is a property of the model, not the endpoint."""

    def __init__(self, generator, *, fusion=None, rerank=None,
                 cand_qty: int = 100, fusion_qty: int = 50,
                 rerank_keep: int = 10,
                 budget: Optional[StageBudget] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        if cand_qty < fusion_qty or fusion_qty < rerank_keep:
            raise ValueError(
                f"funnel widths must narrow: cand_qty={cand_qty} >= "
                f"fusion_qty={fusion_qty} >= rerank_keep={rerank_keep}")
        self.generator = generator
        self.fusion = fusion
        self.rerank = rerank
        self.cand_qty = cand_qty
        self.fusion_qty = fusion_qty
        self.rerank_keep = rerank_keep
        self.budget = budget
        self._time_fn = time_fn
        self._lock = threading.Lock()
        self._rerank_cost_s: Optional[float] = None

    # -- seams the serving layer rebinds through ----------------------------
    @property
    def backend(self):
        return getattr(self.generator, "backend", None)

    @property
    def corpus_dtype(self):
        return getattr(self.generator, "corpus_dtype", None)

    @property
    def n_shards(self) -> int:
        return getattr(self.generator, "n_shards", 1)

    def _replace(self, **kw) -> "FunnelPipeline":
        merged = dict(generator=self.generator, fusion=self.fusion,
                      rerank=self.rerank, cand_qty=self.cand_qty,
                      fusion_qty=self.fusion_qty,
                      rerank_keep=self.rerank_keep, budget=self.budget,
                      time_fn=self._time_fn)
        merged.update(kw)
        return FunnelPipeline(**merged)

    def with_backend(self, backend) -> "FunnelPipeline":
        """Same funnel stages, different execution path under the
        candidate generator (fresh cost estimate — the stages' inputs
        change shape of work)."""
        if not hasattr(self.generator, "with_backend"):
            raise TypeError(
                f"generator {type(self.generator).__name__} does not take "
                "an execution backend")
        return self._replace(generator=self.generator.with_backend(backend))

    def with_corpus_dtype(self, dtype) -> "FunnelPipeline":
        """Same funnel stages, different corpus residency dtype under the
        candidate generator."""
        if not hasattr(self.generator, "with_corpus_dtype"):
            raise TypeError(
                f"generator {type(self.generator).__name__} does not take "
                "a corpus residency dtype")
        return self._replace(
            generator=self.generator.with_corpus_dtype(dtype))

    def with_budget(self, budget: Optional[StageBudget]) -> "FunnelPipeline":
        """Same funnel, different per-stage budgets (how an
        ``EndpointSpec`` / tuned profile binds budgets at registration)."""
        return self._replace(budget=budget)

    def with_rerank_keep(self, rerank_keep: int) -> "FunnelPipeline":
        """Same funnel, different served width (the ``rerank_keep``
        genome knob of :mod:`repro_torch.serving.autotune`)."""
        return self._replace(rerank_keep=rerank_keep)

    # -- the staged run ------------------------------------------------------
    def _should_skip_rerank(self, estimate: Optional[float], spent_s: float,
                            budget: StageBudget) -> Optional[str]:
        """The predictive degradation decision, made BEFORE paying the
        rerank cost (a stage cannot be un-run).  ``None`` = run the
        stage.  With no estimate yet (first batch) the stage runs and
        seeds the estimate — so a funnel that overruns once is counted
        once, then degrades deterministically."""
        if (budget.rerank_s is not None and estimate is not None
                and estimate > budget.rerank_s):
            return (f"estimated rerank cost {1e3 * estimate:.2f}ms exceeds "
                    f"stage budget {1e3 * budget.rerank_s:.2f}ms")
        if budget.total_s is not None:
            if spent_s >= budget.total_s:
                return (f"e2e budget {1e3 * budget.total_s:.2f}ms already "
                        f"spent ({1e3 * spent_s:.2f}ms) before rerank")
            if estimate is not None and spent_s + estimate > budget.total_s:
                return (f"remaining e2e budget "
                        f"{1e3 * (budget.total_s - spent_s):.2f}ms below "
                        f"estimated rerank cost {1e3 * estimate:.2f}ms")
        return None

    def run_timed(self, query_repr, q_tokens=None, *,
                  elapsed_s: float = 0.0) -> Tuple[TopK, StageTrace]:
        """One batch through the staged funnel; returns the result and
        the per-stage trace the serving layer records.  ``elapsed_s`` is
        time the batch already spent before compute (the admission
        queue's wait at batch close) and counts against ``total_s``.

        Each stage's stream is synchronised before its clock stops —
        otherwise the card's asynchronous launches would bill every
        stage's work to whichever stage happens to wait first."""
        budget = self.budget if self.budget is not None else _NO_BUDGET
        overruns = []
        now = self._time_fn
        t0 = now()
        cands = _settled(
            pin_snapshot(self.generator).generate(query_repr, self.cand_qty))
        candgen_s = now() - t0
        if budget.candgen_s is not None and candgen_s > budget.candgen_s:
            overruns.append("candgen")

        fusion_s = None
        if self.fusion is not None:
            t1 = now()
            cands = _settled(
                self.fusion.rerank(q_tokens, cands, self.fusion_qty))
            fusion_s = now() - t1
            if budget.fusion_s is not None and fusion_s > budget.fusion_s:
                overruns.append("fusion")

        rerank_s = None
        fallback = False
        reason = None
        if self.rerank is not None:
            with self._lock:
                estimate = self._rerank_cost_s
            reason = self._should_skip_rerank(
                estimate, elapsed_s + (now() - t0), budget)
            if reason is not None:
                fallback = True
            else:
                t2 = now()
                cands = _settled(
                    self.rerank.rerank(q_tokens, cands, self.rerank_keep))
                rerank_s = now() - t2
                with self._lock:
                    prev = self._rerank_cost_s
                    self._rerank_cost_s = (
                        rerank_s if prev is None
                        else _EWMA_ALPHA * rerank_s
                        + (1.0 - _EWMA_ALPHA) * prev)
                if (budget.rerank_s is not None
                        and rerank_s > budget.rerank_s):
                    overruns.append("rerank")
        if rerank_s is None:
            # no rerank stage, or it was skipped: serve the fused
            # candidates truncated to the funnel's output width —
            # exactly apply_rerankers' no-final tail, so the degraded
            # result is the fused ranking, never a different answer
            keep = min(self.rerank_keep, cands.scores.shape[1])
            cands = TopK(cands.scores[:, :keep], cands.indices[:, :keep])
        return cands, StageTrace(
            candgen_s=candgen_s, fusion_s=fusion_s, rerank_s=rerank_s,
            fallback=fallback, overruns=tuple(overruns),
            fallback_reason=reason)

    def run(self, query_repr, q_tokens=None, *,
            elapsed_s: float = 0.0) -> TopK:
        """The batched-runner surface (``run(query_repr, q_tokens)``):
        identical results to the offline ``apply_rerankers`` composition
        under a generous (or absent) budget."""
        out, _ = self.run_timed(query_repr, q_tokens, elapsed_s=elapsed_s)
        return out

    # -- observability / lifecycle -------------------------------------------
    @property
    def rerank_cost_estimate_s(self) -> Optional[float]:
        """The current EWMA rerank-cost estimate (None until the stage
        has run once)."""
        with self._lock:
            return self._rerank_cost_s

    def reset_cost_estimates(self):
        """Forget learned stage costs (e.g. after swapping the rerank
        model) so the next batch re-seeds them."""
        with self._lock:
            self._rerank_cost_s = None

    def close(self):
        """Release generator-owned resources (a sharded generator's
        host-parallel pool); no-op otherwise."""
        close = getattr(self.generator, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "FunnelPipeline":
        return self

    def __exit__(self, *exc):
        self.close()
