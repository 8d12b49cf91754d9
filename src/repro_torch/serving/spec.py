"""EndpointSpec — the consolidated, validated endpoint registration API
(counterpart of ``repro/serving/spec.py``).

Every registration knob (batching, admission control, execution backend,
residency dtype, tuned profile, live corpus, the funnel's serve width and
per-stage budgets) as ONE frozen, typed value:

* **Validated at construction.**  ``__post_init__`` reuses the legality
  oracle (:func:`repro_torch.serving.autotune.check_config` over a probe
  :class:`~repro_torch.serving.autotune.ServingConfig`), so the
  batching/admission/funnel rules live in one place — an illegal spec
  raises ``ValueError`` before any endpoint state exists.
* **One value to pass around.**  ``RetrievalService.register_runner`` /
  ``register_pipeline`` accept ``spec=EndpointSpec(...)``; the keyword
  surface still works as a thin shim that builds a spec via
  :meth:`EndpointSpec.from_kwargs` (same mutual-exclusion rules, same
  error messages).
* **Profiles expand to specs.**  :meth:`~repro_torch.serving.autotune.
  TunedProfile.to_spec` turns a tuned row into an ``EndpointSpec``;
  ``dataclasses.replace`` on the result overrides single knobs (each
  replace re-validates).

``jit=True`` has no counterpart: ``repro`` wraps the runner in
``jax.jit``, and the port runs eagerly through its hand-written kernels,
so the flag is refused with a ``ValueError`` rather than ignored (and
the runner is not handed to ``torch.compile`` in its place).

``backend`` may be a :mod:`repro_torch.core.backends` name, identity
string, or ExecutionBackend instance — backend *capability* legality is
owned by the pipeline rebind at registration (``with_backend``), not
here, so an opaque runner can still declare any label.  ``corpus_dtype``
is checked against the precision contract when it is a plain dtype name;
aggregated labels (``"mixed(bfloat16,float32)"`` from heterogeneous
shard pools) pass through as declarations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.spaces import canonical_dtype
from repro_torch.serving.autotune import ServingConfig, TunedProfile, check_config
from repro_torch.serving.funnel import StageBudget

__all__ = ["EndpointSpec"]


@dataclasses.dataclass(frozen=True)
class EndpointSpec:
    """Everything one endpoint registration says, as one frozen value.

    ``batch_size`` / ``max_wait_s`` — continuous-batching close knobs;
    ``jit`` — kept so that ``repro``'s registrations read the same;
    ``True`` is refused (the port has no jit of a runner);
    ``max_queue`` / ``overload`` — admission control;
    ``backend`` / ``corpus_dtype`` — execution path and residency dtype
    (rebound through the pipeline's seams, or label-only for runners);
    ``profile`` — the :class:`~repro_torch.serving.autotune.TunedProfile` this
    spec was expanded from (provenance: its tag lands in snapshots and
    cache keys);
    ``live`` — a :class:`~repro_torch.serving.live.LiveCorpus` to serve
    (mutually exclusive with backend/corpus_dtype/profile);
    ``budget`` / ``rerank_keep`` — the funnel knobs: per-stage soft
    deadlines (:class:`~repro_torch.serving.funnel.StageBudget`) and the
    served width of the rerank stage, applied to
    :class:`~repro_torch.serving.funnel.FunnelPipeline` endpoints via
    ``with_budget`` / ``with_rerank_keep`` at registration."""

    batch_size: int = 16
    max_wait_s: float = 0.01
    jit: bool = False
    max_queue: Optional[int] = None
    overload: str = "block"
    backend: Optional[Any] = None
    corpus_dtype: Optional[str] = None
    profile: Optional[TunedProfile] = None
    live: Optional[Any] = None
    budget: Optional[StageBudget] = None
    rerank_keep: Optional[int] = None

    def __post_init__(self):
        if self.jit:
            raise ValueError(
                "jit=True has no counterpart in the port: repro wraps the "
                "runner in jax.jit, the port runs it eagerly through its "
                "CUDA kernels (wrapping it in torch.compile instead would "
                "serve another path than the one registered)")
        if self.live is not None:
            if (self.backend is not None or self.corpus_dtype is not None
                    or self.profile is not None):
                raise ValueError(
                    "live= is mutually exclusive with backend=, "
                    "corpus_dtype=, and profile=: a LiveCorpus declares "
                    "its own backends and residency dtype")
        if self.budget is not None and not isinstance(self.budget,
                                                      StageBudget):
            raise TypeError(
                f"budget must be a StageBudget, got "
                f"{type(self.budget).__name__}")
        # one legality oracle: probe the autotuner's check_config with a
        # genome carrying this spec's batching/admission/funnel knobs.
        # The backend gene is a placeholder — backend capability is owned
        # by the pipeline rebind at registration; dtype is probed only
        # when it is a plain name (aggregated "mixed(...)" labels are
        # declarations, not rebind requests).
        dtype = "float32"
        cd = self.corpus_dtype
        if cd is not None and not (isinstance(cd, str) and "(" in cd):
            try:
                dtype = canonical_dtype(cd)     # resolves "bf16" etc.
            except (TypeError, ValueError):
                dtype = cd if isinstance(cd, str) else "float32"
        probe = ServingConfig(
            backend="reference", corpus_dtype=dtype,
            batch_size=self.batch_size, max_wait_s=self.max_wait_s,
            max_queue=self.max_queue, overload=self.overload,
            rerank_keep=self.rerank_keep,
            rerank_budget_ms=(
                None if self.budget is None or self.budget.rerank_s is None
                else 1e3 * self.budget.rerank_s))
        why = check_config(probe, k=1)
        if why is not None:
            raise ValueError(f"illegal endpoint spec: {why}")

    @classmethod
    def from_kwargs(cls, *, batch_size: int = 16, max_wait_s: float = 0.01,
                    jit: bool = False, max_queue: Optional[int] = None,
                    overload: str = "block", backend: Optional[Any] = None,
                    corpus_dtype: Optional[str] = None,
                    profile: Optional[TunedProfile] = None,
                    live: Optional[Any] = None,
                    budget: Optional[StageBudget] = None,
                    rerank_keep: Optional[int] = None) -> "EndpointSpec":
        """The legacy keyword surface, as a spec constructor — the shim
        ``register_runner`` / ``register_pipeline`` route their loose
        kwargs through.  A ``profile`` expands via
        :meth:`~repro_torch.serving.autotune.TunedProfile.to_spec` (explicit
        ``backend`` / ``corpus_dtype`` alongside it are rejected — a
        profile IS those choices); explicit ``budget`` / ``rerank_keep``
        override the profile's funnel genes."""
        if live is not None:
            # exclusivity is re-checked in __post_init__; constructing
            # directly keeps the error messages identical either way
            return cls(batch_size=batch_size, max_wait_s=max_wait_s,
                       jit=jit, max_queue=max_queue, overload=overload,
                       backend=backend, corpus_dtype=corpus_dtype,
                       profile=profile, live=live, budget=budget,
                       rerank_keep=rerank_keep)
        if profile is not None:
            if backend is not None or corpus_dtype is not None:
                raise ValueError(
                    "profile= supplies backend and corpus_dtype; passing "
                    "them explicitly alongside a profile would serve a "
                    "config the profile never measured")
            overrides: dict = {"jit": jit}
            if budget is not None:
                overrides["budget"] = budget
            if rerank_keep is not None:
                overrides["rerank_keep"] = rerank_keep
            return dataclasses.replace(profile.to_spec(), **overrides)
        return cls(batch_size=batch_size, max_wait_s=max_wait_s, jit=jit,
                   max_queue=max_queue, overload=overload, backend=backend,
                   corpus_dtype=corpus_dtype, budget=budget,
                   rerank_keep=rerank_keep)
