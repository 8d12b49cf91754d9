"""Learning to rank the fused representation (counterpart of
``repro/core/fusion.py``): ranking metrics, coordinate ascent (with the
paper's fix of RankLib's restore bug), LambdaMART over oblivious trees,
and the composite-vector export.

  * :func:`coordinate_ascent` optimises the ranking metric directly over
    linear weights.  Every (feature, step) proposal of a round is scored
    in one batched evaluation and the incumbent moves only on a strict
    improvement, so a non-improving move can never leave the weights
    changed.
  * :func:`lambdamart` boosts symmetric (oblivious) regression trees on
    LambdaRank gradients with NDCG deltas and Newton leaf values; split
    search is one argmax over [feature x threshold] histograms.
  * :func:`export_composite` bakes weights into one fused (query, doc)
    vector pair (the paper's export scenario 2).

Metrics rank candidates in ``jnp.argsort``'s order: descending score,
-0 equal to +0, NaN last, ties toward the lower slot, on the CPU and on
CUDA alike.  Random restarts draw from an explicit ``torch.Generator``
(on its own device), so they cannot reproduce ``jax.random``'s draws;
the deterministic first start can.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import sparse as sp
from repro_torch.core.spaces import FusedVectors

__all__ = [
    "mrr",
    "ndcg_at_k",
    "topk_recall",
    "require_bf16_margin",
    "coordinate_ascent",
    "learn_fused_weights",
    "ObliviousTreeEnsemble",
    "lambdamart",
    "export_composite",
]


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def topk_recall(oracle_indices, got_indices) -> float:
    """Mean per-row overlap of two top-k id lists, as sets (order inside
    a list does not count).  Host-side: it compares results."""
    oracle = np.asarray(_host(oracle_indices))
    got = np.asarray(_host(got_indices))
    if oracle.shape != got.shape:
        raise ValueError(f"shapes differ: {oracle.shape} vs {got.shape}")
    if oracle.ndim == 1:
        oracle, got = oracle[None], got[None]
    k = oracle.shape[-1]
    hits = [len(set(o.tolist()) & set(g.tolist())) / k
            for o, g in zip(oracle.reshape(-1, k), got.reshape(-1, k))]
    return float(np.mean(hits))


def require_bf16_margin(oracle_scores_kplus1, *, pert_bound, safety: float = 2.0):
    """Validity guard for a ``recall == 1.0`` gate over generated data:
    every row's rank-k to rank-(k+1) gap of the f32 oracle's top-(k+1)
    scores (descending columns) must exceed ``safety`` times the bf16
    perturbation bound of a score (``2**-8`` times the score of the
    absolute-valued data).  ``safety=2.0`` covers two scores moving, one
    down and one up; it is not headroom.  Raises AssertionError on a thin
    margin, so the gate fails here and not by chance downstream."""
    s = np.asarray(_host(oracle_scores_kplus1), np.float64)
    assert s.ndim == 2 and s.shape[1] >= 2
    gap = s[:, -2] - s[:, -1]
    bound = np.broadcast_to(np.asarray(_host(pert_bound), np.float64), gap.shape)
    thin = gap <= safety * bound
    assert not thin.any(), (
        f"top-k margin {gap[thin].min():.3e} is within {safety}x the bf16 "
        f"perturbation bound {bound[thin].max():.3e}: regenerate the data; "
        "a bf16 recall gate over it would be a coin flip, not a check")


# ---------------------------------------------------------------------------
# Ranking metrics.  scores [..., Q, C]; labels and valid [Q, C].  Leading
# dimensions of ``scores`` are evaluated at once and kept in the result.
# ---------------------------------------------------------------------------

def _ranks(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """1-based rank of every candidate under descending-score order.

    The sort key is ``-score`` with -0 made +0 and every NaN one NaN, so
    that the stable sort ties them as ``jnp.argsort`` does on the CPU;
    PyTorch's CUDA sort would otherwise order them by their bits."""
    s = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    key = -s + 0.0
    key = torch.where(torch.isnan(key), torch.full_like(key, torch.nan), key)
    order = torch.argsort(key, dim=-1, stable=True)
    c = scores.shape[-1]
    put = torch.arange(1, c + 1, device=scores.device).expand(order.shape)
    return torch.empty_like(order).scatter_(-1, order, put)


def mrr(scores: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
        k: int = 10) -> torch.Tensor:
    """Mean reciprocal rank of the best (first) relevant candidate @k."""
    ranks = _ranks(scores, valid)
    rel = (labels > 0) & valid
    hit = rel & (ranks <= k)
    rr = torch.where(hit, 1.0 / ranks, torch.zeros((), device=scores.device)).amax(-1)
    has_rel = rel.any(-1)
    total = torch.where(has_rel, rr, torch.zeros_like(rr)).sum(-1)
    return total / torch.clamp(has_rel.sum(-1), min=1)


def ndcg_at_k(scores: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
              k: int = 10) -> torch.Tensor:
    """NDCG@k with gains ``2**label - 1``, over the queries with a gain."""
    ranks = _ranks(scores, valid)
    gain = torch.where(valid, 2.0 ** labels - 1.0, torch.zeros_like(labels))
    disc = 1.0 / torch.log2(1.0 + ranks.float())
    dcg = torch.where(ranks <= k, gain * disc, torch.zeros_like(disc)).sum(-1)
    idcg = _ideal_dcg(gain, k)
    has_rel = idcg > 0
    ratio = torch.where(has_rel, dcg / torch.clamp(idcg, min=1e-12), torch.zeros_like(dcg))
    return ratio.sum(-1) / torch.clamp(has_rel.sum(-1), min=1)


def _ideal_dcg(gain: torch.Tensor, k: int) -> torch.Tensor:
    """DCG@k of the gains sorted descending, per query."""
    ideal = -torch.sort(-gain, dim=-1).values[..., :k]
    idisc = 1.0 / torch.log2(2.0 + torch.arange(k, dtype=torch.float32, device=gain.device))
    return (ideal * idisc).sum(-1)


_METRICS = {"mrr": mrr, "ndcg": ndcg_at_k}


# ---------------------------------------------------------------------------
# Coordinate ascent (Metzler & Croft 2007), bug-fixed.
# ---------------------------------------------------------------------------

def _linear_scores(features: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Scores [P, Q, C] of the weight rows [P, F]: products, then a sum
    over the feature axis, each rounded on its own (no fused multiply-add,
    so the CPU and the card compute the same bits at F = 2)."""
    return (features[None] * weights[:, None, None, :]).sum(-1)


def coordinate_ascent(
    features: torch.Tensor,       # f32[Q, C, F]
    labels: torch.Tensor,         # f32[Q, C]
    valid: torch.Tensor,          # bool[Q, C]
    metric: str = "mrr",
    metric_k: int = 10,
    n_rounds: int = 4,
    n_restarts: int = 3,
    step_grid: Sequence[float] = (-2.0, -1.0, -0.5, -0.2, -0.05, 0.05, 0.2, 0.5, 1.0, 2.0),
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, float]:
    """Directly optimise the ranking metric over linear weights.

    Restart 0 starts uniform (RankLib's default); later restarts start
    from ``uniform(-0.5, 1)`` draws of ``generator`` (default: a CPU
    generator seeded 0), L1-normalised.  Each round scores all ``F * G``
    proposals (weight i moved by step j, L1-normalised) in one batched
    evaluation and takes the first best only if it strictly beats the
    incumbent.  Returns (weights [F], achieved metric)."""
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    dev = features.device
    f = features.shape[-1]
    metric_fn = _METRICS[metric]
    grid = torch.tensor(step_grid, dtype=torch.float32, device=dev)
    eye = torch.eye(f, dtype=torch.float32, device=dev)

    def evaluate(w_rows):
        return metric_fn(_linear_scores(features, w_rows), labels, valid, metric_k)

    def propose_all(w):
        props = w[None, None, :] + grid[None, :, None] * eye[:, None, :]
        norm = torch.clamp(props.abs().sum(-1, keepdim=True), min=1e-12)
        return (props / norm).reshape(f * grid.shape[0], f)

    best_w, best_m = None, -float("inf")
    for r in range(n_restarts):
        if r == 0:
            w = torch.full((f,), 1.0 / f, dtype=torch.float32, device=dev)
        else:
            w = torch.rand(f, generator=generator, device=generator.device).to(dev) * 1.5 - 0.5
            w = w / torch.clamp(w.abs().sum(), min=1e-12)
        cur = evaluate(w[None])[0]
        for _ in range(n_rounds):
            props = propose_all(w)
            vals = evaluate(props)
            j = torch.argmax(vals)
            w = torch.where(vals[j] > cur, props[j], w)
            cur = torch.maximum(vals[j], cur)
        if float(cur) > best_m:
            best_w, best_m = w, float(cur)
    return best_w, best_m


def learn_fused_weights(
    dense_scores: torch.Tensor,   # f32[Q, C] dense-component candidate scores
    sparse_scores: torch.Tensor,  # f32[Q, C] sparse-component candidate scores
    labels: torch.Tensor,         # f32[Q, C]
    valid: torch.Tensor,          # bool[Q, C]
    metric: str = "mrr",
    **kwargs,
) -> Tuple[float, float, float]:
    """``FusedSpace`` mixing weights learned from training data (the
    paper's scenario 1 with LETOR): the two component scores are the two
    features of a coordinate-ascent run on the ranking metric.  The
    L1-normalised weights drop into ``FusedSpace.with_weights`` and reach
    the fused kernels' launches unchanged.  Returns ``(w_dense, w_sparse,
    achieved_metric)``."""
    feats = torch.stack([dense_scores, sparse_scores], dim=-1)
    w, achieved = coordinate_ascent(feats, labels, valid, metric=metric, **kwargs)
    return float(w[0]), float(w[1]), achieved


# ---------------------------------------------------------------------------
# LambdaMART with oblivious trees.
# ---------------------------------------------------------------------------

class ObliviousTreeEnsemble(NamedTuple):
    """Depth-D symmetric trees: per tree one (feature, threshold) per
    level and 2^D leaf values; thresholds in raw feature space."""

    feat: torch.Tensor     # i32[M, D]
    thresh: torch.Tensor   # f32[M, D]
    leaves: torch.Tensor   # f32[M, 2^D]
    lr: float

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """x f32[..., F] -> f32[...]: the trees' leaves summed in tree
        order, times ``lr``."""
        m, d = self.feat.shape
        feat = self.feat.long()
        out = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
        for t in range(m):
            code = torch.zeros(x.shape[:-1], dtype=torch.long, device=x.device)
            for lvl in range(d):
                col = torch.index_select(x, -1, feat[t, lvl:lvl + 1]).squeeze(-1)
                code = code * 2 + (col > self.thresh[t, lvl]).long()
            out = out + self.leaves[t][code]
        return self.lr * out


def _lambda_grads(scores, labels, valid, k=10, sigma=1.0):
    """LambdaRank gradients and second-order weights, per query."""
    ranks = _ranks(scores, valid)
    zero = torch.zeros_like(scores)
    gain = torch.where(valid, 2.0 ** labels - 1.0, zero)
    disc = torch.where(valid, 1.0 / torch.log2(1.0 + ranks.float()), zero)
    idcg = torch.clamp(_ideal_dcg(gain, k), min=1e-12)

    s_diff = scores[:, :, None] - scores[:, None, :]
    lbl_gt = (labels[:, :, None] > labels[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    rho = torch.sigmoid(-sigma * s_diff)
    delta = ((gain[:, :, None] - gain[:, None, :]).abs()
             * (disc[:, :, None] - disc[:, None, :]).abs()
             / idcg[:, None, None])
    zeros = torch.zeros_like(rho)
    lam_pair = torch.where(lbl_gt, -sigma * rho * delta, zeros)
    w_pair = torch.where(lbl_gt, sigma * sigma * rho * (1 - rho) * delta, zeros)
    lam = lam_pair.sum(2) - lam_pair.sum(1)
    w = w_pair.sum(2) + w_pair.sum(1)
    return lam, w


def _fit_oblivious_tree(binned, bin_edges, lam, w, valid, depth, n_bins, reg=1.0):
    """One symmetric tree on pre-binned features (binned i32[S, F];
    lam, w f32[S]; valid bool[S]).  Per level: histograms of (sum lambda,
    sum w) over [node x feature x bin], then the (feature, bin) that
    maximises sum over leaves of lambda^2 / (w + reg), one argmax over a
    dense tensor.  Returns (features, raw thresholds, leaves, node of
    each sample)."""
    s_count, f = binned.shape
    dev = binned.device
    zero = torch.zeros_like(lam)
    lam = torch.where(valid, lam, zero)
    w = torch.where(valid, w, zero)
    node = torch.zeros(s_count, dtype=torch.long, device=dev)
    lam_rep = lam.repeat_interleave(f)
    w_rep = w.repeat_interleave(f)
    feats, thrs = [], []
    for lvl in range(depth):
        n_nodes = 2 ** lvl
        idx = ((node[:, None] * f + torch.arange(f, device=dev)[None, :]) * n_bins
               + binned.long()).reshape(-1)
        size = n_nodes * f * n_bins
        hl = torch.zeros(size, dtype=torch.float32, device=dev).index_add_(0, idx, lam_rep)
        hw = torch.zeros(size, dtype=torch.float32, device=dev).index_add_(0, idx, w_rep)
        cl = torch.cumsum(hl.reshape(n_nodes, f, n_bins), dim=-1)   # left sums at threshold b
        cw = torch.cumsum(hw.reshape(n_nodes, f, n_bins), dim=-1)
        rl, rw = cl[..., -1:] - cl, cw[..., -1:] - cw
        gain = (cl ** 2 / (cw + reg) + rl ** 2 / (rw + reg)).sum(0)  # symmetric: one split for all nodes
        flat = int(torch.argmax(gain[:, :-1]))                      # last bin: empty right child
        fbest, bbest = flat // (n_bins - 1), flat % (n_bins - 1)
        feats.append(fbest)
        thrs.append(bbest)
        node = node * 2 + (binned[:, fbest] > bbest).long()
    n_leaves = 2 ** depth
    sl = torch.zeros(n_leaves, dtype=torch.float32, device=dev).index_add_(0, node, lam)
    sw = torch.zeros(n_leaves, dtype=torch.float32, device=dev).index_add_(0, node, w)
    leaves = -sl / (sw + reg)
    fidx = torch.tensor(feats, dtype=torch.long, device=dev)
    thr_raw = bin_edges[fidx, torch.tensor(thrs, dtype=torch.long, device=dev)]
    return fidx.to(torch.int32), thr_raw, leaves, node


def lambdamart(
    features: torch.Tensor,   # f32[Q, C, F]
    labels: torch.Tensor,
    valid: torch.Tensor,
    n_trees: int = 50,
    depth: int = 3,
    lr: float = 0.1,
    n_bins: int = 32,
    metric_k: int = 10,
    reg: float = 1.0,
) -> ObliviousTreeEnsemble:
    """Boost ``n_trees`` oblivious trees on LambdaRank gradients.  Bin
    edges are the valid samples' quantiles per feature, taken on the
    host (data preparation)."""
    q, c, f = features.shape
    dev = features.device
    flatx = features.reshape(q * c, f)
    flat_valid = valid.reshape(q * c)
    xs = flatx.detach().cpu().numpy()
    vmask = flat_valid.detach().cpu().numpy()
    edges = np.zeros((f, n_bins - 1), np.float32)
    for j in range(f):
        col = xs[vmask, j]
        if col.size:
            edges[j] = np.quantile(col, np.linspace(0, 1, n_bins + 1)[1:-1])
    bin_edges = torch.from_numpy(edges).to(dev)
    binned = (flatx[:, :, None] > bin_edges[None, :, :]).sum(-1).to(torch.int32)

    scores = torch.zeros((q, c), dtype=torch.float32, device=dev)
    all_f, all_t, all_l = [], [], []
    for _ in range(n_trees):
        lam, w = _lambda_grads(scores, labels, valid, metric_k)
        fidx, thr, leaves, node = _fit_oblivious_tree(
            binned, bin_edges, lam.reshape(-1), w.reshape(-1), flat_valid, depth, n_bins, reg)
        all_f.append(fidx)
        all_t.append(thr)
        all_l.append(leaves)
        scores = scores + lr * leaves[node].reshape(q, c)
    return ObliviousTreeEnsemble(torch.stack(all_f), torch.stack(all_t), torch.stack(all_l), lr)


# ---------------------------------------------------------------------------
# Composite-vector export (paper section 3.2, scenario 2).
# ---------------------------------------------------------------------------

def export_composite(
    components: Sequence[tuple],       # (kind, weight, q_repr, d_repr)
    vocab_sizes: Sequence[int] | None = None,
) -> Tuple[FusedVectors, FusedVectors, int]:
    """Concatenate per-extractor vectors into one fused (query, doc) pair.

    Dense parts are weight-scaled on the query side and concatenated on
    the feature axis; sparse parts are weight-scaled with their term ids
    offset into a combined vocabulary (``vocab_sizes``, one per sparse
    part, in order), so their inner products add independently.  Padding
    (value 0) is re-marked with the combined trash id.  The weights are
    baked in after export.  Returns (fused queries, fused docs, combined
    vocabulary size)."""
    dense_q, dense_d = [], []
    sp_qi, sp_qv, sp_di, sp_dv = [], [], [], []
    offset = 0
    vs_iter = iter(vocab_sizes or [])
    for kind, weight, qr, dr in components:
        if kind == "dense":
            dense_q.append(weight * qr)      # one side only: <w q, d> = w <q, d>
            dense_d.append(dr)
        elif kind == "sparse":
            vs = next(vs_iter)
            qpad = qr.indices >= vs
            dpad = dr.indices >= vs
            sp_qi.append(torch.where(qpad, 0, qr.indices) + offset)
            sp_qv.append(torch.where(qpad, torch.zeros_like(qr.values), weight * qr.values))
            sp_di.append(torch.where(dpad, 0, dr.indices) + offset)
            sp_dv.append(torch.where(dpad, torch.zeros_like(dr.values), dr.values))
            offset += vs
        else:
            raise ValueError(kind)

    def pack(idxs, vals):
        if not idxs:
            return None
        i = torch.cat(idxs, dim=-1)
        v = torch.cat(vals, dim=-1)
        i = torch.where(v == 0.0, offset, i)
        return sp.SparseVectors(i.to(torch.int32), v)

    fq = FusedVectors(torch.cat(dense_q, dim=-1) if dense_q else None, pack(sp_qi, sp_qv))
    fd = FusedVectors(torch.cat(dense_d, dim=-1) if dense_d else None, pack(sp_di, sp_dv))
    return fq, fd, offset
