"""Metrics: streaming log-loss and AUC (the counterpart of
ftrl_ffm_tpu/metrics.py).

The per-batch parts that run on the device (`kahan_add`,
`StreamingAUC.bucket_counts`) are torch; the host-side closes
(`LossAccumulator`, `StreamingAUC.result`, `exact_auc`) are numpy copies of
the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

# Shared histogram width for streaming AUC; error is O(1/AUC_BINS).  Must
# equal ftrl_ffm_tpu/metrics.py::AUC_BINS for the two packages to agree.
AUC_BINS = 8192


def kahan_add(sums, comps, parts):
    """One compensated-summation (Kahan) step over tuples of accumulators,
    elementwise (ftrl_ffm_tpu/metrics.py::kahan_add): keeps a whole-pass
    f32 chain of per-batch sums at O(1) ulps, the reference's double
    accounting (src/task/ftrl_online.cpp:82-94)."""
    new_sums, new_comps = [], []
    for s, c, x in zip(sums, comps, parts):
        y = x - c
        t = s + y
        new_comps.append((t - s) - y)
        new_sums.append(t)
    return tuple(new_sums), tuple(new_comps)


class LossAccumulator:
    """Host-side double-precision mean of per-batch loss sums
    (reference: src/task/ftrl_online.cpp:82-94)."""

    def __init__(self):
        self.loss_sum = 0.0
        self.count = 0.0

    def update(self, loss_sum, count):
        self.loss_sum += float(loss_sum)
        self.count += float(count)

    @property
    def mean(self) -> float:
        return self.loss_sum / self.count if self.count else float("nan")


class StreamingAUC:
    """Histogram-bucketed AUC over sigmoid scores in [0, 1]: counts per
    bucket accumulate on the device, the trapezoidal rank formula closes
    them on the host; error is O(1/n_bins)."""

    def __init__(self, n_bins: int = AUC_BINS):
        self.n_bins = n_bins
        self.pos = np.zeros(n_bins, np.float64)
        self.neg = np.zeros(n_bins, np.float64)

    @staticmethod
    def bucket_counts(
        logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor, n_bins: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-batch (pos, neg) histograms of sigmoid scores, f32 [n_bins].

        index_add_ adds with atomics on the card, in no fixed order.  The
        sums are still exact and reproducible: every addend is y*w or
        (1-y)*w with y, w in {0, 1}, so each bucket holds a whole number
        below 2^24, which f32 represents exactly in any order."""
        y = y.to(torch.float32)
        w = w.to(torch.float32)
        scores = torch.sigmoid(logits)
        idx = torch.clamp((scores * n_bins).to(torch.int32), 0, n_bins - 1)
        pos = torch.zeros(n_bins, dtype=torch.float32, device=logits.device)
        neg = torch.zeros(n_bins, dtype=torch.float32, device=logits.device)
        pos.index_add_(0, idx, y * w)
        neg.index_add_(0, idx, (1.0 - y) * w)
        return pos, neg

    def update(self, pos, neg):
        self.pos += np.asarray(pos, np.float64)
        self.neg += np.asarray(neg, np.float64)

    def result(self) -> float:
        total_pos = self.pos.sum()
        total_neg = self.neg.sum()
        if total_pos == 0 or total_neg == 0:
            return float("nan")
        # ranks: negatives below each bucket + half of ties within the bucket
        cum_neg = np.cumsum(self.neg) - self.neg
        auc_sum = np.sum(self.pos * (cum_neg + 0.5 * self.neg))
        return float(auc_sum / (total_pos * total_neg))


def exact_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Exact AUC via rank statistic, ties at the midrank (matches sklearn's
    roc_auc_score); all scores must fit host memory."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    n = len(scores)
    # vectorized midranks: for tie group g spanning sorted positions
    # [start_g, end_g), midrank = (start_g + end_g + 1)/2
    uniq, inv, counts = np.unique(scores, return_inverse=True,
                                  return_counts=True)
    ends = np.cumsum(counts)              # 1-based end rank per group
    starts = ends - counts                # 0-based start rank per group
    mid = (starts + ends + 1) / 2.0       # midrank per group
    ranks = mid[inv]                      # per-sample, original order
    l = labels
    n_pos = float(l.sum())
    n_neg = float(n - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[l > 0].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
