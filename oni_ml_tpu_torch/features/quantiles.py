"""Empirical-CDF quantile cuts with the reference's exact semantics.

The reference computes, per quantile q, the MAXIMUM value whose empirical
CDF (P[X <= v], over the full multiset) is strictly below q, with an
accumulator initialised to 0 so cuts never go negative and a missing match
yields 0 (flow_pre_lda.scala:102-137, duplicated at
dns_pre_lda.scala:234-269).  Binning counts how many cuts the value
strictly exceeds (bin_column, flow_pre_lda.scala:139-143 /
dns_pre_lda.scala:271-275).

Word identity across the whole pipeline depends on reproducing this rule
exactly (SURVEY.md §7 hard part (b)), so this module is the only place it
is implemented.

The reference needs three full-data Spark shuffles per variable to get
these cuts (and runs them twice, pre + post).  Here it is one
sort+cumsum over a host array, vectorized over all quantiles at once.
"""

from __future__ import annotations

import numpy as np

# Decile/quintile probe points used everywhere in the reference
# (flow_pre_lda.scala:90-91, dns_pre_lda.scala:52-53).
DECILES = np.array([0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9])
QUINTILES = np.array([0.0, 0.2, 0.4, 0.6, 0.8])


def ecdf_cuts(values: np.ndarray, quantiles: np.ndarray) -> np.ndarray:
    """cuts[i] = max({v : cdf(v) < quantiles[i]} ∪ {0}).

    cdf(v) = (# samples <= v) / N over the full multiset; ties collapse to
    one (value, cdf) pair exactly as the reference's reduceByKey does.
    """
    quantiles = np.asarray(quantiles, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        return np.zeros(len(quantiles), dtype=np.float64)
    uniq, counts = np.unique(values, return_counts=True)
    cdf = np.cumsum(counts) / values.size
    cuts = np.zeros(len(quantiles), dtype=np.float64)
    for i, q in enumerate(quantiles):
        mask = cdf < q
        if mask.any():
            # uniq ascending => the last match is the max; floor at 0 like
            # the reference's zero-initialised aggregate.
            cuts[i] = max(0.0, uniq[mask][-1])
    return cuts


def bin_values(values: np.ndarray, cuts: np.ndarray) -> np.ndarray:
    """bin(v) = #{cuts c : v > c}, vectorized over values."""
    values = np.asarray(values, dtype=np.float64)
    cuts = np.asarray(cuts, dtype=np.float64)
    return (values[:, None] > cuts[None, :]).sum(axis=1).astype(np.int64)
