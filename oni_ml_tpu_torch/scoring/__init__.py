"""Scoring of the flow, DNS and proxy days: the float64 host scorer
(score.py, the default engine) and the device engine's chunked
pipeline (pipeline.py)."""

from .pipeline import (
    DispatchStats,
    chunked_scores,
    filtered_flow_scores,
    filtered_scores,
)
from .score import (
    ScoringModel,
    device_scores,
    score_dns,
    score_dns_csv,
    score_flow_csv,
)

__all__ = ["DispatchStats", "ScoringModel", "chunked_scores",
           "device_scores", "filtered_flow_scores", "filtered_scores",
           "score_dns", "score_dns_csv", "score_flow_csv"]
