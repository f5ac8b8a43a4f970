"""Scoring of the flow, DNS and proxy days and of serving's
micro-batches: the float64 host scorer (score.py, the default engine),
the device engine's chunked pipeline (pipeline.py) and the serving
path's measured host-or-device choice (score.batched_scores)."""

from .pipeline import (
    DispatchStats,
    chunked_scores,
    filtered_flow_scores,
    filtered_scores,
)
from .score import (
    AUTO_DEVICE_MIN,
    ScoringModel,
    batched_scores,
    device_scores,
    dispatch_calibration,
    score_dns,
    score_dns_csv,
    score_flow_csv,
    use_device_path,
)

__all__ = ["AUTO_DEVICE_MIN", "DispatchStats", "ScoringModel",
           "batched_scores", "chunked_scores", "device_scores",
           "dispatch_calibration", "filtered_flow_scores",
           "filtered_scores", "score_dns", "score_dns_csv",
           "score_flow_csv", "use_device_path"]
