"""Float64 host scoring of the flow and DNS days."""

from .score import (
    ScoringModel,
    dns_event_indices,
    flow_event_indices,
    score_dns,
    score_dns_csv,
    score_flow_csv,
)

__all__ = ["ScoringModel", "dns_event_indices", "flow_event_indices",
           "score_dns", "score_dns_csv", "score_flow_csv"]
