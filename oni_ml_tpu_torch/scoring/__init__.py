"""Float64 host scoring of the flow day."""

from .score import ScoringModel, flow_event_indices, score_flow_csv

__all__ = ["ScoringModel", "flow_event_indices", "score_flow_csv"]
