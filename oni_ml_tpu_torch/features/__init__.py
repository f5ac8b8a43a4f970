"""Netflow featurization: ECDF quantile cuts, word construction, and
analyst feedback rows."""

from .feedback import read_flow_feedback_rows
from .flow import FLOW_COLUMNS, NUM_FLOW_COLUMNS, FlowFeatures, featurize_flow
from .lineio import expand_flow_paths, iter_raw_lines
from .quantiles import DECILES, QUINTILES, bin_values, ecdf_cuts

__all__ = [
    "DECILES", "FLOW_COLUMNS", "FlowFeatures", "NUM_FLOW_COLUMNS",
    "QUINTILES", "bin_values", "ecdf_cuts", "expand_flow_paths",
    "featurize_flow", "iter_raw_lines", "read_flow_feedback_rows",
]
