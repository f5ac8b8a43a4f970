"""Featurization of the netflow and DNS days: ECDF quantile cuts, word
construction, and analyst feedback rows."""

from .dns import (
    DNS_COLUMNS,
    NUM_DNS_COLUMNS,
    DnsFeatures,
    extract_subdomain,
    featurize_dns,
    load_top_domains,
    shannon_entropy,
)
from .feedback import read_dns_feedback_rows, read_flow_feedback_rows
from .flow import FLOW_COLUMNS, NUM_FLOW_COLUMNS, FlowFeatures, featurize_flow
from .lineio import expand_flow_paths, iter_raw_lines
from .quantiles import DECILES, QUINTILES, bin_values, ecdf_cuts

__all__ = [
    "DECILES", "DNS_COLUMNS", "DnsFeatures", "FLOW_COLUMNS", "FlowFeatures",
    "NUM_DNS_COLUMNS", "NUM_FLOW_COLUMNS", "QUINTILES", "bin_values",
    "ecdf_cuts", "expand_flow_paths", "extract_subdomain", "featurize_dns",
    "featurize_flow", "iter_raw_lines", "load_top_domains",
    "read_dns_feedback_rows", "read_flow_feedback_rows", "shannon_entropy",
]
