"""Featurization of the netflow and DNS days: ECDF quantile cuts, word
construction, and analyst feedback rows; the native (C++) featurizers of
the pre stage (native_flow, native_dns), their spill storage (blob), the
pre workers' count (shards) and the offline quantile cuts (qtiles)."""

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
from .native_dns import NativeDnsFeatures, featurize_dns_sources
from .native_flow import NativeFlowFeatures, featurize_flow_file
from .qtiles import compute_flow_qtiles, read_flow_qtiles, write_flow_qtiles
from .quantiles import DECILES, QUINTILES, bin_values, ecdf_cuts
from .shards import resolve_pre_workers

__all__ = [
    "DECILES", "DNS_COLUMNS", "DnsFeatures", "FLOW_COLUMNS", "FlowFeatures",
    "NUM_DNS_COLUMNS", "NUM_FLOW_COLUMNS", "NativeDnsFeatures",
    "NativeFlowFeatures", "QUINTILES", "bin_values", "compute_flow_qtiles",
    "ecdf_cuts", "expand_flow_paths", "extract_subdomain", "featurize_dns",
    "featurize_dns_sources", "featurize_flow", "featurize_flow_file",
    "iter_raw_lines", "load_top_domains", "read_dns_feedback_rows",
    "read_flow_feedback_rows", "read_flow_qtiles", "resolve_pre_workers",
    "shannon_entropy", "write_flow_qtiles",
]
