"""File contracts and the in-memory corpus."""

from . import formats
from .corpus import Batch, BucketedLayout, Corpus

__all__ = ["Batch", "BucketedLayout", "Corpus", "formats"]
