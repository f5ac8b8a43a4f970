"""File contracts and the in-memory corpus."""

from . import formats
from .corpus import Batch, BucketedLayout, Corpus, make_batches

__all__ = ["Batch", "BucketedLayout", "Corpus", "formats", "make_batches"]
