"""Streaming dataplane (port of oni_ml_tpu/dataplane/): columnar
inter-stage hand-offs, bounded-buffer overlap, files demoted to
background checkpoints, and the continuous service's ring-buffered
corpus window (`window.py`).

The serial day is a batch chain glued by on-disk contracts
(word_counts.dat -> LDA-C corpus -> model artifacts -> scoring input);
this package is the in-memory replacement `run_pipeline` threads
through the pre -> corpus -> EM -> score chain: typed column sets hand
data between stages, bounded channels overlap producers with consumers
(stalls priced as `dataplane.*` spans and `{"kind": "dataplane"}`
journal records), checkpoint sinks write the file contract in the
background, and scoring prep runs on a host thread while EM runs on
the card.  Every artifact is byte-identical to the serial path
(`--no-dataplane`).
"""

from ..io.formats import atomic_write, atomic_write_bytes
from .channel import Channel, ChannelClosed, ChannelError
from .columns import (
    Column,
    ColumnSet,
    WordCountColumns,
    intern_word_counts,
    make_word_count_columns,
    word_count_columns,
)
from .corpus_builder import (
    StreamingCorpusBuilder,
    consume_corpus,
    stream_word_counts,
)
from .plane import Dataplane
from .scoreprep import ScoringPrep, build_scoring_prep
from .sinks import CheckpointSinks, Task
from .window import CorpusWindow, WindowSnapshot, pow2_capacity

__all__ = [
    "Channel", "ChannelClosed", "ChannelError",
    "Column", "ColumnSet", "WordCountColumns",
    "intern_word_counts", "make_word_count_columns", "word_count_columns",
    "StreamingCorpusBuilder", "consume_corpus", "stream_word_counts",
    "Dataplane", "ScoringPrep", "build_scoring_prep",
    "CheckpointSinks", "Task",
    "CorpusWindow", "WindowSnapshot", "pow2_capacity",
    "atomic_write", "atomic_write_bytes",
]
