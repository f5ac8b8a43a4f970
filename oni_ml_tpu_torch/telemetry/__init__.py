"""The run journal: crash-safe JSONL records of a day's stages and EM
likelihood points, and the resume contract the runner reads."""

from .journal import Journal, RunJournal

__all__ = ["Journal", "RunJournal"]
