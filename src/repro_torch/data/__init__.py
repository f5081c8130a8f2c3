"""Input pipeline (decoupled host stage with bounded prefetch FIFO)."""

from .pipeline import DataConfig, file_stream, prefetched, synthetic_stream

__all__ = ["DataConfig", "file_stream", "prefetched", "synthetic_stream"]
