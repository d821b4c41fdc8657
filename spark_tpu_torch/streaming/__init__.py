"""Structured streaming (micro-batch, WAL, versioned state)."""

from .api import DataStreamReader, DataStreamWriter, StreamingQueryManager
from .core import MemoryStream, StreamingQuery, StreamingRelation

__all__ = [
    "DataStreamReader", "DataStreamWriter", "StreamingQueryManager",
    "MemoryStream", "StreamingQuery", "StreamingRelation",
]
