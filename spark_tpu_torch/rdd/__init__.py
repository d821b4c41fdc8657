"""RDD core API (`core/rdd/` analog): SparkContext, RDD, shared variables."""

from .context import Accumulator, AccumulatorParam, Broadcast, SparkContext
from .rdd import HashPartitioner, Partitioner, RDD, StatCounter

__all__ = [
    "SparkContext", "RDD", "Broadcast", "Accumulator", "AccumulatorParam",
    "Partitioner", "HashPartitioner", "StatCounter",
]
