"""SQL/DataFrame layer: logical plans, analyzer, optimizer, planner, session."""

from .session import SparkSession  # noqa: F401
from .dataframe import DataFrame  # noqa: F401
from .column import Column  # noqa: F401
