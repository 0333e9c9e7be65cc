"""Config, logging and metrics."""

from .config import parse_args  # noqa: F401
from .logging import log_main  # noqa: F401
from .metrics import MetricsCSV, ThroughputMeter  # noqa: F401
