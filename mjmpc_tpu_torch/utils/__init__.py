"""Logging and timing utilities (counterpart of mjmpc_tpu/utils/logger.py
and timer.py)."""
from .logger import LoggerClass, get_logger
from .timer import TimeIt, timeit

__all__ = ["LoggerClass", "get_logger", "TimeIt", "timeit"]
