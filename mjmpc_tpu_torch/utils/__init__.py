"""Logging, timing and stacking utilities (counterpart of
mjmpc_tpu/utils/logger.py, timer.py and helpers.py)."""
from .helpers import stack_tensor_dict_list, stack_tensor_list
from .logger import LoggerClass, get_logger
from .timer import TimeIt, timeit

__all__ = ["LoggerClass", "get_logger", "TimeIt", "timeit", "stack_tensor_list",
           "stack_tensor_dict_list"]
