"""Console/file logging plus tabular CSV metrics.

Counterpart of mjmpc_tpu/utils/logger.py (reference mjmpc/utils/logger.py):
a python-logging console and file logger combined with record_tabular /
dump_tabular metric accumulation. Columns are NaN-padded to stay aligned
and the CSV is reloaded on setup, so runs can be appended to. Plain csv
module; on disk an index column and one column per key.
"""
from __future__ import annotations

import csv
import logging
import math
import os
from typing import Dict, List, Optional


class LoggerClass:
    GLOBAL_LOGGER_NAME = "mjmpc_tpu_torch"

    def __init__(self):
        self._logger: Optional[logging.Logger] = None
        self._csv_path: Optional[str] = None
        self._tabular: Dict[str, List] = {}
        self._curr_recorded: List[str] = []
        self._num_dump_tabular_calls = 0

    # ---- setup -----------------------------------------------------------
    def setup(self, display_name: str, log_path: str, lvl: str = "info"):
        os.makedirs(os.path.dirname(log_path), exist_ok=True)

        logger = logging.getLogger(f"{self.GLOBAL_LOGGER_NAME}.{display_name}")
        logger.setLevel(getattr(logging, lvl.upper(), logging.INFO))
        logger.handlers.clear()
        fmt = logging.Formatter("%(asctime)s %(name)s [%(levelname)s] %(message)s")
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(sh)
        self._logger = logger

        self._csv_path = os.path.splitext(log_path)[0] + ".csv"
        if os.path.exists(self._csv_path):   # resume an earlier run's table
            with open(self._csv_path) as f:
                rows = list(csv.reader(f))
            if rows:
                header = rows[0][1:]  # drop the index column
                cols = list(zip(*[r[1:] for r in rows[1:]])) or [() for _ in header]

                def parse(x):
                    if x in ("", "nan"):
                        return math.nan
                    try:
                        return float(x)
                    except ValueError:
                        return x  # a non-numeric cell (e.g. a list dump)

                self._tabular = {k: [parse(x) for x in v] for k, v in zip(header, cols)}
                if self._tabular:
                    self._num_dump_tabular_calls = len(next(iter(self._tabular.values())))

    # ---- plain logging ---------------------------------------------------
    def info(self, msg, *a):
        if self._logger:
            self._logger.info(msg, *a)

    def debug(self, msg, *a):
        if self._logger:
            self._logger.debug(msg, *a)

    def warning(self, msg, *a):
        if self._logger:
            self._logger.warning(msg, *a)

    # ---- tabular metrics -------------------------------------------------
    def record_tabular(self, key, val):
        key = str(key)
        if key in self._curr_recorded:  # not assert: survives python -O
            raise ValueError(f"duplicate tabular key {key!r} this iteration")
        self._curr_recorded.append(key)
        if key in self._tabular:
            self._tabular[key].append(val)
        else:
            self._tabular[key] = [math.nan] * self._num_dump_tabular_calls + [val]

    def dump_tabular(self):
        if not self._curr_recorded:
            return
        self._curr_recorded = []
        self._num_dump_tabular_calls += 1
        for k, v in self._tabular.items():
            if len(v) == self._num_dump_tabular_calls - 1:
                v.append(math.nan)  # keep the columns aligned
            elif len(v) != self._num_dump_tabular_calls:
                raise ValueError(f"key {k} has {len(v)} items after "
                                 f"{self._num_dump_tabular_calls} dumps")
        with open(self._csv_path, "w", newline="") as f:
            w = csv.writer(f)
            keys = list(self._tabular)
            w.writerow([""] + keys)
            for i in range(self._num_dump_tabular_calls):
                w.writerow([i] + [self._tabular[k][i] for k in keys])


def get_logger(display_name: str, log_dir: str, lvl: str = "info") -> LoggerClass:
    """A logger writing <log_dir>/<display_name>.log and .csv."""
    lg = LoggerClass()
    lg.setup(display_name, os.path.join(log_dir, display_name + ".log"), lvl)
    return lg
