"""Logging and metering for the trainer: ``Logger``, ``AverageMeter``,
``SummaryBoard``, ``TimerDict`` and ``StepTimer``.

A copy of ``sgaligner_tpu/utils/logging.py`` (the port imports nothing of
the JAX package): a file and console logger, sliding-window meters with an
adaptive registry, and a prepare / process step timer. TensorBoard scalars
are the trainer's (optional, ``torch.utils.tensorboard``); metrics always
go to the log file.
"""

from __future__ import annotations

import logging
import sys
import time
from collections import deque


class Logger:
    """Console + optional file logger (reference utils/logger.py:5-51)."""

    def __init__(self, log_file: str | None = None, name: str = "sgaligner_tpu_torch"):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(logging.DEBUG)
        for handler in self.logger.handlers:
            handler.close()
        self.logger.handlers.clear()
        self.logger.propagate = False
        fmt = logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s",
                                datefmt="%Y-%m-%d %H:%M:%S")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    def debug(self, msg): self.logger.debug(msg)
    def info(self, msg): self.logger.info(msg)
    def warning(self, msg): self.logger.warning(msg)
    def error(self, msg): self.logger.error(msg)
    def critical(self, msg): self.logger.critical(msg)


class AverageMeter:
    """Sliding-window mean (reference utils/meter.py:2-33)."""

    def __init__(self, last_n: int | None = None):
        self._records: deque | list = deque(maxlen=last_n) if last_n else []
        self.last_n = last_n

    def update(self, result):
        if isinstance(result, (list, tuple)):
            self._records.extend(result)
        else:
            self._records.append(result)

    def reset(self):
        self._records = deque(maxlen=self.last_n) if self.last_n else []

    def sum(self):
        return float(sum(self._records))

    def mean(self):
        return self.sum() / max(len(self._records), 1)


class SummaryBoard:
    """Adaptive meter registry (reference utils/summary_board.py:7-92)."""

    def __init__(self, names=None, last_n: int | None = None, adaptive: bool = True):
        self.meters: dict[str, AverageMeter] = {}
        self.last_n = last_n
        self.adaptive = adaptive
        for name in names or []:
            self.register_meter(name)

    def register_meter(self, name: str):
        self.meters[name] = AverageMeter(self.last_n)

    def update(self, name: str, value):
        if name not in self.meters:
            if not self.adaptive:
                raise KeyError(name)
            self.register_meter(name)
        self.meters[name].update(value)

    def update_from_dict(self, d: dict):
        for k, v in d.items():
            try:
                self.update(k, float(v))
            except (TypeError, ValueError):
                continue

    def reset_all(self):
        for m in self.meters.values():
            m.reset()

    def mean(self, name: str) -> float:
        return self.meters[name].mean()

    def summary(self) -> dict[str, float]:
        return {k: m.mean() for k, m in self.meters.items()}

    def format(self) -> str:
        return ", ".join(f"{k}: {v:.4f}" for k, v in self.summary().items())


class TimerDict:
    """Keyed timers (reference utils/timer.py:48-79, unused upstream)."""

    def __init__(self):
        self._starts: dict[str, float] = {}
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def tic(self, key: str):
        self._starts[key] = time.perf_counter()

    def toc(self, key: str):
        dt = time.perf_counter() - self._starts.pop(key)
        self._totals[key] = self._totals.get(key, 0.0) + dt
        self._counts[key] = self._counts.get(key, 0) + 1
        return dt

    def mean(self, key: str) -> float:
        return self._totals.get(key, 0.0) / max(self._counts.get(key, 0), 1)

    def summary(self) -> dict[str, float]:
        return {k: self.mean(k) for k in self._totals}


class StepTimer:
    """prepare (data) / process (compute) split timer (utils/timer.py:4-45)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._prepare_total = 0.0
        self._process_total = 0.0
        self._count = 0
        self._last = time.perf_counter()

    def record_prepare(self):
        now = time.perf_counter()
        self._prepare_total += now - self._last
        self._last = now

    def record_process(self):
        now = time.perf_counter()
        self._process_total += now - self._last
        self._last = now
        self._count += 1

    @property
    def prepare_mean(self):
        return self._prepare_total / max(self._count, 1)

    @property
    def process_mean(self):
        return self._process_total / max(self._count, 1)
