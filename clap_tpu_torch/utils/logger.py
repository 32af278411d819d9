"""Leveled logger with pluggable ring-buffer sinks (counterpart of
clap_tpu/utils/logger.py; reference: core/logger.{c,h} — levels
FTRACE..ERR logger.h:19-26, stdio + ring sinks rb_sink_add logger.h:39,
abort_on_error wired from the -E CLI, clap.c:909-915).

Host-rim subsystem: the jitted step never logs (nothing data-dependent
escapes jit); the Engine, loaders, telemetry and tools do. The
networking layer registers a forwarding sink exactly like the
reference streams its ring buffer to the log server (networking.c:98).
"""
from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

# logger.h:19-26
FTRACE, VDBG, DBG, NORMAL, WARN, ERR = range(6)
_NAMES = ["FTRACE", "VDBG", "DBG", "MSG", "WARN", "ERR"]


@dataclass
class LogEntry:
    level: int
    msg: str
    ts: float
    mod: str = ""


class RingSink:
    """Fixed-capacity ring buffer of log entries (rb_sink, logger.h:39:
    the networking layer drains this toward the server)."""

    def __init__(self, capacity: int = 256, level: int = NORMAL):
        self.level = level
        self.buf: deque[LogEntry] = deque(maxlen=capacity)

    def __call__(self, e: LogEntry):
        if e.level >= self.level:
            self.buf.append(e)

    def drain(self) -> list[LogEntry]:
        out = list(self.buf)
        self.buf.clear()
        return out


class Logger:
    def __init__(self, level: int = NORMAL, abort_on_error: bool = False,
                 stdio: bool = True):
        self.level = level
        self.abort_on_error = abort_on_error
        self.sinks: list[Callable[[LogEntry], None]] = []
        if stdio:
            self.sinks.append(self._stdio)

    def _stdio(self, e: LogEntry):
        stream = sys.stderr if e.level >= WARN else sys.stdout
        mod = f" {e.mod}:" if e.mod else ""
        print(f"[{_NAMES[e.level]}]{mod} {e.msg}", file=stream)

    def add_sink(self, sink: Callable[[LogEntry], None]):
        self.sinks.append(sink)
        return sink

    def log(self, level: int, msg: str, mod: str = ""):
        if level < self.level:
            return
        e = LogEntry(level=level, msg=msg, ts=time.time(), mod=mod)
        for s in self.sinks:
            s(e)
        if level >= ERR and self.abort_on_error:
            raise RuntimeError(f"abort_on_error: {msg}")

    # the dbg/msg/warn/err convenience macros (logger.h:50-60)
    def ftrace(self, m, mod=""):
        self.log(FTRACE, m, mod)

    def dbg(self, m, mod=""):
        self.log(DBG, m, mod)

    def msg(self, m, mod=""):
        self.log(NORMAL, m, mod)

    def warn(self, m, mod=""):
        self.log(WARN, m, mod)

    def err(self, m, mod=""):
        self.log(ERR, m, mod)


# process-wide default (log_init, clap.c:1111)
_default = Logger(stdio=False)


def get_logger() -> Logger:
    return _default
