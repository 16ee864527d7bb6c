"""Lightweight per-stage tracing (the reference has only ad-hoc
cost_start/cost_end timers in its CLI, example/sz.c:14-27; here every
pipeline stage is timed and can be dumped programmatically or via
SZ_TPU_TRACE=1).

Usage:
    with trace("quantize"):
        ...
    print(last_spans())
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

_enabled = os.environ.get("SZ_TPU_TRACE", "") not in ("", "0")
_spans: list = []


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    _spans.clear()
    _counters.clear()


def last_spans() -> list:
    """[(name, seconds), ...] since the last reset()."""
    return list(_spans)


@contextlib.contextmanager
def trace(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _spans.append((name, dt))
        if len(_spans) > 4096:
            del _spans[:2048]
        if _enabled:
            print(f"[sz_tpu {name}: {dt * 1e3:.1f} ms]", file=sys.stderr,
                  flush=True)


# --- counters ----------------------------------------------------------------
# Integer counts beside the spans: fixpoint sweeps, and every host fallback
# a device engine takes ("host_fallback.<stage>"), so a caller can prove
# that a run stayed on the device.
_counters: dict = {}


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """{name: total} since the last reset()."""
    return dict(_counters)
