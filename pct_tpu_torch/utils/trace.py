"""Stage spans and host counters of the port's curvature routes.

``span(name)`` marks one stage of a call ("grid", "probe", "cells",
"run_table", "candidates", "kernel", "fit", "scatter", "repair",
"load", or an entry point's name). Under an active ``torch.profiler``
it is ``record_function("pct." + name)``, so the stage is an event on
the profiler's own clock and the kernels launched inside it are linked
to it; with no profiler it returns one shared no-op context. Where
spans nest, the innermost one owns the work. ``stage(name)`` runs every
call of the function it decorates inside ``span(name)``.

``count(name, n)`` adds a host integer to a process-wide tally, read by
``counters()`` and cleared by ``reset()``. Every count is taken where
the host already holds the value, so neither a span nor a count copies
from the device or synchronises. Beside the probe's and the repair's
counts the tally holds every hand-written kernel's launches:
``launches.<symbol>`` (``ops.build.kernel`` counts each launch of entry
point ``symbol``), and for the three selects also
``launches.<symbol>.k<k>``. A reader that wants the launches of one
call takes the difference of ``counters()`` before and after it;
``reset()`` would clear the probe's counts too.
"""

from __future__ import annotations

import contextlib
import functools
import threading

from torch.autograd import profiler as _profiler

PREFIX = "pct."

_NOOP = contextlib.nullcontext()
_counts: dict[str, int] = {}
_lock = threading.Lock()


def span(name: str):
    """A context that records stage ``name`` while a profiler runs."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return _NOOP


def stage(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def count(name: str, n: int):
    """Add the host integer ``n`` to counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def reset():
    """Clear every counter."""
    with _lock:
        _counts.clear()
