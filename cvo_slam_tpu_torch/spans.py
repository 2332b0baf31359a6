"""In-memory spans at the port's layer boundaries.

A span is one interval of work: its name, its start and end on
time.perf_counter()'s clock, the thread that ran it, the span that held it
open on that thread (`parent`), the span on another thread that caused it
(`cause`), the frame it served (the index of the frame in the stream: the
request id that spans of one frame share across threads) and a few
attributes.

The recorder is off by default. A span site then costs one test of the
module flag and gets the shared NULL context back: it reads no clock and
records nothing. enable() turns it on for every thread; each thread appends
its finished spans to a list of its own, and take() empties the lists and
hands their spans back. The recorder starts no thread or process, opens no
file and registers nothing at exit. Its readers are run_slam's profile
trace (chrome_events) and eval/span_readings.py.

    with spans.span("align") as s:     # NULL while the recorder is off
        s.set("backend", backend)
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from typing import List, Optional

ENABLED = False

_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_threads = []       # [(thread, finished spans)] of every thread that recorded


class _Null:
    """What a span site gets while the recorder is off."""
    __slots__ = ()
    frame = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, key, value):
        pass

    def times(self, t0, t1):
        pass


NULL = _Null()


class Span:
    """One recorded span; a context manager while it is open."""
    __slots__ = ("id", "name", "t0", "t1", "thread", "tid", "parent",
                 "cause", "frame", "attrs", "_given", "_owner")

    def __init__(self, name: str, frame: Optional[int] = None,
                 cause: Optional["Span"] = None):
        self.id = next(_ids)
        self.name = name
        self.frame = frame
        self.cause = None if cause is NULL else cause
        self.parent = None
        self.attrs = None
        self._given = False

    def set(self, key: str, value):
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def times(self, t0: float, t1: float):
        """Take (t0, t1), read by the site for a timer of its own, as the
        span's start and end."""
        self.t0, self.t1, self._given = t0, t1, True

    def __enter__(self):
        self._owner = state = _state()
        stack = state[0]
        parent = stack[-1] if stack else None
        self.parent = parent
        self.thread, self.tid = state[2], state[3]
        if self.frame is None:
            up = parent if parent is not None else self.cause
            self.frame = None if up is None else up.frame
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._given:
            self.t1 = time.perf_counter()
        state, self._owner = self._owner, None
        state[0].pop()
        state[1].append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, frame={self.frame}, "
                f"thread={self.thread!r}, {self.t1 - self.t0:.6f} s)")


def _state():
    """(open spans, finished spans, thread name, thread id) of the calling
    thread."""
    state = getattr(_local, "state", None)
    if state is None:
        t = threading.current_thread()
        state = _local.state = ([], [], t.name, threading.get_native_id())
        with _lock:
            _threads.append((t, state[1]))
    return state


def span(name: str, frame: Optional[int] = None, cause=None):
    """A span named `name` around a `with` block: `frame` defaults to the
    enclosing span's on this thread, else to `cause`'s (a span of another
    thread, handed over with the work)."""
    if not ENABLED:
        return NULL
    return Span(name, frame, cause)


def traced(name: str):
    """Decorator: each call of the function in a span named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not ENABLED:
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def record(name: str, t0: float, t1: float, cause=None):
    """A finished span from two readings the site took for a timer of its
    own, under the span open on this thread."""
    if not ENABLED:
        return
    with Span(name, None, cause) as s:
        s.times(t0, t1)


def current():
    """The innermost open span of the calling thread (None while the
    recorder is off or none is open): the cause to hand to another
    thread."""
    if not ENABLED:
        return None
    stack = _state()[0]
    return stack[-1] if stack else None


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def take() -> List[Span]:
    """Every thread's finished spans, by start; the lists are emptied."""
    out = []
    with _lock:
        for _, done in _threads:
            n = len(done)
            out.extend(done[:n])
            del done[:n]
        _threads[:] = [(t, d) for t, d in _threads if t.is_alive() or d]
    out.sort(key=lambda s: s.t0)
    return out


def chrome_events(spans: List[Span], offset_us: float) -> list:
    """The spans as chrome-trace complete events, their times moved onto
    a trace's clock (trace microseconds = perf_counter seconds * 1e6 +
    offset_us), one tid per thread (its native id, as the profiler's), and
    the threads' names as metadata events."""
    pid = os.getpid()
    names = {}
    events = []
    for s in spans:
        names[s.tid] = s.thread
        args = {"frame": s.frame, "id": s.id,
                "parent": None if s.parent is None else s.parent.id,
                "cause": None if s.cause is None else s.cause.id}
        if s.attrs:
            args.update(s.attrs)
        events.append({"name": s.name, "cat": "port_span", "ph": "X",
                       "ts": s.t0 * 1e6 + offset_us,
                       "dur": (s.t1 - s.t0) * 1e6, "pid": pid,
                       "tid": s.tid, "args": args})
    events.extend({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": name}} for tid, name in names.items())
    return events
