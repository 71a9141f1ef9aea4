"""Spans and counters inside the pipeline, recorded only while a caller
holds :func:`recording` open.

    from vilgod_tpu_torch.utils import trace

    with trace.recording(device=torch.device("cuda")) as t:
        ZeroShotDetector(seq, name, cfg, clip_model=clip).process()
    t.spans, t.counters_by_stage(), t.kernel_pairs()

A span is a named interval of the calling thread, nested in the thread's
innermost open span; spans of one sequence share its name as their
sequence id. Span stamps are ``time.time_ns()``, the Unix-epoch clock on
which ``torch.profiler`` stamps the card's kernels (give or take a drift and
steps of a millisecond or so a pass, which marker kernels launched beside
host stamps measure: ``benchmark/spans.py``), so an idle gap on the card's
timeline can be put down to the host span open at that moment.
A ``device=True`` span also records a pair of CUDA events on the current
stream, read when the recording ends (never mid-run): the span's time on
the device's timeline, without a synchronize. On the CPU its host wall
stands in.

Counters (:func:`count`) are charged to the innermost open span of the
calling thread. On a CUDA device the recording counts host syncs as
counter ``syncs``: it sets ``torch.cuda.set_sync_debug_mode("warn")`` and
counts the warnings that PyTorch raises at each synchronizing call
(a ``.cpu()``, ``.item()``, ``bool()`` or ``.tolist()`` of a device
tensor, a pageable upload, a data-dependent shape). An explicit
``torch.cuda.synchronize()`` raises none, so it is not counted. On exit
the mode and the warning filters are restored.

With no recording open, :func:`span` returns one shared null context and
:func:`count` returns at once, after one module-global check: no
allocation, no CUDA event, no ``record_function``, no sync-debug mode.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from dataclasses import dataclass, field

import torch

SYNC_WARNING = "called a synchronizing CUDA operation"
_NULL = contextlib.nullcontext()
_ACTIVE: "Trace | None" = None       # the open recording


@dataclass
class Span:
    """One recorded span. ``start_ns`` / ``end_ns``: ``time.time_ns()``;
    ``device_s``: the device's time between the span's two events
    (``device=True`` spans), else None; ``counters``: counts charged to it
    (its children's not included)."""
    id: int
    name: str
    parent: int | None
    thread: str
    sequence: str | None
    start_ns: int
    end_ns: int = 0
    counters: dict = field(default_factory=dict)
    device_s: float | None = None

    @property
    def wall_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Launch:
    """One counted kernel launch: the (query, data) pairs it scans and the
    shapes its bound needs."""
    kernel: str
    pairs: int
    ndim: int
    n_q: int
    n_d: int


class _Open:
    """The context of one span while recording."""
    __slots__ = ("trace", "span", "device", "events", "ranges")

    def __init__(self, trace: "Trace", span: Span, device: bool):
        self.trace, self.span, self.device = trace, span, device
        self.events = self.ranges = None
        if device and trace.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> Span:
        stack = self.trace._stack()
        stack.append(self.span)
        if self.trace.profiler_ranges:
            self.ranges = torch.profiler.record_function(self.span.name)
            self.ranges.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
            self.trace._events.append((self.span, self.events))
        elif self.device:        # on the CPU the host wall stands in
            self.span.device_s = self.span.wall_s
        if self.ranges is not None:
            self.ranges.__exit__(*exc)
        self.trace._stack().pop()
        return False


class Trace:
    """What one recording holds: the spans in the order they opened, the
    counted kernel launches, and counts made outside any span."""

    def __init__(self, device: torch.device, profiler_ranges: bool):
        self.device = device
        self.cuda = device.type == "cuda"
        self.profiler_ranges = profiler_ranges
        self.spans: list[Span] = []
        self.launches: list[Launch] = []
        self.loose: dict = {}             # counts with no open span
        self._events: list = []
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- while recording ---------------------------------------------------
    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, sequence: str | None, device: bool) -> _Open:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if sequence is None and parent is not None:
            sequence = parent.sequence
        span = Span(next(self._ids), name,
                    None if parent is None else parent.id,
                    threading.current_thread().name, sequence, 0)
        self.spans.append(span)
        return _Open(self, span, device)

    def count(self, name: str, value=1):
        stack = self._stack()
        if stack:
            c = stack[-1].counters
            c[name] = c.get(name, 0) + value
        else:
            with self._lock:
                self.loose[name] = self.loose.get(name, 0) + value

    def launch(self, kernel: str, pairs, ndim: int, n_q: int, n_d: int):
        """A kernel launch that scans ``pairs`` (query, data) pairs (a
        device tensor, read when the recording ends), charged to the
        innermost open span as counter ``pairs.<kernel>``."""
        self.count(f"pairs.{kernel}", pairs)
        self.launches.append(Launch(kernel, pairs, ndim, n_q, n_d))

    def _showwarning(self, original):
        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                self.count("syncs")
            else:
                original(message, category, filename, lineno, file, line)
        return show

    # -- when the recording ends -------------------------------------------
    def _finish(self):
        """Read the device events and the device-tensor counts and pairs
        (one synchronize and one download)."""
        slots = [(c, k) for c in [s.counters for s in self.spans]
                 + [self.loose] for k, v in c.items()
                 if isinstance(v, torch.Tensor)]
        slots += [(x.__dict__, "pairs") for x in self.launches
                  if isinstance(x.pairs, torch.Tensor)]
        if self.cuda and (self._events or slots):
            torch.cuda.synchronize(self.device)
        for span, (e0, e1) in self._events:
            span.device_s = e0.elapsed_time(e1) / 1e3
        self._events.clear()
        if slots:
            values = torch.stack([c[k].reshape(()).to(torch.int64)
                                  for c, k in slots]).tolist()
            for (c, k), v in zip(slots, values):
                c[k] = v

    # -- reading -----------------------------------------------------------
    def children(self) -> dict[int | None, list[Span]]:
        out: dict[int | None, list[Span]] = {}
        for s in self.spans:
            out.setdefault(s.parent, []).append(s)
        return out

    def self_s(self, span: Span, children=None) -> float:
        """The span's wall less the part of it its children cover."""
        kids = (children or self.children()).get(span.id, [])
        covered, end = 0, span.start_ns
        for k in sorted(kids, key=lambda k: k.start_ns):
            a, b = max(k.start_ns, end), min(k.end_ns, span.end_ns)
            if b > a:
                covered += b - a
                end = b
        return (span.end_ns - span.start_ns - covered) / 1e9

    def stage_of(self, span: Span, by_id=None) -> str:
        """The name of the span's ancestor right below its root (the
        runner's stage under its ``sequence`` span), or the root's own."""
        by_id = by_id or {s.id: s for s in self.spans}
        chain = [span]
        while chain[-1].parent is not None:
            chain.append(by_id[chain[-1].parent])
        return chain[-2].name if len(chain) > 1 else chain[-1].name

    def counters_by_span(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for s in self.spans:
            for k, v in s.counters.items():
                acc = out.setdefault(s.name, {})
                acc[k] = acc.get(k, 0) + v
        return out

    def counters_by_stage(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        by_id = {s.id: s for s in self.spans}
        for s in self.spans:
            if s.counters:
                acc = out.setdefault(self.stage_of(s, by_id), {})
                for k, v in s.counters.items():
                    acc[k] = acc.get(k, 0) + v
        return out

    def total(self, counter: str) -> int:
        """A counter summed over every span and the loose counts."""
        return sum(s.counters.get(counter, 0) for s in self.spans) \
            + self.loose.get(counter, 0)

    def kernel_pairs(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for launch in self.launches:
            out[launch.kernel] = out.get(launch.kernel, 0) + launch.pairs
        return out


def current() -> Trace | None:
    """The open recording, or None."""
    return _ACTIVE


def span(name: str, *, sequence: str | None = None, device: bool = False):
    """A span named ``name`` while recording, else the shared null context.
    ``sequence``: the sequence id (by default the parent span's);
    ``device``: also time the span on the device's timeline."""
    t = _ACTIVE
    if t is None:
        return _NULL
    return t.open(name, sequence, device)


def count(name: str, value=1):
    """Add ``value`` to counter ``name`` of the calling thread's innermost
    open span, while recording."""
    t = _ACTIVE
    if t is not None:
        t.count(name, value)


class timed:
    """``with timed(name) as tm: ...`` then ``tm.seconds``: one
    ``time.perf_counter_ns()`` pair that is always read (the runner's
    stage times and the prefetch wait), and that is also the span ``name``
    while recording (the span's own stamps on ``time.time_ns()``, taken
    next to it)."""
    __slots__ = ("name", "sequence", "seconds", "_t0", "_span")

    def __init__(self, name: str, sequence: str | None = None):
        self.name, self.sequence = name, sequence
        self.seconds = 0.0

    def __enter__(self):
        t = _ACTIVE
        self._span = None if t is None else t.open(self.name, self.sequence,
                                                   False)
        if self._span is not None:
            self._span.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.seconds = (time.perf_counter_ns() - self._t0) / 1e9
        if self._span is not None:
            self._span.__exit__(*exc)
        return False


@contextlib.contextmanager
def recording(device=None, profiler_ranges: bool = False):
    """Record spans and counters while inside; yields the :class:`Trace`,
    complete once the block has exited. ``device``: the device whose
    events and syncs are recorded (``torch.device`` or a name; the CPU by
    default). ``profiler_ranges``: each span is also a
    ``torch.profiler.record_function`` range, for a profiler the caller
    runs (such a range also shows on the card's timeline). One recording
    at a time."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a trace is already recording")
    trace = Trace(torch.device(device or "cpu"), profiler_ranges)
    filters = warnings.catch_warnings()
    filters.__enter__()
    mode = None
    try:
        if trace.cuda:
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.showwarning = trace._showwarning(warnings.showwarning)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _ACTIVE = trace
        yield trace
    finally:
        _ACTIVE = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        filters.__exit__(None, None, None)
    trace._finish()
