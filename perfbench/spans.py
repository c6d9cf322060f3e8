"""The port's own spans (``utils.profiling.span``) in a run's traced slice.

The port records spans while a profiler session runs in the process, on
``time.perf_counter_ns()``. :func:`records` takes those that lie inside
the slice ``run.trace_data`` (``t0``..``t1``) and maps them onto the
trace's clock. The slice's own ``offset_us`` reads the host's clock after
the opening synchronize returns, late by up to a few ms while other
threads hold the interpreter lock, so :func:`offset_us` corrects it from
the trace itself: by the shift, within ``SHIFT_US`` of it, that puts the
most CUDA runtime calls of the spans' threads inside those threads'
spans. A span still open when the slice ends is left out: the capture's
own stop (a synchronize and the profiler's teardown, on a thread that
holds the interpreter lock) stretches it by a tenth of a second or more
on the H100's host. Every reader returns None where the port has no
recorder or recorded nothing there, so a reader of a program without the
spans reports nothing.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

SHIFT_US = 10_000.0  # how far the slice's offset_us may be off
_cached: list = [None, None]  # [trace, its corrected offset]


class Span(NamedTuple):
    """A port span on the trace's clock (microseconds)."""

    name: str
    start: float
    end: float
    tid: int
    attrs: dict


def _recorder():
    try:
        from image_enhancement_deglaring_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "trace_tids") else None


def offset_us(run) -> float | None:
    """Host ``perf_counter`` microseconds -> the slice's trace clock: the
    slice's ``offset_us`` plus the shift that holds the most (call, span)
    pairs of a span's thread, a runtime call lying wholly inside the span.
    A step's children bound their calls closely on both sides, so the
    shift is fixed to within the gap between two calls. The slice's own
    offset where no call of a span's thread was traced."""
    t, prof = run.trace_data, _recorder()
    if t is None or prof is None:
        return None
    if _cached[0] is t:
        return _cached[1]
    lo = int((t.t0 - t.offset_us - SHIFT_US) * 1e3)
    hi = int((t.t1 - t.offset_us + SHIFT_US) * 1e3)
    rows: dict = {}
    for r in prof.spans(lo, hi):
        for tid in prof.trace_tids(r.tid):
            rows.setdefault(tid, []).append((r.start_ns / 1e3 + t.offset_us,
                                             r.end_ns / 1e3 + t.offset_us))
    calls: dict = {}
    for e in t.runtime:
        if e["tid"] in rows:
            c0 = float(e["ts"])
            calls.setdefault(e["tid"], []).append((c0, c0 + float(e["dur"])))
    edges = []
    for tid, made in calls.items():
        held = sorted(rows[tid])
        starts = [a for a, _ in held]
        longest = max(b - a for a, b in held)
        for c0, c1 in made:
            j = bisect.bisect_right(starts, c0 + SHIFT_US) - 1
            while j >= 0 and starts[j] >= c0 - SHIFT_US - longest:
                a, b = held[j]
                shift_lo, shift_hi = max(c1 - b, -SHIFT_US), min(c0 - a, SHIFT_US)
                if shift_lo <= shift_hi:
                    edges += [(shift_lo, 0), (shift_hi, 1)]
                j -= 1
    shift = _densest(edges)
    _cached[:] = [t, t.offset_us + shift]
    return _cached[1]


def _densest(edges) -> float:
    """The middle of the stretch covered by most of the closed intervals
    whose ends are ``edges`` ((x, 0) opens, (x, 1) closes); of several,
    the one nearest 0. 0 where there are none."""
    best, best_at, depth, prev = 0, 0.0, 0, 0.0
    for x, kind in sorted(edges):
        mid = (prev + x) / 2
        if depth > best or (depth == best and depth and abs(mid) < abs(best_at)):
            best, best_at = depth, mid
        depth += 1 if kind == 0 else -1
        prev = x
    return best_at


def records(run, name: str) -> list[Span] | None:
    """The spans named ``name`` that lie inside the traced slice."""
    off, prof = offset_us(run), _recorder()
    if off is None:
        return None
    t = run.trace_data
    lo, hi = (int((x - off) * 1e3) for x in (t.t0, t.t1))
    out = [Span(r.name, r.start_ns / 1e3 + off, r.end_ns / 1e3 + off, r.tid, r.attrs)
           for r in prof.spans(lo, hi) if r.name == name and r.end_ns <= hi]
    return out or None


def mean_ms(run, name: str) -> float | None:
    """The mean duration of the spans named ``name`` in the slice, in ms."""
    found = records(run, name)
    if found is None:
        return None
    return sum(s.end - s.start for s in found) / len(found) / 1e3


def device_ms_inside(run, name: str, match) -> float | None:
    """Per span named ``name`` in the slice: the ms of the device ops whose
    name ``match`` accepts and whose runtime call its thread made inside
    that span."""
    found, prof = records(run, name), _recorder()
    if found is None:
        return None
    t = run.trace_data
    held: dict = {}
    for s in found:
        for tid in prof.trace_tids(s.tid):
            held.setdefault(tid, []).append((s.start, s.end))
    total = 0.0
    for e in t.device:
        call = t.launch.get(e.get("args", {}).get("correlation"))
        if call is None or not match(e["name"]):
            continue
        c0 = float(call["ts"])
        if any(a <= c0 <= b for a, b in held.get(call["tid"], ())):
            total += float(e["dur"])
    return total / len(found) / 1e3


def idle_gaps(trace) -> list[tuple[float, float]]:
    """The stretches of the slice with no kernel, copy or memset on the
    device, on the trace's clock."""
    edges = [trace.t0] + [t for iv in trace.intervals for t in iv] + [trace.t1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def idle_inside_ms(run, name: str) -> float | None:
    """Per span named ``name``: the ms of the slice's idle gaps whose
    middle lies inside one of those spans."""
    found = records(run, name)
    if found is None:
        return None
    inside = 0.0
    for a, b in idle_gaps(run.trace_data):
        mid = (a + b) / 2
        if any(s.start <= mid <= s.end for s in found):
            inside += b - a
    return inside / len(found) / 1e3
