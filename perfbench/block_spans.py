"""Device time per image inside a model's per-block spans, from the port's
own spans (``utils.profiling.span``) in a run's traced slice.

:func:`perfbench.spans.device_ms_inside` gives the mean device time of the
ops launched inside one span, over all spans of a name in the slice. A
model whose blocks differ in width needs it by block: the slice holds
whole forwards and pieces of others, so a plain mean over spans weighs the
levels by how the slice happened to cut them, and the spans the closing
synchronize cut short read low. Here each span's ops are summed from the
same correlation of device op and runtime call, a span counts only where
every kernel, copy and memset it launched ran inside the slice, and the
spans are grouped by their ``level`` and ``channels`` attributes: the
result is the sum over groups of the family's blocks per forward
(``blocks_per_forward``) times the group's mean device ms per image
(``images`` attribute). None where the program records no such spans or
a group of the forward has no whole span in the slice.
"""

from __future__ import annotations

import bisect

from . import spans

_LAUNCHES = ("Launch", "Memcpy", "Memset")


def device_ms_per_image(run, name: str) -> float | None:
    found = spans.records(run, name)
    blocks = getattr(run.family, "blocks_per_forward", None)
    prof = spans._recorder()
    if found is None or blocks is None or prof is None:
        return None
    t = run.trace_data
    ran: dict = {}
    for e in t.device:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            ran[c] = ran.get(c, 0.0) + float(e["dur"])
    calls: dict = {}
    for e in t.runtime:
        c = e.get("args", {}).get("correlation")
        if c is not None and any(k in e["name"] for k in _LAUNCHES):
            calls.setdefault(e["tid"], []).append((float(e["ts"]), c))
    for made in calls.values():
        made.sort()
    groups: dict = {}
    for s in found:
        inside = []
        for tid in set(prof.trace_tids(s.tid)):
            made = calls.get(tid, [])
            lo = bisect.bisect_left(made, (s.start, -1))
            hi = bisect.bisect_right(made, (s.end, float("inf")))
            inside += made[lo:hi]
        if not inside or any(c not in ran for _, c in inside):
            continue
        per_image = sum(ran[c] for _, c in inside) / s.attrs["images"] / 1e3
        groups.setdefault((s.attrs["level"], s.attrs["channels"]), []).append(per_image)
    total = 0.0
    for key, n in blocks(run.cfg).items():
        if key not in groups:
            return None
        total += n * sum(groups[key]) / len(groups[key])
    return total
