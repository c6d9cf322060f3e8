"""Milliseconds a request waits in the serving engine, from ``submit`` to
the end of its batch's formation, over the batches formed in the traced
slice: the sum of the ``engine.form`` spans' ``wait_ms_sum`` over the sum
of their ``rows``. In a closed loop at saturation the outstanding
requests fix the time in the engine (Little's law), so there it reads
how that time divides between the queue and the batches in flight, and
moves with ``serve_img_per_s`` rather than ahead of it."""

from perfbench import spans


def read(run):
    forms = spans.records(run, "engine.form")
    if forms is None:
        return None
    rows = sum(s.attrs["rows"] for s in forms)
    return sum(s.attrs["wait_ms_sum"] for s in forms) / rows if rows else None
