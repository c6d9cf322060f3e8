"""Device milliseconds of the engine's copy of each finished batch to the
host: the ``Memcpy DtoH`` device ops whose runtime call the drainer made
inside an ``engine.fetch.copy`` span, over those spans in the traced
slice. The span itself also holds the wait for the collector's later
launches, which the single stream runs before the copy, so its length is
not the copy's cost."""

from perfbench import spans


def read(run):
    return spans.device_ms_inside(run, "engine.fetch.copy", lambda n: n.startswith("Memcpy DtoH"))
