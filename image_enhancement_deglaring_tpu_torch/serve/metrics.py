"""Prometheus text exposition of the serving stats (``GET /metrics``).

A copy of ``image_enhancement_deglaring_tpu.serve.metrics``; the two
servers expose the same series.

An observability addition beyond the reference API (which exposes only
``GET /ping``, reference: api/app.py:104-107): the same numbers the JSON
``/stats`` endpoint reports, rendered in the Prometheus text exposition
format (v0.0.4) so the k8s deployment can be scraped directly — no
sidecar, no client library.

The renderer is tolerant by design: ``/stats`` values can be ``None``
(e.g. no requests served yet, or a percentile window that is still
empty), and the multi-process IPC proxy returns the same dict shape as
the in-process engine. ``None`` samples are simply omitted — Prometheus
treats an absent series as "no observation", which is exactly right.
"""

from __future__ import annotations

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# stats() latency percentiles -> Prometheus summary quantile labels
_LATENCY_QUANTILES = (
    ("latency_ms_p50", "0.5"),
    ("latency_ms_p95", "0.95"),
    ("latency_ms_p99", "0.99"),
)
# host-side request phases recorded by the HTTP layer (p50 of a rolling
# 1024-request window, see ApiServer.host_phase_stats)
_HOST_PHASES = ("decode", "engine", "encode")

_HANDLED_KEYS = frozenset(
    {"requests_served", "mean_batch_fill", "max_batch_size"}
    | {k for k, _ in _LATENCY_QUANTILES}
    | {f"host_{p}_ms_p50" for p in _HOST_PHASES}
)


def _fmt(value) -> str:
    """Prometheus sample value: shortest round-trippable decimal."""
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.9g}"


def _emit(lines: list[str], name: str, mtype: str, help_text: str,
          samples: list[tuple[dict, object]]) -> None:
    present = [(labels, v) for labels, v in samples if v is not None]
    if not present:
        return
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {mtype}")
    for labels, value in present:
        label_str = ""
        if labels:
            inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
            label_str = "{" + inner + "}"
        lines.append(f"{name}{label_str} {_fmt(value)}")


def prometheus_text(stats: dict, worker: str | None = None) -> str:
    """Render an engine/server stats dict as Prometheus exposition text.

    Known keys get stable, unit-correct metric names (milliseconds are
    converted to seconds per Prometheus naming conventions); any other
    numeric key is passed through as a ``deglaring_<key>`` gauge so new
    stats fields surface in monitoring without a code change here.

    ``worker`` labels the host-phase series with the serving process's
    identity. Engine numbers are global (one shared engine), but in
    ``--workers N`` mode the HTTP phases are per-process and SO_REUSEPORT
    routes each scrape to a random worker — without the label those
    scrapes would interleave different processes into one series.
    """
    lines: list[str] = []

    _emit(lines, "deglaring_requests_served_total", "counter",
          "Images served by the inference engine since start",
          [({}, stats.get("requests_served"))])

    _emit(lines, "deglaring_request_latency_seconds", "summary",
          "End-to-end engine request latency (submit to result)",
          [({"quantile": q}, _ms_to_s(stats.get(k)))
           for k, q in _LATENCY_QUANTILES])

    # stats() reports mean_batch_fill as an ABSOLUTE request count per
    # dispatched batch; the ratio gauge normalizes by max_batch_size so a
    # 0..1 fill fraction is what dashboards actually see
    fill = stats.get("mean_batch_fill")
    max_batch = stats.get("max_batch_size")
    _emit(lines, "deglaring_engine_batch_fill_ratio", "gauge",
          "Mean fraction of the engine's max batch filled per dispatch",
          [({}, fill / max_batch if fill is not None and max_batch else None)])
    _emit(lines, "deglaring_engine_batch_fill_mean", "gauge",
          "Mean requests per dispatched device batch (absolute count)",
          [({}, fill)])
    _emit(lines, "deglaring_engine_max_batch_size", "gauge",
          "Engine max_batch_size (upper bound of a dispatched batch)",
          [({}, max_batch)])

    phase_labels = ({"worker": worker} if worker else {})
    _emit(lines, "deglaring_host_phase_seconds", "summary",
          "Host-side request phase time (rolling p50): PIL decode+resize, "
          "engine round-trip, PNG encode",
          [({**phase_labels, "phase": p, "quantile": "0.5"},
            _ms_to_s(stats.get(f"host_{p}_ms_p50")))
           for p in _HOST_PHASES])

    # forward-compatible passthrough for stats keys this module predates
    for key in sorted(stats.keys() - _HANDLED_KEYS):
        value = stats[key]
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        name = "deglaring_" + "".join(
            c if c.isalnum() else "_" for c in key.lower()
        )
        _emit(lines, name, "gauge", f"Engine stat '{key}'", [({}, value)])

    return "\n".join(lines) + "\n" if lines else "\n"


def _ms_to_s(value):
    return None if value is None else float(value) / 1e3
