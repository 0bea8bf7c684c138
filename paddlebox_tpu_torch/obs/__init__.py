"""paddlebox_tpu_torch.obs — the telemetry plane, one registry:

- ``histogram``       log2-bucketed distributions behind ``STAT_OBSERVE``
- ``metrics_writer``  rank-tagged JSONL series of registry snapshots
- ``trace_context``   (trace_id, span_id) propagation
- ``flight_recorder`` always-on ring of recent spans and incidents,
                      dumped as ``incident-<ts>.json``

The exports are lazy: ``utils/monitor.py`` imports ``obs.histogram`` and
``metrics_writer`` / ``flight_recorder`` import monitor back.
"""

from __future__ import annotations

_LAZY = {
    "Histogram": ("paddlebox_tpu_torch.obs.histogram", "Histogram"),
    "merge_all": ("paddlebox_tpu_torch.obs.histogram", "merge_all"),
    "MetricsWriter": ("paddlebox_tpu_torch.obs.metrics_writer", "MetricsWriter"),
    "read_series": ("paddlebox_tpu_torch.obs.metrics_writer", "read_series"),
    "TraceContext": ("paddlebox_tpu_torch.obs.trace_context", "TraceContext"),
    "trace_span": ("paddlebox_tpu_torch.obs.trace_context", "trace_span"),
    "current_trace": ("paddlebox_tpu_torch.obs.trace_context", "current_trace"),
    "FlightRecorder": ("paddlebox_tpu_torch.obs.flight_recorder", "FlightRecorder"),
    "FLIGHT_RECORDER": ("paddlebox_tpu_torch.obs.flight_recorder", "FLIGHT_RECORDER"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
