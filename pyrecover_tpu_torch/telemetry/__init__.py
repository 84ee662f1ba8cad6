"""Telemetry. Only the process-local metrics registry (``metrics.py``) that
the serving engine and the load generator read is ported; the JAX package's
event bus, spans, tracing, flushes and exporter are not."""
