"""Per-layer metric readers, one module a metric, each ``read(rec)`` over
the record ``run.record`` makes; ``None`` when it finds nothing to read."""
