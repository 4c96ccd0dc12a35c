"""Per-layer metric readers, one file a metric, found by the metric's name
in ``BENCHMARK.json``: ``<name>.py`` defines ``read(ctx)``, which returns
the metric's value, or ``None`` where the traced run holds nothing for
it to read.  ``ctx`` (``harness.reader_context``) carries the traced
steps' device ops (name, start µs, duration µs), their launch counters,
the untraced window's seconds a step, the configuration and the program's
parameters after the window."""
