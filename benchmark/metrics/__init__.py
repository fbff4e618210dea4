"""Per-layer metric readers, one file a metric (or a metric family:
`mfu.faces` and `mfu.frames` share `mfu.py`). Each has
`read(name, ctx) -> float | None`; None leaves the metric out of the
line (nothing to read). `ctx` holds the traced window's device facts
(benchmark/trace.py `reduce`), the system's counts and shapes
(`trace_facts`), and the window's requests and units."""
