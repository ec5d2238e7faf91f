"""One reader per metric: ``read(run) -> float | None`` on a
``harness.Run``. A reader that finds nothing to read returns None, and
the run leaves the metric out of its line."""
