"""One reader a per-layer metric, found by the metric's name in
BENCHMARK.json: ``read(ctx) -> float | None`` over a traced run's
core.runner.Context.  A reader that finds nothing to read returns None,
and the harness leaves the metric out of the line."""
