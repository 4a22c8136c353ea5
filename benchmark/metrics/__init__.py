"""One reader a per-layer metric: ``<metric>.py`` holds ``read(ctx)``, which
takes the metric from the run's spans, counters or trace (``harness.Ctx``)
and returns a number, or None where it finds nothing to read; the harness
then leaves the metric out of the line."""
