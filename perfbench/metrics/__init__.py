"""One reader per per-layer metric, ``<metric name>.py`` with ``read(run)``
returning the metric's value or None where the run has nothing to read
(the harness then leaves the metric out of the line)."""
