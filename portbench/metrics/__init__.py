"""One reader a metric: ``<metric>.py`` with ``read(run)``, where ``run`` is
the harness's ``Run`` (window counts and latencies, set-up seconds, the
cell's shapes and, in a traced run, its ``Timeline``).  A reader returns
the metric's value, or None when it finds nothing to read."""
