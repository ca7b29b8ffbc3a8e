"""One reader a per-layer metric, ``<metric name>.py`` with ``read(record)``
returning the value or None when the run has nothing to read (the
harness then leaves the metric out). ``common.py`` holds what the readers
share."""
