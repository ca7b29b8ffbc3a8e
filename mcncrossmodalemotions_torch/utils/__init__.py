"""Host utilities of the port: config hashing, progress/metrics logs, and
the device an entry point runs on."""
