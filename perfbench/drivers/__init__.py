"""One module a driver: ``setup(run)``, ``window(run, ctx, t0, tracer)``
and ``check(run, ctx, win, variant)``; a workload file names its driver."""
