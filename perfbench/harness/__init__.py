"""The harness: finds a cell's files by name, times set-up and the window,
reads the trace, assembles and prints the result."""
