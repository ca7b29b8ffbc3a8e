"""The benchmark's own traffic: one general generator (``generate.py``)
reads a mix's parameters from ``mixes/<name>.json``; the writers it uses
(``wav.py``, ``jpeg.py``) are frozen copies, so a change to the program
never changes the yardstick."""
