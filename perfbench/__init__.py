"""The benchmark of the PyTorch/CUDA port (``mcncrossmodalemotions_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line last.
Everything that belongs to one configuration, traffic mix, driver or
per-layer metric lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/mixes/<traffic>.json``,
``workloads/<cell>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py``. ``counts/`` works out operations and bytes from
shapes, ``reference/`` is the plain reference that decides ``correct``.
"""
