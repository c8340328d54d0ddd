"""The benchmark of ``pion_tpu_torch``: cell-updates per second, peak device
memory and set-up time of the port on the cells of ``BENCHMARK.json``.

``run.py`` is the command; ``harness.py`` runs one cell; the cells'
configurations, traffic mixes, limits and per-layer readers are data and
small files found by name under ``configs/``, ``traffic/``, ``limits/`` and
``metrics/``.  ``reference/`` holds the plain reference that decides
``correct`` (``port_plain``, or the package a configuration names); it
imports nothing of the program.  A configuration may name a builder,
``builders/<name>.py``, of its own inputs (``problems.py``).
"""
