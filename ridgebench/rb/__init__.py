"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``ridgebench/run.py`` runs one cell once.  Everything that belongs to one
configuration, traffic mix, cell, per-layer metric or operation count is
a file of its own under ``ridgebench/``, found by the name that
``BENCHMARK.json`` gives it (``spec``).  The modules here are the
yardstick that later changes to the program do not touch: the input
generator (``data``), the plain reference and its control
(``reference``), the comparison that decides ``correct`` (``correct``),
the reduction of a profiler trace to layers (``trace``) and the cell
driver (``cell``).
"""
