"""The benchmark of ``repro_torch``: one cell of ``BENCHMARK.json`` a run.

``bench/run.py`` is the entry point; ``harness`` loads a cell's files by
name and runs it; ``loops/<loop>.py`` drive the window, and ``updates``
with ``draws/`` the update stream of a mix that churns; ``tracing``
reduces the profiler's trace; ``reference`` holds the plain reference,
the frozen data generator and the roofline counts; ``sweep`` and
``backup_witness`` are scripts around ``harness``.
"""
