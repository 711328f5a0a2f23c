"""The benchmark's general parts: the benchmark file and its lookups
(``spec``), the traffic generator (``traffic``), the drive loop and its
result line (``drive``), the instrumentation of a run (``record``) and
the reading of the profiler's trace (``trace``)."""
