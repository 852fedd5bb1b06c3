"""Host-side utilities of the port: step timing and profiler traces
(``utils/profiling.py``)."""
