"""The benchmark's general machinery: finding cells, configurations, traffic
drivers and metric readers by name; the environment of a run; seeded
weights and inputs; the measured window; the profiler's reduction; the
numbers that decide ``correct``.  Nothing here knows a particular cell."""
