"""The benchmark's general machinery: finding a cell's files by name, the
starts drawn from the seed, the measured window, the profiler's reading, the
comparison that decides ``correct``, and the result line."""
