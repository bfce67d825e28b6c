"""Tools that take the readings the benchmark's limits and bounds are set from."""
