"""The harness: cells found by name, parts, weights, fitted state, the
timed window, the profiler reduction and the check against the plain
reference."""
