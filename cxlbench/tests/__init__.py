"""CPU tests of the benchmark itself."""
