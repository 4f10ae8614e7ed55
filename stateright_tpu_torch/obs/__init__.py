"""Run observability the port carries: the coverage accumulator."""
