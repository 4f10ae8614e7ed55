"""Run observability the port carries: coverage, the bottom-k sample, phase
timers and gauges, and the stage profiler."""
