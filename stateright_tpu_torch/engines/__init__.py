"""Checking engines of the port: the device BFS (gpu_bfs.py)."""
