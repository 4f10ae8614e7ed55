"""The sharded BFS engine (K15): `parallel/mesh.py`, the port of
`stateright_tpu/parallel/mesh.py`."""

from .mesh import MeshProgram, ShardedBfs, ShardedGpuBfsChecker

__all__ = ["MeshProgram", "ShardedBfs", "ShardedGpuBfsChecker"]
