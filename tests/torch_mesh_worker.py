"""One rank of a sharded run over gloo, for tests/test_torch_mesh_dist.py.
Imports only the port (no jax, no JAX package).

    python tests/torch_mesh_worker.py INIT_FILE WORLD RANK SHARDS OUT JOBS_JSON

joins the file:// rendezvous, runs every job — [model class, args,
spawn options] and, optionally, a state-count target — as
`spawn_sharded_bfs(devices=SHARDS, device="cpu", group=WORLD)` and, on
rank 0, writes each run's parity dict and discovery paths as JSON lines
to OUT."""

import json
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import stateright_tpu_torch.models as models  # noqa: E402
from stateright_tpu_torch import TensorModelAdapter  # noqa: E402


def parity(c):
    cov = c.coverage()
    out = dict(
        unique=c.unique_state_count(), states=c.state_count(), max_depth=c.max_depth(),
        discovery_fps={k: str(v) for k, v in c._discovery_fps.items()},
        coverage_actions=cov["actions"], coverage_depths={str(k): v for k, v in cov["depths"].items()},
        coverage_properties=cov["properties"],
    )
    if c._sampler is not None and c._sampler.size():
        out["sample"] = [str(f) for f in c._sampler.fingerprints()]
    return out


def main():
    init, world, rank, shards, out, jobs = sys.argv[1:]
    world, rank, shards = int(world), int(rank), int(shards)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        lines = []
        for job in json.loads(jobs):
            name, args, opts = job[:3]
            tm = getattr(models, name)(*args)
            b = TensorModelAdapter(tm).checker().coverage()
            if len(job) > 3:
                b = b.target_state_count(job[3])
            c = b.spawn_sharded_bfs(devices=shards, device="cpu", group=dist.group.WORLD, **opts).join()
            paths = {k: p.encode(c.model()) for k, p in c.discoveries().items()}
            tel = c.telemetry()
            lines.append(json.dumps(dict(parity=parity(c), paths=paths, world=tel["world_size"],
                                         partial=tel["partial_steps"])))
        if rank == 0:
            with open(out, "w") as f:
                f.write("\n".join(lines) + "\n")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
