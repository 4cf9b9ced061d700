"""Device-mesh parallelism (counterpart of mjmpc_tpu/parallel/): the
particle axis of a solve split over the devices of a mesh row, each shard
on its own device's kernel, and batches of episodes over the rows;
`initialize_multihost` makes the process group of a run over several
hosts (torch.distributed)."""
from .mesh import (
    EPISODES_AXIS,
    PARTICLES_AXIS,
    Mesh,
    episode_sharding,
    initialize_multihost,
    make_mesh,
    pad_particles,
    particle_sharding,
    particle_slices,
    replicated,
)
from .sharded import (
    build_batch_episode_fn,
    build_sharded_episode_fn,
    build_sharded_solve_fn,
    shard_env,
)

__all__ = [
    "EPISODES_AXIS", "PARTICLES_AXIS", "Mesh", "make_mesh", "particle_sharding",
    "episode_sharding", "replicated", "pad_particles", "particle_slices",
    "build_sharded_solve_fn", "build_sharded_episode_fn", "build_batch_episode_fn",
    "shard_env", "initialize_multihost",
]
