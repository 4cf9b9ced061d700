"""Device meshes for particle-parallel MPC.

Counterpart of mjmpc_tpu/parallel/mesh.py. The reference's only
parallelism is particle-data-parallel rollouts over OS processes
(SubprocVecEnv); the JAX package lays the same decomposition out as a
device mesh with two axes:

- ``particles``: the MPC sampling batch, split over the devices of a row;
- ``episodes``: independent episodes (the reference's n_episodes loop and
  the tune/sweep cells), one row of devices each.

Here a mesh is a grid of torch devices, by default the card alone. A shard
is a contiguous slice of the particle axis on one device: each shard runs
its particles through its own device's kernel, and the solver's
reductions are taken over the costs gathered on the row's first device
(parallel/sharded.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

EPISODES_AXIS = "episodes"
PARTICLES_AXIS = "particles"


def canonical_device(device) -> torch.device:
    """`device` with its index: "cuda" is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (episodes x particles) grid of devices: devices[e][p]."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (EPISODES_AXIS, PARTICLES_AXIS)

    @property
    def shape(self) -> dict:
        return {EPISODES_AXIS: len(self.devices), PARTICLES_AXIS: len(self.devices[0])}

    def row(self, episode: int) -> "Mesh":
        """The one-row mesh of episode row `episode`."""
        return Mesh((self.devices[episode],))


def make_mesh(episodes: int = 1, particles: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """An (episodes x particles) mesh over `devices` (default: the card
    alone), laid out row by row; by default every device of a row on the
    particle axis."""
    devs = [canonical_device(d) for d in (devices if devices is not None else ["cuda"])]
    if particles is None:
        if len(devs) % episodes:
            raise ValueError(f"{len(devs)} devices not divisible by episodes={episodes}")
        particles = len(devs) // episodes
    if episodes * particles != len(devs):
        raise ValueError(f"mesh {episodes}x{particles} != {len(devs)} devices")
    return Mesh(tuple(tuple(devs[e * particles:(e + 1) * particles]) for e in range(episodes)))


def pad_particles(num_particles: int, mesh: Mesh) -> int:
    """N rounded up to a multiple of the particle axis's size (the
    reference asserts num_particles % num_cpu == 0; here the caller pads)."""
    n_shards = mesh.shape[PARTICLES_AXIS]
    return -(-num_particles // n_shards) * n_shards


def _slices(n: int, devs) -> List[Tuple[torch.device, slice]]:
    """(device, contiguous slice) of each of n rows split evenly over devs."""
    if n % len(devs):
        raise ValueError(f"{n} rows do not split over {len(devs)} devices; pad them "
                         f"to a multiple (pad_particles)")
    size = n // len(devs)
    return [(d, slice(i * size, (i + 1) * size)) for i, d in enumerate(devs)]


def particle_slices(n: int, mesh: Mesh) -> List[Tuple[torch.device, slice]]:
    """(device, contiguous slice of the particle axis) of each shard of n
    particles over the first row's devices."""
    return _slices(n, mesh.devices[0])


def _checked(x: torch.Tensor, rank: Optional[int]) -> torch.Tensor:
    if rank is not None and x.dim() != rank:
        raise ValueError(f"expected a rank-{rank} tensor, got shape {tuple(x.shape)}")
    return x


def particle_sharding(mesh: Mesh, rank: int = 3):
    """JAX's particle_sharding as a placement: x [N, ...] -> one tensor
    per device of the first row, the particle axis split in contiguous
    slices, the rest replicated."""
    return lambda x: [_checked(x, rank)[sl].to(d) for d, sl in particle_slices(x.shape[0], mesh)]


def episode_sharding(mesh: Mesh, rank: int = 1):
    """JAX's episode_sharding as a placement: x [B, ...] (seeds, env
    params, records) -> one tensor per mesh row, on its first device."""
    rows = [row[0] for row in mesh.devices]
    return lambda x: [_checked(x, rank)[sl].to(d) for d, sl in _slices(x.shape[0], rows)]


def replicated(mesh: Mesh):
    """JAX's replicated as a placement: x -> a copy on every device."""
    return lambda x: [x.to(d) for row in mesh.devices for d in row]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """The process group of a run over several hosts or processes:
    counterpart of the JAX package's jax.distributed.initialize wrapper.

    torch.distributed.init_process_group, with NCCL when CUDA is present
    and gloo on the CPU, at tcp://{coordinator_address} when it is given
    (then pass num_processes and process_id too), else from the environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); num_processes and
    process_id, where given, are the world size and this process's rank. A
    no-op when a group is already initialised."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    sizes = {k: v for k, v in (("world_size", num_processes), ("rank", process_id))
             if v is not None}
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        **sizes)
