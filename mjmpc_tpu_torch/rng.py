"""Counter-based seeding: explicit keys and counters, no global RNG.

The JAX package derives every random stream of a solve as fold_in(key,
(tag, step)) on the device. Here a solve's stream is Philox4x32-10
(ops/noise.py, csrc/philox.cuh) under the 64-bit key stream_key(seed, tag),
a host integer worked out once per (seed, tag), with the solver state's
step, a 0-d int64 tensor on the device, as its last counter word. So the
noise is a function of (seed, tag, step), a solve reads nothing back to the
host, and a solve captured as a CUDA graph draws fresh noise on every
replay, as its step advances on the device.

`generator` seeds a `torch.Generator` for what runs outside a solve (env
initial states, the random policy).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def derive_seed(seed: int, *counters: int) -> int:
    """A 64-bit seed that depends on `seed` and every counter."""
    ss = np.random.SeedSequence([int(seed), *(int(c) for c in counters)])
    return int(ss.generate_state(1, np.uint64)[0])


@functools.lru_cache(maxsize=1024)
def stream_key(seed: int, tag: int) -> int:
    """The 64-bit Philox key of the stream `tag` of a solver seeded with
    `seed`: derive_seed(seed, tag), memoized, so that a solve looks it up
    and never derives it again."""
    return derive_seed(seed, tag)


def step_tensor(step: int, device) -> torch.Tensor:
    """A solver state's step: a 0-d int64 tensor on `device`."""
    return torch.full((), int(step), dtype=torch.int64, device=device)


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed` (for use outside a solve)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
