"""Counter-based seeding: explicit generators, no global RNG.

The JAX package derives every random stream as fold_in(key, (tag, step)).
Here a stream is a `torch.Generator` seeded from a host integer derived
from (seed, *counters), so the same seed and counters give the same
numbers on a given device, and deriving a seed never reads the device.
"""
from __future__ import annotations

import numpy as np
import torch


def derive_seed(seed: int, *counters: int) -> int:
    """A 64-bit seed that depends on `seed` and every counter."""
    ss = np.random.SeedSequence([int(seed), *(int(c) for c in counters)])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
