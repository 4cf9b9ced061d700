"""Replay memories (counterpart of mjmpc_tpu/rl/replay.py): a flat
transition ring buffer and a trajectory-level variant, host-side numpy
storage. The index draw is np.random.RandomState(seed).randint, as in the
JAX package, so that a seed gives the same batches there and here."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class ReplayMemory:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self.rng = np.random.RandomState(seed)
        self._storage: Dict[str, np.ndarray] = {}
        self.position = 0
        self.size = 0

    def push(self, obs, action, reward, next_obs, done):
        batch = dict(obs=obs, action=action, reward=np.float32(reward),
                     next_obs=next_obs, done=np.float32(done))
        if not self._storage:
            for k, v in batch.items():
                v = np.asarray(v, np.float32)
                self._storage[k] = np.zeros((self.capacity,) + v.shape, np.float32)
        for k, v in batch.items():
            self._storage[k][self.position] = np.asarray(v, np.float32)
        self.position = (self.position + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.randint(0, self.size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}

    def __len__(self):
        return self.size


class ReplayMemoryTraj:
    """Stores whole rollouts and samples flattened transitions; the
    flattened view is cached and dropped on push."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self.rng = np.random.RandomState(seed)
        self.trajs: List[Dict[str, np.ndarray]] = []
        self.position = 0
        self._flat: Dict[str, np.ndarray] = None

    def push(self, traj: Dict[str, np.ndarray]):
        if len(self.trajs) < self.capacity:
            self.trajs.append(traj)
        else:
            self.trajs[self.position] = traj
        self.position = (self.position + 1) % self.capacity
        self._flat = None

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        if self._flat is None:
            self._flat = {k: np.concatenate([t[k] for t in self.trajs]) for k in self.trajs[0]}
        n = len(next(iter(self._flat.values())))
        idx = self.rng.randint(0, n, size=batch_size)
        return {k: v[idx] for k, v in self._flat.items()}

    def __len__(self):
        return len(self.trajs)
