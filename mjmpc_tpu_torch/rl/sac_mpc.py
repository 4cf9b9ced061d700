"""SAC-augmented MPC: MPPIQ guided by a SAC-learned twin Q.

Counterpart of mjmpc_tpu/rl/sac_mpc.py (reference
softqmpc/algs/sac_mpc.py): MPC collects transitions, SAC trains on them,
and the learned -min(Q1, Q2) (MPPIQ consumes costs, SAC maximises
rewards) is the Q estimate of MPPIQ's blended returns. With a Q plugged,
MPPIQ reads observations, so on an env with an obs-emitting rollout kernel
(reacher_7dof-v0: kernel #3) the solve goes through it.

The live Q params are an argument of every solve (solve_with_q,
control_step): the call copies them into the buffers the planner's q_fn
reads, on the device, so every SAC update reaches the next solve. A control step is solve, clip and
env step on the device; only the replay push reads back to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import rng, solvers
from .replay import ReplayMemory
from .sac import SAC, SACParams


@dataclasses.dataclass
class SACMPC:
    env: object
    horizon: int = 16
    num_particles: int = 256
    beta: float = 0.5
    td_lam: float = 0.9
    gamma: float = 0.99
    init_cov: float = 1.0
    batch_size: int = 128
    updates_per_step: int = 1
    replay_capacity: int = 100_000
    seed: int = 0

    def __post_init__(self):
        env = self.env
        self.device = env.device
        self.sac = SAC(d_obs=env.d_obs, d_action=env.d_action, gamma=self.gamma)
        self.sac_params: SACParams = self.sac.init_params(
            rng.generator(rng.derive_seed(self.seed, 0), "cpu"), self.device)
        # the actor's normals in the SAC updates
        self.generator = rng.generator(rng.derive_seed(self.seed, 1), self.device)
        self.memory = ReplayMemory(self.replay_capacity, seed=self.seed)
        self.update_info = []      # one dict of 0-d device tensors per SAC update
        self._episodes = 0
        self._build_solver()

    def q_fn_of(self, q_params):
        """MPPIQ's q_fn for the twin Q `q_params`: -min(Q1, Q2) over
        observations [N, H, dO] and actions [N, H, dA]."""
        env, critic = self.env, self.sac.critic

        def q_fn(obs, acts):
            q = critic.min_q(q_params, obs.reshape(-1, env.d_obs),
                             acts.reshape(-1, env.d_action))
            return -q.reshape(obs.shape[:-1])

        return q_fn

    def _build_solver(self):
        env = self.env
        self.solver = solvers.MPPIQ(
            d_action=env.d_action, horizon=self.horizon, num_particles=self.num_particles,
            beta=self.beta, td_lam=self.td_lam, gamma=self.gamma, init_cov=self.init_cov,
            step_size=0.55, filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat",
            device=self.device)
        # One solver with a Q plugged, so that its constants and its choice
        # of the obs rollout are made once. Its q_fn reads device buffers
        # of the Q's shapes, and every solve first copies the Q params it
        # is given into them on the device's stream: a later call, or a
        # CUDA graph captured over solve_with_q, reads the params of its
        # own call, never those of an earlier one.
        live = solvers.map_tensors(torch.clone, self.sac_params.q)
        solve = solvers.make_solve_fn(
            dataclasses.replace(self.solver, q_fn=self.q_fn_of(live)), env)

        def solve_with_q(env_params, env_state, solver_state, q_params):
            solvers.map_tensors(lambda buf, q: buf.copy_(q), live, q_params)
            return solve(env_params, env_state, solver_state)

        def control_step(env_params, env_state, solver_state, q_params):
            obs = env.observe(env_params, env_state)
            action, _, solver_state = solve_with_q(env_params, env_state, solver_state,
                                                   q_params)
            action = env.clip_action(action)
            env_state, next_obs, reward, _ = env.step(env_params, env_state, action)
            return env_state, solver_state, obs, action, next_obs, reward

        self.solve_with_q = solve_with_q
        self.control_step = control_step
        self.solver_state = self.solver.init_state(rng.derive_seed(self.seed, 2))

    def _reset(self):
        """A new episode: the env's start and the solver's state from the
        episode counter."""
        k = self._episodes
        self._episodes += 1
        self.solver_state = self.solver.init_state(rng.derive_seed(self.seed, 3, k))
        return self.env.init(self.env.params, rng.derive_seed(self.seed, 4, k))

    def train(self, n_steps: int, episode_length: int = 200, min_buffer: int = 500):
        """Interleaved MPC control and SAC updates (updates_per_step once
        the buffer holds min_buffer transitions). Returns the episode
        rewards of the episodes that ended."""
        env = self.env
        ep_rewards, ep_reward, t = [], 0.0, 0
        env_state = self._reset()
        for _ in range(n_steps):
            env_state, self.solver_state, obs, action, next_obs, reward = self.control_step(
                env.params, env_state, self.solver_state, self.sac_params.q)
            host = [x.cpu().numpy() for x in (obs, action, reward, next_obs)]
            self.memory.push(host[0], host[1], float(host[2]), host[3], False)
            ep_reward += float(host[2])
            t += 1
            if len(self.memory) >= min_buffer:
                for _ in range(self.updates_per_step):
                    batch = {k: torch.as_tensor(v, device=self.device)
                             for k, v in self.memory.sample(self.batch_size).items()}
                    self.sac_params, info = self.sac.update(self.sac_params, batch,
                                                            self.generator)
                    self.update_info.append(info)
            if t >= episode_length:
                ep_rewards.append(ep_reward)
                ep_reward, t = 0.0, 0
                env_state = self._reset()
        return ep_rewards
