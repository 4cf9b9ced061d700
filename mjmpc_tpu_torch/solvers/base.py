"""Solver core: sampling-MPC controllers as frozen configs plus plain
functions over an explicit state.

Counterpart of mjmpc_tpu/solvers/base.py. One solve (noise, N-particle
H-step rollout, distribution update, act, shift) is a sequence of device
operations with no host round trips: no .item(), .cpu() or float() on a
tensor, no host-to-device copy (constants are built once, on the solver's
device), and no linalg call that checks its info on the host.

Seeding: each consumer (tag) draws from Philox4x32-10 under the key
rng.stream_key(seed, tag), a host integer worked out once per (seed, tag),
with the state's `step` as the last counter word. `step` is a 0-d int64
tensor on the solver's device: a solve advances it by a device add, and the
noise kernels read it from device memory. So noise is a function of (seed,
tag, step), as in the JAX package's fold_in(key, tag, step); the same
solver state gives the same noise; no solve reads the step back to the
host or seeds a torch.Generator; and a solve captured as a CUDA graph draws
fresh noise on every replay. noise_impl "kernel" filters in the
filtered-noise kernel (ops.FilteredNoise); "plain" takes the same kernel's
normals unfiltered and colours and filters them with tensor operations
(ops.filtered_noise).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .. import ops, rng
from ..envs.base import Env
from ..rollout.engine import Trajectories, rollout_open_loop

# Seed-derivation tags (disjoint streams per consumer).
_TAG_ROLLOUT = 0
_TAG_ACT = 1
_TAG_SHIFT = 2


@dataclasses.dataclass(frozen=True)
class GaussianState:
    """Open-loop Gaussian control distribution state."""
    mean: torch.Tensor   # [H, dA]
    cov: torch.Tensor    # [dA, dA]
    step: torch.Tensor   # [] int64 on the device: solves taken so far
    seed: int            # base seed of the solver's streams


_TAGS = (_TAG_ROLLOUT, _TAG_ACT, _TAG_SHIFT)


@dataclasses.dataclass(frozen=True)
class GaussianBatch:
    """B GaussianStates stacked: the solver state of a batched solve
    (build_batched_solve_fn), the counterpart of the JAX package's
    jax.vmap(init_state) over B keys."""
    mean: torch.Tensor   # [B, H, dA]
    cov: torch.Tensor    # [B, dA, dA]
    step: torch.Tensor   # [B] int64 on the device
    # [3, B] int64 on the device: each element's stream keys, rows in _TAGS'
    # order (ops.key_tensor); made once here, so that a solve copies none
    keys: torch.Tensor
    seeds: Tuple[int, ...]

    @classmethod
    def stack(cls, states) -> "GaussianBatch":
        """The batch of `states` (GaussianStates of one solver)."""
        device = states[0].mean.device
        keys = torch.stack([ops.key_tensor([rng.stream_key(s.seed, tag) for s in states], device)
                            for tag in _TAGS])
        return cls(mean=torch.stack([s.mean for s in states]),
                   cov=torch.stack([s.cov for s in states]),
                   step=torch.stack([s.step for s in states]), keys=keys,
                   seeds=tuple(s.seed for s in states))

    def unstack(self) -> list:
        """The B GaussianStates (views of the batch's tensors)."""
        return [GaussianState(mean=self.mean[b], cov=self.cov[b], step=self.step[b], seed=seed)
                for b, seed in enumerate(self.seeds)]


NOISE_IMPLS = ("plain", "kernel")


def sample_filtered_noise(noise_impl: str, sampler: ops.FilteredNoise, key: int,
                          step: torch.Tensor, cov: torch.Tensor, shape: tuple,
                          filter_coeffs) -> torch.Tensor:
    """AR(2)-filtered N(0, cov) noise [*shape, dA] from the stream (key,
    step): the plain sampler ("plain", the JAX package's "xla") or the
    filtered-noise kernel `sampler` ("kernel", JAX's "pallas"); on CPU
    tensors both run their plain versions."""
    if noise_impl == "kernel":
        return sampler(key, step, cov, shape, filter_coeffs)
    return ops.filtered_noise(key, step, cov, shape, filter_coeffs)


@dataclasses.dataclass(frozen=True)
class GaussianMPC:
    """Base open-loop Gaussian MPC solver. Subclasses override
    `update(state, traj)` and `value(state, traj)`."""
    d_action: int
    horizon: int
    num_particles: int
    gamma: float = 1.0
    n_iters: int = 1
    step_size: float = 1.0
    init_cov: float = 1.0
    filter_coeffs: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    base_action: str = "null"            # random | null | repeat
    cov_type: str = "diagonal"           # diagonal | full (CEM, DMD)
    use_zero_control_seq: bool = False
    sample_mode: str = "mean"            # mean | sample
    noise_impl: str = "plain"            # plain | kernel (ops.FilteredNoise)
    # Action bounds, as the JAX config carries them; these solvers do not
    # read them (the env clips).
    action_lows: Optional[Any] = None
    action_highs: Optional[Any] = None
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        if self.noise_impl not in NOISE_IMPLS:
            raise ValueError(f"noise_impl must be one of {NOISE_IMPLS}, got "
                             f"{self.noise_impl!r}")

    # ---- derived constants ----------------------------------------------
    @property
    def gamma_seq(self) -> np.ndarray:
        return ops.gamma_sequence(self.gamma, self.horizon)

    @functools.cached_property
    def discount(self) -> torch.Tensor:
        """The [H, H] discount matrix on the solver's device, built once."""
        return ops.discount_matrix(self.gamma_seq, device=self.device)

    @functools.cached_property
    def noise_sampler(self) -> ops.FilteredNoise:
        """The filtered-noise kernel's wrapper (noise_impl "kernel")."""
        return ops.FilteredNoise()

    def build_constants(self) -> None:
        """Build the solve's device constants now, outside any solve, so
        that a solve copies nothing from the host."""
        self.discount

    @property
    def uses_observations(self) -> bool:
        """Whether update()/value() read traj.observations (gates the
        costs-only fused rollout)."""
        return False

    # ---- state lifecycle -------------------------------------------------
    def init_state(self, seed: int) -> GaussianState:
        """Zero mean, diagonal init_cov."""
        diag = torch.full((self.d_action,), float(self.init_cov),
                          device=self.device)
        return GaussianState(
            mean=torch.zeros((self.horizon, self.d_action), device=self.device),
            cov=torch.diag(diag), step=rng.step_tensor(0, self.device), seed=int(seed))

    def init_batch(self, seeds) -> GaussianBatch:
        """init_state of each seed, stacked."""
        return GaussianBatch.stack([self.init_state(seed) for seed in seeds])

    # ---- sampling --------------------------------------------------------
    def sample_noise(self, state: GaussianState) -> torch.Tensor:
        """AR(2)-filtered Gaussian noise [N, H, dA] from the noise_impl's
        stream (JAX base.py sample_noise)."""
        delta = sample_filtered_noise(
            self.noise_impl, self.noise_sampler, rng.stream_key(state.seed, _TAG_ROLLOUT),
            state.step, state.cov, (self.num_particles, self.horizon), self.filter_coeffs)
        if self.use_zero_control_seq:
            # the last particle probes the zero-action sequence
            delta[-1] = -state.mean
        return delta

    def sample_noise_batch(self, batch: GaussianBatch) -> torch.Tensor:
        """sample_noise of every element of `batch`, [B, N, H, dA], in one
        launch of the noise kernel (either noise_impl)."""
        keys, shape = batch.keys[_TAG_ROLLOUT], (self.num_particles, self.horizon)
        if self.noise_impl == "kernel":
            delta = self.noise_sampler.batch(keys, batch.step, batch.cov, shape,
                                             self.filter_coeffs)
        else:
            delta = ops.filtered_noise_batch(keys, batch.step, batch.cov, shape,
                                             self.filter_coeffs)
        if self.use_zero_control_seq:
            delta[:, -1] = -batch.mean
        return delta

    # ---- to override -----------------------------------------------------
    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        raise NotImplementedError

    def value(self, state: GaussianState, traj: Trajectories) -> torch.Tensor:
        raise NotImplementedError

    # ---- action selection / hotstart -----------------------------------
    def act(self, state: GaussianState, mode: Optional[str] = None) -> torch.Tensor:
        """First mean action, or a sampled perturbation of it."""
        mode = mode or self.sample_mode
        if mode == "mean":
            return state.mean[0]
        if mode == "sample":
            delta = ops.filtered_noise(rng.stream_key(state.seed, _TAG_ACT), state.step,
                                       state.cov, (1, 1), self.filter_coeffs)
            return state.mean[0] + delta.reshape(self.d_action)
        raise ValueError(f"unknown sample mode {mode!r}")

    def act_batch(self, batch: GaussianBatch) -> torch.Tensor:
        """act of every element of `batch`, [B, dA]."""
        if self.sample_mode == "mean":
            return batch.mean[:, 0]
        if self.sample_mode == "sample":
            delta = ops.filtered_noise_batch(batch.keys[_TAG_ACT], batch.step, batch.cov, (1, 1),
                                             self.filter_coeffs)
            return batch.mean[:, 0] + delta.reshape(-1, self.d_action)
        raise ValueError(f"unknown sample mode {self.sample_mode!r}")

    def shift(self, state: GaussianState, last: Optional[torch.Tensor] = None) -> GaussianState:
        """Hotstart: roll the mean left one step and set the last row to
        the base action ('repeat' repeats row -2 of the ROLLED mean), or to
        `last` where the caller drew it (the batched solve's random base
        actions, one launch for every element)."""
        mean = torch.roll(state.mean, -1, 0)
        if last is None:
            last = self._base_action(state, mean)
        mean[-1] = last
        return dataclasses.replace(state, mean=mean)

    def _base_action(self, state: GaussianState, rolled: torch.Tensor) -> torch.Tensor:
        """The shifted mean's last row: base_action's, of the rolled mean."""
        if self.base_action == "random":
            # as the reference does, init_cov (a variance) is the scale
            return self.init_cov * ops.standard_normals(
                rng.stream_key(state.seed, _TAG_SHIFT), state.step, (self.d_action,))
        if self.base_action == "null":
            return torch.zeros(self.d_action, device=rolled.device)
        if self.base_action == "repeat":
            return rolled[-2]
        raise ValueError(f"invalid base_action {self.base_action!r}")

    # ---- shared update helpers -------------------------------------------
    def _interp_mean(self, mean, target):
        """(1 - a) * mean + a * target, every controller's step-size blend."""
        return (1.0 - self.step_size) * mean + self.step_size * target


def open_loop_rollout(env: Env, uses_observations: bool, fused: Any = "auto"):
    """The rollout of an open-loop solve: rollout(env_params, env_state,
    mean [H, dA], noise [N, H, dA]) -> Trajectories.

    fused: use the env's fused rollout kernel. "auto" = yes when the env
    has the one the solver needs: `fused_obs_rollout` for a solver that
    reads observations (MPPIQ with a q_fn), `fused_rollout` for the rest.
    Pass False to plan against params other than the env's build-time
    params (the kernels bake the model constants).
    """
    kernel = env.fused_obs_rollout if uses_observations else env.fused_rollout
    if fused == "auto":
        fused = kernel is not None
    if not fused:
        return functools.partial(rollout_open_loop, env)
    if kernel is None:
        kind = "obs rollout" if uses_observations else "rollout"
        raise ValueError(f"env {env.name!r} has no fused {kind}")

    def rollout(env_params, env_state, mean, noise):
        out = kernel(env_params, env_state, mean, noise)
        obs, costs = out if uses_observations else (None, out)
        return Trajectories(observations=obs, actions=mean[None] + noise, costs=costs,
                            dones=None, next_observations=None, successes=None)

    return rollout


def build_solve_fn(solver: GaussianMPC, env: Env, calc_val: bool = False,
                   hotstart: bool = True, fused: Any = "auto"):
    """One full MPC solve.

    Returns solve(env_params, env_state, solver_state) ->
    (action [dA], value scalar tensor, new solver_state).

    fused: as for open_loop_rollout ("auto", True or False).
    """
    do_rollout = open_loop_rollout(env, solver.uses_observations, fused)
    solver.build_constants()

    def solve(env_params, env_state, solver_state: GaussianState):
        s = solver_state
        for _ in range(solver.n_iters):
            noise = solver.sample_noise(s)
            traj = do_rollout(env_params, env_state, s.mean, noise)
            s = solver.update(s, traj)

        action = solver.act(s)
        if calc_val:
            noise = solver.sample_noise(s)
            traj = do_rollout(env_params, env_state, s.mean, noise)
            value = solver.value(s, traj)
        else:
            value = torch.zeros((), device=s.mean.device)

        s = dataclasses.replace(s, step=s.step + 1)
        if hotstart:
            s = solver.shift(s)
        return action, value, s

    return solve


def check_batchable(solver: GaussianMPC, env: Env):
    """env's batched fused rollout, or NotImplementedError for a solver
    outside the Gaussian open-loop family or an env without one."""
    from .cem import CEM
    from .dmd import DMDMPC
    from .mppi import MPPI
    from .mppiq import MPPIQ
    from .random_shooting import RandomShooting
    if not isinstance(solver, (MPPI, RandomShooting, CEM, DMDMPC)) or isinstance(solver, MPPIQ):
        raise NotImplementedError(
            f"no batched solve for {type(solver).__name__}: only MPPI, RandomShooting, CEM "
            f"and DMDMPC have one; MPPIQ (with a Q, on kernel #3's batched entry), Reinforce "
            f"(on #4's), PFMPC, iLQR and the learned family, a batched update each, are still "
            f"to port (ROADMAP Queue 1 item 5)")
    batched = getattr(env.fused_rollout, "batched", None)
    if batched is None:
        raise NotImplementedError(
            f"env {env.name!r} has no batched fused rollout: kernels #1, #5, #6 and #7 have "
            f"batched entries; an env without a fused rollout (the general rollout: the "
            f"analytic envs, the continual reacher) has none (ROADMAP Queue 1 item 5)")
    return batched


def build_batched_solve_fn(solver: GaussianMPC, env: Env, calc_val: bool = False,
                           hotstart: bool = True):
    """B independent solves at once, the counterpart of the JAX package's
    jax.vmap(build_solve_fn(solver, env), in_axes=(None, 0, 0)).

    Returns solve(env_params, env_states, batch) -> (actions [B, dA],
    values [B], new GaussianBatch): env_states is env states stacked
    (stack_states), batch a GaussianBatch (solver.init_batch). On a CUDA
    device each iteration draws the noise of every element in one launch of
    the noise kernel (#2, sample_noise_batch) and rolls every element out
    in one launch of the env's fused rollout (the batched entry of #1, #5,
    #6 or #7), as the JAX batching rule lifts the batch into the Pallas
    grid; the solver's own update, value and shift run over the batch
    through torch.func.vmap, and
    act, the random base action and the step on batched tensors. Nothing is
    read to the host, so the solve can be captured in a CUDA graph. Element
    b's kernels equal the single solve's bit for bit; the vmapped reductions
    (softmax, weighted sums over N) may sum in another order, so its action
    and mean agree with the single solve's to rounding. On the CPU each
    element is the single solve (build_solve_fn), stacked.

    solve.vectorised is the batched path on any device (tests run it on the
    CPU against the JAX package). A solver outside MPPI, RandomShooting,
    CEM and DMDMPC, or an env whose fused rollout has no batched entry,
    raises NotImplementedError.
    """
    batched_rollout = check_batchable(solver, env)
    single = build_solve_fn(solver, env, calc_val=calc_val, hotstart=hotstart)
    solver.build_constants()

    def state(mean, cov, step):
        return GaussianState(mean=mean, cov=cov, step=step, seed=0)

    def traj(costs, actions):
        return Trajectories(observations=None, actions=actions, costs=costs, dones=None,
                            next_observations=None, successes=None)

    def fields(s):
        return s.mean, s.cov

    update = torch.func.vmap(lambda m, c, st, costs, acts: fields(
        solver.update(state(m, c, st), traj(costs, acts))))
    value = torch.func.vmap(lambda m, c, st, costs, acts: solver.value(
        state(m, c, st), traj(costs, acts)))
    random_base = solver.base_action == "random"
    shift = torch.func.vmap(lambda m, c, st, last: fields(solver.shift(state(m, c, st), last)),
                            in_dims=(0, 0, 0, 0 if random_base else None))

    def rollout(env_params, env_states, b: GaussianBatch):
        noise = solver.sample_noise_batch(b)
        costs = batched_rollout(env_params, env_states, b.mean, noise)
        return costs, b.mean[:, None] + noise

    def vectorised(env_params, env_states, b: GaussianBatch):
        for _ in range(solver.n_iters):
            costs, actions = rollout(env_params, env_states, b)
            mean, cov = update(b.mean, b.cov, b.step, costs, actions)
            b = dataclasses.replace(b, mean=mean, cov=cov)
        action = solver.act_batch(b)
        if calc_val:
            costs, actions = rollout(env_params, env_states, b)
            val = value(b.mean, b.cov, b.step, costs, actions)
        else:
            val = torch.zeros(b.mean.shape[:1], device=b.mean.device)
        b = dataclasses.replace(b, step=b.step + 1)
        if hotstart:
            # a random base action as shift draws it (init_cov the scale),
            # one launch for every element; the others shift computes
            last = (solver.init_cov * ops.standard_normals_batch(
                b.keys[_TAG_SHIFT], b.step, solver.d_action) if random_base else None)
            mean, cov = shift(b.mean, b.cov, b.step, last)
            b = dataclasses.replace(b, mean=mean, cov=cov)
        return action, val, b

    def solve(env_params, env_states, b: GaussianBatch):
        if b.mean.device.type == "cpu":
            outs = [single(env_params, map_tensors(lambda t: t[i], env_states), s)
                    for i, s in enumerate(b.unstack())]
            new = [o[2] for o in outs]
            return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
                    dataclasses.replace(b, mean=torch.stack([s.mean for s in new]),
                                        cov=torch.stack([s.cov for s in new]),
                                        step=torch.stack([s.step for s in new])))
        with ops.control.capturable_linalg(b.mean.device):
            return vectorised(env_params, env_states, b)

    solve.vectorised = vectorised
    return solve


def stack_states(states):
    """B states of one structure (env states, solver states) stacked: every
    tensor leaf on a new leading axis; every other field the first
    state's."""
    return map_tensors(lambda *xs: torch.stack(xs), states[0], *states[1:])


def tensor_leaves(x, prefix: str = "") -> dict:
    """{path: tensor} of every tensor in a solver state: the tensor fields
    of a dataclass and, nested in them, the fields of NamedTuples and the
    items of tuples and lists (the learned-model solvers' parameters and
    layer lists), each under its dotted path."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    if dataclasses.is_dataclass(x):
        items = [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        items = list(zip(x._fields, x))
    elif isinstance(x, (tuple, list)):
        items = list(enumerate(x))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(tensor_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def map_tensors(fn, x, *others):
    """x with every tensor leaf t replaced by fn(t, *the same leaf of each
    of `others`), which share x's structure; other values as in x."""
    if isinstance(x, torch.Tensor):
        return fn(x, *others)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: map_tensors(fn, getattr(x, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        items = [map_tensors(fn, v, *(o[i] for o in others)) for i, v in enumerate(x)]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def guard_finite(solve, solver):
    """Failure-recovery wrapper (JAX base.py guard_finite): when a solve
    gives a non-finite action, value or state tensor (a diverged rollout, a
    collapsed covariance), play a zero action with value 0 and reset the
    solver's state; `step` advances in every case. Tensors nested in the
    state (the learned-model solvers' parameters) are checked and reset
    with the rest.

    The check is one device-side boolean and the choice a torch.where per
    tensor, and the step advances by a device add, so the guard reads
    nothing back to the host and can be captured in a CUDA graph with the
    solve. The reset state is `solver.reset_state(seed, step)` where the
    solver has one (SoftQMPC, RandomShootingNN: fresh parameters drawn on
    the device from Philox at the state's step, so resets at different
    steps draw different parameters, as the JAX guard's
    init_state(fold_in(key, step)) does), else init_state(seed), which
    builds the fresh tensors with device fills. Over a GaussianBatch (a
    batched solve, build_batched_solve_fn) each element is checked and
    reset on its own (_guarded_batch). A host-integer seed cannot
    be chosen on the device without a sync, so the reset state keeps the
    solver state's `seed`; noise streams are keyed by (seed, tag, step) and
    step advances anyway, so the next solve's noise is still fresh.
    """
    reset = getattr(solver, "reset_state", None)

    def guarded(env_params, env_state, solver_state):
        if isinstance(solver_state, GaussianBatch):
            return _guarded_batch(solve, solver, env_params, env_state, solver_state)
        action, value, new_state = solve(env_params, env_state, solver_state)
        ok = torch.isfinite(action).all() & torch.isfinite(value).all()
        names = [f.name for f in dataclasses.fields(new_state) if f.name != "step"]
        for name in names:
            for x in tensor_leaves(getattr(new_state, name)).values():
                if x.is_floating_point():
                    ok = ok & torch.isfinite(x).all()
        fresh = (reset(solver_state.seed, solver_state.step) if reset is not None
                 else solver.init_state(solver_state.seed))
        where = lambda good, bad: torch.where(ok, good, bad)
        recovered = dataclasses.replace(
            new_state, step=solver_state.step + 1,
            **{k: map_tensors(where, getattr(new_state, k), getattr(fresh, k)) for k in names})
        return (torch.where(ok, action, torch.zeros_like(action)),
                torch.where(ok, value, torch.zeros_like(value)), recovered)

    return guarded


def _guarded_batch(solve, solver: GaussianMPC, env_params, env_states, batch: GaussianBatch):
    """guard_finite over a batched solve (build_batched_solve_fn): each
    element is checked on its own ([B] booleans on the device), and only
    the elements that failed play a zero action with value 0 and take their
    solver's init_state (a zero mean, init_cov on the diagonal; their seeds
    and stream keys kept); every element's step advances. Element b's
    result is guard_finite's on element b's single solve."""
    action, value, new = solve(env_params, env_states, batch)
    dims = lambda x: tuple(range(1, x.dim()))
    ok = (torch.isfinite(action).all(-1) & torch.isfinite(value)
          & torch.isfinite(new.mean).all(dims(new.mean)) & torch.isfinite(new.cov).all(dims(new.cov)))
    fresh = solver.init_state(batch.seeds[0])
    where = lambda good, bad: torch.where(ok.reshape((-1,) + (1,) * (good.dim() - 1)), good, bad)
    recovered = dataclasses.replace(new, mean=where(new.mean, fresh.mean),
                                    cov=where(new.cov, fresh.cov), step=batch.step + 1)
    return (where(action, torch.zeros_like(action)), where(value, torch.zeros_like(value)),
            recovered)


def build_optimal_value_fn(solver: GaussianMPC, env: Env):
    """State-value estimate: a full solve with calc_val from a fresh
    control distribution and no hotstart.

    Returns value(env_params, env_state, seed) -> scalar tensor.
    """
    solve = build_solve_fn(solver, env, calc_val=True, hotstart=False)

    def value(env_params, env_state, seed: int):
        _, val, _ = solve(env_params, env_state, solver.init_state(seed))
        return val

    return value


def evaluate_episode(solver: GaussianMPC, env: Env, episode_length: int,
                     calc_val: bool = False):
    """Closed-loop episode with MPC in the loop, as a Python loop over steps.

    Returns episode(env_params, seed) -> dict(reward [T], action [T, dA],
    value [T], done [T], success [T]) of tensors on the env's device.
    """
    solve = build_solve_fn(solver, env, calc_val=calc_val)

    def episode(env_params, seed: int):
        env_state = env.init(env_params, rng.derive_seed(seed, 0))
        solver_state = solver.init_state(rng.derive_seed(seed, 1))
        out = dict(reward=[], action=[], value=[], done=[], success=[])
        for _ in range(episode_length):
            action, value, solver_state = solve(env_params, env_state,
                                                solver_state)
            action = env.clip_action(action)
            env_state, _, reward, done = env.step(env_params, env_state, action)
            succ = (env.success(env_params, env_state)
                    if env.success is not None
                    else torch.zeros((), dtype=torch.bool, device=env.device))
            for key, val in zip(out, (reward, action, value, done, succ)):
                out[key].append(val)
        return {k: torch.stack(v) for k, v in out.items()}

    return episode
