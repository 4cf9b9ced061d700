"""The one bridge from the JAX package's data to the port's.

Plain functions over numpy arrays, or objects whose fields convert with
np.asarray (a JAX ChainModel, GaussianState, ReacherState, PegParams,
PegState, ReinforceState, VFParams, LGPolicyParams, SwimmerParams,
CheetahParams, SwimmerState, CheetahState, PenParams, PenState,
RelocateParams, RelocateState, HammerParams, HammerState, PusherParams,
PusherState, the sawyer and the hand DoorParams and DoorState,
TrayGlassParams, TrayGlassState, PendulumParams, PendulumState, LQRParams,
LQRState, PointMassParams, PointMassState, CartpoleParams, CartpoleState,
MazeParams, MazeState, AcrobotParams, AcrobotState, TrajoptReacherParams,
TrajoptReacherState, ILQRState, QuadraticQParams, an MLP or ensemble layer
list, SACParams, SoftQState or RSNNState does;
models with ball and free joints keep the JAX layout: qpos [nq] with
quaternions in wxyz order, per-DOF arrays [nv], limits [nq]). This module
never imports jax; tests use it so that both packages compute on the same
model and state.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .engine import chain as rb
from .engine.chain import ChainModel
from .envs import acrobot, cartpole, lqr, maze, point_mass, trajopt_reacher
from .envs.half_cheetah import CheetahParams, CheetahState
from .envs import half_cheetah, hammer, hand_door, pen, relocate, sawyer_tasks, swimmer
from .envs.hammer import HammerParams, HammerState
from .envs.panda_tasks import TrayGlassParams, TrayGlassState
from .envs.pen import PenParams, PenState
from .envs.pendulum import PendulumParams, PendulumState
from .envs.reacher_7dof import ReacherState
from .envs.relocate import RelocateParams, RelocateState
from .envs.sawyer_tasks import PegParams, PegState
from .envs.swimmer import _VEL_LIMIT, SwimmerParams, SwimmerState
from .models import EnsembleLayerParams, MLPLayerParams, QuadraticQParams
from .ops.pendulum import PARAM_FIELDS as _PENDULUM_FIELDS
from .policies.linear_gaussian import LGPolicyParams
from .rl.sac import SACParams, adam_init
from .solvers.base import GaussianState
from .solvers.ilqr import ILQRState
from .solvers.random_shooting_nn import RSNNState
from .solvers.softq import SoftQState
from .solvers.reinforce import ReinforceState
from .value_functions import VFParams

_MODEL_TENSORS = ("joint_axis", "body_pos", "mass", "com", "inertia",
                  "armature", "damping", "frictionloss", "stiffness", "gear",
                  "qpos_low", "qpos_high", "gravity", "site_pos")


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _timestep(x, device) -> torch.Tensor:
    """A reference timestep (int32, any shape) as the port's int64 tensor."""
    return torch.as_tensor(np.array(x, np.int64), device=device)


def chain_model_from_reference(model, device="cuda") -> ChainModel:
    """A reference ChainModel (array leaves plus static topology) as the
    port's ChainModel on `device`."""
    tensors = {k: _t(getattr(model, k), device) for k in _MODEL_TENSORS}
    return ChainModel(
        **tensors, parent=tuple(int(p) for p in model.parent),
        joint_types=tuple(str(t) for t in model.joint_types),
        dt=float(model.dt), site_body=int(model.site_body))


def gaussian_state_from_reference(state, seed: int = 0,
                                  device="cuda") -> GaussianState:
    """A reference GaussianState (mean, cov, step, key) as the port's.
    The reference PRNG key has no torch counterpart: the port's streams
    start from `seed`."""
    return GaussianState(mean=_t(state.mean, device), cov=_t(state.cov, device),
                         step=rng.step_tensor(int(np.asarray(state.step)), device),
                         seed=int(seed))


def reacher_state_from_reference(state, seed: int = 0,
                                 device="cuda") -> ReacherState:
    """A reference ReacherState (qpos, qvel, target, timestep, key) as the
    port's; continual target events draw from `seed`."""
    return ReacherState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                        target=_t(state.target, device),
                        timestep=_timestep(state.timestep, device), seed=int(seed))


def peg_params_from_reference(params, device="cuda") -> PegParams:
    """A reference PegParams (model, hole entry, axis, depth, sensor bias)
    as the port's."""
    return PegParams(model=chain_model_from_reference(params.model, device),
                     hole_entry=_t(params.hole_entry, device),
                     hole_axis=_t(params.hole_axis, device),
                     hole_depth=_t(params.hole_depth, device),
                     sensor_bias=_t(params.sensor_bias, device))


def peg_state_from_reference(state, device="cuda") -> PegState:
    """A reference PegState (qpos, qvel, timestep) as the port's."""
    return PegState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                    timestep=_timestep(state.timestep, device))


def reinforce_state_from_reference(state, seed: int = 0, device="cuda") -> ReinforceState:
    """A reference ReinforceState as the port's; the port's streams start
    from `seed` (the reference PRNG key has no torch counterpart)."""
    return ReinforceState(mean_weights=_t(state.mean_weights, device),
                          cov_diag=_t(state.cov_diag, device),
                          vf_weights=_t(state.vf_weights, device),
                          vf_bias=_t(state.vf_bias, device),
                          fit_error=_t(state.fit_error, device),
                          step=rng.step_tensor(int(np.asarray(state.step)), device),
                          seed=int(seed))


def vf_params_from_reference(params, device="cuda") -> VFParams:
    return VFParams(weights=_t(params.weights, device), bias=_t(params.bias, device))


def lg_policy_params_from_reference(params, device="cuda") -> LGPolicyParams:
    return LGPolicyParams(weight=_t(params.weight, device), bias=_t(params.bias, device),
                          log_std=_t(params.log_std, device))


def swimmer_params_from_reference(params, device="cuda") -> SwimmerParams:
    """A reference SwimmerParams (model, drag_perp, drag_par) as the
    port's; the velocity limit is the env's constant."""
    return SwimmerParams(model=chain_model_from_reference(params.model, device),
                         drag_perp=_t(params.drag_perp, device),
                         drag_par=_t(params.drag_par, device),
                         vel_limit=_t(_VEL_LIMIT, device),
                         bodies=rb.constant(swimmer._POINT_BODIES, device))


def cheetah_params_from_reference(params, device="cuda") -> CheetahParams:
    """A reference CheetahParams (model, kp, kd, mu) as the port's."""
    return CheetahParams(model=chain_model_from_reference(params.model, device),
                         kp=_t(params.kp, device), kd=_t(params.kd, device),
                         mu=_t(params.mu, device),
                         bodies=rb.constant(half_cheetah._CONTACT_BODIES, device))


def loco_state_from_reference(state, device="cuda"):
    """A reference SwimmerState or CheetahState (qpos, qvel) as the port's
    state of the same env (told apart by the number of dofs: 7 or 9)."""
    qpos, qvel = _t(state.qpos, device), _t(state.qvel, device)
    cls = SwimmerState if qpos.shape[-1] == 7 else CheetahState
    return cls(qpos=qpos, qvel=qvel)


def pen_params_from_reference(params, device="cuda") -> PenParams:
    """A reference PenParams (the hand and free-pen model, kp, kd, mu, pen
    radius) as the port's."""
    return PenParams(model=chain_model_from_reference(params.model, device),
                     kp=_t(params.kp, device), kd=_t(params.kd, device),
                     mu=_t(params.mu, device), pen_r=_t(params.pen_r, device),
                     consts=pen.constants(device))


def pen_state_from_reference(state, device="cuda") -> PenState:
    """A reference PenState (qpos [31] with the pen's quaternion in wxyz
    order, qvel [30], desired [3], timestep) as the port's."""
    return PenState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                    desired=_t(state.desired, device),
                    timestep=_timestep(state.timestep, device))


def relocate_params_from_reference(params, device="cuda") -> RelocateParams:
    """A reference RelocateParams (the arm, hand and free-ball model, kp,
    kd, mu, ball radius) as the port's."""
    return RelocateParams(model=chain_model_from_reference(params.model, device),
                          kp=_t(params.kp, device), kd=_t(params.kd, device),
                          mu=_t(params.mu, device), ball_r=_t(params.ball_r, device),
                          consts=relocate.constants(device))


def relocate_state_from_reference(state, device="cuda") -> RelocateState:
    """A reference RelocateState (qpos [34] with the ball's quaternion in
    wxyz order, qvel [33], target [3], timestep) as the port's."""
    return RelocateState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                         target=_t(state.target, device),
                         timestep=_timestep(state.timestep, device))


def hammer_params_from_reference(params, device="cuda") -> HammerParams:
    """A reference HammerParams (the arm, hand, free-hammer and nail model,
    kp, kd, mu) as the port's."""
    return HammerParams(model=chain_model_from_reference(params.model, device),
                        kp=_t(params.kp, device), kd=_t(params.kd, device),
                        mu=_t(params.mu, device), consts=hammer.constants(device))


def hammer_state_from_reference(state, device="cuda") -> HammerState:
    """A reference HammerState (qpos [35] with the hammer's quaternion in
    wxyz order, qvel [34], timestep) as the port's."""
    return HammerState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                       timestep=_timestep(state.timestep, device))


def pusher_params_from_reference(params, device="cuda") -> sawyer_tasks.PusherParams:
    """A reference PusherParams (the arm and block model, k_contact) as the
    port's."""
    return sawyer_tasks.PusherParams(model=chain_model_from_reference(params.model, device),
                                     k_contact=_t(params.k_contact, device),
                                     bodies=rb.constant((sawyer_tasks.HAND_BODY,
                                                         sawyer_tasks.BLOCK_BODY), device))


def pusher_state_from_reference(state, device="cuda") -> sawyer_tasks.PusherState:
    """A reference PusherState (qpos [9], qvel [9], target [2], timestep) as
    the port's."""
    return sawyer_tasks.PusherState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                                    target=_t(state.target, device),
                                    timestep=_timestep(state.timestep, device))


def sawyer_door_params_from_reference(params, device="cuda") -> sawyer_tasks.DoorParams:
    """A reference sawyer DoorParams (the arm and door model, k_grab,
    grab_radius, target_angle) as the port's."""
    return sawyer_tasks.DoorParams(model=chain_model_from_reference(params.model, device),
                                   k_grab=_t(params.k_grab, device),
                                   grab_radius=_t(params.grab_radius, device),
                                   target_angle=_t(params.target_angle, device),
                                   handle_local=rb.constant(sawyer_tasks.HANDLE_LOCAL, device))


def sawyer_door_state_from_reference(state, device="cuda") -> sawyer_tasks.DoorState:
    """A reference sawyer DoorState (qpos [8], qvel [8], timestep) as the
    port's."""
    return sawyer_tasks.DoorState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                                  timestep=_timestep(state.timestep, device))


def tray_params_from_reference(params, device="cuda") -> TrayGlassParams:
    """A reference TrayGlassParams (the arm, tray and glass model, the fall
    penalty) as the port's."""
    return TrayGlassParams(model=chain_model_from_reference(params.model, device),
                           fall_penalty=_t(params.fall_penalty, device))


def tray_state_from_reference(state, device="cuda") -> TrayGlassState:
    """A reference TrayGlassState (qpos [9], qvel [9], target [3], timestep)
    as the port's."""
    return TrayGlassState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                          target=_t(state.target, device),
                          timestep=_timestep(state.timestep, device))


def hand_door_params_from_reference(params, device="cuda") -> hand_door.DoorParams:
    """A reference door-v0 DoorParams (the arm, hand, door and latch model,
    kp, kd, mu) as the port's."""
    return hand_door.DoorParams(model=chain_model_from_reference(params.model, device),
                                kp=_t(params.kp, device), kd=_t(params.kd, device),
                                mu=_t(params.mu, device), consts=hand_door.constants(device))


def hand_door_state_from_reference(state, device="cuda") -> hand_door.DoorState:
    """A reference door-v0 DoorState (qpos [29], qvel [29], timestep) as the
    port's."""
    return hand_door.DoorState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
                               timestep=_timestep(state.timestep, device))


def pendulum_params_from_reference(params, device="cuda") -> PendulumParams:
    """A reference PendulumParams (g, m, l, dt, max_speed, max_torque) as
    the port's, 0-d float32 tensors."""
    return PendulumParams(**{f: _t(getattr(params, f), device)
                             for f in _PENDULUM_FIELDS})


def pendulum_state_from_reference(state, device="cuda") -> PendulumState:
    """A reference PendulumState (th, thdot; any leading batch shape) as the
    port's."""
    return PendulumState(th=_t(state.th, device), thdot=_t(state.thdot, device))


def lqr_params_from_reference(params, device="cuda") -> lqr.LQRParams:
    """A reference LQRParams (A, B, Q, R) as the port's."""
    return lqr.LQRParams(**{k: _t(getattr(params, k), device) for k in "ABQR"})


def lqr_state_from_reference(state, device="cuda") -> lqr.LQRState:
    return lqr.LQRState(x=_t(state.x, device))


def point_mass_params_from_reference(params, device="cuda") -> point_mass.PointMassParams:
    """A reference PointMassParams (dt, mass, goal) as the port's."""
    return point_mass.PointMassParams(dt=_t(params.dt, device), mass=_t(params.mass, device),
                                      goal=_t(params.goal, device))


def point_mass_state_from_reference(state, device="cuda") -> point_mass.PointMassState:
    return point_mass.PointMassState(pos=_t(state.pos, device), vel=_t(state.vel, device))


def cartpole_params_from_reference(params, device="cuda") -> cartpole.CartpoleParams:
    """A reference CartpoleParams as the port's, 0-d float32 tensors."""
    return cartpole.CartpoleParams(**{f: _t(getattr(params, f), device)
                                      for f in cartpole.PARAM_FIELDS})


def cartpole_state_from_reference(state, device="cuda") -> cartpole.CartpoleState:
    """A reference CartpoleState (x, x_dot, theta, theta_dot; any leading
    batch shape) as the port's."""
    return cartpole.CartpoleState(x=_t(state.x, device), x_dot=_t(state.x_dot, device),
                                  theta=_t(state.theta, device),
                                  theta_dot=_t(state.theta_dot, device))


def maze_params_from_reference(params, device="cuda") -> maze.MazeParams:
    """A reference MazeParams (obstacles, continual_period) as the port's;
    the period becomes a host integer."""
    return maze.MazeParams(obstacles=_t(params.obstacles, device),
                           continual_period=int(np.asarray(params.continual_period)))


def maze_state_from_reference(state, key: int = 0, device="cuda") -> maze.MazeState:
    """A reference MazeState (pos, vel, goal, timestep, key) as the port's:
    the goal is kept; the reference PRNG key has no torch counterpart, so
    the port's goal draws take the host key `key`."""
    t = np.asarray(state.timestep).astype(np.int64)
    return maze.MazeState(pos=_t(state.pos, device), vel=_t(state.vel, device),
                          goal=_t(state.goal, device),
                          timestep=torch.as_tensor(t, device=device), key=int(key))


def acrobot_params_from_reference(params, device="cuda") -> acrobot.AcrobotParams:
    return acrobot.AcrobotParams(model=chain_model_from_reference(params.model, device))


def acrobot_state_from_reference(state, device="cuda") -> acrobot.AcrobotState:
    return acrobot.AcrobotState(qpos=_t(state.qpos, device), qvel=_t(state.qvel, device))


def trajopt_reacher_params_from_reference(params, device="cuda"
                                          ) -> trajopt_reacher.TrajoptReacherParams:
    return trajopt_reacher.TrajoptReacherParams(
        model=chain_model_from_reference(params.model, device))


def trajopt_reacher_state_from_reference(state, device="cuda"
                                         ) -> trajopt_reacher.TrajoptReacherState:
    """A reference TrajoptReacherState (qpos, qvel, target, timestep) as the
    port's."""
    return trajopt_reacher.TrajoptReacherState(
        qpos=_t(state.qpos, device), qvel=_t(state.qvel, device),
        target=_t(state.target, device), timestep=_timestep(state.timestep, device))


def ilqr_state_from_reference(state, seed: int = 0, device="cuda") -> ILQRState:
    """A reference ILQRState (mean, step, key) as the port's; the port's
    streams start from `seed`."""
    return ILQRState(mean=_t(state.mean, device),
                     step=rng.step_tensor(int(np.asarray(state.step)), device), seed=int(seed))


def quadratic_q_params_from_reference(params, device="cuda") -> QuadraticQParams:
    """A reference QuadraticQParams (l_packed, j, c) as the port's."""
    return QuadraticQParams(l_packed=_t(params.l_packed, device), j=_t(params.j, device),
                            c=_t(params.c, device))


def mlp_params_from_reference(layers, device="cuda"):
    """A reference MLP's layer list (weight [in, out], bias [out]) as the
    port's list of MLPLayerParams."""
    return [MLPLayerParams(weight=_t(lyr.weight, device), bias=_t(lyr.bias, device))
            for lyr in layers]


def ensemble_params_from_reference(layers, device="cuda"):
    """A reference EnsembleMLP's layer list (weight [E, in, out], bias [E,
    1, out]) as the port's list of EnsembleLayerParams."""
    return [EnsembleLayerParams(weight=_t(lyr.weight, device), bias=_t(lyr.bias, device))
            for lyr in layers]


def sac_params_from_reference(params, device="cuda") -> SACParams:
    """A reference SACParams' networks and log_alpha as the port's, with
    fresh optimiser states (the optax states are not carried over)."""
    policy = mlp_params_from_reference(params.policy, device)
    q = tuple(mlp_params_from_reference(net, device) for net in params.q)
    log_alpha = _t(params.log_alpha, device)
    return SACParams(policy=policy, q=q,
                     q_target=tuple(mlp_params_from_reference(net, device)
                                    for net in params.q_target),
                     log_alpha=log_alpha, policy_opt=adam_init(policy), q_opt=adam_init(q),
                     alpha_opt=adam_init(log_alpha))


def softq_state_from_reference(state, seed: int = 0, device="cuda") -> SoftQState:
    """A reference SoftQState as the port's; the port's streams start from
    `seed` (the reference PRNG key has no torch counterpart)."""
    return SoftQState(q_params=quadratic_q_params_from_reference(state.q_params, device),
                      step=rng.step_tensor(int(np.asarray(state.step)), device), seed=int(seed))


def rsnn_state_from_reference(state, seed: int = 0, device="cuda") -> RSNNState:
    """A reference RSNNState as the port's; the port's streams start from
    `seed`."""
    return RSNNState(mean=_t(state.mean, device),
                     policy_params=mlp_params_from_reference(state.policy_params, device),
                     step=rng.step_tensor(int(np.asarray(state.step)), device), seed=int(seed))
