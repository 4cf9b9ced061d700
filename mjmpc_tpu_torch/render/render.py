"""Env renderers: the geometry of each frame, then its pixels.

Counterpart of mjmpc_tpu/render/render.py. One geometry function per JAX
renderer: it takes one episode's env state with [F, ...] tensors (the
frames to draw) and returns one raster.Scene per frame, its primitives in
world coordinates in the order the JAX renderer adds its matplotlib
artists, and its axes limits. raster.draw turns a scene into pixels.

Forward kinematics runs once per episode, batched over the frames, on the
states' device, in float64 (the JAX renderer makes one float32 FK call
per frame), so frames drawn from states on the card equal those drawn
from the same states on the CPU.

One renderer differs from the JAX package's: the pusher's target is the
block's goal (x, y) on the plane of its slides (z = 0, BLOCK_BASE), and
the port draws it there; the JAX renderer indexes the side view's z of
that 2-vector and raises IndexError.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine import chain as rb
from ..envs import hammer, hand_door, pen, relocate
from . import gif, raster
from .raster import Disc, HLine, Line, Rect, Scene

_DOOR_EDGE = (-0.30, 0.0, 0.0)     # the panel's free edge in the door's frame


def _field(state, name: str) -> torch.Tensor:
    x = getattr(state, name)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _host(state, name: str) -> np.ndarray:
    return _field(state, name).detach().cpu().numpy().astype(np.float64)


def _fk(model: rb.ChainModel, state):
    """(rots [F, n, 3, 3], poss [F, n, 3]) as float64 numpy, from one FK
    call on the device of the state's qpos."""
    qpos = _field(state, "qpos")
    m = dataclasses.replace(model, **{
        f.name: getattr(model, f.name).to(qpos.device, torch.float64)
        for f in dataclasses.fields(model)
        if isinstance(getattr(model, f.name), torch.Tensor)
        and getattr(model, f.name).is_floating_point()})
    rots, poss = rb.forward_kinematics(m, qpos.to(torch.float64))
    return rots.cpu().numpy(), poss.cpu().numpy()


def _leading(state) -> int:
    """The length of the leading axis of the state's arrays."""
    return next(getattr(state, f.name).shape[0] for f in dataclasses.fields(state)
                if isinstance(getattr(state, f.name), (np.ndarray, torch.Tensor)))


def _bones(model: rb.ChainModel, poss, plane, first: int = 0, hinges_only: bool = False):
    """A segment from each body's parent frame (or the origin) to its own,
    "-o", tab:blue, markersize 3, linewidth 2."""
    a, b = plane
    out = []
    for i in range(first, len(model.parent)):
        if hinges_only and model.joint_types[i] != "hinge":
            continue
        pi = model.parent[i]
        p0 = np.zeros(3) if pi < 0 else poss[pi]
        out.append(Line(np.array([[p0[a], p0[b]], [poss[i][a], poss[i][b]]]), "tab:blue",
                        width=2, marker="o", marker_size=3))
    return out


def _star(p) -> Line:
    return Line(np.array([[p[0], p[1]]]), "green", style="", marker="*", marker_size=14)


def _ground() -> HLine:
    return HLine(0.0, "k", 0.5)


def _render_pendulum(env, st) -> List[Scene]:
    th = _host(st, "th")
    return [Scene((-1.4, 1.4), (-1.4, 1.4), (
        Line(np.array([[0.0, 0.0], [np.sin(t), np.cos(t)]]), "tab:blue", width=3,
             marker="o"),)) for t in th]


def _render_cartpole(env, st) -> List[Scene]:
    xs, ths = _host(st, "x"), _host(st, "theta")
    return [Scene((x - 2.5, x + 2.5), (-1.4, 1.4), (
        Rect(np.array([x - 0.2, -0.1]), 0.4, 0.2, "gray"),
        Line(np.array([[x, 0.0], [x + np.sin(th), np.cos(th)]]), "tab:blue", width=3,
             marker="o"))) for x, th in zip(xs, ths)]


def _render_point(env, st) -> List[Scene]:
    # LQRState carries .x; PointMassState and MazeState carry .pos
    xs = _host(st, "x" if hasattr(st, "x") else "pos")
    if hasattr(st, "goal"):
        goals = _host(st, "goal")
    else:
        goal = getattr(env.params, "goal", None)
        g = np.zeros(2) if goal is None else goal.detach().cpu().numpy().astype(np.float64)
        goals = np.broadcast_to(g, (len(xs), 2))
    obstacles = getattr(env.params, "obstacles", None)
    discs = () if obstacles is None else tuple(
        Disc(np.array([ox, oy]), orad, "gray", 0.5)
        for ox, oy, orad in obstacles.detach().cpu().numpy().astype(np.float64))
    return [Scene((-3.0, 3.0), (-3.0, 3.0), (
        Line(np.array([[x[0], x[1] if x.shape[0] > 1 else 0.0]]), "tab:blue", style="",
             marker="o", marker_size=10),
        _star(g)) + discs) for x, g in zip(xs, goals)]


def _chain_scenes(env, st, plane, limits) -> List[Scene]:
    """The kinematic skeleton in a coordinate plane and the state's target,
    if it has one: a 2-vector target lies on the plane z = 0."""
    model = env.params.model
    _, poss = _fk(model, st)
    a, b = plane
    targets = _host(st, "target") if hasattr(st, "target") else None
    scenes = []
    for f in range(len(poss)):
        items = _bones(model, poss[f], plane)
        if targets is not None:
            t = targets[f] if targets.shape[-1] == 3 else np.append(targets[f], 0.0)
            items.append(_star((t[a], t[b])))
        xlim, ylim, extra = limits(poss[f])
        scenes.append(Scene(xlim, ylim, tuple(items) + extra))
    return scenes


def _render_reacher(env, st) -> List[Scene]:
    """y-z side view."""
    return _chain_scenes(env, st, (1, 2), lambda poss: ((-1.2, 0.6), (-0.8, 0.8), ()))


def _planar(plane, span: float = 1.5) -> Callable:
    def render(env, st) -> List[Scene]:
        def limits(poss):
            cx = poss[:, plane[0]].mean()
            return (cx - span, cx + span), (-span, span), (_ground(),)
        return _chain_scenes(env, st, plane, limits)
    return render


def _render_pen(env, st) -> List[Scene]:
    """Hand and free pen, x-z side view: digits, cradle ridge, pen capsule,
    desired axis ray."""
    model = env.params.model
    rots, poss = _fk(model, st)
    desired = _host(st, "desired")
    c = pen.DESIRED_POS.astype(np.float64)
    body = pen.PEN_BODY
    scenes = []
    for f in range(len(poss)):
        e0 = poss[f, body] + rots[f, body] @ np.array([-pen.PEN_HL, 0.0, 0.0])
        e1 = poss[f, body] + rots[f, body] @ np.array([pen.PEN_HL, 0.0, 0.0])
        d = desired[f]
        items = _bones(model, poss[f], (0, 2), hinges_only=True) + [
            Line(np.array([[e0[0], e0[2]], [e1[0], e1[2]]]), "tab:red", width=5, cap="round"),
            Line(np.array([[c[0], c[2]], [c[0] + 0.08 * d[0], c[2] + 0.08 * d[2]]]), "green",
                 width=2, style="--"),
            Disc(np.array([0.0, 0.008]), pen.RIDGE_R, "gray", 0.5),
            _ground()]
        scenes.append(Scene((-0.15, 0.15), (-0.02, 0.18), tuple(items)))
    return scenes


def _render_relocate(env, st) -> List[Scene]:
    """Arm, hand and free ball, x-z side view, with the aerial target."""
    model = env.params.model
    _, poss = _fk(model, st)
    targets = _host(st, "target")
    ball = relocate.BALL_BODY
    return [Scene((-0.45, 0.45), (-0.05, 0.5), tuple(
        _bones(model, poss[f], (0, 2), first=3, hinges_only=True) + [
            Disc(np.array([poss[f, ball, 0], poss[f, ball, 2]]), relocate.BALL_R, "tab:red", 0.8),
            _star((targets[f, 0], targets[f, 2])), _ground()]))
        for f in range(len(poss))]


def _render_hammer(env, st) -> List[Scene]:
    model = env.params.model
    rots, poss = _fk(model, st)
    body = hammer.HAMMER_BODY
    scenes = []
    for f in range(len(poss)):
        r, p = rots[f, body], poss[f, body]
        e0 = p + r @ np.array([-hammer.HANDLE_HL, 0.0, 0.0])
        e1 = p + r @ np.array([hammer.HANDLE_HL, 0.0, 0.0])
        head = p + r @ hammer.HEAD_LOCAL.astype(np.float64)
        nail = poss[f, hammer.NAIL_BODY]
        items = _bones(model, poss[f], (0, 2), first=3, hinges_only=True) + [
            Line(np.array([[e0[0], e0[2]], [e1[0], e1[2]]]), "saddlebrown", width=4,
                 cap="round"),
            Disc(np.array([head[0], head[2]]), hammer.HEAD_R, "dimgray"),
            Line(np.array([[nail[0], 0.05], [nail[0], nail[2]]]), "black", width=2),
            Disc(np.array([nail[0], nail[2]]), hammer.NAIL_R, "black"),
            _ground()]
        scenes.append(Scene((-0.25, 0.4), (-0.05, 0.45), tuple(items)))
    return scenes


def _render_door(env, st) -> List[Scene]:
    """Top-down (x-y) view: arm and hand, the door panel swinging about its
    hinge, the handle bar on the latch."""
    model = env.params.model
    rots, poss = _fk(model, st)
    door, latch = hand_door.DOOR_BODY, hand_door.LATCH_BODY
    scenes = []
    for f in range(len(poss)):
        hinge = poss[f, door]
        edge = hinge + rots[f, door] @ np.asarray(_DOOR_EDGE)
        ha = poss[f, latch] + rots[f, latch] @ hand_door.HANDLE_A.astype(np.float64)
        hb = poss[f, latch] + rots[f, latch] @ hand_door.HANDLE_B.astype(np.float64)
        items = _bones(model, poss[f], (0, 1), first=3, hinges_only=True) + [
            Line(np.array([[hinge[0], hinge[1]], [edge[0], edge[1]]]), "saddlebrown", width=5),
            Line(np.array([[ha[0], ha[1]], [hb[0], hb[1]]]), "dimgray", width=4, cap="round")]
        scenes.append(Scene((-0.35, 0.5), (-0.3, 0.45), tuple(items)))
    return scenes


_RENDERERS: Dict[str, Callable] = {
    "SimplePendulum-v0": _render_pendulum,
    "cartpole-v0": _render_cartpole,
    "point_mass-v0": _render_point,
    "LQR-v0": _render_point,
    "reacher_7dof-v0": _render_reacher,
    "continual_reacher-v0": _render_reacher,
    "Swimmer-v0": _planar((0, 1)),
    "HalfCheetah-v0": _planar((0, 2)),
    "acrobot-v0": _planar((0, 2), span=2.2),
    "maze-v0": _render_point,
    "continual_maze-v0": _render_point,
    "sawyer_reacher-v0": _render_reacher,
    "sawyer_pusher-v0": _render_reacher,
    "sawyer_door-v0": _render_reacher,
    "sawyer_peg_insertion-v0": _render_reacher,
    "panda_reacher-v0": _render_reacher,
    "panda_tray_glass-v0": _render_reacher,
    "trajopt_reacher-v0": _planar((0, 1), span=0.3),
    "pen-v0": _render_pen,
    "relocate-v0": _render_relocate,
    "hammer-v0": _render_hammer,
    "door-v0": _render_door,
}

SUPPORTED = sorted(_RENDERERS)


def _renderer(env) -> Callable:
    base = env.name.split("+")[0]
    if base not in _RENDERERS:
        raise ValueError(f"no renderer for env {env.name!r}; supported: {SUPPORTED}")
    return _RENDERERS[base]


def _select(state, index):
    """The env state with every array field indexed by `index` on its
    leading axis (host fields, such as a seed, kept)."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[index] for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), (np.ndarray, torch.Tensor))})


def _episode(states, episode: int):
    """One episode's state of [T, ...] arrays: run_episodes' list of
    per-episode states, or one state of [B, T, ...] arrays."""
    if isinstance(states, (list, tuple)):
        return states[episode]
    return _select(states, episode)


def _n_episodes(states) -> int:
    return len(states) if isinstance(states, (list, tuple)) else _leading(states)


def scenes(env, states, episode: int = 0, max_frames: int = 400) -> List[Scene]:
    """The scenes of one recorded episode, every ceil(T / max_frames)-th
    step."""
    render = _renderer(env)
    st = _episode(states, episode)
    stride = max(1, -(-_leading(st) // max_frames))    # ceil: honour the cap
    return render(env, _select(st, slice(None, None, stride)))


def render_trajectory(env, states, episode: int = 0, fps: int = 25,
                      figsize: Sequence[float] = raster.FIGSIZE,
                      max_frames: int = 400) -> List[np.ndarray]:
    """Frames ([H, W, 3] uint8; 320 x 320 at the default figsize) of one
    recorded episode. `states` is run_episodes' list with one env state of
    [T, ...] arrays per episode, or one env state of [B, T, ...] arrays;
    numpy arrays or tensors on any device (FK runs there)."""
    return [raster.draw(s, figsize) for s in scenes(env, states, episode, max_frames)]


def dump_videos(env, states, folder: str, filename: str = "vid_traj_", fps: int = 25,
                episodes: Optional[Sequence[int]] = None) -> List[str]:
    """Write {folder}/{filename}{b}.gif for each episode b; returns the
    paths."""
    _renderer(env)
    os.makedirs(folder, exist_ok=True)
    episodes = range(_n_episodes(states)) if episodes is None else episodes
    return [gif.write_gif(os.path.join(folder, f"{filename}{b}.gif"),
                          render_trajectory(env, states, episode=b, fps=fps), fps=fps)
            for b in episodes]
