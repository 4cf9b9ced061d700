"""render/ in the port against the JAX package's renderers.

Geometry: for each of the 22 SUPPORTED envs, one state from the JAX env's
init on a fixed key, carried across with convert.py, drawn by the JAX
renderer on a matplotlib Agg axes (matplotlib is the reference here
only): the port's primitives equal the drawn artists (line points, circle
centres and radii, the rectangle, the axhline, the limits) to atol 1e-5
(the port's FK is float64, the JAX renderer's float32), and their
colours, widths, styles, markers and caps exactly. The JAX pusher
renderer raises IndexError on its 2-vector target after drawing the
chain: the chain is held to it, and the target to the block's plane.

Frames: 320 x 320 x 3 uint8, not blank, one a step up to max_frames and
then every ceil(T / max_frames)-th; run_episodes' list of states and a
[B, T, ...] state give the same frames; an unknown env raises the JAX
message. Raster: the equal-aspect axes box equals matplotlib's, a disc
covers pi r^2 pixels to within the pixels its edge crosses, a segment's
pixels lie within its half-width. run_mpc --dump_vids and
visualize_trajectories write one GIF per episode; the port imports no
imaging library. About 45 s on one core.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import matplotlib
import numpy as np
import pytest
import torch
import yaml

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.colors import to_rgb  # noqa: E402
from matplotlib.patches import Circle, Rectangle  # noqa: E402

from mjmpc_tpu import envs as jenvs  # noqa: E402
from mjmpc_tpu.render import render as jrender  # noqa: E402
from mjmpc_tpu_torch import convert, envs, render, solvers  # noqa: E402
from mjmpc_tpu_torch.harness import episode, visualize_trajectories  # noqa: E402
from mjmpc_tpu_torch.render import gif, raster  # noqa: E402
from mjmpc_tpu_torch.render import render as prender  # noqa: E402

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU
ATOL = 1e-5
PENDULUM = "configs/SimplePendulum-v0.yml"

_STATE = {
    "SimplePendulum-v0": convert.pendulum_state_from_reference,
    "cartpole-v0": convert.cartpole_state_from_reference,
    "point_mass-v0": convert.point_mass_state_from_reference,
    "LQR-v0": convert.lqr_state_from_reference,
    "maze-v0": convert.maze_state_from_reference,
    "continual_maze-v0": convert.maze_state_from_reference,
    "reacher_7dof-v0": convert.reacher_state_from_reference,
    "continual_reacher-v0": convert.reacher_state_from_reference,
    "sawyer_reacher-v0": convert.reacher_state_from_reference,
    "panda_reacher-v0": convert.reacher_state_from_reference,
    "Swimmer-v0": convert.loco_state_from_reference,
    "HalfCheetah-v0": convert.loco_state_from_reference,
    "acrobot-v0": convert.acrobot_state_from_reference,
    "trajopt_reacher-v0": convert.trajopt_reacher_state_from_reference,
    "sawyer_pusher-v0": convert.pusher_state_from_reference,
    "sawyer_door-v0": convert.sawyer_door_state_from_reference,
    "sawyer_peg_insertion-v0": convert.peg_state_from_reference,
    "panda_tray_glass-v0": convert.tray_state_from_reference,
    "pen-v0": convert.pen_state_from_reference,
    "relocate-v0": convert.relocate_state_from_reference,
    "hammer-v0": convert.hammer_state_from_reference,
    "door-v0": convert.hand_door_state_from_reference,
}


def _stack(state, t: int):
    """The port state with its tensors repeated along a new leading axis
    of length t."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[None].expand(t, *getattr(state, f.name).shape)
        for f in dataclasses.fields(state) if isinstance(getattr(state, f.name), torch.Tensor)})


def _jax_artists(name, jstate):
    """The JAX renderer's lines, patches and limits on a fresh axes (the
    lines drawn before an IndexError, and no limits, for the pusher)."""
    jenv = jenvs.make(name)
    fig, ax = plt.subplots(figsize=(4, 4), dpi=80)
    ax.set_aspect("equal")
    try:
        jrender._RENDERERS[name](jenv, jstate, ax)
        limits = (ax.get_xlim(), ax.get_ylim())
    except IndexError:
        assert name == "sawyer_pusher-v0"
        limits = None
    lines, patches = list(ax.lines), list(ax.patches)
    out = dict(limits=limits, patches=patches, hlines=[], lines=[])
    for ln in lines:
        out["lines" if ln.get_transform() is ax.transData else "hlines"].append(ln)
    plt.close(fig)
    return out


def _same_color(port: str, mpl) -> bool:
    return np.allclose(np.asarray(raster.COLORS[port]) / 255.0, to_rgb(mpl), atol=1.0 / 255)


def test_supported_is_the_jax_table():
    assert prender.SUPPORTED == jrender.SUPPORTED
    assert render.SUPPORTED == jrender.SUPPORTED and len(render.SUPPORTED) == 22
    assert set(_STATE) == set(render.SUPPORTED)


@pytest.mark.parametrize("name", jrender.SUPPORTED)
def test_geometry_matches_the_jax_renderer(name):
    jenv = jenvs.make(name)
    jstate = jenv.init(jenv.params, jax.random.PRNGKey(3))
    env = envs.make(name, device=DEVICE)
    (scene,) = prender.scenes(env, [_stack(_STATE[name](jstate, device=DEVICE), 1)])
    ref = _jax_artists(name, jstate)

    lines = [it for it in scene.items if isinstance(it, raster.Line)]
    if ref["limits"] is None:            # the pusher: its target is the block's plane's
        target = np.asarray(jstate.target)
        assert len(lines) == len(ref["lines"]) + 1
        np.testing.assert_allclose(lines[-1].xy, [[target[1], 0.0]], atol=ATOL)
        assert lines[-1].marker == "*" and lines[-1].color == "green"
        lines = lines[:-1]
    else:
        np.testing.assert_allclose(scene.xlim, ref["limits"][0], atol=ATOL)
        np.testing.assert_allclose(scene.ylim, ref["limits"][1], atol=ATOL)
    assert len(lines) == len(ref["lines"])
    for ours, theirs in zip(lines, ref["lines"]):
        np.testing.assert_allclose(ours.xy, theirs.get_xydata(), atol=ATOL)
        assert _same_color(ours.color, theirs.get_color())
        assert ours.width == theirs.get_linewidth()
        assert (ours.style or "None") == theirs.get_linestyle()
        assert (ours.marker or "None") == theirs.get_marker()
        if ours.marker:
            assert ours.marker_size == theirs.get_markersize()
        if ours.style == "-":
            assert ours.cap == theirs.get_solid_capstyle()

    hlines = [it for it in scene.items if isinstance(it, raster.HLine)]
    assert len(hlines) == len(ref["hlines"])
    for ours, theirs in zip(hlines, ref["hlines"]):
        np.testing.assert_allclose(theirs.get_xydata(), [[0.0, ours.y], [1.0, ours.y]], atol=0)
        assert _same_color(ours.color, theirs.get_color()) and ours.width == theirs.get_linewidth()

    patches = [it for it in scene.items if isinstance(it, (raster.Disc, raster.Rect))]
    assert len(patches) == len(ref["patches"])
    for ours, theirs in zip(patches, ref["patches"]):
        assert _same_color(ours.color, theirs.get_facecolor()[:3])
        if isinstance(ours, raster.Disc):
            assert isinstance(theirs, Circle)
            np.testing.assert_allclose(ours.center, theirs.center, atol=ATOL)
            np.testing.assert_allclose(ours.radius, theirs.radius, atol=ATOL)
            assert ours.alpha == (1.0 if theirs.get_alpha() is None else theirs.get_alpha())
        else:
            assert isinstance(theirs, Rectangle)
            np.testing.assert_allclose(ours.xy, theirs.get_xy(), atol=ATOL)
            np.testing.assert_allclose((ours.width, ours.height),
                                       (theirs.get_width(), theirs.get_height()), atol=ATOL)


@pytest.mark.parametrize("limits", [((-1.4, 1.4), (-1.4, 1.4)), ((-0.45, 0.45), (-0.05, 0.5)),
                                    ((-0.35, 0.5), (-0.3, 0.45)), ((-1.2, 0.6), (-0.8, 0.8))])
def test_view_is_matplotlibs_equal_aspect_box(limits):
    fig, ax = plt.subplots(figsize=(4, 4), dpi=80)
    ax.set_aspect("equal")
    ax.set_xlim(*limits[0])
    ax.set_ylim(*limits[1])
    fig.canvas.draw()
    box = ax.get_window_extent()
    plt.close(fig)
    view = raster.View(*limits)
    np.testing.assert_allclose([view.left, view.bottom, view.right, view.top],
                               [box.x0, box.y0, box.x1, box.y1], atol=1e-6)
    assert (view.width, view.height) == (320, 320)


def _short_run(name):
    env = envs.make(name, device=DEVICE)
    solver = solvers.MPPI(d_action=env.d_action, horizon=6, num_particles=8, lam=0.1,
                          init_cov=0.5, device=DEVICE)
    return env, episode.run_episodes(solver, env, n_episodes=2, episode_length=4, base_seed=0)


@pytest.mark.parametrize("name", ["SimplePendulum-v0", "reacher_7dof-v0", "acrobot-v0"])
def test_frames_from_run_episodes(name):
    env, out = _short_run(name)
    frames = render.render_trajectory(env, out["states"], episode=1)
    assert len(frames) == 4
    for f in frames:
        assert f.shape == (320, 320, 3) and f.dtype == np.uint8
        assert f.std() > 1.0            # actually drew something
    # one state of [B, T, ...] arrays, as the JAX package records them
    batched = dataclasses.replace(out["states"][0], **{
        f.name: np.stack([getattr(s, f.name) for s in out["states"]])
        for f in dataclasses.fields(out["states"][0])
        if isinstance(getattr(out["states"][0], f.name), np.ndarray)})
    for a, b in zip(frames, render.render_trajectory(env, batched, episode=1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t,max_frames,want", [(10, 3, [0, 4, 8]), (10, 10, list(range(10))),
                                               (7, 400, list(range(7))), (9, 2, [0, 5])])
def test_frame_stride_follows_max_frames(t, max_frames, want):
    env = envs.make("SimplePendulum-v0", device=DEVICE)
    s = env.init(env.params, 0)
    st = dataclasses.replace(s, th=torch.linspace(0.0, 3.0, t), thdot=torch.zeros(t))
    frames = render.render_trajectory(env, [st], max_frames=max_frames)
    assert len(frames) == len(want)
    for f, i in zip(frames, want):
        one = dataclasses.replace(s, th=st.th[i:i + 1], thdot=st.thdot[i:i + 1])
        np.testing.assert_array_equal(f, render.render_trajectory(env, [one])[0])


def test_unsupported_env_raises():
    env, out = _short_run("SimplePendulum-v0")
    bad = dataclasses.replace(env, name="nope-v0")
    with pytest.raises(ValueError, match=r"no renderer for env 'nope-v0'; supported: \["):
        render.render_trajectory(bad, out["states"])
    with pytest.raises(ValueError):
        render.dump_videos(bad, out["states"], "unused")


@pytest.mark.parametrize("radius", [3.0, 7.5, 20.0, 41.3])
def test_disc_covers_pi_r_squared(radius):
    canvas = raster.Canvas(raster.View((-1, 1), (-1, 1)))
    c = np.array([160.2, 158.7])
    raster._disc(canvas, c, radius, "black")
    count = int((canvas.frame() == 0).all(-1).sum())
    # only pixels whose centres lie within half a diagonal of the edge can
    # differ from the area: pi ((r + 0.71)^2 - r^2)
    assert abs(count - math.pi * radius ** 2) <= math.pi * (1.42 * radius + 0.5)


@pytest.mark.parametrize("p0,p1,width,cap", [((60, 70), (250, 200), 5, "round"),
                                             ((100, 250), (230, 90), 2, "projecting"),
                                             ((80, 160), (240, 160), 0.5, "projecting"),
                                             ((150, 60), (150, 260), 4, "round")])
def test_segment_pixels_lie_within_its_width(p0, p1, width, cap):
    view = raster.View((0.0, 1.0), (0.0, 1.0))
    canvas = raster.Canvas(view)
    w0, w1 = (np.array([(p[0] - view.left) / view.scale, (p[1] - view.bottom) / view.scale])
              for p in (p0, p1))
    raster._line(canvas, raster.Line(np.stack([w0, w1]), "black", width=width, cap=cap))
    rows, cols = np.nonzero((canvas.frame() == 0).all(-1))
    px, py = cols + 0.5, view.height - (rows + 0.5)
    a, b = np.asarray(p0, float), np.asarray(p1, float)
    d = b - a
    t = np.clip(((px - a[0]) * d[0] + (py - a[1]) * d[1]) / (d @ d), 0.0, 1.0)
    dist = np.hypot(px - (a[0] + t * d[0]), py - (a[1] + t * d[1]))
    r = max(0.5 * width * raster.PT, 0.5)
    # a projecting cap reaches r past each end: its corners sqrt(2) r away
    assert dist.max() <= r * (math.sqrt(2) if cap == "projecting" else 1.0) + 1e-9
    assert len(rows) >= 0.9 * np.hypot(*d) * min(2 * r, 1.0)


def test_frames_hold_only_palette_colours():
    for name in ("pen-v0", "relocate-v0", "maze-v0", "cartpole-v0"):
        jenv = jenvs.make(name)
        jstate = jenv.init(jenv.params, jax.random.PRNGKey(0))
        env = envs.make(name, device=DEVICE)
        (frame,) = render.render_trajectory(env, [_stack(_STATE[name](jstate, device=DEVICE), 1)])
        colours = {tuple(c) for c in np.unique(frame.reshape(-1, 3), axis=0).tolist()}
        assert colours <= set(raster.palette_colors()), name
        assert len(colours) >= 3


def _cut(tmp_path, steps=4):
    with open(PENDULUM) as f:
        exp = yaml.safe_load(f)
    exp.update(n_episodes=1, max_ep_length=steps)
    exp["mppi"].update(horizon=4, num_cpu=1, particles_per_cpu=6)
    path = tmp_path / "pendulum.yml"
    path.write_text(yaml.safe_dump(exp))
    return str(path)


def test_visualize_trajectories_writes_one_gif(tmp_path, capsys):
    out = tmp_path / "vids"
    paths = visualize_trajectories.main(["--config", _cut(tmp_path), "--out", str(out),
                                         "--device", DEVICE])
    assert paths == [str(out / "vid_traj_0.gif")]
    assert capsys.readouterr().out.split() == paths
    info = gif.read_gif(paths[0])
    assert (info["width"], info["height"], info["loop"]) == (320, 320, 0)
    assert info["delays"] == [4] * 4


def test_the_port_imports_no_imaging_library():
    code = ("import sys; import mjmpc_tpu_torch.render, "
            "mjmpc_tpu_torch.harness.visualize_trajectories, mjmpc_tpu_torch.harness.run_mpc; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('matplotlib', 'imageio', 'PIL', 'jax', 'mjmpc_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]"
