"""The fused rollout of a forest with contact: kernel wrapper and its plain
PyTorch version.

Counterpart of mjmpc_tpu/ops/pallas_forest.py build_forest_rollout: a
kinematic FOREST of hinge/slide trees (the hand's digits hanging from the
wrist, an arm) plus free rigid bodies (the pen) whose only coupling to
the trees is the explicit contact force, rolled out over N particles and
H control steps in one kernel (csrc/forest_rollout.cu, a team of lanes
per particle; model, topology, the team's work tables and task baked
into a header generated here).

Semantics, for every particle b and step t (identical to the Pallas
builder):
- u = clip(mean[t] + noise[b, t]) on the bodies `act_bodies` (the action
  layout), zero on every other dof;
- n_substeps semi-implicit Euler substeps, each:
  * FK over the forest;
  * every contact point's world position and velocity (scalar joints:
    v = sum_d qd_d a_d x (p - o_d) for a hinge, qd_d a_d for a slide;
    free body: v + R (w x l)); the task's force law gives a world force
    per point; the forces scatter through the same point Jacobians
    (free body: f onto the linear dofs and l x R^T f onto the angular);
  * each scalar tree: Jacobian-composed mass matrix with armature +
    dt*damping on the diagonal, the zero-qdd RNEA bias, the
    ancestor-sparse Cholesky solve of M qdd = gear*u - bias - damping*qd -
    stiffness*q + tau - frictionloss*tanh(50 qd), then qd += dt qdd,
    q += dt qd and the joint-limit clamp (qd zeroed where clamped);
  * each free body: the Euler equations in (world-linear, body-angular)
    coordinates, a decoupled 3x3 solve when its com is at the joint
    origin, the coupled symmetric 6x6 solve otherwise (an offset com);
    then v += dt a, w += dt alpha, p += dt v, quat <- quat exp(dt w / 2),
    renormalised;
- cost[b, t] = the task's cost of the post-step state.

The mass matrix of a forest is block-diagonal (one block per tree, a free
body's block constant in body coordinates), and a tree's block ordered
ancestors-first factorises with no fill-in outside ancestor pairs, so the
solve costs O(sum of path lengths squared), not O(nv^3).

Tasks (ForestTask; `extras` carries their call-time data):
- pen (envs/pen.py): extras = [desired axis 3, kp, kd, mu, pen radius];
  12 contact points; cost = -the pen reward.
- peg (envs/sawyer_tasks.py): extras = [hole entry 3, hole axis 3, hole
  depth, sensor bias 3]; no contact; cost = the depth-progress insertion
  cost, ops/chain_rollout.py's _peg_cost (shared with the chain kernels'
  peg task, so the three peg planners cannot drift apart).
- ground spheres: spheres on bodies against the plane z = 0, extras = [kp,
  kd, mu, target 3]; cost = |site - target|. A small general task (the
  tests' forest with a coupled free body).
- relocate (envs/relocate.py): extras = [target 3, kp, kd, mu, ball
  radius]; 12 contact points; the hand's weight on the arm's z slide as a
  joint torque; cost = -the relocate reward of the palm and the ball.
- hammer (envs/hammer.py): extras = [kp, kd, mu]; 15 contact points; the
  hand's weight and the nail's dry friction as joint torques; the hammer
  is the free body with an offset com (the coupled 6x6 solve); cost = -the
  hammer reward.
- sawyer_door (envs/sawyer_tasks.py): extras = [k_grab, grab radius,
  target angle]; 2 points, the hand and the handle; a gated grab spring
  on the handle only; cost = -the door reward.
- pusher (envs/sawyer_tasks.py): extras = [target 2, k_contact]; 2
  points, the hand and the block (two scalar trees, the arm and the
  block's two slides, in contact); cost = -the pusher reward.
- tray (envs/panda_tasks.py, one task per variant's model): extras =
  [target 3, fall penalty]; no contact; the arm's gravity feed-forward
  from the FK's frames as joint torques; cost = -the tray reward.
- door (envs/hand_door.py): extras = [kp, kd, mu]; 13 contact points; the
  hand's weight, the latch's spring and the door's spring and strike plate
  as joint torques; cost = -the door reward.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import chain
from ..engine.chain import ChainModel
from ..envs import contact
from ..kernels import build
from .chain_rollout import _check_args, _f, _peg_cost, _vp

HINGE, SLIDE, FREE = 0, 1, 2
_F32 = np.float32


# ---------------------------------------------------------------------------
# Model constants: the forest's topology and the per-body data, in f32
# ---------------------------------------------------------------------------

def forest_consts(model: ChainModel) -> dict:
    """The model's constants as the kernel bakes them, with the forest's
    topology: trees of scalar bodies and free roots. Raises ValueError for
    what the kernel does not take: ball joints, a free body that is not a
    root or has children, a parent listed after its child."""
    types = list(model.joint_types)
    parent = [int(p) for p in model.parent]
    n = len(types)
    jtype = []
    for i, t in enumerate(types):
        if parent[i] >= i:
            raise ValueError(f"body {i}'s parent {parent[i]} must come before it")
        if t == "hinge":
            jtype.append(HINGE)
        elif t == "slide":
            jtype.append(SLIDE)
        elif t == "free":
            if parent[i] >= 0:
                raise ValueError("free bodies must be forest roots")
            if any(parent[k] == i for k in range(n)):
                raise ValueError("free bodies must be childless")
            jtype.append(FREE)
        else:
            raise ValueError(f"forest rollout: unsupported joint type {t!r}")
    trees: List[List[int]] = []
    tree_of = [-1] * n
    for i in range(n):
        if jtype[i] == FREE:
            continue
        if parent[i] < 0:
            tree_of[i] = len(trees)
            trees.append([i])
        else:
            tree_of[i] = tree_of[parent[i]]
            trees[tree_of[i]].append(i)
    npf = lambda x: x.detach().cpu().numpy().astype(_F32)
    c = dict(n=n, parent=parent, jtype=jtype, trees=trees, nq=model.nq, nv=model.nv,
             qoff=list(model.q_offsets), voff=list(model.v_offsets),
             free=[i for i in range(n) if jtype[i] == FREE],
             axis=npf(model.joint_axis), body_pos=npf(model.body_pos), mass=npf(model.mass),
             com=npf(model.com), inertia=npf(model.inertia).reshape(n, 9),
             armature=npf(model.armature), damping=npf(model.damping),
             frictionloss=npf(model.frictionloss), stiffness=npf(model.stiffness),
             gear=npf(model.gear), qlow=npf(model.qpos_low), qhigh=npf(model.qpos_high),
             gravity=npf(model.gravity), site_pos=npf(model.site_pos),
             site_body=int(model.site_body), dt=_F32(model.dt))
    # anc[i, j]: body j is on body i's root path (i included)
    c["anc"] = np.asarray(model.ancestor_mask())[:, list(model.v_offsets)] > 0
    dt = c["dt"]
    # per scalar body (indexed by body): armature + dt*damping, in f32 as the
    # kernel's constant folding computes it
    c["reg"] = np.zeros(n, _F32)
    for i in range(n):
        if jtype[i] != FREE:
            vi = c["voff"][i]
            c["reg"][i] = c["armature"][vi] + dt * c["damping"][vi]
    c["free_consts"] = {i: _free_body_consts(c, i) for i in c["free"]}
    return c


def _free_body_consts(c: dict, i: int) -> dict:
    """A free body's constants in f32: regularisers, mass * g, the
    decoupled branch's 1/(m + reg) and the Cholesky factor of I_c + reg I,
    the coupled branch's I_o = I_c - m [c]x [c]x and -m [c]x."""
    vi = c["voff"][i]
    dt, mass = c["dt"], c["mass"][i]
    reg_l = c["armature"][vi] + dt * c["damping"][vi]
    reg_a = c["armature"][vi + 3] + dt * c["damping"][vi + 3]
    i_c = c["inertia"][i].reshape(3, 3)
    com = c["com"][i]
    out = dict(reg_l=reg_l, reg_a=reg_a, damp_l=c["damping"][vi], damp_a=c["damping"][vi + 3],
               mg=(mass * c["gravity"]).astype(_F32), inv_ml=_F32(1.0) / (mass + reg_l),
               m_reg_l=_F32(mass + reg_l), coupled=bool(np.abs(com.astype(np.float64)).max() >= 1e-9))
    m = i_c.copy()
    for k in range(3):
        m[k, k] = m[k, k] + reg_a
    l00 = np.sqrt(m[0, 0])
    l10, l20 = m[1, 0] / l00, m[2, 0] / l00
    l11 = np.sqrt(m[1, 1] - l10 * l10)
    l21 = (m[2, 1] - l20 * l10) / l11
    l22 = np.sqrt(m[2, 2] - l20 * l20 - l21 * l21)
    out["chol3"] = np.asarray([l00, l10, l20, l11, l21, l22], _F32)
    c64 = com.astype(np.float64)
    skew = np.array([[0, -c64[2], c64[1]], [c64[2], 0, -c64[0]], [-c64[1], c64[0], 0]])
    out["i_o"] = np.asarray(i_c.astype(np.float64) - float(mass) * skew @ skew, _F32)
    out["mskew"] = np.asarray(-float(mass) * skew, _F32)
    return out


def _ancestors(c: dict, i: int) -> List[int]:
    """Body i's ancestors, root first, i excluded."""
    out, k = [], c["parent"][i]
    while k >= 0:
        out.append(k)
        k = c["parent"][k]
    return out[::-1]


def _table(name: str, ctype: str, values, fmt=None) -> str:
    """A table of the generated header: a __constant__ copy for the card,
    the block's copy of it in shared memory (filled by load_tables), a
    constexpr copy for the host, and the accessor name(i, ...) that reads
    the right one (FOREST_T), so the kernel can index it at run time. The
    card reads the shared copy: a team's lanes read different entries at
    once, which constant memory serves one address at a time."""
    fmt = fmt or ((lambda v: str(int(v))) if ctype == "int" else _f)
    arr = np.asarray(values)
    dims = "".join(f"[{d}]" for d in arr.shape)
    idx = ", ".join(f"int i{k}" for k in range(arr.ndim))
    sub = "".join(f"[i{k}]" for k in range(arr.ndim))

    def init(a):
        return fmt(a) if a.ndim == 0 else "{" + ", ".join(init(x) for x in a) + "}"

    return (f"__constant__ {ctype} d_{name}{dims} = {init(arr)};\n"
            f"FOREST_SHARED {ctype} s_{name}{dims};\n"
            f"constexpr {ctype} h_{name}{dims} = {init(arr)};\n"
            f"__host__ __device__ inline {ctype} {name}({idx}) "
            f"{{ return FOREST_T({name}){sub}; }}\n")


def _cbool(x: bool) -> str:
    return "true" if x else "false"


def _table_copy(name: str, shape: Tuple[int, ...]) -> str:
    """The line of load_tables that copies table `space::name` into shared
    memory."""
    space, base = name.split("::")
    size = int(np.prod(shape))
    idx, rest = "", size
    for axis, d in enumerate(shape):
        rest //= d
        flat = f"k / {rest}" if rest > 1 else "k"
        idx += f"[{flat} % {d}]" if axis > 0 else f"[{flat}]"
    return (f"  for (int k = tid; k < {size}; k += nthreads) "
            f"{space}::s_{base}{idx} = {space}::d_{base}{idx};")


def _deal(costs: Sequence[int], team: int) -> List[List[int]]:
    """Items dealt to `team` lanes, largest first, each to the lane with the
    least work so far (the lowest such lane); each lane's items in
    increasing order."""
    lanes: List[List[int]] = [[] for _ in range(team)]
    load = [0] * team
    for item in sorted(range(len(costs)), key=lambda k: (-costs[k], k)):
        lane = min(range(team), key=lambda l: (load[l], l))
        lanes[lane].append(item)
        load[lane] += costs[item]
    return [sorted(x) for x in lanes]


def default_team(c: dict, task: "ForestTask") -> int:
    """A particle's lanes in each warp: the power of two (at most a warp)
    that covers the widest tree level, the contact points and a quarter of
    the (body, ancestor) slots: 32 for the hand, 8 for a 7-body chain."""
    n, jt = c["n"], c["jtype"]
    paths = [_ancestors(c, i) + [i] for i in range(n)]
    width = max(sum(1 for i in range(n) if len(paths[i]) == d + 1) for d in range(n))
    slots = sum(len(paths[i]) for i in range(n) if jt[i] != FREE)
    need = max(width, len(task.points), -(-slots // 4), 1)
    return min(32, 1 << (need - 1).bit_length())


def forest_schedule(c: dict, task: "ForestTask", team: int) -> dict:
    """The work tables of a team of `team` lanes in each warp, as the
    generated header carries them (csrc/forest_rollout.cuh says which phase
    reads which):

    - levels: the bodies by tree level (a body's depth on its root path),
      free bodies with the roots; the FK and RNEA forward pass go down the
      levels, the Cholesky factor's columns (column c at every body of
      level c or below) and forward substitution too, the RNEA backward
      pass and back substitution up them;
    - children: each body's children in decreasing order, the order in
      which the backward pass adds their forces;
    - desc: each scalar body b followed by its descendants, increasing,
      the order of the mass-matrix sums over bodies below a pair (a, b)
      and of back substitution's sum;
    - slots: one per (scalar body i, k-th body on its root path), the
      Jacobian columns of i's com;
    - pairs: the packed mass entries (b, ka), dealt to the lanes by the
      length of their sums (pair_lanes), each lane's laid out as one list
      of terms (b, ka, i) over the bodies i of desc[b] (terms, per lane),
      so that the warp walks the longest lane's terms once;
    - tau_lanes: each body's generalized contact force, dealt to the lanes
      by its number of points;
    - dof_points: for each body the contact points it moves, increasing, the
      order of its generalized-force sum."""
    n, par, jt = c["n"], c["parent"], c["jtype"]
    if team not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"team must be a power of two up to 32, not {team}")
    paths = [_ancestors(c, i) + [i] for i in range(n)]
    n_levels = max(len(p) for p in paths)
    levels = [[i for i in range(n) if len(paths[i]) == lv + 1 and jt[i] != FREE]
              + ([i for i in range(n) if jt[i] == FREE] if lv == 0 else [])
              for lv in range(n_levels)]
    children = [[k for k in range(n - 1, -1, -1) if par[k] == i] for i in range(n)]
    desc = [[k for k in range(n) if jt[i] != FREE and i in paths[k]] for i in range(n)]
    slots = [(i, k) for i in range(n) if jt[i] != FREE for k in range(len(paths[i]))]
    pairs = [(b, ka) for b in range(n) if jt[b] != FREE for ka in range(len(paths[b]))]
    dof_points = [[k for k, (b, _) in enumerate(task.points) if i in paths[b]]
                  for i in range(n)]
    pair_lanes = [[pairs[k] for k in lane]
                  for lane in _deal([len(desc[b]) for b, _ in pairs], team)]
    # a free body's point costs about twice a hinge's
    tau_lanes = _deal([1 + len(dof_points[i]) * (2 if jt[i] == FREE else 1)
                       for i in range(n)], team)
    terms = [[(b, ka, i) for b, ka in lane for i in desc[b]] for lane in pair_lanes]
    return dict(team=team, levels=levels, children=children, desc=desc, slots=slots,
                pairs=pairs, dof_points=dof_points, pair_lanes=pair_lanes,
                tau_lanes=tau_lanes, terms=terms)


def _flat(lists: Sequence[Sequence], pad=0) -> Tuple[List[int], list]:
    """(start offsets [len + 1], concatenated items, or [pad] if none: a
    table has at least one entry)."""
    start, items = [0], []
    for x in lists:
        items += list(x)
        start.append(len(items))
    return start, items or [pad]


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ForestTask:
    """A task of the forest kernel: its contact points, force law, cost and
    extras layout (plain version), the header's TASK and constants, and
    its operation counts as csrc/forest_rollout.cuh computes them."""
    name: str
    index: int                        # TASK in the generated header
    n_extras: int
    points: Tuple[Tuple[int, Tuple[float, float, float]], ...]   # (body, local point)
    forces: Optional[Callable]        # (pos [N, K, 3], vel [N, K, 3], extras) -> [N, K, 3]
    cost: Callable                    # (model, q, qd, rots, poss, extras) -> [N]
    header: Tuple[str, ...] = ()      # lines of the task's namespace
    tables: Tuple[tuple, ...] = ()    # its tables, (name, ctype, values) as _table takes them
    force_ops: int = 0                # per substep
    cost_ops: int = 0                 # per control step
    # the optional joint-torque hook, (q, qd, extras, (rots, poss, axes)) ->
    # {scalar body: [N] or a float} added to the joints' generalized forces
    # each substep after the contact forces (relocate's and hammer's)
    joint_torque: Optional[Callable] = None


def pen_task() -> ForestTask:
    """pen-v0's task: the 12 contact points and force law of envs/pen.py's
    pen_forces, extras [desired 3, kp, kd, mu, pen radius], cost = -pen
    reward of the pen body's centre and long axis."""
    from ..envs import pen

    def forces(pos, vel, extras):
        return pen.pen_forces(pos, vel, extras[3], extras[4], extras[5], extras[6],
                              pen.constants(pos.device))

    def cost(model, q, qd, rots, poss, extras):
        return -pen.pen_reward(poss[:, pen.PEN_BODY], rots[:, pen.PEN_BODY, :, 0], extras[0:3],
                               pen.constants(poss.device).desired_pos)

    header = (
        f"constexpr int PEN_BODY = {pen.PEN_BODY};",
        f"constexpr int N_TIPS = {pen.N_TIPS};",
        f"constexpr float RIDGE_R = {_f(pen.RIDGE_R)};",
    )
    tables = (("ridge_a", "float", pen.RIDGE_A), ("ridge_b", "float", pen.RIDGE_B),
              ("desired_pos", "float", pen.DESIRED_POS), ("tip_radius", "float", pen.C_RADII))
    points = tuple((int(b), tuple(float(x) for x in p))
                   for b, p in zip(pen.C_BODIES, pen.C_POINTS))
    # counted from forest_rollout.cuh as written: a sphere-plane force per
    # capsule end, the ridge's capsule force and its split (13); per tip a
    # sphere-segment force, its split onto the ends (13) and a sphere-plane
    # force with the sum (3). The cost: |diff| (9), orien (5), the
    # horizontal norm (5), the compares and the reward (11).
    force_ops = (2 * _FORCE_PLANE + _CAPSULE + 13
                 + pen.N_TIPS * (_SPHERE_SEG + 13 + _FORCE_PLANE + 3))
    return ForestTask("pen", 0, 7, points, forces, cost, header, tables, force_ops, 30)


def peg_task() -> ForestTask:
    """The peg-insertion task: no contact, extras [hole entry 3, hole axis
    3, hole depth, sensor bias 3], the chain kernels' peg cost of the site
    (the peg's tip)."""
    def cost(model, q, qd, rots, poss, extras):
        return _peg_cost(model, (rots, poss, None, None), extras)

    # site (18) and the peg cost of csrc/peg_cost.cuh (48)
    return ForestTask("peg", 1, 10, (), None, cost, (), (), 0, 66)


def ground_spheres_task(points: Sequence[Tuple[int, Sequence[float]]],
                        radii: Sequence[float]) -> ForestTask:
    """Spheres of `radii` at body-local `points` against the plane z = 0,
    extras [kp, kd, mu, target 3]; cost = |site - target|."""
    radii_f32 = np.asarray(radii, _F32)

    def forces(pos, vel, extras):
        r = torch.as_tensor(radii_f32, device=pos.device)
        return contact.sphere_plane_force(pos, vel, r, extras[0], extras[1], extras[2])

    def cost(model, q, qd, rots, poss, extras):
        sb = model.site_body
        site = poss[:, sb] + rots[:, sb] @ model.site_pos
        return torch.linalg.vector_norm(site - extras[3:6], dim=-1)

    pts = tuple((int(b), tuple(float(x) for x in p)) for b, p in points)
    # a sphere-plane force per point; the cost: the site (18) and |d| (9)
    return ForestTask("ground_spheres", 2, 6, pts, forces, cost, (),
                      (("sphere_radius", "float", radii_f32),), len(pts) * _FORCE_PLANE, 27)


def relocate_task(hand_weight: float) -> ForestTask:
    """relocate-v0's task: the 12 contact points and force law of
    envs/relocate.py's relocate_forces, `hand_weight` on the arm's z slide
    (body 2) as a joint torque, extras [target 3, kp, kd, mu, ball radius],
    cost = -relocate reward of the palm pad and the ball."""
    from ..envs import relocate as rl
    weight = float(np.float32(hand_weight))

    def forces(pos, vel, extras):
        return rl.relocate_forces(pos, vel, extras[3], extras[4], extras[5], extras[6],
                                  rl.constants(pos.device))

    def joint_torque(q, qd, extras, fk):
        return {2: weight}

    def cost(model, q, qd, rots, poss, extras):
        return -rl.relocate_reward(rl.palm_position(rots, poss, rl.constants(poss.device)),
                                   poss[:, rl.BALL_BODY], extras[0:3])

    header = (
        f"constexpr int N_TIPS = {rl.N_TIPS};",
        f"constexpr int BALL_BODY = {rl.BALL_BODY};",
        f"constexpr float PALM_R = {_f(rl.PALM_R)};",
        f"constexpr float HAND_WEIGHT = {_f(weight)};",
        f"constexpr float LIFT_Z = {_f(rl.LIFT_Z)};",
    )
    tables = (("tip_radius", "float", rl.C_RADII), ("palm_local", "float", rl.PALM_LOCAL))
    points = tuple((int(b), tuple(float(x) for x in p)) for b, p in zip(rl.C_BODIES, rl.C_POINTS))
    # counted from forest_rollout.cuh as written: the ball's plane force; per
    # tip a sphere-sphere force, a sphere-plane force and their sum (3) and
    # its subtraction from the ball's sum (3); the palm's sphere-sphere and
    # plane forces, their sum and its subtraction (6); the hand's weight (1).
    # The cost: the palm (18), three distances (27), the lift compare and
    # its term (5), two gates (4), the sum and the sign (5).
    force_ops = (_FORCE_PLANE + rl.N_TIPS * (_SPHERE_SPHERE + _FORCE_PLANE + 6)
                 + _SPHERE_SPHERE + _FORCE_PLANE + 6 + 1)
    return ForestTask("relocate", 3, 7, points, forces, cost, header, tables, force_ops, 59,
                      joint_torque)


def hammer_task(hand_weight: float) -> ForestTask:
    """hammer-v0's task: the 15 contact points and force law of
    envs/hammer.py's hammer_forces, `hand_weight` on the arm's z slide (body
    2) and the nail's dry friction on its slide as joint torques, extras
    [kp, kd, mu], cost = -hammer reward of the palm pad, the hammer, its
    head, the nail and the nail's depth."""
    from ..envs import hammer as hm
    weight = float(np.float32(hand_weight))

    def forces(pos, vel, extras):
        return hm.hammer_forces(pos, vel, extras[0], extras[1], extras[2],
                                hm.constants(pos.device))

    def joint_torque(q, qd, extras, fk):
        return {2: weight, hm.NAIL_BODY: hm.nail_friction(qd[:, hm.NAIL_V])}

    def cost(model, q, qd, rots, poss, extras):
        return -hm.hammer_reward(*hm.hammer_frames(rots, poss, hm.constants(poss.device)),
                                 -q[:, hm.NAIL_Q])

    header = (
        f"constexpr int N_TIPS = {hm.N_TIPS};",
        f"constexpr int CAP_A = {hm.CAP_A}, CAP_B = {hm.CAP_B}, HEAD = {hm.HEAD}, "
        f"NAIL = {hm.NAIL}, PALM = {hm.PALM};",
        f"constexpr int HAMMER_BODY = {hm.HAMMER_BODY};",
        f"constexpr int NAIL_BODY = {hm.NAIL_BODY};",
        f"constexpr float HANDLE_R = {_f(hm.HANDLE_R)};",
        f"constexpr float HEAD_R = {_f(hm.HEAD_R)};",
        f"constexpr float NAIL_R = {_f(hm.NAIL_R)};",
        f"constexpr float PALM_R = {_f(hm.PALM_R)};",
        f"constexpr float HAND_WEIGHT = {_f(weight)};",
        f"constexpr float NAIL_RESIST = {_f(hm.NAIL_RESIST)};",
        f"constexpr float NAIL_V_SLIP = {_f(hm.NAIL_V_SLIP)};",
        f"constexpr float NAIL_TRAVEL = {_f(hm.NAIL_TRAVEL)};",
        f"constexpr float HALF_DEPTH = {_f(0.5 * hm.NAIL_TRAVEL)};",
        f"constexpr float FULL_DEPTH = {_f(0.95 * hm.NAIL_TRAVEL)};",
    )
    tables = (("tip_radius", "float", hm.C_RADII), ("palm_local", "float", hm.PALM_LOCAL),
              ("head_local", "float", hm.HEAD_LOCAL))
    points = tuple((int(b), tuple(float(x) for x in p)) for b, p in zip(hm.C_BODIES, hm.C_POINTS))
    # counted from forest_rollout.cuh as written: a sphere-plane force per
    # handle end; per tip a sphere-segment force, a sphere-plane force and
    # their sum (3) and its split onto the ends (13); the head's plane and
    # strike forces, their sum and the nail's negation (6); the palm's
    # sphere-segment force and its split (13); the joint torques (hand 1,
    # the nail's friction 4). The cost: the palm and the head (36), two
    # distances (18), the depth and its term (3), two gates (4), the sum
    # and the sign (6).
    force_ops = (2 * _FORCE_PLANE + hm.N_TIPS * (_SPHERE_SEG + _FORCE_PLANE + 16)
                 + _FORCE_PLANE + _SPHERE_SPHERE + 6 + _SPHERE_SEG + 13 + 5)
    return ForestTask("hammer", 4, 3, points, forces, cost, header, tables, force_ops, 67,
                      joint_torque)


def sawyer_door_task() -> ForestTask:
    """sawyer_door-v0's task: the hand (the wrist's origin, body 6) and the
    handle on the door (body 7), the grab spring of envs/sawyer_tasks.py's
    door_forces on the handle only, extras [k_grab, grab radius, target
    angle], cost = -the door reward."""
    from ..envs import sawyer_tasks as st

    def forces(pos, vel, extras):
        return st.door_forces(pos, extras[0], extras[1])

    def cost(model, q, qd, rots, poss, extras):
        handle = st.handle_position(rots, poss, torch.as_tensor(handle_local, device=poss.device))
        return -st.door_reward(poss[:, st.HAND_BODY], handle,
                               q[:, st.DOOR_BODY], extras[2])

    header = (f"constexpr int HAND_BODY = {st.HAND_BODY};",
              f"constexpr int DOOR_BODY = {st.DOOR_BODY};")
    handle_local = np.asarray(st.HANDLE_LOCAL, _F32)
    tables = (("handle_local", "float", handle_local),)
    points = ((st.HAND_BODY, (0.0, 0.0, 0.0)),
              (st.DOOR_BODY, tuple(float(x) for x in st.HANDLE_LOCAL)))
    # counted from forest_rollout.cuh as written: the difference, its norm
    # and the 1e-8, the gate and the spring (14). The cost: the handle (18),
    # the reach (9), the angle's error, its size and the sum (5).
    return ForestTask("sawyer_door", 5, 3, points, forces, cost, header, tables, 14, 32)


def pusher_task() -> ForestTask:
    """sawyer_pusher-v0's task: the hand sphere (body 6) and the block (body
    8, its y slide), the penalty contact of envs/sawyer_tasks.py's
    pusher_forces (-f on the hand, +f on the block), extras [target 2,
    k_contact], cost = -the pusher reward of the block's planar target."""
    from ..envs import sawyer_tasks as st

    def forces(pos, vel, extras):
        return st.pusher_forces(pos, extras[2])

    def cost(model, q, qd, rots, poss, extras):
        return -st.pusher_reward(poss[:, st.HAND_BODY], poss[:, st.BLOCK_BODY], extras[0:2])

    header = (f"constexpr float CONTACT_R = {_f(st.HAND_R + st.BLOCK_R)};",
              f"constexpr int HAND_BODY = {st.HAND_BODY};",
              f"constexpr int BLOCK_BODY = {st.BLOCK_BODY};")
    points = ((st.HAND_BODY, (0.0, 0.0, 0.0)), (st.BLOCK_BODY, (0.0, 0.0, 0.0)))
    # counted from forest_rollout.cuh as written: the difference, its norm
    # and the 1e-8, the overlap, its gate and the push, the force and its
    # negation (20). The cost: the reach (9), the planar distance (6), its
    # weight and the sum (2).
    return ForestTask("pusher", 6, 3, points, forces, cost, header, (), 20, 17)


def tray_task(model: ChainModel) -> ForestTask:
    """The tray-glass task of envs/panda_tasks.py for `model` (each variant's
    own): no contact; the arm's gravity feed-forward as the joint-torque
    hook, for each arm dof d -sum_i m_i g . J_d(c_i) over the bodies i that
    d moves (a_d x (c_i - o_d) for a hinge, a_d for a slide), from the FK's
    frames; extras [target 3, fall penalty]; cost = -the tray reward."""
    from ..envs import panda_tasks as pt
    c = forest_consts(model)
    mass, com = c["mass"], c["com"]
    grav = [float(x) for x in c["gravity"]]
    paths = [_ancestors(c, i) + [i] for i in range(c["n"])]
    below = {d: [i for i in range(c["n"]) if d in paths[i]] for d in range(pt.N_ARM)}

    def joint_torque(q, qd, extras, fk):
        rots, poss, axes = fk
        out = {}
        for d, bodies in below.items():
            total = None
            for i in bodies:
                ci = poss[:, i] + _mv(rots[:, i], torch.as_tensor(com[i], device=poss.device))
                jv = (_cross(axes[d], ci - poss[:, d]) if c["jtype"][d] == HINGE
                      else axes[d])
                term = float(-mass[i]) * (grav[0] * jv[:, 0] + grav[1] * jv[:, 1]
                                          + grav[2] * jv[:, 2])
                total = term if total is None else total + term
            out[d] = total
        return out

    def cost(model_, q, qd, rots, poss, extras):
        tray = poss[:, pt.TRAY_BODY] + _mv(rots[:, pt.TRAY_BODY], model_.site_pos)
        return -pt.tray_reward(tray, extras[0:3], pt.glass_offset(q), extras[3])

    header = (f"constexpr int N_ARM = {pt.N_ARM};",
              f"constexpr int TRAY_BODY = {pt.TRAY_BODY};",
              f"constexpr int GLASS_Q = {pt.GLASS_Q};",
              f"constexpr float TRAY_R = {_f(pt.TRAY_R)};")
    # counted from forest_rollout.cuh as written: each body's com (3), per
    # (arm dof, body below it) the column (12 for a hinge), g . column (5),
    # its weight and the sum (2), per arm dof the add to tau (1). The cost:
    # the tray (18), the reach (9), the offset (4), the gate and the sums (4).
    force_ops = (3 * c["n"] + sum(len(b) * ((12 if c["jtype"][d] == HINGE else 0) + 7)
                                  for d, b in below.items()) + pt.N_ARM)
    return ForestTask("tray", 7, 4, (), None, cost, header, (), force_ops, 35, joint_torque)


def door_task(hand_weight: float) -> ForestTask:
    """door-v0's task: the 13 contact points and force law of
    envs/hand_door.py's door_forces, `hand_weight` on the arm's z slide
    (body 2), the latch's return spring and the door's spring and strike
    plate as joint torques, extras [kp, kd, mu], cost = -the door reward of
    the palm pad, the handle's middle, the door's and the latch's angles."""
    from ..envs import hand_door as hd
    weight = float(np.float32(hand_weight))

    def forces(pos, vel, extras):
        return hd.door_forces(pos, vel, extras[0], extras[1], extras[2],
                              hd.constants(pos.device))

    def joint_torque(q, qd, extras, fk):
        q_door, q_latch = q[:, hd.DOOR_BODY], q[:, hd.LATCH_BODY]
        return {2: weight, hd.DOOR_BODY: hd.door_torque(q_door, q_latch),
                hd.LATCH_BODY: hd.latch_torque(q_latch)}

    def cost(model, q, qd, rots, poss, extras):
        return -hd.door_reward(*hd.door_frames(rots, poss, hd.constants(poss.device)),
                               q[:, hd.DOOR_BODY],
                               q[:, hd.LATCH_BODY])

    header = (
        f"constexpr int N_TIPS = {hd.N_TIPS};",
        f"constexpr int CAP_A = {hd.CAP_A}, CAP_B = {hd.CAP_B}, PALM = {hd.PALM};",
        f"constexpr int DOOR_BODY = {hd.DOOR_BODY};",
        f"constexpr int LATCH_BODY = {hd.LATCH_BODY};",
        f"constexpr float HANDLE_R = {_f(hd.HANDLE_R)};",
        f"constexpr float PALM_R = {_f(hd.PALM_R)};",
        f"constexpr float HAND_WEIGHT = {_f(weight)};",
        f"constexpr float LATCH_THRESH = {_f(hd.LATCH_THRESH)};",
        f"constexpr float LATCH_SPRING = {_f(hd.LATCH_SPRING)};",
        f"constexpr float DOOR_SPRING = {_f(hd.DOOR_SPRING)};",
        f"constexpr float BLOCK_K = {_f(hd.BLOCK_K)};",
    )
    tables = (("tip_radius", "float", hd.C_RADII), ("palm_local", "float", hd.PALM_LOCAL),
              ("handle_mid", "float", hd.HANDLE_MID))
    points = tuple((int(b), tuple(float(x) for x in p)) for b, p in zip(hd.C_BODIES, hd.C_POINTS))
    # counted from forest_rollout.cuh as written: per tip and for the palm a
    # sphere-segment force and its split onto the ends (13); the joint
    # torques: the hand's weight (1), the latch's spring (2), the door's
    # gates (11), strike plate (4) and spring (3). The cost: the palm and the
    # handle (36), the reach (9), the weighted sum (6), three gates and
    # their terms (6).
    force_ops = (hd.N_TIPS + 1) * (_SPHERE_SEG + 13) + 1 + 2 + 18
    return ForestTask("door", 8, 3, points, forces, cost, header, tables, force_ops, 57,
                      joint_torque)


# Operation counts of csrc/forest_rollout.cuh's contact primitives as
# written (a multiply, an add, a compare, a division or a transcendental is
# one): force_along, penalty_force, sphere_plane_force, sphere_segment_force
# (with closest_on_segment), capsule_capsule_force (with
# segment_segment_closest) and sphere_sphere_force.
_FORCE_ALONG = 37
_PENALTY = 10 + _FORCE_ALONG
_FORCE_PLANE = 2 + _FORCE_ALONG
_SPHERE_SEG = 26 + 24 + _PENALTY
_CAPSULE = 68 + 21 + _PENALTY
_SPHERE_SPHERE = 14 + _PENALTY


# ---------------------------------------------------------------------------
# Plain PyTorch version, batched over particles: q [N, nq], qd [N, nv]
# ---------------------------------------------------------------------------

def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, -1)


def _mv(r, v):
    return (r @ v[..., None])[..., 0]


def _rodrigues(axis, ang):
    """Rotation [N, 3, 3] about the constant unit axis (3 floats) by ang
    [N], the kernel's closed form."""
    c, s = torch.cos(ang), torch.sin(ang)
    x, y, z = (float(a) for a in axis)
    one_c = 1.0 - c
    return torch.stack([c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s,
                        y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s,
                        z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c],
                       -1).reshape(ang.shape + (3, 3))


def _quat_to_mat(w, x, y, z):
    """Rotations [N, 3, 3] of unit quaternions (no renormalisation: the
    integrator keeps them unit)."""
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       -1).reshape(w.shape + (3, 3))


def _fk(c: dict, q):
    """(rots [N, n, 3, 3], poss [N, n, 3], axes): FK over the forest; axes[i]
    [N, 3] is scalar body i's world DOF axis (None for free bodies)."""
    n = q.shape[0]
    rots, poss, axes = [], [], []
    for i in range(c["n"]):
        pi, jt = c["parent"][i], c["jtype"][i]
        bp = torch.as_tensor(c["body_pos"][i], device=q.device)
        axis = c["axis"][i]
        if jt == FREE:
            qi = c["qoff"][i]
            p = bp + q[:, qi:qi + 3]
            r = _quat_to_mat(*(q[:, qi + 3 + k] for k in range(4)))
            a = None
        else:
            qs = q[:, c["qoff"][i]]
            if pi < 0:
                base, r_p = bp.expand(n, 3), None
            else:
                base, r_p = poss[pi] + _mv(rots[pi], bp), rots[pi]
            ax = torch.as_tensor(axis, device=q.device)
            if jt == HINGE:
                rod = _rodrigues(axis, qs)
                r = rod if r_p is None else r_p @ rod
                p = base
                a = _mv(r, ax)
            else:
                a = ax.expand(n, 3) if r_p is None else _mv(r_p, ax)
                r = torch.eye(3, device=q.device).expand(n, 3, 3) if r_p is None else r_p
                p = base + qs[:, None] * a
        rots.append(r)
        poss.append(p)
        axes.append(a)
    return torch.stack(rots, 1), torch.stack(poss, 1), axes


def _point_jacobian(c: dict, b: int, p, rots_l, poss_l, axes):
    """{d: column [N, 3]} of the world point p [N, 3] on scalar body b:
    a_d x (p - o_d) for a hinge ancestor d, a_d for a slide."""
    cols = {}
    for d in _ancestors(c, b) + [b]:
        cols[d] = _cross(axes[d], p - poss_l[d]) if c["jtype"][d] == HINGE else axes[d]
    return cols


def _contact(c: dict, task: ForestTask, q, qd, rots, poss, axes, extras, tau):
    """Adds the generalized contact forces of the task's points to tau
    [N, nv]."""
    dev = q.device
    rots_l, poss_l = rots.unbind(1), poss.unbind(1)
    pos, vel, jacs = [], [], []
    for b, local in task.points:
        l = torch.as_tensor(np.asarray(local, _F32), device=dev)
        p = poss_l[b] + _mv(rots_l[b], l)
        if c["jtype"][b] == FREE:
            vi = c["voff"][b]
            v = qd[:, vi:vi + 3] + _mv(rots_l[b], _cross(qd[:, vi + 3:vi + 6], l.expand_as(p)))
            jacs.append(None)
        else:
            cols = _point_jacobian(c, b, p, rots_l, poss_l, axes)
            v = torch.zeros_like(p)
            for d, col in cols.items():
                v = v + qd[:, c["voff"][d], None] * col
            jacs.append(cols)
        pos.append(p)
        vel.append(v)
    forces = task.forces(torch.stack(pos, 1), torch.stack(vel, 1), extras).unbind(1)
    for (b, local), f, cols in zip(task.points, forces, jacs):
        if cols is None:
            vi = c["voff"][b]
            l = torch.as_tensor(np.asarray(local, _F32), device=dev).expand_as(f)
            rtf = (rots_l[b].transpose(-1, -2) @ f[..., None])[..., 0]
            tau[:, vi:vi + 3] = tau[:, vi:vi + 3] + f
            tau[:, vi + 3:vi + 6] = tau[:, vi + 3:vi + 6] + _cross(l, rtf)
        else:
            for d, col in cols.items():
                vd = c["voff"][d]
                tau[:, vd] = tau[:, vd] + _dot(col, f)


def _tree_mass_and_bias(c: dict, tree, rots_l, poss_l, axes, qd):
    """({(a, b): [N]} upper-triangle mass entries over ancestor pairs, a <=
    b, and {i: [N]} RNEA bias at zero qdd) of one scalar tree."""
    dev = qd.device
    g = torch.as_tensor(c["gravity"], device=dev)
    m_out, iws, rcs = {}, {}, {}
    for i in tree:
        com = torch.as_tensor(c["com"][i], device=dev)
        inertia = torch.as_tensor(c["inertia"][i].reshape(3, 3), device=dev)
        rcs[i] = _mv(rots_l[i], com)
        ci = poss_l[i] + rcs[i]
        iw = rots_l[i] @ inertia @ rots_l[i].transpose(-1, -2)
        iws[i] = iw
        dofs = _ancestors(c, i) + [i]
        hinge = [c["jtype"][d] == HINGE for d in dofs]
        jv = torch.stack([_cross(axes[d], ci - poss_l[d]) if h else axes[d]
                          for d, h in zip(dofs, hinge)], 1)                  # [N, k, 3]
        mass = float(c["mass"][i])
        block = jv @ (mass * jv).transpose(-1, -2)                           # [N, k, k]
        if any(hinge):
            jw = torch.stack([axes[d] if h else torch.zeros_like(axes[d])
                              for d, h in zip(dofs, hinge)], 1)
            block = block + jw @ (iw @ jw.transpose(-1, -2))
        for ai, a in enumerate(dofs):
            for bi in range(ai, len(dofs)):
                key = (a, dofs[bi])
                m_out[key] = m_out[key] + block[:, ai, bi] if key in m_out else block[:, ai, bi]
    zero = torch.zeros_like(poss_l[tree[0]])
    w, dw, ao, fc, nc = {}, {}, {}, {}, {}
    for i in tree:
        pi = c["parent"][i]
        wp, dwp, ap = (w[pi], dw[pi], ao[pi]) if pi >= 0 else (zero, zero, zero)
        r = poss_l[i] - (poss_l[pi] if pi >= 0 else 0.0)
        a = qd[:, c["voff"][i], None] * axes[i]
        wj, vj = (a, zero) if c["jtype"][i] == HINGE else (zero, a)
        w[i] = wp + wj
        dw[i] = dwp + _cross(wp, wj)
        ao[i] = (ap + _cross(dwp, r)) + (_cross(wp, _cross(wp, r)) + 2.0 * _cross(wp, vj))
        acc_c = ao[i] + (_cross(dw[i], rcs[i]) + _cross(w[i], _cross(w[i], rcs[i])))
        fc[i] = float(c["mass"][i]) * (acc_c - g)
        nc[i] = _mv(iws[i], dw[i]) + _cross(w[i], _mv(iws[i], w[i]))
    bias = {}
    fa = {i: zero for i in tree}
    na = {i: zero for i in tree}
    for i in reversed(tree):
        pi = c["parent"][i]
        f = fc[i] + fa[i]
        nmom = (nc[i] + _cross(rcs[i], fc[i])) + na[i]
        bias[i] = _dot(axes[i], nmom) if c["jtype"][i] == HINGE else _dot(axes[i], f)
        if pi >= 0:
            fa[pi] = fa[pi] + f
            na[pi] = na[pi] + (nmom + _cross(poss_l[i] - poss_l[pi], f))
    return m_out, bias


def _chol_solve(idx, m_out, rhs, anc):
    """Cholesky solve of one SPD block given by its upper-triangle entries
    m_out {(a, b): [N]} over the bodies idx (ordered ancestors-first);
    anc[i] lists i's ancestors in idx, root first (no fill-in outside
    them: the ancestor-sparse factor); x = M^-1 rhs as {i: [N]}."""
    low, y, x = {}, {}, {}
    for i in idx:
        for j in anc[i]:
            s = m_out[(j, i)]
            for k in anc[j]:
                s = s - low[(i, k)] * low[(j, k)]
            low[(i, j)] = s / low[(j, j)]
        s = m_out[(i, i)]
        for k in anc[i]:
            s = s - low[(i, k)] * low[(i, k)]
        low[(i, i)] = torch.sqrt(s)
    for i in idx:
        s = rhs[i]
        for k in anc[i]:
            s = s - low[(i, k)] * y[k]
        y[i] = s / low[(i, i)]
    for a in range(len(idx) - 1, -1, -1):
        i = idx[a]
        s = y[i]
        for k in idx[a + 1:]:
            if (k, i) in low:
                s = s - low[(k, i)] * x[k]
        x[i] = s / low[(i, i)]
    return x


def _free_step(c: dict, i: int, q, qd, rot, tau):
    """A free body's substep: (q block [N, 7], qd block [N, 6])."""
    fcst = c["free_consts"][i]
    qi, vi = c["qoff"][i], c["voff"][i]
    dev = q.device
    pos, quat = q[:, qi:qi + 3], q[:, qi + 3:qi + 7]
    v_lin, w_b = qd[:, vi:vi + 3], qd[:, vi + 3:vi + 6]
    f_lin, tau_b = tau[:, vi:vi + 3], tau[:, vi + 3:vi + 6]
    i_b = torch.as_tensor(c["inertia"][i].reshape(3, 3), device=dev)
    mg = torch.as_tensor(fcst["mg"], device=dev)
    damp_l, damp_a = float(fcst["damp_l"]), float(fcst["damp_a"])
    if not fcst["coupled"]:
        # (m + reg) a = f + m g - damp v;  (I_c + reg I) alpha = tau - w x I_c w - damp w
        acc_l = (f_lin + mg - damp_l * v_lin) * float(fcst["inv_ml"])
        rhs = (tau_b - _cross(w_b, _mv(i_b, w_b))) - damp_a * w_b
        l00, l10, l20, l11, l21, l22 = (float(x) for x in fcst["chol3"])
        y0 = rhs[:, 0] / l00
        y1 = (rhs[:, 1] - l10 * y0) / l11
        y2 = (rhs[:, 2] - l20 * y0 - l21 * y1) / l22
        x2 = y2 / l22
        x1 = (y1 - l21 * x2) / l11
        x0 = (y0 - l10 * x1 - l20 * x2) / l00
        acc_a = torch.stack([x0, x1, x2], -1)
    else:
        cv = torch.as_tensor(c["com"][i], device=dev)
        q_v = f_lin + mg - damp_l * v_lin
        rtg = (rot.transpose(-1, -2) @ mg[:, None])[..., 0]
        q_w = (tau_b - damp_a * w_b) + _cross(cv.expand_as(rtg), rtg)
        wwc = _cross(w_b, _cross(w_b, cv.expand_as(w_b)))
        mass = float(c["mass"][i])
        rhs_v = q_v - mass * _mv(rot, wwc)
        rhs_w = (q_w - mass * _cross(cv.expand_as(wwc), wwc)) - _cross(w_b, _mv(i_b, w_b))
        b_blk = rot @ torch.as_tensor(fcst["mskew"], device=dev)              # -m R [c]x
        m_out, rhs = {}, {}
        n = q.shape[0]
        for a in range(3):
            for bb in range(a, 3):
                m_out[(a, bb)] = torch.full((n,), float(fcst["m_reg_l"]) if a == bb else 0.0,
                                            device=dev)
                m_out[(3 + a, 3 + bb)] = torch.full(
                    (n,), float(fcst["i_o"][a, bb] + (fcst["reg_a"] if a == bb else 0.0)),
                    device=dev)
            for bb in range(3):
                m_out[(a, 3 + bb)] = b_blk[:, a, bb]
            rhs[a], rhs[3 + a] = rhs_v[:, a], rhs_w[:, a]
        idx = list(range(6))
        acc = _chol_solve(idx, m_out, rhs, {k: idx[:k] for k in idx})
        acc_l = torch.stack([acc[0], acc[1], acc[2]], -1)
        acc_a = torch.stack([acc[3], acc[4], acc[5]], -1)
    dt = float(c["dt"])
    v_new = v_lin + dt * acc_l
    w_new = w_b + dt * acc_a
    pos_new = pos + dt * v_new
    quat_new = chain._quat_mul(quat, chain._exp_quat(dt * w_new))
    quat_new = quat_new / torch.sqrt(torch.sum(quat_new * quat_new, -1, keepdim=True))
    return torch.cat([pos_new, quat_new], -1), torch.cat([v_new, w_new], -1)


def forest_substep(c: dict, task: ForestTask, q, qd, ub, extras):
    """One semi-implicit Euler substep of the forest: (q [N, nq], qd [N, nv])
    -> the next (q, qd); ub {body: [N]} the clipped controls of the
    actuated bodies (every other dof gets zero)."""
    rots, poss, axes = _fk(c, q)
    tau = torch.zeros_like(qd)
    if task.points:
        _contact(c, task, q, qd, rots, poss, axes, extras, tau)
    if task.joint_torque is not None:
        for i, t in task.joint_torque(q, qd, extras, (rots, poss, axes)).items():
            tau[:, c["voff"][i]] = tau[:, c["voff"][i]] + t
    rots_l, poss_l = rots.unbind(1), poss.unbind(1)
    q_new, qd_new = q.clone(), qd.clone()
    dt = float(c["dt"])
    for tree in c["trees"]:
        m_out, bias = _tree_mass_and_bias(c, tree, rots_l, poss_l, axes, qd)
        rhs = {}
        for i in tree:
            vi, qi = c["voff"][i], c["qoff"][i]
            m_out[(i, i)] = m_out[(i, i)] + float(c["reg"][i])
            u = ub.get(i)
            gu = float(c["gear"][vi]) * (u if u is not None else torch.zeros_like(qd[:, vi]))
            rhs[i] = (gu - bias[i] - float(c["damping"][vi]) * qd[:, vi]
                      - float(c["stiffness"][vi]) * q[:, qi] + tau[:, vi])
            if c["frictionloss"][vi] != 0.0:      # smooth Coulomb friction
                rhs[i] = rhs[i] - float(c["frictionloss"][vi]) * torch.tanh(qd[:, vi] * 50.0)
        acc = _chol_solve(tree, m_out, rhs, {i: _ancestors(c, i) for i in tree})
        for i in tree:
            vi, qi = c["voff"][i], c["qoff"][i]
            qdn = qd[:, vi] + dt * acc[i]
            qn = q[:, qi] + dt * qdn
            clamped = torch.clamp(qn, float(c["qlow"][qi]), float(c["qhigh"][qi]))
            qd_new[:, vi] = torch.where(clamped == qn, qdn, torch.zeros_like(qdn))
            q_new[:, qi] = clamped
    for i in c["free"]:
        qi, vi = c["qoff"][i], c["voff"][i]
        q_new[:, qi:qi + 7], qd_new[:, vi:vi + 6] = _free_step(c, i, q, qd, rots_l[i], tau)
    return q_new, qd_new


def rollout_forest_plain(model: ChainModel, n_substeps: int, act_bodies: Sequence[int],
                         task: ForestTask, ulow: float, uhigh: float, q0, qd0, extras,
                         mean, noise, consts: Optional[dict] = None):
    """Plain PyTorch forest rollout: costs [N, H] of mean [H, dA] + noise
    [N, H, dA] from (q0 [nq], qd0 [nv]) with the task's extras."""
    c = forest_consts(model) if consts is None else consts
    n, horizon, _ = noise.shape
    q = q0.expand(n, c["nq"]).clone()
    qd = qd0.expand(n, c["nv"]).clone()
    costs = []
    for t in range(horizon):
        u = torch.clamp(mean[t] + noise[:, t], ulow, uhigh)
        ub = {body: u[:, j] for j, body in enumerate(act_bodies)}
        for _ in range(n_substeps):
            q, qd = forest_substep(c, task, q, qd, ub, extras)
        rots, poss, _ = _fk(c, q)
        costs.append(task.cost(model, q, qd, rots, poss, extras))
    return torch.stack(costs, 1)


# The pen cost's gates: +10 and +50 at similarity > 0.90 / 0.95 while close,
# -5 once dropped. A particle whose state sits at a gate within an f32 ulp
# can land on either side in two summation orders, and its cost then moves
# by a signed sum of these steps.
PEN_BONUS_STEPS = tuple(sorted({a * 5 + b * 10 + c * 50 for a in (-1, 0, 1)
                                for b in (-1, 0, 1) for c in (-1, 0, 1)} - {0}))
# The relocate cost's constant gates: +10 and +20 at the carry distances
# 0.10 and 0.05 (its lift gate adds a term that depends on the state, not a
# constant step); the hammer cost's: +25 and +75 at half and 95% depth.
RELOCATE_BONUS_STEPS = tuple(sorted({b * 10 + c * 20 for b in (-1, 0, 1)
                                     for c in (-1, 0, 1)} - {0}))
HAMMER_BONUS_STEPS = tuple(sorted({b * 25 + c * 75 for b in (-1, 0, 1)
                                   for c in (-1, 0, 1)} - {0}))
# door-v0's: +2, +8 and +10 at the door angles 0.2, 1.0 and 1.35.
DOOR_BONUS_STEPS = tuple(sorted({a * 2 + b * 8 + c * 10 for a in (-1, 0, 1)
                                 for b in (-1, 0, 1) for c in (-1, 0, 1)} - {0}))
# The tray's fall penalty at a glass offset of 0.12 is its extras' value (5
# in every variant), one step either way.
TRAY_FALL_STEPS = (-5.0, 5.0)


def gated_cost_agreement(got, want, atol: float = 1e-3,
                         steps: Sequence[float] = PEN_BONUS_STEPS) -> dict:
    """How two cost arrays of a threshold-gated cost agree: the share of
    entries within atol, the number of the others that differ by one of
    the bonus `steps` to within atol, and the number that differ
    otherwise. The tolerance is absolute: a bonus is a constant, and adds
    no error beyond a few ulps of itself."""
    diff = got - want
    within = diff.abs() <= atol
    step = torch.as_tensor(steps, dtype=diff.dtype, device=diff.device)
    on_step = ((diff[..., None] - step).abs() <= atol).any(-1)
    return dict(share_within=float(within.float().mean()),
                bonus_steps=int((~within & on_step).sum()),
                other=int((~within & ~on_step).sum()))


# ---------------------------------------------------------------------------
# Work counts for the card-time bound
# ---------------------------------------------------------------------------

_ADD, _DOT, _CROSS, _MV, _MM = 3, 5, 9, 15, 45
_ROD, _QUAT_MAT, _ROT_INERTIA = 36, 39, 90
# the RNEA's forward step of one body and its backward step (+21 with a parent)
_RNEA_FWD, _RNEA_BWD, _RNEA_PARENT = 150, 23, 21
# a free body's decoupled and coupled solves, and its integration
_FREE_DECOUPLED, _FREE_COUPLED, _FREE_INTEGRATE = 63, 334, 75


def _substep_flops(c: dict, task: ForestTask) -> Tuple[int, int]:
    """(FK pass, substep without it) operations of one particle, counted
    from csrc/forest_rollout.cuh (a multiply, an add, a compare, a division
    or a transcendental is one) on the forest's topology: each operation
    that the function needs, once. What the kernel's lanes repeat to save
    a phase (a column's Cholesky diagonal beside each of its entries,
    m_i jv per mass term, a slide's unread rotational term) is not
    counted."""
    n, par, jt = c["n"], c["parent"], c["jtype"]
    paths = [_ancestors(c, i) + [i] for i in range(n)]
    col = lambda d: 12 if jt[d] == HINGE else 0      # a hinge's a x (p - o)
    fk = 0
    for i in range(n):
        if jt[i] == FREE:
            fk += _ADD + _QUAT_MAT
        elif par[i] < 0:
            fk += _ROD + _MV if jt[i] == HINGE else 2 * _ADD
        else:
            fk += _MV + _ADD + (_ROD + _MM + _MV if jt[i] == HINGE else _MV + 2 * _ADD)
    points = 0
    for b, _ in task.points:
        points += _MV + _ADD
        if jt[b] == FREE:
            points += (_CROSS + _MV + _ADD) + (2 * _ADD + _MV + _CROSS)    # v; gather
        else:
            points += sum(2 * col(d) + 12 for d in paths[b])              # v; gather
    sub = points + task.force_ops
    for i in range(n):
        if jt[i] == FREE:
            coupled = c["free_consts"][i]["coupled"]
            sub += (_FREE_COUPLED if coupled else _FREE_DECOUPLED) + _FREE_INTEGRATE
            continue
        path = paths[i]
        d = len(path)
        h = [jt[k] == HINGE for k in path]
        sub += _MV + _ADD + _ROT_INERTIA                                  # rc, ci, iw
        sub += sum(27 if x else 0 for x in h) + _ADD * d                  # jv, iw a, m jv
        sub += sum(_DOT + 1 + (_DOT + 1 if h[a] and h[b] else 0)
                   for a in range(d) for b in range(a, d))                # mass pairs
        sub += _RNEA_FWD + _RNEA_BWD + (_RNEA_PARENT if par[i] >= 0 else 0)
        sub += sum(2 * k + 1 for k in range(d - 1)) + 2 * (d - 1) + 1      # factor row
        sub += 2 * (2 * (d - 1) + 1)                                      # both substitutions
        fl = int(c["frictionloss"][c["voff"][i]] != 0)
        sub += 1 + 7 + 4 * fl + 7                                         # diag, rhs, update
    return fk, sub


def forest_rollout_flops(model: ChainModel, n_substeps: int, n: int, horizon: int,
                         act_bodies: Sequence[int], task: ForestTask) -> int:
    """Floating-point operations of one kernel call: the FK pass of the
    first state, then per control step the actions (3 per actuated dof),
    n_substeps of the substep and the FK pass of its new state, and the
    task's cost of the post-step state (a step's last FK pass serves its
    cost and the next step). The work is the same for every input."""
    fk, sub = _substep_flops(forest_consts(model), task)
    step = 3 * len(act_bodies) + n_substeps * (fk + sub) + task.cost_ops
    return n * (fk + horizon * step)


def forest_rollout_bytes(model: ChainModel, n: int, horizon: int, d_act: int,
                         task: ForestTask) -> int:
    """Bytes one kernel call must move: q0, qd0, extras, the mean and the
    noise in, costs out, f32."""
    return 4 * (model.nq + model.nv + task.n_extras + horizon * d_act
                + n * horizon * d_act + n * horizon)


# ---------------------------------------------------------------------------
# The generated header and the kernel wrapper
# ---------------------------------------------------------------------------

def model_header(model: ChainModel, n_substeps: int, act_bodies: Sequence[int],
                 task: ForestTask, ulow: float = -1.0, uhigh: float = 1.0) -> str:
    """C++ header of the forest's constants, its topology, the work tables
    of a team of default_team lanes in each warp (forest_schedule) and the
    task for csrc/forest_rollout.cu: scalars as constexpr, tables through
    _table, and load_tables, which copies every table into the block's
    shared memory."""
    return _model_header(model, n_substeps, act_bodies, task, ulow, uhigh,
                         default_team(forest_consts(model), task))


def _model_header(model: ChainModel, n_substeps: int, act_bodies: Sequence[int],
                  task: ForestTask, ulow: float, uhigh: float, team: int) -> str:
    """model_header for a team of `team` lanes in each warp (the tests build
    other team sizes through it)."""
    c = forest_consts(model)
    n = c["n"]
    sched = forest_schedule(c, task, team)
    scalar = lambda key, off: [c[key][c[off][b]] if c["jtype"][b] != FREE else 0.0
                               for b in range(n)]
    free = lambda key, shape: np.asarray(
        [c["free_consts"][b][key] if b in c["free_consts"] else np.zeros(shape, _F32)
         for b in range(n)], _F32)
    coupled = [int(b in c["free_consts"] and c["free_consts"][b]["coupled"]) for b in range(n)]
    # each body's root path (root first, itself last), padded with -1
    paths = [_ancestors(c, b) + [b] for b in range(n)]
    maxd = max(len(p) for p in paths)
    anc = [p + [-1] * (maxd - len(p)) for p in paths]
    points = task.points or ((0, (0.0, 0.0, 0.0)),)     # a placeholder row, never read
    slot_off = np.cumsum([0] + [len(paths[b]) if c["jtype"][b] != FREE else 0
                                for b in range(n)])[:n]
    level_start, level_body = _flat(sched["levels"])
    child_start, child = _flat(sched["children"])
    desc_start, desc = _flat(sched["desc"])
    point_start, dof_point = _flat(sched["dof_points"])
    term_start, terms = _flat(sched["terms"], (0, 0, 0))
    tau_start, tau_body = _flat(sched["tau_lanes"])
    # a term's edge bits: 1 its entry's first, 2 its last, 4 a diagonal
    # entry, 8 two hinges
    edge = [int(k == 0 or terms[k - 1][:2] != t[:2])
            + 2 * int(k == len(terms) - 1 or terms[k + 1][:2] != t[:2])
            + 4 * int(ka == len(paths[b]) - 1)
            + 8 * int(c["jtype"][paths[b][ka]] == HINGE and c["jtype"][b] == HINGE)
            for k, t in enumerate(terms) for b, ka, _ in [t]]
    tables = [
        ("parent", "int", c["parent"]),
        ("jtype", "int", c["jtype"]),
        ("qoff", "int", c["qoff"]),
        ("voff", "int", c["voff"]),
        ("depth", "int", [len(p) for p in paths]),
        ("anc", "int", anc),
        # an action whose body a later action sets is -1: the last wins, as
        # in the plain version
        ("act_body", "int", [-1 if b in act_bodies[j + 1:] else b
                             for j, b in enumerate(act_bodies)]),
        ("axis", "float", c["axis"]),
        ("body_pos", "float", c["body_pos"]),
        ("mass", "float", c["mass"]),
        ("com", "float", c["com"]),
        ("inertia", "float", c["inertia"]),
        ("reg", "float", c["reg"]),
        ("damping", "float", scalar("damping", "voff")),
        ("stiffness", "float", scalar("stiffness", "voff")),
        ("gear", "float", scalar("gear", "voff")),
        ("frictionloss", "float", scalar("frictionloss", "voff")),
        ("qlow", "float", scalar("qlow", "qoff")),
        ("qhigh", "float", scalar("qhigh", "qoff")),
        ("gravity", "float", c["gravity"]),
        ("site_pos", "float", c["site_pos"]),
        ("coupled", "int", coupled),
        ("free_damp_l", "float", free("damp_l", ())),
        ("free_damp_a", "float", free("damp_a", ())),
        ("free_reg_a", "float", free("reg_a", ())),
        ("free_inv_ml", "float", free("inv_ml", ())),
        ("free_m_reg_l", "float", free("m_reg_l", ())),
        ("free_mg", "float", free("mg", (3,))),
        ("free_chol3", "float", free("chol3", (6,))),
        ("free_i_o", "float", free("i_o", (3, 3)).reshape(n, 9)),
        ("free_mskew", "float", free("mskew", (3, 3)).reshape(n, 9)),
        ("point_body", "int", [b for b, _ in points]),
        ("point_local", "float", np.asarray([p for _, p in points], _F32)),
        # the team's schedule
        ("level_start", "int", level_start),
        ("level_body", "int", level_body),
        ("child_start", "int", child_start),
        ("child", "int", child),
        ("desc_start", "int", desc_start),
        ("desc", "int", desc),
        # back substitution's L(k, i) for the bodies k below i: M[k][depth(i) - 1]
        ("desc_m", "int", [k * maxd + len(paths[i]) - 1
                           for i, ks in enumerate(sched["desc"]) for k in ks] or [0]),
        ("slot_off", "int", slot_off),
        ("slot_body", "int", [i for i, _ in sched["slots"]]),
        ("slot_k", "int", [k for _, k in sched["slots"]]),
        ("term_start", "int", term_start),
        ("term_ja", "int", [slot_off[i] + ka for _, ka, i in terms]),
        ("term_jb", "int", [slot_off[i] + len(paths[b]) - 1 for b, _, i in terms]),
        ("term_a", "int", [paths[b][ka] for b, ka, _ in terms]),
        ("term_m", "int", [b * maxd + ka for b, ka, _ in terms]),
        ("term_mass", "float", [c["mass"][i] for _, _, i in terms]),
        ("term_reg", "float", [c["reg"][b] for b, _, _ in terms]),
        ("term_edge", "int", edge),
        ("tau_start", "int", tau_start),
        ("tau_body", "int", tau_body),
        ("point_start", "int", point_start),
        ("dof_point", "int", dof_point),
    ]
    lines = [
        "// Generated by mjmpc_tpu_torch/ops/forest_rollout.py from a ChainModel and a task.",
        "#pragma once",
        f"#define FOREST_TASK {task.index}",
        "#ifdef __CUDA_ARCH__",
        "#define FOREST_T(name) s_##name",
        "#else",
        "#define FOREST_T(name) h_##name",
        "#endif",
        "#ifdef __CUDACC__",
        "#define FOREST_SHARED __shared__",
        "#else",
        "#define FOREST_SHARED [[maybe_unused]] static",
        "#endif",
        "namespace forest {",
        f"constexpr int NB = {n};",
        f"constexpr int NQ = {c['nq']};",
        f"constexpr int NV = {c['nv']};",
        f"constexpr int MAXD = {maxd};",
        f"constexpr int D_ACT = {len(act_bodies)};",
        f"constexpr int N_POINTS = {len(task.points)};",
        f"constexpr int N_SUBSTEPS = {int(n_substeps)};",
        f"constexpr int SITE_BODY = {c['site_body']};",
        f"constexpr int TASK = {task.index};  // {task.name}",
        f"constexpr int N_EXTRAS = {task.n_extras};",
        f"constexpr float DT = {_f(c['dt'])};",
        f"constexpr float ULOW = {_f(ulow)};",
        f"constexpr float UHIGH = {_f(uhigh)};",
        f"constexpr int TEAM = {team};  // a particle's lanes in each warp",
        f"constexpr int N_LEVELS = {len(sched['levels'])};",
        f"constexpr int N_SLOTS = {len(sched['slots'])};",
        # the joint kinds and terms the model has: the kernel builds no code
        # for the others
        f"constexpr bool HAS_FREE = {_cbool(bool(c['free']))};",
        f"constexpr bool HAS_SLIDE = {_cbool(SLIDE in c['jtype'])};",
        f"constexpr bool HAS_COUPLED = {_cbool(any(coupled))};",
        f"constexpr bool HAS_FRICTIONLOSS = {_cbool(bool(np.any(c['frictionloss'] != 0)))};",
    ]
    lines += [_table(*t) for t in tables]
    lines += ["}  // namespace forest", "namespace forest_task {", *task.header,
              *(_table(*t) for t in task.tables), "}  // namespace forest_task"]
    copies = [_table_copy(f"forest::{name}", np.asarray(values).shape)
              for name, _, values in tables]
    copies += [_table_copy(f"forest_task::{name}", np.asarray(values).shape)
               for name, _, values in task.tables]
    lines += ["#ifdef __CUDACC__", "namespace forest {",
              "// Every table into the block's shared memory, by threads tid of nthreads.",
              "__device__ inline void load_tables(int tid, int nthreads) {", *copies, "}",
              "}  // namespace forest", "#endif"]
    return "\n".join(lines) + "\n"


class ForestRollout:
    """rollout(q0 [nq], qd0 [nv], extras [n_extras], mean [H, dA], noise
    [N, H, dA]) -> costs [N, H], all float32 on one device; extras is the
    task's.

    `batch` runs B such rollouts (B starts, extras and means, noise
    [B, N, H, dA]) in one launch over B N particles; element b equals the
    single rollout of element b's inputs bit for bit.

    `ForestRollout.launches` counts kernel launches over all instances; it
    rises by one per launch and nowhere else (the plain version on CPU
    tensors does not count); `ForestRollout.batch_launches` likewise counts
    the batched entry's.
    """
    launches = 0
    batch_launches = 0
    # nvcc flags beyond build.NVCC_FLAGS (a measurement build sets its own)
    nvcc_flags: Tuple[str, ...] = ()

    def __init__(self, model: ChainModel, n_substeps: int, act_bodies: Sequence[int],
                 task: ForestTask, ulow: float = -1.0, uhigh: float = 1.0):
        self.model = model
        self.n_substeps = int(n_substeps)
        self.act_bodies = tuple(int(b) for b in act_bodies)
        self.task = task
        self.ulow = float(ulow)
        self.uhigh = float(uhigh)
        self.consts = forest_consts(model)
        for b in self.act_bodies:
            if not 0 <= b < self.consts["n"] or self.consts["jtype"][b] == FREE:
                raise ValueError(f"act body {b} is not a scalar joint of the model")
        self.team = default_team(self.consts, task)
        self.header = model_header(model, n_substeps, self.act_bodies, task, ulow, uhigh)
        self._lib = None

    def library(self) -> build.KernelLibrary:
        """Build (at first use) and load the kernel for this model and task,
        and let it take its particles' shared memory (before any launch, so
        that no launch does it inside a captured graph)."""
        if self._lib is None:
            lib = build.load("forest_rollout", "forest_rollout.cu",
                             {"forest_model.h": self.header}, self.nvcc_flags)
            entry = lib.lib.forest_rollout_launch
            entry.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                                      ctypes.c_void_p]
            entry.restype = ctypes.c_int
            entry = lib.lib.forest_rollout_batch_launch
            entry.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            entry.restype = ctypes.c_int
            lib.lib.forest_rollout_error_string.argtypes = [ctypes.c_int]
            lib.lib.forest_rollout_error_string.restype = ctypes.c_char_p
            lib.lib.forest_rollout_layout.argtypes = [ctypes.c_void_p]
            lib.lib.forest_rollout_layout.restype = None
            lib.lib.forest_rollout_setup.restype = ctypes.c_int
            layout = (ctypes.c_int * 6)()
            lib.lib.forest_rollout_layout(layout)
            want = (self.task.index, self.consts["nq"], self.consts["nv"],
                    len(self.act_bodies), self.task.n_extras, self.team)
            if tuple(layout) != want:
                raise RuntimeError(f"{lib.path} was built for (task, nq, nv, dA, n_extras, "
                                   f"team) = {tuple(layout)}, not {want}")
            rc = lib.lib.forest_rollout_setup()
            if rc != 0:
                raise RuntimeError("ForestRollout kernel setup failed: "
                                   + lib.lib.forest_rollout_error_string(rc).decode())
            self._lib = lib
        return self._lib

    def _check(self, q0, qd0, extras, mean, noise):
        c = self.consts
        args = {"q0": q0, "qd0": qd0, "extras": extras, "mean": mean, "noise": noise}
        d = len(self.act_bodies)
        return _check_args(args, d, lambda h: {"q0": (c["nq"],), "qd0": (c["nv"],),
                                               "extras": (self.task.n_extras,),
                                               "mean": (h, d)})

    def plain(self, q0, qd0, extras, mean, noise):
        """The plain PyTorch version (any device)."""
        self._check(q0, qd0, extras, mean, noise)
        return rollout_forest_plain(self.model, self.n_substeps, self.act_bodies, self.task,
                                    self.ulow, self.uhigh, q0, qd0, extras, mean, noise,
                                    self.consts)

    def __call__(self, q0, qd0, extras, mean, noise):
        args = self._check(q0, qd0, extras, mean, noise)
        device = noise.device
        if device.type == "cpu":
            return rollout_forest_plain(self.model, self.n_substeps, self.act_bodies,
                                        self.task, self.ulow, self.uhigh, q0, qd0, extras,
                                        mean, noise, self.consts)
        if device.type != "cuda":
            raise ValueError(f"no forest-rollout kernel for device {device}")
        for name, x in args.items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        n, horizon, _ = noise.shape
        lib = self.library().lib
        with torch.cuda.device(device):
            costs = torch.empty((n, horizon), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.forest_rollout_launch(_vp(q0), _vp(qd0), _vp(extras), _vp(mean),
                                           _vp(noise), _vp(costs), n, horizon,
                                           ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError("ForestRollout kernel launch failed: "
                               + lib.forest_rollout_error_string(rc).decode())
        type(self).launches += 1
        return costs

    def _check_batch(self, q0, qd0, extras, mean, noise):
        if not isinstance(noise, torch.Tensor) or noise.dim() != 4 or noise.shape[0] < 1:
            raise ValueError("noise must be a [B>=1, N, H, dA] torch.Tensor")
        c, batch, d = self.consts, noise.shape[0], len(self.act_bodies)
        args = {"q0": q0, "qd0": qd0, "extras": extras, "mean": mean,
                "noise": noise.reshape(-1, *noise.shape[2:])}
        _check_args(args, d, lambda h: {"q0": (batch, c["nq"]), "qd0": (batch, c["nv"]),
                                        "extras": (batch, self.task.n_extras),
                                        "mean": (batch, h, d)})
        return dict(args, noise=noise)

    def batch_plain(self, q0, qd0, extras, mean, noise):
        """batch in plain PyTorch (any device): the plain rollout of each
        element, stacked."""
        self._check_batch(q0, qd0, extras, mean, noise)
        return torch.stack([rollout_forest_plain(self.model, self.n_substeps, self.act_bodies,
                                                 self.task, self.ulow, self.uhigh, q0[b], qd0[b],
                                                 extras[b], mean[b], noise[b], self.consts)
                            for b in range(noise.shape[0])])

    def batch(self, q0, qd0, extras, mean, noise):
        """B rollouts: q0 [B, nq], qd0 [B, nv], extras [B, n_extras], mean
        [B, H, dA], noise [B, N, H, dA] -> costs [B, N, H]; on a CUDA device
        one launch of the kernel over the B N particles, the plain version
        per element on the CPU."""
        args = self._check_batch(q0, qd0, extras, mean, noise)
        device = noise.device
        if device.type == "cpu":
            return self.batch_plain(q0, qd0, extras, mean, noise)
        if device.type != "cuda":
            raise ValueError(f"no forest-rollout kernel for device {device}")
        for name, x in args.items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        batch, n, horizon, _ = noise.shape
        lib = self.library().lib
        with torch.cuda.device(device):
            costs = torch.empty((batch, n, horizon), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.forest_rollout_batch_launch(_vp(q0), _vp(qd0), _vp(extras), _vp(mean),
                                                 _vp(noise), _vp(costs), batch, n, horizon,
                                                 ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError("ForestRollout batched kernel launch failed: "
                               + lib.forest_rollout_error_string(rc).decode())
        ForestRollout.batch_launches += 1
        return costs


def build_forest_rollout(model: ChainModel, n_substeps: int, act_bodies: Sequence[int],
                         task: ForestTask, ulow: float = -1.0,
                         uhigh: float = 1.0) -> ForestRollout:
    """Fused forest rollout (see ForestRollout): act_bodies are the scalar
    bodies that receive u[:, j], in the action layout."""
    return ForestRollout(model, n_substeps, act_bodies, task, ulow, uhigh)
