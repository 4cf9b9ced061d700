"""Adroit-scale five-digit dexterous hand for the hand-manipulation suite.

Counterpart of mjmpc_tpu/envs/adroit.py (host-side numpy body tables, the
same numbers). The hand matches Adroit's 24-hinge-DOF budget with the
Shadow Hand's allocation: a 2-DOF wrist (flexion about x, deviation about
y, the shared root of all digits), three 4-DOF fingers (abduction and
three phalanx curls), a 5-DOF little finger (an extra metacarpal curl) and
a 5-DOF thumb (an extra opposition roll about y). Fingertips manipulate
free (quaternion-state) objects through the compliant contact model of
envs/contact.py; actions actuate hand joints only, never the object.

Digit layout (palm plane z = 0, objects rest on or above the palm): four
fingers at (+-x_spread, +-y_spread, height) plus the thumb at
(0, -y_spread), segments pointing down and inward so that digits on +y
oppose digits on -y like finger/thumb pinch pairs. Every joint is zero at
neutral. Segment geometry is a parameter: the pen hand uses long
manipulation segments, the arm-mounted grip hand (relocate, hammer, door)
short cage segments.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..engine import chain as rb

# Manipulation-hand digit geometry (meters): per-phalanx (inward, down)
# reach. Neutral tips land at |y| = Y_SPREAD - 0.042 = 0.021,
# z = HEIGHT - 0.076 = 0.054 — just below the raised-cradle pen center
# (envs/pen.py, center z = 0.072), exactly engaging a resting pen of
# radius 0.012 with tip radius 0.009.
SEGS_PEN = ((0.018, 0.030), (0.014, 0.026), (0.010, 0.020))
X_SPREAD = 0.045
Y_SPREAD = 0.063
HEIGHT = 0.130
TIP_R = 0.009
_SEG_R = 0.008

N_DIGITS = 5
# Shadow-Hand DOF allocation (mj_envs Adroit): FF/MF/RF = 4, LF = 5
# (metacarpal), TH = 5 (opposition roll). Digit order here: the four
# fingers (+x+y, -x+y, +x-y, -x-y) then the thumb at (0, -y).
DIGIT_DOFS = (4, 4, 4, 5, 5)
N_WRIST_DOF = 2                          # flexion (x) + deviation (y)
N_HAND_DOF = N_WRIST_DOF + sum(DIGIT_DOFS)   # 24 — Adroit's count
N_HAND_BODIES = N_HAND_DOF               # one body per hinge

# DOF-layout helpers (hand-local indices; also valid as body indices
# within the hand since every hinge owns one body)
DIGIT_STARTS = tuple(
    N_WRIST_DOF + sum(DIGIT_DOFS[:d]) for d in range(N_DIGITS))


def digit_abduct_index(d: int) -> int:
    """Hand-local index of digit d's abduction joint."""
    return DIGIT_STARTS[d]


def digit_curl_indices(d: int):
    """Hand-local indices of digit d's three phalanx curls (always the
    last three joints of the digit, after abduction and any extra
    metacarpal/opposition joint)."""
    start, ndof = DIGIT_STARTS[d], DIGIT_DOFS[d]
    return list(range(start + ndof - 3, start + ndof))

# Grip-hand (relocate/hammer/door) segments: total reach (0.034 inward,
# 0.053 down) — identical to the tuned round-2 cage, so the neutral tip
# ring closing onto a ~0.044-radius sphere from the 0.050-radius ring is
# preserved; the 4th DOF and 5th digit only ADD closing envelope.
SEGS_GRIP = ((0.012, 0.020), (0.012, 0.018), (0.010, 0.015))
GRIP_BASES = [(sx * 0.045, s * 0.045, 0.065, s)
              for s in (1.0, -1.0) for sx in (1.0, -1.0)] \
    + [(0.0, -0.0636, 0.065, -1.0)]
PALM_LOCAL = (0.0, 0.0, 0.075)
PALM_R = 0.015


def digit_bases() -> List[Tuple[float, float, float, float]]:
    """(x, y, z, side) for the five knuckles; side = sign(y). The thumb
    sits at x = 0 on the -y side, opposing the +y finger pair across
    the pen's resting line."""
    return [(sx * X_SPREAD, s * Y_SPREAD, HEIGHT, s)
            for s in (1.0, -1.0) for sx in (1.0, -1.0)] \
        + [(0.0, -Y_SPREAD, HEIGHT, -1.0)]


def hand_bodies(parent: int = -1,
                bases: Optional[Sequence[Tuple[float, float, float, float]]]
                = None,
                gear: float = 0.4, damping: float = 0.08,
                armature: float = 0.01,
                segments: Sequence[Tuple[float, float]] = SEGS_PEN,
                wrist_gear: float = 1.5, wrist_damping: float = 0.5,
                wrist_armature: float = 0.05) -> Tuple[list, list]:
    """Body dicts for the 24-DOF hand plus per-digit contact metadata.

    Layout: a 2-DOF wrist gimbal (flexion about x, deviation about y)
    anchored at the palm center (0, 0, base z), from which all five
    digits hang; three 4-DOF fingers, a 5-DOF little finger (extra
    metacarpal curl), a 5-DOF thumb (extra opposition roll). All added
    joints are zero at neutral, so the resting tip ring matches the
    wrist-less 20-DOF layout exactly.

    Returns (bodies, digits) where each digits entry is
    (distal_body_index, tip_local [3], mid_local [3]) — the two contact
    spheres per digit fed to `engine.chain.points_frame`. The wrist root
    dict carries a `mount=True` marker; intra-hand parent indices are
    local (relative to the start of the returned list). Callers
    embedding the hand at a nonzero index base must offset the local
    parents and re-parent the marked root (see `arm_hand_bodies`) — the
    marker, not the parent VALUE, distinguishes the mount, so a layout
    whose local indices happen to collide with the mount index cannot
    silently build a wrong topology.
    """
    bodies: list = []
    digits: list = []
    segs = list(segments)
    bases = list(bases or digit_bases())
    anchor_z = bases[0][2]
    # 2-DOF wrist gimbal at the palm anchor; flexion tips the digit
    # array toward ±y (the pinch plane), deviation sweeps it along x
    bodies.append(dict(
        pos=(0.0, 0.0, anchor_z), axis=(1, 0, 0), range=(-0.45, 0.45),
        parent=parent, mount=True, gear=wrist_gear,
        damping=wrist_damping, armature=wrist_armature, geoms=[]))
    bodies.append(dict(
        pos=(0.0, 0.0, 0.0), axis=(0, 1, 0), range=(-0.45, 0.45),
        parent=0, gear=wrist_gear, damping=wrist_damping,
        armature=wrist_armature, geoms=[]))
    for d, (bx, by, bz, s) in enumerate(bases):
        thumb = d == len(bases) - 1
        bodies.append(dict(
            pos=(bx, by, bz - anchor_z), axis=(0, 0, 1),
            range=(-0.45, 0.45), parent=1, gear=gear, damping=damping,
            armature=armature, geoms=[]))
        prev = len(bodies) - 1
        if DIGIT_DOFS[d] == 5:
            # thumb: opposition roll about y (Shadow THJ4); little
            # finger: metacarpal curl about x (Shadow LFJ4)
            bodies.append(dict(
                pos=(0.0, 0.0, 0.0),
                axis=(0, 1, 0) if thumb else (1, 0, 0),
                range=(-0.6, 0.6) if thumb else (-0.2, 0.7),
                parent=prev, gear=gear, damping=damping,
                armature=armature, geoms=[]))
            prev = len(bodies) - 1
        # phalanx chain: each link hinges about x at the previous link's
        # endpoint, its capsule reaching (inward, down) = (-s*dy, -dz)
        prev_end = (0.0, 0.0, 0.0)
        for j, (dy, dz) in enumerate(segs):
            r = _SEG_R + 0.001 if j == 0 else _SEG_R
            geoms = [rb.capsule_geom(r, (0, 0, 0, 0, -s * dy, -dz))]
            if j == len(segs) - 1:
                geoms.append(rb.sphere_geom(TIP_R, (0, -s * dy, -dz)))
            bodies.append(dict(
                pos=prev_end, axis=(1, 0, 0), range=(-1.3, 1.3),
                parent=prev, gear=gear, damping=damping,
                armature=armature, geoms=geoms))
            prev = len(bodies) - 1
            prev_end = (0.0, -s * dy, -dz)
        dy, dz = segs[-1]
        digits.append((prev,
                       np.array([0.0, -s * dy, -dz], np.float32),
                       np.array([0.0, -s * dy / 2, -dz / 2], np.float32)))
    return bodies, digits


def arm_hand_bodies(bases=None, arm_gear: float = 8.0,
                    arm_damping: float = 2.0, arm_armature: float = 0.2):
    """3-slide arm (x/y/z translation, z carries a palm plate) with the
    five-digit grip hand mounted on the z-slide — the shared base
    assembly of relocate/hammer/door. Returns (bodies, digits) with
    digit body indices and knuckle parents already offset past the 3 arm
    bodies. Host data only: engine.chain.build_chain puts it on a device
    when an env is made."""
    bases = GRIP_BASES if bases is None else bases
    slide_axes = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    bodies = [dict(pos=(0, 0, 0), axis=ax, type="slide",
                   range=(-0.6, 0.6) if i < 2 else (-0.05, 0.5),
                   parent=i - 1, gear=arm_gear, damping=arm_damping,
                   armature=arm_armature,
                   geoms=[] if i < 2 else
                   [rb.box_geom((0.04, 0.04, 0.008), (0, 0, 0.075))])
              for i, ax in enumerate(slide_axes)]
    hand, digits = hand_bodies(parent=2, bases=bases, segments=SEGS_GRIP)
    for b in hand:
        if not b.pop("mount", False):   # the wrist root keeps the mount
            b["parent"] += 3            # parent; local hand indices
                                        # shift past the arm
    bodies += hand
    return bodies, [(b + 3, tip, mid) for (b, tip, mid) in digits]


def arm_hand_weight(model: rb.ChainModel) -> np.float32:
    """The weight that the arm's z slide carries in an arm_hand_bodies
    model: its first 3 + N_HAND_BODIES bodies (the slides and the hand) under
    9.81 m/s^2, as one float32."""
    return np.float32(9.81) * np.float32(model.mass[:3 + N_HAND_BODIES].sum().item())


def hand_joint_names() -> List[str]:
    """MuJoCo-style joint names for the dyn-randomize name tables, in
    body/DOF order (wrist pair first, then digits)."""
    names = ["wrist_flex", "wrist_dev"]
    for d in range(N_DIGITS):
        names.append(f"digit{d}_abduct")
        if DIGIT_DOFS[d] == 5:
            names.append(f"digit{d}_opp" if d == N_DIGITS - 1
                         else f"digit{d}_meta")
        names += [f"digit{d}_proximal", f"digit{d}_middle",
                  f"digit{d}_distal"]
    return names
