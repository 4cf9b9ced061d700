"""Trajectory rendering and video dumping (counterpart of
mjmpc_tpu/render/).

Frames are drawn from recorded env states by hand, in numpy
(render/raster.py takes the place of the matplotlib Agg canvas): chain
envs draw their kinematic skeleton from forward kinematics, the classic
control envs analytic sketches. Videos are GIF89a files written by
render/gif.py. No imaging library is imported.
"""
from .render import SUPPORTED, dump_videos, render_trajectory

__all__ = ["render_trajectory", "dump_videos", "SUPPORTED"]
