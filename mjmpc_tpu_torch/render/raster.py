"""A numpy rasteriser of the primitives the env renderers draw.

It takes the place of the matplotlib Agg canvas of the JAX package's
renderers (mjmpc_tpu/render/render.py): a figure of figsize x dpi pixels
(4 x 4 inches at 80 dpi: 320 x 320), a white background and one axes box
at matplotlib's default subplot position, shrunk about its centre to
equal aspect as `ax.set_aspect("equal")` does. World coordinates map into
that box from the scene's x and y limits; everything is clipped to it.

The primitives mirror the matplotlib artists the renderers make, with
their widths and marker sizes in points (1/72 inch):

- Line: a Line2D (a polyline with round joints; solid with a
  "projecting" or "round" cap, or dashed with matplotlib's default dash
  pattern of 3.7 and 1.6 line widths and butt caps; "o" and "*" markers
  with their 1 pt edge);
- HLine: `ax.axhline`, across the whole box;
- Disc: `plt.Circle` (filled, with alpha);
- Rect: `plt.Rectangle` (filled).

As in matplotlib, patches (Disc, Rect) are drawn before lines whatever
the order they were added in (their zorder is 1, a line's 2), and each
kind in the order added. Coverage is binary (a pixel is painted when its
centre is inside the shape; a line is at least one pixel wide), so a
frame holds only the scene's colours and their alpha blends: the GIF
palette (render/gif.py) holds them. Title text, ticks and spines are not
drawn.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

DPI = 80
FIGSIZE = (4, 4)
PT = DPI / 72.0                       # pixels per point
SUBPLOT = (0.125, 0.11, 0.9, 0.88)    # matplotlib's default left, bottom, right, top
MARKER_EDGE_PT = 1.0                  # lines.markeredgewidth
DASH_PATTERN = (3.7, 1.6)             # lines.dashed_pattern, in line widths
STAR_INNER = 0.381966                 # MarkerStyle("*")'s inner radius

COLORS = {
    "white": (255, 255, 255),
    "black": (0, 0, 0),
    "k": (0, 0, 0),
    "tab:blue": (31, 119, 180),
    "tab:red": (214, 39, 40),
    "green": (0, 128, 0),
    "g": (0, 128, 0),
    "gray": (128, 128, 128),
    "saddlebrown": (139, 69, 19),
    "dimgray": (105, 105, 105),
}


@dataclasses.dataclass(frozen=True)
class Line:
    """A matplotlib Line2D: points [n, 2] in world coordinates."""
    xy: np.ndarray
    color: str
    width: float = 1.5          # points
    style: str = "-"            # "-", "--" or "" (markers only)
    marker: str = ""            # "", "o" or "*"
    marker_size: float = 6.0    # points
    cap: str = "projecting"     # solid cap: "projecting" or "round"


@dataclasses.dataclass(frozen=True)
class HLine:
    """`ax.axhline(y)`."""
    y: float
    color: str
    width: float


@dataclasses.dataclass(frozen=True)
class Disc:
    """`plt.Circle(center, radius)`, filled."""
    center: np.ndarray
    radius: float
    color: str
    alpha: float = 1.0


@dataclasses.dataclass(frozen=True)
class Rect:
    """`plt.Rectangle(xy, width, height)`, filled."""
    xy: np.ndarray
    width: float
    height: float
    color: str


@dataclasses.dataclass(frozen=True)
class Scene:
    """One frame's primitives in the order the renderer adds them, and its
    axes limits."""
    xlim: Tuple[float, float]
    ylim: Tuple[float, float]
    items: Tuple


class View:
    """World to pixel mapping of one axes box at equal aspect."""

    def __init__(self, xlim: Sequence[float], ylim: Sequence[float],
                 figsize: Sequence[float] = FIGSIZE):
        self.width, self.height = int(round(figsize[0] * DPI)), int(round(figsize[1] * DPI))
        left, bottom, right, top = SUBPLOT
        box_w, box_h = (right - left) * self.width, (top - bottom) * self.height
        self.x0, self.y0 = float(xlim[0]), float(ylim[0])
        span_x, span_y = float(xlim[1]) - self.x0, float(ylim[1]) - self.y0
        self.scale = min(box_w / span_x, box_h / span_y)       # pixels per world unit
        w, h = self.scale * span_x, self.scale * span_y
        # the box shrinks along its longer side, about its centre (anchor "C")
        self.left = left * self.width + 0.5 * (box_w - w)
        self.bottom = bottom * self.height + 0.5 * (box_h - h)
        self.right, self.top = self.left + w, self.bottom + h

    def to_display(self, xy) -> np.ndarray:
        """World [..., 2] to display coordinates (pixels, y up from the
        figure's bottom edge)."""
        xy = np.asarray(xy, np.float64)
        return np.stack([self.left + (xy[..., 0] - self.x0) * self.scale,
                         self.bottom + (xy[..., 1] - self.y0) * self.scale], -1)


class Canvas:
    """An RGB frame being painted, clipped to a view's axes box."""

    def __init__(self, view: View):
        self.view = view
        self.rgb = np.full((view.height, view.width, 3), 255.0, np.float64)

    def _window(self, lo, hi):
        """Pixel rows, columns and centres (display coordinates) of the
        pixels whose centres lie in [lo, hi] and inside the axes box."""
        v = self.view
        x_lo, x_hi = max(lo[0], v.left), min(hi[0], v.right)
        y_lo, y_hi = max(lo[1], v.bottom), min(hi[1], v.top)
        c0, c1 = max(int(np.ceil(x_lo - 0.5)), 0), min(int(np.floor(x_hi - 0.5)), v.width - 1)
        # pixel row r has its centre at display y = height - r - 0.5
        r0 = max(int(np.ceil(v.height - y_hi - 0.5)), 0)
        r1 = min(int(np.floor(v.height - y_lo - 0.5)), v.height - 1)
        if c0 > c1 or r0 > r1:
            return None
        px = np.arange(c0, c1 + 1) + 0.5
        py = v.height - (np.arange(r0, r1 + 1) + 0.5)
        return slice(r0, r1 + 1), slice(c0, c1 + 1), px[None, :], py[:, None]

    def paint(self, lo, hi, inside, color: str, alpha: float = 1.0) -> None:
        """Paint the pixels of the window [lo, hi] for which
        inside(px, py) holds."""
        win = self._window(lo, hi)
        if win is None:
            return
        rows, cols, px, py = win
        mask = inside(px, py)
        if not mask.any():
            return
        region = self.rgb[rows, cols]
        c = np.asarray(COLORS[color], np.float64)
        region[mask] = alpha * c + (1.0 - alpha) * region[mask]
        self.rgb[rows, cols] = region

    def frame(self) -> np.ndarray:
        return np.rint(self.rgb).astype(np.uint8)


def _segment(canvas: Canvas, p0, p1, r: float, color: str, ext0: float = 0.0,
             ext1: float = 0.0) -> None:
    """A butt-capped segment between display points p0 and p1, half-width
    r pixels, extended by ext0 before p0 and ext1 past p1 (a projecting
    cap extends by r). A segment of length 0 paints nothing."""
    d = p1 - p0
    length = float(np.hypot(*d))
    if length == 0.0:
        return
    u = d / length
    lo, hi = np.minimum(p0, p1) - r - max(ext0, ext1), np.maximum(p0, p1) + r + max(ext0, ext1)

    def inside(px, py):
        rx, ry = px - p0[0], py - p0[1]
        t = rx * u[0] + ry * u[1]
        return (t >= -ext0) & (t <= length + ext1) & (np.abs(rx * u[1] - ry * u[0]) <= r)

    canvas.paint(lo, hi, inside, color)


def _whole_window(px, py):
    return np.ones(np.broadcast_shapes(px.shape, py.shape), bool)


def _disc(canvas: Canvas, c, r: float, color: str, alpha: float = 1.0) -> None:
    canvas.paint(c - r, c + r, lambda px, py: np.hypot(px - c[0], py - c[1]) <= r, color, alpha)


def _star(canvas: Canvas, c, r: float, color: str) -> None:
    """A filled five-point star of outer radius r, one point up."""
    ang = np.pi / 2 + np.arange(10) * np.pi / 5
    rad = np.where(np.arange(10) % 2 == 0, r, r * STAR_INNER)
    vx, vy = c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)

    def inside(px, py):
        odd = np.zeros(np.broadcast_shapes(px.shape, py.shape), bool)
        for i in range(10):              # even-odd rule over the ten edges
            x0, y0, x1, y1 = vx[i], vy[i], vx[i - 1], vy[i - 1]
            crosses = (y0 > py) != (y1 > py)
            x_at = x0 + (py - y0) * (x1 - x0) / (y1 - y0 if y1 != y0 else 1.0)
            odd ^= crosses & (px < x_at)
        return odd

    canvas.paint(c - r, c + r, inside, color)


def _dashes(p0, p1, on: float, off: float, phase: float):
    """The dashes of the segment p0 -> p1 (display), the pattern starting
    `phase` pixels into its period; returns the pieces and the phase at
    p1."""
    d = p1 - p0
    length = float(np.hypot(*d))
    period = on + off
    pieces = []
    start = -phase                       # dash k covers [start + k period, ... + on)
    while start < length:
        a, b = max(start, 0.0), min(start + on, length)
        if b > a:
            pieces.append((p0 + d * (a / length), p0 + d * (b / length)))
        start += period
    return pieces, (phase + length) % period


def _line(canvas: Canvas, line: Line) -> None:
    pts = canvas.view.to_display(line.xy)
    r = max(0.5 * line.width * PT, 0.5)
    if line.style == "-":
        ext = r if line.cap == "projecting" else 0.0
        last = len(pts) - 2
        for i in range(len(pts) - 1):
            _segment(canvas, pts[i], pts[i + 1], r, line.color, ext if i == 0 else 0.0,
                     ext if i == last else 0.0)
        # round joints, and round caps at the two ends
        joints = pts if line.cap == "round" else pts[1:-1]
        for p in joints:
            _disc(canvas, p, r, line.color)
    elif line.style == "--":
        on, off = (k * line.width * PT for k in DASH_PATTERN)
        phase = 0.0
        for i in range(len(pts) - 1):
            pieces, phase = _dashes(pts[i], pts[i + 1], on, off, phase)
            for a, b in pieces:
                _segment(canvas, a, b, r, line.color)
    elif line.style:
        raise ValueError(f"line style {line.style!r}")
    size = 0.5 * (line.marker_size + MARKER_EDGE_PT) * PT
    for p in pts:
        if line.marker == "o":
            _disc(canvas, p, size, line.color)
        elif line.marker == "*":
            _star(canvas, p, size, line.color)
        elif line.marker:
            raise ValueError(f"marker {line.marker!r}")


def draw(scene: Scene, figsize: Sequence[float] = FIGSIZE) -> np.ndarray:
    """The scene's frame, [figsize x DPI, 3] uint8."""
    view = View(scene.xlim, scene.ylim, figsize)
    canvas = Canvas(view)
    patches = [it for it in scene.items if isinstance(it, (Disc, Rect))]
    lines = [it for it in scene.items if isinstance(it, (Line, HLine))]
    for it in patches:
        if isinstance(it, Disc):
            _disc(canvas, view.to_display(it.center), it.radius * view.scale, it.color,
                  it.alpha)
        else:
            lo = view.to_display(it.xy)
            hi = view.to_display(np.asarray(it.xy, np.float64) + (it.width, it.height))
            canvas.paint(np.minimum(lo, hi), np.maximum(lo, hi), _whole_window, it.color)
    for it in lines:
        if isinstance(it, HLine):
            y = view.to_display((view.x0, it.y))[1]
            r = max(0.5 * it.width * PT, 0.5)
            _segment(canvas, np.array([view.left, y]), np.array([view.right, y]), r, it.color)
        else:
            _line(canvas, it)
    return canvas.frame()


def palette_colors() -> List[Tuple[int, int, int]]:
    """Every colour a frame can hold: the named colours, and the blends of
    the renderers' translucent discs (gray at 0.5, tab:red at 0.8) over
    white and over each other, rounded as Canvas.frame rounds."""
    base = [COLORS[k] for k in ("white", "black", "tab:blue", "tab:red", "green", "gray",
                                "saddlebrown", "dimgray")]
    out = list(base)
    layers = [(np.asarray(COLORS["gray"], np.float64), 0.5),
              (np.asarray(COLORS["tab:red"], np.float64), 0.8)]
    under = [np.asarray(c, np.float64) for c in base]
    for _ in range(2):                   # up to two translucent discs on top of each other
        under = [a * c + (1.0 - a) * u for u in under for c, a in layers]
        out += [tuple(int(v) for v in np.rint(u)) for u in under]
    seen, unique = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            unique.append(c)
    return unique
