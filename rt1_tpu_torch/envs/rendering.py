"""Top-down board renderer in numpy (counterpart of `rt1_tpu/envs/rendering.py`).

The JAX package draws the board with PIL's `ImageDraw`; the port draws the
same picture with no imaging library. It keeps the JAX module's geometry
(`_world_to_px`, `_scale`, `_shape_points`) and colours, and follows PIL's
integer rasterization rules, so that the two frames agree pixel for pixel
where the rules below match PIL's (`tests/test_torch_envs_render.py` holds
them together):

* a polygon's vertices are truncated to whole pixels; its fill covers, on
  each row, the pixels from the rounded-up left to the rounded-down right
  crossing of its integer edges (crossings in single precision, a corner
  on a whole pixel moved half a pixel, each pixel drawn once), and its
  1-pixel outline is one Bresenham line per edge without its last point;
* an ellipse's box is truncated to whole pixels, and the ellipse is walked
  in half-pixel units as the quarter-curve of least deviation from
  `a^2 y^2 + b^2 x^2 = a^2 b^2`; an outline of width `w` is the span
  between that curve and the one of a box `2 (w - 1)` smaller;
* a rectangle's corners are truncated and its fill includes both;
* a colour with an alpha below 255 is blended as PIL blends an RGBA ink
  on an RGB image: `(out * (255 - a) + ink * a) / 255`, rounded by the
  same integer division.

`resize_bilinear` is PIL's `Image.resize(..., BILINEAR)` on a uint8
image, in the same fixed-point arithmetic (the same bytes).
`add_debug_info_to_image` is the JAX module's instruction overlay: the
frame upscaled to 640x360, under a white strip of `3 * int(360 * 0.08)`
rows that holds the instruction wrapped at 35 characters. The JAX module
writes the text in PIL's default font; the port writes it in its own 5x7
bitmap font (`rt1_tpu_torch/envs/font.py`), so only the text's pixels
differ.
"""

import functools
import math
import textwrap

import numpy as np

from rt1_tpu_torch.envs import constants, font

BOARD_COLOR = (90, 90, 95)
BORDER_COLOR = (50, 50, 55)
EFFECTOR_COLOR = (20, 20, 20)
EFFECTOR_RING = (230, 230, 230)
GOAL_RING = (0, 255, 0, 160)

BLOCK_COLORS = {
    "red": (205, 60, 50),
    "blue": (60, 90, 205),
    "green": (60, 160, 70),
    "yellow": (230, 200, 50),
    "purple": (140, 60, 200),
}

# Margin of world space drawn around the workspace (meters).
_MARGIN = 0.02


def _world_to_px(xy, image_size):
    """Map board (x, y) to pixel (col, row). x spans image rows (top=X_MIN)."""
    h, w = image_size
    x, y = xy
    row = (x - (constants.X_MIN - _MARGIN)) / (
        (constants.X_MAX - constants.X_MIN) + 2 * _MARGIN
    ) * h
    col = (y - (constants.Y_MIN - _MARGIN)) / (
        (constants.Y_MAX - constants.Y_MIN) + 2 * _MARGIN
    ) * w
    return col, row


def _scale(image_size):
    """Pixels per meter (row axis)."""
    h, _ = image_size
    return h / ((constants.X_MAX - constants.X_MIN) + 2 * _MARGIN)


def _shape_points(shape, yaw, radius):
    """Unit outline for a block shape, rotated by yaw, scaled to radius."""
    if shape == "cube":
        angles = np.array([0.25, 0.75, 1.25, 1.75]) * np.pi
        pts = np.stack([np.cos(angles), np.sin(angles)], -1) * 1.25
    elif shape == "pentagon":
        angles = np.linspace(0, 2 * np.pi, 5, endpoint=False) - np.pi / 2
        pts = np.stack([np.cos(angles), np.sin(angles)], -1) * 1.2
    elif shape == "star":
        angles = np.linspace(0, 2 * np.pi, 10, endpoint=False) - np.pi / 2
        radii = np.where(np.arange(10) % 2 == 0, 1.45, 0.62)
        pts = np.stack([np.cos(angles), np.sin(angles)], -1) * radii[:, None]
    elif shape == "moon":
        # Crescent: approximated by an outer arc + offset inner arc.
        outer = np.linspace(-0.75 * np.pi, 0.75 * np.pi, 12)
        inner = np.linspace(0.6 * np.pi, -0.6 * np.pi, 12)
        pts = np.concatenate([
            np.stack([np.cos(outer), np.sin(outer)], -1) * 1.25,
            np.stack([np.cos(inner) * 0.85 + 0.45, np.sin(inner) * 0.85], -1),
        ])
    elif shape == "pole":
        pts = np.array(
            [[-0.5, -1.6], [0.5, -1.6], [0.5, 1.6], [-0.5, 1.6]]
        )
    else:
        angles = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        pts = np.stack([np.cos(angles), np.sin(angles)], -1)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T * radius


# ------------------------------------------------------------------ pixels


def _round_up(v):
    """PIL's ROUND_UP of a float32: halves away from zero, the half added
    in single precision."""
    v = np.float32(v)
    if v >= 0:
        return int(math.floor(v + np.float32(0.5)))
    return -int(math.floor(-v + np.float32(0.5)))


def _round_down(v):
    """PIL's ROUND_DOWN of a float32: halves toward zero."""
    v = np.float32(v)
    if v >= 0:
        return int(math.ceil(v - np.float32(0.5)))
    return -int(math.ceil(-v - np.float32(0.5)))


def _roundf(v):
    """C's `roundf`: nearest integer, halves away from zero, as a float32
    (exact: a float32 plus 0.5 is exact in double precision)."""
    return np.float32(math.copysign(math.floor(abs(float(v)) + 0.5), v))


def _blend(dst, ink):
    """`dst` (uint8 (..., 3)) with the RGBA `ink` drawn over it."""
    a = ink[3]
    if a == 255:
        dst[...] = ink[:3]
        return
    v = dst.astype(np.int32) * (255 - a) + np.asarray(ink[:3], np.int32) * a + 128
    dst[...] = ((v >> 8) + v) >> 8


def _hline(img, x0, y, x1, ink):
    """Pixels x0..x1 (both included; none if x0 > x1) of row y, clipped."""
    h, w = img.shape[:2]
    if not 0 <= y < h:
        return
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if x0 <= x1:
        _blend(img[y, x0:x1 + 1], ink)


def _point(img, x, y, ink):
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        if ink[3] == 255:
            img[y, x] = ink[:3]
        else:
            _blend(img[y, x], ink)


def _line(img, x0, y0, x1, y1, ink):
    """Bresenham from (x0, y0) toward (x1, y1), the end point excluded."""
    dx, xs = (x1 - x0, 1) if x1 >= x0 else (x0 - x1, -1)
    dy, ys = (y1 - y0, 1) if y1 >= y0 else (y0 - y1, -1)
    if dx == 0:
        for _ in range(dy):
            _point(img, x0, y0, ink)
            y0 += ys
    elif dy == 0:
        for _ in range(dx):
            _point(img, x0, y0, ink)
            x0 += xs
    elif dx > dy:
        n, dy2, dx2 = dx, 2 * dy, 2 * dx
        e = dy2 - dx
        for _ in range(n):
            _point(img, x0, y0, ink)
            if e >= 0:
                y0 += ys
                e -= dx2
            e += dy2
            x0 += xs
    else:
        n, dx2, dy2 = dy, 2 * dx, 2 * dy
        e = dx2 - dy
        for _ in range(n):
            _point(img, x0, y0, ink)
            if e >= 0:
                x0 += xs
                e -= dy2
            e += dx2
            y0 += ys


def _rectangle(img, box, ink):
    """Filled rectangle over the truncated corners, both included."""
    x0, y0, x1, y1 = (int(v) for v in box)
    for y in range(max(y0, 0), min(y1, img.shape[0] - 1) + 1):
        _hline(img, x0, y, x1, ink)


class _Edge:
    __slots__ = ("xmin", "xmax", "ymin", "ymax", "x0", "y0", "dx")

    def __init__(self, x0, y0, x1, y1):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        # Slopes and crossings in single precision, as PIL computes them.
        self.dx = np.float32(0.0) if y0 == y1 else np.float32(x1 - x0) / np.float32(y1 - y0)
        self.x0, self.y0 = x0, y0

    def x_at(self, y):
        return np.float32(y - self.y0) * self.dx + np.float32(self.x0)


def _polygon_edges(xy):
    """Edges of the closed integer polygon `xy`; consecutive horizontal
    edges running the same way merge into one."""
    edges = []
    n = len(xy)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            last = edges[-1]
            if x1 > x0 > xy[i - 1][0]:
                last.xmax = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                last.xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if xy[-1] != xy[0]:
        edges.append(_Edge(xy[-1][0], xy[-1][1], xy[0][0], xy[0][1]))
    return edges


def _horizontal_edges(img, edges, ink, x_pos, y):
    """Draw row y's horizontal edges that start at or before `x_pos` (-1:
    any), from `x_pos` on; returns the new `x_pos`."""
    for e in edges:
        if e.ymin == y and e.ymin == e.ymax:
            if x_pos != -1 and x_pos < e.xmin:
                continue
            xmin = e.xmin
            if x_pos > xmin:
                xmin = x_pos
                if e.xmax < xmin:
                    continue
            _hline(img, xmin, y, e.xmax, ink)
            x_pos = e.xmax + 1
    return x_pos


def _fill_polygon(img, xy, ink):
    """Scanline fill of the integer polygon `xy`, each pixel drawn once."""
    edges = _polygon_edges(xy)
    if not edges:
        return
    ymin = min(min(e.ymin for e in edges), img.shape[0] - 1)
    ymax = max(max(e.ymax for e in edges), 0)
    sloped = [e for e in edges if e.ymin != e.ymax]
    ymin = max(ymin, 0)
    ymax = min(ymax, img.shape[0])
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(sloped):
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.x_at(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])
            elif cur.dx != 0 and len(xx) % 2 == 1 and _roundf(xx[-1]) == xx[-1]:
                # A corner on a whole pixel: move the crossing half a pixel
                # beyond the two edges' crossings of the adjacent row.
                for other in sloped[:i]:
                    if (cur.dx > 0 and other.dx <= 0) or (cur.dx < 0 and other.dx >= 0):
                        continue
                    if not other.ymin <= y <= other.ymax or \
                            _roundf(xx[-1]) != _roundf(other.x_at(y)):
                        continue
                    y_adj = y - 1 if y == cur.ymax else y + 1
                    if not other.ymin <= y_adj <= other.ymax:
                        continue
                    adj, adj_other = cur.x_at(y_adj), other.x_at(y_adj)
                    if xx[-1] > adj + 1 and xx[-1] > adj_other + 1:
                        xx[-1] = _roundf(max(adj, adj_other)) + np.float32(0.5)
                    elif xx[-1] < adj - 1 and xx[-1] < adj_other - 1:
                        xx[-1] = _roundf(min(adj, adj_other)) - np.float32(0.5)
                    break
        xx.sort()
        x_pos = -1 if not xx else 0
        for i in range(1, len(xx), 2):
            x_end = _round_down(xx[i])
            if x_end < x_pos:
                continue
            x_pos = _horizontal_edges(img, edges, ink, x_pos, y)
            if x_end < x_pos:
                continue
            x_start = _round_up(xx[i - 1])
            if x_pos > x_start:
                x_start = x_pos
                if x_end < x_start:
                    continue
            _hline(img, x_start, y, x_end, ink)
            x_pos = x_end + 1
        _horizontal_edges(img, edges, ink, x_pos, y)


def _polygon(img, points, fill, outline):
    """A polygon over float `points` (truncated), filled and outlined 1
    pixel wide."""
    xy = [(int(x), int(y)) for x, y in points]
    _fill_polygon(img, xy, fill)
    for i in range(len(xy)):
        (x0, y0), (x1, y1) = xy[i], xy[(i + 1) % len(xy)]
        _line(img, x0, y0, x1, y1, outline)


class _Quarter:
    """One quarter of an ellipse of box (a, b), in half-pixel units from
    its centre, walked from (a, b % 2) to (a % 2, b)."""

    def __init__(self, a, b):
        self.finished = a < 0 or b < 0
        if not self.finished:
            self.cx, self.cy, self.ex, self.ey = a, b % 2, a % 2, b
            self.a2, self.b2 = a * a, b * b
            self.a2b2 = self.a2 * self.b2

    def _delta(self, x, y):
        return abs(self.a2 * y * y + self.b2 * x * x - self.a2b2)

    def next(self):
        if self.finished:
            return None
        ret = (self.cx, self.cy)
        if self.cx == self.ex and self.cy == self.ey:
            self.finished = True
        else:
            nx, ny = self.cx, self.cy + 2
            nd = self._delta(nx, ny)
            if nx > 1:
                d = self._delta(self.cx - 2, self.cy + 2)
                if nd > d:
                    nx, ny, nd = self.cx - 2, self.cy + 2, d
                d = self._delta(self.cx - 2, self.cy)
                if nd > d:
                    nx, ny = self.cx - 2, self.cy
            self.cx, self.cy = nx, ny
        return ret


def _ellipse_spans(a, b, width):
    """(x0, y, x1) spans of a ring of `width` pixels inside an ellipse of
    box (a, b), in half-pixel units from the centre."""
    outer = _Quarter(a, b)
    first = outer.next()
    if width < 1 or first is None:
        return
    leftmost = a % 2
    pr, py = first
    inner = _Quarter(a - 2 * (width - 1), b - 2 * (width - 1))
    pl = leftmost
    finished = False
    while not finished:
        y, left, right = py, pl, pr
        while True:
            nxt = outer.next()
            if nxt is None or nxt[1] > y:
                break
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        while True:
            nxt = inner.next()
            if nxt is None or nxt[1] > y:
                break
            left = nxt[0]
        pl = leftmost if nxt is None else nxt[0]
        spans = []
        if (left > 0 or left < right) and y > 0:
            spans.append((2 if left == 0 else left, y, right))
        if y > 0:
            spans.append((-right, y, -left))
        if left > 0 or left < right:
            spans.append((2 if left == 0 else left, -y, right))
        spans.append((-right, -y, -left))
        yield from reversed(spans)


def _ellipse(img, box, ink, width=None):
    """An ellipse in the truncated `box`: filled when `width` is None, else
    an outline `width` pixels wide."""
    x0, y0, x1, y1 = (int(v) for v in box)
    a, b = x1 - x0, y1 - y0
    if a < 0 or b < 0:
        return
    for sx0, sy, sx1 in _ellipse_spans(a, b, a + b if width is None else width):
        _hline(img, x0 + (sx0 + a) // 2, y0 + (sy + b) // 2, x0 + (sx1 + a) // 2, ink)


@functools.lru_cache(maxsize=8)
def _background(image_size):
    """The border and the workspace surface, drawn once per frame size."""
    h, w = image_size
    img = np.empty((h, w, 3), np.uint8)
    img[...] = BORDER_COLOR
    x0, y0 = _world_to_px((constants.X_MIN, constants.Y_MIN), image_size)
    x1, y1 = _world_to_px((constants.X_MAX, constants.Y_MAX), image_size)
    _rectangle(img, (x0, y0, x1, y1), BOARD_COLOR + (255,))
    img.flags.writeable = False
    return img


def render_board(block_poses, effector_xy, image_size=None, goal_region=None):
    """Render the board state to an RGB uint8 array.

    Args:
      block_poses: {block_name: (xy, yaw)} for blocks on the table.
      effector_xy: (x, y) of the effector cylinder.
      image_size: (height, width); defaults to the reference camera size.
      goal_region: optional (target_xy, radius) drawn as a translucent ring.
    """
    from rt1_tpu_torch.envs.backends.kinematic import BLOCK_RADIUS, EFFECTOR_RADIUS

    if image_size is None:
        image_size = (constants.IMAGE_HEIGHT, constants.IMAGE_WIDTH)
    img = _background(tuple(image_size)).copy()
    px_per_m = _scale(image_size)

    if goal_region is not None and goal_region[0] is not None:
        gx, gy = _world_to_px(goal_region[0], image_size)
        gr = goal_region[1] * px_per_m
        _ellipse(img, (gx - gr, gy - gr, gx + gr, gy + gr), GOAL_RING, width=2)

    for name, (xy, yaw) in block_poses.items():
        color_name, shape = name.split("_")
        color = BLOCK_COLORS.get(color_name, (128, 128, 128))
        cx, cy = _world_to_px(xy, image_size)
        pts = _shape_points(shape, yaw, BLOCK_RADIUS * px_per_m)
        # world (x -> row, y -> col): point offsets are (dy -> px, dx -> py).
        poly = [(cx + float(p[1]), cy + float(p[0])) for p in pts]
        _polygon(img, poly, color + (255,), tuple(int(c * 0.6) for c in color) + (255,))

    ex, ey = _world_to_px(effector_xy, image_size)
    er = EFFECTOR_RADIUS * px_per_m * 1.4
    box = (ex - er, ey - er, ex + er, ey + er)
    _ellipse(img, box, EFFECTOR_COLOR + (255,))
    _ellipse(img, box, EFFECTOR_RING + (255,), width=1)
    return img


# ------------------------------------------------------------ resize, text

_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


@functools.lru_cache(maxsize=16)
def _bilinear_taps(in_size, out_size):
    """(source index (out, k), int64 weight (out, k)) of PIL's bilinear
    resampling of one axis: the triangle filter widened by the scale when
    shrinking, normalised, then rounded to `_PRECISION_BITS` fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.intp)
    weight = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale)) for x in range(xmax)]
        total = sum(k)
        for x, w in enumerate(k):
            w = w / total if total != 0.0 else w
            index[xx, x] = xmin + x
            weight[xx, x] = int(0.5 + w * (1 << _PRECISION_BITS)) if w >= 0 else \
                int(-0.5 + w * (1 << _PRECISION_BITS))
    index.flags.writeable = weight.flags.writeable = False
    return index, weight


def _resample_axis(img, axis, out_size):
    """One pass of PIL's 8-bit resampling along `axis` (0 rows, 1 columns),
    tap by tap. The sums fit int32 as PIL's do: the weights are at most
    2^22 and sum to about 2^22."""
    index, weight = _bilinear_taps(img.shape[axis], out_size)
    shape = (1,) * axis + (out_size,) + (1,) * (img.ndim - axis - 1)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(index.shape[1]):
        acc += np.take(img, index[:, j], axis=axis).astype(np.int32) * weight[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(image, height, width):
    """PIL's `Image.fromarray(image).resize((width, height), BILINEAR)` of
    a uint8 (H, W, 3) image: columns first, then rows, each rounded to
    uint8; an unchanged size is a copy."""
    img = np.asarray(image, np.uint8)
    if img.shape[1] != width:
        img = _resample_axis(img, 1, width)
    if img.shape[0] != height:
        img = _resample_axis(img, 0, height)
    return img.copy() if img is image else img


def draw_text(img, x, y, text):
    """Write `text` in black with its top-left corner at (x, y) in the
    bitmap font, clipped to the image."""
    h, w = img.shape[:2]
    for i, char in enumerate(text):
        glyph = font.glyph(char)
        gy, gx = np.nonzero(glyph)
        px, py = gx + x + i * font.ADVANCE, gy + y
        keep = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        img[py[keep], px[keep]] = 0


def add_debug_info_to_image(image, info_dict):
    """Upscale to 640x360 and write the wrapped instruction above the frame
    (the JAX module's layout, the reference's `language_table.py:1000-1029`):
    a white strip of `3 * int(360 * 0.08)` rows, 35 characters a line, a
    line every 14 rows from (2, 2)."""
    frame = resize_bilinear(image, 360, 640)
    text = ""
    if "instruction" in info_dict:
        text = "instruction: %s" % info_dict["instruction"]
    strip_h = int(3 * int(360 * 0.08))
    canvas = np.full((360 + strip_h, 640, 3), 255, np.uint8)
    canvas[strip_h:] = frame
    y = 2
    for line in textwrap.wrap(text, width=35):
        draw_text(canvas, 2, y, line)
        y += 14
    return canvas
