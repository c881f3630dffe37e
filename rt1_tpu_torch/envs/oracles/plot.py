"""Planner / oracle debug pictures (counterpart of
`rt1_tpu/envs/oracles/plot.py`): the RRT* tree, the inflated obstacles and
the planned path over the board, as RGB arrays.

The JAX module draws with PIL; the port draws the same pictures with the
numpy rasterizer of `rendering.py`, which follows PIL's integer rules, so
the bytes are JAX's. A line of width 1 is one Bresenham segment per pair of
points without its end, then the polyline's last point; a wider line is,
per segment, the filled quadrilateral PIL computes for it. A background
frame is resized with PIL's bilinear filter (`rendering.resize_bilinear`).

All drawing is in board (world) coordinates; `image_size` is (height,
width).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from rt1_tpu_torch.envs import rendering
from rt1_tpu_torch.envs.rendering import _scale, _world_to_px

TREE_COLOR = (120, 200, 255, 110)
OBSTACLE_COLOR = (230, 90, 70, 90)
OBSTACLE_EDGE = (230, 90, 70, 220)
PATH_COLOR = (255, 230, 60, 255)
START_COLOR = (60, 220, 90, 255)
GOAL_COLOR = (255, 90, 200, 255)


def _round_up(f: float) -> int:
    """PIL's ROUND_UP of a double."""
    return int(math.floor(f + 0.5)) if f >= 0.0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    """PIL's ROUND_DOWN of a double."""
    return int(math.ceil(f - 0.5)) if f >= 0.0 else -int(math.ceil(abs(f) - 0.5))


def _wide_segment(img, x0, y0, x1, y1, ink, width):
    """PIL's wide line from (x0, y0) to (x1, y1): the quadrilateral
    `width` pixels across, filled."""
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        rendering._point(img, x0, y0, ink)
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max, ratio_min = _round_up(small) / big, _round_down(small) / big
    dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
    dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
    rendering._fill_polygon(img, [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
                                  (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)], ink)


def _draw_line(img, points, ink, width=1):
    """PIL's `ImageDraw.line(points, fill=ink, width=width)` on `img` in
    place; the points' coordinates are truncated to whole pixels."""
    xy = [(int(x), int(y)) for x, y in points]
    if width <= 1:
        for (x0, y0), (x1, y1) in zip(xy, xy[1:]):
            rendering._line(img, x0, y0, x1, y1, ink)
        if len(xy) > 1:
            rendering._point(img, xy[-1][0], xy[-1][1], ink)
    else:
        for (x0, y0), (x1, y1) in zip(xy, xy[1:]):
            _wide_segment(img, x0, y0, x1, y1, ink, width)


def _draw_ellipse(img, box, fill=None, outline=None, width=1):
    """PIL's `ImageDraw.ellipse(box, fill, outline, width)`: the fill, then
    an outline of a different ink."""
    if fill is not None:
        rendering._ellipse(img, box, fill)
    if outline is not None and outline != fill and width != 0:
        rendering._ellipse(img, box, outline, width=width)


def _board(image, image_size):
    """The picture to draw on: `image` resized to `image_size`, or an empty
    board in `render_board`'s palette."""
    if image is None:
        return rendering._background(tuple(image_size)).copy()
    return rendering.resize_bilinear(np.asarray(image, np.uint8), *image_size)


def draw_planner(planner, image: Optional[np.ndarray] = None, image_size=(360, 640),
                 show_tree: bool = True) -> np.ndarray:
    """An `RRTStarPlanner` (after `.plan()`; a failed plan still draws its
    tree and obstacles) as an RGB array: the inflated obstacles, the tree's
    edges (`show_tree`), the path, the start and the goal, over `image`
    (resized to `image_size`) or an empty board."""
    img = _board(image, image_size)
    px_per_m = _scale(image_size)
    for c, r in zip(planner.obstacles, planner.radii):
        cx, cy = _world_to_px(c, image_size)
        pr = float(r) * px_per_m
        _draw_ellipse(img, (cx - pr, cy - pr, cx + pr, cy + pr), fill=OBSTACLE_COLOR,
                      outline=OBSTACLE_EDGE)
    if show_tree and len(planner.tree_points):
        pts_px = [_world_to_px(p, image_size) for p in planner.tree_points]
        for i, par in enumerate(planner.tree_parent):
            if par < 0:
                continue
            _draw_line(img, [pts_px[int(par)], pts_px[i]], TREE_COLOR, width=1)
    draw_path(img, planner.path, image_size=image_size)
    for p, color in ((planner.start, START_COLOR), (planner.goal, GOAL_COLOR)):
        cx, cy = _world_to_px(p, image_size)
        _draw_ellipse(img, (cx - 4, cy - 4, cx + 4, cy + 4), fill=color)
    return img


def draw_path(img, path: Sequence[Sequence[float]], image_size=(360, 640),
              color=PATH_COLOR) -> None:
    """A subgoal polyline (a planner's `path` runs goal -> start) 2 pixels
    wide with a dot at each subgoal, onto the RGB array `img` in place."""
    if path is None or len(path) < 2:
        return
    px = [_world_to_px(p, image_size) for p in path]
    _draw_line(img, px, color, width=2)
    for p in px:
        _draw_ellipse(img, (p[0] - 2, p[1] - 2, p[0] + 2, p[1] + 2), fill=color)


def draw_oracle_plan(oracle, raw_state, image: Optional[np.ndarray] = None,
                     image_size=(360, 640)) -> np.ndarray:
    """An `RRTPushOracle`'s current block plan for `raw_state` over the
    board. Plans with the oracle's own `get_plan`, then restores its
    planning state and its random stream, so drawing during a rollout
    leaves the oracle's later actions unchanged."""
    saved = (oracle._plan, oracle._current_rrt_target, oracle._need_replan)
    rng_state = oracle._rng.get_state()
    try:
        oracle.get_plan(raw_state)
        path = [list(p) for p in oracle._plan] + [list(oracle._current_rrt_target)]
    finally:
        oracle._plan, oracle._current_rrt_target, oracle._need_replan = saved
        oracle._rng.set_state(rng_state)
    img = _board(image, image_size)
    draw_path(img, path, image_size=image_size)
    return img
