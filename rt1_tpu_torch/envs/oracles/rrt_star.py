"""Vectorized RRT* planner over a 2-D board with circular obstacles.

Parity source: reference `language_table/environments/oracles/rrt_star.py:
25-357` (same algorithm, same tuning-parameter meanings). This version keeps
the vertex set in growing numpy arrays so nearest-neighbor / neighborhood
queries are vectorized instead of Python loops over node objects — the
planner runs every few control steps in the eval loop, so host-side speed
matters.

Collision checks, by contrast, are deliberately SCALAR: the board carries at
most a handful of circular obstacles, and profiling the demo collector
showed ~80% of episode-collection wall-clock inside numpy-per-call overhead
of the old array-based `_collision_free` (≈130 µs/call across ~180k calls
for six episodes). Plain float arithmetic over a prebuilt obstacle tuple
list runs the same check in a few µs, which multiplies the throughput of
demo collection, DAgger relabeling, and every oracle-driven eval.
"""

import math

import numpy as np


def _obstacle_tuples(centers, radii):
    """Precompute [(cx, cy, r^2), ...] Python floats for the scalar checks."""
    return [
        (float(c[0]), float(c[1]), float(r) * float(r))
        for c, r in zip(np.asarray(centers).reshape(-1, 2), radii)
    ]


def _inside_circles(p, obstacle_tuples):
    """Point inside any (inflated) obstacle; takes the prebuilt tuples."""
    x, y = float(p[0]), float(p[1])
    for cx, cy, r2 in obstacle_tuples:
        px, py = cx - x, cy - y
        if px * px + py * py <= r2:
            return True
    return False


class RRTStarPlanner:
    """RRT* over a rectangle with circular obstacles."""

    def __init__(
        self,
        start,
        goal,
        x_range,
        y_range,
        obstacle_xy,
        obstacle_radii,
        delta,
        step_length,
        goal_sample_rate,
        search_radius,
        iter_max,
        boundary_width=0.01,
        rng=None,
    ):
        self.start = np.asarray(start, dtype=np.float64)
        self.goal = np.asarray(goal, dtype=np.float64)
        self.x_range = x_range
        self.y_range = y_range
        self.obstacles = (
            np.asarray(obstacle_xy, dtype=np.float64).reshape(-1, 2)
        )
        # Inflate obstacle radii by delta once, up front.
        self.radii = (
            np.asarray(obstacle_radii, dtype=np.float64).reshape(-1) + delta
        )
        # Scalar-check working set (see module docstring): built once per
        # plan, consumed millions of times.
        self._obs = _obstacle_tuples(self.obstacles, self.radii)
        self.delta = delta
        self.step_length = step_length
        self.goal_sample_rate = goal_sample_rate
        self.search_radius = search_radius
        self.iter_max = iter_max
        self.boundary_width = boundary_width
        self.rng = rng or np.random
        self.success = False
        self.path = []
        # Filled by plan() on success; consumed by oracles/plot.py.
        self.tree_points = np.zeros((0, 2))
        self.tree_parent = np.zeros((0,), dtype=np.int64)

    def _collision_free(self, p0, p1):
        """Fused scalar form of: p1 outside every (inflated) obstacle AND
        outside the boundary strips AND segment p0->p1 clear of every
        obstacle. Semantics identical to the three vectorized helpers; the
        per-call numpy overhead they carried dominated collection/eval
        profiles (module docstring)."""
        x1, y1 = float(p1[0]), float(p1[1])
        x_min, x_max = self.x_range
        y_min, y_max = self.y_range
        margin = self.boundary_width + self.delta
        if (
            x1 <= x_min + margin
            or x1 >= x_max - self.delta
            or y1 <= y_min + margin
            or y1 >= y_max - self.delta
        ):
            return False
        x0, y0 = float(p0[0]), float(p0[1])
        dx, dy = x1 - x0, y1 - y0
        d2 = dx * dx + dy * dy
        for cx, cy, r2 in self._obs:
            px, py = cx - x1, cy - y1
            if px * px + py * py <= r2:
                return False
            if d2 > 0.0:
                t = ((cx - x0) * dx + (cy - y0) * dy) / d2
                if t < 0.0:
                    t = 0.0
                elif t > 1.0:
                    t = 1.0
                qx, qy = x0 + t * dx - cx, y0 + t * dy - cy
                if qx * qx + qy * qy <= r2:
                    return False
        return True

    def plan(self):
        """Grow the tree; on success `self.path` is goal->start subgoals."""
        if _inside_circles(self.start, self._obs):
            # Start embedded in an obstacle: unplannable configuration.
            self.success = False
            return self

        n_cap = self.iter_max + 2
        pts = np.empty((n_cap, 2))
        parent = np.full(n_cap, -1, dtype=np.int64)
        cost = np.zeros(n_cap)
        pts[0] = self.start
        n = 1

        for _ in range(self.iter_max):
            if self.rng.random() > self.goal_sample_rate:
                sample = np.array(
                    [
                        self.rng.uniform(
                            self.x_range[0] + self.delta,
                            self.x_range[1] - self.delta,
                        ),
                        self.rng.uniform(
                            self.y_range[0] + self.delta,
                            self.y_range[1] - self.delta,
                        ),
                    ]
                )
            else:
                sample = self.goal

            dists = np.linalg.norm(pts[:n] - sample, axis=1)
            near_i = int(np.argmin(dists))
            step = min(self.step_length, dists[near_i])
            if dists[near_i] == 0.0:
                continue
            new = pts[near_i] + (sample - pts[near_i]) / dists[near_i] * step

            if not self._collision_free(pts[near_i], new):
                continue

            # Neighborhood radius shrinks as the tree grows (standard RRT*).
            r = min(
                self.search_radius * math.sqrt(math.log(n + 1) / (n + 1)),
                self.step_length,
            )
            nd = np.linalg.norm(pts[:n] - new, axis=1)
            neighbors = [
                j
                for j in np.flatnonzero(nd <= r)
                if self._collision_free(pts[j], new)
            ]

            pts[n] = new
            if neighbors:
                costs = [cost[j] + nd[j] for j in neighbors]
                best = neighbors[int(np.argmin(costs))]
                parent[n] = best
                cost[n] = cost[best] + nd[best]
                # Rewire: adopt the new node as parent where it shortens paths.
                for j in neighbors:
                    through_new = cost[n] + nd[j]
                    if through_new < cost[j]:
                        parent[j] = n
                        cost[j] = through_new
            else:
                parent[n] = near_i
                cost[n] = cost[near_i] + step
            n += 1

        # Retain the tree for debug visualization (oracles/plot.py) — saved
        # before goal connection so failed plans can be inspected too.
        self.tree_points = pts[:n].copy()
        self.tree_parent = parent[:n].copy()

        # Connect the tree to the goal.
        gd = np.linalg.norm(pts[:n] - self.goal, axis=1)
        candidates = np.flatnonzero(gd <= self.step_length)
        best_i, best_c = None, np.inf
        for j in candidates:
            if not self._collision_free(pts[j], self.goal):
                continue
            c = cost[j] + gd[j]
            if c < best_c:
                best_i, best_c = int(j), c
        if best_i is None:
            if len(candidates):
                self.success = False
                return self
            # Mirror the reference's fallback: no vertex reached the goal
            # radius; treat the most recently added vertex as the endpoint.
            best_i = n - 1

        path = [list(self.goal)]
        node = best_i
        while node != -1:
            path.append([float(pts[node][0]), float(pts[node][1])])
            node = int(parent[node])
        self.path = path
        self.success = True
        return self


def plan_shortest_path(
    xy_start,
    xy_goal,
    x_range,
    y_range,
    obstacle_xy,
    obstacle_widths,
    delta,
    step_length,
    goal_sample_rate,
    search_radius,
    iter_max,
    boundary_width=0.01,
    rng=None,
    raise_error_on_plan_failure=False,
):
    """Plan goal->start subgoal list; falls back to the direct segment.

    Mirrors `rrt_star.get_shortest_path_no_collisions` (reference `:25-85`)
    including the "just try the direct path and replan later" compromise on
    failure.
    """
    planner = RRTStarPlanner(
        xy_start,
        xy_goal,
        x_range,
        y_range,
        obstacle_xy,
        obstacle_widths,
        delta,
        step_length,
        goal_sample_rate,
        search_radius,
        iter_max,
        boundary_width=boundary_width,
        rng=rng,
    )
    planner.plan()
    if not planner.success:
        if raise_error_on_plan_failure:
            raise ValueError("Could not find path! Consider retuning RRT-*.")
        return [list(np.asarray(xy_goal, float)),
                list(np.asarray(xy_start, float))], False
    return planner.path, True
