"""The port's numpy board renderer against the JAX package's PIL renderer.

`rt1_tpu_torch.envs.rendering.render_board` draws the board with no
imaging library. It is held against `rt1_tpu.envs.rendering.render_board`
(PIL's `ImageDraw`) on the same arguments, taken from 240 board states:
seeded resets and random-action rollouts of the JAX env under every reward
family, with both block sets, at the camera's 180x320 and at the `tiny`
config's 32x56 frame. The goal ring is drawn wherever the family has one.

Tolerance: the target is pixel equality. The test requires at least 99 %
of the pixels of every frame to be equal, and every differing pixel to lie
within one pixel (8-adjacent) of a colour edge of PIL's frame. It prints
the measured share of equal pixels.

The rasterizer's primitives are also held alone against PIL's on random
shapes: rectangles, filled ellipses, 1- and 2-pixel translucent ellipse
outlines, exactly; block polygons (filled and outlined), with the same
bound as the frames.
"""

import numpy as np
import pytest
from PIL import Image, ImageDraw

from rt1_tpu.envs import blocks as jax_blocks
from rt1_tpu.envs import rendering as jax_rendering
from rt1_tpu.envs import rewards as jax_rewards
from rt1_tpu.envs.language_table import LanguageTable as JaxLanguageTable
from rt1_tpu_torch.envs import rendering

MIN_EQUAL_SHARE = 0.99
STEPS = 14          # rollout steps per (family, block mode) after the reset


def _board_args(env):
    """The arguments `LanguageTable._render_image` passes to render_board."""
    backend = env._backend
    poses = {b: backend.block_pose(b) for b in env._blocks_on_table}
    goal = env._reward_calculator.get_goal_region()
    return poses, backend.effector_xy(), goal


def _board_states():
    """240 (poses, effector, goal) states: 8 families x 2 block modes x
    (1 reset + 14 steps of seeded random actions)."""
    states = []
    for f, name in enumerate(sorted(jax_rewards.REWARD_FAMILIES)):
        for m, mode in enumerate((jax_blocks.BlockMode.BLOCK_4, jax_blocks.BlockMode.BLOCK_8)):
            seed = 100 * f + m
            env = JaxLanguageTable(mode, reward_factory=jax_rewards.get_reward_factory(name),
                                   seed=seed)
            env.reset()
            states.append(_board_args(env))
            rng = np.random.default_rng(seed)
            for _ in range(STEPS):
                env.step(rng.uniform(-0.05, 0.05, 2).astype(np.float32))
                states.append(_board_args(env))
    return states


def _near_edge(ref):
    """Pixels whose 3x3 neighbourhood in `ref` holds more than one colour."""
    h, w, _ = ref.shape
    pad = np.pad(ref.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="edge")
    edge = np.zeros((h, w), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= (pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] != ref).any(-1)
    return edge


def _check_frame(port, ref, what):
    """Equal share of one frame; raises past the stated bound."""
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.uint8, what
    differ = (port != ref).any(-1)
    share = 1.0 - differ.mean()
    off_edge = differ & ~_near_edge(ref)
    assert share >= MIN_EQUAL_SHARE, f"{what}: only {share:.5f} of pixels equal"
    assert not off_edge.any(), f"{what}: pixels off every edge differ: {np.argwhere(off_edge)[:5]}"
    return int(differ.sum())


@pytest.mark.parametrize("image_size", [(180, 320), (32, 56)])
def test_render_board_matches_pil(image_size):
    states = _board_states()
    assert len(states) >= 200
    rings = sum(goal[0] is not None for _, _, goal in states)
    assert rings > 0
    differing = total = exact = 0
    for i, (poses, effector, goal) in enumerate(states):
        ref = jax_rendering.render_board(poses, effector, image_size=image_size, goal_region=goal)
        port = rendering.render_board(poses, effector, image_size=image_size, goal_region=goal)
        n = _check_frame(port, ref, f"state {i} at {image_size}")
        differing += n
        exact += n == 0
        total += ref.shape[0] * ref.shape[1]
    print(f"render_board {image_size}: {len(states)} frames ({rings} with a goal ring), "
          f"{exact} pixel-exact, equal pixels {1 - differing / total:.7f} "
          f"({differing} of {total} differ)")


def test_render_board_default_size_and_colours():
    poses = {"red_moon": (np.array([0.3, 0.0]), 0.3), "blue_cube": (np.array([0.45, 0.1]), 1.0)}
    effector = np.array([0.4, -0.1])
    ref = jax_rendering.render_board(poses, effector, goal_region=(np.array([0.3, 0.1]), 0.05))
    port = rendering.render_board(poses, effector, goal_region=(np.array([0.3, 0.1]), 0.05))
    assert port.shape == (180, 320, 3)
    _check_frame(port, ref, "default size")
    for name in ("BOARD_COLOR", "BORDER_COLOR", "EFFECTOR_COLOR", "EFFECTOR_RING", "BLOCK_COLORS"):
        assert getattr(rendering, name) == getattr(jax_rendering, name)
    assert rendering._scale((180, 320)) == jax_rendering._scale((180, 320))
    for shape in ("cube", "pentagon", "star", "moon", "pole", "other"):
        np.testing.assert_array_equal(rendering._shape_points(shape, 0.7, 9.0),
                                      jax_rendering._shape_points(shape, 0.7, 9.0))


def _pil_canvas(h, w):
    img = Image.new("RGB", (w, h), rendering.BORDER_COLOR)
    return img, ImageDraw.Draw(img, "RGBA")


def _np_canvas(h, w):
    img = np.empty((h, w, 3), np.uint8)
    img[...] = rendering.BORDER_COLOR
    return img


def test_primitives_match_pil_exactly():
    rng = np.random.default_rng(0)
    h, w = 90, 160
    for i in range(300):
        x0, y0 = rng.uniform(-5, 60, 2)
        box = (x0, y0, x0 + rng.uniform(0, 120), y0 + rng.uniform(0, 60))
        img, draw = _pil_canvas(h, w)
        draw.rectangle(list(box), fill=rendering.BOARD_COLOR)
        port = _np_canvas(h, w)
        rendering._rectangle(port, box, rendering.BOARD_COLOR + (255,))
        np.testing.assert_array_equal(port, np.asarray(img), err_msg=f"rectangle {box}")

        cx, cy, r = rng.uniform(-10, w + 10), rng.uniform(-10, h + 10), rng.uniform(0.5, 30)
        box = (cx - r, cy - r, cx + r, cy + r)
        for kw, ink in (({}, rendering.EFFECTOR_COLOR + (255,)),
                        ({"width": 1}, rendering.EFFECTOR_RING + (255,)),
                        ({"width": 2}, rendering.GOAL_RING)):
            img, draw = _pil_canvas(h, w)
            if kw:
                draw.ellipse(box, outline=ink, width=kw["width"])
            else:
                draw.ellipse(box, fill=ink[:3])
            port = _np_canvas(h, w)
            rendering._ellipse(port, box, ink, **kw)
            np.testing.assert_array_equal(port, np.asarray(img), err_msg=f"ellipse {box} {kw}")


def test_block_polygons_match_pil():
    rng = np.random.default_rng(1)
    h, w = 90, 160
    differing = 0
    for i in range(600):
        shape = ("cube", "pentagon", "star", "moon", "pole", "other")[i % 6]
        pts = rendering._shape_points(shape, rng.uniform(-np.pi, np.pi), rng.uniform(3, 15))
        cx, cy = rng.uniform(-5, w + 5), rng.uniform(-5, h + 5)
        poly = [(cx + float(p[1]), cy + float(p[0])) for p in pts]
        color = rendering.BLOCK_COLORS["purple"]
        outline = tuple(int(c * 0.6) for c in color)
        img, draw = _pil_canvas(h, w)
        draw.polygon(poly, fill=color, outline=outline)
        port = _np_canvas(h, w)
        rendering._polygon(port, poly, color + (255,), outline + (255,))
        differing += _check_frame(port, np.asarray(img), f"{shape} polygon {i}")
    print(f"block polygons: {differing} differing pixels over 600 shapes")
