"""The port's Language-Table env against the JAX package's, bitwise.

`rt1_tpu_torch.envs` is a copy of `rt1_tpu.envs` (plain numpy and scipy)
apart from the renderer, which `tests/test_torch_envs_render.py` holds.
Here both envs start from the same seed and take the same seeded random
actions, for every reward family of the registry with both block sets on
the `kinematic` backend, and for `block2block` on `kinematic_arm` (the
xArm IK in the loop). Exactly equal, bit for bit: every reset and step
observation other than `rgb` (which must have the same shape and dtype),
rewards, `done`, `succeeded`, `compute_state()` and the instruction bytes.
The RRT push oracle's plan and its actions over one episode are held the
same way. The module lists, the block sets, the instruction enumeration
and the backend names are held too.
"""

import collections

import numpy as np
import pytest

from rt1_tpu.envs import blocks as jax_blocks
from rt1_tpu.envs import rewards as jax_rewards
from rt1_tpu.envs.backends import make_backend as jax_make_backend
from rt1_tpu.envs.language_table import LanguageTable as JaxLanguageTable
from rt1_tpu.envs.oracles import RRTPushOracle as JaxRRTPushOracle
from rt1_tpu_torch.envs import blocks, rewards
from rt1_tpu_torch.envs.backends import make_backend
from rt1_tpu_torch.envs.language_table import LanguageTable
from rt1_tpu_torch.envs.oracles import RRTPushOracle

STEPS = 10
EPISODES = 2
MODES = ("BLOCK_4", "BLOCK_8")
CASES = [(name, mode, "kinematic") for name in sorted(jax_rewards.REWARD_FAMILIES)
         for mode in MODES] + [("block2block", "BLOCK_4", "kinematic_arm")]


def assert_bitwise(port, ref, what):
    """Same keys, dtypes, shapes and bytes."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), what
        for key in ref:
            assert_bitwise(port[key], ref[key], f"{what}[{key}]")
        return
    if isinstance(ref, (list, tuple, collections.deque)):
        assert type(port) is type(ref) and len(port) == len(ref), what
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_bitwise(p, r, f"{what}[{i}]")
        return
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), what
        assert (port.dtype, port.shape) == (ref.dtype, ref.shape), what
        assert port.tobytes() == ref.tobytes(), what
        return
    assert type(port) is type(ref) and (port == ref or (port != port and ref != ref)), \
        (what, port, ref)


def _observation(port, ref, what):
    assert port["rgb"].shape == ref["rgb"].shape and port["rgb"].dtype == ref["rgb"].dtype
    assert_bitwise({k: v for k, v in port.items() if k != "rgb"},
                   {k: v for k, v in ref.items() if k != "rgb"}, what)


def _envs(name, mode, backend, seed):
    ref = JaxLanguageTable(jax_blocks.BlockMode[mode], seed=seed, backend=backend,
                           reward_factory=jax_rewards.get_reward_factory(name))
    port = LanguageTable(blocks.BlockMode[mode], seed=seed, backend=backend,
                         reward_factory=rewards.get_reward_factory(name))
    return port, ref


@pytest.mark.parametrize("name,mode,backend", CASES)
def test_env_matches_jax_bitwise(name, mode, backend):
    seed = 17 + CASES.index((name, mode, backend))
    port, ref = _envs(name, mode, backend, seed)
    rng = np.random.default_rng(seed)
    for episode in range(EPISODES):
        what = f"{name}/{mode}/{backend} episode {episode}"
        _observation(port.reset(), ref.reset(), f"{what} reset")
        assert_bitwise(port.compute_state(), ref.compute_state(), f"{what} reset state")
        assert port.instruction_str == ref.instruction_str
        assert LanguageTable.decode_instruction(port.compute_state()["instruction"]) == \
            JaxLanguageTable.decode_instruction(ref.compute_state()["instruction"])
        for t in range(STEPS):
            action = rng.uniform(-0.1, 0.1, 2).astype(np.float32)
            p_obs, p_reward, p_done, p_info = port.step(action)
            r_obs, r_reward, r_done, r_info = ref.step(action)
            _observation(p_obs, r_obs, f"{what} step {t}")
            assert_bitwise((p_reward, p_done, p_info), (r_reward, r_done, r_info),
                           f"{what} step {t} reward/done/info")
            assert port.succeeded == ref.succeeded
            assert_bitwise(port.compute_state(), ref.compute_state(), f"{what} step {t} state")
            if p_done:
                break


def test_rrt_oracle_plan_and_actions_match_jax():
    port, ref = _envs("block2block", "BLOCK_4", "kinematic", 11)
    port.reset()
    ref.reset()
    p_oracle = RRTPushOracle(port, use_ee_planner=True, seed=0)
    r_oracle = JaxRRTPushOracle(ref, use_ee_planner=True, seed=0)
    assert p_oracle.get_plan(port.compute_state()) == r_oracle.get_plan(ref.compute_state())
    assert_bitwise(p_oracle._plan, r_oracle._plan, "plan")
    p_oracle.reset()
    r_oracle.reset()
    for t in range(80):
        action = p_oracle.action(port.compute_state())
        assert_bitwise(action, r_oracle.action(ref.compute_state()), f"oracle action {t}")
        assert p_oracle.phase == r_oracle.phase
        p_obs, p_reward, p_done, _ = port.step(action)
        r_obs, r_reward, r_done, _ = ref.step(action)
        _observation(p_obs, r_obs, f"oracle step {t}")
        assert (p_reward, p_done) == (r_reward, r_done)
        if p_done:
            break
    assert port.succeeded == ref.succeeded


def test_registry_block_sets_and_instructions_match_jax():
    assert sorted(rewards.REWARD_FAMILIES) == sorted(jax_rewards.REWARD_FAMILIES)
    for mode in blocks.BlockMode:
        jmode = jax_blocks.BlockMode(mode.value)
        assert blocks.block_set(mode) == jax_blocks.block_set(jmode)
        for training in (True, False):
            assert blocks.block_subsets(mode, training) == \
                jax_blocks.block_subsets(jmode, training)
    for mode in MODES:
        assert rewards.generate_all_instructions(blocks.BlockMode[mode]) == \
            jax_rewards.generate_all_instructions(jax_blocks.BlockMode[mode])
    for name in ("kinematic", "kinematic_arm", "auto"):
        assert type(make_backend(name)).__name__ == type(jax_make_backend(name)).__name__
    with pytest.raises(ValueError):
        make_backend("pybullet")


def test_render_text_overlay_raises():
    """The overlay no longer raises: `render()` with `render_text_in_image`
    (the default) is the frame under the instruction strip, at JAX's canvas
    size (tests/test_torch_eval_extras.py holds its layout to JAX's)."""
    from rt1_tpu_torch.envs.rendering import resize_bilinear

    env = LanguageTable(blocks.BlockMode.BLOCK_4, seed=0,
                        reward_factory=rewards.get_reward_factory("block2block"))
    obs = env.reset()
    overlay = env.render()
    strip = 3 * int(360 * 0.08)
    assert overlay.shape == (360 + strip, 640, 3) and overlay.dtype == np.uint8
    np.testing.assert_array_equal(overlay[strip:], resize_bilinear(obs["rgb"], 360, 640))
    assert (overlay[:strip] != 255).any()  # the instruction's text
    plain = LanguageTable(blocks.BlockMode.BLOCK_4, seed=0, render_text_in_image=False,
                          reward_factory=rewards.get_reward_factory("block2block"))
    obs = plain.reset()
    np.testing.assert_array_equal(plain.render(), obs["rgb"])
