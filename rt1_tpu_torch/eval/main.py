"""Checkpoint evaluation CLI (counterpart of `rt1_tpu/eval/main.py`).

Restores the newest checkpoint of the port's trainer from `--workdir`
(RT-1 or, with `model.family="lava"`, LAVA: `load_policy_from_workdir`),
runs the closed-loop protocol (`evaluate.py`) and prints the result as
one JSON line: `successes`, `episodes_per_reward`, `mean_episode_length`
and `checkpoint_step`. Parity source: reference
`language_table/eval/main_rt1.py:204-221`. Run it as
`python -m rt1_tpu_torch.eval` (`__main__.py` holds the usage).
"""

from __future__ import annotations

import argparse
import json
import sys

DESCRIPTION = """Closed-loop Language-Table eval: `python -m rt1_tpu_torch.eval`.

Run (the flagship's newest checkpoint, on the card):

  python -m rt1_tpu_torch.eval --config language_table --workdir /tmp/rt1_torch

Run (the smoke config on the CPU, one short episode):

  python -m rt1_tpu_torch.eval --config tiny --workdir /tmp/rt1_tiny --device cpu \\
      --episodes 1 --max_steps 3

Run (the scripted RRT expert or uniform random actions under the same
protocol; no checkpoint is read):

  python -m rt1_tpu_torch.eval --config language_table --baseline oracle --episodes 3

The policy runs on `cuda` unless `--device cpu` is given, and the command
raises without a card. The instruction embedder must match the one in
`<workdir>/data_manifest.json`, where the trainer wrote one, unless
`--allow_embedder_mismatch` is given. An empty workdir raises. The last
line is the result JSON. `--videos` writes each episode as an animated GIF
(`<workdir>/videos_ckpt<step>/<reward>_<episode>_<success|failure>.gif`,
`videos_<baseline>` for a baseline), every frame under the instruction
overlay.
"""


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.eval", description=DESCRIPTION,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True,
                   help="language_table | tiny | lava_tiny (or the path of the JAX config file "
                        "of that name); --set model.family=lava evaluates a LAVA checkpoint")
    p.add_argument("--workdir", default="/tmp/rt1_tpu_torch",
                   help="The trainer's workdir: its newest checkpoint is evaluated.")
    p.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                   help="Override a config field (dotted key), repeatable.")
    p.add_argument("--rewards", action="append", default=None,
                   help="Reward family, repeatable (default: block2block).")
    p.add_argument("--episodes", type=int, default=10, help="Episodes per reward.")
    p.add_argument("--max_steps", type=int, default=80, help="Max steps per episode.")
    p.add_argument("--block_mode", default="BLOCK_8", help="Block variant.")
    p.add_argument("--seed", type=int, default=0, help="Env seed.")
    p.add_argument("--embedder", default="hash",
                   help="Instruction embedder: hash | ngram | the path of a table's .npz "
                        "(python -m rt1_tpu_torch.eval.embedding).")
    p.add_argument("--videos", action="store_true",
                   help="Write each episode as an animated GIF with the instruction overlay, "
                        "under <workdir>/videos_<ckpt<step> | the baseline>/.")
    p.add_argument("--backend", choices=("kinematic", "kinematic_arm", "auto"),
                   default="kinematic",
                   help="Physics backend (kinematic_arm: xArm6 IK in the loop).")
    p.add_argument("--baseline", choices=("oracle", "random"), default=None,
                   help="Evaluate a baseline instead of the checkpoint: 'oracle' = the "
                        "scripted RRT expert (the success ceiling), 'random' = uniform "
                        "+-0.03 actions (chance). No checkpoint is read.")
    p.add_argument("--allow_embedder_mismatch", action="store_true",
                   help="Evaluate even if the checkpoint's data manifest records a "
                        "different instruction embedder.")
    p.add_argument("--attention", choices=("fused", "dense", "pallas"), default="fused",
                   help="Attention path; 'pallas' is the JAX name of 'fused'.")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    return p.parse_args(argv)


def eval_policy_for(config, model):
    """(the eval policy of `model`, the history keys its observation needs
    or None for the default): `RT1EvalPolicy`, or `LavaEvalPolicy` per
    `config.model.family` (the "clip" encoder tokenizes the instruction,
    so the history carries it)."""
    from rt1_tpu_torch.eval.policy import LAVA_CLIP_HISTORY_KEYS, LavaEvalPolicy, RT1EvalPolicy

    if config.model.family != "lava":
        return RT1EvalPolicy(model), None
    clip_tokenizer = history_keys = None
    if config.model.lava.lang_encoder == "clip":
        from rt1_tpu_torch.train.train import make_clip_tokenizer

        clip_tokenizer, history_keys = make_clip_tokenizer(config), LAVA_CLIP_HISTORY_KEYS
    policy = LavaEvalPolicy(model, sequence_length=config.model.time_sequence_length,
                            clip_tokenizer=clip_tokenizer)
    return policy, history_keys


def load_policy_from_workdir(config, workdir, device=None, attention_impl=None):
    """(the eval policy over the newest checkpoint in `workdir`, its step,
    its history keys or None): RT-1 (`RT1EvalPolicy`, rolling network
    state) or LAVA (`LavaEvalPolicy`, a history-window forward) per
    `config.model.family`. Raises FileNotFoundError on an empty workdir:
    evaluating random weights silently would be worse than failing."""
    from rt1_tpu_torch.eval.restore import load_policy_and_step

    model, step = load_policy_and_step(config, device=device, attention_impl=attention_impl,
                                       workdir=workdir)
    policy, history_keys = eval_policy_for(config, model)
    return policy, step, history_keys


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch import resolve_device
    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.data.episodes import check_embedder_compatibility
    from rt1_tpu_torch.envs import blocks
    from rt1_tpu_torch.eval.evaluate import OracleEvalPolicy, RandomEvalPolicy, evaluate_policy

    device = resolve_device(args.device)
    config = get_config(args.config)
    for assignment in args.overrides:
        apply_override(config, assignment)
    if not args.allow_embedder_mismatch and not args.baseline:
        # Baselines read no embedding and no checkpoint.
        check_embedder_compatibility(
            args.workdir, args.embedder,
            context="checkpoint data_manifest; pass --allow_embedder_mismatch to override",
            manifest_name="data_manifest.json")
    history_keys = None
    if args.baseline == "oracle":
        policy, step = OracleEvalPolicy(seed=args.seed), -1
    elif args.baseline == "random":
        policy, step = RandomEvalPolicy(seed=args.seed), -1
    else:
        policy, step, history_keys = load_policy_from_workdir(config, args.workdir, device,
                                                              args.attention)
    env_kwargs = dict(
        target_height=config.data.height,
        target_width=config.data.width,
        random_crop_factor=config.data.crop_factor,
        sequence_length=config.model.time_sequence_length,
        backend=args.backend,
    )
    if history_keys is not None:
        env_kwargs["history_keys"] = history_keys
    results = evaluate_policy(
        policy,
        workdir=args.workdir,
        reward_names=tuple(args.rewards or ("block2block",)),
        num_evals_per_reward=args.episodes,
        max_episode_steps=args.max_steps,
        block_mode=blocks.BlockMode(args.block_mode),
        seed=args.seed,
        embedder=args.embedder,
        write_videos=args.videos,
        env_kwargs=env_kwargs,
        # Videos by policy identity: a baseline never overwrites a checkpoint's.
        video_tag=args.baseline if args.baseline else f"ckpt{step}",
    )
    results["checkpoint_step"] = step
    print(json.dumps(results), flush=True)
    return 0
