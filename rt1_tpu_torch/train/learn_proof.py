"""The learning proof: oracle-collect -> train -> DAgger -> closed-loop eval
(counterpart of `scripts/learn_proof.py`).

Run as `python -m rt1_tpu_torch.train.learn_proof`. With no external data
or weights:

1. collect — roll the scripted RRT push oracle out on the simulator
   (BLOCK_4, block2block) and write successful demos, over worker
   processes (`data/collect.py`), instructions embedded with `ngram`;
   `--exec_noise_std` adds DART execution noise.
2. train — the flagship RT-1 (FiLM-EfficientNet-B3, TokenLearner, 8
   decoder layers, bf16) at 128x224 through `train/train.py`, optionally
   from a state-regression-pretrained encoder (`--pretrained_encoder`,
   `train/pretrain_vision.py`).
3. dagger (run on its own: `--stage dagger`) — roll the trained policy
   out, relabel every visited state with the oracle, aggregate, extend
   training; a crash-safe loop (`train/dagger_loop.py`).
4. eval — the closed-loop protocol (oracle-validated inits, 80-step
   episodes, eval seed 10000) for the trained policy and the random and
   oracle baselines; writes `<workdir>/learn_proof.json` (the JAX
   summary's keys, plus `loss_curves` and `corpus_entropy`),
   `<workdir>/loss_curve.json` and the trained arm's episode videos
   (`<workdir>/eval/trained/videos/*.gif`; with `--archive_dir`, up to 3
   of them, successes first, copied to `<archive_dir>/learn_proof_videos/`).

The trained policy is restored with fused attention, so every control
step of the DAgger rollouts and the trained arm's eval runs the attention
kernel on the card (`python -m rt1_tpu_torch.eval` does the same). Each
stage prints one JSON line (`{"stage": ...}`) with its wall time and, for
dagger and eval, the kernel's launches by variant and the engine's steps
(eval: also the trained policy's action ms, p50 / p99 / max).

`--config` names the base config (`language_table`, as in JAX) and `--set
key=value` overrides a field after the proof's own settings; at their
defaults they change nothing. The checkpoint's identity (`train_meta.json`)
is stamped from the resulting config, which equals the flags unless
`--set` changed a field. Output goes to `--workdir` only; `--archive_dir`
also copies the records there without clobbering older ones. Runs on
`cuda` unless `--device cpu` is given, and raises without a card.

Run (the flagship on the card):

  python -m rt1_tpu_torch.train.learn_proof --workdir /tmp/learn_proof --episodes 800
  python -m rt1_tpu_torch.train.learn_proof --workdir /tmp/learn_proof --stage dagger
  python -m rt1_tpu_torch.train.learn_proof --workdir /tmp/learn_proof --stage eval

Run (the smoke config on the CPU):

  python -m rt1_tpu_torch.train.learn_proof --config tiny --device cpu --workdir /tmp/lp \\
      --episodes 3 --workers 1 --num_steps 2 --eval_episodes 1 --height 32 --width 56 \\
      --batch 2 --seq_len 3 --dtype float32 --set model.image_tokenizer=tiny
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REWARD = "block2block"
EVAL_SEED = 10_000    # disjoint from the collection workers' seeds (0..workers)
DAGGER_SEED = 30_000  # disjoint from eval (10k) and diagnostics (20k)
ENTROPY_EPISODES = 200

# The model and data identity of a checkpoint: a mismatch restores into the
# wrong model silently (no parameter shape depends on e.g. the window).
EVAL_META_KEYS = ("seq_len", "image_tokenizer", "height", "width", "dtype", "focal_gamma",
                  "aux_mse_weight", "embedder")
# A resumed training run also needs the same batch (optimizer and data
# order) and the same init (pretrained_encoder); eval does not.
TRAIN_META_KEYS = EVAL_META_KEYS + ("batch", "pretrained_encoder")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.train.learn_proof",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default="/tmp/learn_proof", help="Artifacts root.")
    p.add_argument("--episodes", type=int, default=800, help="Successful episodes to collect.")
    p.add_argument("--workers", type=int, default=12, help="Parallel collection processes.")
    p.add_argument("--num_steps", type=int, default=20000, help="Training steps.")
    p.add_argument("--eval_episodes", type=int, default=20, help="Closed-loop episodes per policy.")
    p.add_argument("--stage", choices=("all", "collect", "train", "eval", "dagger"), default="all",
                   help="all (collect, train, eval) | collect | train | eval | dagger")
    p.add_argument("--dagger_rounds", type=int, default=3,
                   help="DAgger iterations: rollout with oracle relabelling -> aggregate -> "
                        "extend training.")
    p.add_argument("--dagger_episodes", type=int, default=40,
                   help="On-policy episodes aggregated per DAgger round.")
    p.add_argument("--dagger_beta", type=float, default=0.0,
                   help="Probability of executing the oracle's action instead of the policy's "
                        "in DAgger rollouts (0 = pure on-policy DAgger).")
    p.add_argument("--dagger_extra_steps", type=int, default=5000,
                   help="Training-step extension after each DAgger round.")
    p.add_argument("--exec_noise_std", type=float, default=0.0,
                   help="DART execution-noise std at collection: executed action = oracle "
                        "action + N(0, std), the recorded label stays clean. 0 = noise-free.")
    p.add_argument("--block_mode", default="BLOCK_4", help="Board variant.")
    p.add_argument("--embedder", default="ngram", help="Instruction embedder.")
    p.add_argument("--image_tokenizer", choices=("efficientnet_b3", "efficientnet_small"),
                   default="efficientnet_b3",
                   help="efficientnet_b3 (flagship) | efficientnet_small (0.35/0.35).")
    p.add_argument("--height", type=int, default=128, help="Train/eval image height.")
    p.add_argument("--width", type=int, default=224, help="Train/eval image width.")
    p.add_argument("--batch", type=int, default=32, help="Per-host batch size.")
    p.add_argument("--checkpoint_every", type=int, default=2500, help="Checkpoint cadence (steps).")
    p.add_argument("--seq_len", type=int, default=6,
                   help="time_sequence_length; 1 = a Markovian policy (current frame only).")
    p.add_argument("--focal_gamma", type=float, default=0.0,
                   help="Focal CE modulation; 0 = reference parity.")
    p.add_argument("--aux_mse_weight", type=float, default=0.0,
                   help="Soft-argmax MSE auxiliary weight; 0 = reference parity.")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="Model compute dtype.")
    p.add_argument("--constant_lr", action="store_true",
                   help="Push the MultiStepLR milestones past the horizon (full LR throughout).")
    p.add_argument("--pretrained_encoder", default="",
                   help="A state-regression-pretrained encoder (train/pretrain_vision.py) "
                        "grafted into the tokenizer at a fresh start; empty = from scratch.")
    p.add_argument("--run_tag", default="r03",
                   help="Label in the archived records' file names (with --archive_dir).")
    p.add_argument("--archive_dir", default=None,
                   help="Also copy learn_proof.json, loss_curve.json and dagger_rounds.json "
                        "here, never overwriting (default: no archive).")
    p.add_argument("--config", default="language_table",
                   help="Base config the proof's settings go on (language_table | tiny).")
    p.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                   help="Override a config field after the proof's settings, repeatable.")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    return p.parse_args(argv)


def _emit(record):
    print(json.dumps(record), flush=True)


class LearnProof:
    """The stages over one workdir (`<workdir>/data`, `<workdir>/train`)."""

    def __init__(self, args):
        self.args = args
        self.data_dir = os.path.join(args.workdir, "data")
        self.train_dir = os.path.join(args.workdir, "train")

    # ------------------------------------------------------------ config

    def train_config(self, num_steps, constant_lr=None):
        from rt1_tpu_torch.configs import apply_override
        from rt1_tpu_torch.train.proof_config import proof_train_config

        a = self.args
        config = proof_train_config(
            self.data_dir, num_steps, image_tokenizer=a.image_tokenizer, seq_len=a.seq_len,
            focal_gamma=a.focal_gamma, aux_mse_weight=a.aux_mse_weight, dtype=a.dtype,
            pretrained_encoder=a.pretrained_encoder, height=a.height, width=a.width,
            batch=a.batch, checkpoint_every=a.checkpoint_every,
            constant_lr=a.constant_lr if constant_lr is None else constant_lr,
            base_config=a.config)
        for assignment in a.overrides:
            apply_override(config, assignment)
        return config

    def meta(self, keys):
        """The checkpoint identity under `keys`, from the run's config."""
        c = self.train_config(self.args.num_steps)
        values = {"seq_len": c.model.time_sequence_length,
                  "image_tokenizer": c.model.image_tokenizer, "height": c.data.height,
                  "width": c.data.width, "dtype": c.model.dtype,
                  "focal_gamma": c.model.focal_gamma, "aux_mse_weight": c.model.aux_mse_weight,
                  "embedder": self.args.embedder, "batch": c.per_host_batch_size,
                  "pretrained_encoder": self.args.pretrained_encoder}
        return {k: values[k] for k in keys}

    def check_meta(self, context, keys):
        from rt1_tpu_torch.train.meta import check_train_meta

        check_train_meta(self.train_dir, context, self.meta(keys))

    def latest_step(self):
        from rt1_tpu_torch.trainer.checkpoints import latest_step

        return latest_step(os.path.join(self.train_dir, "checkpoints"))

    def restore_policy(self):
        """RT1EvalPolicy over the newest checkpoint, fused attention."""
        from rt1_tpu_torch.eval.policy import RT1EvalPolicy
        from rt1_tpu_torch.eval.restore import load_policy_and_step

        model, step = load_policy_and_step(self.train_config(self.args.num_steps),
                                           device=self.args.device, attention_impl="fused",
                                           workdir=self.train_dir)
        return RT1EvalPolicy(model), step

    def archive(self, src, dest_name):
        if self.args.archive_dir:
            from rt1_tpu_torch.utils.artifacts import archive_file

            archive_file(src, self.args.archive_dir, dest_name)

    def tag(self):
        return os.path.basename(os.path.normpath(self.args.workdir))

    # ------------------------------------------------------------ stages

    def collect(self):
        from rt1_tpu_torch.data.collect import collect_dataset_parallel
        from rt1_tpu_torch.data.episodes import read_manifest
        from rt1_tpu_torch.envs import blocks

        a = self.args
        manifest = read_manifest(self.data_dir)
        if manifest is not None:
            # A manifest without exec_noise_std is a clean (pre-DART) corpus.
            recorded = manifest.get("exec_noise_std", 0.0)
            if recorded != a.exec_noise_std:
                raise ValueError(
                    f"collect: corpus at {self.data_dir} was collected with "
                    f"exec_noise_std={recorded}, flags say {a.exec_noise_std}. Point --workdir "
                    "at a fresh directory (or pass the matching noise level).")
            _emit({"stage": "collect", "status": "already_done",
                   "episodes": manifest["episodes"]})
            return
        stats = {}
        t0 = time.perf_counter()
        counts = collect_dataset_parallel(
            self.data_dir, a.episodes, workers=a.workers, block_mode=blocks.BlockMode(a.block_mode),
            reward_name=REWARD, embedder=a.embedder, exec_noise_std=a.exec_noise_std,
            stats=stats)
        _emit({"stage": "collect", "counts": counts, "episodes": a.episodes,
               "attempts": stats["attempts"], "workers": a.workers,
               "seconds": time.perf_counter() - t0})

    def train(self):
        from rt1_tpu_torch.train.meta import stamp_train_meta
        from rt1_tpu_torch.train.train import train_and_evaluate

        a = self.args
        latest = self.latest_step()
        if latest is not None and latest >= a.num_steps:
            _emit({"stage": "train", "status": "already_done", "step": latest})
            return
        config = self.train_config(a.num_steps)
        os.makedirs(self.train_dir, exist_ok=True)
        if latest is not None:
            # Resuming: the recorded identity is the truth, never restamped.
            self.check_meta("train(resume)", TRAIN_META_KEYS)
        else:
            stamp_train_meta(self.train_dir, self.meta(TRAIN_META_KEYS))
        t0 = time.perf_counter()
        train_and_evaluate(config, self.train_dir, device=a.device)
        _emit({"stage": "train", "step": self.latest_step(), "seconds": time.perf_counter() - t0})

    def dagger(self):
        """Rounds of on-policy rollouts relabelled by the oracle, aggregated
        into the corpus, training extended at full LR (every aggregation
        shifts the data, so a late decay would freeze the policy then)."""
        import numpy as np

        from rt1_tpu_torch.data.dagger import (DAGGER_HISTORY_KEYS, append_episodes_to_corpus,
                                               collect_dagger_batch)
        from rt1_tpu_torch.data.episodes import check_embedder_compatibility, read_manifest
        from rt1_tpu_torch.envs import blocks
        from rt1_tpu_torch.envs.oracles import RRTPushOracle
        from rt1_tpu_torch.eval.evaluate import build_eval_env
        from rt1_tpu_torch.parallel.flash_attention import fused_attention
        from rt1_tpu_torch.train.dagger_loop import DaggerLoopConfig, clear_state, run_dagger_loop
        from rt1_tpu_torch.train.train import train_and_evaluate

        a = self.args
        t_start = time.perf_counter()
        self.check_meta("dagger", TRAIN_META_KEYS)
        check_embedder_compatibility(self.data_dir, a.embedder, context="dagger")
        # Roll out under the corpus's own settings, or its manifest lies.
        manifest = read_manifest(self.data_dir) or {}
        for key, mine in (("block_mode", a.block_mode), ("reward", REWARD)):
            recorded = manifest.get(key, mine)
            if recorded != mine:
                raise ValueError(
                    f"dagger: corpus manifest records {key}={recorded!r} but this run would "
                    f"roll out with {mine!r}; aggregated episodes would mix task settings.")
        rollout_max_steps = int(manifest.get("max_steps", 80))
        latest = self.latest_step()
        if latest is None:
            raise RuntimeError("dagger: no checkpoint to roll out; run --stage train first")
        config = self.train_config(a.num_steps)
        kernel = {"launches": {v: 0 for v in fused_attention.launches_by_variant},
                  "engine_steps": 0}

        def collect_round(rnd):
            policy, step = self.restore_policy()
            env = build_eval_env(
                reward_name=REWARD, block_mode=blocks.BlockMode(a.block_mode),
                seed=DAGGER_SEED + 1000 * rnd, embedder=a.embedder,
                target_height=config.data.height, target_width=config.data.width,
                sequence_length=config.model.time_sequence_length,
                history_keys=DAGGER_HISTORY_KEYS)
            oracle = RRTPushOracle(env, use_ee_planner=True)
            before = dict(fused_attention.launches_by_variant)
            steps_before = policy.engine.steps_total
            episodes, successes, _ = collect_dagger_batch(
                env, policy, oracle, a.dagger_episodes,
                rng=np.random.default_rng(DAGGER_SEED + rnd), max_steps=rollout_max_steps,
                beta=a.dagger_beta)
            for v, n in fused_attention.launches_by_variant.items():
                kernel["launches"][v] += n - before[v]
            kernel["engine_steps"] += policy.engine.steps_total - steps_before
            total = append_episodes_to_corpus(self.data_dir, episodes)
            return {"from_checkpoint": step, "rollout_episodes": len(episodes),
                    "rollout_successes": successes, "corpus_train_episodes_after": total}

        def train_to(target):
            train_and_evaluate(self.train_config(target, constant_lr=True), self.train_dir,
                               device=a.device)

        state_path = os.path.join(a.workdir, "dagger_state.json")
        history = run_dagger_loop(
            state_path=state_path, base_step=latest,
            config=DaggerLoopConfig(rounds=a.dagger_rounds, extra_steps=a.dagger_extra_steps),
            collect_round=collect_round, train_to=train_to,
            log=lambda text: _emit({"stage": "dagger", "log": text}))
        summary_path = os.path.join(a.workdir, "dagger_rounds.json")
        with open(summary_path + ".tmp", "w") as f:
            json.dump({"beta": a.dagger_beta, "rounds": history}, f, indent=2)
        os.replace(summary_path + ".tmp", summary_path)
        self.archive(summary_path, f"{self.tag()}_dagger_rounds_{a.run_tag}.json")
        # Only once the history is durable: a crash before this resumes
        # into the completed state instead of re-running every round.
        clear_state(state_path)
        _emit({"stage": "dagger", "rounds": history, "step": self.latest_step(), **kernel,
               "seconds": time.perf_counter() - t_start})
        return history

    def run_protocol(self, policy, tag, write_videos=False):
        from rt1_tpu_torch.envs import blocks
        from rt1_tpu_torch.eval.evaluate import evaluate_policy

        a = self.args
        config = self.train_config(a.num_steps)
        t0 = time.perf_counter()
        results = evaluate_policy(
            policy, workdir=os.path.join(a.workdir, "eval", tag), reward_names=(REWARD,),
            num_evals_per_reward=a.eval_episodes, block_mode=blocks.BlockMode(a.block_mode),
            seed=EVAL_SEED, embedder=a.embedder, write_videos=write_videos,
            env_kwargs=dict(target_height=config.data.height, target_width=config.data.width,
                            sequence_length=config.model.time_sequence_length))
        _emit({"stage": "eval", "arm": tag, "successes": results["successes"][REWARD],
               "episodes": a.eval_episodes,
               "mean_episode_length": results["mean_episode_length"][REWARD],
               "seconds": time.perf_counter() - t0})
        return results

    def evaluate(self):
        import numpy as np

        from rt1_tpu_torch.data.collect import corpus_accounting
        from rt1_tpu_torch.data.episodes import check_embedder_compatibility, read_manifest
        from rt1_tpu_torch.eval.diagnostics import corpus_entropy
        from rt1_tpu_torch.eval.evaluate import OracleEvalPolicy, RandomEvalPolicy
        from rt1_tpu_torch.eval.proof import build_proof_summary, write_proof_json
        from rt1_tpu_torch.parallel.flash_attention import fused_attention
        from rt1_tpu_torch.utils.artifacts import copy_proof_videos
        from rt1_tpu_torch.utils.curves import read_scalar_curves, write_loss_curves

        a = self.args
        t_start = time.perf_counter()
        self.check_meta("eval", EVAL_META_KEYS)
        check_embedder_compatibility(self.data_dir, a.embedder, context="eval")
        manifest = read_manifest(self.data_dir)
        # Stale videos of an earlier eval of this workdir go first: their
        # names carry the outcome, and the archive prefers successes.
        video_dir = os.path.join(a.workdir, "eval", "trained", "videos")
        shutil.rmtree(video_dir, ignore_errors=True)
        policy, _ = self.restore_policy()
        # The trained policy's action latency a control step (the env's
        # step and render are not in it).
        action_ms, act = [], policy.action

        def timed_action(obs):
            t0 = time.perf_counter()
            out = act(obs)
            action_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        policy.action = timed_action
        before = dict(fused_attention.launches_by_variant)
        steps_before = policy.engine.steps_total
        trained = self.run_protocol(policy, "trained", write_videos=True)
        kernel = {"launches": {v: n - before[v]
                               for v, n in fused_attention.launches_by_variant.items()},
                  "engine_steps": policy.engine.steps_total - steps_before,
                  "action_ms": {q: float(np.percentile(action_ms, p))
                                for q, p in (("p50", 50), ("p99", 99), ("max", 100))}}
        # The chance baseline, and the protocol's expert ceiling (the RRT
        # oracle solves well under all oracle-validated inits in 80 steps).
        random_results = self.run_protocol(RandomEvalPolicy(seed=EVAL_SEED), "random")
        oracle_results = self.run_protocol(OracleEvalPolicy(seed=EVAL_SEED), "oracle")
        if a.archive_dir:
            copy_proof_videos(video_dir, a.archive_dir, prefix=f"{self.tag()}_{a.run_tag}")
        curves = read_scalar_curves(self.train_dir)
        curve_path = write_loss_curves(
            curves, os.path.join(a.workdir, "loss_curve.json"),
            title=f"RT-1 on oracle block2block demos ({a.image_tokenizer}, {a.dtype})")
        config = self.train_config(a.num_steps)
        episodes_collected, split_counts = corpus_accounting(self.data_dir, manifest)
        summary = build_proof_summary(
            reward=REWARD, block_mode=a.block_mode, manifest=manifest,
            flag_embedder=a.embedder, flag_exec_noise_std=a.exec_noise_std,
            episodes_collected=episodes_collected, split_counts=split_counts,
            num_steps_requested=a.num_steps, evaluated_checkpoint_step=self.latest_step(),
            seq_len=config.model.time_sequence_length, focal_gamma=config.model.focal_gamma,
            aux_mse_weight=config.model.aux_mse_weight,
            image_tokenizer=config.model.image_tokenizer,
            resolution=[config.data.height, config.data.width], eval_episodes=a.eval_episodes,
            eval_seed=EVAL_SEED, trained=trained, random_results=random_results,
            oracle_results=oracle_results, curves=curves)
        # The port's additions: the learning curve and the bar it is read
        # against (the marginal token entropy of the corpus).
        summary["loss_curves"] = {k: [list(p) for p in v] for k, v in curves.items()}
        summary["corpus_entropy"] = corpus_entropy(
            self.data_dir, ENTROPY_EPISODES, vocab_size=config.model.vocab_size)
        proof_path = write_proof_json(a.workdir, summary)
        self.archive(proof_path, f"{self.tag()}_{a.run_tag}.json")
        self.archive(curve_path, f"{self.tag()}_loss_curve_{a.run_tag}.json")
        _emit({"stage": "eval", "summary": {k: v for k, v in summary.items()
                                            if k not in ("loss_curves", "corpus_entropy")},
               **kernel, "seconds": time.perf_counter() - t_start})
        return summary


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch import resolve_device

    # Every stage but collect needs the device; refuse before any work.
    resolve_device(args.device)
    proof = LearnProof(args)
    if args.stage in ("all", "collect"):
        proof.collect()
    if args.stage in ("all", "train"):
        proof.train()
    if args.stage == "dagger":
        proof.dagger()
    if args.stage in ("all", "eval"):
        proof.evaluate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
