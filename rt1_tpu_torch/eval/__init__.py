"""Closed-loop evaluation (counterpart of `rt1_tpu/eval/`).

* `embedding` — instruction embedders (hash, ngram).
* `restore` — the policy and serving engine from a config and weights or
  the trainer's newest checkpoint.
* `wrappers` — instruction embedding, central crop + resize, history.
* `policy` — `RT1EvalPolicy`, a one-slot wrapper over the serving engine.
* `evaluate` — the protocol: oracle-validated inits, <= 80 steps per
  episode, success by the sparse reward; the oracle and random baselines.
* `main` — `python -m rt1_tpu_torch.eval`.
* `proof` — the learning proof's summary and its pre-registered criterion.
* `diagnostics` — the marginal action-token entropy of a corpus.
"""
