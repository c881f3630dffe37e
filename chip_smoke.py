#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`rt1_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases kernel,ab    # a quick kernel check

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result line. Every process the script starts
shares one bytecode cache of the run (`_bytecode_cache`: the card's
machine writes none, and each process compiled torch anew), and the
forkserver that workers fork from imports torch once. A whole run takes
the phases in two lanes: once `train` has run, a second process
(`_Lane`) runs moe, parallel, serve_modes, proof and bench while this one runs
train_ops, data, rlds, eval and lava; it is joined before fleet, so the
serving fleets' phases (alerts and canaries judged on latency) and the
kernels' timings run alone. Host timings of the phases that run beside
the other lane are not comparable with those of runs in one lane:

1. device  — requires CUDA; prints `nvidia-smi --query-gpu=name,power.limit`.
2. build   — builds the three attention kernels (`rt1_tpu_torch/csrc/
             fused_attention.cu`, the simple kernel; `fused_attention_tc.cu`,
             the bf16 tensor-core kernel; `fused_attention_tf32x3.cu`, the
             float32 tensor-core kernel in 3xTF32; one nvcc per source for
             sm_90a, in parallel) from the checkout, and prints ptxas's
             registers and spills per kernel.
3. kernel  — holds the kernels against their plain PyTorch version
             (`fused_attention_reference`, TF32 off) on the card: the serve
             shape q/k/v (b, 66, 8, 128) at the buckets 1/2/4/8, f32 and
             bf16, no mask / the RT-1 mask / causal / the RT-1 mask with
             fully masked rows; q/k/v as strided views of one packed
             projection, and in f32 one element off 16-byte alignment; s=1;
             ragged s=37; s=48, 64, 80, 81, 128, 256 and 320 (one or
             several key tiles, either side of each kernel's tile choice),
             with rows whose first key tiles are fully masked; d=256, 64,
             48, 40, 12; the `tiny` config's (2, 15, 2, 8) in f32 and bf16.
             Tolerance 2e-5 in f32, 2e-2 in bf16, and in bf16 also at most
             one bf16 ulp of the reference (at max(|ref|, 2^-4)). Every case
             must run the variant `flash_attention._variant` names for its
             tensors (per-variant launch counts), and the three variants
             must each run; two more cases force the simple kernel on
             float32 (serve shape, s=37). Times each kernel, the plain
             version and `scaled_dot_product_attention` (a yardstick only;
             the port never calls it) with CUDA events and, at the serve
             shape, a tp rank's and `tiny`'s (the simple kernel's own
             path), the profiler's device time.
4. ab      — the simple kernel in bf16 against the tensor-core kernel at the
             serve shape, in turns (simple, tc, tc, simple), CUDA events and
             device time, beside SDPA; and the host's wall time per call
             over 200 calls issued without synchronising (kernel and SDPA).
             Then float32 at the same shape and mask: the simple kernel, the
             tf32x3 kernel and SDPA in float32, in turns (simple, tf32x3,
             SDPA, SDPA, tf32x3, simple), with errors and the byte bound.
5. sweep   — query slices (16 rows, one compute warp each) per block of
             each tensor-core kernel (bf16 and tf32x3) at the serve shape,
             b = 8 and b = 1, each setting held to the reference; prints
             the fastest.
6. parity  — the flagship policy (FiLM-EfficientNet-B3 at 256x456, 8 decoder
             layers) from one seeded set of weights, one `infer_step` at
             batch 2 in f32 on the card (tf32x3 kernel, TF32 off for cuDNN
             and cuBLAS) against the same on the CPU (plain path): step
             logits within 1e-3 x max|logit|, image tokens within 1e-3 of
             their own scale, action tokens equal wherever the top-2 gap
             allows; exactly one tf32x3 launch per layer, no other.
7. tiny    — the smoke config (`tiny`: 2 decoder layers of 2 heads x 8) on
             the card: the same GPU-vs-CPU parity in its own float32 (one
             tf32x3 launch per layer), then one `infer_step` in bf16, where
             d = 8 is not a multiple of 16: one simple launch per layer, no
             other, finite logits and tokens in range.
8. step    — one full-bucket (8 sessions) batched step of the flagship
             engine in process: host wall time, the card's busy time and
             idle share from torch.profiler, and the costliest kernels;
             tensor-core launches = 8 x engine steps, tf32x3 and simple 0.
             Then the `pretrained` check (`models/load_pretrained.py`): a
             seeded state dict with torchvision's efficientnet_b3 key names,
             order and shapes (12,233,232 learnable parameters; the script's
             own copy of the naming rule) ported on the card into
             `EfficientNetB3(include_top=True)`, every ported tensor equal to
             its source bit for bit (by the names' own map, not the
             porter's); the classifier's f32 forward at batch 8 and 300x300
             on the card (TF32 off) within 1e-3 x max|logit| of the CPU's,
             its CUDA-event and device ms; `classifier.*` dropped, the rest
             ported into the flagship master's tower
             (`image_tokenizer.encoder.net`) and one bf16 bucket-8 engine
             step served from it (`eval/restore.py::serving_engine`): 8
             tensor-core launches, no other, the engine's tower equal to
             the source in bf16, actions finite and in bounds.
9. serve   — the main path: `python -m rt1_tpu_torch.serve --config
             language_table --random_init --port 0` (bf16, fused attention),
             3 sessions x 8 `/act` steps of 256x456 `image_b64` frames over
             HTTP, then `/reset`; every reply 200, actions finite and in
             bounds, the tensor-core kernel's launch count (which starts at
             0 in the new server process) equal to 8 x the engine's batched
             steps, warm-up included, and the other kernels' 0; SIGTERM
             drains with exit 0.
10. train_parity — one train step of the flagship (B3 at 256x456, 8
             decoder layers) in float32 at batch 2, dropout, stochastic depth
             and the crop off, on the card (TF32 off) against the same on the
             CPU from the same weights and batch: the loss, the global
             gradient norm, the gradient norm of each decoder layer and each
             MBConv stage, every gradient element, the BatchNorm running
             statistics after the step and the parameters after Adam where
             the gradient decides them, each within the tolerance
             `TRAIN_TOL` states (printed beside the largest error).
11. train  — the flagship training path in bf16 (float32 masters), batch 8,
             dropout, stochastic depth and the crop on, without the
             health pack (the step measured since PR 3; `train_parity`
             and `data` leave it off too), in process: 3
             warm-up and 10 timed steps (wall time median and range,
             frames/s), the card's busy time, idle share and launches per
             step, peak memory, MFU (FLOPs of one step by FlopCounterMode,
             with the grouped-conv backward counted per group (`step_flops`),
             over 989 TFLOP/s), and no fused-attention launch in any train
             step; 30 steps on one fixed batch whose last 5 losses average
             below the first 5; an eval step with fused attention (8
             tensor-core launches, no other); then `python -m rt1_tpu_torch.train
             --config language_table` (its `main`, in process) for 4 steps
             with a checkpoint every 2, a rerun to 6 steps that must report
             restoring step 4, and
             `python -m rt1_tpu_torch.serve --workdir` answering one `/act`.
             Before the CLI, `python -m rt1_tpu_torch.train.profile_train
             --model flagship --steps 3` (its `main`, in process): its
             Chrome trace with one `train#step_num=<i>#` mark a step and
             CUDA kernel events (the CLI exits non-zero without them),
             `host_trace.json` with a `device_step` span a step, no
             fused-attention launch; busy ms and launches a step beside
             this phase's profiled step.
12. train_ops — the trainer's resilience and observability at the
             flagship's width (bf16 on f32 masters, batch 8, synthetic
             batches) with the flagship config's `resilience.*` and `obs.*`:
             the model-health pack's cost (3 warm-up steps, then 5 timed
             steps a turn with the pack off, on, on, off: host ms median
             each way; device launches and busy ms each way over 3 profiled
             steps; the pack's entries finite and named as `pack_names`
             names them for a meta-device policy); a 6-step
             `train_and_evaluate` with `obs.prometheus_port=0` scraped from
             its `log` callback at log step 4 (the text parses with
             `parse_exposition` and carries `rt1_train_goodput_*`, `_health_*`,
             `_timing_*` and `_guard_*` gauges; the port is closed after the
             run); a guard rollback (8 steps, checkpoints every 2,
             `guard_skip_budget=1`, `nan_batch@4x3`: back to step 4 with a
             fresh seed, on to step 8, guard counters equal to the same run
             of `tiny` on the CPU, `rollback_replay` > 0, the ledger's FLOPs
             equal to the pack-free step's, and to phase `train`'s); then
             `python -m rt1_tpu_torch.train --config language_table` for 12
             steps through `nan_batch@2,ckpt_save@1,sigterm@9` (one guard
             skip with an OK verdict, the first save retried once, exit 0
             on the SIGTERM with a checkpoint at step 10,
             `goodput_summary.json` summing to 1 within 1e-6 with `mfu_pct`
             > 0, `flight_record.jsonl` with the reason `preempt`, 8
             tensor-core launches per eval batch and no other) and a rerun
             to 12 (its `main`, in process) that restores step 10 and books
             `ckpt_restore`. Prints
             the pack's cost, the ledger's MFU beside phase `train`'s, the
             CLI's goodput buckets and the phase's wall time.
13. data   — the flagship trained from Language-Table episode files: 128
             train (twice the episodes a windowed loader keeps
             decoded, so most windows read their episode file, as on a real
             corpus) + 4 val seeded episodes x 20 steps at 180x320 written
             under a temporary directory (removed at the end) and packed by
             `python -m rt1_tpu_torch.data.pack_dataset` (its `main`, in
             process); the window sampler
             (`native/window_sampler.cc`, built here by g++) held to its
             plain version at 180x320 -> 256x456 and the packed gather to
             plain slices (exact); frames/s of each loader alone at batch 8,
             window 6 (numpy; torch at 4 workers, pinned; packed at 1, 2
             and 4 threads), each after the
             corpus's pages are dropped from the OS page cache, the numpy
             loader with its episode reads a batch, their ms and their
             share; the bf16 train step
             fed by each loader through `device_feeder` (pinned, two
             batches in flight on a copy stream) in turns with the
             synthetic stream (synthetic, numpy, torch, packed; 3 warm-up
             and 3 timed steps a turn, then 3 more under one
             synchronisation; each turn's seconds):
             step wall median and range, ms
             blocked on the host iterator and in the upload per step, the
             card's idle share, frames/s, and for numpy the episode reads'
             share of the wait; 9 more steps per fed turn whose
             device batch must equal its host batch (>= 20 in all: a torn
             pinned buffer fails); then the train CLI on the
             corpus (its `main`, in process), 4 steps through the packed
             cache and a rerun to 6
             through the default `tf` loader (the torch loader drawing
             through tf.data's bounded shuffle buffer, 2048 of the
             corpus's windows) that restores step 4, each eval on
             `val` with 8 tensor-core launches per eval batch, and
             `data_manifest.json` equal to the corpus's manifest.
13b. rlds  — Language-Table's RLDS layout read without TensorFlow, at the
             flagship's width: the TFDS fixture
             `tests/fixtures/tfds_language_table/` (3 episodes of 6-8 steps at
             360x640 written by TensorFlow, one copy JPEG q95 and one PNG):
             every frame decoded by the port's decoders
             (`csrc/image_decode.cc`, g++; PNG in numpy + zlib) equal to
             TF's decode (the SHA-256 of each frame, the pixels of two a
             copy), ms a frame each way; `python -m
             rt1_tpu_torch.data.convert_rlds` on the JPEG copy (its `main`,
             in process; 2 train + 1 val episodes, s an episode); `python
             -m rt1_tpu_torch.train --config language_table --set
             data.loader=rlds_tf` on that store (shuffle buffer 64, about
             three passes of the fixture; the config's 2048 would hold 100)
             for 2 bf16 steps at batch 8 with an eval (8 tensor-core launches an eval batch) and a
             resume to 4 that restores step 2; `create_rlds_datasets` over
             the TFDS directory alone (frames/s). Then the data service
             (`rt1_tpu_torch/data/service.py`): a dispatcher and 2 worker
             processes from the forkserver; the same train CLI and resume
             with `data.data_service_address` (the stream's gauges logged
             as feeder/*); the bf16 train step through `device_feeder` in
             turns fed by `create_rlds_datasets` in this process, by the
             same through the service and by synthetic batches (a step's
             wall, its wait and upload, the CPU ms a step of the launching
             thread, the process and the workers, the card's idle share;
             the client's receive ms and wire bytes a batch; no worker
             initialised CUDA); one worker killed (SIGKILL) after 2 of 10
             service-fed steps: it drops out, the survivor's batches feed
             the other 8; one bucket-8 bf16 engine step served from the
             service-trained checkpoint on the fixture's frames: 8
             tensor-core launches, no other, actions finite and in bounds.
14. eval   — the closed-loop Language-Table eval of the flagship: phase
             `train`'s CLI checkpoint (step 6; run alone, the train CLI
             writes one at step 2 under a temporary directory),
             `python -m rt1_tpu_torch.eval --config language_table
             --workdir <it> --episodes 1 --max_steps 80 --videos --embedder
             <table>.npz` (its `main`, in this process; the table built by
             `python -m rt1_tpu_torch.eval.embedding --embedder hash`, its
             `main`) restores it (its
             JSON must carry every key and the trainer's step) and writes
             one GIF an episode under `videos_ckpt<step>/` with JAX's names,
             of steps + 1 frames (counted by walking the file's blocks; the
             GIF's write time is printed); then in
             process one bf16 episode of 80 control steps of that
             checkpoint (fused attention, BLOCK_8 block2block, 180x320
             frames drawn by the numpy renderer, cropped and resized to
             256x456 by the native sampler): p50 / p99 / max ms of
             `policy.action`, the wrapped `env.step`, `render_board`, the
             crop-resize and the whole control step, the RRT validation of
             each episode's init, 8 tensor-core launches a step and no
             other, whether the p99 meets the 10 Hz budget, and the card's
             busy time, idle share and launches a step over 5 more steps
             (torch.profiler); then 12 float32 control steps on the card
             (TF32 off, the window rolls after 6; 8 tf32x3 launches a
             step, no other) replayed through a fresh CPU policy of the
             same checkpoint: each step's logits within 1e-3 x max|logit|,
             actions within 1e-6 wherever every action token's top-2 gap
             exceeds that bound; then `--baseline oracle` and `--baseline
             random` (2 episodes each) through the CLI's entry, in process like the
             checkpoint's run and one oracle
             episode on the `kinematic_arm` backend.
15. moe    — the flagship with the Switch-routed expert FFN (`--set
             model.ffn_impl=moe`: 4 experts, capacity factor 2.0, expert
             hidden 512) on its seeded random weights: a bf16 bucket-8
             engine (fused attention) over 3 + 10 timed + 3 profiled steps
             of 8 sessions (host ms, busy ms, idle share, 8 tensor-core
             launches a step and no other); each session's step alone
             against the same step beside 7 others (logits within 2e-2 x
             max|logit|, tokens equal beyond twice that, routes of >= 99 %
             of the token-layer pairs identical) and the drops of the
             whole-bucket routing beside the per-session ones; the int8
             and cached engines in float32 on the card against the same
             mode on the CPU through `serve/parity.py`'s token agreement
             (2 canned episodes of window + 2 steps, >= 0.99), JAX's gates
             (int8 against f32, the cached fill against the windowed
             engine) and the share of routes int8 leaves alone, reported,
             and each mode's resident bytes; the float32 `infer_step` on the
             card against the CPU (`phase_parity`: 1e-3 x max|logit|, one
             tf32x3 launch a layer); 3 bf16 train steps at batch 8 with
             remat off and on (finite loss and `moe_aux_loss`, every
             router's gradient nonzero, step ms, peak card memory, which
             remat must lower), and one float32 step at batch 2 each way
             whose losses agree within 1e-6 relative.
16. lava   — the LAVA family at the reference's widths (`--set
             model.family=lava`: d_model 128, 2 cross-attention and 2
             temporal layers, pyramid (2, 3, 4), dense ResNet 256 x 8,
             256x456, window 6, batch 8, float32): the train CLI's `main`
             in process, 4 steps and a checkpoint (finite losses, an eval);
             the eval CLI's `main` from it, 1 episode of at most 10 control
             steps (their ms); the "clip" encoder with `data.clip_tokens`
             on the byte-level tokenizer from 4 + 1 seeded episodes with
             their instruction text, 2 steps; then each variant
             (conv_maxpool, clip, resnet) once at batch 2 on the card
             against the CPU in float32 (TF32 off) within 1e-4 of the
             output's scale, with the card's forward ms (the resnet
             encoder's forward among them).
16b. parallel — multi-process training (`rt1_tpu_torch/parallel/`) on the
             card's world of one: (a) an NCCL process group of one rank in
             process, 3 flagship bf16 train steps at batch 8 under
             `parallel.dp=1` through the collective path (gradient, loss
             and monitors reduced on one-rank groups) against the plain
             step on the same weights and batches, cuDNN deterministic:
             loss, flat gradient, BatchNorm statistics and masters equal
             bit for bit, each step's ms both ways; (b) `python -m
             torch.distributed.run --nproc_per_node 1` on the train CLI
             (the smoke config, NCCL) through `_run_cli`'s process-group
             guard: 2 steps and a sharded checkpoint; then the CLI's
             `main` in process, in an NCCL world of one, to step 3
             resuming step 2; (c) a 2-rank gloo group on
             the host CPU writes the flagship's seed-0 state under fsdp=2
             (sharded, manifest last); the card restores it into a bf16
             bucket-8 engine (a config asking fsdp=2, which one card cannot
             hold: plain placement) and a float32 `infer_step`, beside the
             same from the unsharded state: logits and actions equal bit
             for bit, 8 tensor-core launches a bf16 engine step, 8 tf32x3
             launches the float32 step; (d) tensor and pipeline
             parallelism at the flagship's widths, float32, batch 2, one
             step from the seed-0 state, randomness off: a tp=2 pair on
             the card (gloo, both ranks on cuda:0: NCCL takes one device a
             rank) and a pp=2 pair (2 microbatches) on the host CPU (gloo
             sends no CUDA tensor point to point), each against its world
             of one on the same weights and batch (the tp one in process
             on the card, the pp one beside its pair on the host): loss,
             the parts' flat gradient assembled into the world of one's
             and the gradient norm within `PARALLEL_PAIR_TOL`; the tp pair
             then runs a bf16 eval step of 8 rows through the fused kernel
             on 4 heads a rank (8 tensor-core launches a rank, as its world
             of one on 8 heads; eval loss within the stated bf16
             tolerance); each pair writes its sharded checkpoint; (e) the
             card serves each pair's checkpoint as (c) serves fsdp's,
             beside the same state restored at world one and saved in the
             one-file format: logits and actions bit for bit, 8
             tensor-core launches a bf16 engine step, 8 tf32x3 the float32
             step; (f) the kernel at a tp rank's heads, (8, 66, 4, 128)
             and (8, 66, 2, 128) in bf16 and float32, under `kernel`'s
             gates; these cases join the `kernels` line's; (g) `python
             examples/torch/parallelism_example.py` as a user runs it (the
             card by default) beside its `--device cpu` run, 8 gloo ranks
             each, one Adam step of the tiny RT-1 under dp, tp, sp, pp and
             ep: five lines in the order of JAX's example, dp, tp and ep on
             cuda:0 and sp and pp on the host (point to point), each
             printed loss and gradient norm (float32, TF32 off) within one
             unit of its last digit of the host run's, the four dense
             modes' losses on the card within one unit of each other, 0
             attention-kernel launches; the card run's wall seconds and
             the card's memory while it ran.
17. serve_modes — the serving modes at the flagship's width, every engine
             derived in process from the parity phase's seeded f32 master
             weights: card vs CPU in float32 (TF32 off): the int8 tree bit
             for bit, and step logits over window + 1 steps of the int8
             windowed step and of the cached step, then `rebuild_cache`
             and one more cached step, within 1e-3 x max|logit| (tf32x3
             launches 8 a windowed step, 0 cached); the JAX engine's gates
             through `serve/parity.py` at 0.99 in float32 (int8 against
             f32, the cached fill against the windowed engine), bf16
             agreement and the cached steady state reported; 3 + 10 timed
             + 5 profiled bucket-8 steps of 8 sessions in four modes (f32
             compute, bf16, int8 at bf16, cached at bf16), in turns and
             back (the second turn beside the first): host ms p50 /
             p99, busy ms, idle share, device launches, fused launches a
             step (8 of the matching variant windowed, 0 cached), resident
             bytes; then `python -m rt1_tpu_torch.serve --inference_dtype
             int8 --cached_inference --session_snapshot_dir <tmp>`: `/act`,
             `POST /reload` onto the same random init (a replay after it
             gives the actions before it bit for bit; caches_rebuilt = the
             live sessions), `/session/export`, `/release`,
             `/session/import` under a new id (its next action = the
             original's), the `/metrics` gauges, SIGTERM exit 0.
18. fleet  — the serving fleet: `python -m rt1_tpu_torch.serve.fleet
             --replicas 2 --config language_table --random_init
             --inference_dtype bf16 --faults replica_kill@1` (the router on
             an ephemeral port, a chaos tick every 12 s): both replicas
             warm up; 4 sessions x 8 `/act` steps of 256x456 frames through
             the router (`"debug": true`) answer 200 with the
             `X-RT1-Request-Id` sent; each
             session's window sits on exactly one replica (`/session/export`
             on each: one holder, step 8) and both replicas hold sessions;
             the router's Prometheus `/metrics` parses with the port's
             `parse_exposition`, `rt1_serve_replica_up` 1 a replica; in each
             replica's fanned-out JSON 8 tensor-core launches an engine step
             (> 0) and no other, and the bf16 flagship's resident bytes;
             after the kill the victim's sessions answer `"restarted": true`
             and the others do not, the respawned replica is ready again
             with the same launch rule; SIGTERM stops the fleet with exit 0
             and one kill, one restart in its final line. The fleet runs
             the metrics plane (`--collector`, 0.25 s) and the alerts
             proof's replica_kill (`rt1_tpu_torch/obs/alerts_proof.py`): 12
             more sessions placed before the kill and re-homed after it,
             a watcher on `/metrics` and `/alerts`, 650 clean acts that
             decay the burn; exactly ReplicaDown, SLOBurnRateFast and
             SLOBurnRateSlow fire and resolve, with their detection
             latencies; and, beside the replicas' warm-up, the proof's
             overhead A/B and byte identity on stub fleets on the host (300
             acts an arm). Prints
             the router's
             `/act` p50 / p99 / max beside phase `serve`'s, the warm-up and
             kill-to-ready seconds, each replica's resident bytes and the
             card's memory in use; the replica's own `phases` total split
             from the client's time gives the router's and the HTTP hops'
             share. CPU rehearsal: `phase_fleet('tiny', 'cpu')`.
19. proof  — (run last) the learning proof at the flagship's width (B3 at 128x224,
             window 6, batch 32, bf16) under a temporary directory, through
             `python -m rt1_tpu_torch.train.learn_proof`: `--stage collect`
             of 4 episodes over 4 workers (8 until the script's time limit
             forced the cut; BLOCK_4 block2block, ngram,
             180x320; the manifest, `corpus_accounting` and the split
             counts checked), then 2 DART demos (std 0.005, 160 steps) by
             `collect_dataset` in process into their own directory; 256
             state-regression frames at 128x224 and 10 `pretrain_encoder`
             steps at B3's coefficients (batch 32), `save_encoder`; the
             CLI's `main` in process (a process start each fewer) for
             `--stage train` 10 steps from that encoder (the graft line
             must show); `--stage dagger`, 1 round of 1 episode + 5 steps
             (the corpus grows by 1, the checkpoint reaches 15, no graft on
             the resume); `--stage eval`, 1 episode of the trained, random
             and oracle arms at seed 10000 (`learn_proof.json` carries the
             JAX summary's keys). The DAgger and eval stages each launch
             the tensor-core kernel 8 times an engine step and no other
             variant (the CLI's counts). Then 10 timed DAgger and 10 eval
             control steps of the final checkpoint in process (p50 / p99 /
             max ms, 8 tensor-core launches a step) and 3 more of each
             under torch.profiler. Prints collection episodes/s and
             successes an attempt (4 workers and 1), the pretrain and
             train step ms, the control-step quantiles and each stage's
             wall time, beside `nvidia-smi`'s line. Then `python -m
             rt1_tpu_torch.eval.diagnostics` (its `main`) on the workdir, 1
             episode of at most 20 steps (80 in JAX), its report's keys,
             and one episode of `closed_loop_diagnostics` on the restored
             policy: 8 tensor-core launches an engine step, one engine step
             a control step; `python -m rt1_tpu_torch.train.perception_probe
             --arms small_64x96` (its `main`), 64 frames, 3 steps on the
             card, its encoder read back. CPU rehearsal:
             `phase_proof('tiny', 'cpu')`.
20. ops    — the fleet's operations loop at the flagship's width (run
             before `proof`): a packed seed corpus (4 x 12 steps at
             256x456, its manifest naming the "hash" embedder); the train
             CLI to step 2 (the incumbent, `data_manifest.json` stamped);
             `python -m rt1_tpu_torch.serve --workdir` with `--embedder
             ngram` must exit non-zero naming the manifest (ROADMAP C3)
             and with `--allow_embedder_mismatch` answer one `/act`;
             `python -m rt1_tpu_torch.serve.fleet` with 2 bf16 replicas,
             `--collector --collector_interval_s 1`, `--capture_dir`,
             `--promote_from` (gate: block2block, 1 episode a cell,
             `--gate_max_steps 10`; canary weight 0.5, 3 clean ticks of 2 s,
             no request floor) and `canary_slo_breach@4`; 4 long sessions
             and a released 6-step session every 2 s through the router;
             a live packed-feed trainer on its own corpus; the train CLI
             resumed once, to steps 4 and 6, in a copy of the workdir while
             the fleet boots, each step renamed into the watched workdir
             in its turn (4 once the fleet is armed, 6 once the controller
             has taken 4): candidate, gate passed, signed verdict,
             canary, promoted by rolling reload with no restarted session
             and no failed request; the captured episodes swept into
             `staging`, a `pack_append@1` torn append that leaves the
             one-shard corpus readable, the retry, the live trainer's
             `rt1_flywheel_corpus_windows` growing, its SIGTERM exit 0;
             step 6 canaried and rolled back (`slo_breach_injected`, the
             incumbent 4 restored), restarting exactly the sessions bound
             to the demoted canary (asked of its replica by
             `/session/export` while the canary runs); `/alerts` shows CanarySLOBreach firing
             then resolved, `/history?family=rt1_serve_requests_total`
             points, `/dashboard` HTML, `/metrics` text with `rt1_deploy_*`,
             `rt1_alert_*`, `rt1_obs_collector_*` through
             `parse_exposition`; the gate's launches (matrix tensor core
             only, parity tf32x3 = 8 x the float32 engine's steps) and each
             replica's (8 tensor-core launches an engine step, no other);
             `/reload` of the incumbent onto each replica timed; SIGTERM
             exit 0 with one promotion, one rollback, no failed request and
             a TSDB snapshot; the alerts proof's canary_breach judges the
             run: exactly CanarySLOBreach fired and resolved, one rollback,
             the request-indexed rolling burn never at 2. Prints the gate's
             seconds (matrix, parity
             engine builds, parity check), canary-to-promote and -rollback
             s, reload s a replica, the collector's cycle ms, `/act` p50 /
             p99 with the collector armed, capture bytes an episode and
             episodes swept, the fleet process's peak card memory and the
             phase's wall time. CPU rehearsal: `phase_ops('tiny', 'cpu')`.
21. loadgen — the serving load generator, `python -m
             rt1_tpu_torch.serve.loadgen`, in its seven modes against bf16
             flagship replicas (run before `chaos`), in four lanes at once:
             (a) a replica started with `--max_batch 8 --max_delay_ms 5
             --max_queue 32 --pipeline_depth 2 --request_timeout_s 30`
             (its `/healthz` `batcher` must show them), `--traced` at 8
             sessions x 16 steps (128 ok, 0 request-id mismatches), then
             `--overhead_ab 2`, then `--occupancy_sweep --sweep_levels 1,8
             --sweep_rounds 1` (compile count pinned at the bucket count);
             (b) `--quant_ab bf16,int8` (the f32 reference added) with
             token agreement >= 0.99 each; (c) `--fleet 2 --faults
             replica_kill@1` over 8 s of 4 traced sessions (one restart,
             both replicas ready at the end), then `--migration_ab` (stub
             fleets: 0 durable window resets, token-identical
             continuations); (d) `--traffic_schedule spike` at 1-3
             replicas (int8 surge) against 3 fixed, phases of 3 s. Every
             mode must report `requests_failed == 0`. Each mode's p50 /
             p99 ms, req/s, seconds, and each replica's launches by
             variant (`--replica_metrics`: one variant, 8 an engine step,
             warm-up included, the others 0).
22. chaos  — `python -m rt1_tpu_torch.resilience.chaos_train --device cuda`
             (its `main`, in process; its three train runs are `tiny`
             subprocesses): every assertion of the JAX drill; then
             `python -m rt1_tpu_torch.obs.run_report` over chaos A's
             workdir (goodput, flight recorder and scalar sections with
             data) and over phase loadgen's records (the serve section);
             a 3-step flagship fit through the train CLI's `main` with
             `--sweep_trial 1 --set model.photometric_augmentation=True`
             (lr 5e-4 at the start line, finite losses); the native
             episode reader (g++ -lz) against `np.load` on 16 seeded
             180x320 episodes (the data phase's writer) and 4 compressed
             copies: equal arrays, and reads a second each way.
23. kernels — one line listing the three kernels with their launches on
             their path (serve for the tensor-core kernel, the flagship f32
             parity step for tf32x3, the `tiny` bf16 step for the simple
             one), on the eval path (`eval_launches`), in the learning
             proof's DAgger and eval stages (`proof_launches`), in each
             serving mode's bucket-8 drive (`serve_modes_launches`), in
             each fleet replica (`fleet_launches`), in the operations
             loop's gate and replicas (`ops_launches`) and, for the
             tensor-core kernel, in the train CLI's evals of phase train_ops
             (`train_ops_launches`), in each replica the load generator
             reached (`loadgen_launches`), in the MoE flagship's bf16
             engine and float32 step (`moe_launches`), in the engines and
             float32 steps restored from the fsdp=2, tp=2 and pp=2
             checkpoints, in the tp pair's eval step, by rank, and in the
             parallelism example's steps, all ranks and modes
             (`parallel_launches`), in the engine step served from the
             ported torchvision-layout tower (`pretrained_launches`, phase
             step), in the engine step served from the checkpoint trained
             through `data.loader=rlds_tf` (`rlds_launches`, phase rlds),
             in each run of phase bench and its infer runs' timed steps
             (`bench_launches`),
             errors (phase parallel's (f) cases
             among them), times and bound.
24. bench  — (run in the second lane, after `proof`) `python -m
             rt1_tpu_torch.bench` (its `main`, in process) in each mode
             on the card: `train` on the flagship (5 steps after 2, one
             window); `infer` on the flagship with `--attention_impl
             pallas` in bf16 (with `--inference_dtype f32,bf16,int8` and
             `--window_sweep 3,6`) and in float32, and on `tiny` in bf16
             (8 steps after 2 each): exactly one kernel launch a decoder
             layer a timed step, of `tensor_core`, `tf32x3` and `simple`
             respectively, and none in the other variants; `e2e` on the
             flagship from 4 synthetic episodes through the torch loader,
             and on `tiny` through the packed feeder with `--guard
             --health` (3 steps after 1, one window); `mfu` on the
             flagship (a value in (0, 100]); `env` (100 control steps);
             `multihost` (5 steps, gloo ranks sharing the card). Each headline
             parses with JAX's metric name for its flags and names the
             card (`device`: name, count, nvidia-smi line); no fused
             launch in a train step; the records it writes are read and
             removed. Prints each run's headline value, seconds and
             launches, the quant A/B's bytes and floors, the KV-cache
             sweep, the e2e, mfu and multihost details. Step counts are
             cut from the CLI's defaults (`BENCH_*`). CPU rehearsal:
             `phase_bench('tiny', 'cpu')`.

The last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()  # the script's own wall clock, imports included

# H100 SXM peaks (NVIDIA data sheet, dense): HBM 3.35 TB/s; bf16 tensor cores
# 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s. The kernel's
# bound takes the peak of its I/O type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# GPU-vs-CPU float32 parity of the flagship: both run the same math in full
# float32 (TF32 off); only the order of sums differs, across 26 MBConv
# blocks, BatchNorm, 8 decoder layers and 3 reductions per layer.
PARITY_REL_TOL = 1e-3

SERVE_SESSIONS = 3
SERVE_STEPS = 8
SERVE_TIMEOUT_S = 600

# Flagship train step, GPU (TF32 off) vs CPU in float32. Relative errors
# against the CPU's value; a group's gradient norm against the larger of
# its own and 1e-3 of the global norm (groups whose true gradient is ~0,
# such as a FiLM bias that feeds a BatchNorm, carry only rounding noise).
# Every gradient element: its GPU-CPU difference against the largest CPU
# gradient element of the model (as the JAX parity tests hold the port).
# BatchNorm statistics are O(1) after the step (0.9 of their init plus the
# batch's). Parameters after Adam: 1e-6 wherever the CPU's gradient is
# settled, |g| >= 100 eps and >= 10 x the gradient tolerance above: the
# GPU's gradient, held within that tolerance, then has the same sign and
# Adam's first update, g / (|g| + eps), differs by at most
# eps |dg| / (|g1| |g2|) <= 1.2e-3, so the parameters by 6e-7 at lr 5e-4.
# Elsewhere Adam turns a gradient's rounding noise into any update in
# [-lr, lr], and the gradient check above is what holds those elements.
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "group_grad_norm": 1e-3, "grad_leaf": 1e-4,
             "batch_stats": 1e-4, "params_settled": 1e-6}
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_FIT_STEPS = 3, 10, 30
TRAIN_CLI_TIMEOUT_S = 600


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 200) -> float:
    """Mean milliseconds of `fn` over `iters` back-to-back calls (CUDA events,
    after a warm-up)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20):
    """What the card itself spent on `iters` calls of `fn`:
    `rt1_tpu_torch/obs/profile.py::device_profile` ({"wall_ms", "busy_ms",
    "kernels", "launches"} per call, or None when the profiler fails or
    records no device activity; then the CUDA-event times stand alone)."""
    from rt1_tpu_torch.obs.profile import device_profile as profile

    return profile(fn, iters)


def attention_bound(b, s, h, d, dtype: str, masked: bool):
    """Least time for the function on an H100: each of q, k, v, out moved
    once (plus the uint8 mask) over HBM, vs the two products' 4*b*h*s*s*d
    operations at the peak of the I/O type. Returns (ms, bound_by)."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elem + (s * s if masked else 0)
    ops = 4 * b * h * s * s * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_cases():
    """(name, b, s, h, d, dtype, mask kind, forced variant or None). The
    serve shape is the flagship window s = 6*(8+3) = 66 with 8 heads of
    128, at the engine's buckets 1, 2, 4 and 8; the `tiny` config's is
    s = 3*(2+3) = 15 with 2 heads of 8; a tp rank's serve shape has 8 / tp
    heads (`tp_kernel_cases`, which phase parallel runs again, its device
    time profiled here). Each case runs the kernel
    `flash_attention._variant` names: bf16 with d % 16 == 0 the tensor-core
    kernel, float32 with d % 8 == 0 the tf32x3 kernel (both with the head
    dim padded in shared memory where it is not 64, 128 or 256), rows off
    16-byte alignment and the other head dims the simple kernel. The last
    two cases force the simple kernel on float32 calls the rule gives to
    tf32x3, so that it stays held on float32. Every case the simple kernel
    runs, the serve shape's RT-1 cases at every bucket, a tp rank's and
    `tiny`'s also get device times (`_kernel_case`)."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for mask in ("none", "rt1", "causal", "rt1_masked_rows"):
            cases.append((f"serve_b8_{dtype}_{mask}", 8, 66, 8, 128, dtype, mask))
    cases += [
        ("serve_b1_bfloat16_rt1", 1, 66, 8, 128, "bfloat16", "rt1"),
        ("serve_b2_bfloat16_rt1", 2, 66, 8, 128, "bfloat16", "rt1"),
        ("serve_b4_bfloat16_rt1", 4, 66, 8, 128, "bfloat16", "rt1"),
        ("packed_qkv_b8_bfloat16_rt1", 8, 66, 8, 128, "bfloat16", "rt1"),
        ("s1_bfloat16_none", 8, 1, 8, 128, "bfloat16", "none"),
        ("ragged_s37_float32_causal", 8, 37, 8, 128, "float32", "causal"),
        ("ragged_s37_bfloat16_causal", 8, 37, 8, 128, "bfloat16", "causal"),
        ("s256_float32_none", 2, 256, 8, 128, "float32", "none"),
        ("s256_bfloat16_causal", 2, 256, 8, 128, "bfloat16", "causal"),
        ("s256_bfloat16_first_tile_masked", 2, 256, 8, 128, "bfloat16", "first_tile_masked"),
        ("s320_bfloat16_causal", 2, 320, 8, 128, "bfloat16", "causal"),
        ("s256_d256_bfloat16_causal", 2, 256, 8, 256, "bfloat16", "causal"),
        ("s256_d256_bfloat16_first_tile_masked", 2, 256, 8, 256, "bfloat16", "first_tile_masked"),
        ("d64_float32_rt1", 8, 66, 8, 64, "float32", "rt1"),
        ("d64_bfloat16_rt1", 8, 66, 8, 64, "bfloat16", "rt1"),
        ("d48_bfloat16_rt1", 8, 66, 8, 48, "bfloat16", "rt1"),
        ("d40_bfloat16_rt1", 8, 66, 8, 40, "bfloat16", "rt1"),
        ("packed_qkv_b8_float32_rt1", 8, 66, 8, 128, "float32", "rt1"),
        ("misaligned_b8_float32_rt1", 8, 66, 8, 128, "float32", "rt1"),
        ("s1_float32_none", 8, 1, 8, 128, "float32", "none"),
        ("s256_float32_first_tile_masked", 2, 256, 8, 128, "float32", "first_tile_masked"),
        ("s48_d256_float32_causal", 2, 48, 8, 256, "float32", "causal"),
        ("s256_d256_float32_first_tile_masked", 2, 256, 8, 256, "float32", "first_tile_masked"),
        ("d40_float32_rt1", 8, 66, 8, 40, "float32", "rt1"),
        ("d12_float32_rt1", 8, 66, 8, 12, "float32", "rt1"),
        # around the tf32x3 kernel's tile choice (one 80-key tile up to
        # s = 80 at d <= 128, 64-key tiles past it) and its full tiles at
        # d = 64 and d = 256
        ("s80_float32_causal", 8, 80, 8, 128, "float32", "causal"),
        ("s81_float32_causal", 8, 81, 8, 128, "float32", "causal"),
        ("s128_d64_float32_causal", 2, 128, 8, 64, "float32", "causal"),
        ("s64_d256_float32_causal", 2, 64, 8, 256, "float32", "causal"),
        ("tiny_float32_rt1", 2, 15, 2, 8, "float32", "rt1_tiny"),
        ("tiny_bfloat16_rt1", 2, 15, 2, 8, "bfloat16", "rt1_tiny"),
        # the simple kernel's edges: its key tile (32 keys a lane-slot, 1-4
        # slots: one pass up to the tile, an online rescale past it),
        # 16-byte and scalar loads, d from 1 to 255
        ("d8_s1_bfloat16_none", 8, 1, 8, 8, "bfloat16", "none"),
        ("d8_s32_bfloat16_causal", 8, 32, 8, 8, "bfloat16", "causal"),
        ("d8_s33_bfloat16_causal", 8, 33, 8, 8, "bfloat16", "causal"),
        ("d8_s66_bfloat16_rt1", 8, 66, 8, 8, "bfloat16", "rt1"),
        ("d8_s256_bfloat16_first_tile_masked", 2, 256, 8, 8, "bfloat16", "first_tile_masked"),
        ("tiny_bfloat16_rt1_masked_rows", 2, 15, 2, 8, "bfloat16", "rt1_tiny_masked_rows"),
        ("d1_bfloat16_rt1", 8, 66, 8, 1, "bfloat16", "rt1"),
        ("d200_bfloat16_rt1", 8, 66, 8, 200, "bfloat16", "rt1"),
        ("misaligned_tiny_bfloat16_rt1", 2, 15, 2, 8, "bfloat16", "rt1_tiny"),
        ("d255_float32_rt1", 8, 66, 8, 255, "float32", "rt1"),
    ]
    return [case + (None,) for case in cases] + tp_kernel_cases() + [
        ("serve_b8_float32_rt1_forced_simple", 8, 66, 8, 128, "float32", "rt1", "simple"),
        ("ragged_s37_float32_causal_forced_simple", 8, 37, 8, 128, "float32", "causal", "simple"),
    ]


def make_mask(kind, s):
    """The (s, s) uint8 mask of a case on the card (None for "none").
    "rt1_tiny" is the `tiny` config's RT-1 mask (window 3, 2 image tokens);
    "rt1_masked_rows" zeroes three whole rows of the RT-1 mask, and
    "rt1_tiny_masked_rows" three of `tiny`'s;
    "first_tile_masked" is causal, and rows from 128 on attend only to keys
    from 128 on, so their first key tile (128 keys at d <= 128 in the
    tensor-core kernels and at d <= 64 in the simple kernel, 64 at d = 256)
    is fully masked and the online softmax must rescale."""
    import numpy as np
    import torch

    from rt1_tpu_torch.models.rt1 import rt1_attention_mask

    if kind == "none":
        return None
    if kind in ("rt1_tiny", "rt1_tiny_masked_rows"):
        m = np.array(rt1_attention_mask(3, 2, 3), np.uint8)
        if kind == "rt1_tiny_masked_rows":
            m[[0, 7, 14]] = 0
    elif kind in ("rt1", "rt1_masked_rows"):
        m = np.array(rt1_attention_mask(6, 8, 3), np.uint8)
        if kind == "rt1_masked_rows":
            m[[0, 30, 65]] = 0
    else:
        m = np.tril(np.ones((s, s), np.uint8))
        if kind == "first_tile_masked":
            m[128:, :128] = 0
    return torch.from_numpy(m).cuda()


def bf16_ulp_err(out, ref):
    """Largest |out - ref| in bf16 ulps of the reference, the ulp taken at
    max(|ref|, 2**-4): both sides round an fp32 value that agrees to about
    2e-5, so an honest kernel is at most one rounding step away."""
    import torch

    mag = ref.float().abs().clamp_min(2.0 ** -4)
    _, exp = torch.frexp(mag)  # mag = m * 2**exp, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8)  # 2**(floor(log2 mag) - 7)
    return float(((out.float() - ref.float()).abs() / ulp).max())


def _qkv(rng, b, s, h, d, tdt, packed=False, misaligned=False):
    import numpy as np
    import torch

    if packed:  # q/k/v as views of one (b, s, 3, h, d) projection
        x = torch.from_numpy(rng.standard_normal((b, s, 3, h, d), dtype=np.float32))
        x = x.to("cuda", tdt)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    if misaligned:  # each one element into its storage: rows off 16-byte alignment
        return tuple(
            torch.from_numpy(rng.standard_normal(b * s * h * d + 1, dtype=np.float32))
            .to("cuda", tdt)[1:].view(b, s, h, d)
            for _ in range(3)
        )
    return tuple(
        torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).to("cuda", tdt)
        for _ in range(3)
    )


def _kernel_case(rng, name, b, s, h, d, dtype, mask_kind, forced, phase="kernel"):
    """One case against the plain version (TF32 off) under the gates of
    `kernel`: the variant `_variant` names (or `forced`) runs, within
    `TOL` (bf16 also within one ulp); its record with the kernel's, the
    plain version's and SDPA's ms and the bound."""
    import torch
    import torch.nn.functional as F

    from rt1_tpu_torch.parallel import flash_attention as fa
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, fused_attention_reference

    tdt = getattr(torch, dtype)
    q, k, v = _qkv(rng, b, s, h, d, tdt, packed=name.startswith("packed_"),
                   misaligned=name.startswith("misaligned_"))
    mask = make_mask(mask_kind, s)
    scale = 1.0 / d ** 0.5
    if forced:
        expected = forced
        run = lambda: fa._launch(q, k, v, mask, scale, variant=forced)  # noqa: E731
    else:
        expected = fa.variant_of(q, k, v, mask)
        run = lambda: fused_attention(q, k, v, mask=mask, scale=scale)  # noqa: E731
    before = dict(fused_attention.launches_by_variant)
    out = run()
    ref = fused_attention_reference(q, k, v, mask=mask, scale=scale)
    torch.cuda.synchronize()
    ran = [x for x in fa.VARIANTS if fused_attention.launches_by_variant[x] != before[x]]
    if ran != [expected]:
        raise AssertionError(f"kernel case {name}: ran {ran}, expected {expected}")
    err = float((out.float() - ref.float()).abs().max())
    ulps = bf16_ulp_err(out, ref) if dtype == "bfloat16" else None
    if not (torch.isfinite(out).all() and err <= TOL[dtype]) or (ulps is not None and ulps > 1.0):
        raise AssertionError(f"kernel case {name}: max abs err {err} (tol {TOL[dtype]}), "
                             f"{ulps} bf16 ulps (tol 1)")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = None if mask is None else mask.bool()
    record = {
        "phase": phase, "case": name, "variant": expected, "forced": bool(forced),
        "shape": [b, s, h, d], "dtype": dtype, "mask": mask_kind, "max_abs_err": err,
        "tol": TOL[dtype], "max_err_ulps": ulps,
        "kernel_ms": cuda_time_ms(run),
        "plain_ms": cuda_time_ms(lambda: fused_attention_reference(q, k, v, mask=mask, scale=scale)),
        # SDPA's kernels fault (cudaErrorMisalignedAddress) on views off
        # 16-byte alignment: no yardstick there.
        "library_ms": None if name.startswith("misaligned_") else cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask, scale=scale)
        ),
    }
    record["bound_ms"], record["bound_by"] = attention_bound(b, s, h, d, dtype, mask is not None)
    if phase == "kernel" and (name.startswith(("serve_b", "tp")) and mask_kind == "rt1"
                              or name.startswith("tiny_") or expected == "simple"):
        # Device-only time per call: the event times above include the
        # host's launch cost whenever the host, not the card, is slower.
        profiled = {"device_ms": run,
                    "plain_device_ms": lambda: fused_attention_reference(q, k, v, mask=mask,
                                                                         scale=scale),
                    "library_device_ms": lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=sdpa_mask, scale=scale)}
        if record["library_ms"] is None:
            del profiled["library_device_ms"]
            record["library_device_ms"] = None
        for key, fn in profiled.items():
            prof = device_profile(fn)
            record[key] = None if prof is None else prof["busy_ms"]
    return record


def phase_kernel():
    """Kernels vs plain on the card. Returns the per-case records."""
    import numpy as np
    import torch

    from rt1_tpu_torch.parallel import flash_attention as fa

    # The plain version's einsums in full fp32 (no TF32), as on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    records = []
    for case in kernel_cases():
        record = _kernel_case(rng, *case)
        emit(record)
        records.append(record)
    ran = {r["variant"] for r in records}
    if ran != set(fa.VARIANTS):
        raise AssertionError(f"kernel cases ran {sorted(ran)}, not every variant of {fa.VARIANTS}")
    return records


def _serve_inputs(b=8, dtype="bfloat16"):
    """q/k/v (b, 66, 8, 128) in `dtype` and the RT-1 mask: the serve shape."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, b, 66, 8, 128, getattr(torch, dtype))
    return q, k, v, make_mask("rt1", 66), 1.0 / 128 ** 0.5


def phase_ab():
    """Same-run A/B at the serve shape: the simple kernel in bf16 against
    the tensor-core kernel, in turns (simple, tc, tc, simple), by CUDA
    events and by profiler device time, beside SDPA as the yardstick; and
    the host's cost per call (200 calls issued without synchronising)."""
    import torch
    import torch.nn.functional as F

    from rt1_tpu_torch.parallel import flash_attention as fa

    q, k, v, mask, scale = _serve_inputs()
    ref = fa.fused_attention_reference(q, k, v, mask=mask, scale=scale)
    runs = {"simple": lambda: fa._launch(q, k, v, mask, scale, variant="simple"),
            "tensor_core": lambda: fa._launch(q, k, v, mask, scale, variant="tensor_core")}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = mask.bool()
    runs["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask,
                                                           scale=scale)
    for variant in ("simple", "tensor_core"):
        err = float((runs[variant]().float() - ref.float()).abs().max())
        if err > TOL["bfloat16"]:
            raise AssertionError(f"A/B: {variant} kernel max abs err {err}")
    turns = []
    for name in ("simple", "tensor_core", "tensor_core", "simple", "sdpa", "sdpa"):
        prof = device_profile(runs[name], iters=50)
        turns.append({"kernel": name, "ms": cuda_time_ms(runs[name]),
                      "device_ms": None if prof is None else prof["busy_ms"]})
    host_us = {}
    for name in ("tensor_core", "sdpa"):
        runs[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            runs[name]()
        host_us[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    record = {"phase": "ab", "shape": [8, 66, 8, 128], "dtype": "bfloat16", "mask": "rt1",
              "turns": turns, "host_us_per_call": host_us, "float32": _ab_float32()}
    emit(record)
    return record


def _ab_float32():
    """float32 at the serve shape with the RT-1 mask: the simple kernel, the
    tf32x3 kernel and SDPA in float32 on the same inputs, in turns (simple,
    tf32x3, SDPA, SDPA, tf32x3, simple), by CUDA events and device time,
    with each one's error against the plain version (TF32 off) and the
    byte bound (q/k/v/out and the mask over 3.35 TB/s)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rt1_tpu_torch.parallel import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(np.random.default_rng(6), 8, 66, 8, 128, torch.float32)
    mask, scale = make_mask("rt1", 66), 1.0 / 128 ** 0.5
    ref = fa.fused_attention_reference(q, k, v, mask=mask, scale=scale)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    runs = {"simple": lambda: fa._launch(q, k, v, mask, scale, variant="simple"),
            "tf32x3": lambda: fa._launch(q, k, v, mask, scale, variant="tf32x3"),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask.bool(),
                                                           scale=scale)}
    errs = {"simple": float((runs["simple"]() - ref).abs().max()),
            "tf32x3": float((runs["tf32x3"]() - ref).abs().max()),
            "sdpa": float((runs["sdpa"]().transpose(1, 2) - ref).abs().max())}
    for name in ("simple", "tf32x3"):
        if not errs[name] <= TOL["float32"]:
            raise AssertionError(f"A/B float32: {name} kernel max abs err {errs[name]}")
    turns = []
    for name in ("simple", "tf32x3", "sdpa", "sdpa", "tf32x3", "simple"):
        prof = device_profile(runs[name], iters=50)
        turns.append({"kernel": name, "ms": cuda_time_ms(runs[name]),
                      "device_ms": None if prof is None else prof["busy_ms"]})
    bound_ms, bound_by = attention_bound(8, 66, 8, 128, "float32", masked=True)
    return {"shape": [8, 66, 8, 128], "mask": "rt1", "turns": turns, "max_abs_err": errs,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_sweep(values=(8, 3, 2, 1)):
    """Query slices (16 rows, one compute warp each) per block of each
    tensor-core kernel (bf16 `tensor_core`, float32 `tf32x3`) at the serve
    shape, b = 8 and b = 1: 8 (clamped to the 5 slices of s = 66) is one
    block per (batch, head) and one K/V read; fewer slices mean more blocks
    that re-read K/V from L2. Each setting is also held to the reference
    (bf16: one ulp; float32: TOL)."""
    import torch

    from rt1_tpu_torch.parallel import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for variant, dtype in (("tensor_core", "bfloat16"), ("tf32x3", "float32")):
        for b in (8, 1):
            q, k, v, mask, scale = _serve_inputs(b, dtype)
            ref = fa.fused_attention_reference(q, k, v, mask=mask, scale=scale)
            for slices in values:
                fn = lambda: fa._launch(q, k, v, mask, scale, variant=variant, slices=slices)  # noqa: E731
                out = fn()
                if dtype == "bfloat16":
                    err, bad = bf16_ulp_err(out, ref), "bf16 ulps"
                    ok = err <= 1.0
                else:
                    err, bad = float((out - ref).abs().max()), "max abs err"
                    ok = err <= TOL["float32"]
                if not ok:
                    raise AssertionError(f"sweep {variant} b={b} slices={slices}: {err} {bad}")
                prof = device_profile(fn, iters=50)
                rows.append({"kernel": variant, "b": b, "slices": slices,
                             "blocks": b * 8 * -(-5 // min(slices, 5)), "ms": cuda_time_ms(fn),
                             "device_ms": None if prof is None else prof["busy_ms"],
                             ("max_err_ulps" if dtype == "bfloat16" else "max_abs_err"): err})
    best = {}
    for variant in ("tensor_core", "tf32x3"):
        timed = [r for r in rows if r["kernel"] == variant and r["b"] == 8
                 and r["device_ms"] is not None]
        best[variant] = min(timed, key=lambda r: r["device_ms"])["slices"] if timed else None
    record = {"phase": "sweep", "rows": rows, "fastest_slices_b8": best,
              "default_slices": {"tensor_core": fa.TC_SLICES_PER_BLOCK,
                                 "tf32x3": fa.TF32X3_SLICES_PER_BLOCK}}
    emit(record)
    return record


def phase_parity(device: str = "cuda", config_name: str = "language_table", batch: int = 2,
                 phase: str = "parity", sets=()):
    """A policy (the flagship by default, with the `sets` overrides) at f32
    on `device` (fused kernel, tf32x3) vs the CPU (plain)."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.eval.restore import load_policy

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config(config_name)
    for assignment in sets:
        apply_override(config, assignment)
    config.model.dtype = "float32"
    rng = np.random.default_rng(1)
    h, w = config.data.height, config.data.width
    frame = rng.uniform(0, 1, (batch, h, w, 3)).astype(np.float32)
    emb = rng.standard_normal((batch, 512)).astype(np.float32)
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    outs = {}
    for dev in (device, "cpu"):
        policy = load_policy(config, device=dev, attention_impl="fused")
        if dev == device:
            reset_launch_counts()  # counts this path's launches only
        t0 = time.perf_counter()
        with torch.no_grad():
            obs = {"image": torch.from_numpy(frame).to(dev),
                   "natural_language_embedding": torch.from_numpy(emb).to(dev)}
            out, state = policy.infer_step(obs, policy.initial_state(batch))
            outs[dev] = (out["action_logits"].cpu().double(), out["action_tokens"].cpu(),
                         state["context_image_tokens"].cpu().double())
        outs[dev + "_s"] = time.perf_counter() - t0
        if dev == device:
            launches = dict(fused_attention.launches_by_variant)
            layers = policy.num_layers
    logits, tokens, image_tokens = outs[device]
    cpu_logits, cpu_tokens, cpu_image_tokens = outs["cpu"]
    if not (torch.isfinite(logits).all() and torch.isfinite(image_tokens).all()):
        raise AssertionError("flagship parity: non-finite output on the card")
    scale = max(1.0, float(cpu_logits.abs().max()))
    bound = PARITY_REL_TOL * scale
    diff = float((logits - cpu_logits).abs().max())
    # At random init the B3 tower's output is tiny (each non-residual block
    # attenuates: SiLU and the SE gate both halve small activations), so the
    # tower is held to the same relative bound against its own scale.
    token_scale = float(cpu_image_tokens.abs().max())
    token_rel_diff = float((image_tokens - cpu_image_tokens).abs().max()) / max(token_scale, 1e-30)
    agree = tokens == cpu_tokens
    # A token may flip only where the CPU's top-2 logits lie within the bound.
    top2 = cpu_logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    unexplained = int((~agree & (gap > 2 * bound)).sum())
    record = {
        "phase": phase, "config": config_name, "sets": list(sets), "batch": batch,
        "dtype": "float32",
        "tf32": False, "attention": "fused (card) vs plain (cpu)",
        "max_abs_logit_diff": diff, "bound": bound, "max_abs_logit": scale,
        "max_abs_image_token": token_scale, "image_token_rel_diff": token_rel_diff,
        "action_token_agreement": float(agree.float().mean()),
        "step_s": {"device": outs[device + "_s"], "cpu": outs["cpu_s"]},
        "launches_by_variant": launches, "decoder_layers": layers,
    }
    emit(record)
    if diff > bound or unexplained or not token_rel_diff <= PARITY_REL_TOL:
        raise AssertionError(f"{config_name} parity: logit diff {diff} (bound {bound}), "
                             f"image-token relative diff {token_rel_diff}, "
                             f"{unexplained} token flips beyond the bound")
    # One f32 infer_step: one tf32x3 launch per decoder layer, no other.
    if launches != {"tensor_core": 0, "tf32x3": layers, "simple": 0}:
        raise AssertionError(f"{config_name} parity: launches {launches}, "
                             f"expected {layers} tf32x3")
    return record


def phase_tiny(device: str = "cuda", batch: int = 2):
    """The smoke config on the card: GPU-vs-CPU parity in its own float32
    (tf32x3), then one `infer_step` in bf16, whose head dim 8 the bf16
    tensor-core kernel does not take: the simple kernel, once per layer."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval.restore import load_policy
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    parity = phase_parity(device, "tiny", batch, phase="tiny_parity")
    config = get_config("tiny")
    config.model.dtype = "bfloat16"
    rng = np.random.default_rng(4)
    h, w = config.data.height, config.data.width
    policy = load_policy(config, device=device, attention_impl="fused")
    frame = rng.uniform(0, 1, (batch, h, w, 3)).astype(np.float32)
    emb = rng.standard_normal((batch, 512)).astype(np.float32)
    obs = {"image": torch.from_numpy(frame).to(device),
           "natural_language_embedding": torch.from_numpy(emb).to(device)}
    reset_launch_counts()  # counts this path's launches only
    with torch.no_grad():
        out, _ = policy.infer_step(obs, policy.initial_state(batch))
    torch.cuda.synchronize()
    launches = dict(fused_attention.launches_by_variant)
    logits, tokens = out["action_logits"].float(), out["action_tokens"]
    record = {"phase": "tiny", "config": "tiny", "batch": batch, "dtype": "bfloat16",
              "launches_by_variant": launches, "decoder_layers": policy.num_layers,
              "logits_shape": list(logits.shape), "action_tokens": tokens.tolist(),
              "float32_parity": {k: parity[k] for k in ("max_abs_logit_diff", "bound",
                                                         "launches_by_variant")}}
    emit(record)
    if not torch.isfinite(logits).all() or \
            ((tokens < 0) | (tokens >= config.model.vocab_size)).any():
        raise AssertionError(f"tiny bf16: non-finite logits or tokens out of range {tokens}")
    if launches != {"tensor_core": 0, "tf32x3": 0, "simple": policy.num_layers}:
        raise AssertionError(f"tiny bf16: launches {launches}, expected "
                             f"{policy.num_layers} simple")
    return record


TORCHVISION_B3_PARAMS = 12_233_232  # torchvision's published efficientnet_b3 total
PRETRAINED_BATCH, PRETRAINED_HW = 8, 300  # B3's ImageNet resolution
TOWER = "image_tokenizer.encoder.net"


def torchvision_b3_manifest():
    """[(torchvision key, shape, kind, the port's key)] of torchvision's
    `efficientnet_b3().state_dict()`, in its order: width 1.2 and depth 1.4
    over the B0 MBConv table (expand, kernel, stride, in, out, repeats),
    `_make_divisible` widths, SE squeeze max(1, block input // 4), head 4 x
    the last stage's width, classifier `Linear(head, 1000)`. `kind` is the
    draw's (weight, bn_weight, bn_bias, bn_mean, bn_var, count, bias)."""
    def divisible(v, divisor=8):
        new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
        return new_v + divisor if new_v < 0.9 * v else new_v

    table = [(1, 3, 1, 32, 16, 1), (6, 3, 2, 16, 24, 2), (6, 5, 2, 24, 40, 2),
             (6, 3, 2, 40, 80, 3), (6, 5, 1, 80, 112, 3), (6, 5, 2, 112, 192, 4),
             (6, 3, 1, 192, 320, 1)]
    keys = []

    def conv_bn(prefix, port, cin, cout, k, groups=1):
        keys.append((f"{prefix}.0.weight", (cout, cin // groups, k, k), "weight",
                     f"{port}.conv.weight"))
        for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            keys.append((f"{prefix}.1.{leaf}", (cout,), kind, f"{port}.bn.{leaf}"))
        keys.append((f"{prefix}.1.num_batches_tracked", (), "count", None))

    cin = divisible(32 * 1.2)
    conv_bn("features.0", "stem", 3, cin, 3)
    block = 0
    for stage, (expand, k, _stride, _in, out, repeats) in enumerate(table, start=1):
        cout = divisible(out * 1.2)
        for i in range(int(math.ceil(repeats * 1.4))):
            p, port = f"features.{stage}.{i}.block", f"block_{block}"
            block_in = cin if i == 0 else cout
            expanded, squeezed, j = block_in * expand, max(1, block_in // 4), 0
            if expand != 1:
                conv_bn(f"{p}.0", f"{port}.expand", block_in, expanded, 1)
                j = 1
            conv_bn(f"{p}.{j}", f"{port}.depthwise", expanded, expanded, k, groups=expanded)
            for fc, shape in (("fc1", (squeezed, expanded, 1, 1)),
                              ("fc2", (expanded, squeezed, 1, 1))):
                keys.append((f"{p}.{j + 1}.{fc}.weight", shape, "weight", f"{port}.se.{fc}.weight"))
                keys.append((f"{p}.{j + 1}.{fc}.bias", shape[:1], "bias", f"{port}.se.{fc}.bias"))
            conv_bn(f"{p}.{j + 2}", f"{port}.project", expanded, cout, 1)
            block += 1
        cin = cout
    head = 4 * divisible(320 * 1.2)
    conv_bn("features.8", "top", cin, head, 1)
    keys.append(("classifier.1.weight", (1000, head), "weight", "classifier.weight"))
    keys.append(("classifier.1.bias", (1000,), "bias", "classifier.bias"))
    return keys


def torchvision_b3_state_dict(device, seed=18):
    """A seeded state dict of the manifest, drawn on `device`: weights
    N(0, 1/fan_in), BatchNorm scales 1 + N(0, 0.1^2), biases and means
    N(0, 0.1^2), variances U(0.5, 1.5), so the classifier's logits are
    O(1)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    sd = {}
    for key, shape, kind, _ in torchvision_b3_manifest():
        if kind == "count":
            sd[key] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind == "bn_var":
            sd[key] = 0.5 + torch.rand(shape, generator=gen, device=device)
        else:
            draw = torch.randn(shape, generator=gen, device=device)
            if kind == "weight":
                sd[key] = draw / math.sqrt(math.prod(shape[1:]))
            else:
                sd[key] = 1.0 + 0.1 * draw if kind == "bn_weight" else 0.1 * draw
    return sd


def _pretrained_check(config, bucket, device, items, batch=PRETRAINED_BATCH,
                      hw=PRETRAINED_HW):
    """Port a torchvision-layout B3 state dict into the classifier and
    into the flagship's tower on `device`, and serve one bf16 engine step
    from the result (see the module docstring, phase `step`)."""
    import numpy as np
    import torch

    from rt1_tpu_torch.eval.restore import compute_dtype, master_policy, serving_engine
    from rt1_tpu_torch.models.efficientnet import EfficientNetB3
    from rt1_tpu_torch.models.load_pretrained import port_torch_efficientnet
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts
    from rt1_tpu_torch.serve.engine import pow2_buckets

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    manifest = torchvision_b3_manifest()
    learnable = sum(math.prod(shape) for _, shape, kind, _ in manifest
                    if kind not in ("bn_mean", "bn_var", "count"))
    sd = torchvision_b3_state_dict(device)
    net = EfficientNetB3(include_top=True).to(device)
    if learnable != TORCHVISION_B3_PARAMS or \
            sum(p.numel() for p in net.parameters()) != TORCHVISION_B3_PARAMS:
        raise AssertionError(f"pretrained: manifest {learnable} learnable parameters, the "
                             f"port's B3 {sum(p.numel() for p in net.parameters())}, "
                             f"expected {TORCHVISION_B3_PARAMS}")
    _sync(dev)
    t0 = time.perf_counter()
    ported = port_torch_efficientnet(sd, net)
    _sync(dev)
    port_s = time.perf_counter() - t0
    pairs = [(key, port) for key, _, _, port in manifest if port is not None]
    unequal = [key for key, port in pairs if not torch.equal(ported[port], sd[key])]
    if unequal or sorted(p for _, p in pairs) != sorted(ported):
        raise AssertionError(f"pretrained: {len(unequal)} ported tensors differ from their "
                             f"source ({unequal[:4]}), or the keys do not cover the B3")
    net.load_state_dict(ported)
    net.eval()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(18)
    x = rng.uniform(0, 1, (batch, hw, hw, 3)).astype(np.float32)
    with torch.no_grad():
        xd = torch.from_numpy(x).to(device)
        logits = net(xd).double().cpu()
        forward_ms = cuda_time_ms(lambda: net(xd), iters=10) if on_card else None
        prof = device_profile(lambda: net(xd), iters=3) if on_card else None
        cpu_net = EfficientNetB3(include_top=True)
        cpu_net.load_state_dict({k: v.cpu() for k, v in ported.items()})
        cpu_logits = cpu_net.eval()(torch.from_numpy(x)).double()
    bound = PARITY_REL_TOL * float(cpu_logits.abs().max())
    diff = float((logits - cpu_logits).abs().max())
    del cpu_net

    body = {k: v for k, v in sd.items() if not k.startswith("classifier.")}
    master, _ = master_policy(config, None, None, "fused")
    t0 = time.perf_counter()
    master.load_state_dict(port_torch_efficientnet(body, master, submodule_path=TOWER))
    tower_port_s = time.perf_counter() - t0
    dtype = compute_dtype(config)
    engine = serving_engine(master, dtype, device, max_sessions=bucket,
                            buckets=pow2_buckets(bucket))
    served = engine.policy.state_dict()
    # The engine holds the tower at its dtype (bf16 for the flagship).
    off = [key for key, port in pairs if not port.startswith("classifier.") and not
           torch.equal(served[f"{TOWER}.{port}"],
                       sd[key].to(served[f"{TOWER}.{port}"].dtype))]
    engine.warmup(items[0][1]["image"].shape)  # every bucket once, outside the count
    steps_before = engine.steps_total
    reset_launch_counts()  # counts this step's launches only
    results = engine.act_batch(items)
    _sync(dev)
    launches = dict(fused_attention.launches_by_variant)
    steps = engine.steps_total - steps_before
    layers = engine.policy.num_layers
    actions = np.asarray([r.get("action", [np.nan] * 2) for r in results], np.float64)
    record = {
        "torchvision_params": learnable, "state_dict_keys": len(sd),
        "ported_tensors_bit_equal": len(pairs) - len(unequal), "port_s": port_s,
        "tower_port_s": tower_port_s,
        "classifier": {"batch": batch, "hw": hw, "dtype": "float32", "tf32": False,
                       "max_abs_logit_diff": diff, "bound": bound,
                       "max_abs_logit": float(cpu_logits.abs().max()),
                       "events_ms": forward_ms,
                       "device_ms": prof["busy_ms"] if prof else None,
                       "device_launches": prof["launches"] if prof else None},
        "engine": {"bucket": bucket, "dtype": str(dtype).replace("torch.", ""),
                   "engine_steps": steps, "launches_by_variant": launches,
                   "tower_off_source": len(off), "actions_shape": list(actions.shape)},
        "nvidia_smi": nvidia_smi() if on_card else None,
    }
    if not diff <= bound or not torch.isfinite(logits).all():
        raise AssertionError(f"pretrained: classifier logits card vs CPU {diff}, bound {bound}")
    expected = {"tensor_core": layers if on_card else 0, "tf32x3": 0, "simple": 0}
    if steps != 1 or launches != expected or off:
        raise AssertionError(f"pretrained: {steps} engine steps, launches {launches} "
                             f"(expected {expected}), {len(off)} tower tensors off the source")
    if actions.shape != (len(items), 2) or not np.isfinite(actions).all() or \
            (np.abs(actions) > 0.03 + 1e-7).any():
        raise AssertionError(f"pretrained: actions {actions}")
    return record


def phase_step(config_name: str = "language_table", bucket: int = 8, iters: int = 5,
               device: str = "cuda"):
    """One full-bucket batched control step of the flagship engine (bf16,
    fused attention), in process: host wall time per step, the card's busy
    time and idle share, launches, and the kernels that take the most
    device time."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval.restore import build_serve_engine
    from rt1_tpu_torch.serve.engine import pow2_buckets

    config = get_config(config_name)
    h, w = config.data.height, config.data.width
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    engine, _ = build_serve_engine(config, device=device, attention_impl="fused",
                                   max_sessions=bucket, buckets=pow2_buckets(bucket))
    reset_launch_counts()
    engine.warmup((h, w, 3))
    rng = np.random.default_rng(3)
    items = [
        (f"step-{i}", {"image": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
                       "natural_language_embedding": rng.standard_normal(512).astype(np.float32)})
        for i in range(bucket)
    ]
    for _ in range(3):
        engine.act_batch(items)
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.act_batch(items)
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = device_profile(lambda: engine.act_batch(items), iters=iters)
    launches = dict(fused_attention.launches_by_variant)
    expected = {"tensor_core": engine.policy.num_layers * engine.steps_total, "tf32x3": 0,
                "simple": 0}
    record = {"phase": "step", "config": config_name, "bucket": bucket, "dtype": engine.dtype,
              "wall_ms": sorted(walls), "launches_by_variant": launches,
              "engine_steps_total": engine.steps_total}
    if launches != expected:
        raise AssertionError(f"step: launches {launches}, expected {expected}")
    if prof is not None:
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:8]
        # The attention kernels' names hold "attention"; nothing else in the step does.
        attn = sum(ms for name, ms in prof["kernels"].items() if "attention" in name)
        record.update({
            "profiled_wall_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
            "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"],
            "device_launches": prof["launches"], "attention_device_ms": attn,
            "top_kernels_ms": [[name[:80], ms] for name, ms in top],
        })
    del engine
    record["pretrained"] = _pretrained_check(config, bucket, device, items)
    emit(record)
    return record


def _http(url, payload=None, timeout=120):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _read_ready_line(proc, timeout_s):
    """The server's `{"status": "serving", ...}` line, read on a thread so a
    silent server cannot hang the script."""
    box = {}

    def reader():
        for line in proc.stdout:
            line = line.strip()
            if line.startswith("{") and '"status": "serving"' in line:
                box["ready"] = json.loads(line)
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout_s)
    if "ready" not in box:
        raise RuntimeError(f"server not ready after {timeout_s}s (exit code {proc.poll()})")
    return box["ready"]


def phase_serve(config_name: str = "language_table", device: str = "cuda"):
    """Drive the port's server over HTTP; the main path."""
    import numpy as np

    from rt1_tpu_torch.configs import get_config

    config = get_config(config_name)
    h, w = config.data.height, config.data.width
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "rt1_tpu_torch.serve", "--config", config_name,
           "--random_init", "--port", "0", "--device", device]
    with tempfile.TemporaryFile(mode="w+") as errlog:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=errlog, text=True)
        try:
            t0 = time.perf_counter()
            ready = _read_ready_line(proc, SERVE_TIMEOUT_S)
            startup_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{ready['port']}"
            rng = np.random.default_rng(2)
            frames = rng.integers(0, 256, (SERVE_SESSIONS, SERVE_STEPS, h, w, 3), dtype=np.uint8)
            replies = []
            lock = threading.Lock()

            def session(i):
                for step in range(SERVE_STEPS):
                    body = {"session_id": f"smoke-{i}",
                            "image_b64": base64.b64encode(frames[i, step].tobytes()).decode(),
                            "instruction": f"push block {i} to the top left corner"}
                    t = time.perf_counter()
                    code, out = _http(url + "/act", body)
                    with lock:
                        replies.append((code, out, time.perf_counter() - t))

            threads = [threading.Thread(target=session, args=(i,)) for i in range(SERVE_SESSIONS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(SERVE_TIMEOUT_S)
            if len(replies) != SERVE_SESSIONS * SERVE_STEPS:
                raise AssertionError(f"serve: {len(replies)} replies of {SERVE_SESSIONS * SERVE_STEPS}")
            for code, out, _ in replies:
                action = np.asarray(out.get("action", []), np.float64)
                tokens = np.asarray(out.get("action_tokens", []))
                if code != 200 or action.shape != (2,) or not np.isfinite(action).all():
                    raise AssertionError(f"serve: bad /act reply {code} {out}")
                if (np.abs(action) > 0.03 + 1e-7).any() or tokens.shape != (3,) or \
                        ((tokens < 0) | (tokens >= config.model.vocab_size)).any():
                    raise AssertionError(f"serve: action out of bounds {out}")
            for i in range(SERVE_SESSIONS):
                code, out = _http(url + "/reset", {"session_id": f"smoke-{i}"})
                if code != 200 or not out.get("ok"):
                    raise AssertionError(f"serve: /reset {code} {out}")
            _, metrics = _http(url + "/metrics")
            launches = int(metrics["attention_launches_total"])
            tc_launches = int(metrics["attention_launches_tensor_core_total"])
            tf32x3_launches = int(metrics["attention_launches_tf32x3_total"])
            simple_launches = int(metrics["attention_launches_simple_total"])
            steps = int(metrics["engine_steps_total"])
            layers = int(metrics["decoder_layers"])
            expected = layers * steps if device == "cuda" else 0
            # bf16 serving runs the tensor-core kernel only.
            if (device == "cuda" and launches <= 0) or tc_launches != expected or \
                    tf32x3_launches != 0 or simple_launches != 0 or launches != tc_launches:
                raise AssertionError(f"serve: {tc_launches} tensor-core, {tf32x3_launches} "
                                     f"tf32x3 and {simple_launches} simple launches, expected "
                                     f"{layers} x {steps}, 0 and 0")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            if rc != 0:
                raise AssertionError(f"serve: exit code {rc} after SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            if proc.returncode not in (0, None):
                errlog.seek(0)
                sys.stderr.write(errlog.read()[-8000:])
    lat_ms = np.sort([r[2] for r in replies]) * 1e3
    record = {
        "phase": "serve", "config": config_name, "dtype": ready["dtype"],
        "attention": ready["attention"], "requests": len(replies), "startup_s": startup_s,
        "client_p50_ms": float(np.percentile(lat_ms, 50)),
        "client_p99_ms": float(np.percentile(lat_ms, 99)),
        "client_latencies_ms": [round(float(x), 3) for x in lat_ms],
        "server_latency_p50_ms": metrics["latency_p50_ms"],
        "server_latency_p99_ms": metrics["latency_p99_ms"],
        "server_step_p50_ms": metrics["step_p50_ms"],
        "mean_batch_occupancy": metrics["mean_batch_occupancy"],
        "engine_steps_total": steps, "attention_launches_total": launches,
        "attention_launches_tensor_core_total": tc_launches,
        "attention_launches_tf32x3_total": tf32x3_launches,
        "attention_launches_simple_total": simple_launches,
        "decoder_layers": layers, "compile_count": metrics["compile_count"],
    }
    emit(record)
    return record


# Serving modes: card vs CPU, the parity gates, per-mode bucket-8
# steps, and the int8 + cached server's /reload and session moves.
SERVE_MODES_BUCKET = 8
SERVE_MODES_CPU_BATCH = 2      # rows of the card-vs-CPU replay
SERVE_MODES_WARMUP, SERVE_MODES_TIMED, SERVE_MODES_PROFILED = 3, 10, 5
SERVE_MODES_FLAGS = ("--inference_dtype", "int8", "--cached_inference")


def _logit_check(what, logits, cpu_logits, tokens, cpu_tokens):
    """The parity phase's rule over a list of steps: logits within
    PARITY_REL_TOL x max|cpu logit|, a token flip only where the CPU's
    top-2 gap lies within twice that bound."""
    import torch

    logits, cpu_logits = torch.stack(logits), torch.stack(cpu_logits)
    tokens, cpu_tokens = torch.stack(tokens), torch.stack(cpu_tokens)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"serve_modes {what}: non-finite logits on the card")
    scale = max(1.0, float(cpu_logits.abs().max()))
    bound = PARITY_REL_TOL * scale
    diff = float((logits - cpu_logits).abs().max())
    top2 = cpu_logits.topk(2, dim=-1).values
    agree = tokens == cpu_tokens
    unexplained = int((~agree & (top2[..., 0] - top2[..., 1] > 2 * bound)).sum())
    record = {"max_abs_logit_diff": diff, "bound": bound, "max_abs_logit": scale,
              "action_token_agreement": float(agree.float().mean()), "steps": len(logits)}
    if diff > bound or unexplained:
        emit({"phase": "serve_modes", "failed": what, **record})
        raise AssertionError(f"serve_modes {what}: logit diff {diff} (bound {bound}), "
                             f"{unexplained} token flips beyond the bound")
    return record


def _replay_steps(policy, dev, frames, emb, cached):
    """Step `policy` over `frames` (window + 1 steps, then, cached, a
    rebuild and one more step): per step (logits, tokens) on the CPU."""
    import torch

    out = []
    state = policy.initial_state(emb.shape[0], cached=cached)
    step = policy.infer_step_cached if cached else policy.infer_step
    with torch.no_grad():
        for i, frame in enumerate(frames):
            if cached and i == len(frames) - 1:
                state = policy.rebuild_cache(state)
            obs = {"image": torch.from_numpy(frame).to(dev),
                   "natural_language_embedding": torch.from_numpy(emb).to(dev)}
            result, state = step(obs, state)
            out.append((result["action_logits"].cpu().double(), result["action_tokens"].cpu()))
    return out


def _serve_modes_server(config_name, config, device, frames, embedding, cache_values):
    """`python -m rt1_tpu_torch.serve --inference_dtype int8 --cached_inference
    --session_snapshot_dir <tmp>`: act, /reload onto the same random init
    (a replay after it must give the same actions bit for bit and every
    live cache must be rebuilt), export / release / import a session (its
    next action must equal the original's), the /metrics gauges;
    `cache_values` is one slot's K/V cache in values."""
    import numpy as np

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    window = config.model.time_sequence_length

    def body(sid, i):
        return {"session_id": sid, "embedding": embedding,
                "image_b64": base64.b64encode(frames[i].tobytes()).decode()}

    with tempfile.TemporaryDirectory() as ring, tempfile.TemporaryFile(mode="w+") as errlog:
        cmd = [sys.executable, "-m", "rt1_tpu_torch.serve", "--config", config_name,
               "--random_init", "--port", "0", "--device", device, *SERVE_MODES_FLAGS,
               "--session_snapshot_dir", ring]
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=errlog,
                                text=True)
        try:
            t0 = time.perf_counter()
            ready = _read_ready_line(proc, SERVE_TIMEOUT_S)
            startup_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{ready['port']}"
            before = [_http(url + "/act", body("r0", i))[1] for i in range(window)]
            for i in range(3):
                _http(url + "/act", body("m", i))
            live = _http(url + "/healthz")[1]["active_sessions"]
            t0 = time.perf_counter()
            code, reload = _http(url + "/reload", {})
            reload_s = time.perf_counter() - t0
            after = [_http(url + "/act", body("r1", i))[1] for i in range(window)]
            code_x, exported = _http(url + "/session/export", {"session_id": "m"})
            original = _http(url + "/act", body("m", 3))[1]
            _http(url + "/release", {"session_id": "m"})
            code_i, imported = _http(url + "/session/import",
                                     {"snapshot": exported["snapshot"], "session_id": "m2"})
            moved = _http(url + "/act", body("m2", 3))[1]
            ready_code = _http(url + "/readyz")[0]
            _, metrics = _http(url + "/metrics")
            ring_files = len([n for n in os.listdir(ring) if n.endswith(".json")])
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            if proc.returncode not in (0, None):
                errlog.seek(0)
                sys.stderr.write(errlog.read()[-8000:])
    cache_bytes = cache_values * (2 if ready["dtype"] == "bfloat16" else 4)
    record = {
        "startup_s": startup_s, "ready": {k: ready[k] for k in (
            "inference_dtype", "cached_inference", "param_bytes_device", "replica_id",
            "compile_count", "dtype")},
        "reload": {k: reload.get(k) for k in ("ok", "caches_rebuilt", "params_swapped",
                                              "param_bytes", "inference_dtype")},
        "reload_s": reload_s, "live_sessions_at_reload": live,
        "replay_identical": [a["action"] for a in after] == [b["action"] for b in before]
        and [a["action_tokens"] for a in after] == [b["action_tokens"] for b in before],
        "moved_equals_original": (moved["action"], moved["action_tokens"])
        == (original["action"], original["action_tokens"]),
        "snapshot_bytes": len(json.dumps(exported.get("snapshot", {}))),
        "ring_files": ring_files, "exit_code": rc,
        "metrics": {k: metrics[k] for k in (
            "inference_dtype", "param_bytes_device", "param_bytes_master", "cache_enabled",
            "cache_bytes_per_slot", "cache_invalidations", "cache_rebuild_steps_total",
            "reloads_total", "migration_exports_total", "migration_imports_total",
            "attention_launches_total", "engine_steps_total", "compile_count")},
    }
    problems = []
    if code != 200 or not reload.get("ok") or reload.get("caches_rebuilt") != live or live != 2:
        problems.append(f"/reload {code} {reload} with {live} live sessions")
    if not record["replay_identical"]:
        problems.append(f"actions after /reload differ: {before} vs {after}")
    if code_x != 200 or code_i != 200 or imported.get("session_id") != "m2" or \
            moved.get("session_started") or not record["moved_equals_original"]:
        problems.append(f"session move: export {code_x}, import {code_i} {imported}, "
                        f"moved {moved} vs original {original}")
    m = metrics
    if (m["inference_dtype"], m["cache_enabled"], m["reloads_total"],
            m["migration_exports_total"], m["migration_imports_total"]) != ("int8", 1, 1, 1, 1) \
            or m["cache_bytes_per_slot"] != cache_bytes \
            or not m["param_bytes_device"] < m["param_bytes_master"] \
            or m["attention_launches_total"] != 0 or ready_code != 200 or rc != 0 \
            or ring_files < 1:
        problems.append(f"gauges {record['metrics']}, /readyz {ready_code}, exit {rc}, "
                        f"ring files {ring_files}, expected cache bytes {cache_bytes}")
    if problems:
        emit({"phase": "serve_modes", "server": record})
        raise AssertionError("serve_modes server: " + "; ".join(problems))
    return record


def phase_serve_modes(config_name: str = "language_table", device: str = "cuda"):
    """The serving modes at the flagship's width, on the parity
    phase's seeded random weights (one f32 master policy; every engine is
    derived from it in process):

    1. card vs CPU, float32 compute (TF32 off): the int8 tree bit for bit;
       step logits over window + 1 steps of the int8 windowed step and of
       the cached step (then `rebuild_cache` and one more cached step)
       within the parity phase's tolerance;
    2. the JAX engine's gates through `serve/parity.py` at 0.99, f32
       compute: int8 against f32, the cached fill against the windowed
       engine; reported, not gated: bf16 against f32 and the cached
       steady state;
    3. bucket-8 steps of 8 sessions in four modes (f32 compute, bf16,
       int8 at bf16, cached at bf16), in turns and back: host ms p50 /
       p99, the card's busy ms and idle share, device launches, fused
       launches per variant (8 of the matching variant a windowed step, 0
       a cached one) and resident bytes;
    4. the int8 + cached server over HTTP (`_serve_modes_server`)."""
    import copy

    import numpy as np
    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval.restore import master_policy, serving_engine
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts
    from rt1_tpu_torch.serve import parity

    on_card = device == "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    config = get_config(config_name)
    h, w = config.data.height, config.data.width
    shape, window = (h, w, 3), config.model.time_sequence_length
    master, _ = master_policy(config, None, None, attention_impl="fused")
    layers = master.num_layers
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def engine(dev, mode="f32", compute="float32", cached=False, sessions=SERVE_MODES_BUCKET):
        return serving_engine(copy.deepcopy(master), dtypes[compute], dev, inference_dtype=mode,
                              cached_inference=cached, max_sessions=sessions,
                              buckets=[1, sessions])

    # 1. card vs CPU.
    card = {"f32": engine(device), "int8": engine(device, "int8")}
    cpu = {"f32": engine("cpu", sessions=2), "int8": engine("cpu", "int8", sessions=2)}
    card_tree = card["int8"].policy.state_dict()
    cpu_tree = cpu["int8"].policy.state_dict()
    int8_leaves = sum(v.dtype == torch.int8 for v in cpu_tree.values())
    tree_diff = sorted(k for k, v in cpu_tree.items() if not torch.equal(card_tree[k].cpu(), v))
    if tree_diff or sorted(card_tree) != sorted(cpu_tree):
        raise AssertionError(f"serve_modes: int8 tree on the card differs from the CPU's in "
                             f"{tree_diff[:8]} ({len(tree_diff)} leaves)")
    rng = np.random.default_rng(5)
    b = SERVE_MODES_CPU_BATCH
    frames = [rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32) for _ in range(window + 2)]
    emb = rng.standard_normal((b, 512)).astype(np.float32)
    replay = {}
    for name, mode, cached in (("int8_f32", "int8", False), ("cached_f32", "f32", True)):
        n = window + (2 if cached else 1)
        reset_launch_counts()
        on = _replay_steps(card[mode].policy, device, frames[:n], emb, cached)
        launches = dict(fused_attention.launches_by_variant)
        t0 = time.perf_counter()
        ref = _replay_steps(cpu[mode].policy, "cpu", frames[:n], emb, cached)
        record = _logit_check(name, [o[0] for o in on], [r[0] for r in ref],
                              [o[1] for o in on], [r[1] for r in ref])
        record.update(launches_by_variant=launches, cpu_s=time.perf_counter() - t0)
        expected = {"tensor_core": 0, "tf32x3": 0 if cached or not on_card else layers * n,
                    "simple": 0}
        if launches != expected:
            raise AssertionError(f"serve_modes {name}: launches {launches}, expected {expected}")
        if cached:
            # The step after the rebuild alone, as the cached gate reads it.
            record["after_rebuild"] = _logit_check(name + "_rebuilt", [on[-1][0]], [ref[-1][0]],
                                                   [on[-1][1]], [ref[-1][1]])
        replay[name] = record
    del cpu

    # 2. the gates, f32 compute, through the port's parity.py.
    card["cached"] = engine(device, cached=True)
    card["bf16"] = engine(device, "bf16", "bfloat16")
    gates = {}
    try:
        gates["int8_vs_f32"] = parity.check_parity(card["f32"], card["int8"], shape)
        gates["cached_vs_windowed"] = parity.check_cached_parity(card["f32"], card["cached"], shape)
    except ValueError as exc:
        emit({"phase": "serve_modes", "gates": gates, "failed": str(exc)})
        raise
    bf16_stat = parity.action_token_agreement(card["f32"], card["bf16"],
                                              parity.canned_episodes(shape))

    # 3. bucket-8 steps per mode.
    timed = {"f32": card.pop("f32"), "bf16": card.pop("bf16")}
    del card
    timed["int8_bf16"] = engine(device, "int8", "bfloat16")
    timed["cached_bf16"] = engine(device, "f32", "bfloat16", cached=True)
    items = [(f"t-{i}", {"image": rng.uniform(0, 1, shape).astype(np.float32),
                         "natural_language_embedding": rng.standard_normal(512).astype(np.float32)})
             for i in range(SERVE_MODES_BUCKET)]
    modes = {}
    # In turns (f32, bf16, int8, cached, cached, int8, bf16, f32): each
    # mode's second turn is kept beside its first.
    for name in list(timed) + list(reversed(list(timed))):
        eng = timed[name]
        reset_launch_counts()  # this mode's drive only
        steps0 = eng.steps_total
        for _ in range(SERVE_MODES_WARMUP):
            eng.act_batch(items)
        walls = []
        for _ in range(SERVE_MODES_TIMED):
            t0 = time.perf_counter()
            eng.act_batch(items)
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = device_profile(lambda: eng.act_batch(items), iters=SERVE_MODES_PROFILED) \
            if on_card else None
        steps = eng.steps_total - steps0
        launches = dict(fused_attention.launches_by_variant)
        quantiles = _quantiles(walls)
        record = {
            "inference_dtype": eng.inference_dtype, "compute": eng.dtype,
            "cached": eng.cached_inference, "host_ms_p50": quantiles["p50"],
            "host_ms_p99": quantiles["p99"], "host_ms": sorted(walls),
            "engine_steps": steps, "launches_by_variant": launches,
            "fused_launches_per_step": {k: v / steps for k, v in launches.items()},
            "serving_param_bytes": eng.serving_param_bytes,
            "cache_bytes_per_slot": eng.cache_bytes_per_slot,
            "compile_count": eng.compile_count,
        }
        if prof is not None:
            record.update(device_busy_ms=prof["busy_ms"], profiled_wall_ms=prof["wall_ms"],
                          idle_share=1.0 - prof["busy_ms"] / prof["wall_ms"],
                          device_launches=prof["launches"])
        variant = "tf32x3" if eng.dtype == "float32" else "tensor_core"
        expected = {"tensor_core": 0, "tf32x3": 0, "simple": 0}
        if on_card and not eng.cached_inference:
            expected[variant] = layers * steps
        if launches != expected:
            raise AssertionError(f"serve_modes {name}: launches {launches}, expected {expected}")
        if name in modes:
            modes[name]["second_turn"] = {k: record[k] for k in (
                "host_ms_p50", "host_ms_p99", "device_busy_ms", "idle_share", "device_launches")
                if k in record}
        else:
            modes[name] = record
    del timed

    # 4. the server.
    frames_u8 = rng.integers(0, 256, (max(window, 4), h, w, 3), dtype=np.uint8)
    server = _serve_modes_server(config_name, config, device, frames_u8,
                                 [float(x) for x in emb[0]],
                                 modes["cached_bf16"]["cache_bytes_per_slot"] // 2)
    record = {
        "phase": "serve_modes", "config": config_name, "bucket": SERVE_MODES_BUCKET,
        "card_vs_cpu": {"int8_tree_leaves": len(cpu_tree), "int8_leaves": int8_leaves,
                        "int8_tree_bitwise": True, **replay},
        "gates": {"threshold": parity.PARITY_THRESHOLD, **{
            k: {f: v[f] for f in ("agreement", "tokens_total", "max_abs_action_diff", "passed")
                if f in v} for k, v in gates.items()}},
        "stats": {"bf16_vs_f32_agreement": bf16_stat["agreement"],
                  "bf16_tokens_total": bf16_stat["tokens_total"],
                  "cached_steady_agreement": gates["cached_vs_windowed"]["steady_agreement"],
                  "cached_steady_steps": gates["cached_vs_windowed"]["steady_steps"]},
        "modes": modes, "server": server, "seconds": time.perf_counter() - t_phase,
    }
    emit(record)
    return record


def _param_group(name, stage_of_block):
    """The gradient-norm group of a parameter: a decoder layer, an MBConv
    stage (its blocks and their FiLM layers), or the module it sits in."""
    parts = name.split(".")
    if parts[0] == "transformer" and parts[1].startswith("layer_"):
        return "decoder_" + parts[1]
    if "net" in parts:
        leaf = parts[parts.index("net") + 1]
        if leaf.startswith(("block_", "film_")):
            return f"mbconv_stage_{stage_of_block[int(leaf.split('_')[1])]}"
        return "tower_" + leaf
    return ".".join(parts[:2])


def _stage_of_block(policy):
    """MBConv block index -> stage index (0..6) of the policy's tower; {}
    for a tokenizer without one."""
    from rt1_tpu_torch.models.efficientnet import BLOCKS_ARGS, round_repeats

    net = getattr(getattr(policy.image_tokenizer, "encoder", None), "net", None)
    if net is None:
        return {}
    stages = []
    for stage, args in enumerate(BLOCKS_ARGS):
        stages += [stage] * round_repeats(args["repeats"], net.depth_coefficient)
    return dict(enumerate(stages))


def phase_train_parity(config_name: str = "language_table", device: str = "cuda", batch: int = 2):
    """One float32 train step of the flagship on `device` against the CPU."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config
    from rt1_tpu_torch.train.train import build_model, synthetic_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config(config_name)
    for assignment in ("model.dtype=float32", "model.dropout_rate=0",
                       "regularization.crop_ratio=0", "regularization.drop_connect_rate=0",
                       f"per_host_batch_size={batch}", "obs.model_health=False"):
        apply_override(config, assignment)
    host_batch = synthetic_batch(config, config.seed, 0, "cpu")
    runs = {}
    for dev in (device, "cpu"):
        policy = build_model(config, dev)
        optimizer = optimizer_from_config(config)
        state = create_train_state(policy, optimizer)
        fns = train_step_fns_from_config(config, optimizer)
        tbatch = tuple({k: v.to(dev) for k, v in tree.items()} for tree in host_batch)
        t0 = time.perf_counter()
        metrics = fns.train_step(state, tbatch, 0, keep_grad=True)
        grads = {k: g.double().cpu() for k, g in fns.grads_by_name(state, metrics["grad"]).items()}
        runs[dev] = {
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "grads": grads,
            "stats": {k: v.double().cpu() for k, v in policy.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "params": {k: p.detach().double().cpu() for k, p in policy.named_parameters()},
            "seconds": time.perf_counter() - t0, "stage_of_block": _stage_of_block(policy),
        }
        del policy, state, fns, metrics
        torch.cuda.empty_cache()
    gpu, cpu = runs[device], runs["cpu"]
    groups = {}
    for name in cpu["grads"]:
        groups.setdefault(_param_group(name, cpu["stage_of_block"]), []).append(name)

    def group_norm(run, names):
        return float(torch.sqrt(sum((run["grads"][n] ** 2).sum() for n in names)))

    group_rows = {}
    for group, names in sorted(groups.items()):
        g_cpu, g_gpu = group_norm(cpu, names), group_norm(gpu, names)
        ref = max(g_cpu, 1e-3 * cpu["grad_norm"])
        group_rows[group] = {"cpu": g_cpu, "gpu": g_gpu, "rel_err": abs(g_gpu - g_cpu) / ref}
    stats_err = max((float((gpu["stats"][k] - v).abs().max()) for k, v in cpu["stats"].items()),
                    default=0.0)
    scale = max(float(g.abs().max()) for g in cpu["grads"].values())
    leaf_errs = {name: float((gpu["grads"][name] - g).abs().max()) / scale
                 for name, g in cpu["grads"].items()}
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    # Settled by the CPU's gradient alone (see TRAIN_TOL).
    floor = max(100 * 1e-8, 10 * TRAIN_TOL["grad_leaf"] * scale)
    settled, total, settled_err = 0, 0, 0.0
    for name, p_cpu in cpu["params"].items():
        mask = cpu["grads"][name].abs() >= floor
        settled += int(mask.sum())
        total += mask.numel()
        if mask.any():
            settled_err = max(settled_err, float((gpu["params"][name] - p_cpu).abs()[mask].max()))
    errors = {
        "loss": abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        "grad_norm": abs(gpu["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"],
        "group_grad_norm": max(r["rel_err"] for r in group_rows.values()),
        "grad_leaf": leaf_errs[worst_leaf],
        "batch_stats": stats_err,
        "params_settled": settled_err,
    }
    record = {
        "phase": "train_parity", "config": config_name, "batch": batch, "dtype": "float32",
        "tf32": False, "loss": {"gpu": gpu["loss"], "cpu": cpu["loss"]},
        "grad_norm": {"gpu": gpu["grad_norm"], "cpu": cpu["grad_norm"]},
        "max_err": errors, "tol": TRAIN_TOL, "group_grad_norms": group_rows,
        "grad_leaf_worst": worst_leaf, "grad_scale": scale,
        "params_settled_floor": floor, "params_settled_share": settled / total,
        "step_s": {"device": gpu["seconds"], "cpu": cpu["seconds"]},
    }
    emit(record)
    bad = {k: v for k, v in errors.items() if not v <= TRAIN_TOL[k]}
    if bad or not np.isfinite(gpu["loss"]):
        raise AssertionError(f"train parity: errors {bad} beyond {TRAIN_TOL}")
    return record


def _timed_step(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_train(config_name: str = "language_table", device: str = "cuda", workdir=None):
    """The flagship training path in bf16 on the card: timed steps, loss on
    a fixed batch, a fused eval step, then the CLI with resume and serve
    (in `workdir` when given, which then keeps the checkpoints)."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.obs.flops import step_flops
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config
    from rt1_tpu_torch.train.train import build_model, synthetic_batch

    # PyTorch's defaults, which the parity phases turned off: the trainer
    # runs with them.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config(config_name)
    apply_override(config, "model.attention_impl=fused")  # eval steps only: training runs dense
    # The step this phase has measured since PR 3; train_ops measures the
    # health pack beside it.
    apply_override(config, "obs.model_health=False")
    policy = build_model(config, device)
    optimizer = optimizer_from_config(config)
    state = create_train_state(policy, optimizer)
    fns = train_step_fns_from_config(config, optimizer)
    b, t = config.per_host_batch_size, config.model.time_sequence_length
    batches = [synthetic_batch(config, config.seed, i, device) for i in range(2)]
    reset_launch_counts()  # the train steps' launches start here
    step = 0
    for _ in range(TRAIN_WARMUP):
        fns.train_step(state, batches[step % 2], step)
        step += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(TRAIN_TIMED):
        ms, metrics = _timed_step(lambda: fns.train_step(state, batches[step % 2], step))
        walls.append(ms)
        step += 1
    peak_bytes = torch.cuda.max_memory_allocated()
    counter = {"step": step}

    def one_step():
        fns.train_step(state, batches[counter["step"] % 2], counter["step"])
        counter["step"] += 1

    prof = device_profile(one_step, iters=3)
    flops, flops_raw = step_flops(one_step)
    torch.cuda.synchronize()
    train_launches = dict(fused_attention.launches_by_variant)
    if any(train_launches.values()):
        raise AssertionError(f"train: fused attention launched in train steps: {train_launches}")
    step = counter["step"]
    fixed = synthetic_batch(config, config.seed, 10_000, device)
    losses = []
    for _ in range(TRAIN_FIT_STEPS):
        losses.append(float(fns.train_step(state, fixed, step)["loss"]))
        step += 1
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"train: loss on a fixed batch did not fall: {losses}")
    reset_launch_counts()
    eval_metrics = fns.eval_step(state, fixed)
    torch.cuda.synchronize()
    eval_launches = dict(fused_attention.launches_by_variant)
    expected = {"tensor_core": policy.num_layers, "tf32x3": 0, "simple": 0}
    acc = float(eval_metrics["token_accuracy"])
    if eval_launches != expected or not np.isfinite(float(eval_metrics["loss"])) or not 0 <= acc <= 1:
        raise AssertionError(f"train: fused eval step launches {eval_launches} (expected "
                             f"{expected}), metrics {eval_metrics}")
    median_ms = float(np.median(walls))
    record = {
        "phase": "train", "config": config_name, "batch": b, "window": t,
        "compute_dtype": str(fns.compute_dtype).split(".")[-1], "masters": "float32",
        "guard": fns.guard_nonfinite, "step_wall_ms": {"median": median_ms, "min": min(walls),
                                                      "max": max(walls), "all": walls},
        "frames_per_s": b * t / (median_ms / 1e3),
        "peak_memory_bytes": peak_bytes, "flops_per_step": flops,
        "mfu": flops / (median_ms / 1e3) / PEAK_OPS_PER_S["bfloat16"],
        "flops_per_step_flopcounter_formulas": flops_raw,
        "mfu_flopcounter_formulas": flops_raw / (median_ms / 1e3) / PEAK_OPS_PER_S["bfloat16"],
        "train_step_attention_launches": train_launches,
        "fit": {"steps": TRAIN_FIT_STEPS, "first5_mean": first, "last5_mean": last,
                "losses": losses},
        "eval": {"loss": float(eval_metrics["loss"]), "token_accuracy": acc,
                 "attention_launches": eval_launches},
        "updates": int(state.step), "guard_skips": int(state.guard_skips),
    }
    if prof is not None:
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:10]
        record.update({
            "profiled_wall_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
            "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"],
            "device_launches": prof["launches"],
            "top_kernels_ms": [[name[:80], ms] for name, ms in top],
        })
    del policy, state, fns, batches, fixed
    torch.cuda.empty_cache()
    record["profile_train"] = _profile_train(config_name, device, record)
    torch.cuda.empty_cache()
    record["cli"] = _train_cli(config_name, device, workdir)
    emit(record)
    return record


PROFILE_TRAIN_STEPS = 3


def _profile_train(config_name, device, train=None):
    """`python -m rt1_tpu_torch.train.profile_train` (its `main`, in
    process) for PROFILE_TRAIN_STEPS steps of the config: the Chrome trace
    with one step mark a step, CUDA kernel events on the card (the CLI
    exits non-zero without them), `host_trace.json` with a `device_step`
    span a step, no fused-attention launch (training runs dense); beside
    `train`'s profiled busy ms and launches a step (phase train)."""
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts
    from rt1_tpu_torch.train import profile_train

    with tempfile.TemporaryDirectory() as logdir:
        reset_launch_counts()
        lines, seconds = _run_in_process(profile_train.main, [
            "--model", "tiny" if config_name == "tiny" else "flagship", "--steps",
            str(PROFILE_TRAIN_STEPS), "--logdir", logdir, "--device", device])
        launches = dict(fused_attention.launches_by_variant)
        summary = lines[-1]
        marks = profile_train.step_marks(os.path.join(logdir, profile_train.TRACE_NAME))
        with open(os.path.join(logdir, profile_train.HOST_TRACE_NAME)) as f:
            spans = [e for e in json.load(f)["traceEvents"] if e.get("name") == "device_step"]
        trace_bytes = os.path.getsize(os.path.join(logdir, profile_train.TRACE_NAME))
    if len(marks) != PROFILE_TRAIN_STEPS or len(spans) != PROFILE_TRAIN_STEPS or \
            summary["step_marks"] != PROFILE_TRAIN_STEPS:
        raise AssertionError(f"profile_train: {len(marks)} step marks, {len(spans)} "
                             f"device_step spans, expected {PROFILE_TRAIN_STEPS}")
    if any(launches.values()):
        raise AssertionError(f"profile_train: fused attention launched in train steps {launches}")
    if (device == "cuda") != ("device_busy_ms_per_step" in summary):
        raise AssertionError(f"profile_train: device numbers {summary}")
    record = {**summary, "seconds": seconds, "trace_bytes": trace_bytes,
              "attention_launches": launches}
    if train is not None and "device_busy_ms" in train and "device_busy_ms_per_step" in summary:
        # The same step as phase train's: a gap over ~10 % is a finding.
        record["busy_ratio_to_phase_train"] = \
            summary["device_busy_ms_per_step"] / train["device_busy_ms"]
        record["launch_ratio_to_phase_train"] = \
            summary["launches_per_step"] / train["device_launches"]
    emit({"phase": "profile_train", **record})
    return record


def _run_in_process(main, args):
    """A CLI's `main(argv)` in this process (its JSON stdout lines, its
    seconds): the entry a user calls without a process start of its own,
    which would time only the interpreter, torch's import and the CUDA
    context."""
    import io

    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        code = main(list(args))
    if code != 0:
        raise AssertionError(f"{main.__module__} {args}: exit code {code}")
    lines = [json.loads(x) for x in printed.getvalue().splitlines() if x.startswith("{")]
    return lines, time.perf_counter() - t0


CLI_DUMP_GRACE_S = 15     # a timed-out command's processes printing their stacks


def _run_cli(args, timeout_s, module="rt1_tpu_torch.train"):
    """`python -m module args` in a process group of its own, with
    faulthandler armed in it and in every process it starts. Past
    `timeout_s` the whole group gets SIGABRT, so each process (a fleet's
    supervisor and replicas too) prints every thread's stack before it
    dies; what the command printed goes to stderr and, whole, to
    `chiprun_out/cli_timeout_<module>_<pid>.txt`, and TimeoutExpired is
    raised. No process of the group outlives the call. Core files are off
    (this process's limit, which the group inherits): SIGABRT writes none."""
    import resource

    resource.setrlimit(resource.RLIMIT_CORE, (0, resource.getrlimit(resource.RLIMIT_CORE)[1]))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PYTHONFAULTHANDLER="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGABRT)
        try:
            out, err = proc.communicate(timeout=CLI_DUMP_GRACE_S)
        except subprocess.TimeoutExpired:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        path = os.path.join(REPO, "chiprun_out", f"cli_timeout_{module}_{proc.pid}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(f"{module} {args}: cut at {timeout_s} s\n--- stdout\n{out}\n--- stderr\n{err}")
        sys.stderr.write(f"{module} {args}: cut at {timeout_s} s; its stdout ends\n{out[-4000:]}\n"
                         f"its stderr (the stacks) ends\n{err[-16000:]}\nwhole: {path}\n")
        raise subprocess.TimeoutExpired(proc.args, timeout_s, output=out, stderr=err) from None
    finally:
        # A process of the group still alive past the command (a leaked
        # replica) does not outlive the call.
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    if proc.returncode != 0:
        sys.stderr.write(err[-8000:])
        raise AssertionError(f"{module} {args}: exit code {proc.returncode}")
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return lines, time.perf_counter() - t0


def _train_cli(config_name, device, workdir=None):
    """The trainer's CLI: 4 steps (checkpoints 2 and 4), a rerun to 6 that
    restores step 4, then the server on the workdir answering one /act.
    `workdir` (default: a temporary one) keeps the checkpoints."""
    import numpy as np

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.train.__main__ import main as train_main

    config = get_config(config_name)
    h, w = config.data.height, config.data.width
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory())
        base = ["--config", config_name, "--workdir", workdir, "--device", device,
                "--set", "checkpoint_every_steps=2"]
        # In process (the script's time limit): the CLI's `main`.
        first, first_s = _run_in_process(train_main, base + ["--set", "num_steps=4"])
        if first[0].get("restored_step") is not None or first[-1].get("checkpoint_step") != 4:
            raise AssertionError(f"train CLI: first run {first[0]} ... {first[-1]}")
        second, second_s = _run_in_process(train_main, base + ["--set", "num_steps=6"])
        if second[0].get("restored_step") != 4 or second[-1].get("checkpoint_step") != 6:
            raise AssertionError(f"train CLI: rerun {second[0]} ... {second[-1]}")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "rt1_tpu_torch.serve", "--config", config_name,
               "--workdir", workdir, "--port", "0", "--device", device, "--max_sessions", "1"]
        with tempfile.TemporaryFile(mode="w+") as errlog:
            proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=errlog, text=True)
            try:
                ready = _read_ready_line(proc, SERVE_TIMEOUT_S)
                frame = np.random.default_rng(7).integers(0, 256, (h, w, 3), dtype=np.uint8)
                code, out = _http(f"http://127.0.0.1:{ready['port']}/act", {
                    "session_id": "trained", "instruction": "push the red star to the left",
                    "image_b64": base64.b64encode(frame.tobytes()).decode()})
                action = np.asarray(out.get("action", []), np.float64)
                if code != 200 or action.shape != (2,) or not np.isfinite(action).all() or \
                        ready.get("checkpoint_step") != 6:
                    raise AssertionError(f"serve --workdir: {code} {out} ready {ready}")
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=120)
                if rc != 0:
                    raise AssertionError(f"serve --workdir: exit code {rc} after SIGTERM")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
                if proc.returncode not in (0, None):
                    errlog.seek(0)
                    sys.stderr.write(errlog.read()[-8000:])
    return {"first_run_s": first_s, "rerun_s": second_s, "restored_step": second[0]["restored_step"],
            "checkpoint_step": second[-1]["checkpoint_step"],
            "served_checkpoint_step": ready["checkpoint_step"], "act": out}


# The trainer's resilience and observability (phase train_ops), at the
# flagship's width with the flagship config's resilience.* and obs.*.
TRAIN_OPS_WARMUP, TRAIN_OPS_TURN = 3, 5      # warm-up steps; timed steps a turn
TRAIN_OPS_TURNS = (False, True, True, False)  # model_health off, on, on, off
TRAIN_OPS_PROFILED = 3
TRAIN_OPS_ROLLBACK = ("num_steps=8", "checkpoint_every_steps=2", "log_every_steps=1",
                      "resilience.guard_skip_budget=1", "resilience.faults=nan_batch@4x3")
# The flagship's own obs values, named so that a CPU rehearsal on `tiny`
# (which turns them off) runs the same checks.
TRAIN_OPS_OBS = ("obs.model_health=True", "obs.goodput_mfu=True")
TRAIN_OPS_CLI = ("num_steps=12", "checkpoint_every_steps=4", "log_every_steps=2",
                 "eval_every_steps=4", "model.attention_impl=fused") + TRAIN_OPS_OBS
TRAIN_OPS_SCRAPED = ("rt1_train_goodput_", "rt1_train_health_", "rt1_train_timing_",
                     "rt1_train_guard_")


def _sets(assignments):
    return [arg for a in assignments for arg in ("--set", a)]


def _train_ops_pack_cost(config, device):
    """The health pack's cost on the flagship step: host ms (synchronised
    steps) and device launches a step with the pack off and on, in turns;
    the pack's entries against `pack_names` of a meta-device policy; and the
    FLOPs of the pack-free step (phase `train`'s count)."""
    import dataclasses

    import numpy as np
    import torch

    from rt1_tpu_torch.eval.restore import build_policy
    from rt1_tpu_torch.obs.flops import train_step_flops
    from rt1_tpu_torch.obs.health import PACK_KEY, pack_names, param_paths, unpack
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config
    from rt1_tpu_torch.train.train import build_model, synthetic_batch

    policy = build_model(config, device)
    optimizer = optimizer_from_config(config)
    state = create_train_state(policy, optimizer)
    on = train_step_fns_from_config(config, optimizer)
    off = dataclasses.replace(on, model_health=False)
    batches = [synthetic_batch(config, config.seed, i, device) for i in range(2)]
    counter = {"step": 0}

    def step(fns):
        metrics = fns.train_step(state, batches[counter["step"] % 2], counter["step"])
        counter["step"] += 1
        return metrics

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for _ in range(TRAIN_OPS_WARMUP):
        step(on)
        step(off)
    walls = {False: [], True: []}
    turns = []
    for health in TRAIN_OPS_TURNS:
        fns = on if health else off
        turn = []
        for _ in range(TRAIN_OPS_TURN):
            sync()
            t0 = time.perf_counter()
            metrics = step(fns)
            sync()
            turn.append((time.perf_counter() - t0) * 1e3)
            if health:
                pack = metrics[PACK_KEY]
        walls[health] += turn
        turns.append(float(np.median(turn)))
    names = on.health_names(state)
    values = unpack(names, pack)
    with torch.device("meta"):
        meta = build_policy(config)
    expected = pack_names(param_paths(meta), config.obs.health_group_depth,
                          action_dims=meta.tokens_per_action)
    if names != expected or not all(np.isfinite(list(values.values()))):
        raise AssertionError(f"train_ops: pack names {names[:4]}... (expected "
                             f"{expected[:4]}...), values {values}")
    record = {"entries": len(names), "groups": sum(n.startswith("health/grad_norm/")
                                                   for n in names)}
    for health in (False, True):
        key = "on" if health else "off"
        record[f"host_ms_{key}"] = {"median": float(np.median(walls[health])),
                                    "all": walls[health]}
        if on_card:
            prof = device_profile(lambda: step(on if health else off), iters=TRAIN_OPS_PROFILED)
            record[f"launches_{key}"] = None if prof is None else prof["launches"]
            record[f"busy_ms_{key}"] = None if prof is None else prof["busy_ms"]
    # Off, on, on, off: each on turn against its neighbouring off turn,
    # which cancels a drift over the four turns.
    record["turn_median_ms"] = turns
    record["added_host_ms"] = ((turns[1] - turns[0]) + (turns[2] - turns[3])) / 2
    if on_card and record.get("launches_on") is not None and record["launches_off"] is not None:
        record["added_launches"] = record["launches_on"] - record["launches_off"]
    # FLOPs of the whole pack-free step: what phase `train` counts.
    record["step_flops_pack_off"] = train_step_flops(lambda: step(off))
    del policy, state, on, off, batches, meta
    return record


def _train_ops_scrape(config, device, workdir):
    """A 6-step run with the scrape listener on an ephemeral port, scraped
    once from the `log` callback at log step 4 (the pack's gauges ride in
    from log step 2)."""
    import urllib.request

    from rt1_tpu_torch.configs import apply_override
    from rt1_tpu_torch.obs.prometheus import parse_exposition
    from rt1_tpu_torch.train.train import train_and_evaluate

    cfg = copy.deepcopy(config)
    for assignment in ("num_steps=6", "log_every_steps=2", "obs.prometheus_port=0"):
        apply_override(cfg, assignment)
    seen = {"records": []}

    def log(record):
        seen["records"].append(record)
        if record.get("status") == "start":
            seen["url"] = record["metrics_url"]
        elif record.get("step") == 4 and "loss" in record:
            with urllib.request.urlopen(seen["url"], timeout=60) as resp:
                seen["text"] = resp.read().decode()

    train_and_evaluate(cfg, workdir, device=device, log=log)
    exp = parse_exposition(seen["text"])
    families = sorted(exp.types)
    counts = {prefix: sum(f.startswith(prefix) for f in families) for prefix in TRAIN_OPS_SCRAPED}
    if not all(counts.values()):
        raise AssertionError(f"train_ops: scrape at step 4 lacks families: {counts}")
    # The listener is closed with the run: its port no longer answers.
    try:
        urllib.request.urlopen(seen["url"], timeout=5)
        raise AssertionError("train_ops: the scrape listener outlived its run")
    except (urllib.error.URLError, ConnectionError):
        pass
    return {"url": seen["url"], "families": len(families), "by_prefix": counts,
            "health_gauges_sample": [f for f in families if f.startswith("rt1_train_health_")][:3]}


def _guard_counters(records):
    last = [r for r in records if "guard/checks_total" in r][-1]
    return {k: v for k, v in last.items() if k.startswith("guard/")}


def _train_ops_rollback(config, device, workdir):
    """The guard's rollback at this config's width: `nan_batch@4x3` under a
    skip budget of 1; returns the run's record, its guard counters and
    goodput summary."""
    from rt1_tpu_torch.configs import apply_override
    from rt1_tpu_torch.resilience import faults
    from rt1_tpu_torch.train.train import train_and_evaluate

    cfg = copy.deepcopy(config)
    for assignment in TRAIN_OPS_ROLLBACK:
        apply_override(cfg, assignment)
    records = []
    try:
        state = train_and_evaluate(cfg, workdir, device=device, log=records.append)
    finally:
        faults.clear()
    rollbacks = [r for r in records if r.get("status") == "guard_rollback"]
    with open(os.path.join(workdir, "goodput_summary.json")) as f:
        summary = json.load(f)
    return {"updates": int(state.step), "guard_skips": int(state.guard_skips),
            "rollbacks": rollbacks, "counters": _guard_counters(records),
            "done": records[-1], "goodput": summary}


def phase_train_ops(config_name: str = "language_table", device: str = "cuda", train=None):
    """The trainer's resilience and observability at the flagship's width:
    the health pack's cost, the scrape listener's live gauges, a guard
    rollback (its counters held to the tiny config's on the CPU) and the
    train CLI through a NaN batch, a retried save and a self-delivered
    SIGTERM, then its resume. `train`, phase `train`'s record where it ran,
    gives the FLOPs the ledger's must equal and the MFU to print beside."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.parallel.flash_attention import reset_launch_counts

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config(config_name)
    for assignment in TRAIN_OPS_OBS:
        apply_override(config, assignment)
    record = {"phase": "train_ops", "config": config_name,
              "resilience": vars(config.resilience), "obs": vars(config.obs)}
    reset_launch_counts()
    record["pack"] = _train_ops_pack_cost(config, device)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        record["scrape"] = _train_ops_scrape(config, device, os.path.join(root, "scrape"))
        gc.collect()
        rollback = _train_ops_rollback(config, device, os.path.join(root, "rollback"))
        # The same scenario on the tiny config on the CPU, which the CPU
        # tests hold to JAX's loop.
        reference = _train_ops_rollback(get_config("tiny"), "cpu", os.path.join(root, "tiny"))
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    restored = [r["restored_step"] for r in rollback["rollbacks"]]
    if (restored != [4] or rollback["done"].get("step") != 8 or rollback["guard_skips"] < 2
            or rollback["counters"] != reference["counters"]
            or not rollback["goodput"]["buckets_s"]["rollback_replay"] > 0):
        raise AssertionError(f"train_ops: rollback {rollback} against the tiny CPU run "
                             f"{reference['counters']}")
    record["rollback"] = {"restored": restored, "updates": rollback["updates"],
                          "guard_skips": rollback["guard_skips"],
                          "counters": rollback["counters"],
                          "goodput_buckets_s": rollback["goodput"]["buckets_s"],
                          "flops_per_step": rollback["goodput"].get("flops_per_step")}
    counted = {record["pack"]["step_flops_pack_off"]}
    if train is not None:
        counted.add(float(train["flops_per_step"]))
    if {record["rollback"]["flops_per_step"]} != counted:
        raise AssertionError(f"train_ops: the ledger's FLOPs {record['rollback']} differ from "
                             f"the step's {counted}")
    record["cli"] = _train_ops_cli(config_name, device, config.eval_batches,
                                   config.model.num_layers if on_card else 0)
    record["phase_s"] = time.perf_counter() - t_phase
    emit(record)
    print(f"train_ops: health pack host ms off {record['pack']['host_ms_off']['median']:.2f} "
          f"on {record['pack']['host_ms_on']['median']:.2f}; launches off "
          f"{record['pack'].get('launches_off')} on {record['pack'].get('launches_on')}",
          flush=True)
    print(f"train_ops: goodput buckets (s) {json.dumps(record['cli']['goodput']['buckets_s'])}",
          flush=True)
    train_mfu = None if train is None else train["mfu"] * 100
    print(f"train_ops: ledger mfu_pct {record['cli']['goodput'].get('mfu_pct')} (CLI run), "
          f"phase train's mfu_pct {train_mfu}", flush=True)
    print(f"train_ops: phase {record['phase_s']:.1f} s; {nvidia_smi() if on_card else 'cpu'}",
          flush=True)
    return record


def _train_ops_cli(config_name, device, eval_batches, layers):
    """`python -m rt1_tpu_torch.train` through `TRAIN_OPS_CLI`'s faults (a
    process of its own: it takes a SIGTERM), then a rerun to 12 without
    them (its `main`, in process)."""
    from rt1_tpu_torch.train.__main__ import main as train_main

    with tempfile.TemporaryDirectory() as workdir:
        base = ["--config", config_name, "--workdir", workdir, "--device", device]
        first, first_s = _run_cli(
            base + _sets(TRAIN_OPS_CLI + ("resilience.faults=nan_batch@2,ckpt_save@1,sigterm@9",)),
            TRAIN_CLI_TIMEOUT_S)
        logs = [r for r in first if "loss" in r]
        at4 = next(r for r in logs if r["step"] == 4)
        done = first[-1]
        ckpts = sorted(int(s) for s in os.listdir(os.path.join(workdir, "checkpoints")))
        with open(os.path.join(workdir, "goodput_summary.json")) as f:
            goodput = json.load(f)
        with open(os.path.join(workdir, "flight_record.jsonl")) as f:
            flight = json.loads(f.readline())["flight_recorder"]
        evals = [r for r in first if "eval_loss" in r]
        launches = [{v: r[f"eval_attention_launches_{v}"] for v in ("tensor_core", "tf32x3",
                                                                    "simple")} for r in evals]
        expected = {"tensor_core": layers * eval_batches, "tf32x3": 0, "simple": 0}
        checks = {
            "one_skip_ok_verdict": (at4["guard_skips_cum"] == 1
                                    and at4["guard/device_skips_total"] == 1
                                    and at4["guard/bad_checks_total"] == 0
                                    and done["guard_skips"] == 1),
            "save_retried_once": logs[-1].get("retry/ckpt_save_retries_total") == 1,
            "preempted_at_10": (done.get("preempted") is True and done["step"] == 10
                                and done["checkpoint_step"] == 10 and ckpts[-1] == 10),
            "goodput_sums_to_1": abs(sum(goodput["fractions"].values()) - 1.0) <= 1e-6,
            "mfu_positive": goodput.get("mfu_pct", 0) > 0 and goodput["preempted"],
            "flight_reason_preempt": flight["reason"] == "preempt",
            "eval_launches": len(evals) == 2 and all(x == expected for x in launches),
        }
        if not all(checks.values()):
            raise AssertionError(f"train_ops CLI: {checks}; done {done}; goodput {goodput}; "
                                 f"evals {launches}")
        # The rerun needs no signal of its own: its `main`, in process.
        second, second_s = _run_in_process(train_main,
                                           base + _sets(TRAIN_OPS_CLI + ("resilience.faults=",)))
        with open(os.path.join(workdir, "goodput_summary.json")) as f:
            resumed = json.load(f)
        start = next(r for r in second if r.get("status") == "start")
        if (start.get("restored_step") != 10 or second[-1].get("step") != 12
                or second[-1].get("checkpoint_step") != 12
                or not resumed["buckets_s"]["ckpt_restore"] > 0):
            raise AssertionError(f"train_ops CLI rerun: {second[:2]} ... {second[-1]}; "
                                 f"{resumed['buckets_s']}")
    return {"first_run_s": first_s, "rerun_s": second_s, "checks": checks, "done": done,
            "checkpoints": ckpts, "goodput": goodput, "flight_reason": flight["reason"],
            "eval_launches": launches, "per_eval": expected, "eval_batches": eval_batches,
            "resumed": {"restored_step": start["restored_step"], "done": second[-1],
                        "goodput_buckets_s": resumed["buckets_s"],
                        "mfu_pct": resumed.get("mfu_pct")}}


# The data phase: Language-Table episode files -> loaders -> pinned upload
# -> the flagship train step.
# Train episodes: twice CACHE_EPISODES, the episodes a windowed loader
# (each worker) keeps decoded, so that at most half of the timed windows
# find theirs decoded (four times until the script's time limit forced
# the cut).
DATA_EPISODES = {"train": 128, "val": 4}
DATA_STEPS = 20                  # steps an episode, at Language-Table's 180x320
DATA_WARM, DATA_BATCHES = 5, 10   # batches of each loader alone: drained, then timed
DATA_CHECK_STEPS = 9             # fed steps per turn whose batch is held to its host batch
DATA_TIMED = 3                   # timed steps a fed turn, each way (phase train times 10)
DATA_CLI_TIMEOUT_S = 600


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _write_corpus(root, config, episodes_per_split, steps, seed=0):
    """Seeded episodes with Language-Table's schema under `root`/{train,val},
    a dataset manifest, and both splits packed by the packer's CLI."""
    import numpy as np

    from rt1_tpu_torch.data import episodes

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for split, n in episodes_per_split.items():
        for i in range(n):
            episodes.save_episode(os.path.join(root, split, f"episode_{i:05d}.npz"),
                                  episodes.generate_synthetic_episode(rng, num_steps=steps))
    manifest = {"source": "chip_smoke seeded episodes", "seed": seed, "steps": steps,
                "episodes": episodes_per_split}
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    write_s = time.perf_counter() - t0
    from rt1_tpu_torch.data import pack_dataset

    d = config.data
    # The packer's `main` in process (a process start fewer).
    lines, pack_s = _run_in_process(pack_dataset.main, [
        "--data_dir", root, "--height", str(d.height), "--width", str(d.width),
        "--crop_factor", str(d.crop_factor)])
    sizes = {}
    for dirpath, _, names in os.walk(root):
        part = "pack" if dirpath.endswith("_packed") else "episodes"
        sizes[part] = sizes.get(part, 0) + sum(os.path.getsize(os.path.join(dirpath, n))
                                               for n in names)
    # One episode file read cold (its pages just dropped), then warm.
    probe = os.path.join(root, "train", "episode_00000.npz")
    rates = {}
    for kind in ("cold", "warm"):
        if kind == "cold":
            _drop_page_cache(root)
        t0 = time.perf_counter()
        with open(probe, "rb") as f:
            n = len(f.read())
        rates[f"{kind}_read_GBps"] = n / (time.perf_counter() - t0) / 1e9
    return manifest, {"write_s": write_s, "pack_s": pack_s, "packs": lines, "bytes": sizes,
                      "file_system": _file_system(root), **rates}


def _file_system(path):
    """The type of the file system that holds `path` (/proc/mounts)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            mount, fs = line.split()[1:3]
            if (path == mount or path.startswith(mount.rstrip("/") + "/")) and \
                    len(mount) >= len(best):
                best, kind = mount, fs
    return kind


def _drop_page_cache(root):
    """Write back every file under `root` and drop its pages from the OS
    page cache (posix_fadvise DONTNEED), so that the next reads come from
    the disk, as on a corpus larger than the host's memory. Pages still
    mapped (an open pack) do not drop, nor anything on a memory file
    system; `_write_corpus` records which it is."""
    gc.collect()  # unmap the packs of closed caches
    for dirpath, _, names in os.walk(root):
        for name in names:
            fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            try:
                os.fdatasync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def _sampler_check(root, config, build_s):
    """The sampler built here against its plain version at the flagship
    geometry (exact) on one batch's worth of frames, and the packed gather
    against plain slices."""
    import numpy as np

    from rt1_tpu_torch.data import native, pack
    from rt1_tpu_torch.data.episodes import load_episode
    from rt1_tpu_torch.data.pipeline import _crop_box, crop_resize_frames, crop_resize_reference

    d = config.data
    n = config.per_host_batch_size * config.model.time_sequence_length
    frames = []
    for i in range(2):
        frames += list(load_episode(os.path.join(root, "train", f"episode_{i:05d}.npz"))["rgb"])
    frames = frames[:n]
    rng = np.random.default_rng(1)
    boxes = [_crop_box(*f.shape[:2], d.crop_factor, rng) for f in frames]
    t0 = time.perf_counter()
    got = crop_resize_frames(frames, boxes, d.height, d.width)
    native_ms = (time.perf_counter() - t0) * 1e3
    want = crop_resize_reference(frames, boxes, d.height, d.width)
    mismatched = int((got != want).sum())
    cache = pack.PackedEpisodeCache(pack.default_pack_dir(root, "train"),
                                    window=config.model.time_sequence_length)
    gather_mismatched = 0
    for idx in (0, 7, len(cache) - 1):
        ep_i, start = cache.index[idx]
        draws = np.random.default_rng(idx)
        boxes_w = [cache.draw_box(draws) for _ in range(cache.window)]
        out = cache.gather_frames(ep_i, start, np.random.default_rng(idx))
        for j, box in enumerate(boxes_w):
            top, left = pack.map_box_to_packed(box, cache.src_h, cache.src_w, cache.packed_h,
                                               cache.packed_w, cache.height, cache.width)
            plain = cache.frames(ep_i)[cache._padded_src(start, j), top:top + cache.height,
                                       left:left + cache.width]
            gather_mismatched += int((out[j] != plain).sum())
    record = {"build_s": build_s, "library": os.path.relpath(native.library_path(), REPO),
              "frames": len(frames), "shape": [int(x) for x in got.shape],
              "native_ms": native_ms, "mismatched_bytes": mismatched,
              "gather_mismatched_bytes": gather_mismatched, "tolerance": "exact"}
    if mismatched or gather_mismatched:
        raise AssertionError(f"data: sampler disagrees with its plain version: {record}")
    return record


def _time_loader(batches, frames_per_batch, dataset=None):
    """frames/s of a host-batch iterator alone: DATA_WARM batches drained
    (the first includes the loader's start-up), DATA_BATCHES timed. With
    the `dataset` it reads in this process, also its episode reads a
    batch, their ms and share of the batch, and the share of windows that
    found their episode decoded."""
    t0 = time.perf_counter()
    next(batches)
    first_s = time.perf_counter() - t0
    for _ in range(DATA_WARM - 1):
        next(batches)
    r0, s0 = (dataset.episode_reads, dataset.episode_read_s) if dataset else (0, 0.0)
    t0 = time.perf_counter()
    for _ in range(DATA_BATCHES):
        next(batches)
    dt = time.perf_counter() - t0
    getattr(batches, "close", lambda: None)()
    ms = dt * 1e3 / DATA_BATCHES
    record = {"first_batch_s": first_s, "ms_per_batch": ms,
              "frames_per_s": DATA_BATCHES * frames_per_batch / dt}
    if dataset is not None:
        reads = dataset.episode_reads - r0
        read_ms = (dataset.episode_read_s - s0) * 1e3 / DATA_BATCHES
        windows = DATA_BATCHES * frames_per_batch // dataset.window
        record.update({"episode_reads_per_batch": reads / DATA_BATCHES,
                       "episode_read_ms_per_batch": read_ms, "episode_read_share": read_ms / ms,
                       "decoded_hit_rate": 1.0 - reads / windows})
    return record


def _loader_config(config, loader, **data):
    import copy

    cfg = copy.deepcopy(config)
    cfg.data.packed_cache = loader == "packed"
    cfg.data.loader = "numpy" if loader == "numpy" else "torch"
    for key, value in data.items():
        setattr(cfg.data, key, value)
    return cfg


class _HostRecorder:
    """Passes host batches through; once armed, keeps a copy of each so the
    batch the step received can be held to it."""

    def __init__(self, source):
        self.source = source
        self.armed = False
        self.copies = []

    def __iter__(self):
        return self

    def __next__(self):
        import torch

        batch = next(self.source)
        self.copies.append({g: {k: torch.as_tensor(v).clone() for k, v in leaves.items()}
                            for g, leaves in batch.items()} if self.armed else None)
        return batch

    def close(self):
        getattr(self.source, "close", lambda: None)()


def _fed_run(fns, state, step, next_batch, feeder, dev, frames_per_batch, recorder=None,
             dataset=None):
    """TRAIN_WARMUP + DATA_TIMED train steps, each fed by `next_batch()`,
    synchronised per step; then the loop's rate over DATA_TIMED steps with
    one synchronisation; the profiler's idle share over 3 steps; with a
    recorder, DATA_CHECK_STEPS more steps whose batch must equal its host
    batch. With the `dataset` the feed reads in this process, the episode
    reads' ms a timed step and their share of the wait. Returns (record,
    next step)."""
    import numpy as np

    box = {"step": step}

    def one_step():
        batch = next_batch(box["step"])
        fns.train_step(state, batch, box["step"])
        box["step"] += 1
        return batch

    for _ in range(TRAIN_WARMUP):
        one_step()
    _sync(dev)
    w0, u0 = (feeder.wait_s, feeder.upload_s) if feeder else (0.0, 0.0)
    r0, s0 = (dataset.episode_reads, dataset.episode_read_s) if dataset else (0, 0.0)
    walls = []
    for _ in range(DATA_TIMED):
        t0 = time.perf_counter()
        one_step()
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    per = 1e3 / DATA_TIMED
    wait_ms = (feeder.wait_s - w0) * per if feeder else None
    upload_ms = (feeder.upload_s - u0) * per if feeder else None
    reads = (dataset.episode_reads - r0, (dataset.episode_read_s - s0) * per) if dataset else None
    t0 = time.perf_counter()
    for _ in range(DATA_TIMED):
        one_step()
    _sync(dev)
    loop_s = time.perf_counter() - t0
    median = float(np.median(walls))
    record = {"step_wall_ms": {"median": median, "min": min(walls), "max": max(walls),
                               "all": walls},
              "wait_ms_per_step": wait_ms, "upload_ms_per_step": upload_ms,
              "frames_per_s": frames_per_batch / (median / 1e3),
              "loop_frames_per_s": DATA_TIMED * frames_per_batch / loop_s}
    if reads is not None:
        record.update({"episode_reads_per_step": reads[0] / DATA_TIMED,
                       "episode_read_ms_per_step": reads[1],
                       "episode_read_share_of_wait": reads[1] / wait_ms if wait_ms else None})
    if dev.type == "cuda":
        prof = device_profile(one_step, iters=3)
        if prof is not None:
            record.update({"profiled_wall_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
                           "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"]})
    if recorder is not None:
        recorder.armed = True
        checked = 0
        for _ in range(DATA_CHECK_STEPS):
            obs, actions = one_step()
            _sync(dev)
            host = recorder.copies[feeder.batches - 1]
            recorder.copies[feeder.batches - 1] = None
            # Pulled before arming (the feeder reads `depth` ahead): unchecked.
            if host is None:
                continue
            for group, got in (("observations", obs), ("actions", actions)):
                for k, v in got.items():
                    if not _tensors_equal(v.cpu(), host[group][k]):
                        raise AssertionError(f"data: the device batch's {group}/{k} differs "
                                             "from its host batch (a torn upload)")
            checked += 1
        record["batches_held_to_host"] = checked
    return record, box["step"]


def _tensors_equal(a, b):
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def _data_cli(root, config_name, device, manifest, num_layers):
    """The trainer's CLI on the corpus: 4 steps through the packed cache with
    eval on val (fused attention), then a rerun to 6 through the config's
    default loader, `tf` (the torch loader through the bounded shuffle
    buffer), that restores step 4."""
    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.train.__main__ import main as train_main

    on_card = device.startswith("cuda")
    data = get_config(config_name).data
    if data.loader != "tf" or data.packed_cache:
        raise AssertionError(f"data CLI: the rerun is to take the default tf loader, not "
                             f"loader={data.loader} packed_cache={data.packed_cache}")
    with tempfile.TemporaryDirectory() as workdir:
        base = ["--config", config_name, "--workdir", workdir, "--device", device,
                "--set", f"data.data_dir={root}", "--set", "checkpoint_every_steps=2",
                "--set", "eval_every_steps=2", "--set", "eval_batches=1",
                "--set", "log_every_steps=2", "--set", "model.attention_impl=fused"]
        first, first_s = _run_in_process(train_main, base + [
            "--set", "data.packed_cache=True", "--set", "num_steps=4"])
        second, second_s = _run_in_process(train_main, base + ["--set", "num_steps=6"])
        with open(os.path.join(workdir, "data_manifest.json")) as f:
            stamped = json.load(f)
    runs = []
    for lines, loader, restored, last in ((first, "packed", None, 4), (second, "tf", 4, 6)):
        start = next(x for x in lines if x.get("status") == "start")
        evals = [x for x in lines if "eval_loss" in x]
        expected = num_layers if on_card else 0
        bad = [x for x in evals
               if x["eval_attention_launches_tensor_core"] != expected * x["eval_batches"]
               or x["eval_attention_launches_tf32x3"] or x["eval_attention_launches_simple"]]
        stale = [x for x in lines if x.get("status") == "packed_cache_stale"]
        stream = "torch" if loader == "tf" else loader  # tf is the torch loader's buffered order
        if start["data_loader"] != stream or start["restored_step"] != restored or stale or \
                bad or not evals or lines[-1].get("checkpoint_step") != last:
            raise AssertionError(f"data CLI ({loader}): start {start}, evals {evals}, stale "
                                 f"{stale}, end {lines[-1]}")
        runs.append({"data_loader": loader, "shuffle_buffer": data.shuffle_buffer
                     if loader == "tf" else None, "restored_step": restored,
                     "eval_steps": [x["step"] for x in evals],
                     "eval_attention_launches_tensor_core": [
                         x["eval_attention_launches_tensor_core"] for x in evals],
                     "checkpoint_step": lines[-1]["checkpoint_step"]})
    if stamped != manifest:
        raise AssertionError(f"data CLI: data_manifest.json {stamped} != {manifest}")
    runs[0]["seconds"], runs[1]["seconds"] = first_s, second_s
    return runs


def phase_data(config_name: str = "language_table", device: str = "cuda",
               episodes_per_split=None, steps: int = DATA_STEPS):
    """Train the flagship from episode files: the corpus and its packs, the
    sampler held to its plain version, each loader alone, the bf16 train
    step fed by each loader through `device_feeder` beside the synthetic
    stream, device batches held to their host batches, and the CLI."""
    import shutil

    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.data import native
    from rt1_tpu_torch.data.feeder import SampleAheadFeeder
    from rt1_tpu_torch.data.pack import PackedEpisodeCache, default_pack_dir
    from rt1_tpu_torch.data.pipeline import (CACHE_EPISODES, WindowedEpisodeDataset,
                                             device_feeder, loader_batches)
    from rt1_tpu_torch.train.train import build_model, dataset_batches, synthetic_batch
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config

    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config(config_name)
    config.obs.model_health = False  # the fed step of phase `train`, without the pack
    b, t = config.per_host_batch_size, config.model.time_sequence_length
    frames_per_batch = b * t
    t0 = time.perf_counter()
    native.build()  # g++ of native/window_sampler.cc: its first use in this run
    build_s = time.perf_counter() - t0
    if episodes_per_split is None:
        episodes_per_split = DATA_EPISODES
        if DATA_EPISODES["train"] < 2 * CACHE_EPISODES:
            raise AssertionError("data: the train corpus must outgrow the decoded-episode "
                                 f"cache ({CACHE_EPISODES}) twice")
    root = tempfile.mkdtemp(prefix="rt1_chip_smoke_data_")
    try:
        config.data.data_dir = root
        free_gb = shutil.disk_usage(root).free / 1e9
        manifest, corpus = _write_corpus(root, config, episodes_per_split, steps)
        corpus["free_GB_before"] = free_gb
        sampler = _sampler_check(root, config, build_s)
        paths = sorted(os.path.join(root, "train", n) for n in os.listdir(
            os.path.join(root, "train")))

        def windowed():
            return WindowedEpisodeDataset(paths, window=t, crop_factor=config.data.crop_factor,
                                          height=config.data.height, width=config.data.width)

        # Each loader from a cold page cache, the numpy loader with a cold
        # decoded-episode cache too (the workers' start empty).
        _drop_page_cache(root)
        ds = windowed()
        alone = {"numpy": _time_loader(ds.numpy_batches(b, seed=0), frames_per_batch, ds)}
        # As the trainer runs it: 4 workers, pinned on the card (2 workers
        # and 4 unpinned were cut for the script's time limit).
        _drop_page_cache(root)
        alone["torch_4_workers"] = _time_loader(loader_batches(windowed().as_torch_loader(
            b, seed=0, num_workers=4, pin_memory=dev.type == "cuda")), frames_per_batch)
        del ds
        for threads in (1, 2, 4):
            _drop_page_cache(root)
            alone[f"packed_{threads}_threads"] = _time_loader(SampleAheadFeeder(
                PackedEpisodeCache(default_pack_dir(root, "train"), window=t), b, seed=0,
                num_threads=threads), frames_per_batch)

        policy = build_model(config, dev)
        optimizer = optimizer_from_config(config)
        state = create_train_state(policy, optimizer)
        fns = train_step_fns_from_config(config, optimizer)
        fed, step = {}, 0
        # One turn a loader (mirrored, twice each, until the script's time
        # limit forced the cut).
        turns = ("synthetic", "numpy", "torch", "packed")
        for turn, loader in enumerate(turns):
            turn_t0 = time.perf_counter()
            if loader == "synthetic":
                record, step = _fed_run(
                    fns, state, step, lambda i: synthetic_batch(config, config.seed, i, dev),
                    None, dev, frames_per_batch)
            else:
                _drop_page_cache(root)
                dataset = None
                if loader == "numpy":
                    # As dataset_batches builds it, held here for its reads.
                    dataset = windowed()
                    batches = dataset.numpy_batches(b, seed=config.seed)
                else:
                    stream = dataset_batches(_loader_config(config, loader), "train",
                                             pin_memory=dev.type == "cuda")
                    if stream.loader != loader:
                        raise AssertionError(f"data: asked for {loader}, got {stream.loader}")
                    batches = stream.batches
                recorder = _HostRecorder(batches)
                feeder = device_feeder(recorder, dev, depth=2)
                try:
                    record, step = _fed_run(fns, state, step, lambda i: next(feeder), feeder,
                                            dev, frames_per_batch, recorder, dataset)
                finally:
                    feeder.close()
            record["turn_s"] = time.perf_counter() - turn_t0
            fed[f"{turn}_{loader}"] = record
        held = sum(r.get("batches_held_to_host", 0) for r in fed.values())
        if held < 20:
            raise AssertionError(f"data: only {held} device batches held to their host batches")
        num_layers = policy.num_layers
        del policy, state, fns, optimizer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cli = _data_cli(root, config_name, device, manifest, num_layers)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record = {"phase": "data", "config": config_name, "batch": b, "window": t,
              "image": [config.data.height, config.data.width], "corpus": corpus,
              "sampler": sampler, "loader_alone": alone, "fed_step": fed,
              "batches_held_to_host": held, "cli": cli}
    emit(record)
    return record


# The rlds phase: the TFDS fixture through the port's RLDS path.
RLDS_FIXTURE = os.path.join("tests", "fixtures", "tfds_language_table")
RLDS_SPLITS = {"train": 2, "val": 1}   # the fixture's 3 episodes, converted
RLDS_TRAIN_STEPS = 2                   # CLI steps, then a resume to twice that
RLDS_LOADER_BATCHES = 3                # batches timed alone, after the first
RLDS_FED_WARMUP, RLDS_FED_TIMED = 2, 3
RLDS_SHUFFLE_BUFFER = 64               # ~3 passes of the fixture's 21 windows (config: 2048)
RLDS_SERVICE_WORKERS = 2               # data service worker processes
RLDS_SERVICE_START_S = 120             # a service process's ready record
# The fed step in turns: the RLDS stream in this process, the same through
# the service's workers, synthetic batches.
RLDS_AB_TURNS = ("inprocess", "service", "synthetic", "synthetic", "service", "inprocess")
RLDS_KILL_STEPS = (2, 8)               # service-fed steps before and after a worker is killed
RLDS_IN_FLIGHT = 2 + 2 + 1             # a killed worker's batches still due: AHEAD, feeder, reply


def _rlds_decode(fixture):
    """Every fixture frame through the port's decoders, held to TF's
    decode; the ms a frame of each encoding."""
    import hashlib

    import numpy as np

    from rt1_tpu_torch.data import codecs, tfds

    codecs.build()
    with open(os.path.join(fixture, "tf_decoded_sha256.json")) as f:
        digests = json.load(f)
    out = {}
    with np.load(os.path.join(fixture, "tf_decoded.npz")) as stored:
        pixels = {k: stored[k] for k in stored.files}
    for enc in ("jpeg", "png"):
        examples = list(tfds.TfdsDirectory(os.path.join(fixture, enc)).examples("train"))
        encoded = [ex["steps/observation/rgb"] for ex in examples]
        t0 = time.perf_counter()
        frames = [[codecs.decode_image(b, 3) for b in ep] for ep in encoded]
        seconds = time.perf_counter() - t0
        n = sum(len(ep) for ep in frames)
        got = [[hashlib.sha256(f.tobytes()).hexdigest() for f in ep] for ep in frames]
        held = [k for k in pixels if k.startswith(enc + "_")]
        off = [k for k in held if not np.array_equal(
            frames[int(k.split("_")[1])][int(k.split("_")[2])], pixels[k])]
        if got != digests[enc] or off or len(held) < 2:
            raise AssertionError(f"rlds: {enc} frames off TF's decode: digests "
                                 f"{got != digests[enc]}, pixels {off} of {held}")
        out[enc] = {"frames": n, "frames_equal_tf": n, "pixels_held": len(held),
                    "bytes_per_frame": sum(map(len, sum(encoded, []))) / n,
                    "ms_per_frame": seconds * 1e3 / n, "shape": list(frames[0][0].shape)}
    return out


def _rlds_cli(config_name, device, store, workdir, num_layers, service=None):
    """The train CLI on the converted store with data.loader=rlds_tf (with
    `service`, the data service's target, through its workers):
    RLDS_TRAIN_STEPS steps with an eval, then a resume to twice that."""
    from rt1_tpu_torch.train.__main__ import main as train_main

    on_card = device.startswith("cuda")
    base = ["--config", config_name, "--workdir", workdir, "--device", device,
            "--set", f"data.data_dir={store}", "--set", "data.loader=rlds_tf",
            "--set", f"checkpoint_every_steps={RLDS_TRAIN_STEPS}",
            "--set", f"eval_every_steps={RLDS_TRAIN_STEPS}", "--set", "eval_batches=1",
            "--set", "log_every_steps=1", "--set", "model.attention_impl=fused",
            "--set", f"data.shuffle_buffer={RLDS_SHUFFLE_BUFFER}"]
    if service is not None:
        base += ["--set", f"data.data_service_address={service}"]
    runs = []
    for restored, last in ((None, RLDS_TRAIN_STEPS), (RLDS_TRAIN_STEPS, 2 * RLDS_TRAIN_STEPS)):
        lines, seconds = _run_in_process(train_main, base + ["--set", f"num_steps={last}"])
        start = next(x for x in lines if x.get("status") == "start")
        evals = [x for x in lines if "eval_loss" in x]
        losses = [x["loss"] for x in lines if "loss" in x]
        expected = num_layers if on_card else 0
        bad = [x for x in evals
               if x["eval_attention_launches_tensor_core"] != expected * x["eval_batches"]
               or x["eval_attention_launches_tf32x3"] or x["eval_attention_launches_simple"]]
        # Through the service the loop logs the stream's gauges as feeder/*.
        fed_by = [x for x in lines if "feeder/received" in x]
        if start["data_loader"] != "rlds_tf" or start["restored_step"] != restored or bad or \
                not evals or lines[-1].get("checkpoint_step") != last or \
                not all(math.isfinite(x) for x in losses) or \
                (service is not None and not fed_by):
            raise AssertionError(f"rlds CLI{' (service)' if service else ''}: start {start}, "
                                 f"evals {evals}, losses {losses}, end {lines[-1]}")
        run = {"restored_step": restored, "checkpoint_step": last, "seconds": seconds,
               "losses": losses, "eval_steps": [x["step"] for x in evals],
               "eval_attention_launches_tensor_core": [
                   x["eval_attention_launches_tensor_core"] for x in evals]}
        if fed_by:
            run["service"] = {k.split("/", 1)[1]: v for k, v in fed_by[-1].items()
                              if k.startswith("feeder/")}
        runs.append(run)
    return runs


@contextlib.contextmanager
def _rlds_service(workers):
    """A data service dispatcher and `workers` workers, each a process of
    the forkserver (torch imported once there, never CUDA): yields (the
    dispatcher's target, [(worker process, its ready record)], seconds to
    start them all). Every process is stopped on the way out."""
    import multiprocessing

    from rt1_tpu_torch.data import service

    ctx = multiprocessing.get_context("forkserver")
    procs = []

    def start(role, **kwargs):
        ours, theirs = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=service.serve, args=(role,), kwargs=dict(kwargs, ready=theirs),
                           name=f"rt1-data-{role}", daemon=True)
        proc.start()
        procs.append(proc)
        theirs.close()
        try:
            if not ours.poll(RLDS_SERVICE_START_S):
                raise AssertionError(f"rlds: the data service {role} sent no ready record in "
                                     f"{RLDS_SERVICE_START_S} s (exit code {proc.exitcode})")
            return ours.recv()
        finally:
            ours.close()

    t0 = time.perf_counter()
    try:
        target = start("dispatcher")["target"]
        ready = [start("worker", dispatcher_address=target) for _ in range(workers)]
        yield target, list(zip(procs[1:], ready)), time.perf_counter() - t0
    finally:
        for proc in reversed(procs):
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=15)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=15)


def _rlds_fed_turn(fns, state, box, next_batch, feeder, dev, frames_per_batch,
                   workers_cpu_s=None):
    """RLDS_FED_WARMUP + RLDS_FED_TIMED bf16 train steps fed by
    `next_batch()`, each synchronised: the timed steps' walls, the
    feeder's wait on its iterator and upload a step, the CPU ms a step of
    the thread that launches the step, of this whole process and (with
    `workers_cpu_s()`, their sum of CPU seconds) of the service's workers,
    and on the card the profiler's busy time and idle share over 2 more."""
    import numpy as np

    def one_step():
        fns.train_step(state, next_batch(), box["step"])
        box["step"] += 1

    for _ in range(RLDS_FED_WARMUP):
        one_step()
    _sync(dev)
    w0, u0 = (feeder.wait_s, feeder.upload_s) if feeder else (0.0, 0.0)
    cpu0 = (time.thread_time(), time.process_time(), workers_cpu_s() if workers_cpu_s else 0.0)
    walls = []
    for _ in range(RLDS_FED_TIMED):
        t0 = time.perf_counter()
        one_step()
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    cpu1 = (time.thread_time(), time.process_time(), workers_cpu_s() if workers_cpu_s else 0.0)
    per = 1e3 / RLDS_FED_TIMED
    median = float(np.median(walls))
    record = {"step_wall_ms": walls, "median_ms": median,
              "wait_ms_per_step": (feeder.wait_s - w0) * per if feeder else None,
              "upload_ms_per_step": (feeder.upload_s - u0) * per if feeder else None,
              "launch_thread_cpu_ms_per_step": (cpu1[0] - cpu0[0]) * per,
              "process_cpu_ms_per_step": (cpu1[1] - cpu0[1]) * per,
              "workers_cpu_ms_per_step": (cpu1[2] - cpu0[2]) * per if workers_cpu_s else None,
              "frames_per_s": frames_per_batch * 1e3 / median}
    if dev.type == "cuda":
        prof = device_profile(one_step, iters=2)
        if prof is not None:
            record.update({"profiled_wall_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
                           "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"]})
    return record


def _rlds_lose_a_worker(fns, state, box, stream, feeder, dev, workers):
    """Service-fed steps before and after one worker process is killed:
    the stream drops it and carries on with the other, whose batches keep
    coming, and every step is taken."""
    import signal as signals

    before, after = RLDS_KILL_STEPS
    for _ in range(before):
        fns.train_step(state, next(feeder), box["step"])
        box["step"] += 1
    _sync(dev)
    (keep, keep_ready), (victim, victim_ready) = workers
    counts = {w["index"]: w["batches"] for w in stream.workers()}
    os.kill(victim.pid, signals.SIGKILL)
    victim.join(timeout=30)
    t0 = time.perf_counter()
    for _ in range(after):
        metrics = fns.train_step(state, next(feeder), box["step"])
        box["step"] += 1
    _sync(dev)
    seconds = time.perf_counter() - t0
    states = {w["index"]: w for w in stream.workers()}
    gained = states[keep_ready["index"]]["batches"] - counts[keep_ready["index"]]
    loss = float(metrics["loss"])
    # The victim's batches already in flight (AHEAD at the client, the
    # feeder's 2) may still arrive; the rest come from the survivor.
    if victim.is_alive() or states[victim_ready["index"]]["state"] != "dropped" or \
            states[keep_ready["index"]]["state"] != "live" or \
            gained < after - RLDS_IN_FLIGHT or not math.isfinite(loss):
        raise AssertionError(f"rlds: after killing worker {victim_ready['index']}: workers "
                             f"{states}, the survivor sent {gained} of {after} steps' batches, "
                             f"loss {loss}")
    return {"steps_before": before, "steps_after": after, "seconds_after": seconds,
            "killed_worker": victim_ready["index"], "survivor_batches_after": gained,
            "workers": list(states.values()), "loss": loss}


def phase_rlds(config_name: str = "language_table", device: str = "cuda"):
    """The TFDS fixture decoded and held to TF's pixels, converted by the
    CLI, trained and resumed through `data.loader=rlds_tf` in this process
    and through the data service's worker processes, the bf16 step fed in
    turns by `create_rlds_datasets` here, through the service and by
    synthetic batches, a worker killed under a service-fed run, and the
    service-trained checkpoint served (see the module docstring)."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.data import convert_rlds, rlds_pipeline, service
    from rt1_tpu_torch.data.pipeline import device_feeder
    from rt1_tpu_torch.eval.restore import build_serve_engine
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts
    from rt1_tpu_torch.serve.engine import pow2_buckets
    from rt1_tpu_torch.train.train import build_model, synthetic_batch
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    fixture = os.path.join(REPO, RLDS_FIXTURE)
    config = get_config(config_name)
    config.obs.model_health = False  # phase train's step
    b, t = config.per_host_batch_size, config.model.time_sequence_length
    h, w = config.data.height, config.data.width
    decode = _rlds_decode(fixture)
    root = tempfile.mkdtemp(prefix="rt1_chip_smoke_rlds_")
    try:
        store = os.path.join(root, "store")
        _, convert_s = _run_in_process(convert_rlds.main, [
            "--dataset_dir", os.path.join(fixture, "jpeg"), "--output_dir", store,
            "--num_train", str(RLDS_SPLITS["train"]), "--num_val", str(RLDS_SPLITS["val"]),
            "--num_test", "0"])
        written = {s: len(os.listdir(os.path.join(store, s))) for s in RLDS_SPLITS}
        if written != RLDS_SPLITS:
            raise AssertionError(f"rlds: convert wrote {written}, expected {RLDS_SPLITS}")
        episodes = sum(RLDS_SPLITS.values())
        cli = _rlds_cli(config_name, device, store, os.path.join(root, "train"),
                        config.model.num_layers)

        # The loader alone, straight over the TFDS directory.
        cfg = rlds_pipeline.RldsPipelineConfig(
            window=t, crop_factor=config.data.crop_factor, height=h, width=w, batch_size=b,
            shuffle_buffer=RLDS_SHUFFLE_BUFFER, seed=config.seed)
        tfds_dir = os.path.join(fixture, "jpeg")
        (stream,) = rlds_pipeline.create_rlds_datasets(tfds_dir, cfg, splits=("train",))
        try:
            alone = _time_rlds_loader(stream, b * t)
        finally:
            stream.close()

        with _rlds_service(RLDS_SERVICE_WORKERS) as (target, workers, service_start_s):
            # The train CLI and its resume through the workers.
            workdir = os.path.join(root, "train_service")
            cli_service = _rlds_cli(config_name, device, store, workdir,
                                    config.model.num_layers, service=target)

            # The bf16 step fed in turns: create_rlds_datasets in this
            # process, the same through the service, synthetic batches.
            policy = build_model(config, dev)
            optimizer = optimizer_from_config(config)
            state = create_train_state(policy, optimizer)
            fns = train_step_fns_from_config(config, optimizer)
            box = {"step": 0}
            service_cfg = dataclasses.replace(cfg, data_service_address=target,
                                              data_service_job_name="chip_smoke_rlds")
            fed = {}

            def workers_cpu_s():
                return sum(service.worker_stats(ready["target"])["cpu_s"] for _, ready in workers)

            for turn, feed in enumerate(RLDS_AB_TURNS):
                if feed == "synthetic":
                    fed[f"{turn}_{feed}"] = _rlds_fed_turn(
                        fns, state, box, lambda: synthetic_batch(config, config.seed, box["step"],
                                                                 dev), None, dev, b * t,
                        workers_cpu_s)
                    continue
                (stream,) = rlds_pipeline.create_rlds_datasets(
                    tfds_dir, service_cfg if feed == "service" else cfg, splits=("train",))
                feeder = device_feeder(stream, dev, depth=2)
                try:
                    record = _rlds_fed_turn(fns, state, box, lambda: next(feeder), feeder, dev,
                                            b * t, workers_cpu_s)
                    if feed == "service":
                        stats = stream.stats()
                        record["service"] = {
                            "recv_ms_per_batch": stats["recv_ms_per_batch"],
                            "reply_wait_ms_per_batch": stats["reply_wait_ms_per_batch"],
                            "wire_bytes_per_batch": stats["bytes"] / stats["received"],
                            "batches_by_worker": [x["batches"] for x in stream.workers()]}
                        if min(record["service"]["batches_by_worker"]) < 1:
                            raise AssertionError(f"rlds: a worker sent nothing: {record}")
                finally:
                    feeder.close()
                fed[f"{turn}_{feed}"] = record
            served = [service.worker_stats(ready["target"]) for _, ready in workers]
            if any(x["cuda_initialized"] for x in served):
                raise AssertionError(f"rlds: a data service worker initialised CUDA: {served}")

            # A worker killed under a service-fed run.
            (stream,) = rlds_pipeline.create_rlds_datasets(tfds_dir, service_cfg,
                                                           splits=("train",))
            feeder = device_feeder(stream, dev, depth=2)
            try:
                lost = _rlds_lose_a_worker(fns, state, box, stream, feeder, dev, workers)
            finally:
                feeder.close()
            del policy, state, fns, optimizer
            if on_card:
                torch.cuda.empty_cache()
        image_bytes = b * t * h * w * 3

        # One bucket-8 bf16 engine step from the service-trained CLI's
        # checkpoint, on the fixture's frames (the eval crop, resized to
        # the model's size).
        engine, restored = build_serve_engine(config, workdir=workdir, device=dev,
                                              attention_impl="fused", max_sessions=b,
                                              buckets=pow2_buckets(b))
        batch = next(iter(rlds_pipeline.make_episode_dataset_from_paths(
            [os.path.join(store, "val", "episode_0.npz")])))
        boxes = rlds_pipeline.crop_boxes(b, *batch["rgb"].shape[1:3], cfg, False, None)
        frames = rlds_pipeline.crop_resize(batch["rgb"][np.arange(b) % len(batch["rgb"])],
                                           boxes, h, w).numpy()
        items = [(f"rlds-{i}", {"image": frames[i],
                                "natural_language_embedding": batch["instruction"][0]})
                 for i in range(b)]
        engine.warmup((h, w, 3))
        steps0 = engine.steps_total
        reset_launch_counts()
        results = engine.act_batch(items)
        _sync(dev)
        launches = dict(fused_attention.launches_by_variant)
        steps = engine.steps_total - steps0
        layers = engine.policy.num_layers
        del engine
        actions = np.asarray([r.get("action", [np.nan] * 2) for r in results], np.float64)
        expected = {"tensor_core": layers if on_card else 0, "tf32x3": 0, "simple": 0}
        if restored != 2 * RLDS_TRAIN_STEPS or steps != 1 or launches != expected or \
                actions.shape != (b, 2) or not np.isfinite(actions).all() or \
                (np.abs(actions) > 0.03 + 1e-7).any():
            raise AssertionError(f"rlds: engine from step {restored}: {steps} steps, "
                                 f"launches {launches} (expected {expected}), actions {actions}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record = {"phase": "rlds", "config": config_name, "batch": b, "window": t,
              "image": [h, w], "decode": decode,
              "convert": {"episodes": episodes, "seconds": convert_s,
                          "s_per_episode": convert_s / episodes},
              "cli": cli, "loader_alone": alone,
              "service": {"workers": RLDS_SERVICE_WORKERS, "start_s": service_start_s,
                          "image_bytes_per_batch": image_bytes, "cli": cli_service,
                          "workers_served": served, "lose_a_worker": lost},
              "fed_ab": fed,
              "engine": {"checkpoint": "service", "restored_step": restored,
                         "engine_steps": steps, "launches_by_variant": launches},
              "nvidia_smi": nvidia_smi() if on_card else None,
              "seconds": time.perf_counter() - t_phase}
    emit(record)
    return record


def _time_rlds_loader(stream, frames_per_batch):
    """frames/s of an RLDS stream alone: the first batch (its start-up and
    first episodes' decode), then RLDS_LOADER_BATCHES timed."""
    t0 = time.perf_counter()
    next(stream)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(RLDS_LOADER_BATCHES):
        next(stream)
    dt = time.perf_counter() - t0
    return {"first_batch_s": first_s, "ms_per_batch": dt * 1e3 / RLDS_LOADER_BATCHES,
            "frames_per_s": RLDS_LOADER_BATCHES * frames_per_batch / dt}


# The eval phase: the closed-loop Language-Table eval of the flagship.
EVAL_CLI_EPISODES = 1
EVAL_STEPS = 80                  # the protocol's episode budget
EVAL_PROFILE_STEPS = 5
EVAL_REPLAY_STEPS = 12           # the window (6) rolls after step 6
EVAL_BASELINE_EPISODES = 2
EVAL_BUDGET_MS = 100.0           # the 10 Hz control period


def _quantiles(samples):
    import numpy as np

    a = np.asarray(samples, np.float64)
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
            "max": float(a.max()), "n": int(a.size)}


def _env_kwargs(config, backend="kinematic"):
    """The eval CLI's env settings for `config` (`eval/main.py`)."""
    return dict(target_height=config.data.height, target_width=config.data.width,
                random_crop_factor=config.data.crop_factor,
                sequence_length=config.model.time_sequence_length, backend=backend)


def _eval_env(config, seed):
    """The CLI's default env chain: BLOCK_8, block2block."""
    from rt1_tpu_torch.eval.evaluate import build_eval_env

    return build_eval_env(seed=seed, **_env_kwargs(config))


def _record_logits(policy):
    """Keep each `infer_step`'s action logits (row 0) in a list, on the host."""
    logits = []
    infer_step = policy.infer_step

    def recording(obs, state, **kwargs):
        out, new_state = infer_step(obs, state, **kwargs)
        logits.append(out["action_logits"][0].double().cpu())
        return out, new_state

    policy.infer_step = recording
    return logits


def _timed_eval_episode(config, workdir, device):
    """One bf16 episode of EVAL_STEPS control steps of the restored
    flagship: per-phase host times, the RRT validation, launches per step,
    then torch.profiler over EVAL_PROFILE_STEPS more steps."""
    import torch

    from rt1_tpu_torch.envs import language_table as lt_module
    from rt1_tpu_torch.eval import wrappers as wrappers_module
    from rt1_tpu_torch.eval.evaluate import validated_reset
    from rt1_tpu_torch.eval.policy import RT1EvalPolicy
    from rt1_tpu_torch.eval.restore import load_policy_and_step
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    model, step = load_policy_and_step(config, device=device, attention_impl="fused",
                                       workdir=workdir)
    policy = RT1EvalPolicy(model)
    h, w = config.data.height, config.data.width
    policy.engine.warmup((h, w, 3))
    env = _eval_env(config, seed=0)
    spans = {"render_board": [], "crop_resize": []}
    originals = (lt_module.render_board, wrappers_module.crop_resize_batch)

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spans[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    lt_module.render_board = timed(originals[0], "render_board")
    wrappers_module.crop_resize_batch = timed(originals[1], "crop_resize")
    times = {k: [] for k in ("policy_action", "env_step", "render_board", "crop_resize",
                             "control_step")}
    rrt_s, box = [], {}
    try:
        def reset():
            policy.reset()
            t0 = time.perf_counter()
            box["obs"] = validated_reset(env)
            rrt_s.append(time.perf_counter() - t0)

        def control_step():
            for v in spans.values():
                v.clear()
            t0 = time.perf_counter()
            action = policy.action(box["obs"])
            t1 = time.perf_counter()
            box["obs"], _, done, _ = env.step(action)
            t2 = time.perf_counter()
            times["policy_action"].append((t1 - t0) * 1e3)
            times["env_step"].append((t2 - t1) * 1e3)
            times["control_step"].append((t2 - t0) * 1e3)
            times["render_board"].append(sum(spans["render_board"]))
            times["crop_resize"].append(sum(spans["crop_resize"]))
            if done:
                reset()

        reset()
        steps_before = policy.engine.steps_total
        reset_launch_counts()  # the timed episode's launches start here
        for _ in range(EVAL_STEPS):
            control_step()
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.synchronize()
        launches = dict(fused_attention.launches_by_variant)
        engine_steps = policy.engine.steps_total - steps_before
        prof = device_profile(control_step, iters=EVAL_PROFILE_STEPS) if on_card else None
    finally:
        lt_module.render_board, wrappers_module.crop_resize_batch = originals
    layers = model.num_layers
    # bf16 on the card: the tensor-core kernel once per decoder layer a step.
    expected = {"tensor_core": layers * engine_steps if on_card else 0, "tf32x3": 0, "simple": 0}
    if engine_steps != EVAL_STEPS or launches != expected:
        raise AssertionError(f"eval: {engine_steps} engine steps, launches {launches}, "
                             f"expected {expected}")
    timed_ms = {k: _quantiles(v[:EVAL_STEPS]) for k, v in times.items()}
    kinematics = [e - r - c for e, r, c in zip(times["env_step"], times["render_board"],
                                               times["crop_resize"])][:EVAL_STEPS]
    record = {
        "dtype": config.model.dtype, "checkpoint_step": step, "steps": EVAL_STEPS,
        "episodes_started": len(rrt_s), "ms": timed_ms,
        "env_step_less_render_and_resize_ms": _quantiles(kinematics),
        "rrt_validation_s": rrt_s, "launches_by_variant": launches,
        "attention_launches_per_step": launches["tensor_core"] / EVAL_STEPS,
        "budget_ms": EVAL_BUDGET_MS,
        "meets_10hz_budget": timed_ms["control_step"]["p99"] < EVAL_BUDGET_MS,
    }
    if prof is not None:
        attn = {name[:80]: ms for name, ms in prof["kernels"].items() if "attention" in name}
        record.update({
            "profiled_control_step_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
            "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"],
            "device_launches_per_step": prof["launches"], "attention_kernels_ms": attn,
        })
    del policy, model
    torch.cuda.empty_cache()
    return record


def _eval_replay(config, workdir, device):
    """EVAL_REPLAY_STEPS float32 control steps on the card (tf32x3, TF32 off),
    replayed through a fresh CPU policy of the same checkpoint (plain path):
    logits within PARITY_REL_TOL x max|logit|, actions equal where every
    action token's top-2 gap exceeds that bound."""
    import copy

    import numpy as np
    import torch

    from rt1_tpu_torch.eval.evaluate import validated_reset
    from rt1_tpu_torch.eval.policy import RT1EvalPolicy
    from rt1_tpu_torch.eval.restore import load_policy_and_step
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = copy.deepcopy(config)
    config.model.dtype = "float32"
    h, w = config.data.height, config.data.width
    runs = {}
    for dev in (device, "cpu"):
        model, _ = load_policy_and_step(config, device=dev, attention_impl="fused",
                                        workdir=workdir)
        policy = RT1EvalPolicy(model)
        policy.engine.warmup((h, w, 3))
        logits = _record_logits(model)
        runs[dev] = {"logits": logits, "actions": [], "seq_idx": []}
        t0 = time.perf_counter()
        if dev == device:
            env = _eval_env(config, seed=1)
            obs = validated_reset(env)
            observations = []
            reset_launch_counts()  # the replayed steps' launches start here
            for _ in range(EVAL_REPLAY_STEPS):
                observations.append(obs)
                action = policy.action(obs)
                runs[dev]["actions"].append(action)
                runs[dev]["seq_idx"].append(int(policy.network_state["seq_idx"]))
                obs, _, done, _ = env.step(action)
                if done:
                    raise AssertionError("eval replay: the episode ended before the window rolled")
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            launches = dict(fused_attention.launches_by_variant)
        else:
            for obs in observations:
                runs[dev]["actions"].append(policy.action(obs))
                runs[dev]["seq_idx"].append(int(policy.network_state["seq_idx"]))
        runs[dev]["s"] = time.perf_counter() - t0
        del policy, model
    gpu, cpu = runs[device], runs["cpu"]
    layers = config.model.num_layers
    on_card = torch.device(device).type == "cuda"
    expected = {"tensor_core": 0, "tf32x3": layers * EVAL_REPLAY_STEPS if on_card else 0,
                "simple": 0}
    if launches != expected:
        raise AssertionError(f"eval replay: launches {launches}, expected {expected}")
    if len(gpu["logits"]) != EVAL_REPLAY_STEPS or len(cpu["logits"]) != EVAL_REPLAY_STEPS:
        raise AssertionError(f"eval replay: {len(gpu['logits'])} / {len(cpu['logits'])} steps "
                             "recorded")
    rows, failures = [], []
    for i in range(EVAL_REPLAY_STEPS):
        g, c = gpu["logits"][i], cpu["logits"][i]
        bound = PARITY_REL_TOL * max(1.0, float(c.abs().max()))
        diff = float((g - c).abs().max())
        top2 = c.topk(2, dim=-1).values
        min_gap = float((top2[..., 0] - top2[..., 1]).min())
        action_diff = float(np.abs(gpu["actions"][i] - cpu["actions"][i]).max())
        held = min_gap > bound
        rows.append({"step": i, "max_abs_logit_diff": diff, "bound": bound,
                     "min_top2_gap": min_gap, "action_diff": action_diff,
                     "actions_held": held})
        if not torch.isfinite(g).all() or diff > bound or (held and action_diff > 1e-6):
            failures.append(rows[-1])
    if gpu["seq_idx"] != cpu["seq_idx"] or max(gpu["seq_idx"]) != config.model.time_sequence_length:
        failures.append({"seq_idx": [gpu["seq_idx"], cpu["seq_idx"]]})
    record = {"dtype": "float32", "tf32": False, "steps": EVAL_REPLAY_STEPS,
              "launches_by_variant": launches, "seq_idx": gpu["seq_idx"],
              "max_abs_logit_diff": max(r["max_abs_logit_diff"] for r in rows),
              "actions_held_steps": sum(r["actions_held"] for r in rows),
              "step_s": {"device": gpu["s"], "cpu": cpu["s"]}, "rows": rows}
    if failures:
        emit({"phase": "eval_replay", **record})
        raise AssertionError(f"eval replay: card vs CPU beyond the bound: {failures}")
    torch.cuda.empty_cache()
    return record


def phase_eval(config_name: str = "language_table", device: str = "cuda", workdir=None):
    """The closed-loop eval of the flagship: the eval CLI on a checkpoint of
    the train CLI (phase `train`'s in `workdir` when given, else one trained
    here to step 2), one timed and profiled bf16 episode in process, the
    f32 card-vs-CPU replay, and the oracle and random baselines and a
    `kinematic_arm` episode."""
    import io

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval import evaluate
    from rt1_tpu_torch.eval.embedding import build_table_cli
    from rt1_tpu_torch.eval.evaluate import OracleEvalPolicy, evaluate_policy, write_video
    from rt1_tpu_torch.eval.main import main as eval_main
    from rt1_tpu_torch.eval.video import count_gif_frames
    from rt1_tpu_torch.trainer.checkpoints import latest_step

    config = get_config(config_name)
    with contextlib.ExitStack() as stack:
        train_s = None
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory())
            t0 = time.perf_counter()
            trained, _ = _run_cli(["--config", config_name, "--workdir", workdir, "--device",
                                   device, "--set", "num_steps=2",
                                   "--set", "checkpoint_every_steps=2"], TRAIN_CLI_TIMEOUT_S)
            train_s = time.perf_counter() - t0
            if trained[-1].get("checkpoint_step") != 2:
                raise AssertionError(f"eval: the train CLI ended with {trained[-1]}")
        trainer_step = latest_step(os.path.join(workdir, "checkpoints"))
        table = os.path.join(stack.enter_context(tempfile.TemporaryDirectory()), "table.npz")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            build_table_cli(["--output", table, "--embedder", "hash"])
        table_s = time.perf_counter() - t0
        video_s = []

        def timed_video(path_stem, frames, fps=10):
            t = time.perf_counter()
            path = write_video(path_stem, frames, fps)
            video_s.append(time.perf_counter() - t)
            return path

        evaluate.write_video = timed_video
        try:
            lines, cli_s = _run_in_process(eval_main, [
                "--config", config_name, "--workdir", workdir, "--device", device,
                "--episodes", str(EVAL_CLI_EPISODES), "--max_steps", str(EVAL_STEPS),
                "--rewards", "block2block", "--videos", "--embedder", table])
        finally:
            evaluate.write_video = write_video
        result = lines[-1]
        keys = {"successes", "episodes_per_reward", "mean_episode_length", "checkpoint_step"}
        if set(result) != keys or result["checkpoint_step"] != trainer_step or \
                result["episodes_per_reward"] != EVAL_CLI_EPISODES or \
                set(result["successes"]) != {"block2block"} or \
                not 1 <= result["mean_episode_length"]["block2block"] <= EVAL_STEPS:
            raise AssertionError(f"eval CLI: {result}, trainer step {trainer_step}")
        # One GIF an episode, steps + 1 frames, under the JAX names.
        video_dir = os.path.join(workdir, f"videos_ckpt{trainer_step}")
        videos = sorted(os.listdir(video_dir))
        frames = [count_gif_frames(os.path.join(video_dir, v)) for v in videos]
        if len(videos) != EVAL_CLI_EPISODES or \
                not all(v.startswith("block2block_") and v.endswith(".gif") for v in videos) or \
                sum(frames) != EVAL_CLI_EPISODES * (
                    result["mean_episode_length"]["block2block"] + 1):
            raise AssertionError(f"eval CLI videos: {videos} of {frames} frames, {result}")
        video = {"files": videos, "frames": frames, "write_s": video_s, "table_s": table_s,
                 "bytes": [os.path.getsize(os.path.join(video_dir, v)) for v in videos]}
        timed = _timed_eval_episode(config, workdir, device)
        replay = _eval_replay(config, workdir, device)
    baselines = {}
    for baseline in ("oracle", "random"):
        lines, seconds = _run_in_process(eval_main, [
            "--config", config_name, "--device", device, "--baseline", baseline,
            "--episodes", str(EVAL_BASELINE_EPISODES)])
        out = lines[-1]
        if out.get("checkpoint_step") != -1 or out.get("episodes_per_reward") != \
                EVAL_BASELINE_EPISODES or set(out.get("successes", {})) != {"block2block"}:
            raise AssertionError(f"eval --baseline {baseline}: {out}")
        baselines[baseline] = {"result": out, "s": seconds}
    t0 = time.perf_counter()
    arm = evaluate_policy(OracleEvalPolicy(seed=0), num_evals_per_reward=1,
                          env_kwargs=_env_kwargs(config, backend="kinematic_arm"))
    baselines["oracle_kinematic_arm"] = {"result": arm, "s": time.perf_counter() - t0}
    record = {"phase": "eval", "config": config_name, "train_cli_s": train_s,
              "cli": {"result": result, "s": cli_s, "videos": video}, "timed_episode": timed,
              "replay": replay, "baselines": baselines}
    emit(record)
    return record


# The learning proof at the flagship's width, and its CPU rehearsal at
# `tiny`'s: sizes of each stage. DART demos take the longer budget of the
# JAX package's DART test (at 80 steps few noisy demos finish); seed 4
# finishes its two in a few attempts.
PROOF_SIZES = {
    "language_table": dict(
        cli=[], coefficients=(1.2, 1.4), episodes=4, workers=4, dart_episodes=2,
        pretrain_frames=256, pretrain_steps=10, pretrain_batch=32, train_steps=10,
        dagger_episodes=1, dagger_extra_steps=5, eval_episodes=1, timed_steps=10),
    "tiny": dict(
        cli=["--height", "32", "--width", "56", "--batch", "2", "--seq_len", "3",
             "--dtype", "float32", "--image_tokenizer", "efficientnet_small",
             "--set", "data.loader=numpy"],
        coefficients=(0.35, 0.35), episodes=3, workers=2, dart_episodes=1,
        pretrain_frames=16, pretrain_steps=2, pretrain_batch=4, train_steps=2,
        dagger_episodes=1, dagger_extra_steps=2, eval_episodes=1, timed_steps=3),
}
PROOF_DART_STD = 0.005
PROOF_DART_SEED = 4
PROOF_DART_MAX_STEPS = 160
PROOF_PROFILE_STEPS = 3
PROOF_CLI_TIMEOUT_S = 600
PROOF_DIAG_STEPS = 20            # a closed-loop diagnostics episode's budget (80 in JAX)
DIAG_KEYS = {"episodes", "successes", "oracle_cosine_mean", "action_std_mean",
             "block_target_progress_mean", "per_episode", "checkpoint_step"}
PROBE_ARM, PROBE_FRAMES, PROBE_STEPS, PROBE_BATCH = "small_64x96", 64, 3, 16


def _proof_cli(args):
    return _run_cli(args, PROOF_CLI_TIMEOUT_S, module="rt1_tpu_torch.train.learn_proof")


def _stage_line(lines, stage, key):
    """The last JSON line of `stage` that carries `key`."""
    found = [r for r in lines if r.get("stage") == stage and key in r]
    if not found:
        raise AssertionError(f"proof: no {stage} line with {key!r} in {lines[-3:]}")
    return found[-1]


def _check_launches(what, record, layers, on_card):
    """The kernel's launches in a stage: the tensor-core variant once per
    decoder layer an engine step (warm-up included) on the card, no other;
    none on the CPU (the plain path)."""
    steps = record["engine_steps"]
    expected = {"tensor_core": layers * steps if on_card else 0, "tf32x3": 0, "simple": 0}
    if steps < 1 or record["launches"] != expected:
        raise AssertionError(f"proof {what}: {steps} engine steps, launches "
                             f"{record['launches']}, expected {expected}")


def _timed_control_steps(config, policy, device, steps, dagger):
    """`steps` control steps of the restored policy (bf16 on the card, fused
    attention) on a DAgger env (oracle label + policy action + env.step) or
    an eval env (policy action + env.step): per-step host ms (an episode's
    validated reset falls between steps, untimed), launches per step from
    the counters, then torch.profiler over PROOF_PROFILE_STEPS more steps
    with the counters read around them."""
    import numpy as np
    import torch

    from rt1_tpu_torch.data.dagger import DAGGER_HISTORY_KEYS
    from rt1_tpu_torch.envs import blocks
    from rt1_tpu_torch.envs.oracles import RRTPushOracle
    from rt1_tpu_torch.eval.evaluate import build_eval_env, validated_reset
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    layers = policy.engine.policy.num_layers
    env = build_eval_env(
        reward_name="block2block", block_mode=blocks.BlockMode.BLOCK_4,
        seed=30_000 if dagger else 10_000, embedder="ngram",
        target_height=config.data.height, target_width=config.data.width,
        sequence_length=config.model.time_sequence_length,
        history_keys=DAGGER_HISTORY_KEYS if dagger else None)
    oracle = RRTPushOracle(env, use_ee_planner=True)
    box = {}

    def reset():
        """A validated init, as `collect_dagger_episode` (the collector's
        oracle plans it) and `run_episode` (`validated_reset`) take one;
        between episodes, so outside the timed step."""
        policy.reset()
        if dagger:
            while True:
                box["obs"] = env.reset()
                oracle.reset()
                if oracle.get_plan(env.compute_state()):
                    break
        else:
            box["obs"] = validated_reset(env)
        box["done"] = False

    def step():
        if dagger:
            np.asarray(oracle.action(env.compute_state()), np.float32)
        box["obs"], _, box["done"], _ = env.step(policy.action(box["obs"]))

    def control_step():
        if box["done"]:
            reset()
        step()

    reset()
    on_card = torch.device(device).type == "cuda"
    times = []
    reset_launch_counts()
    steps_before = policy.engine.steps_total
    for _ in range(steps):
        if box["done"]:
            reset()
        t0 = time.perf_counter()
        step()
        if on_card:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    record = {"launches": dict(fused_attention.launches_by_variant),
              "engine_steps": policy.engine.steps_total - steps_before}
    _check_launches("timed " + ("dagger" if dagger else "eval"), record, layers, on_card)
    out = {"ms": _quantiles(times), **record}
    if on_card:
        reset_launch_counts()
        steps_before = policy.engine.steps_total
        prof = device_profile(control_step, iters=PROOF_PROFILE_STEPS)
        profiled = {"launches": dict(fused_attention.launches_by_variant),
                    "engine_steps": policy.engine.steps_total - steps_before}
        _check_launches("profiled " + ("dagger" if dagger else "eval"), profiled, layers,
                        on_card)
        per_step = {v: n / profiled["engine_steps"] for v, n in profiled["launches"].items()}
        if per_step != {"tensor_core": layers, "tf32x3": 0, "simple": 0}:
            raise AssertionError(f"proof: profiled control step launches {per_step}")
        out["profiled"] = {"attention_launches_per_step": per_step}
        if prof is not None:
            out["profiled"].update({
                "control_step_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
                "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"],
                "device_launches_per_step": prof["launches"],
                "attention_kernels_ms": {n[:80]: ms for n, ms in prof["kernels"].items()
                                         if "attention" in n}})
    return out


def phase_proof(config_name: str = "language_table", device: str = "cuda"):
    """The learning proof through `python -m rt1_tpu_torch.train.learn_proof`
    at the config's width (its collection stage a CLI, its train, DAgger and
    eval stages its `main` in process): collect (4 workers) plus DART demos in process,
    vision pretraining and its encoder, train from the graft, one DAgger
    round, the three-arm eval, the proof's arm (`train/proof_arm.py`) run
    again over the finished workdir; then timed and profiled DAgger and
    eval control steps."""
    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.data.collect import collect_dataset, corpus_accounting
    from rt1_tpu_torch.data.episodes import read_manifest
    from rt1_tpu_torch.envs import blocks
    from rt1_tpu_torch.eval.policy import RT1EvalPolicy
    from rt1_tpu_torch.eval.proof import build_proof_summary
    from rt1_tpu_torch.eval.restore import load_policy_and_step
    from rt1_tpu_torch.train import learn_proof
    from rt1_tpu_torch.train.learn_proof import LearnProof, parse_args
    from rt1_tpu_torch.eval import diagnostics
    from rt1_tpu_torch.eval.evaluate import build_eval_env
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts
    from rt1_tpu_torch.train import perception_probe
    from rt1_tpu_torch.train.pretrain_vision import (ENCODER_FORMAT,
                                                      generate_state_regression_dataset,
                                                      load_encoder, pretrain_encoder,
                                                      save_encoder)

    sizes = PROOF_SIZES[config_name]
    on_card = torch.device(device).type == "cuda"
    stage_s = {}
    with tempfile.TemporaryDirectory() as root:
        workdir = os.path.join(root, "learn_proof")
        data_dir = os.path.join(workdir, "data")
        enc_path = os.path.join(root, "encoder.pt")
        common = ["--workdir", workdir, "--config", config_name, "--device", device,
                  *sizes["cli"]]
        # The config the CLI's stages build from these flags.
        config = LearnProof(parse_args(common)).train_config(sizes["train_steps"])
        layers = config.model.num_layers
        hw = (config.data.height, config.data.width)
        # 1. Collect: the CLI over worker processes, then DART demos in
        # process (one worker) into a directory of their own.
        lines, stage_s["collect"] = _proof_cli(
            common + ["--stage", "collect", "--episodes", str(sizes["episodes"]),
                      "--workers", str(sizes["workers"])])
        collected = _stage_line(lines, "collect", "counts")
        manifest = read_manifest(data_dir)
        expected = {"episodes": sizes["episodes"], "embedder": "ngram", "block_mode": "BLOCK_4",
                    "reward": "block2block", "workers": sizes["workers"], "exec_noise_std": 0.0}
        if any(manifest.get(k) != v for k, v in expected.items()):
            raise AssertionError(f"proof collect: manifest {manifest}, expected {expected}")
        accounting = corpus_accounting(data_dir)
        if accounting[0] != sizes["episodes"] or sum(accounting[1].values()) != \
                sizes["episodes"] or accounting[1] != {k: v for k, v in
                                                       collected["counts"].items() if v}:
            raise AssertionError(f"proof collect: accounting {accounting}, CLI {collected}")
        dart_dir = os.path.join(root, "dart")
        dart_stats = {}
        t0 = time.perf_counter()
        dart_counts = collect_dataset(
            dart_dir, sizes["dart_episodes"], block_mode=blocks.BlockMode.BLOCK_4,
            seed=PROOF_DART_SEED, max_steps=PROOF_DART_MAX_STEPS, embedder="ngram",
            progress_every=0, exec_noise_std=PROOF_DART_STD, stats=dart_stats)
        stage_s["collect_dart"] = time.perf_counter() - t0
        dart_manifest = read_manifest(dart_dir)
        if dart_manifest.get("exec_noise_std") != PROOF_DART_STD or \
                corpus_accounting(dart_dir) != (sizes["dart_episodes"], dart_counts):
            raise AssertionError(f"proof DART: {dart_manifest}, {dart_counts}")
        # 2. Pretrain the encoder at the policy's coefficients.
        t0 = time.perf_counter()
        images, targets, names = generate_state_regression_dataset(
            sizes["pretrain_frames"], image_hw=hw, seed=0)
        stage_s["pretrain_frames"] = time.perf_counter() - t0
        step_ms = []
        t0 = time.perf_counter()
        model, metrics = pretrain_encoder(
            images, targets, num_steps=sizes["pretrain_steps"],
            batch_size=sizes["pretrain_batch"], seed=0,
            width_coefficient=sizes["coefficients"][0],
            depth_coefficient=sizes["coefficients"][1],
            token_embedding_size=config.model.token_embedding_size,
            eval_every=max(1, sizes["pretrain_steps"] // 2), log=lambda *_: None,
            device=device, step_times=step_ms)
        save_encoder(model, metrics, enc_path)
        stage_s["pretrain"] = time.perf_counter() - t0
        del model
        if not all(map(math.isfinite, [metrics["val_rmse"]] +
                       [h["train_loss"] for h in metrics["history"]])):
            raise AssertionError(f"proof pretrain: {metrics}")
        # 3. Train from the graft; 4. one DAgger round; 5. the eval.
        run = common + ["--num_steps", str(sizes["train_steps"]),
                        "--pretrained_encoder", enc_path]
        log_every = max(1, sizes["train_steps"] // 4)
        # The train, DAgger and eval stages' `main` in this process (a
        # process start each fewer, for the 1200 s limit); collection
        # keeps its CLI and its worker processes.
        lines, stage_s["train"] = _run_in_process(learn_proof.main, run + [
            "--stage", "train", "--set", f"log_every_steps={log_every}"])
        if {"status": "grafted_pretrained_encoder", "path": enc_path} not in lines:
            raise AssertionError("proof train: no graft line in the trainer's log")
        trained = _stage_line(lines, "train", "step")
        rates = [r["steps_per_sec"] for r in lines if "steps_per_sec" in r]
        if trained["step"] != sizes["train_steps"] or not rates:
            raise AssertionError(f"proof train: {trained}, rates {rates}")
        lines, stage_s["dagger"] = _run_in_process(
            learn_proof.main, run + ["--stage", "dagger", "--dagger_rounds", "1",
                   "--dagger_episodes", str(sizes["dagger_episodes"]),
                   "--dagger_extra_steps", str(sizes["dagger_extra_steps"])])
        if any(r.get("status") == "grafted_pretrained_encoder" for r in lines):
            raise AssertionError("proof dagger: the resumed run grafted")
        dagger = _stage_line(lines, "dagger", "rounds")
        target = sizes["train_steps"] + sizes["dagger_extra_steps"]
        corpus = sizes["episodes"] + sizes["dagger_episodes"]
        (round0,) = dagger["rounds"]
        if dagger["step"] != target or round0["rollout_episodes"] != sizes["dagger_episodes"] \
                or round0["corpus_train_episodes_after"] != corpus:
            raise AssertionError(f"proof dagger: {dagger}")
        _check_launches("dagger", dagger, layers, on_card)
        manifest = read_manifest(data_dir)
        if (manifest["episodes"], manifest["dagger_episodes"]) != \
                (corpus, sizes["dagger_episodes"]):
            raise AssertionError(f"proof dagger: manifest {manifest}")
        lines, stage_s["eval"] = _run_in_process(learn_proof.main, run + [
            "--stage", "eval", "--eval_episodes", str(sizes["eval_episodes"])])
        evaluated = _stage_line(lines, "eval", "summary")
        _check_launches("eval", evaluated, layers, on_card)
        with open(os.path.join(workdir, "learn_proof.json")) as f:
            summary = json.load(f)
        arms = {"successes": {"block2block": 0}, "mean_episode_length": {"block2block": 0.0}}
        keys = set(build_proof_summary(
            reward="block2block", block_mode="", manifest=None, flag_embedder="",
            flag_exec_noise_std=0.0,
            episodes_collected=0, split_counts={}, num_steps_requested=0,
            evaluated_checkpoint_step=0, seq_len=0, focal_gamma=0.0, aux_mse_weight=0.0,
            image_tokenizer="", resolution=[], eval_episodes=0, eval_seed=0, trained=arms,
            random_results=arms, oracle_results=arms, curves={"loss": [], "eval_loss": []}))
        if set(summary) != keys | {"loss_curves", "corpus_entropy"} or \
                summary["evaluated_checkpoint_step"] != target or \
                summary["episodes_collected"] != corpus or \
                summary["eval_episodes"] != sizes["eval_episodes"]:
            raise AssertionError(f"proof eval: learn_proof.json {sorted(summary)}")
        # 5b. The proof's arm (`python -m rt1_tpu_torch.train.proof_arm`) in
        # process over this finished workdir with the phase's flags: every
        # stage skipped, no train step, checkpoint or launch; its decision.
        arm_record = _proof_arm_resumes(workdir, run + [
            "--eval_episodes", str(sizes["eval_episodes"]), "--dagger_rounds", "1",
            "--dagger_episodes", str(sizes["dagger_episodes"]),
            "--dagger_extra_steps", str(sizes["dagger_extra_steps"])])
        stage_s["arm"] = arm_record["seconds"]
        # 6. Timed and profiled control steps of the final checkpoint.
        t0 = time.perf_counter()
        model, _ = load_policy_and_step(config, device=device, attention_impl="fused",
                                        workdir=os.path.join(workdir, "train"))
        policy = RT1EvalPolicy(model)
        policy.engine.warmup((config.data.height, config.data.width, 3))
        dagger_steps = _timed_control_steps(config, policy, device, sizes["timed_steps"],
                                            dagger=True)
        eval_steps = _timed_control_steps(config, policy, device, sizes["timed_steps"],
                                          dagger=False)
        stage_s["timing"] = time.perf_counter() - t0
        # 7. Closed-loop diagnostics: the CLI on the workdir, then one
        # episode of the restored policy with its launches counted.
        t0 = time.perf_counter()
        diag_out = os.path.join(root, "diagnostics.json")
        lines, _ = _run_in_process(diagnostics.main, run + [
            "--diag_episodes", "1", "--max_steps", str(PROOF_DIAG_STEPS), "--out", diag_out])
        with open(diag_out) as f:
            report = json.load(f)
        if set(report) != DIAG_KEYS or lines[-1] != {k: v for k, v in report.items()
                                                     if k != "per_episode"}:
            raise AssertionError(f"proof diagnostics: {sorted(report)}, {lines[-1]}")
        env = build_eval_env(reward_name="block2block", block_mode=blocks.BlockMode.BLOCK_4,
                             seed=20_000, embedder="ngram", target_height=hw[0],
                             target_width=hw[1],
                             sequence_length=config.model.time_sequence_length)
        reset_launch_counts()
        steps_before = policy.engine.steps_total
        t1 = time.perf_counter()
        direct = diagnostics.closed_loop_diagnostics(policy, env, 1, PROOF_DIAG_STEPS)
        diag_step_ms = (time.perf_counter() - t1) * 1e3 / direct["per_episode"][0]["steps"]
        diag_launches = {"launches": dict(fused_attention.launches_by_variant),
                         "engine_steps": policy.engine.steps_total - steps_before}
        _check_launches("diagnostics", diag_launches, layers, on_card)
        if diag_launches["engine_steps"] != direct["per_episode"][0]["steps"]:
            raise AssertionError(f"proof diagnostics: {diag_launches} for {direct}")
        stage_s["diagnostics"] = time.perf_counter() - t0
        del policy, model
        if on_card:
            torch.cuda.empty_cache()
        # 8. The perception probe on one arm.
        t0 = time.perf_counter()
        probe_dir = os.path.join(root, "probe")
        lines, _ = _run_in_process(perception_probe.main, [
            "--out_dir", probe_dir, "--frames", str(PROBE_FRAMES), "--steps",
            str(PROBE_STEPS), "--batch", str(PROBE_BATCH), "--arms", PROBE_ARM,
            "--device", device])
        probe = lines[-1][PROBE_ARM]
        if probe["device"] != str(torch.device(device)) or \
                not math.isfinite(probe["val_rmse_mm"]) or \
                load_encoder(probe["encoder_path"])["format"] != ENCODER_FORMAT:
            raise AssertionError(f"proof perception probe: {probe}")
        stage_s["perception_probe"] = time.perf_counter() - t0
    arms = {a: {"successes": summary[f"{a}_successes"],
                "mean_episode_length": summary[f"{a}_mean_episode_length"]}
            for a in ("trained", "random", "oracle")}
    record = {
        "phase": "proof", "config": config_name, "device": device,
        "nvidia_smi": nvidia_smi() if on_card else None,
        "collect": {"workers": sizes["workers"], "episodes": sizes["episodes"],
                    "attempts": collected["attempts"], "seconds": collected["seconds"],
                    "episodes_per_s": sizes["episodes"] / collected["seconds"],
                    "successes_per_attempt": sizes["episodes"] / collected["attempts"]},
        "collect_dart": {"workers": 1, "episodes": sizes["dart_episodes"],
                         "attempts": dart_stats["attempts"], "seconds": stage_s["collect_dart"],
                         "episodes_per_s": sizes["dart_episodes"] / stage_s["collect_dart"],
                         "successes_per_attempt":
                             sizes["dart_episodes"] / dart_stats["attempts"],
                         "exec_noise_std": PROOF_DART_STD, "max_steps": PROOF_DART_MAX_STEPS},
        "pretrain": {"frames": sizes["pretrain_frames"], "steps": sizes["pretrain_steps"],
                     "batch": sizes["pretrain_batch"], "coefficients": sizes["coefficients"],
                     "step_ms": _quantiles(step_ms[1:] or step_ms),
                     "first_step_ms": step_ms[0], "val_rmse_mm": metrics["val_rmse_mm"],
                     "targets": len(names)},
        "train": {"steps": sizes["train_steps"], "batch": config.per_host_batch_size,
                  "hw": list(hw), "dtype": config.model.dtype,
                  "step_ms_per_window": [1e3 / r for r in rates]},
        "dagger": {"rounds": dagger["rounds"], "launches": dagger["launches"],
                   "engine_steps": dagger["engine_steps"], "seconds": dagger["seconds"]},
        "eval": {"arms": arms, "launches": evaluated["launches"],
                 "engine_steps": evaluated["engine_steps"], "seconds": evaluated["seconds"],
                 "criterion_met": summary["criterion_met"],
                 "corpus_entropy_nats": summary["corpus_entropy"]["mean_entropy_nats"]},
        "control_step": {"dagger": dagger_steps, "eval": eval_steps},
        "diagnostics": {"cli": _without_episodes(report), "episode": _without_episodes(direct),
                        "control_step_ms": diag_step_ms, **diag_launches},
        "perception_probe": {k: probe[k] for k in ("resolution", "frames", "steps",
                                                   "val_rmse_mm", "dataset_seconds",
                                                   "train_seconds", "device")},
        "arm": arm_record,
        "stage_s": stage_s,
    }
    emit(record)
    return record


def _proof_arm_resumes(workdir, args):
    """The arm run again over a workdir whose every stage is done: each
    stage skipped, the checkpoints and `learn_proof.json` unchanged, no
    train step and no launch; its decision line printed as a phase line."""
    from rt1_tpu_torch.parallel.flash_attention import fused_attention
    from rt1_tpu_torch.train import proof_arm
    from rt1_tpu_torch.trainer.checkpoints import all_steps

    ckpt_dir = os.path.join(workdir, "train", "checkpoints")
    proof_path = os.path.join(workdir, "learn_proof.json")
    with open(proof_path, "rb") as f:
        proof_bytes = f.read()
    steps_before = all_steps(ckpt_dir)
    launches_before = dict(fused_attention.launches_by_variant)
    lines, seconds = _run_in_process(proof_arm.main, args)
    launches = {v: n - launches_before[v] for v, n in fused_attention.launches_by_variant.items()}
    stages = {r["proof_arm"]: r for r in lines if "proof_arm" in r}
    decision = stages.pop("decision", None)
    with open(proof_path, "rb") as f:
        unchanged = f.read() == proof_bytes
    if list(stages) != list(proof_arm.ProofArm.STAGES) or decision is None or \
            any(r["status"] != "skipped" for r in stages.values()) or \
            any("steps_per_sec" in r for r in lines) or set(launches.values()) != {0} or \
            all_steps(ckpt_dir) != steps_before or not unchanged:
        raise AssertionError(f"proof arm: {lines}, launches {launches}")
    emit({"phase": "proof_arm", **decision})  # a lane forwards only phase lines
    return {"stages": {k: r.get("reason") for k, r in stages.items()}, "decision": decision,
            "launches": launches, "seconds": seconds}


def _without_episodes(report):
    """A diagnostics report without its per-episode records."""
    return {k: v for k, v in report.items() if k != "per_episode"}


# The fleet: `python -m rt1_tpu_torch.serve.fleet` fronting flagship bf16
# replicas on the card, with one `replica_kill` chaos tick after the drive.
FLEET_REPLICAS = 2
FLEET_SESSIONS = 4
FLEET_STEPS = 8
FLEET_CHAOS_INTERVAL_S = 12.0    # the kill's tick, counted from the fleet's first all-ready
FLEET_TIMEOUT_S = 600            # a replica's warm-up, and the respawn's
# The alerts proof's replica_kill on this fleet (`obs/alerts_proof.py`):
FLEET_COLLECTOR_S = 0.25         # the metrics plane's scrape, as the proof arms it
FLEET_WATCH_S = 0.25             # the watcher's poll of /metrics and /alerts
FLEET_PROOF_SESSIONS = tuple(f"k{i}" for i in range(12))  # placed before the kill
FLEET_QUIET_S = 60.0             # every alert resolved within this
FLEET_OVERHEAD_ROUNDS = 5        # the collector A/B on stub fleets: 300 acts an arm


def _post(url, payload, headers=None, timeout=120):
    """(status, body) of a JSON POST, an HTTP error's body included."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get_text(url, accept=None, timeout=60):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


def _memory_used_mib(on_card):
    if not on_card:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return int(out.stdout.strip().splitlines()[0])


def _wait_for(predicate, timeout_s, what):
    """Poll `predicate` every 0.1 s; returns its first truthy value."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"fleet: timed out after {timeout_s:.0f}s waiting for {what}")


def _fleet_launches(snapshot, on_card, what):
    """A replica's per-variant launches from the router's fan-out, held to
    8 tensor-core launches an engine step (0 on the CPU) and no other."""
    steps, layers = int(snapshot["engine_steps_total"]), int(snapshot["decoder_layers"])
    launches = {v: int(snapshot[f"attention_launches_{v}_total"])
                for v in ("tensor_core", "tf32x3", "simple")}
    expected = layers * steps if on_card else 0
    if steps <= 0 or launches != {"tensor_core": expected, "tf32x3": 0, "simple": 0} or \
            (on_card and expected <= 0):
        raise AssertionError(f"fleet: {what} launched {launches} in {steps} engine steps, "
                             f"expected {layers} x {steps} tensor-core and no other")
    return {**launches, "engine_steps": steps}


def phase_fleet(config_name: str = "language_table", device: str = "cuda", direct=None):
    """`python -m rt1_tpu_torch.serve.fleet` with two bf16 replicas of the
    config on `device`: warm-up, 4 sessions x 8 `/act` steps through the
    router, affinity, request ids, the Prometheus and JSON fan-out with each
    replica's kernel counters, the chaos kill and the respawn. `direct` is
    phase `serve`'s record, printed beside the router's latencies."""
    import numpy as np

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.obs import alerts_proof
    from rt1_tpu_torch.obs.prometheus import parse_exposition
    from rt1_tpu_torch.serve.fleet import FLAGSHIP_PARAM_BYTES

    config = get_config(config_name)
    h, w = config.data.height, config.data.width
    on_card = device == "cuda"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("RT1_FAULTS", None)
    sessions = [f"fleet-{i}" for i in range(FLEET_SESSIONS)]
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (FLEET_SESSIONS, FLEET_STEPS + 1, h, w, 3), dtype=np.uint8)

    def body(i, step):
        return {"session_id": sessions[i], "instruction": f"push block {i} to the top left corner",
                "image_b64": base64.b64encode(frames[i, step].tobytes()).decode()}

    def check_action(out):
        action = np.asarray(out.get("action", []), np.float64)
        tokens = np.asarray(out.get("action_tokens", []))
        if action.shape != (2,) or not np.isfinite(action).all() or \
                (np.abs(action) > 0.03 + 1e-7).any() or tokens.shape != (3,) or \
                ((tokens < 0) | (tokens >= config.model.vocab_size)).any():
            raise AssertionError(f"fleet: bad action {out}")

    # The proof's other two phases on stub fleets (host processes, no
    # torch) run beside this fleet's warm-up.
    stub_out = {}

    def stub_ab():
        t = time.perf_counter()
        try:
            stub_out["stubs"] = alerts_proof.run_overhead_and_identity(
                alerts_proof.FleetSpec(stub=True), rounds=FLEET_OVERHEAD_ROUNDS)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            stub_out["error"] = exc
        stub_out["s"] = time.perf_counter() - t

    stub_thread = threading.Thread(target=stub_ab, name="fleet-stub-ab", daemon=True)
    stub_thread.start()
    try:
        with tempfile.TemporaryDirectory() as logs, tempfile.TemporaryFile(mode="w+") as errlog:
            cmd = [sys.executable, "-m", "rt1_tpu_torch.serve.fleet", "--replicas",
                   str(FLEET_REPLICAS), "--config", config_name, "--random_init",
                   "--inference_dtype", "bf16", "--device", device, "--port", "0",
                   "--faults", "replica_kill@1", "--chaos_interval_s", str(FLEET_CHAOS_INTERVAL_S),
                   "--poll_interval_s", "0.25", "--warmup_timeout_s", str(FLEET_TIMEOUT_S),
                   "--collector", "--collector_interval_s", str(FLEET_COLLECTOR_S),
                   "--log_dir", logs]
            proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=errlog,
                                    text=True, start_new_session=True)
            ok, watcher = False, None
            try:
                t0 = time.perf_counter()
                ready = _read_ready_line(proc, FLEET_TIMEOUT_S)
                warmup_s = time.perf_counter() - t0
                url = f"http://127.0.0.1:{ready['port']}"
                fleet = json.loads(_get_text(url + "/fleet/status"))
                if [r["state"] for r in fleet["replicas"]] != ["ready"] * FLEET_REPLICAS:
                    raise AssertionError(f"fleet: not every replica ready {fleet['replicas']}")
                memory_ready = _memory_used_mib(on_card)
                # 1. The drive: each session's steps in order, the sessions at once.
                replies, lock = [], threading.Lock()

                def drive(i):
                    for step in range(FLEET_STEPS):
                        rid = f"fleet-{i}-{step}"
                        t = time.perf_counter()
                        code, out = _post(url + "/act", dict(body(i, step), debug=True),
                                          {"X-RT1-Request-Id": rid})
                        with lock:
                            replies.append((rid, code, out, time.perf_counter() - t))

                t_drive = time.perf_counter()
                threads = [threading.Thread(target=drive, args=(i,)) for i in range(FLEET_SESSIONS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(FLEET_TIMEOUT_S)
                drive_s = time.perf_counter() - t_drive
                if len(replies) != FLEET_SESSIONS * FLEET_STEPS:
                    raise AssertionError(f"fleet: {len(replies)} replies of "
                                         f"{FLEET_SESSIONS * FLEET_STEPS}")
                for rid, code, out, _ in replies:
                    if code != 200 or out.get("restarted"):
                        raise AssertionError(f"fleet: /act {code} {out}")
                    if out.get("request_id") != rid:
                        raise AssertionError(f"fleet: request id {rid} came back as "
                                             f"{out.get('request_id')}")
                    check_action(out)
                # 2. Affinity: each session's whole window on exactly one replica.
                fleet = json.loads(_get_text(url + "/fleet/status"))
                if any(r["restarts"] for r in fleet["replicas"]):
                    raise AssertionError("fleet: the chaos kill came before the drive ended; "
                                         "raise FLEET_CHAOS_INTERVAL_S")
                urls = {r["id"]: r["url"] for r in fleet["replicas"]}
                owners = {}
                for sid in sessions:
                    held = {rid: _post(u + "/session/export", {"session_id": sid})
                            for rid, u in urls.items()}
                    holders = [rid for rid, (code, _) in held.items() if code == 200]
                    if len(holders) != 1 or \
                            held[holders[0]][1]["snapshot"]["step_index"] != FLEET_STEPS:
                        raise AssertionError(f"fleet: {sid} held by {holders}")
                    owners[sid] = holders[0]
                if set(owners.values()) != set(urls):
                    raise AssertionError(f"fleet: sessions on {owners}, replicas {sorted(urls)}")
                # 3. The router's Prometheus text and JSON fan-out.
                parsed = parse_exposition(_get_text(url + "/metrics", accept="text/plain"))
                for rid in urls:
                    if parsed.value("rt1_serve_replica_up", replica_id=str(rid)) != 1.0:
                        raise AssertionError(f"fleet: rt1_serve_replica_up of {rid} is not 1")
                fanned = json.loads(_get_text(url + "/metrics"))["replicas"]
                launches = {rid: _fleet_launches(snap, on_card, f"replica {rid}")
                            for rid, snap in fanned.items()}
                resident = {rid: int(snap["param_bytes_device"]) for rid, snap in fanned.items()}
                if config_name == "language_table" and \
                        set(resident.values()) != {FLAGSHIP_PARAM_BYTES["bf16"]}:
                    raise AssertionError(f"fleet: resident bytes {resident}")
                # The alerts proof's replica_kill on this fleet: more sessions
                # placed before the kill (their re-homes are the burn), the
                # watcher on the plane's signals.
                frame_body = body(0, FLEET_STEPS)
                proof_fleet = alerts_proof.Fleet(url, body=lambda sid: {**frame_body,
                                                                        "session_id": sid})
                for sid in FLEET_PROOF_SESSIONS:
                    proof_fleet.act(sid)
                watcher = alerts_proof.Watcher(url, interval_s=FLEET_WATCH_S)
                watcher.start()
                t_armed = time.time()
                # 4. The chaos kill (tick 1: the lowest-id ready replica).
                def killed():
                    rs = json.loads(_get_text(url + "/fleet/status"))["replicas"]
                    return [r["id"] for r in rs if r["restarts"] == 1]

                (victim,) = _wait_for(killed, FLEET_CHAOS_INTERVAL_S + 60, "the chaos kill")
                t_kill = time.perf_counter()
                rehome = {}
                for i, sid in enumerate(sessions):
                    code, out = _post(url + "/act", body(i, FLEET_STEPS),
                                      {"X-RT1-Request-Id": f"fleet-{i}-rehome"})
                    if code != 200 or bool(out.get("restarted")) != (owners[sid] == victim) or \
                            out.get("request_id") != f"fleet-{i}-rehome":
                        raise AssertionError(f"fleet: after the kill {sid} (on {owners[sid]}, "
                                             f"victim {victim}) answered {code} {out}")
                    check_action(out)
                    rehome[sid] = bool(out.get("restarted"))
                touched = alerts_proof.touch(proof_fleet, FLEET_PROOF_SESSIONS, tries=1)
                restarted = sum(rehome.values()) + sum(touched.values())
                memory_killed = _memory_used_mib(on_card)

                def healed():
                    rs = json.loads(_get_text(url + "/fleet/status"))["replicas"]
                    return all(r["state"] == "ready" for r in rs) and \
                        [r["restarts"] for r in rs if r["id"] == victim] == [1]

                _wait_for(healed, FLEET_TIMEOUT_S, "the respawned replica")
                kill_to_ready_s = time.perf_counter() - t_kill
                memory_respawned = _memory_used_mib(on_card)
                fanned = json.loads(_get_text(url + "/metrics"))["replicas"]
                respawned = _fleet_launches(fanned[str(victim)], on_card, "the respawned replica")
                # The burn decays under clean traffic and every alert resolves.
                t_decay = time.perf_counter()
                alerts_proof.await_firing(watcher, ("SLOBurnRateFast", "SLOBurnRateSlow"))
                alerts_proof.decay(proof_fleet, sessions + list(FLEET_PROOF_SESSIONS),
                                   alerts_proof.DECAY_ACTS)
                quiet = alerts_proof.await_quiet(proof_fleet, FLEET_QUIET_S)
                decay_s = time.perf_counter() - t_decay
                watcher.stop()
                # 5. SIGTERM: the fleet drains its replicas and exits 0.
                proc.send_signal(signal.SIGTERM)
                out, _ = proc.communicate(timeout=180)
                final = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
                if proc.returncode != 0 or not final or final[-1].get("status") != "stopped":
                    raise AssertionError(f"fleet: exit code {proc.returncode} after SIGTERM")
                chaos = final[-1]["chaos"]
                if (chaos["kills_injected"], chaos["replica_restarts"]) != (1, 1):
                    raise AssertionError(f"fleet: chaos {chaos}")
                kill = alerts_proof.kill_record(final[-1], watcher, t_armed, restarted,
                                                faults="replica_kill@1")
                if not (quiet and kill["passed"]):
                    raise AssertionError(f"fleet: the alerts proof's replica_kill {kill}")
                ok = True
            finally:
                if watcher is not None:
                    watcher.stop()
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=30)
                if not ok:
                    errlog.seek(0)
                    sys.stderr.write(errlog.read()[-4000:])
                    for name in sorted(os.listdir(logs)):
                        with open(os.path.join(logs, name)) as f:
                            sys.stderr.write(f"--- {name}\n" + f.read()[-4000:])
    finally:
        stub_thread.join(FLEET_TIMEOUT_S)  # its stub fleets stop before this returns
    stub_thread.join(FLEET_TIMEOUT_S)
    if stub_thread.is_alive() or "error" in stub_out:
        raise AssertionError(f"fleet: the stub fleets' A/B {stub_out.get('error', 'hung')}")
    stubs, stubs_s = stub_out["stubs"], stub_out["s"]
    if not stubs["byte_identity"]["passed"]:
        raise AssertionError(f"fleet: an unarmed fleet's ops surfaces {stubs['byte_identity']}")
    lat_ms = [r[3] * 1e3 for r in replies]
    router_ms = _quantiles(lat_ms)
    # Inside the replica (its `phases`, under "debug": true) and the rest:
    # the router, both HTTP hops and the client.
    replica_ms = [r[2]["phases"]["total_ms"] for r in replies]
    hop_ms = _quantiles([c - r for c, r in zip(lat_ms, replica_ms)])
    replica_ms = _quantiles(replica_ms)
    direct_ms = None
    if direct is not None:
        direct_ms = {"p50": direct["client_p50_ms"], "p99": direct["client_p99_ms"],
                     "max": max(direct["client_latencies_ms"]), "n": direct["requests"]}
    smi = nvidia_smi() if on_card else None
    emit({"phase": "fleet_latency", "router_act_ms": router_ms,
          "direct_act_ms (phase serve)": direct_ms, "inside_replica_ms": replica_ms,
          "router_and_hops_ms": hop_ms})
    emit({"phase": "fleet_times", "warmup_s": warmup_s, "kill_to_ready_s": kill_to_ready_s,
          "drive_s": drive_s})
    emit({"phase": "fleet_bytes", "param_bytes_device": resident,
          "memory_used_mib": {"ready": memory_ready, "after_kill": memory_killed,
                              "respawned": memory_respawned}})
    if smi:
        print(smi, flush=True)
    record = {
        "phase": "fleet", "config": config_name, "device": device, "dtype": "bf16",
        "replicas": FLEET_REPLICAS, "sessions": FLEET_SESSIONS, "steps": FLEET_STEPS,
        "nvidia_smi": smi, "warmup_s": warmup_s, "kill_to_ready_s": kill_to_ready_s,
        "drive_s": drive_s, "router_act_ms": router_ms, "direct_act_ms": direct_ms,
        "inside_replica_ms": replica_ms, "router_and_hops_ms": hop_ms,
        "owners": owners, "victim": victim, "restarted": rehome,
        "launches": launches, "respawned_launches": respawned,
        "param_bytes_device": resident,
        "memory_used_mib": {"ready": memory_ready, "after_kill": memory_killed,
                            "respawned": memory_respawned},
        "slo": final[-1]["slo"]["by_class"],
        "alerts_proof": {"replica_kill": kill, "decay_s": decay_s,
                         "stub_overhead": stubs["overhead"],
                         "stub_byte_identity": stubs["byte_identity"], "stub_s": stubs_s},
    }
    emit(record)
    return record


OPS_SEED_EPISODES, OPS_SEED_STEPS = 4, 12  # the packed seed corpus, at the config's geometry
OPS_LONG_SESSIONS = 4            # sessions live across the promotion
OPS_SHORT_STEPS = 6              # steps of each short session before its /release
OPS_SHORT_EVERY_S = 2.0          # a short session starts this often
OPS_LONG_EVERY_S = 0.25          # a long session acts at most this often
OPS_CLEAN_TICKS = 3              # the canary's clean window (min_canary_requests 0: pinned)
OPS_POLL_S = 2.0                 # controller tick; > the collector's 1 s, so a scrape
#                                  sees the breached canary's burn before the rollback
OPS_GATE_STEPS = 10              # --gate_max_steps: 1 task x 1 episode a column
OPS_WATCH_S = 0.5                # the alerts proof's watcher: /metrics and /alerts
OPS_TIMEOUT_S = 600


class _OpsTraffic(threading.Thread):
    """The ops phase's clients: OPS_LONG_SESSIONS sessions that act for
    the whole phase (no restart allowed across the promotion), and a short
    session every OPS_SHORT_EVERY_S that acts OPS_SHORT_STEPS times and
    is released (a captured episode). Records every reply's client ms,
    failures and `restarted` flags with their time.

    While a canary runs it also notes which sessions are bound to the
    canary replica (`canary_bound`, by candidate step), asking the replica
    for the session's snapshot (`/session/export`, a pure read): each long
    session when the canary is first seen and 1 s later, each new short
    session after its first act. A rollback may restart those sessions
    only, and must restart the long ones."""

    def __init__(self, url, frame_b64, embedding):
        super().__init__(daemon=True)
        self.url, self.frame_b64, self.embedding = url, frame_b64, embedding
        self.stop_evt = threading.Event()
        self.long = [f"ops-long-{i}" for i in range(OPS_LONG_SESSIONS)]
        self.latencies_ms, self.failures, self.restarts = [], [], []
        self.ok = self.short_released = 0
        self.canary_bound = {}
        self._canary = None          # (candidate step, canary replica url) while one runs
        self._first_look = None      # (monotonic s, long session -> step on the canary)
        self._last = {}

    def act(self, sid):
        t = time.perf_counter()
        try:
            code, out = _post(self.url + "/act", {"session_id": sid, "image_b64": self.frame_b64,
                                                  "embedding": self.embedding,
                                                  "task": "ops_probe"})
        except (urllib.error.URLError, OSError) as exc:
            code, out = 0, {"error": str(exc)}
        if code != 200 or "action" not in out:
            self.failures.append({"session": sid, "code": code, "body": str(out)[:300],
                                  "unix_time": time.time(),
                                  "router_view": self._router_view(sid)})
            return None
        self.latencies_ms.append((time.perf_counter() - t) * 1e3)
        self.ok += 1
        if out.get("restarted"):
            self.restarts.append({"session": sid, "unix_time": time.time()})
        return out

    def _router_view(self, sid):
        """The router's view of `sid` (`GET /fleet/session`: its replica,
        its orphan and migrated marks), or the error that reading it met."""
        try:
            return json.loads(_get_text(f"{self.url}/fleet/session?session_id={sid}"))
        except (urllib.error.URLError, OSError, ValueError) as exc:
            return {"error": str(exc)}

    def _probe(self, fn, *args):
        try:
            fn(*args)
        except (urllib.error.URLError, OSError) as exc:
            self.failures.append({"session": None, "code": 0, "body": f"canary probe: {exc}"})

    def _step_on_canary(self, sid):
        """The session's step count in the canary replica's engine, or None."""
        code, out = _post(self._canary[1] + "/session/export", {"session_id": sid})
        return out["snapshot"]["step_index"] if code == 200 else None

    def _note_if_on_canary(self, sid):
        """A new session: bound to the canary iff its engine holds it."""
        if self._step_on_canary(sid) is not None:
            self.canary_bound.setdefault(self._canary[0], set()).add(sid)

    def _watch_canary(self):
        """A long session is bound to the canary iff the canary's copy of it
        advances between two looks 1 s apart: a rolling reload's migration
        can leave a stale copy behind on a replica the router no longer
        sends the session to."""
        status = json.loads(_get_text(self.url + "/deploy/status"))
        if status["state"] != "canary":
            if self._canary is not None and self._first_look is not None:
                self.failures.append({"session": None, "code": 0,
                                      "body": f"canary {self._canary[0]} ended within 1 s"})
            self._canary = self._first_look = None
            return
        step = status["candidate_step"]
        if self._canary is None or self._canary[0] != step:
            replicas = json.loads(_get_text(self.url + "/fleet/status"))["replicas"]
            rid = status["canary_replica_id"]
            self._canary = (step, next(r["url"] for r in replicas if r["id"] == rid))
            self._first_look = (time.monotonic(),
                                {sid: self._step_on_canary(sid) for sid in self.long})
        elif self._first_look is not None and time.monotonic() - self._first_look[0] >= 1.0:
            for sid, first in self._first_look[1].items():
                now = self._step_on_canary(sid)
                if first is not None and now is not None and now > first:
                    self.canary_bound.setdefault(step, set()).add(sid)
            self._first_look = None

    def run(self):
        short, short_steps, last_short, last_watch = None, 0, 0.0, 0.0
        while not self.stop_evt.is_set():
            now = time.monotonic()
            if now - last_watch >= OPS_LONG_EVERY_S:
                last_watch = now
                self._probe(self._watch_canary)
            for sid in self.long:
                if now - self._last.get(sid, 0.0) >= OPS_LONG_EVERY_S:
                    self._last[sid] = now
                    self.act(sid)
            if short is None and now - last_short >= OPS_SHORT_EVERY_S:
                short, short_steps, last_short = f"ops-short-{int(now * 1e3)}", 0, now
            if short is not None:
                self.act(short)
                short_steps += 1
                if short_steps == 1 and self._canary is not None:
                    self._probe(self._note_if_on_canary, short)
                if short_steps >= OPS_SHORT_STEPS:
                    # The router's view just before the /release (which
                    # clears it), kept if the release fails (ROADMAP C7).
                    view = self._router_view(short)
                    code, out = _post(self.url + "/release", {"session_id": short})
                    if code != 200:
                        self.failures.append({"session": short, "code": code, "body": str(out),
                                              "unix_time": time.time(),
                                              "router_view_before_release": view})
                    self.short_released += 1
                    short = None
            self.stop_evt.wait(0.02)


def _ops_c3(config_name, device, workdir, env, frame_b64):
    """ROADMAP C3 on the card: `python -m rt1_tpu_torch.serve --workdir`
    with another embedder than the checkpoint's manifest must refuse,
    naming the manifest; with --allow_embedder_mismatch it serves."""
    base = [sys.executable, "-m", "rt1_tpu_torch.serve", "--config", config_name, "--workdir",
            workdir, "--device", device, "--port", "0", "--embedder", "ngram",
            "--max_sessions", "1"]
    refused = subprocess.run(base, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=OPS_TIMEOUT_S)
    if refused.returncode == 0 or "data_manifest" not in refused.stderr or \
            "--allow_embedder_mismatch" not in refused.stderr:
        raise AssertionError(f"ops: serve with a mismatched embedder exited "
                             f"{refused.returncode}: {refused.stderr[-2000:]}")
    proc = subprocess.Popen(base + ["--allow_embedder_mismatch"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ready = _read_ready_line(proc, OPS_TIMEOUT_S)
        code, out = _post(f"http://127.0.0.1:{ready['port']}/act",
                          {"session_id": "c3", "instruction": "push the red block",
                           "image_b64": frame_b64}, timeout=120)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    if code != 200 or "action" not in out or proc.returncode != 0 or \
            ready.get("checkpoint_step") != 2:
        raise AssertionError(f"ops: --allow_embedder_mismatch did not serve: {code} {out}, "
                             f"exit {proc.returncode}")
    return {"refused_exit_code": refused.returncode,
            "refusal": refused.stderr.strip().splitlines()[-1][:300],
            "allowed_checkpoint_step": ready["checkpoint_step"]}


def _verdict_summary(event):
    """The gate's verdict behind a controller event (its signed file), as
    much of it as says why the gate decided so; None without one."""
    path = event.get("verdict_path")
    if not path or not os.path.isfile(path):
        return None
    with open(path) as f:
        verdict = json.load(f)
    parity = verdict.get("parity") or {}
    keys = ("passed", "error", "eval_passed", "candidate_mean_success",
            "incumbent_mean_success", "margin")
    return {**{k: verdict.get(k) for k in keys},
            "parity": {k: parity.get(k) for k in ("passed", "agreement", "tokens_total",
                                                   "threshold", "error", "skipped")}}


def _copy_workdir(src, dst):
    """Copy a train workdir, hard-linking its checkpoint files (hundreds
    of MB at the flagship) and copying the rest."""
    def link_or_copy(a, b):
        if os.path.basename(a) == "state.pt":
            os.link(a, b)
        else:
            shutil.copy2(a, b)

    shutil.copytree(src, dst, copy_function=link_or_copy)


def _publish_step(stage_wd, train_wd, step, root, trainer, timeout_s):
    """Wait for `step`'s checkpoint in the staging workdir, then put it into
    the watched one in one rename, as the trainer's own save lands it.
    Returns the seconds waited."""
    t0 = time.perf_counter()
    staged = os.path.join(stage_wd, "checkpoints", str(step))
    _wait_for(lambda: os.path.isfile(os.path.join(staged, "state.pt")) or "s" in trainer,
              timeout_s, f"the trainer's step {step}")
    if not os.path.isfile(os.path.join(staged, "state.pt")):
        raise AssertionError(f"ops: the trainer ended without step {step}: {trainer}")
    tmp = os.path.join(root, f"publish_{step}")
    _copy_workdir(staged, tmp)
    os.rename(tmp, os.path.join(train_wd, "checkpoints", str(step)))
    return time.perf_counter() - t0


def phase_ops(config_name: str = "language_table", device: str = "cuda"):
    """The fleet's operations loop (metrics plane, flywheel capture, eval-
    gated continuous deployment) at the config's width on `device`; see the
    module docstring, phase 18. CPU rehearsal: `phase_ops('tiny', 'cpu')`."""
    import numpy as np

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.data import pack as pack_lib
    from rt1_tpu_torch.data.episodes import write_manifest
    from rt1_tpu_torch.deploy import loop as deploy_loop
    from rt1_tpu_torch.flywheel import loop as fly
    from rt1_tpu_torch.flywheel.capture import capture_files
    from rt1_tpu_torch.obs import alerts_proof
    from rt1_tpu_torch.obs.prometheus import parse_exposition

    t_phase = time.perf_counter()
    config = get_config(config_name)
    h, w = config.data.height, config.data.width
    layers = config.model.num_layers
    on_card = device == "cuda"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("RT1_FAULTS", None)
    rng = np.random.default_rng(11)
    frame_b64 = base64.b64encode(rng.integers(0, 256, (h, w, 3), np.uint8).tobytes()).decode()
    embedding = [float(x) for x in rng.standard_normal(512).astype(np.float32)]
    with tempfile.TemporaryDirectory() as root:
        logs = os.path.join(root, "logs")
        train_wd, fly_wd = os.path.join(root, "train"), os.path.join(root, "fly_train")
        stage_wd = os.path.join(root, "train_stage")
        capture = os.path.join(root, "capture")
        data = {k: os.path.join(root, f"data_{k}") for k in ("deploy", "fly")}
        for d in (logs, train_wd, fly_wd, capture):
            os.makedirs(d)
        packs = {}
        for k, d in data.items():
            paths = fly.build_corpus(d, OPS_SEED_EPISODES, OPS_SEED_STEPS, h, w)
            write_manifest(d, embedder="hash", episodes=OPS_SEED_EPISODES)
            packs[k] = pack_lib.default_pack_dir(d, "train")
            pack_lib.pack_episodes(paths, packs[k], h, w, config.data.crop_factor)
        # 1. The incumbent: step 2 of a trainer whose packed corpus stamps
        # data_manifest.json (embedder "hash").
        t0 = time.perf_counter()
        deploy_loop.train_to(config_name, device, train_wd, data["deploy"], 2,
                             os.path.join(logs, "train.log"))
        train2_s = time.perf_counter() - t0
        with open(os.path.join(train_wd, "data_manifest.json")) as f:
            if json.load(f).get("embedder") != "hash":
                raise AssertionError("ops: the trainer stamped no hash embedder")
        # 3a. The candidates: one process resumes the trainer to 4 and on to
        # 6 in a copy of the workdir while the fleet boots; each step is
        # published into the watched workdir when its turn comes.
        _copy_workdir(train_wd, stage_wd)
        train46 = {}

        def resume_to_6():
            t = time.perf_counter()
            try:
                deploy_loop.train_to(config_name, device, stage_wd, data["deploy"], 6,
                                     os.path.join(logs, "train.log"))
            except Exception as exc:  # noqa: BLE001 - re-raised on the main thread
                train46["error"] = exc
            train46["s"] = time.perf_counter() - t

        train_thread = threading.Thread(target=resume_to_6, daemon=True)
        train_thread.start()
        # 3. The fleet with all three flags armed; the breach is aimed at
        # the second canary's first tick (the first takes OPS_CLEAN_TICKS).
        argv = deploy_loop.fleet_argv(
            config_name, device, train_wd, clean_window_ticks=OPS_CLEAN_TICKS,
            gate_tasks="block2block", gate_episodes=1, gate_max_steps=OPS_GATE_STEPS,
            faults=f"canary_slo_breach@{OPS_CLEAN_TICKS + 1}", min_canary_requests=0,
            poll_interval_s=OPS_POLL_S,
            extra=["--inference_dtype", "bf16", "--collector", "--collector_interval_s", "1",
                   "--capture_dir", capture, "--obs_dir", root, "--log_dir", logs,
                   "--warmup_timeout_s", str(OPS_TIMEOUT_S)])
        errlog = open(os.path.join(logs, "fleet.err"), "w")
        t_boot = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=errlog,
                                text=True, start_new_session=True)
        traffic = fly_proc = watcher = None
        ok = False
        try:
            # 2. C3 while the fleet warms up.
            c3 = _ops_c3(config_name, device, train_wd, env, frame_b64)
            ready = _read_ready_line(proc, OPS_TIMEOUT_S)
            warmup_s = time.perf_counter() - t_boot
            url = f"http://127.0.0.1:{ready['port']}"
            if ready.get("deploy", {}).get("incumbent_step") != 2 or not ready.get("collector"):
                raise AssertionError(f"ops: fleet armed {ready}")
            # The alerts proof's canary_breach judges this fleet's alerts.
            watcher = alerts_proof.Watcher(url, interval_s=OPS_WATCH_S)
            watcher.start()
            traffic = _OpsTraffic(url, frame_b64, embedding)
            traffic.start()
            # 5a. The live trainer, on its own corpus, before any append.
            scrape_port = fly.free_port()
            fly_log = open(os.path.join(logs, "fly_train.log"), "w")
            fly_proc = fly.start_live_trainer(config_name, device, fly_wd, data["fly"],
                                              scrape_port, fly_log)
            published = {4: _publish_step(stage_wd, train_wd, 4, root, train46, OPS_TIMEOUT_S)}
            # Step 6 goes in once the controller has taken 4: it can then
            # only surface at the controller's next idle tick, after 4's
            # promotion.
            _wait_for(lambda: (deploy_loop.deploy_status(url) or {}).get("candidates_seen_total"),
                      OPS_TIMEOUT_S, "the controller to take step 4")
            published[6] = _publish_step(stage_wd, train_wd, 6, root, train46, OPS_TIMEOUT_S)
            promoted, status = deploy_loop.wait_terminal(url, OPS_TIMEOUT_S)
            events = [e["event"] for e in status["timeline"]]
            if promoted["event"] != "promoted" or promoted["step"] != 4 or events != [
                    "candidate", "gate_passed", "canary_started", "promoted"]:
                raise AssertionError(f"ops: promotion timeline {status['timeline']}")
            canary = status["timeline"][2]
            if canary["weight"] != 0.5:
                raise AssertionError(f"ops: canary {canary}")
            if traffic.restarts or traffic.failures:
                raise AssertionError(f"ops: across the promotion restarts {traffic.restarts} "
                                     f"failures {traffic.failures[:3]}")
            n_promote = len(status["timeline"])
            # 5. The flywheel: released short sessions captured and swept
            # into staging; the torn append; the live trainer's pickup.
            staging = os.path.join(capture, "staging")
            staged = _wait_for(lambda: capture_files(staging), OPS_TIMEOUT_S,
                               "captured episodes in staging")
            episode_bytes = [os.path.getsize(p) for p in staged]
            with np.load(staged[0]) as ep:
                keys = sorted(ep.files)
                if ep["rgb"].shape[1:] != (h, w, 3) or "action_tokens" not in keys:
                    raise AssertionError(f"ops: captured episode {keys} {ep['rgb'].shape}")
            first, _ = fly.wait_flywheel_gauges(fly_proc, scrape_port, OPS_TIMEOUT_S)
            torn = fly.torn_append_chaos(packs["fly"], staged)
            if not (torn["injected"] and torn["manifest_intact"]):
                raise AssertionError(f"ops: torn append {torn}")
            manifest = pack_lib.append_shard(packs["fly"], staged)
            if len(manifest["shards"]) != 2:
                raise AssertionError(f"ops: append gave {len(manifest['shards'])} shards")
            grown, _ = fly.wait_flywheel_gauges(
                fly_proc, scrape_port, OPS_TIMEOUT_S,
                grown_from=first["rt1_flywheel_corpus_windows"])
            fly_rc = fly.stop_process(fly_proc)
            fly_log.close()
            if fly_rc != 0:
                raise AssertionError(f"ops: the live trainer exited {fly_rc} on SIGTERM")
            # 3b. The breaching candidate: step 6, rolled back.
            train_thread.join(OPS_TIMEOUT_S)
            if "error" in train46 or "s" not in train46:
                raise AssertionError(f"ops: the resume to step 6: {train46}")
            rolled, status = deploy_loop.wait_terminal(url, OPS_TIMEOUT_S, after=n_promote)
            restore = rolled.get("restore") or {}
            if rolled["event"] != "rolled_back" or rolled["step"] != 6 or \
                    rolled["reason"] != "slo_breach_injected" or rolled["incumbent"] != 4 or \
                    restore.get("status") != 200 or restore.get("checkpoint_step") != 4:
                raise AssertionError(f"ops: rollback {rolled}; verdict {_verdict_summary(rolled)}")
            timeline = status["timeline"]
            # 4. The metrics plane.
            def alert_cycle():
                hist = json.loads(_get_text(url + "/alerts"))["history"]
                seen = [e["event"] for e in hist if e["alert"] == "CanarySLOBreach"]
                return seen if seen[:2] == ["firing", "resolved"] else None

            alert_events = _wait_for(alert_cycle, 30, "CanarySLOBreach firing, then resolved")
            series = json.loads(_get_text(url + "/history"))["series"]
            family = "rt1_serve_requests_total"
            if family not in {s["family"] for s in series}:
                raise AssertionError(f"ops: {family} not in /history")
            hist = json.loads(_get_text(url + "/history?family=" + family + "&window_s=600"))
            points = sum(len(s["points"]) for s in hist["series"])
            dashboard = _get_text(url + "/dashboard")
            if points < 2 or "<html" not in dashboard.lower():
                raise AssertionError(f"ops: /history {points} points, /dashboard "
                                     f"{dashboard[:200]}")
            parsed = parse_exposition(_get_text(url + "/metrics", accept="text/plain"))
            names = {name for name, _, _ in parsed.samples}
            for prefix in ("rt1_deploy_", "rt1_alert_", "rt1_obs_collector_"):
                if not any(n.startswith(prefix) for n in names):
                    raise AssertionError(f"ops: no {prefix}* family on /metrics")
            collector_stats = json.loads(_get_text(url + "/alerts"))["counters"]
            # 6. The kernels: the gate's in the fleet process (from the
            # signed verdicts), the replicas' through the fan-out.
            verdicts = [deploy_loop.verify_verdict(train_wd, p) for p in status["verdicts"]]
            if [v["candidate_step"] for v in verdicts] != [4, 6] or \
                    not all(v["signature_ok"] and v["passed"] for v in verdicts):
                raise AssertionError(f"ops: verdicts {verdicts}")
            gates = []
            for p in status["verdicts"]:
                with open(p) as f:
                    gates.append(json.load(f))
            for g in gates:
                # The matrix's control steps: tensor core only. The parity
                # check: tf32x3 = 8 x the float32 reference engine's steps,
                # the bf16 engine's tensor core; never the simple kernel.
                m, par = g["matrix_attention_launches"], g["parity"]["attention_launches"]
                ref_tf32x3 = layers * g["parity"]["reference_steps"] if on_card else 0
                if (m["tensor_core"] > 0) != on_card or m["tf32x3"] or m["simple"] or \
                        par["tf32x3"] != ref_tf32x3 or (par["tensor_core"] > 0) != on_card or \
                        par["simple"]:
                    raise AssertionError(f"ops: gate launches matrix {m} parity {par}")
            fanned = json.loads(_get_text(url + "/metrics"))["replicas"]
            replica_launches = {rid: _fleet_launches(snap, on_card, f"replica {rid}")
                                for rid, snap in fanned.items()}
            # Rolling-reload seconds a replica: the incumbent onto each, in turn.
            reload_s = {}
            for r in json.loads(_get_text(url + "/fleet/status"))["replicas"]:
                t0 = time.perf_counter()
                code, out = _post(r["url"] + "/reload", {"step": 4}, timeout=OPS_TIMEOUT_S)
                _wait_for(lambda: _http(r["url"] + "/readyz")[0] == 200, 120, "readyz")
                if code != 200:
                    raise AssertionError(f"ops: reload of replica {r['id']}: {code} {out}")
                reload_s[r["id"]] = time.perf_counter() - t0
            memory_mib = _memory_used_mib(on_card)
            traffic.stop_evt.set()
            traffic.join(120)
            for sid in traffic.long:
                _post(url + "/release", {"session_id": sid})
            if traffic.failures:
                raise AssertionError(f"ops: failed requests {traffic.failures[:5]}")
            # The rollback restarts only sessions bound to the demoted
            # canary, and each long session that was bound to it.
            bound = traffic.canary_bound.get(6, set())
            restarted = {r["session"] for r in traffic.restarts}
            if restarted - bound or {sid for sid in traffic.long if sid in bound} - restarted:
                raise AssertionError(f"ops: restarted {sorted(restarted)}, bound to the "
                                     f"demoted canary {sorted(bound)}")
            out = fly.stop_and_collect(proc)
            final = deploy_loop.final_line(out)
            if proc.returncode != 0 or final is None:
                raise AssertionError(f"ops: fleet exit code {proc.returncode}")
            if final["deploy"]["promotions_total"] != 1 or \
                    final["deploy"]["rollbacks_total"] != 1 or \
                    final["slo"]["by_class"].get("failed", {}).get("count", 0):
                raise AssertionError(f"ops: final deploy {final['deploy']} slo {final['slo']}")
            swept = final["chaos"]["captures_swept"]
            if not os.path.exists(os.path.join(root, "tsdb_snapshot.jsonl")):
                raise AssertionError("ops: no TSDB snapshot on shutdown")
            watcher.stop()
            canary = alerts_proof.canary_record(final, watcher,
                                                faults=f"canary_slo_breach@{OPS_CLEAN_TICKS + 1}")
            if not canary["passed"]:
                raise AssertionError(f"ops: the alerts proof's canary_breach {canary}")
            ok = True
        finally:
            if watcher is not None:
                watcher.stop()
            if traffic is not None:
                traffic.stop_evt.set()
            if fly_proc is not None and fly_proc.poll() is None:
                fly_proc.kill()
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
            errlog.close()
            if not ok:
                for name in sorted(os.listdir(logs)):
                    with open(os.path.join(logs, name)) as f:
                        sys.stderr.write(f"--- {name}\n" + f.read()[-3000:])
    t_of = {e["event"]: e["unix_time"] for e in timeline[:n_promote]}
    t_rb = {e["event"]: e["unix_time"] for e in timeline[n_promote:]}
    smi = nvidia_smi() if on_card else None
    record = {
        "phase": "ops", "config": config_name, "device": device, "nvidia_smi": smi,
        "c3": c3, "warmup_s": warmup_s,
        "train_s": {"to_2": train2_s, "to_4_and_6": train46["s"]},
        "published_s": published,
        "gate_s": [{"total": g["gate_seconds"], "matrix": g["matrix_seconds"],
                    "parity_engine_builds": g["parity"]["build_seconds"],
                    "parity_check": g["parity"]["check_seconds"]} for g in gates],
        "gate_matrix": [g["matrix"] for g in gates],
        "gate_parity": [{k: g["parity"].get(k) for k in ("agreement", "tokens_total", "passed",
                                                           "max_abs_action_diff")}
                        for g in gates],
        "canary_to_promote_s": t_of["promoted"] - t_of["canary_started"],
        "canary_to_rollback_s": t_rb["rolled_back"] - t_rb["canary_started"],
        "reload_s_a_replica": reload_s,
        "collector_cycle_ms": {n: t["last_scrape_duration_s"] * 1e3
                               for n, t in final["obs"]["collector"]["targets"].items()},
        "collector_cycles": final["obs"]["collector"]["cycles_total"],
        "alerts": alert_events, "alert_counters": collector_stats,
        "alerts_proof_canary_breach": canary,
        "act_ms_collector_armed": _quantiles(traffic.latencies_ms),
        "requests_ok": traffic.ok, "restarts_after_rollback": sorted(restarted),
        "canary_bound": {step: sorted(b) for step, b in traffic.canary_bound.items()},
        "capture_bytes_an_episode": sum(episode_bytes) / len(episode_bytes),
        "episodes_staged_at_append": len(staged), "captures_swept": swept,
        "flywheel": {"before": first, "after": grown, "torn_append": torn},
        "fleet_peak_device_bytes": [g.get("peak_device_bytes") for g in gates],
        "memory_used_mib": memory_mib,
        "gate_launches": [{"matrix": g["matrix_attention_launches"],
                           "parity": g["parity"]["attention_launches"],
                           "parity_reference_steps": g["parity"]["reference_steps"]}
                          for g in gates],
        "replica_launches": replica_launches,
        "wall_s": time.perf_counter() - t_phase,
    }
    if smi:
        print(smi, flush=True)
    emit(record)
    return record


# The serving load generator (`python -m rt1_tpu_torch.serve.loadgen`) in
# its seven modes against flagship replicas, in four lanes at once (one
# card, the host's cores shared): lane A the flags replica (plain
# `--traced`, `--overhead_ab`) then `--occupancy_sweep`; lane B
# `--quant_ab`; lane C the fleet's chaos then `--migration_ab` (stub
# fleets); lane D the elastic `--traffic_schedule`.
LOADGEN_FLAGS = ("--max_batch", "8", "--max_delay_ms", "5", "--max_queue", "32",
                 "--pipeline_depth", "2", "--request_timeout_s", "30")
LOADGEN_BATCHER = {"max_batch": 8, "max_delay_s": 0.005, "max_queue": 32, "pipeline_depth": 2,
                   "request_timeout_s": 30.0}
LOADGEN_SESSIONS = 8
LOADGEN_STEPS = 16
# Cut in depth to the script's time limit (PERF.md §4): JAX's loadgen
# defaults are 32 steps, 24 parity frames, phases of 6 s.
LOADGEN_SWEEP_STEPS = 4
LOADGEN_QUANT_STEPS = 2
LOADGEN_PARITY_STEPS = 16
LOADGEN_FLEET_S = 5.0            # the chaos window, driven by 4 sessions
LOADGEN_CHAOS_INTERVAL_S = 3.0
LOADGEN_PHASE_S = 2.0            # a traffic phase (the spike's edge half of it)
LOADGEN_TIMEOUT_S = 600
LOADGEN_STUB_WARMUP_S = 120      # a stub fleet's boot (seconds normally)
LOADGEN_STUB_TIMEOUT_S = 300     # the stub-only migration A/B (~12-25 s normally)
LOADGEN_VARIANTS = ("tensor_core", "tf32x3", "simple")


def _loadgen(args, outdir, name, timeout_s=LOADGEN_TIMEOUT_S):
    """One `python -m rt1_tpu_torch.serve.loadgen` run: its record (also at
    `outdir`/<output name>), its seconds and the replicas it reached."""
    metrics_path = os.path.join(outdir, f"replica_metrics_{name}.jsonl")
    lines, seconds = _run_cli([*args, "--replica_metrics", metrics_path], timeout_s,
                              module="rt1_tpu_torch.serve.loadgen")
    record = lines[-1]
    if record.get("requests_failed") != 0:
        raise AssertionError(f"loadgen {name}: requests_failed {record.get('requests_failed')}")
    replicas = []
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            replicas = [json.loads(line) for line in f if line.strip()]
    return record, seconds, replicas


def _replica_launches(row, on_card, what):
    """A replica's fused-attention launches by variant from its /metrics
    (`--replica_metrics` row); on the card exactly one variant launches,
    8 a batched engine step (warm-up included), the others 0."""
    if "error" in row:
        raise AssertionError(f"{what}: /metrics unreadable: {row['error']}")
    counts = {v: int(row[f"attention_launches_{v}_total"]) for v in LOADGEN_VARIANTS}
    steps = int(row["engine_steps_total"])
    if on_card:
        running = [v for v in LOADGEN_VARIANTS if counts[v]]
        if len(running) != 1 or counts[running[0]] != 8 * steps or steps <= 0:
            raise AssertionError(f"{what}: launches {counts}, expected 8 x {steps} of one variant")
    elif any(counts.values()):
        raise AssertionError(f"{what}: {counts} launches on the CPU")
    return {**counts, "engine_steps": steps}


def _mode_row(record, seconds, replicas, on_card, **keys):
    return {"p50_ms": record.get("latency_p50_ms"), "p99_ms": record.get("latency_p99_ms"),
            "req_per_sec": record.get("value") if record.get("unit") == "req/s" else None,
            "seconds": seconds, "requests_failed": record["requests_failed"],
            "launches": {r["label"]: _replica_launches(r, on_card, r["label"]) for r in replicas},
            **keys}


def _loadgen_lane_a(config_name, device, outdir, on_card):
    """The flags replica: its /healthz batcher, plain `--traced`,
    `--overhead_ab 2`; then `--occupancy_sweep --sweep_levels 1,8`."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "rt1_tpu_torch.serve", "--config", config_name, "--random_init",
           "--port", "0", "--device", device, "--inference_dtype", "bf16", *LOADGEN_FLAGS]
    modes = {}
    with tempfile.TemporaryFile(mode="w+") as errlog:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=errlog,
                                text=True)
        try:
            t0 = time.perf_counter()
            ready = _read_ready_line(proc, LOADGEN_TIMEOUT_S)
            startup_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{ready['port']}"
            _, health = _http(url + "/healthz")
            if health.get("batcher") != LOADGEN_BATCHER:
                raise AssertionError(f"loadgen: /healthz batcher {health.get('batcher')}, "
                                     f"expected {LOADGEN_BATCHER}")
            record, seconds, replicas = _loadgen(
                ["--url", url, "--sessions", str(LOADGEN_SESSIONS), "--steps",
                 str(LOADGEN_STEPS), "--traced", "--output",
                 os.path.join(outdir, "BENCH_serving.json"), "--slo_summary",
                 os.path.join(outdir, "slo_summary_traced.json")], outdir, "traced")
            if record["requests_ok"] != LOADGEN_SESSIONS * LOADGEN_STEPS or \
                    record["request_id_mismatches"] != 0:
                raise AssertionError(f"loadgen traced: {record['requests_ok']} ok, "
                                     f"{record['request_id_mismatches']} id mismatches")
            modes["traced"] = _mode_row(record, seconds, replicas, on_card,
                                        startup_s=startup_s,
                                        mean_batch_occupancy=record["mean_batch_occupancy"])
            record, seconds, replicas = _loadgen(
                ["--url", url, "--sessions", str(LOADGEN_SESSIONS), "--steps",
                 str(LOADGEN_STEPS), "--overhead_ab", "2", "--output",
                 os.path.join(outdir, "BENCH_serve_trace_overhead.json")], outdir, "overhead_ab")
            modes["overhead_ab"] = _mode_row(record, seconds, replicas, on_card,
                                             tracing_overhead_pct=record["value"],
                                             best_req_per_sec=record["best_req_per_sec"])
            proc.send_signal(signal.SIGTERM)
            if proc.wait(timeout=120) != 0:
                raise AssertionError(f"loadgen: flags replica exit code {proc.returncode}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            if proc.returncode not in (0, None):
                errlog.seek(0)
                sys.stderr.write(errlog.read()[-8000:])
    record, seconds, replicas = _loadgen(
        ["--occupancy_sweep", "--sweep_levels", "1,8", "--sweep_rounds", "1", "--steps",
         str(LOADGEN_SWEEP_STEPS), "--config", config_name, "--device", device,
         "--inference_dtype", "bf16", "--output",
         os.path.join(outdir, "BENCH_serve_batching.json")], outdir, "occupancy_sweep")
    if not record["compile_count_pinned_at_bucket_count"]:
        raise AssertionError(f"loadgen occupancy_sweep: compile counts {record['per_side']}")
    modes["occupancy_sweep"] = _mode_row(
        record, seconds, replicas, on_card, speedup_full=record["value"],
        per_level={side: {level: {k: row[k] for k in ("req_per_sec", "latency_p50_ms",
                                                        "latency_p99_ms",
                                                        "mean_batch_occupancy")}
                          for level, row in rec["levels"].items()}
                   for side, rec in record["per_side"].items()})
    return modes


def _loadgen_lane_b(config_name, device, outdir, on_card):
    """`--quant_ab bf16,int8` (f32 added as the reference)."""
    modes = {}
    record, seconds, replicas = _loadgen(
        ["--quant_ab", "bf16,int8", "--config", config_name, "--device", device,
         "--sessions", str(LOADGEN_SESSIONS), "--steps", str(LOADGEN_QUANT_STEPS),
         "--parity_steps", str(LOADGEN_PARITY_STEPS), "--byte_report_config", config_name,
         "--output", os.path.join(outdir, "BENCH_serve_quant.json")], outdir, "quant_ab")
    agreement = {d: row["parity"]["agreement"] for d, row in record["per_dtype"].items()}
    if min(agreement.values()) < 0.99:
        raise AssertionError(f"loadgen quant_ab: token agreement {agreement} < 0.99")
    modes["quant_ab"] = _mode_row(
        record, seconds, replicas, on_card, agreement=agreement,
        per_dtype={d: {k: row[k] for k in ("req_per_sec", "latency_p50_ms", "latency_p99_ms",
                                           "param_bytes_device")}
                   for d, row in record["per_dtype"].items()},
        int8_reduction=record["value"])
    return modes


def _loadgen_lane_c(config_name, device, outdir, on_card):
    """`--fleet 2 --faults replica_kill@1`, then `--migration_ab` on stub
    fleets."""
    modes = {}
    record, seconds, replicas = _loadgen(
        ["--fleet", "2", "--faults", "replica_kill@1", "--config", config_name, "--device",
         device, "--inference_dtype", "bf16", "--sessions", "4", "--duration",
         str(LOADGEN_FLEET_S), "--chaos_interval_s", str(LOADGEN_CHAOS_INTERVAL_S),
         "--traced", "--output", os.path.join(outdir, "BENCH_serve_fleet.json")],
        outdir, "fleet")
    if record["replica_restarts_total"] != 1 or record["replicas_ready_at_end"] != 2:
        raise AssertionError(f"loadgen fleet: {record['replica_restarts_total']} restarts, "
                             f"{record['replicas_ready_at_end']} ready at the end")
    modes["fleet"] = _mode_row(record, seconds, replicas, on_card,
                               restarted=record["requests_restarted"],
                               restarts=record["replica_restarts_total"])
    # Stub fleets (no card, no kernel), one attempt. A hang (one run sat
    # 600 s, ROADMAP C) ends at the time limit with every process's stacks
    # (`_run_cli`); a fleet that does not heal or drain in time is a
    # `timeout:` event of the record, and fails here.
    record, seconds, replicas = _loadgen(
        ["--migration_ab", "--sessions", "4", "--steps", "2",
         "--fleet_warmup_timeout_s", str(LOADGEN_STUB_WARMUP_S), "--output",
         os.path.join(outdir, "BENCH_serve_migration.json")], outdir, "migration_ab",
        timeout_s=LOADGEN_STUB_TIMEOUT_S)
    timeouts = {side: [e["event"] for e in s["events"] if e["event"].startswith("timeout:")]
                for side, s in record["sides"].items()}
    if any(timeouts.values()):
        raise AssertionError(f"loadgen migration_ab: waits that ran out {timeouts}")
    if not (record["zero_window_resets"] and record["token_identical_continuations"]):
        raise AssertionError(f"loadgen migration_ab: {record['value']} resets on the durable "
                             f"side, token identical {record['token_identical_continuations']}")
    modes["migration_ab"] = _mode_row(record, seconds, replicas, on_card,
                                      window_resets=record["value"],
                                      legacy_window_resets=record["legacy_window_resets"])
    return modes


def _loadgen_lane_d(config_name, device, outdir, on_card):
    """`--traffic_schedule spike` at 1-3 replicas (elastic) against 3
    (fixed)."""
    modes = {}
    record, seconds, replicas = _loadgen(
        ["--traffic_schedule", "spike", "--config", config_name, "--device", device,
         "--inference_dtype", "bf16", "--min_replicas", "1", "--max_replicas", "3",
         "--surge_dtype", "int8", "--phase_duration", str(LOADGEN_PHASE_S),
         "--schedule_base_sessions", "2", "--schedule_peak_sessions", "8", "--output",
         os.path.join(outdir, "BENCH_serve_elastic.json")], outdir, "traffic_schedule")
    sides = record["sides"]
    modes["traffic_schedule"] = _mode_row(
        record, seconds, replicas, on_card, cost_ratio=record["value"],
        peak_p99_ms={side: rec["spike"]["peak_p99_ms"] for side, rec in sides.items()},
        replicas_after={side: [row["replicas_after"] for row in rec["spike"]["phases"]]
                        for side, rec in sides.items()},
        scale_events=len(sides["elastic"]["spike"]["scale_events"]),
        compile_pinned=record["compile_pinned_at_bucket_count"])
    return modes


def phase_loadgen(config_name: str = "language_table", device: str = "cuda", outdir=None):
    """The load generator's seven modes against the port's replicas; every
    mode must report `requests_failed == 0`. Leaves its records in
    `outdir` for phase chaos's run report (a temporary directory, removed,
    when None)."""
    on_card = device == "cuda"
    own = outdir is None
    outdir = outdir or tempfile.mkdtemp(prefix="rt1_chip_smoke_loadgen_")
    lanes = {"a": _loadgen_lane_a, "b": _loadgen_lane_b, "c": _loadgen_lane_c,
             "d": _loadgen_lane_d}
    results, errors = {}, {}

    def run(name, lane):
        try:
            results[name] = lane(config_name, device, outdir, on_card)
        except BaseException as exc:  # noqa: BLE001 - re-raised below, named
            errors[name] = exc

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=item) for item in lanes.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    try:
        if errors:
            for name, exc in errors.items():
                print(f"loadgen lane {name}: {exc!r}", file=sys.stderr)
            raise AssertionError(f"loadgen: lanes {sorted(errors)} failed: "
                                 f"{next(iter(errors.values()))}")
        modes = {mode: row for lane in results.values() for mode, row in lane.items()}
        record = {"phase": "loadgen", "config": config_name, "device": device,
                  "nvidia_smi": nvidia_smi() if on_card else None, "modes": modes,
                  "wall_s": wall_s, "lanes": {k: list(v) for k, v in results.items()}}
        emit(record)
        return record
    finally:
        if own:
            shutil.rmtree(outdir, ignore_errors=True)


# The trainer's leftovers: the chaos drill, the run report over its
# workdir and over the load generator's records, a flagship fit with the
# photometric augmentation and a sweep trial, and the native episode reader.
CHAOS_FIT_STEPS = 3
CHAOS_READER_EPISODES = 16
CHAOS_REPORT_SECTIONS = {
    "train": ("## Where the hours went", "## Flight recorder", "## Last training scalars"),
    "serve": ("## Serve post-mortem",),
}


def _report_sections(text, wanted, what):
    """Each `wanted` heading's section of a run report, which must hold
    more than its not-found note."""
    out = {}
    for heading in wanted:
        if heading not in text:
            raise AssertionError(f"chaos: the {what} report has no {heading!r} section")
        body = text.split(heading, 1)[1].split("\n## ", 1)[0]
        if "not found" in body or "No metrics.jsonl" in body or "No serving artifacts" in body:
            raise AssertionError(f"chaos: the {what} report's {heading!r} section is empty:"
                                 f"{body[:400]}")
        out[heading.lstrip("# ")] = len(body.splitlines())
    return out


def _reader_check(root, config):
    """The native reader against `np.load` on seeded episodes (the data
    phase's writer, seed 0; each also saved compressed): equal arrays and
    dtypes, and reads a second each way."""
    import numpy as np

    from rt1_tpu_torch.data import episodes, native

    t0 = time.perf_counter()
    native.build_reader()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    paths = []
    for i in range(CHAOS_READER_EPISODES):
        ep = episodes.generate_synthetic_episode(rng, num_steps=DATA_STEPS)
        path = os.path.join(root, f"episode_{i:05d}.npz")
        episodes.save_episode(path, ep)
        paths.append(path)
        if i < 4:
            packed = os.path.join(root, f"compressed_{i:05d}.npz")
            np.savez_compressed(packed, **ep)
            paths.append(packed)
    for path in paths:
        mine = native.load_episode_native(path)
        with np.load(path) as z:
            ref = {k: z[k] for k in z.files}
        if sorted(mine) != sorted(ref) or any(
                mine[k].dtype != ref[k].dtype or not np.array_equal(mine[k], ref[k])
                for k in ref):
            raise AssertionError(f"chaos: the native reader differs from np.load on {path}")
    plain = [p for p in paths if "episode_" in p]
    rates = {}
    for kind, read in (("native", native.load_episode_native),
                       ("np_load", lambda p: dict(np.load(p)))):
        t0 = time.perf_counter()
        for path in plain:
            read(path)
        rates[f"{kind}_reads_per_s"] = len(plain) / (time.perf_counter() - t0)
    return {"files": len(paths), "compressed": 4, "build_s": build_s, **rates,
            "episode_bytes": os.path.getsize(plain[0])}


def phase_chaos(config_name: str = "language_table", device: str = "cuda", loadgen_dir=None):
    """The chaos drill, the run reports, a flagship fit with the photometric
    augmentation under sweep trial 1, and the native episode reader."""
    from rt1_tpu_torch.configs import SWEEPS, get_config
    from rt1_tpu_torch.obs import run_report
    from rt1_tpu_torch.resilience import chaos_train
    from rt1_tpu_torch.train.__main__ import main as train_main

    config = get_config(config_name)
    root = tempfile.mkdtemp(prefix="rt1_chip_smoke_chaos_")
    try:
        t0 = time.perf_counter()
        import io

        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            drill = chaos_train.main(["--workdir", os.path.join(root, "drill"), "--seed", "0",
                                      "--device", device])
        drill_s = time.perf_counter() - t0
        reports = {}
        chaos_dir = os.path.join(root, "drill", "chaos")
        text = run_report.main(["--workdir", chaos_dir, "--out",
                                os.path.join(root, "report_chaos.md")])
        reports["chaos_a"] = _report_sections(text, CHAOS_REPORT_SECTIONS["train"], "chaos A")
        if loadgen_dir is not None:
            text = run_report.main(["--workdir", loadgen_dir, "--out",
                                    os.path.join(root, "report_loadgen.md")])
            reports["loadgen"] = _report_sections(text, CHAOS_REPORT_SECTIONS["serve"],
                                                  "loadgen")
        from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

        # The flagship's sweep trial 1 (lr 5e-4, seed 42); `tiny` (the CPU
        # rehearsal) has no sweep.
        trial_args = ["--sweep_trial", "1"] if config_name in SWEEPS else []
        reset_launch_counts()
        lines, fit_s = _run_in_process(train_main, [
            "--config", config_name, "--device", device, "--workdir",
            os.path.join(root, "fit"), *trial_args,
            "--set", "model.photometric_augmentation=True",
            "--set", f"num_steps={CHAOS_FIT_STEPS}", "--set", "log_every_steps=1",
            "--set", f"checkpoint_every_steps={CHAOS_FIT_STEPS}",
            "--set", f"eval_every_steps={10 * CHAOS_FIT_STEPS}"])
        trial = next((r for r in lines if r.get("status") == "sweep_trial"), None)
        start = next(r for r in lines if r.get("status") == "start")
        if trial_args and (trial["overrides"] != {"learning_rate": 5e-4, "seed": 42}
                           or start["learning_rate"] != 5e-4):
            raise AssertionError(f"chaos: sweep trial 1 applied {trial}, trained at "
                                 f"{start['learning_rate']}")
        losses = [r["loss"] for r in lines if "loss" in r]
        steps = [r["step"] for r in lines if "loss" in r]
        if steps[-1:] != [CHAOS_FIT_STEPS] or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"chaos: the augmented fit logged steps {steps}, losses {losses}")
        reader = _reader_check(os.path.join(root, "reader"), config)
        record = {"phase": "chaos", "config": config_name, "device": device,
                  "drill": drill, "drill_s": drill_s, "reports": reports,
                  "fit": {"seconds": fit_s, "losses": losses,
                          "learning_rate": start["learning_rate"],
                          "attention_launches": dict(fused_attention.launches_by_variant)},
                  "reader": reader}
        emit(record)
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The moe phase: the flagship with the Switch-routed expert FFN (4 experts,
# capacity factor 2.0, expert hidden 512), and remat.
MOE_SETS = ("model.ffn_impl=moe",)
MOE_BUCKET = 8
MOE_WARMUP, MOE_TIMED, MOE_PROFILED = 3, 10, 3
MOE_TRAIN_STEPS = 3               # bf16 train steps at batch 8, each way of remat
MOE_ROUTE_AGREEMENT = 0.99        # routes of a session alone = beside 7 others
MOE_F32_LOSS_TOL = 1e-6           # relative: float32 loss with remat against without
MOE_F32_GRAD_TOL = 1e-6           # relative (norm of the difference): the float32 gradient
                                  # and the BatchNorm statistics, remat on against off
MOE_PARITY_EPISODES = 2           # canned episodes of window + 2 steps (JAX's gate: 4 x 8)


def _moe_config(config_name, *sets):
    from rt1_tpu_torch.configs import apply_override, get_config

    config = get_config(config_name)
    for assignment in MOE_SETS + sets:
        apply_override(config, assignment)
    return config


def _moe_routes(policy, run):
    """(run()'s result, the routes of each MoE layer call in order: (the
    float32 router's argmax (b, s), kept (b, s))), recorded by forward
    hooks; a dropped token's FFN output is exactly 0."""
    import torch

    from rt1_tpu_torch.models.moe import MoEFeedForward

    routes = []

    def hook(module, args, output):
        logits = torch.nn.functional.linear(args[0].float(), module.gate.weight.float())
        routes.append((logits.argmax(-1).cpu(), (output[0] != 0).any(-1).cpu()))

    hooks = [m.register_forward_hook(hook) for m in policy.modules()
             if isinstance(m, MoEFeedForward)]
    try:
        result = run()
    finally:
        for h in hooks:
            h.remove()
    return result, routes


def _moe_sessions(policy, dev, frames, emb):
    """Each session's step alone against the same step beside the others
    (per-session routing, the serving engine's): logits within the bf16
    tolerance, tokens equal wherever the top-2 gap exceeds twice it, and
    the routes (expert and kept) of at least MOE_ROUTE_AGREEMENT of the
    token-layer pairs identical; and the whole-bucket routing's drops
    beside the per-session ones."""
    import torch

    b = frames.shape[0]
    obs = {"image": torch.from_numpy(frames).to(dev),
           "natural_language_embedding": torch.from_numpy(emb).to(dev)}
    with torch.no_grad():
        (beside, _), r_beside = _moe_routes(
            policy, lambda: policy.infer_step(obs, policy.initial_state(b), per_row=True))
        (whole, _), r_whole = _moe_routes(
            policy, lambda: policy.infer_step(obs, policy.initial_state(b), per_row=False))
        alone = []
        for i in range(b):
            one = {k: v[i:i + 1] for k, v in obs.items()}
            (out, _), routes = _moe_routes(
                policy, lambda: policy.infer_step(one, policy.initial_state(1), per_row=True))
            alone.append((out, routes))
    logits = beside["action_logits"].float().cpu()
    bound = TOL["bfloat16"] * max(1.0, float(logits.abs().max()))
    diff, flips, same, total = 0.0, 0, 0, 0
    for i, (out, routes) in enumerate(alone):
        got = out["action_logits"][0].float().cpu()
        diff = max(diff, float((got - logits[i]).abs().max()))
        top2 = logits[i].topk(2, dim=-1).values
        agree = out["action_tokens"][0].cpu() == beside["action_tokens"][i].cpu()
        flips += int((~agree & (top2[..., 0] - top2[..., 1] > 2 * bound)).sum())
        for (e_all, k_all), (e_one, k_one) in zip(r_beside, routes):
            same += int(((e_all[i] == e_one[0]) & (k_all[i] == k_one[0])).sum())
            total += e_one[0].numel()
    record = {"sessions": b, "max_abs_logit_diff": diff, "bound": bound,
              "token_flips_beyond_bound": flips, "route_agreement": same / total,
              "routes_compared": total,
              "dropped_per_session_routing": int(sum(int((~k).sum()) for _, k in r_beside)),
              "dropped_whole_bucket_routing": int(sum(int((~k).sum()) for _, k in r_whole)),
              "whole_bucket_token_agreement": float(
                  (whole["action_tokens"] == beside["action_tokens"]).float().mean())}
    if diff > bound or flips or same / total < MOE_ROUTE_AGREEMENT:
        raise AssertionError(f"moe: a session alone differs from the same session beside "
                             f"{b - 1} others: {record}")
    return record


def _moe_train(config_name, dev, remat, dtype, batch, steps, keep=False):
    """`steps` train steps of the MoE flagship at `dtype` (float32 masters)
    on synthetic batches, dropout and stochastic depth on: losses,
    `moe_aux_loss`, step ms, peak card memory and the routers' gradient max
    on the last step. With `keep`, (that record, the last step's flat
    gradient, its routers' gradients by name, the BatchNorm statistics
    after the steps)."""
    import numpy as np
    import torch

    from rt1_tpu_torch.models.moe import router_names
    from rt1_tpu_torch.train.train import build_model, synthetic_batch
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config

    config = _moe_config(config_name, f"model.remat={remat}", f"model.dtype={dtype}",
                         f"per_host_batch_size={batch}", "obs.model_health=False")
    policy = build_model(config, dev)
    optimizer = optimizer_from_config(config)
    state = create_train_state(policy, optimizer)
    fns = train_step_fns_from_config(config, optimizer)
    batches = [synthetic_batch(config, config.seed, i, dev) for i in range(steps)]
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    walls, losses, aux = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = fns.train_step(state, batches[i], i, keep_grad=i == steps - 1)
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["moe_aux_loss"]))
    grads = fns.grads_by_name(state, metrics["grad"])
    routers = {n: grads[n] for n in router_names(policy)}
    router = {n: float(g.abs().max()) for n, g in routers.items()}
    record = {"remat": remat, "dtype": dtype, "batch": batch, "losses": losses,
              "moe_aux_loss": aux, "grad_norm": float(metrics["grad_norm"]),
              "step_ms": walls, "step_ms_median_after_first": float(np.median(walls[1:]))
              if steps > 1 else walls[0],
              "peak_memory_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda"
              else None,
              "router_grad_max": router}
    kept = (metrics["grad"], routers, state.flat_buffers.clone()) if keep else None
    del policy, state, fns, optimizer, batches, grads, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and np.isfinite(aux).all()):
        raise AssertionError(f"moe train: non-finite loss or aux loss: {record}")
    if len(router) != config.model.num_layers or not all(v > 0 for v in router.values()):
        raise AssertionError(f"moe train: a router got no gradient: {router}")
    return (record, *kept) if keep else record


def _rel_diff(a, b):
    """|a - b| / |b| in float64 (norms of tensors); 0 for two empty ones
    (`tiny` has no BatchNorm)."""
    import torch

    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    if a.numel() == b.numel() == 0:
        return 0.0
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase_moe(config_name: str = "language_table", device: str = "cuda"):
    """The flagship with `model.ffn_impl=moe` (4 experts, capacity 2.0,
    hidden 512) on its seeded random weights: a bf16 bucket-8 engine (fused
    attention; host ms, busy ms, 8 tensor-core launches a step), each
    session routed alone (`_moe_sessions`), the int8 and cached engines
    on the card against the same mode on the CPU through `serve/parity.py`
    at 0.99 in float32, JAX's two gates and the routes int8 changes
    (reported), each mode's resident bytes,
    the float32 `infer_step` on the card against the CPU (`phase_parity`:
    one tf32x3 launch a layer), and bf16 train steps at batch 8 with remat
    off and on (finite loss and aux loss, every router's gradient nonzero,
    step ms, peak memory lower with remat), then one float32 step each way
    (cuDNN deterministic) whose loss, flat gradient, routers' gradients and
    BatchNorm statistics must agree: what a broken recompute (masks drawn
    again, statistics updated twice) would change."""
    import numpy as np
    import torch

    from rt1_tpu_torch.eval.restore import master_policy, serving_engine
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts
    from rt1_tpu_torch.serve import parity

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    config = _moe_config(config_name)
    h, w = config.data.height, config.data.width
    shape = (h, w, 3)
    master, _ = master_policy(config, None, None, attention_impl="fused")
    layers = master.num_layers

    def engine(mode, compute, cached=False, on=dev, sessions=MOE_BUCKET):
        return serving_engine(copy.deepcopy(master), compute, on, inference_dtype=mode,
                              cached_inference=cached, max_sessions=sessions,
                              buckets=sorted({1, sessions}))

    # 1. The bf16 engine, bucket 8.
    eng = engine("f32", torch.bfloat16)
    rng = np.random.default_rng(7)
    frames = rng.uniform(0, 1, (MOE_BUCKET,) + shape).astype(np.float32)
    emb = rng.standard_normal((MOE_BUCKET, 512)).astype(np.float32)
    items = [(f"m-{i}", {"image": frames[i], "natural_language_embedding": emb[i]})
             for i in range(MOE_BUCKET)]
    reset_launch_counts()  # this drive's launches only
    steps0 = eng.steps_total
    for _ in range(MOE_WARMUP):
        eng.act_batch(items)
    walls = []
    for _ in range(MOE_TIMED):
        t0 = time.perf_counter()
        eng.act_batch(items)
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = device_profile(lambda: eng.act_batch(items), iters=MOE_PROFILED) if on_card else None
    steps = eng.steps_total - steps0
    launches = dict(fused_attention.launches_by_variant)
    expected = {"tensor_core": layers * steps if on_card else 0, "tf32x3": 0, "simple": 0}
    if launches != expected:
        raise AssertionError(f"moe serve: launches {launches}, expected {expected}")
    serve = {"bucket": MOE_BUCKET, "engine_steps": steps, "host_ms": _quantiles(walls),
             "launches_by_variant": launches,
             "tensor_core_per_step": launches["tensor_core"] / steps,
             "serving_param_bytes": eng.serving_param_bytes}
    if prof is not None:
        serve.update(device_busy_ms=prof["busy_ms"], profiled_wall_ms=prof["wall_ms"],
                     idle_share=1.0 - prof["busy_ms"] / prof["wall_ms"],
                     device_launches=prof["launches"])
    sessions = _moe_sessions(eng.policy, dev, frames, emb)
    bytes_by_mode = {"bf16": eng.serving_param_bytes}
    del eng
    gc.collect()

    # 2. The serving modes in float32: each of int8 and cached on the card
    # against the same mode on the CPU through serve/parity.py (>= 0.99);
    # JAX's own gates (int8 against f32, the cached fill against the
    # windowed engine) and the routes int8 changes, reported: an MoE's
    # argmax routing and per-call capacity turn int8 noise, and the cached
    # block's own capacity, into other experts (ROADMAP C; the readings
    # equal JAX's on the same weights, tests/test_torch_moe.py).
    window = config.model.time_sequence_length
    episodes = parity.canned_episodes(shape, episodes=MOE_PARITY_EPISODES, steps=window + 2)
    f32 = engine("f32", torch.float32)
    card_vs_cpu, jax_gates = {}, {}
    for mode, cached in (("int8", False), ("cached", True)):
        dtype = "int8" if mode == "int8" else "f32"
        card = engine(dtype, torch.float32, cached)
        cpu = engine(dtype, torch.float32, cached, on="cpu", sessions=1)
        t0 = time.perf_counter()
        stats = parity.action_token_agreement(card, cpu, episodes)
        card_vs_cpu[mode] = dict(stats, seconds=time.perf_counter() - t0)
        if mode == "int8":
            jax_gates["int8_vs_f32"] = parity.action_token_agreement(f32, card, episodes)
            with torch.no_grad():
                obs = {"image": torch.from_numpy(frames).to(dev),
                       "natural_language_embedding": torch.from_numpy(emb).to(dev)}
                _, r_f32 = _moe_routes(f32.policy, lambda: f32.policy.infer_step(
                    obs, f32.policy.initial_state(MOE_BUCKET), per_row=True))
                _, r_int8 = _moe_routes(card.policy, lambda: card.policy.infer_step(
                    obs, card.policy.initial_state(MOE_BUCKET), per_row=True))
            same = sum(int(((a == c) & (b == d)).sum()) for (a, b), (c, d) in zip(r_f32, r_int8))
            jax_gates["int8_vs_f32"]["route_agreement"] = same / sum(
                a.numel() for a, _ in r_f32)
            bytes_by_mode["int8"] = card.serving_param_bytes
        else:
            fill = [episode[:window] for episode in episodes]
            jax_gates["cached_vs_windowed_fill"] = parity.action_token_agreement(f32, card, fill)
            bytes_by_mode["cached_cache_per_slot"] = card.cache_bytes_per_slot
        del card, cpu
        gc.collect()
    bytes_by_mode["f32"] = f32.serving_param_bytes
    del f32, master
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    low = {m: s["agreement"] for m, s in card_vs_cpu.items()
           if s["agreement"] < parity.PARITY_THRESHOLD}
    if low:
        emit({"phase": "moe", "card_vs_cpu": card_vs_cpu, "failed": low})
        raise AssertionError(f"moe: card against CPU below {parity.PARITY_THRESHOLD}: {low}")

    # 3. Float32 infer_step, card vs CPU (its launch rule holds on a card).
    f32_parity = phase_parity(device, config_name, phase="moe_parity", sets=MOE_SETS) \
        if on_card else {"launches_by_variant": dict.fromkeys(expected, 0)}

    # 4. Training: bf16 at batch 8, remat off and on; float32 each way.
    train = {remat: _moe_train(config_name, dev, remat, "bfloat16", config.per_host_batch_size,
                               MOE_TRAIN_STEPS) for remat in (False, True)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        f32_train, kept = {}, {}
        for remat in (False, True):
            f32_train[remat], *kept[remat] = _moe_train(config_name, dev, remat, "float32", 2, 1,
                                                       keep=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (grad_off, routers_off, bn_off), (grad_on, routers_on, bn_on) = kept[False], kept[True]
    loss_off, loss_on = f32_train[False]["losses"][0], f32_train[True]["losses"][0]
    norm_off, norm_on = f32_train[False]["grad_norm"], f32_train[True]["grad_norm"]
    remat_check = {
        "peak_memory_bytes": {"off": train[False]["peak_memory_bytes"],
                              "on": train[True]["peak_memory_bytes"]},
        "f32_loss": {"off": loss_off, "on": loss_on,
                     "rel_diff": abs(loss_on - loss_off) / abs(loss_off)},
        "f32_grad_norm": {"off": norm_off, "on": norm_on,
                          "rel_diff": abs(norm_on - norm_off) / abs(norm_off)},
        "f32_grad_rel_diff": _rel_diff(grad_on, grad_off),
        "f32_router_grad_rel_diff": max(_rel_diff(routers_on[n], routers_off[n])
                                        for n in routers_off),
        "f32_batchnorm_stats_rel_diff": _rel_diff(bn_on, bn_off),
        "batchnorm_stats_numel": bn_off.numel(),
        "f32_grad_bit_equal": bool(torch.equal(grad_on, grad_off)),
        "tolerance": {"loss": MOE_F32_LOSS_TOL, "grad_and_stats": MOE_F32_GRAD_TOL},
    }
    del kept, grad_off, routers_off, bn_off, grad_on, routers_on, bn_on
    record = {"phase": "moe", "config": config_name, "sets": list(MOE_SETS),
              "nvidia_smi": nvidia_smi() if on_card else None, "serve": serve,
              "sessions": sessions,
              "card_vs_cpu": {"threshold": parity.PARITY_THRESHOLD, **card_vs_cpu},
              "jax_gates": jax_gates,
              "bytes_by_mode": bytes_by_mode,
              "f32_parity": {k: f32_parity[k] for k in (
                  "max_abs_logit_diff", "bound", "action_token_agreement",
                  "launches_by_variant") if k in f32_parity},
              "train": {"remat_off": train[False], "remat_on": train[True]},
              "f32_train": {"remat_off": f32_train[False], "remat_on": f32_train[True]},
              "remat": remat_check, "seconds": time.perf_counter() - t_phase}
    emit(record)
    if on_card and not train[True]["peak_memory_bytes"] < train[False]["peak_memory_bytes"]:
        raise AssertionError(f"moe: remat did not lower the peak memory: {remat_check}")
    if remat_check["f32_loss"]["rel_diff"] > MOE_F32_LOSS_TOL:
        raise AssertionError(f"moe: the float32 loss differs with remat: {remat_check}")
    off = {k: remat_check[k] for k in ("f32_grad_rel_diff", "f32_router_grad_rel_diff",
                                       "f32_batchnorm_stats_rel_diff")
           if not remat_check[k] <= MOE_F32_GRAD_TOL}
    if off:
        raise AssertionError(f"moe: remat changed the float32 gradient or statistics: {off}")
    return record


# The lava phase: the LAVA family at the reference's SequenceLAVMSE widths,
# through the train and eval CLIs' entries, in process.
LAVA_SETS = ("model.family=lava",)
LAVA_TRAIN_STEPS = 4
LAVA_EVAL_STEPS = 10
LAVA_CLIP_STEPS = 2
LAVA_CLIP_EPISODES = {"train": 4, "val": 1}
LAVA_CLIP_EPISODE_STEPS = 8
LAVA_CPU_BATCH = 2
LAVA_REL_TOL = 1e-4               # card vs CPU, float32 (TF32 off), of max|action|
LAVA_INSTRUCTION = "push the red star to the blue cube"


def _lava_card_vs_cpu(config_name, device, variant):
    """One float32 forward of the LAVA `variant` ((image encoder, language
    encoder)) at full width from the seeded init, on the card and on the
    CPU (TF32 off): outputs within LAVA_REL_TOL of their scale, and the
    card's forward ms."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.text.clip_bpe import default_tokenizer
    from rt1_tpu_torch.train.train import build_model

    image_encoder, lang_encoder = variant
    config = get_config(config_name)
    for assignment in LAVA_SETS + (f"model.lava.image_encoder={image_encoder}",
                                   f"model.lava.lang_encoder={lang_encoder}"):
        apply_override(config, assignment)
    b, t = LAVA_CPU_BATCH, config.model.time_sequence_length
    rng = np.random.default_rng(9)
    obs = {"rgb": rng.uniform(0, 1, (b, t, config.data.height, config.data.width, 3))
           .astype(np.float32),
           "natural_language_embedding": rng.standard_normal((b, t, 512)).astype(np.float32)}
    if lang_encoder == "clip":
        tokens = default_tokenizer(config.model.lava.text_context).tokenize_text(
            [LAVA_INSTRUCTION, "Move the green circle left"])
        obs["instruction_tokenized_clip"] = np.repeat(tokens[:, None], t, axis=1)
    outs = {}
    for dev in (device, "cpu"):
        policy = build_model(config, dev).eval()
        inputs = {k: torch.from_numpy(v).to(dev) for k, v in obs.items()}
        with torch.no_grad():
            policy(inputs)  # warm: cuDNN's first call picks its algorithms
            _sync(torch.device(dev))
            t0 = time.perf_counter()
            out = policy(inputs)
            _sync(torch.device(dev))
        outs[dev] = (out.double().cpu(), (time.perf_counter() - t0) * 1e3)
        del policy
    (got, card_ms), (ref, cpu_ms) = outs[device], outs["cpu"]
    scale = float(ref.abs().max())
    diff = float((got - ref).abs().max())
    record = {"image_encoder": image_encoder, "lang_encoder": lang_encoder, "batch": b,
              "max_abs_diff": diff, "max_abs_output": scale, "bound": LAVA_REL_TOL * scale,
              "forward_ms": {"card": card_ms, "cpu": cpu_ms}}
    if not (torch.isfinite(got).all() and diff <= LAVA_REL_TOL * scale):
        raise AssertionError(f"lava {variant}: card vs CPU {record}")
    return record


def _lava_clip_corpus(root):
    """Seeded episodes (180x320) with their instruction text, for the
    "clip" encoder's tokens."""
    import numpy as np

    from rt1_tpu_torch.data import episodes

    rng = np.random.default_rng(11)
    for split, n in LAVA_CLIP_EPISODES.items():
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            ep = episodes.generate_synthetic_episode(rng, num_steps=LAVA_CLIP_EPISODE_STEPS)
            ep["instruction_text"] = episodes.encode_instruction_text(LAVA_INSTRUCTION)
            episodes.save_episode(os.path.join(root, split, f"episode_{i:05d}.npz"), ep)


def phase_lava(config_name: str = "language_table", device: str = "cuda"):
    """LAVA at the reference's widths (d_model 128, 2 + 2 layers, pyramid
    (2, 3, 4), dense ResNet 256 x 8, 256x456, window 6, batch 8, float32):
    `python -m rt1_tpu_torch.train --set model.family=lava` (its `main`, in
    process) for 4 steps and a checkpoint; `python -m rt1_tpu_torch.eval`
    from it, 1 episode of at most 10 steps, with the control step's ms;
    the "clip" variant with `data.clip_tokens=true` on the byte-level
    tokenizer for 2 steps from seeded episodes; and each of the three
    variants (conv_maxpool, clip, resnet) once on the card against the CPU."""
    import numpy as np
    import torch

    from rt1_tpu_torch.eval import main as eval_main
    from rt1_tpu_torch.eval.policy import LavaEvalPolicy
    from rt1_tpu_torch.train.__main__ import main as train_main

    dev = torch.device(device)
    t_phase = time.perf_counter()
    sets = [x for a in LAVA_SETS for x in ("--set", a)]
    with tempfile.TemporaryDirectory() as root:
        workdir = os.path.join(root, "lava")
        base = ["--config", config_name, "--workdir", workdir, "--device", device] + sets
        train, train_s = _run_in_process(train_main, base + [
            "--set", f"num_steps={LAVA_TRAIN_STEPS}", "--set", "checkpoint_every_steps=4",
            "--set", "eval_every_steps=4", "--set", "eval_batches=1",
            "--set", "log_every_steps=2"])
        start = next(x for x in train if x.get("status") == "start")
        losses = [x["loss"] for x in train if "loss" in x]
        evals = [x["eval_loss"] for x in train if "eval_loss" in x]
        if (start["compute_dtype"] != "float32" or not losses or not evals
                or not np.isfinite(losses + evals).all() or train[-1].get("checkpoint_step") != 4):
            raise AssertionError(f"lava train CLI: {start}; losses {losses}; evals {evals}; "
                                 f"{train[-1]}")
        # The eval CLI, its control steps timed in place.
        control_ms = []
        action = LavaEvalPolicy.action

        def timed_action(self, observation):
            t0 = time.perf_counter()
            out = action(self, observation)
            control_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        LavaEvalPolicy.action = timed_action
        try:
            result, eval_s = _run_in_process(eval_main.main, [
                "--config", config_name, "--workdir", workdir, "--device", device, *sets,
                "--episodes", "1", "--max_steps", str(LAVA_EVAL_STEPS)])
        finally:
            LavaEvalPolicy.action = action
        result = result[-1]
        if result.get("checkpoint_step") != 4 or not 1 <= len(control_ms) <= LAVA_EVAL_STEPS:
            raise AssertionError(f"lava eval CLI: {result}, {len(control_ms)} control steps")
        # The clip variant from episode files.
        data_dir = os.path.join(root, "clip_data")
        _lava_clip_corpus(data_dir)
        clip, clip_s = _run_in_process(train_main, [
            "--config", config_name, "--workdir", os.path.join(root, "clip"),
            "--device", device, *sets, "--set", "model.lava.lang_encoder=clip",
            "--set", "data.clip_tokens=true", "--set", f"data.data_dir={data_dir}",
            "--set", "data.loader=numpy", "--set", f"num_steps={LAVA_CLIP_STEPS}",
            "--set", "checkpoint_every_steps=2", "--set", "eval_every_steps=2",
            "--set", "eval_batches=1", "--set", "log_every_steps=1"])
        clip_losses = [x["loss"] for x in clip if "loss" in x]
        if len(clip_losses) != LAVA_CLIP_STEPS or not np.isfinite(clip_losses).all() \
                or clip[-1].get("checkpoint_step") != LAVA_CLIP_STEPS:
            raise AssertionError(f"lava clip train CLI: {clip_losses}; {clip[-1]}")
    card_vs_cpu = [_lava_card_vs_cpu(config_name, device, v) for v in (
        ("conv_maxpool", "embedding_in_obs"), ("conv_maxpool", "clip"),
        ("resnet", "embedding_in_obs"))]
    record = {"phase": "lava", "config": config_name, "sets": list(LAVA_SETS),
              "nvidia_smi": nvidia_smi() if dev.type == "cuda" else None,
              "train_cli": {"seconds": train_s, "losses": losses, "eval_losses": evals,
                            "parameters": start["parameters"],
                            "checkpoint_step": train[-1]["checkpoint_step"]},
              "eval_cli": {"seconds": eval_s, "result": result,
                           "control_steps": len(control_ms), "control_ms": _quantiles(control_ms)},
              "clip_train_cli": {"seconds": clip_s, "losses": clip_losses,
                                 "tokenizer_vocab": 514},
              "card_vs_cpu": card_vs_cpu, "tolerance_rel": LAVA_REL_TOL,
              "seconds": time.perf_counter() - t_phase}
    emit(record)
    return record


PARALLEL_STEPS = 3                # flagship bf16 train steps at batch 8, each way
PARALLEL_BUCKET = 8
PARALLEL_ENGINE_STEPS = 2         # bucket-8 engine steps of each restored engine
PARALLEL_CLI = ("--standalone", "--nproc_per_node", "1", "-m", "rt1_tpu_torch.train",
                "--config", "tiny", "--set", "parallel.distributed.enabled=true",
                "--set", "checkpoint_every_steps=2", "--set", "eval_every_steps=2")
PARALLEL_CLI_TIMEOUT_S = 300
PARALLEL_SAVE_TIMEOUT_S = 300


def _parallel_fsdp_save(rank, world, init, workdir, config_name):
    """One rank of the host CPU's gloo group: the flagship's state from
    seed 0, no step, under fsdp=`world`, saved sharded as step 0. A spawn
    target (this module is its child's main)."""
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))  # beside (a) and (b)
    sys.path.insert(0, REPO)
    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.parallel import distributed, mesh
    from rt1_tpu_torch.parallel.plan import ShardingPlan
    from rt1_tpu_torch.train.train import build_model
    from rt1_tpu_torch.trainer.checkpoints import CheckpointManager
    from rt1_tpu_torch.trainer.state import create_train_state, shard_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config

    config = get_config(config_name)
    for assignment in ("seed=0", f"parallel.fsdp={world}", "parallel.distributed.enabled=true",
                       f"parallel.distributed.coordinator_address=file://{init}",
                       f"parallel.distributed.process_id={rank}",
                       f"parallel.distributed.num_processes={world}"):
        apply_override(config, assignment)
    distributed.initialize_from_config(config, device="cpu")
    try:
        grid = mesh.RankGrid(ShardingPlan.from_config(config).mesh)
        state = create_train_state(build_model(config, "cpu"), optimizer_from_config(config))
        shard_train_state(state, grid.index("fsdp"), grid.size("fsdp"))
        CheckpointManager(os.path.join(workdir, "checkpoints"), grid=grid).save(0, state)
    finally:
        distributed.shutdown()


def _parallel_world_one(config_name, dev, root):
    """(a) An NCCL world of one, in this process: PARALLEL_STEPS flagship
    bf16 train steps at batch 8 under parallel.dp=1 through the collective
    path (`TrainStepFns(grid=...)`: the gradient all-reduced, the loss and
    monitors reduced, on a one-rank group) against the same steps without a
    process group, from the same weights and batches, cuDNN deterministic:
    loss, flat gradient, BatchNorm statistics and updated masters equal bit
    for bit; each step timed both ways (CUDA-synchronised wall ms)."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.parallel import distributed, mesh
    from rt1_tpu_torch.parallel.plan import ShardingPlan
    from rt1_tpu_torch.train.train import build_model, synthetic_batch
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config

    config = get_config(config_name)
    config.obs.model_health = False  # phase train's step
    for assignment in ("parallel.dp=1", "parallel.distributed.enabled=true",
                       f"parallel.distributed.coordinator_address=file://{root}/nccl_init",
                       "parallel.distributed.process_id=0",
                       "parallel.distributed.num_processes=1"):
        apply_override(config, assignment)
    if not distributed.initialize_from_config(config, dev):
        raise AssertionError("parallel: the NCCL world of one did not initialise")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        import torch.distributed as dist

        backend = dist.get_backend()
        grid = mesh.RankGrid(ShardingPlan.from_config(config).mesh)
        if not grid.distributed or grid.world != 1:
            raise AssertionError(f"parallel: {grid}")
        runs = {}
        for way, g in (("plain", None), ("collective", grid)):
            optimizer = optimizer_from_config(config)
            state = create_train_state(build_model(config, dev), optimizer)
            runs[way] = (state, train_step_fns_from_config(config, optimizer, grid=g))
        batches = [synthetic_batch(config, config.seed, i, dev) for i in range(PARALLEL_STEPS)]
        walls = {"plain": [], "collective": []}
        equal, losses = [], []
        for step in range(PARALLEL_STEPS):
            out = {}
            order = ("plain", "collective") if step % 2 == 0 else ("collective", "plain")
            for way in order:
                state, fns = runs[way]
                _sync(dev)
                t0 = time.perf_counter()
                metrics = fns.train_step(state, batches[step], step, keep_grad=True)
                _sync(dev)
                walls[way].append((time.perf_counter() - t0) * 1e3)
                out[way] = (metrics, state)
            (mp, sp), (mc, sc) = out["plain"], out["collective"]
            same = {"loss": torch.equal(mp["loss"], mc["loss"]),
                    "grad": torch.equal(mp["grad"], mc["grad"]),
                    "grad_norm": torch.equal(mp["grad_norm"], mc["grad_norm"]),
                    "batch_stats": torch.equal(sp.flat_buffers, sc.flat_buffers),
                    "masters": torch.equal(sp.flat, sc.flat)}
            equal.append(same)
            losses.append(float(mp["loss"]))
            if not all(same.values()) or not torch.isfinite(mp["loss"]):
                raise AssertionError(f"parallel: the NCCL world-1 step {step} differs from the "
                                     f"plain step: {same}, loss {float(mp['loss'])} / "
                                     f"{float(mc['loss'])}")
        record = {"backend": backend, "steps": PARALLEL_STEPS, "equal": equal, "losses": losses,
                  "step_ms": {way: {"all": w, "median_after_first": float(np.median(w[1:]))}
                              for way, w in walls.items()}}
        del runs, batches, out, mp, mc, sp, sc
        return record
    finally:
        torch.backends.cudnn.deterministic = deterministic
        distributed.shutdown()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _parallel_launcher(device, root):
    """(b) `python -m torch.distributed.run --nproc_per_node 1` on the train
    CLI (the smoke config on the card, NCCL) through `_run_cli`'s
    process-group guard: 2 steps and a sharded checkpoint; then the CLI's
    `main` in this process, in an NCCL world of one of its own (a `file://`
    rendezvous), to step 3, resuming step 2 (a process start fewer)."""
    from rt1_tpu_torch.parallel import distributed
    from rt1_tpu_torch.train.__main__ import main as train_main

    workdir = os.path.join(root, "launched")
    base = list(PARALLEL_CLI) + ["--workdir", workdir, "--device", device]
    first, first_s = _run_cli(base + ["--set", "num_steps=2"], PARALLEL_CLI_TIMEOUT_S,
                              module="torch.distributed.run")
    start = next(x for x in first if x.get("status") == "start")
    manifest_path = os.path.join(workdir, "checkpoints", "2", "manifest.json")
    if start.get("world") != 1 or first[-1].get("checkpoint_step") != 2 \
            or not os.path.isfile(manifest_path):
        raise AssertionError(f"parallel launcher: {start}; {first[-1]}")
    with open(manifest_path) as f:
        manifest = json.load(f)
    cli = base[base.index("-m") + 2:]   # the train CLI's own arguments
    try:
        second, second_s = _run_in_process(train_main, cli + [
            "--set", "num_steps=3", "--set",
            f"parallel.distributed.coordinator_address=file://{root}/resume_init",
            "--set", "parallel.distributed.process_id=0",
            "--set", "parallel.distributed.num_processes=1"])
    finally:
        distributed.shutdown()
    start2 = next(x for x in second if x.get("status") == "start")
    if start2.get("restored_step") != 2 or second[-1].get("step") != 3 \
            or second[-1].get("updates") != 3:
        raise AssertionError(f"parallel launcher resume: {start2}; {second[-1]}")
    return {"seconds": [first_s, second_s], "start": start, "manifest_world": manifest["world"],
            "restored_step": start2["restored_step"], "done": second[-1]}


class _ParallelSave:
    """(c)'s first half, started before (a) so the host's gloo group writes
    the fsdp=2 checkpoint while the card runs (a) and (b)."""

    def __init__(self, config_name, root):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.t0 = time.perf_counter()
        self.procs = [ctx.Process(target=_parallel_fsdp_save,
                                  args=(r, 2, os.path.join(root, "gloo_init"),
                                        os.path.join(root, "sharded"), config_name))
                      for r in range(2)]
        for p in self.procs:
            p.start()

    def join(self) -> float:
        """Seconds from the start to the last rank's exit; raises unless
        both saved."""
        for p in self.procs:
            p.join(PARALLEL_SAVE_TIMEOUT_S)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in self.procs):
            raise AssertionError(f"parallel: the gloo fsdp=2 save failed: "
                                 f"{[p.exitcode for p in self.procs]}")
        return time.perf_counter() - self.t0

    def join_quietly(self) -> None:
        """No rank outlives the phase, whatever failed first."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()


def _serve_checkpoint(config, wide, dev, sharded, plain, step):
    """The checkpoint `step` of workdir `sharded` (written under a plan
    `wide` asks for, which one card cannot hold: plain placement) served
    on `dev` beside the same state's one-file checkpoint in `plain`: a
    bf16 bucket-8 engine (PARALLEL_ENGINE_STEPS steps and one
    `infer_step`) and a float32 `infer_step` each way, cuDNN
    deterministic. Logits and actions must be equal bit for bit, with 8
    tensor-core launches a bf16 engine step and 8 tf32x3 launches the
    float32 step on the card (0 on the CPU: the plain path)."""
    import numpy as np
    import torch

    from rt1_tpu_torch.eval.restore import build_serve_engine, config_with_model_dtype
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    rng = np.random.default_rng(3)
    h, w = config.data.height, config.data.width
    frames = rng.uniform(0, 1, (PARALLEL_BUCKET, h, w, 3)).astype(np.float32)
    emb = rng.standard_normal((PARALLEL_BUCKET, 512)).astype(np.float32)
    items = [(f"p-{i}", {"image": frames[i], "natural_language_embedding": emb[i]})
             for i in range(PARALLEL_BUCKET)]
    obs = {"image": torch.from_numpy(frames).to(dev),
           "natural_language_embedding": torch.from_numpy(emb).to(dev)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name, cfg, workdir in (("sharded", wide, sharded), ("plain", config, plain)):
            engine, restored = build_serve_engine(cfg, workdir=workdir, device=dev, step=step,
                                                  attention_impl="fused",
                                                  max_sessions=PARALLEL_BUCKET,
                                                  buckets=(1, PARALLEL_BUCKET))
            reset_launch_counts()   # this engine's drive only (its warm-up included)
            steps0 = engine.steps_total
            actions = [engine.act_batch(items) for _ in range(PARALLEL_ENGINE_STEPS)]
            engine_steps = engine.steps_total - steps0
            _sync(dev)
            bf16_launches = dict(fused_attention.launches_by_variant)
            with torch.no_grad():
                logits = engine.policy.infer_step(
                    obs, engine.policy.initial_state(PARALLEL_BUCKET))[0]["action_logits"]
            del engine
            f32, _ = build_serve_engine(config_with_model_dtype(cfg, "float32"), workdir=workdir,
                                        device=dev, step=step, attention_impl="fused",
                                        max_sessions=PARALLEL_BUCKET,
                                        buckets=(PARALLEL_BUCKET,))
            reset_launch_counts()
            with torch.no_grad():
                f32_logits = f32.policy.infer_step(
                    obs, f32.policy.initial_state(PARALLEL_BUCKET))[0]["action_logits"]
            _sync(dev)
            f32_launches = dict(fused_attention.launches_by_variant)
            del f32
            out[name] = dict(step=restored, actions=actions, logits=logits.float().cpu(),
                             f32_logits=f32_logits.float().cpu(), engine_steps=engine_steps,
                             bf16_launches=bf16_launches, f32_launches=f32_launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    a, b = out["sharded"], out["plain"]
    layers = config.model.num_layers if dev.type == "cuda" else 0   # the CPU runs the plain path
    same_actions = all(
        np.array_equal(x["action"], y["action"]) and np.array_equal(x["action_tokens"],
                                                                    y["action_tokens"])
        for sa, sb in zip(a["actions"], b["actions"]) for x, y in zip(sa, sb))
    checks = {
        "bf16_logits_equal": torch.equal(a["logits"], b["logits"]),
        "f32_logits_equal": torch.equal(a["f32_logits"], b["f32_logits"]),
        "actions_equal": same_actions,
        "finite": bool(torch.isfinite(a["logits"]).all() and torch.isfinite(a["f32_logits"]).all()),
    }
    expected_bf16 = {"tensor_core": layers * a["engine_steps"], "tf32x3": 0, "simple": 0}
    expected_f32 = {"tensor_core": 0, "tf32x3": layers, "simple": 0}
    if not all(checks.values()) or a["bf16_launches"] != expected_bf16 \
            or a["f32_launches"] != expected_f32 or a["step"] != step:
        raise AssertionError(f"parallel serving of {sharded}: {checks}; launches "
                             f"{a['bf16_launches']} (expected {expected_bf16}), "
                             f"{a['f32_launches']} (expected {expected_f32}); step {a['step']}")
    return {"checks": checks, "engine_steps": a["engine_steps"],
            "bf16_launches": a["bf16_launches"], "f32_launches": a["f32_launches"],
            "tensor_core_per_engine_step": config.model.num_layers,
            "max_abs_logit": float(a["logits"].abs().max())}


def _parallel_migration(config_name, dev, root, saving):
    """(c) A 2-rank gloo group on the host CPU writes the flagship's seed-0
    state under fsdp=2 (`saving`, started with the phase); the card serves
    it beside the unsharded state's one-file checkpoint
    (`_serve_checkpoint`)."""
    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.train.train import build_model
    from rt1_tpu_torch.trainer.checkpoints import CheckpointManager
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config

    sharded, plain = os.path.join(root, "sharded"), os.path.join(root, "plain")
    save_s = saving.join()
    with open(os.path.join(sharded, "checkpoints", "0", "manifest.json")) as f:
        manifest = json.load(f)
    config = get_config(config_name)
    apply_override(config, "seed=0")
    state = create_train_state(build_model(config, "cpu"), optimizer_from_config(config))
    CheckpointManager(os.path.join(plain, "checkpoints")).save(0, state)
    del state
    wide = copy.deepcopy(config)
    apply_override(wide, "parallel.fsdp=2")   # a plan one card cannot hold: plain placement
    served = _serve_checkpoint(config, wide, dev, sharded, plain, 0)
    return {"save_s": save_s, "manifest": {k: manifest[k] for k in ("world", "fsdp", "mesh",
                                                                       "padded_size")},
            **served}


# (d) Tensor- and pipeline-parallel pairs at the flagship's widths against
# the world of one on the same seed-0 weights and batch (drawn on the CPU):
# float32, batch 2, one step, randomness off (the CPU tests' settings), TF32
# off and cuDNN deterministic on the card.
PARALLEL_PAIR_SETS = ("seed=0", "model.dtype=float32", "model.dropout_rate=0",
                      "regularization.crop_ratio=0", "regularization.drop_connect_rate=0",
                      "obs.model_health=False", "per_host_batch_size=2",
                      "model.pipeline_microbatches=2")
# name -> (the plan's sets, where the pair runs). The tp pair runs on the
# card over gloo, both ranks on cuda:0 (NCCL takes one device a rank;
# gloo's all-reduce and all-gather take CUDA tensors), so its bf16 eval
# step runs the fused kernel on 4 heads a rank; the pp pair runs on the
# host CPU (gloo sends no CUDA tensor point to point).
PARALLEL_PAIRS = {"tp": (("parallel.tp=2", "model.attention_impl=fused"), "card"),
                  "pp": (("parallel.pp=2",), "host")}
PARALLEL_EVAL_ROWS = 8              # the tp pair's bf16 eval step, at the flagship's batch
# The CPU tests' tolerances (`tests/test_torch_parallel_step.py`: loss,
# GRAD_TOL_B3 of the largest gradient element, grad norm), each pair against
# a world of one on its own device (the card's and the host's float32
# differ by 2.1e-5 in this step's gradient norm on an H100). The
# bf16 eval loss against the world of one's, relative (the row-parallel
# all-reduce adds bf16 partial sums).
PARALLEL_PAIR_TOL = {"loss": 1e-5, "grad": 2e-4, "grad_norm": 1e-5, "eval_loss_bf16": 1e-2}
PARALLEL_PAIR_TIMEOUT_S = 600


def _pair_config(config_name, sets):
    from rt1_tpu_torch.configs import apply_override, get_config

    config = get_config(config_name)
    for assignment in PARALLEL_PAIR_SETS + tuple(sets):
        apply_override(config, assignment)
    return config


def _pair_run(config_name, name, device, world, root):
    """One rank of pair `name` (world 2, in an initialised process group)
    or its world of one (world 1): the seed-0 state, one train step with
    the flat gradient kept, the pair's sharded checkpoint as step 1, and
    for the tp pair a bf16 eval step of PARALLEL_EVAL_ROWS rows on the
    updated masters with its fused-attention launches counted."""
    import torch

    from rt1_tpu_torch.configs import apply_override
    from rt1_tpu_torch.parallel import mesh
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts
    from rt1_tpu_torch.parallel.partition import partition_policy
    from rt1_tpu_torch.parallel.plan import ShardingPlan
    from rt1_tpu_torch.train.train import build_model, synthetic_batch
    from rt1_tpu_torch.trainer.checkpoints import CheckpointManager
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config

    dev = torch.device(device)
    sets = PARALLEL_PAIRS[name][0]
    config = _pair_config(config_name, sets if world > 1 else
                          [a for a in sets if not a.startswith("parallel.")])
    saved_flags = (torch.backends.cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    grid = partition = None
    try:
        t0 = time.perf_counter()
        policy = build_model(config, dev)
        if world > 1:
            plan = ShardingPlan.from_config(config)
            grid = mesh.RankGrid(plan.mesh)
            mesh.set_current(grid)
            partition = partition_policy(policy, grid, plan, config.model.pipeline_microbatches)
        optimizer = optimizer_from_config(config)
        state = create_train_state(policy, optimizer, partition)
        fns = train_step_fns_from_config(config, optimizer, grid=grid)
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = tuple({k: v.to(dev) for k, v in tree.items()}
                      for tree in synthetic_batch(config, config.seed, 0, "cpu"))
        metrics = fns.train_step(state, batch, 0, keep_grad=True)
        record = {"name": name, "world": world, "device": str(dev),
                  "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                  "grad": metrics["grad"].detach().cpu(), "init_s": init_s,
                  "step_s": time.perf_counter() - t0}
        if partition is not None:
            record["partition"] = partition.to_manifest()
            record["part"] = (partition.stage_index, partition.model_index)
            t0 = time.perf_counter()
            CheckpointManager(os.path.join(root, f"pair_{name}", "checkpoints"),
                              grid=grid).save(1, state)
            record["save_s"] = time.perf_counter() - t0
        if "model.attention_impl=fused" in sets:
            bf16 = copy.deepcopy(config)
            apply_override(bf16, "model.dtype=bfloat16")
            apply_override(bf16, f"per_host_batch_size={PARALLEL_EVAL_ROWS}")
            eval_fns = train_step_fns_from_config(bf16, optimizer, grid=grid)
            batch = tuple({k: v.to(dev) for k, v in tree.items()}
                          for tree in synthetic_batch(bf16, config.seed + 1, 0, "cpu"))
            reset_launch_counts()
            out = eval_fns.eval_step(state, batch)
            _sync(dev)
            record["eval_loss"] = float(out["loss"])
            record["eval_launches"] = dict(fused_attention.launches_by_variant)
        return record
    finally:
        mesh.set_current(None)
        (torch.backends.cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved_flags


def _parallel_pair(rank, world, init, root, config_name, name, device):
    """A spawn target: `_pair_run` in a gloo group of `world` ranks (none
    for world 1), its record saved under `root`."""
    import torch

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world)
    try:
        record = _pair_run(config_name, name, device, world, root)
        torch.save(record, os.path.join(root, f"pair_{name}_{rank}_of_{world}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _PairGroup:
    """(d) Pair `name`'s two ranks (and, with `reference`, its world of
    one) as spawned processes on `device`, started at once."""

    def __init__(self, config_name, root, name, device, reference=False):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.root, self.name, self.t0 = root, name, time.perf_counter()
        init = os.path.join(root, f"pair_{name}_init")
        jobs = [(r, 2) for r in range(2)] + ([(0, 1)] if reference else [])
        self.files = [os.path.join(root, f"pair_{name}_{r}_of_{w}.pt") for r, w in jobs]
        self.procs = [ctx.Process(target=_parallel_pair,
                                  args=(r, w, init, root, config_name, name, device))
                      for r, w in jobs]
        for p in self.procs:
            p.start()

    def join(self):
        """(the records in job order, seconds from the start to the last
        exit); raises unless every process wrote its record."""
        import torch

        for p in self.procs:
            p.join(PARALLEL_PAIR_TIMEOUT_S)
        self.join_quietly()
        if any(p.exitcode != 0 for p in self.procs) or \
                not all(os.path.isfile(f) for f in self.files):
            raise AssertionError(f"parallel: pair {self.name} failed: "
                                 f"{[p.exitcode for p in self.procs]}")
        return ([torch.load(f, weights_only=False) for f in self.files],
                time.perf_counter() - self.t0)

    def join_quietly(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()


def _logical_grad(records):
    """The world of one's flat gradient from a pair's two parts."""
    from rt1_tpu_torch.parallel.partition import Partition

    partition = Partition.from_manifest(records[0]["partition"])
    return partition.logical_flat({tuple(r["part"]): r["grad"] for r in records})


def _check_pair(name, records, seconds, reference):
    """(d) A pair's loss, flat gradient and gradient norm (and the tp
    pair's bf16 eval loss and launches) against the world of one."""
    grad, ref = _logical_grad(records), reference["grad"]
    scale = float(ref.abs().max())
    errors = {"loss": max(abs(r["loss"] - reference["loss"]) / abs(reference["loss"])
                          for r in records),
              "grad": float((grad - ref).abs().max()) / scale,
              "grad_norm": max(abs(r["grad_norm"] - reference["grad_norm"]) /
                               reference["grad_norm"] for r in records)}
    if "eval_loss" in records[0]:
        errors["eval_loss_bf16"] = max(abs(r["eval_loss"] - reference["eval_loss"]) /
                                       abs(reference["eval_loss"]) for r in records)
    record = {"where": records[0]["device"], "reference_where": reference["device"],
              "losses": [r["loss"] for r in records],
              "reference_loss": reference["loss"], "max_err": errors, "tol": PARALLEL_PAIR_TOL,
              "grad_scale": scale, "step_s": [r["step_s"] for r in records],
              "reference_step_s": reference["step_s"], "save_s": [r["save_s"] for r in records],
              "seconds": seconds, "part_numel": [int(r["grad"].numel()) for r in records],
              "world_one_numel": int(ref.numel())}
    if "eval_launches" in records[0]:
        record["eval_launches"] = [r["eval_launches"] for r in records]
        record["reference_eval_launches"] = reference["eval_launches"]
        record["eval_loss"] = [r["eval_loss"] for r in records]
        record["reference_eval_loss"] = reference["eval_loss"]
    bad = {k: v for k, v in errors.items() if not v <= PARALLEL_PAIR_TOL[k]}
    if bad:
        raise AssertionError(f"parallel pair {name}: errors {bad} beyond {PARALLEL_PAIR_TOL}")
    return record


def _serve_pair(config_name, dev, root, name):
    """(e) Pair `name`'s checkpoint served on `dev` beside the same state
    restored at world one and saved in the one-file format."""
    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.train.train import build_model
    from rt1_tpu_torch.trainer.checkpoints import CheckpointManager
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config

    sharded, plain = os.path.join(root, f"pair_{name}"), os.path.join(root, f"plain_{name}")
    with open(os.path.join(sharded, "checkpoints", "1", "manifest.json")) as f:
        manifest = json.load(f)
    config = get_config(config_name)
    apply_override(config, "seed=0")
    state = create_train_state(build_model(config, "cpu"), optimizer_from_config(config))
    CheckpointManager(os.path.join(sharded, "checkpoints")).restore(state, 1)
    CheckpointManager(os.path.join(plain, "checkpoints")).save(1, state)
    del state
    wide = copy.deepcopy(config)
    for assignment in PARALLEL_PAIRS[name][0]:
        if assignment.startswith("parallel."):
            apply_override(wide, assignment)   # a plan one card cannot hold: plain placement
    served = _serve_checkpoint(config, wide, dev, sharded, plain, 1)
    return {"manifest": {"world": manifest["world"], "mesh": manifest["mesh"],
                         "parts": [(p["stage"], p["model"], len(p["names"]))
                                   for p in manifest["parts"]]}, **served}


def tp_kernel_cases():
    """(f) The serve shape at a tp rank's heads: 8 heads over tp 2 and 4."""
    return [(f"tp{8 // h}_b8_{dtype}_rt1", 8, 66, h, 128, dtype, "rt1", None)
            for h in (4, 2) for dtype in ("bfloat16", "float32")]


# (g) The parallelism example as a user runs it, 8 gloo ranks a run: by
# default (the card) and with `--device cpu`, both at once. Its lines print
# the loss to 5 decimals and the gradient norm to 4, as JAX's do; both
# runs compute in float32 with TF32 off from the same host-drawn weights,
# batch and crop, which leaves ~1e-7 of each value between card and host,
# so each printed value may differ from the host's by one unit of its last
# digit (a rounding edge), and no more; so may the four dense modes' losses
# on the card, two of which run on the host (a crop drawn on the card's
# generator would set them apart).
PARALLEL_EXAMPLE = os.path.join("examples", "torch", "parallelism_example.py")
PARALLEL_EXAMPLE_DECIMALS = {"loss": 5, "grad_norm": 4}
PARALLEL_EXAMPLE_UNITS = 1
PARALLEL_EXAMPLE_TIMEOUT_S = 300


def _jax_example_labels():
    """The mode labels of JAX's `examples/parallelism_example.py`, in its
    order, read from the file's `modes` list (nothing of JAX is imported)."""
    import ast

    with open(os.path.join(REPO, "examples", "parallelism_example.py")) as f:
        tree = ast.parse(f.read())
    listed = next(node.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", None) == "modes")
    return [entry.elts[0].value for entry in listed.elts]


def _example_lines(text):
    """The example's mode lines: label, mesh, the printed loss and gradient
    norm (strings), where its ranks ran, their kernel launches and the
    step's milliseconds."""
    import ast

    rows = []
    for line in text.splitlines():
        if " mesh={" not in line:
            continue
        label, rest = line.split(" mesh=", 1)
        mesh, fields = rest.split("} ", 1)
        fields = dict(item.split("=", 1) for item in fields.split())
        rows.append({"label": label.rstrip(), "mesh": ast.literal_eval(mesh + "}"),
                     "loss": fields["loss"], "grad_norm": fields["grad_norm"],
                     "device": fields["device"], "step_ms": float(fields["step_ms"]),
                     "launches": int(fields["attention_launches"])})
    return rows


class _CardMemory(threading.Thread):
    """The card's `memory.used` (MiB) every 0.5 s while `proc` runs: the
    whole card's, which a second lane shares (`nvidia-smi` lists no process
    in a container that hides the host's process ids)."""

    def __init__(self, proc):
        super().__init__(daemon=True)
        self.proc, self.samples = proc, []

    def run(self):
        while self.proc.poll() is None:
            self.samples.append(_memory_used_mib(True))
            time.sleep(0.5)


def _parallel_example(on_card):
    """(g) `python examples/torch/parallelism_example.py` by default (the
    card; `--device cpu` too without one) and with `--device cpu`, at
    once: five lines in JAX's order, each mode where the example's rule
    puts it (sp and pp on the host, the others on cuda:0), each printed
    loss and gradient norm within PARALLEL_EXAMPLE_UNITS of the host's, the
    dense modes at one loss on the card, no attention-kernel launch; the
    card run's wall seconds and the card's memory while it ran."""
    runs, files = {}, {}
    root = tempfile.mkdtemp(prefix="rt1_chip_smoke_example_")
    try:
        for where, args in (("card", [] if on_card else ["--device", "cpu"]),
                            ("host", ["--device", "cpu"])):
            files[where] = open(os.path.join(root, f"{where}.txt"), "w+")
            runs[where] = (subprocess.Popen(
                [sys.executable, PARALLEL_EXAMPLE, *args], cwd=REPO, stdout=files[where],
                stderr=subprocess.STDOUT, text=True, start_new_session=True),
                time.perf_counter())
        memory = _CardMemory(runs["card"][0]) if on_card else None
        if memory is not None:
            memory.start()
        seconds, text = {}, {}
        deadline = time.perf_counter() + PARALLEL_EXAMPLE_TIMEOUT_S
        while len(seconds) < len(runs) and time.perf_counter() < deadline:
            for where, (proc, t0) in runs.items():
                if where not in seconds and proc.poll() is not None:
                    seconds[where] = time.perf_counter() - t0
            time.sleep(0.1)
        for where, (proc, _) in runs.items():
            files[where].seek(0)
            text[where] = files[where].read()
            if proc.poll() != 0:
                raise AssertionError(f"parallel (g): the example on the {where} exited "
                                     f"{proc.poll()}; its output ends\n{text[where][-4000:]}")
        if memory is not None:
            memory.join(timeout=60)
    finally:
        for proc, _ in runs.values():
            if proc.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=60)
        for f in files.values():
            f.close()
        shutil.rmtree(root, ignore_errors=True)
    lines = {where: _example_lines(out) for where, out in text.items()}
    labels = _jax_example_labels()
    units = {key: [] for key in PARALLEL_EXAMPLE_DECIMALS}
    for where, rows in lines.items():
        if [r["label"] for r in rows] != labels:
            raise AssertionError(f"parallel (g): the {where} run's modes "
                                 f"{[r['label'] for r in rows]}, JAX's {labels}")
    for card, host in zip(lines["card"], lines["host"]):
        point_to_point = card["mesh"]["seq"] > 1 or card["mesh"]["stage"] > 1
        expected = "cpu" if point_to_point or not on_card else "cuda:0"
        if card["mesh"] != host["mesh"] or math.prod(card["mesh"].values()) != 8 or \
                card["device"] != expected or host["device"] != "cpu":
            raise AssertionError(f"parallel (g): {card['label']} on {card['device']} "
                                 f"(host run {host['device']}), expected {expected}")
        for key, decimals in PARALLEL_EXAMPLE_DECIMALS.items():
            if not (math.isfinite(float(card[key])) and math.isfinite(float(host[key]))):
                raise AssertionError(f"parallel (g): {card['label']} {key} not finite")
            units[key].append(abs(round(float(card[key]) * 10 ** decimals) -
                                  round(float(host[key]) * 10 ** decimals)))
    dense = [round(float(r["loss"]) * 1e5) for r in lines["card"] if r["label"][:2] != "ep"]
    launches = sum(r["launches"] for rows in lines.values() for r in rows)
    if max(max(u) for u in units.values()) > PARALLEL_EXAMPLE_UNITS or \
            max(dense) - min(dense) > PARALLEL_EXAMPLE_UNITS or launches:
        raise AssertionError(f"parallel (g): card vs host units {units}, dense losses on the "
                             f"card {dense}, launches {launches} (allowed "
                             f"{PARALLEL_EXAMPLE_UNITS} unit, 0 launches)")
    samples = memory.samples if memory is not None else []
    return {"lines": lines["card"], "host_lines": lines["host"], "card_s": seconds["card"],
            "host_s": seconds["host"], "units": units, "tol_units": PARALLEL_EXAMPLE_UNITS,
            "dense_loss_units": dense, "launches": launches,
            "card_memory_used_mib": [min(samples), max(samples)] if samples else None}


def phase_parallel(config_name: str = "language_table", device: str = "cuda"):
    """Multi-process training on the card's world of one: (a) the NCCL
    world-1 step against the plain step, (b) the launcher CLI, (c) a gloo
    fsdp=2 checkpoint of the host served on the card, (d) a tp=2 pair on
    the card and a pp=2 pair on the host against their worlds of one, (e)
    the card serving each pair's checkpoint, (f) the kernel at a tp rank's
    heads, (g) the parallelism example on the card against the host
    (`_parallel_world_one`, `_parallel_launcher`, `_parallel_migration`,
    `_check_pair`, `_serve_pair`, `_kernel_case`, `_parallel_example`)."""
    import numpy as np
    import torch

    dev = torch.device(device)
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rt1_chip_smoke_parallel_")
    saving = _ParallelSave(config_name, root)
    groups = {}
    try:
        cases = []
        if dev.type == "cuda":   # (f) first: the kernels have no CPU build
            torch.backends.cuda.matmul.allow_tf32 = False
            rng = np.random.default_rng(1)
            cases = [_kernel_case(rng, *case, phase="parallel") for case in tp_kernel_cases()]
        t0 = time.perf_counter()
        world_one = dict(_parallel_world_one(config_name, dev, root),
                         seconds=time.perf_counter() - t0)
        # After (a), whose step the host processes' threads would slow.
        groups = {"pp": _PairGroup(config_name, root, "pp", "cpu", reference=True),
                  "tp": _PairGroup(config_name, root, "tp", device)}
        t0 = time.perf_counter()
        launcher = dict(_parallel_launcher(device, root), seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        migration = dict(_parallel_migration(config_name, dev, root, saving),
                         seconds=time.perf_counter() - t0)
        # The tp pair's world of one: this process, on `device`; the pp
        # pair's: a process beside it on the host.
        tp_records, tp_s = groups["tp"].join()
        pairs = {"tp": _check_pair("tp", tp_records, tp_s,
                                   _pair_run(config_name, "tp", device, 1, root))}
        pp_records, pp_s = groups["pp"].join()
        pairs["pp"] = _check_pair("pp", pp_records[:2], pp_s, pp_records[2])
        layers = _pair_config(config_name, ()).model.num_layers if dev.type == "cuda" else 0
        expected = {"tensor_core": layers, "tf32x3": 0, "simple": 0}
        if any(r != expected for r in pairs["tp"]["eval_launches"] +
               [pairs["tp"]["reference_eval_launches"]]):
            raise AssertionError(f"parallel pair tp: eval launches "
                                 f"{pairs['tp']['eval_launches']}, expected {expected} a rank")
        t0 = time.perf_counter()
        served = {name: _serve_pair(config_name, dev, root, name) for name in ("tp", "pp")}
        served["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        example = dict(_parallel_example(dev.type == "cuda"), seconds=time.perf_counter() - t0)
    finally:
        saving.join_quietly()
        for group in groups.values():
            group.join_quietly()
        shutil.rmtree(root, ignore_errors=True)
    record = {"phase": "parallel", "config": config_name,
              "nvidia_smi": nvidia_smi() if dev.type == "cuda" else None,
              "world_one": world_one, "launcher": launcher, "migration": migration,
              "pairs": pairs, "served": served, "kernel_cases": cases, "example": example,
              "seconds": time.perf_counter() - t_phase}
    emit(record)
    return record


# Phase bench: `python -m rt1_tpu_torch.bench`'s modes through its `main`,
# in process, at step counts cut from its defaults (steps / warm-up /
# windows 20 / 3 / 5; env 400 control steps; multihost 30 steps).
BENCH_TRAIN = ("--steps", "5", "--warmup", "2", "--windows", "1")
BENCH_INFER = ("--steps", "8", "--warmup", "2")
BENCH_AB = ("--inference_dtype", "f32,bf16,int8", "--window_sweep", "3,6")
BENCH_E2E = ("--steps", "3", "--warmup", "1", "--windows", "1", "--episodes", "4")
BENCH_MFU = ("--steps", "3", "--warmup", "1", "--windows", "1")
BENCH_ENV_STEPS = "5"             # x 20 control steps
BENCH_MULTIHOST_STEPS = "5"
# Headline metric names, JAX's for the same flags (tests/test_torch_bench.py
# derives them from bench.py's source).
BENCH_METRICS = {
    "train": "train_steps_per_sec_per_chip{tiny}",
    "infer_bfloat16": "infer_step_latency_p50_pallas",
    "infer_float32": "infer_step_latency_p50_pallas",
    "infer_tiny_bfloat16": "infer_step_latency_p50_pallas",
    "e2e": "train_steps_per_sec_per_chip_e2e{tiny}",
    "e2e_packed": "train_steps_per_sec_per_chip_e2e_tiny_packed",
    "mfu": "train_step_mfu{tiny}",
    "env": "env_control_steps_per_sec",
    "multihost": "multihost_examples_per_sec_ratio_2p_over_1p",
}


def _bench_run(argv):
    """`python -m rt1_tpu_torch.bench argv` (its `main`, in process): its
    headline, its stderr JSON lines, the paths it wrote (removed here after
    reading), the fused kernel's launches in it and its seconds."""
    import io

    from rt1_tpu_torch import bench
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    out, err = io.StringIO(), io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = bench.main(list(argv))
    seconds = time.perf_counter() - t0
    launches = dict(fused_attention.launches_by_variant)
    if code != 0:
        raise AssertionError(f"bench {argv}: exit code {code}")
    heads = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith('{"metric"')]
    if len(heads) != 1:
        raise AssertionError(f"bench {argv}: {len(heads)} headlines in {out.getvalue()[-2000:]}")
    details = [json.loads(x) for x in err.getvalue().splitlines() if x.startswith("{")]
    written = [line.split("wrote ", 1)[1].strip() for line in err.getvalue().splitlines()
               if line.startswith(("bench: wrote ", "bench_multihost: wrote "))]
    records = {}
    for path in written:
        with open(path) as f:
            records[os.path.basename(path)] = json.load(f)
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    return {"headline": heads[0], "details": details, "records": records,
            "launches_by_variant": launches, "seconds": seconds}


def phase_bench(config_name: str = "language_table", device: str = "cuda"):
    """`python -m rt1_tpu_torch.bench` on the card, each mode through its
    `main` in process (module docstring, phase 24)."""
    import torch

    from rt1_tpu_torch.configs import get_config

    t_phase = time.perf_counter()
    model = "tiny" if config_name == "tiny" else "flagship"
    on_card = device == "cuda"
    layers = get_config(config_name).model.num_layers
    common = ["--device", device]
    data_dir = tempfile.mkdtemp(prefix="rt1_chip_smoke_bench_")
    corpus = ["--data_dir", os.path.join(data_dir, "episodes")]
    cases = {
        "train": ["--mode", "train", "--model", model, *BENCH_TRAIN],
        "infer_bfloat16": ["--mode", "infer", "--model", model, "--attention_impl", "pallas",
                           "--dtype", "bfloat16", *BENCH_INFER, *BENCH_AB],
        "infer_float32": ["--mode", "infer", "--model", model, "--attention_impl", "pallas",
                          "--dtype", "float32", *BENCH_INFER],
        # The simple kernel's path: tiny's d = 8 in bf16.
        "infer_tiny_bfloat16": ["--mode", "infer", "--model", "tiny", "--attention_impl",
                                "pallas", "--dtype", "bfloat16", *BENCH_INFER],
        "e2e": ["--mode", "e2e", "--model", model, *BENCH_E2E, *corpus],
        # The guard's and the health pack's A/Bs at tiny: the pack's floors
        # take 400 synced steps.
        "e2e_packed": ["--mode", "e2e", "--model", "tiny", "--packed", "--guard", "--health",
                       *BENCH_E2E, *corpus],
        "mfu": ["--mode", "mfu", "--model", model, *BENCH_MFU],
        "env": ["--mode", "env", "--steps", BENCH_ENV_STEPS],
        "multihost": ["--mode", "multihost", "--steps", BENCH_MULTIHOST_STEPS],
    }
    runs = {}
    try:
        for name, argv in cases.items():
            runs[name] = _bench_run(argv + common)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    smi = nvidia_smi() if on_card else None
    expected_device = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
                       "nvidia_smi": smi} if on_card else "cpu"
    for name, run in runs.items():
        head = run["headline"]
        metric = BENCH_METRICS[name].format(tiny="_tiny" if model == "tiny" else "")
        if head["metric"] != metric or head["device"] != expected_device:
            raise AssertionError(f"bench {name}: headline {head}, expected {metric} on "
                                 f"{expected_device}")
        if not (isinstance(head["value"], float) and math.isfinite(head["value"])
                and head["value"] > 0):
            raise AssertionError(f"bench {name}: value {head['value']}")
    if on_card and not 0 < runs["mfu"]["headline"]["value"] <= 100:
        raise AssertionError(f"bench mfu: {runs['mfu']['headline']['value']} % outside (0, 100]")
    # The timed infer steps' launches (infer_detail: the counts' rise over
    # the timed steps, the run's own counts left whole): exactly one kernel
    # a decoder layer a step, of the variant the dtype and head dim give.
    tiny_layers = get_config("tiny").model.num_layers
    bf16_variant = "simple" if model == "tiny" else "tensor_core"  # tiny's d = 8
    for name, variant, n_layers in (("infer_bfloat16", bf16_variant, layers),
                                    ("infer_float32", "tf32x3", layers),
                                    ("infer_tiny_bfloat16", "simple", tiny_layers)):
        timed = next(d for d in runs[name]["details"] if d.get("mode") == "infer_detail")
        expected = dict.fromkeys(("tensor_core", "tf32x3", "simple"), 0)
        if on_card:  # the CPU takes the plain version
            expected[variant] = n_layers * int(BENCH_INFER[1])
        if timed["launches_by_variant"] != expected:
            raise AssertionError(f"bench {name}: launches {timed['launches_by_variant']}, "
                                 f"expected {expected}")
    for name in ("train", "e2e", "e2e_packed", "mfu", "env", "multihost"):
        if any(runs[name]["launches_by_variant"].values()):
            raise AssertionError(f"bench {name}: fused attention launched "
                                 f"{runs[name]['launches_by_variant']} (training runs dense)")
    ab = next(d for d in runs["infer_bfloat16"]["details"] if d.get("metric") == "infer_quant_ab")
    sweep = runs["infer_bfloat16"]["records"]["BENCH_serve_kvcache.json"]
    e2e = {name: next(d for d in runs[name]["details"] if d.get("mode") == "e2e_detail")
           for name in ("e2e", "e2e_packed")}
    multihost = runs["multihost"]["records"]["multihost_scaling.json"]
    where = "gloo ranks all on cuda:0" if on_card else "gloo ranks on the host's CPU"
    if not multihost["methodology"]["topology"].startswith(where):
        raise AssertionError(f"bench multihost: {multihost['methodology']['topology']}, "
                             f"expected {where}")
    record = {
        "phase": "bench", "config": config_name, "nvidia_smi": smi,
        "headlines": {name: run["headline"]["value"] for name, run in runs.items()},
        "seconds_by_run": {name: run["seconds"] for name, run in runs.items()},
        "launches_by_run": {name: run["launches_by_variant"] for name, run in runs.items()},
        "infer_timed_launches": {
            name: next(d for d in runs[name]["details"]
                       if d.get("mode") == "infer_detail")["launches_by_variant"]
            for name in ("infer_bfloat16", "infer_float32", "infer_tiny_bfloat16")},
        "quant_ab": ab["per_dtype"],
        "kvcache_sweep": sweep["per_window"],
        "e2e_detail": e2e,
        "mfu_detail": next(d for d in runs["mfu"]["details"] if d.get("mode") == "mfu_detail"),
        "multihost": {"groups": multihost["groups"], "scaling": multihost["scaling"]},
        "cut": {"train": BENCH_TRAIN, "infer": BENCH_INFER, "e2e": BENCH_E2E, "mfu": BENCH_MFU,
                "env_steps": BENCH_ENV_STEPS, "multihost_steps": BENCH_MULTIHOST_STEPS},
        "seconds": time.perf_counter() - t_phase,
    }
    emit(record)
    return record


def _kernel_entry(name, source, launches, path, head, cases):
    """One entry of the `kernels` line: the kernel's numbers at `head` (the
    case of its path's shape) and its largest error over `cases`."""
    ulps = [r["max_err_ulps"] for r in cases if r["max_err_ulps"] is not None]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": "rt1_tpu/parallel/flash_attention.py:34",
        "launches": launches, "path": path,
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        "max_err_ulps": max(ulps) if ulps else None,
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "device_ms": head.get("device_ms"),
        "plain_device_ms": head.get("plain_device_ms"),
        "library_device_ms": head.get("library_device_ms"),
        "shape": head["shape"], "dtype": head["dtype"],
    }


PHASES = ("kernel", "ab", "sweep", "parity", "tiny", "step", "serve", "train_parity", "train",
          "train_ops", "data", "rlds", "eval", "moe", "lava", "parallel", "serve_modes", "fleet",
          "ops", "loadgen", "chaos", "proof", "bench")


# The second lane: phases run by a process of their own beside the main
# one's (see the module docstring). It starts once LANE_B_AFTER has run and
# is joined before LANE_B_JOIN, so that the serving fleets' phases (alerts
# and canaries judged on latency) run alone.
LANE_B = ("moe", "parallel", "serve_modes", "proof", "bench")
LANE_B_AFTER = "train"
LANE_B_JOIN = "fleet"
LANE_B_TIMEOUT_S = 1100
LANE_ENV = "RT1_CHIP_SMOKE_PYCACHE"
# While both lanes run, each takes half the host's cores for its CPU ops
# (OpenMP threads of two processes sized to every core spin on each other).
LANE_THREADS = max(1, (os.cpu_count() or 2) // 2)


class _Lane:
    """`python3 chip_smoke.py --phases <phases> --records <file>` in a
    session of its own: its output goes to a file, its phases' records come
    back through `--records`. `join()` returns them (raising if the lane
    failed); `kill()` stops it and every process it started."""

    def __init__(self, phases):
        self.phases = phases
        self.dir = tempfile.mkdtemp(prefix="rt1_chip_smoke_lane_")
        self.records = os.path.join(self.dir, "records.json")
        self.out = open(os.path.join(self.dir, "out.txt"), "w+")
        env = dict(os.environ, OMP_NUM_THREADS=str(LANE_THREADS),
                   **{LANE_ENV: os.environ["PYTHONPYCACHEPREFIX"]})
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--phases", ",".join(phases),
             "--records", self.records], cwd=REPO, env=env, stdout=self.out,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)

    def join(self, timeout_s):
        try:
            rc = self.proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.kill()
            rc = None
        wall_s = time.perf_counter() - self.t0
        self.out.seek(0)
        text = self.out.read()
        if rc != 0:
            sys.stderr.write(f"lane {self.phases}: exit {rc}; its output ends\n{text[-16000:]}\n")
            self.close()
            raise AssertionError(f"lane {self.phases} failed (exit {rc})")
        # Its phases' lines into this output, in their order.
        for line in text.splitlines():
            if line.startswith('{"phase"') and not line.startswith(
                    ('{"phase": "device"', '{"phase": "build"', '{"phase": "timing"')):
                print(line, flush=True)
        with open(self.records) as f:
            out = json.load(f)
        self.close()
        return out["done"], out["seconds"], wall_s

    def kill(self):
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=60)

    def close(self):
        self.out.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def _run_phases(phases, lanes, done, seconds, shared, loadgen_dir, lane_b):
    """Each of `phases` in PHASES' order into `done` and `seconds`; with
    `lanes`, LANE_B's phases by the second lane (`lane_b` holds it, then its
    wall and the main lane's wait for it), this lane on LANE_THREADS CPU
    threads meanwhile."""
    import torch

    threads = (torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS"))
    for phase in PHASES:
        if lanes and phase == LANE_B_JOIN:
            t_wait = time.perf_counter()
            lane_done, lane_seconds, lane_b["wall_s"] = lane_b["lane"].join(LANE_B_TIMEOUT_S)
            lane_b["wait_s"] = time.perf_counter() - t_wait
            done.update(lane_done)
            seconds.update(lane_seconds)
            torch.set_num_threads(threads[0])
            if threads[1] is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = threads[1]
        if phase not in phases or (lanes and phase in LANE_B):
            continue
        t_phase = time.perf_counter()
        run = globals()["phase_" + phase]
        # The fleet's latencies print beside the lone server's, the
        # ledger's MFU beside phase train's.
        if phase == "fleet":
            done[phase] = run(direct=done.get("serve"))
        elif phase == "train_ops":
            done[phase] = run(train=done.get("train"))
        elif phase in ("train", "eval"):
            done[phase] = run(workdir=shared)
        elif phase == "loadgen":
            done[phase] = run(outdir=loadgen_dir)
        elif phase == "chaos":
            done[phase] = run(loadgen_dir=loadgen_dir)
        else:
            done[phase] = run()
        seconds[phase] = time.perf_counter() - t_phase
        if lanes and phase == LANE_B_AFTER:
            lane_b["lane"] = _Lane(LANE_B)
            torch.set_num_threads(LANE_THREADS)
            os.environ["OMP_NUM_THREADS"] = str(LANE_THREADS)  # processes it starts


def _bytecode_cache() -> str:
    """Compile Python modules once for every process this run starts: the
    card's machine sets PYTHONDONTWRITEBYTECODE and its packages ship no
    bytecode, so each process (a replica, a CLI, a worker) compiled torch
    anew, about 8 s of its start-up. Bytecode goes to a temporary
    directory of this run (`sys.pycache_prefix`, PYTHONPYCACHEPREFIX for
    the processes it starts), removed at exit; nothing is written beside
    the sources."""
    import atexit

    cache = os.environ.get(LANE_ENV)  # a lane process shares its parent's
    if not cache:
        cache = tempfile.mkdtemp(prefix="rt1_chip_smoke_pycache_")
        atexit.register(shutil.rmtree, cache, ignore_errors=True)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    return cache


def main(argv=None) -> int:
    import argparse

    _bytecode_cache()  # before torch's import: this process compiles it once
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %(default)s (build and device always "
                             "run); the kernels and ok lines need all of them")
    parser.add_argument("--records", default=None,
                        help="(a lane's) write the phases' records and seconds to this file")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # The forkserver that the DataLoader's, the oracle collectors' and the
    # data service's workers fork from imports torch and their modules
    # once; else every worker imports torch itself (6-9 s on the card's
    # host).
    import multiprocessing

    multiprocessing.set_forkserver_preload(
        ["__main__", "torch", "rt1_tpu_torch.data.pipeline", "rt1_tpu_torch.data.collect",
         "rt1_tpu_torch.data.rlds_pipeline", "rt1_tpu_torch.data.service"])
    from rt1_tpu_torch.parallel import flash_attention

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    seconds = flash_attention.build_seconds()
    library = flash_attention.library_path()
    report = library + ".ptxas.txt"
    ptxas = []
    if os.path.exists(report):
        with open(report) as f:
            ptxas = [line.strip() for line in f if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(library, REPO),
          "ptxas": ptxas})
    done, seconds = {}, {}
    # Phase eval evaluates phase train's CLI checkpoint when both run: one
    # train CLI run fewer.
    shared = tempfile.mkdtemp(prefix="rt1_chip_smoke_train_") \
        if {"train", "eval"} <= set(phases) else None
    # Phase chaos's run report reads phase loadgen's records when both run.
    loadgen_dir = tempfile.mkdtemp(prefix="rt1_chip_smoke_loadgen_") \
        if {"loadgen", "chaos"} <= set(phases) else None
    # A whole run starts the second lane after LANE_B_AFTER and joins it
    # before LANE_B_JOIN; a partial run takes its phases in order.
    lanes = set(phases) == set(PHASES)
    lane_b = {}
    try:
        _run_phases(phases, lanes, done, seconds, shared, loadgen_dir, lane_b)
    finally:
        if lane_b.get("lane") is not None and lane_b["lane"].proc.poll() is None:
            lane_b["lane"].kill()
        for directory in (shared, loadgen_dir):
            if directory is not None:
                shutil.rmtree(directory, ignore_errors=True)
    timing = {"phase": "timing", "seconds": seconds, "total_s": time.perf_counter() - T_START}
    if "wall_s" in lane_b:
        timing["lane_b"] = {"phases": list(LANE_B), "wall_s": lane_b["wall_s"],
                            "join_wait_s": lane_b["wait_s"]}
    emit(timing)
    if args.records:
        with open(args.records, "w") as f:
            json.dump({"done": done, "seconds": seconds}, f)
    if set(phases) != set(PHASES):
        print(smi, flush=True)
        emit({"partial": phases, "passed": True})
        return 0
    records, serve, parity, tiny = done["kernel"], done["serve"], done["parity"], done["tiny"]
    # The kernel at a tp rank's heads (phase parallel (f)) joins the cases.
    records = records + done["parallel"]["kernel_cases"]
    eval_bf16 = done["eval"]["timed_episode"]["launches_by_variant"]
    eval_f32 = done["eval"]["replay"]["launches_by_variant"]

    def case(name):
        return next(r for r in records if r["case"] == name)

    def cases(variant):
        return [r for r in records if r["variant"] == variant]

    entries = [
        _kernel_entry(
            "fused_attention_tc", "rt1_tpu_torch/csrc/fused_attention_tc.cu",
            serve["attention_launches_tensor_core_total"], "serve (bf16)",
            case("serve_b8_bfloat16_rt1"), cases("tensor_core")),
        _kernel_entry(
            "fused_attention_tf32x3", "rt1_tpu_torch/csrc/fused_attention_tf32x3.cu",
            parity["launches_by_variant"]["tf32x3"], "flagship infer_step (float32)",
            case("serve_b8_float32_rt1"), cases("tf32x3")),
        _kernel_entry(
            "fused_attention_simple", "rt1_tpu_torch/csrc/fused_attention.cu",
            tiny["launches_by_variant"]["simple"], "tiny infer_step (bfloat16, d = 8)",
            case("tiny_bfloat16_rt1"), cases("simple")),
    ]
    # The eval path's launches beside each variant's own path: the timed
    # bf16 episode and the f32 replay of the `eval` phase.
    # And the learning proof's: the DAgger and eval stages of its CLI.
    proof = done["proof"]
    serve_modes = done["serve_modes"]["modes"]
    fleet = done["fleet"]
    for entry, variant in zip(entries, ("tensor_core", "tf32x3", "simple")):
        # Each fleet replica's launches from its start to the drive's end,
        # and the respawned replica's after the kill (new processes: 0 at
        # start).
        entry["fleet_launches"] = {
            **{f"replica_{rid}": counts[variant] for rid, counts in fleet["launches"].items()},
            "respawned": fleet["respawned_launches"][variant]}
        # Each serving mode's bucket-8 drive (counts set to 0 before it).
        entry["serve_modes_launches"] = {
            mode: record["launches_by_variant"][variant] for mode, record in serve_modes.items()}
        entry["eval_launches"] = {"bf16_episode": eval_bf16[variant],
                                  "f32_replay": eval_f32[variant]}
        entry["proof_launches"] = {"dagger": proof["dagger"]["launches"][variant],
                                   "eval": proof["eval"]["launches"][variant]}
    # The operations loop: the gate's matrix and parity engines in the
    # fleet process (one verdict a candidate), and each replica from its
    # start to the end of the phase (new processes: 0 at start).
    ops = done["ops"]
    for entry, variant in zip(entries, ("tensor_core", "tf32x3", "simple")):
        entry["ops_launches"] = {
            "gate_matrix": [g["matrix"][variant] for g in ops["gate_launches"]],
            "gate_parity": [g["parity"][variant] for g in ops["gate_launches"]],
            **{f"replica_{rid}": counts[variant]
               for rid, counts in ops["replica_launches"].items()}}
    # The MoE flagship's: its bf16 bucket-8 engine and its float32
    # infer_step (counts set to 0 before each).
    moe = done["moe"]
    for entry, variant in zip(entries, ("tensor_core", "tf32x3", "simple")):
        entry["moe_launches"] = {
            "serve_bf16": moe["serve"]["launches_by_variant"][variant],
            "serve_engine_steps": moe["serve"]["engine_steps"],
            "f32_infer_step": moe["f32_parity"]["launches_by_variant"][variant]}
    # Phase parallel: the engines served from the fsdp=2, tp=2 and pp=2
    # checkpoints, each a bf16 bucket-8 engine (engine steps and one
    # infer_step for the logits) and a float32 infer_step (counts set to
    # 0 before each), and the tp pair's bf16 eval step on the card, each
    # rank on 4 of the 8 heads (counts set to 0 before it).
    parallel = done["parallel"]
    for entry, variant in zip(entries, ("tensor_core", "tf32x3", "simple")):
        entry["parallel_launches"] = {
            f"{name}_{key}": served[field][variant] if field != "engine_steps"
            else served[field]
            for name, served in (("fsdp", parallel["migration"]),
                                 ("tp", parallel["served"]["tp"]),
                                 ("pp", parallel["served"]["pp"]))
            for key, field in (("bf16_engine", "bf16_launches"),
                               ("bf16_engine_steps", "engine_steps"),
                               ("f32_infer_step", "f32_launches"))}
        entry["parallel_launches"]["tp_eval_step_by_rank"] = [
            launches[variant] for launches in parallel["pairs"]["tp"]["eval_launches"]]
        # (g) gates every variant's launches in the example's steps at 0.
        entry["parallel_launches"]["example_steps"] = parallel["example"]["launches"]
    # Phase step's `pretrained` check: one bf16 bucket-8 engine step served
    # from the torchvision-layout tower (counts set to 0 before it).
    pretrained = done["step"]["pretrained"]["engine"]["launches_by_variant"]
    for entry, variant in zip(entries, ("tensor_core", "tf32x3", "simple")):
        entry["pretrained_launches"] = pretrained[variant]
    # Phase rlds: the bucket-8 bf16 engine step served from the checkpoint
    # trained through data.loader=rlds_tf (counts set to 0 before it).
    rlds = done["rlds"]["engine"]["launches_by_variant"]
    for entry, variant in zip(entries, ("tensor_core", "tf32x3", "simple")):
        entry["rlds_launches"] = rlds[variant]
    # The train CLI's periodic evals in phase train_ops.
    train_ops = done["train_ops"]["cli"]
    entries[0]["train_ops_launches"] = {
        "evals": [launches["tensor_core"] for launches in train_ops["eval_launches"]],
        "eval_batches": train_ops["eval_batches"]}
    # Each replica the load generator's modes reached, from its start to
    # the mode's end (new processes: 0 at start).
    loadgen = done["loadgen"]["modes"]
    for entry, variant in zip(entries, ("tensor_core", "tf32x3", "simple")):
        entry["loadgen_launches"] = {
            mode: {label: counts[variant] for label, counts in row["launches"].items()}
            for mode, row in loadgen.items() if row["launches"]}
    # Phase bench: each of its runs (counts set to 0 before each) and the
    # infer runs' timed steps alone.
    bench = done["bench"]
    for entry, variant in zip(entries, ("tensor_core", "tf32x3", "simple")):
        entry["bench_launches"] = {
            **{name: counts[variant] for name, counts in bench["launches_by_run"].items()},
            **{f"{name}_timed": counts[variant]
               for name, counts in bench["infer_timed_launches"].items()}}
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
