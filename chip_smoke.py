#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, check it, time it.

    python3 chip_smoke.py

Phases, in order; the script exits non-zero at the first failure:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, the TF32 flags (both set False), and the kernel build;
  2. kernels: every kernel of the paths against its plain PyTorch version
     on the card at the paths' shapes, with times for the kernel, the
     plain version and the PyTorch library call computing the same
     function where there is one (a yardstick only; the port never calls
     it): flash attention (f32 and bf16 at the paths' shapes, f32 ragged,
     windowed and D = 32, 256 cases, and bf16 2048-token causal prefills
     at the deepseek-moe-16b and smollm-360m heads, where the tensor cores
     set the time), then the discounted-return scan, its adjoint
     and V-trace at (T, B) = (32, 32) (the training path), (32, 4096) and
     (2048, 128) (each with its device time, `device_us`, and beside it
     `launch_floor_us`, the device time of the library's empty kernel
     launched in the same profiler window; the f32 flash row at the
     policy trunk's serving shape has it too), then the
     prioritized replay draw at (C, size, n) =
     (20000, 12800, 64) (the DQN path), a full 1M-slot buffer with n = 256,
     nearly empty and empty buffers, and forced ties (indices exact,
     weights within 1e-5, bitwise repeatable; the yardstick is
     torch.topk over the scores);
     then the sharded replay service's per-shard draw `shard_topk_c` at
     (R, chunk, local counts, k) = (2, 10000, (10000, 2800), 64) and
     (4, 5000, (5000, 5000, 2800, 0), 64) (the replay=2 and replay=4 DQN
     paths at size 12800), full 262144-slot shards with k = 256, ragged
     1M-slot shards with an empty one, and forced ties (indices and scores
     bitwise the plain version's; the yardstick is a batched torch.topk
     over the masked (R, chunk) scores); then the grouped matmul at the
     LM serving path's shapes (deepseek-moe-16b experts, batch 4, prompt
     32: decode C = 8, prefill C = 15) in bf16 and f32, ragged shapes and
     a C below the smallest tile (f32 within rtol 1e-4, bf16 against the
     f32 product within one bf16 rounding, 2^-8; the yardstick is
     torch.bmm); every flash, replay-draw, per-shard-draw and grouped
     matmul row also gives the kernel's device time per call from
     torch.profiler (`device_us`, and the library call's; None where
     five windows each lost kernel records), beside the CUDA-event ms,
     which counts the host's launch cost too;
  2b. training attention: at the policy trunk's training shapes
     (TRAIN_FLASH_CASES: a full-width ppo minibatch (256, 4, 2, 4, 64),
     the reduced trunk's and the full-width a3c/impala batch of 1024 rows,
     pendulum's 3 keys, a dqn batch of 64; 5 keys, one past the 4 at a
     time the backward's phase 1 takes; TRAIN_FLASH_UNALIGNED: the
     ppo minibatch with every operand one float off its alignment, the
     backward's scalar-copy instance, bitwise its gradients on aligned
     copies), the
     forward writing each row's log-sum-exp (O bitwise the serving
     forward's, lse within 2e-5 of the plain version's) and the backward
     kernel `flash_attention_bwd` against its plain version on the
     kernel's o and lse (within 1e-4 x max(1, max|grad|)), bitwise on a
     repeat; each with ms, device time
     beside the launch floor, plain ms, the library's ms (SDPA's forward;
     SDPA's backward through autograd) and its bound;
  3. slice: the full-width `paper-drl-trunk` policy served through
     ServeEngine for cartpole and pendulum at 500 and 2000 offered
     requests/s, with a hot swap in every cell; the kernel's launch count
     over that run must be 4 (one per layer) per dispatch;
  4. training: `repro_torch.launch.rl_train` at the default config
     (60 iterations of 32 envs x 32 steps, MLP (64, 64)) on cartpole for
     ppo, a3c, impala (its default: the V-trace kernel) and dqn,
     ppo on pendulum for 20 iterations, and dqn on GridWorld(4, 16) at the
     reference's learning-bar config (tests/test_trainer.py) for 16 seeds;
     ppo and dqn on cartpole for 20 iterations with `--sync asp` and with
     `--sync ssp` (one worker, the plan's delay schedule); ppo on the
     wrapped `pendulum-norm` and impala on `cartpole-repeat` for 20
     iterations; `rl_train --policy trunk` (the reduced trunk) for ppo,
     a3c, impala and dqn for 3 iterations, and a full-width trunk fit
     (Trainer, trunk_kwargs={"reduced": False}) of ppo and impala, each
     gated on the training attention's exact forward-with-lse and backward
     launches an iteration (TRUNK_LAUNCHES per layer);
     each run checks finite losses and its kernels' launch counts per
     iteration; the learning bars: cartpole ppo/a3c/impala on the mean of
     the last two logged returns, GridWorld dqn on the mean over the seeds
     of the mean of the last four;
  4b. sharded replay: dqn at the default config on cartpole through
     `rl_train --plan "workers=1:allreduce:bsp,replay=R:allreduce:bsp:replay"`
     for R = 2 and 4 (the slice's main path, counts at 0 just before each
     and read just after: 60 `shard_topk_c` launches and no
     `prioritized_sample_c` launch per fit), each fit bitwise equal to the
     same plan through `Trainer` with `use_kernel=False` (params,
     optimizer state, the reassembled buffer, history), which is bitwise
     the flat plan's plain fit; finite losses;
  4c. distribution: the plan's data positions on the one card, one
     thread each (core/positions.py), through `rl_train`: impala, ppo and
     a3c `--n-workers 4` at the default config (60 iterations, 32 envs
     split 8 a position) and dqn for 20 (cut for time), each gated on W
     times the flat run's kernel launches, finite losses and, but for
     dqn, learning bars (ppo >= 60, a3c >= 25, impala >= 20: about half
     of the JAX package's 4-worker fits); impala for 10 iterations under
     `--n-workers 4`, `hosts=1 x workers=4` and `hosts=2 x workers=2`
     all-allreduce plans, bitwise equal in params and history, `--topology
     ps` within rel 1e-3 of allreduce on the last loss,
     `hosts=2:allreduce:bsp,workers=2:gossip:asp` and `--sync ssp`
     finite; a3c under `--actors 16,32` (superstep 5, 20 iterations) at
     one and four workers, `actor_shards` following the schedule; dqn
     under `workers=2 x replay=2` (2 x 20 `shard_topk_c` launches, the
     flat buffer returned); the reduced trunk under impala at two
     workers (twice the flat run's flash launches); and the 4-worker
     impala fit against `use_kernel=False` (params within 1e-5); each
     run's `train_run` line has its plan, W, ms an iteration and env
     steps a second;
  4d. pipeline and sharded learner states: `rl_train --sync ssp
     --staleness-bound 1 --pipeline` (depth 1) for ppo, a3c and impala at
     the default config (bars ppo >= 45, a3c >= 28, impala >= 22: about
     half of the JAX package's own pipelined fits) and dqn for 20
     iterations (cut for time), a3c under `--sync asp --max-delay 4
     --pipeline` (depth 4, 20 iterations); impala and dqn for 10
     iterations fused, pipelined at depth 0 (bitwise the fused fit) and
     at depth 1 with supersteps of 2 and 10 (bitwise each other); one
     cartpole step through `HostPipelined` (card -> host -> card) bitwise
     the host's step, and a 10-iteration depth-1 impala fit on gridworld
     through it bitwise the on-device env's fit; impala
     under `workers=2 x shard=2` (ZeRO-2) and `x zero3=2` (ZeRO-3), each
     bitwise the distribution phase's 10-iteration flat(4) fit (params,
     the reassembled optimizer state, ring, history); dqn under
     `workers=1 x zero3=2 x replay=2` bitwise `--n-workers 2` (20
     iterations, the flat buffer returned); the full-width trunk under
     impala at zero3(1, 2), layer-wise, bitwise flat(2) (3 iterations;
     the training attention's launches twice the flat(1) run's); every
     position's TrainState bytes after two full-width trunk iterations
     at W = 4, flat / ZeRO-2 / ZeRO-3, exactly 16P / 10P / 4P in f32 plus
     padding and counters (`max_memory_allocated` beside them, not
     gated); a zero3 fit (MLP and full-width trunk) saved, then served
     live, restored into a plain agent and through wrappers at 2 and 4
     shards, bitwise; every run's launches exactly W x its algorithm's
     per consumed iteration; each `train_run` line has its plan, W,
     pipeline depth, ms an iteration, env steps a second and launches;
  4e. processes: `rl_train --backend gloo`, a process a data position,
     every rank on the one card (NCCL refuses two ranks on one card),
     each case after the same `--backend positions` fit, in turns:
     impala at 4 workers (10 iterations; also bitwise 4c's flat(4)
     fit), ppo under (hosts=2 allreduce bsp, workers=2 gossip asp),
     impala under workers=2 x shard=2 (bitwise the flat(4) fit), dqn
     under workers=2 x replay=2 (20 iterations, the flat buffer back),
     a3c pipelined at ssp depth 1 at W = 2, and the reduced trunk under
     impala at W = 2 (its training attention's launches twice the flat
     run's): each gloo fit bitwise its threaded fit and its line the
     threaded line plus `backend` and `n_processes`; every rank's
     launches summed equal to the threaded run's, none in the launcher;
     each `train_run` line has the gloo and the threaded ms an
     iteration (a number, not a gate). Then a one-rank NCCL group on
     cuda:0: its hook, shard_gather and all-gather equal to
     `PositionGroup(1)`'s; and `--backend nccl --n-workers 2` refused,
     naming the card count, before any process starts;
  5. path agreement: one learner_step per algorithm from one state and
     trajectory, kernels on against the plain versions, on the card; the
     dqn step with the kernel runs under
     torch.cuda.set_sync_debug_mode("error"), so it syncs nothing; so do
     the dqn steps through the sharded replay service (R = 2 and 4); and
     per algorithm the full-width trunk's learner loss (within 1e-5) and
     gradients (within 1e-4 x max|g|), training attention kernels against
     the plain attention;
  5b. evolution: ES and DeepGA on cartpole (32 members, 4 generations)
     and ERL on pendulum (8 members, 3 generations) on the card, each
     population a batch there; finite fitness;
  6. the forward-only flash-attention entry raises on an input that
     requires grad (training goes through ops.flash_attention);
  7. CLI: `repro_torch.launch.serve_policy --quick` for ppo and dqn
     (trains 4 iterations in-process, then serves);
  8. the gmm kernel raises on an input that requires grad;
  9. LM serve: `repro_torch.launch.serve.serve` of the full-width
     deepseek-moe-16b in bf16 with use_kernels on weights drawn on the card
     from seed 0 (2 prefills and 17 decode steps: 1539 gmm_ecd and 56
     flash-attention launches), finite logits, peak device memory, and the
     kernel path against use_kernels=False on the same params
     (`lm_agreement`: f32 compute end to end, prefill and first decode
     logits within 1e-3 x max|logit|; bf16 layer by layer within 2^-6);
     then smollm-360m at full width in bf16 (flash attention only);
 10. wkv6 kernel: the chunked RWKV-6 WKV against its plain version (the
     per-step scan), y and the final state, with a nonzero u and initial
     state, at (B, T, H, N, chunk) = (4, 32, 32, 64, 64) (the rwkv6-1.6b
     serve prefill), (4, 512, 32, 64, 64), (4, 1, 32, 64, 1) (decode),
     (2, 100, 3, 16, 32) and (1, 37, 1, 8, 16) (ragged last chunks), and
     with bf16 r, k, v, u (the serve path's dtypes; the plain version on
     their f32 values) at the prefill and decode shapes, within the
     reference's atol 2e-4, rtol 1e-3; bitwise repeatable, the final S
     written over the state it is given, each row with its device time
     (`device_us`); it raises under grad;
 11. RWKV serve: `serve()` of the full-width rwkv6-1.6b in bf16 with
     use_kernels on weights drawn on the card from seed 0, its constants
     (u, w0, ln_scale, the lerps) redrawn from a numpy seed (2 prefills
     and 17 decode steps: 456 wkv6_btHN launches, no gmm or flash), finite
     logits, peak device memory, and the kernel path against
     use_kernels=False on the same params in f32 compute at prompt 32 and
     512, layer by layer on the same input (every block's prefill output
     and state, and its first decode output and state from its own
     prefill cache, within 1e-3 x max|plain|; end-to-end
     logits reported: this random model amplifies f32 rounding ~2x per
     layer);
 12. LM zoo: `serve()` of gemma3-1b, stablelm-1.6b, minicpm3-4b,
     whisper-base, paligemma-3b (the reference's stub frontends), and of
     one whole period of jamba-v0.1-52b (8 of 32 layers) and of
     llama4-maverick-400b-a17b (2 of 48; one 80 GB card holds no more),
     at the published widths (checked), bf16, use_kernels, weights drawn
     on the card from seed 0 (every leaf counted: `zoo_param_count`),
     batch 4, prompt 32, 16 new tokens: the flash and grouped-matmul
     launches exactly ZOO's (flash on the causal full-attention layers'
     prefills only; local attention, MLA, the encoder, cross attention
     and Mamba on the model's own path, as the reference routes them),
     `generated_shape` [4, 16], and `lm_agreement` on each; the kernels
     phases also hold the zoo's flash and grouped-matmul shapes in bf16
     (ZOO_FLASH_CASES, ZOO_GMM_CASES) against their plain versions;
 13. LM training: `repro_torch.launch.train.train` (use_kernels=False,
     as the reference trains) of smollm-360m at full width, batch 16,
     seq 128, 20 steps, in f32, in bf16 on f32 master weights (every
     param and moment leaf still f32 after) and in f32 with remat (its
     first 5 CEs the f32 run's within rtol 1e-6, its peak allocation
     below the f32 run's); each CE finite, the last below the first; ms
     a step and peak bytes. Then whisper-base, gemma3-1b, rwkv6-1.6b,
     stablelm-1.6b and paligemma-3b at full width for 3 steps in bf16
     with remat (finite CE), and the learning bars at
     examples/train_lm.py's settings (reduced, f32, 300 steps, batch 16,
     seq 64, lr 3e-3): smollm-360m, deepseek-moe-16b, rwkv6-1.6b and
     jamba-v0.1-52b end within 0.25 of `optimal_ce`. Every kernel's
     launch count is the same after the phase as before it.
 14. dry-run: `repro_torch.launch.dryrun.dryrun_one` of the reference's
     five cases (smollm-360m train_4k, gemma3-1b decode_32k, rwkv6-1.6b
     long_500k, whisper-base prefill_32k at mesh (4, 4), smollm-360m
     train_4k multi-pod at (2, 2, 2)), deepseek-moe-16b decode_32k at
     (4, 4), and at the production (16, 16) the five pairs the card
     host's torch refused before the dry-run's own rules (jamba-v0.1-52b
     train_4k and prefill_32k at one period, 8 of its 32 layers, for
     time; its long_500k and decode_32k; rwkv6-1.6b train_4k), each at
     full width in a process of its own, on the host's
     CPU (meta DTensors over a fake process group; the card is not
     used), all started before phase 13, so they run beside it and the
     examples (which they slow): every case ok, its compute, memory and
     collective terms (H100 data-sheet constants), bottleneck and
     collective bytes a kind printed;
 15. examples: the port's six examples (examples/repro_torch/*.py) at
     their defaults on the card, each a process of its own, all at
     once, while the dry-runs run: exit 0, train_lm's final CE within
     0.25 of its floor, serve_policy_cartpole's programs flat after
     warmup, es_cartpole's fitness finite; and `serve_policy --quick
     --out DIR`, its BENCH_torch_serve.json valid and stamped with the
     card.
It then prints the kernels' JSON line and, last, the device line.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,     # CUDA-core f32, H100 SXM data sheet
            "bfloat16": 989e12}   # dense bf16 tensor cores
SERVE_CASE = (32, 4, 2, 4, 64, True, 0)  # B, H, KVH, S, D, causal, window
# the LM serve path's prefill attention (batch 4, prompt 32)
LM_FLASH_CASES = [(4, 16, 16, 32, 128, True, 0),   # deepseek-moe-16b
                  (4, 15, 5, 32, 64, True, 0)]     # smollm-360m
# f32 past 32 keys (flash_fwd<float>, on no caller's path) at
# (4, 16, 16, 128, 128): a deepseek-width head at a 128-token prompt
KERNEL_CASES = [SERVE_CASE, *LM_FLASH_CASES,
                (2, 4, 2, 384, 64, True, 0),
                (1, 4, 1, 256, 64, True, 64),
                (2, 2, 2, 96, 32, False, 0),
                (1, 2, 1, 512, 256, True, 0),
                (4, 16, 16, 128, 128, True, 0)]
# bf16 only: the LM zoo's prefill attention at its serve shapes (batch 4,
# prompt 32): gemma3 (D = 256, one kv head, the short-row branch),
# stablelm (MHA), whisper's decoder, paligemma (256 patches + 32 tokens:
# a ragged tail at D = 256, one kv head), jamba, llama4 (40 over 8 heads)
ZOO_FLASH_CASES = [(4, 4, 1, 32, 256, True, 0), (4, 32, 32, 32, 64, True, 0),
                   (4, 8, 8, 32, 64, True, 0), (4, 8, 1, 288, 256, True, 0),
                   (4, 32, 8, 32, 128, True, 0),
                   (4, 40, 8, 32, 128, True, 0)]
# bf16 only: the LM models' heads at a 2048-token causal prefill, where
# the tensor cores, not the host, set the time
LONG_FLASH_CASES = [(1, 16, 16, 2048, 128, True, 0),  # deepseek-moe-16b
                    (1, 15, 5, 2048, 64, True, 0)]    # smollm-360m
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SM_CLOCK_HZ = 1.98e9          # H100 SXM boost clock
FMA_CYCLES = 4                # latency of one dependent f32 FMA
SCAN_SHAPES = [(32, 32), (32, 4096), (2048, 128)]  # (T, B); first = path
# learning bars on the mean of the last two logged returns (cartpole,
# default config): about half of what the JAX package reaches
BARS = {"ppo": 50.0, "a3c": 30.0, "impala": 30.0}
# DQN on GridWorld(4, 16) at tests/test_trainer.py's config: per seed,
# the mean of the last four logged returns (iterations 70, 80, 90, 99);
# the bar holds their mean over GRID_SEEDS. One seed is no gate: the JAX
# package itself stays under 0.8 at 10 of 48 seeds (DQN's policy dips for
# some iterations at this config), while a policy that does not learn
# times out near -0.16 and a random one scores ~0.21
GRID_BAR = 0.8
GRID_SEEDS = range(16)
GRID_CFG = dict(iters=100, superstep=10, n_envs=16, unroll=8, log_every=10,
                algo_kwargs={"warmup": 5, "eps_decay_steps": 60,
                             "target_update": 20})
# (C, size, n, forced ties); first = the DQN path's shape
REPLAY_CASES = [(20000, 12800, 64, False), (1048576, 1048576, 256, False),
                (4096, 10, 64, False), (131, 100, 1, False),
                (4096, 0, 16, False), (20000, 12800, 64, True)]
REPLAY_TOL = 1e-5
# (R, chunk, local counts, k, forced ties) of the per-shard draw; the first
# two are the replay=2 and replay=4 DQN paths' shapes at size 12800 (the
# first is the path's row in the kernels line)
SHARD_CASES = [(2, 10000, (10000, 2800), 64, False),
               (4, 5000, (5000, 5000, 2800, 0), 64, False),
               (4, 262144, (262144,) * 4, 256, False),
               (4, 1048576, (1048576, 1048576, 300000, 0), 256, False),
               (2, 10000, (10000, 2800), 64, True)]
REPLAY_SHARDS = (2, 4)   # the replay axis sizes the slice trains with
SYNC_ITERS = 20
# (E, C, d, f) of the grouped matmul: the LM serve path's (decode wi/wg,
# decode wo, prefill wi/wg, prefill wo; the first is the path's row in the
# kernels line), then ragged shapes and a C below the smallest C-tile
GMM_PATH = [(64, 8, 2048, 1408), (64, 8, 1408, 2048), (64, 15, 2048, 1408),
            (64, 15, 1408, 2048)]
GMM_CASES = GMM_PATH + [(4, 70, 96, 130), (8, 16, 512, 64), (3, 3, 100, 37)]
# bf16 only: the LM zoo's expert matmuls (batch 4, prompt 32), each C from
# the reference's max(8, round(T·K/E·1.25)): jamba's prefill (T = 128,
# C = 20) and decode (C = 8) wi/wg and wo, llama4's wi/wg and wo (C = 8
# at prefill and decode; 10.7 GB of weights a call)
ZOO_GMM_CASES = [(16, 20, 4096, 14336), (16, 20, 14336, 4096),
                 (16, 8, 4096, 14336), (16, 8, 14336, 4096),
                 (128, 8, 5120, 8192), (128, 8, 8192, 5120)]
GMM_RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}
LM = dict(arch="deepseek-moe-16b", batch=4, prompt_len=32, gen_len=16)
# the rest of the LM zoo, served like LM at full width: (arch, layers
# served, the published widths checked, flash_attention_hsd and gmm_ecd
# launches a serve()). jamba serves one whole period of its 32 layers (7
# Mamba, 1 attention, 4 MoE: 13.3 B params, 26.5 GB in bf16; all 32
# would be 103 GB), llama4 one of its 48 (a MoE layer then a dense one:
# 18.6 B, 37.1 GB; all 48 would be 795 GB): one 80 GB card holds no more
ZOO = [
    ("gemma3-1b", 26, dict(d_model=1152, n_heads=4, n_kv_heads=1,
                           head_dim=256, d_ff=6912, vocab=262144,
                           window=512), 8, 0),
    ("stablelm-1.6b", 24, dict(d_model=2048, n_heads=32, n_kv_heads=32,
                               head_dim=64, d_ff=5632, vocab=100352,
                               norm="layernorm"), 48, 0),
    ("minicpm3-4b", 62, dict(d_model=2560, n_heads=40, head_dim=64,
                             d_ff=6400, vocab=73448, q_lora_rank=768,
                             kv_lora_rank=256, rope_head_dim=32), 0, 0),
    ("whisper-base", 6, dict(d_model=512, n_heads=8, n_kv_heads=8,
                             head_dim=64, d_ff=2048, vocab=51865,
                             enc_layers=6, enc_tokens=1500), 12, 0),
    ("paligemma-3b", 18, dict(d_model=2048, n_heads=8, n_kv_heads=1,
                              head_dim=256, d_ff=16384, vocab=257216,
                              frontend_tokens=256, frontend_dim=1152),
     36, 0),
    ("jamba-v0.1-52b", 8, dict(d_model=4096, n_heads=32, n_kv_heads=8,
                               head_dim=128, d_ff=14336, vocab=65536,
                               ssm_state=16, ssm_conv=4, ssm_expand=2,
                               moe=(16, 2, 14336, 0, 2)), 2, 228),
    ("llama4-maverick-400b-a17b", 2, dict(
        d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
        vocab=202048, moe=(128, 1, 8192, 1, 2)), 4, 57),
]
# kernel path against use_kernels=False on the same params (lm_agreement):
# f32 end to end, x max|logit| (f32 sums in another order over 28 layers);
# bf16 layer by layer, x max|plain output| (2^-6: a few bf16 roundings)
LM_F32_TOL = 1e-3
LM_BF16_TOL = 2.0 ** -6
# LM training (phase lm_train) through repro_torch.launch.train.train:
# the launcher's default arch at full width, batch 16, seq 128, 20 steps
# (cut from 200 for time), in f32, in bf16 on f32 master weights and in
# f32 with remat; the first REMAT_MATCH losses of the remat run against
# the f32 run's, bitwise or within rtol 1e-6
LM_TRAIN = dict(arch="smollm-360m", batch=16, seq=128, steps=20, lr=3e-4)
REMAT_MATCH = 5
# the other configs whose f32 params, gradients and two AdamW moments
# (16 bytes a param) fit the card, 3 steps in bf16 with remat at batch 16,
# seq 128 (paligemma's rows are its 256 stub patches + 128 tokens); the
# rest (minicpm3-4b 68.2 GB, deepseek-moe-16b 262, jamba-v0.1-52b 823,
# llama4 6363) train reduced only
LM_TRAIN_FULL = ("whisper-base", "gemma3-1b", "rwkv6-1.6b", "stablelm-1.6b",
                 "paligemma-3b")
LM_TRAIN_FULL_STEPS = 3
# learning bars at examples/train_lm.py's settings (reduced, f32): the
# final CE within LM_BAR_MARGIN of the stream's optimal_ce (the
# reference's gap on a CPU is 0.04-0.11; its stream draws differ)
LM_BARS = dict(archs=("smollm-360m", "deepseek-moe-16b", "rwkv6-1.6b",
                      "jamba-v0.1-52b"), steps=300, batch=16, seq=64,
               lr=3e-3, seed=0)
LM_BAR_MARGIN = 0.25
# (B, T, H, N, chunk) of the chunked WKV: the rwkv6-1.6b serve prefill,
# a prompt of eight chunks, the decode step, then the reference's sweep
# shapes (ragged last chunks)
WKV_CASES = [(4, 32, 32, 64, 64), (4, 512, 32, 64, 64), (4, 1, 32, 64, 1),
             (2, 100, 3, 16, 32), (1, 37, 1, 8, 16)]
WKV_TOL = dict(atol=2e-4, rtol=1e-3)   # the reference's own
# bf16 r, k, v, u (the serve path's dtypes) at the prefill and decode
# shapes, held against the plain version on their f32 values (the first
# is the path's row in the kernels line)
WKV_BF16_CASES = [(4, 32, 32, 64, 64), (4, 1, 32, 64, 1)]
RWKV = dict(arch="rwkv6-1.6b", batch=4, prompt_len=32, gen_len=16,
            agree_prompts=(32, 512))
# (B, H, KVH, S, D) of the policy trunk's training attention (4 query heads
# over 2 kv heads, 4 keys for cartpole, 3 for pendulum): a full-width ppo
# minibatch (the path's row in the kernels line), the reduced trunk's
# (rl_train's default) a3c/impala batch of 32 envs x 32 steps, the same at
# full width, pendulum's 3 keys, and a dqn batch; then 5 keys, one past
# the 4 at a time the backward's phase 1 takes at D 64
TRAIN_FLASH_CASES = [(256, 4, 2, 4, 64), (1024, 4, 2, 4, 32),
                     (1024, 4, 2, 4, 64), (256, 4, 2, 3, 64),
                     (64, 4, 2, 4, 32), (256, 4, 2, 5, 64)]
# the path's shape with every operand one float into its buffer: off the
# 16-byte alignment, so the backward's scalar-copy instance
TRAIN_FLASH_UNALIGNED = [(256, 4, 2, 4, 64)]
# the backward against its plain version fed the kernel's o and lse: dk and
# dv sum S * G rows and dq S keys of f32 products in another order
BWD_TOL = 1e-4
TRUNK_ITERS = 3
# (forward-with-lse, backward) launches per layer an iteration: ppo
# differentiates 4 epochs x 4 minibatches; a3c its batch and, through the
# n-step target, the bootstrap value; impala its batch (its bootstrap
# forward is differentiable but V-trace's targets are detached); dqn the
# online net on obs and, for the double-Q argmax (no gradient), next_obs
TRUNK_LAUNCHES = {"ppo": (16, 16), "a3c": (2, 2), "impala": (2, 1),
                  "dqn": (2, 1)}
# the trunk's learner gradients, kernels against use_kernels=False at full
# width: x max|gradient| (f32 through four layers in another order)
TRUNK_GRAD_TOL = 1e-4
# the distribution phase: the data positions the slice's main path runs on
# the one card, its fits' iterations (dqn cut from 60 for time) and the
# learning bars on the mean of the last two logged returns, about half of
# the JAX package's own 4-worker fits at seed 0 on a CPU (ppo 133.9, a3c
# 57.5, impala 38.9 at iteration 59)
DIST_W = 4
DIST_ITERS = {"impala": 60, "ppo": 60, "a3c": 60, "dqn": 20}
DIST_BARS = {"ppo": 60.0, "a3c": 25.0, "impala": 20.0}
DIST_SHORT = 10       # the nested, mixed and kernel-vs-plain fits
DIST_ELASTIC = ("16,32", 20, 5)   # actors schedule, iterations, superstep
DIST_TOL = 1e-5       # kernel vs plain params: the path agreement's bound
# the pipeline and sharded learner-state phase: the pipelined fits'
# iterations (dqn cut from 60 for time) and their learning bars on the mean
# of the last two logged returns, about half of the JAX package's own
# `rl_train --sync ssp --staleness-bound 1 --pipeline` at seed 0 on a CPU
# (ppo 89.5, a3c 56.4, impala 44.3 at iterations 50 and 59)
PIPE_ITERS = {"ppo": 60, "a3c": 60, "impala": 60, "dqn": 20}
PIPE_BARS = {"ppo": 45.0, "a3c": 28.0, "impala": 22.0}
PIPE_ASP = ("a3c", 20, 4)   # algorithm, iterations, asp max_delay (= depth)
ZERO_DQN_ITERS = 20          # dqn zero3 + replay against flat(2)
ZERO_MEM_ITERS = 2           # the memory table's fits


# (arch, shape, mesh, layers kept or None for all): the reference's five,
# the MoE decode, and the five pairs torch 2.11 (the card host's) refused
# before the dry-run's own view, add/sub and flip rules, at the production
# mesh where they failed. jamba's train_4k and prefill_32k keep one whole
# period of its 32 layers (7 Mamba + 1 attention, MoE every other layer:
# every op kind of the model, the head split among them): at full depth
# they traced in 300.6 s and 483.6 s on the card host's CPU (`dryrun
# --all`, eight at once), too long for DRYRUN_TIMEOUT_S beside the
# examples
DRYRUN_CASES = [
    ("smollm-360m", "train_4k", (4, 4), None),
    ("gemma3-1b", "decode_32k", (4, 4), None),
    ("rwkv6-1.6b", "long_500k", (4, 4), None),
    ("whisper-base", "prefill_32k", (4, 4), None),
    ("smollm-360m", "train_4k", (2, 2, 2), None),
    ("deepseek-moe-16b", "decode_32k", (4, 4), None),
    ("jamba-v0.1-52b", "train_4k", (16, 16), 8),
    ("jamba-v0.1-52b", "prefill_32k", (16, 16), 8),
    ("jamba-v0.1-52b", "long_500k", (16, 16), None),
    ("jamba-v0.1-52b", "decode_32k", (16, 16), None),
    ("rwkv6-1.6b", "train_4k", (16, 16), None),
]
DRYRUN_TIMEOUT_S = 420
DRYRUN_SCRIPT = """
import dataclasses, json, sys, time
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import dryrun_one
arch, shape = sys.argv[1], sys.argv[2]
mesh = tuple(int(x) for x in sys.argv[3].split(","))
cfg = get_config(arch)
if sys.argv[4] != "None":
    cfg = dataclasses.replace(cfg, n_layers=int(sys.argv[4]))
t0 = time.perf_counter()
rec = dryrun_one(cfg, shape, mesh_shape=mesh, multi_pod=len(mesh) == 3,
                 save=False)
rec["wall_s"] = time.perf_counter() - t0
print("RESULT " + json.dumps(rec))
"""
# the six examples at their defaults on the card, and the policy serving
# launcher's record
EXAMPLES = ["quickstart", "train_lm", "serve_lm", "impala_pendulum",
            "es_cartpole", "serve_policy_cartpole"]
EXAMPLE_TIMEOUT_S = 300


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_time_ms(fn, iters, warmup=10):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, iters=10, tries=5):
    """Device time of fn's CUDA kernels per call, in us, from
    torch.profiler's key_averages, and each kernel's launches per call.
    Beside cuda_time_ms (events around many calls, which counts the
    host's launch cost where the host is slower than the card), it is the
    kernels' own time. Late in a long process the profiler loses some
    kernels' records, not their launch calls': a window with fewer kernel
    records than launch calls, or a kernel seen other than a whole number
    of times a call, is run again, up to `tries` windows
    (`launch/profiling.kernel_us`). The time is None where no window was
    whole; the launches are the last window's."""
    from repro_torch.launch.profiling import kernel_us
    times, launches = kernel_us(fn, iters, tries)
    return (sum(times.values()) if times else None), launches


def attended_pairs(S, causal, window):
    """(query, key) pairs the masks keep: the work these inputs need."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window else 0
        hi = q + 1 if causal else S
        total += max(0, hi - lo)
    return total


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"tf32: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels.common import build_kernels, load_kernels
    t0 = time.perf_counter()
    lib, log = build_kernels()
    load_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s -> "
          f"{os.path.relpath(lib, ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    return card


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.profiling import beside_floor
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    cases = [(c, "float32") for c in KERNEL_CASES] + [
        (c, "bfloat16") for c in (SERVE_CASE, *LM_FLASH_CASES,
                                  *LONG_FLASH_CASES, *ZOO_FLASH_CASES)]
    for (B, H, KVH, S, D, causal, window), dname in cases:
        dt = getattr(torch, dname)
        G = H // KVH
        qg = torch.randn((B, S, KVH, G, D), generator=gen,
                         device="cuda").to(dt)
        k = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(dt)
        q_hsd = qg.reshape(B, S, H, D).transpose(1, 2)
        k_hsd, v_hsd = k.transpose(1, 2), v.transpose(1, 2)

        def kernel():
            return flash_attention(qg, k, v, causal=causal, window=window)

        def plain():
            return attention_ref(q_hsd, k_hsd, v_hsd, causal=causal,
                                 window=window)

        mask = None
        if window:
            qi = torch.arange(S, device="cuda")[:, None]
            ki = torch.arange(S, device="cuda")[None, :]
            mask = (ki <= qi) & (ki > qi - window)
        qc, kc, vc = (t.contiguous() for t in (q_hsd, k_hsd, v_hsd))

        def library():
            return F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True)

        out = kernel()
        torch.cuda.synchronize()
        ref = plain().transpose(1, 2).reshape(B, S, KVH, G, D)
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item(),
              f"flash_attention non-finite at {(B, H, KVH, S, D)}")
        check(err <= TOL[dname],
              f"flash_attention {dname} {(B, H, KVH, S, D, causal, window)}"
              f" max_abs_err {err} > {TOL[dname]}")
        iters = 200 if S <= 128 else 50
        ms = cuda_time_ms(kernel, iters)
        plain_ms = cuda_time_ms(plain, iters)
        library_ms = cuda_time_ms(library, iters)
        floor_us = None
        if ((B, H, KVH, S, D, causal, window), dname) == (SERVE_CASE,
                                                         "float32"):
            dev_us, floor_us, dev_kernels = beside_floor(kernel)
        else:
            dev_us, dev_kernels = device_us(kernel)
        library_dev_us, _ = device_us(library)
        es = torch.finfo(dt).bits // 8
        nbytes = es * (2 * B * H * S * D + 2 * B * KVH * S * D)
        ops = 4 * D * B * H * attended_pairs(S, causal, window)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / PEAK_OPS[dname]
        row = {"shape": [B, H, KVH, S, D], "causal": causal,
               "window": window, "dtype": dname, "max_abs_err": err,
               "tol": TOL[dname], "ms": ms, "device_us": dev_us,
               "launch_floor_us": floor_us,
               "device_kernels": dev_kernels, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_device_us": library_dev_us,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        print("kernel_case " + json.dumps(row))
        results[((B, H, KVH, S, D, causal, window), dname)] = row
    print("kernels_checked " + json.dumps({"kernels": ["flash_attention_hsd"]}))
    return results


def phase_flash_bwd_kernel():
    """The training attention's kernels at TRAIN_FLASH_CASES: the forward
    with each row's log-sum-exp (O bitwise the serving forward's, lse
    against the plain version's) and the backward against its plain
    version on the kernel's o and lse (bitwise on a repeat), each with
    its ms, device time beside the launch floor, plain ms, the library's
    ms (SDPA's forward, and SDPA's backward through autograd) and its
    bound. Returns {kernel name: {case: row}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    from repro_torch.launch.profiling import beside_floor
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"flash_attention_fwd_lse": {}, "flash_attention_bwd": {}}

    def drawn(shape, offset):
        """a (B, S, X, D) draw, one `offset` floats into its buffer"""
        n = math.prod(shape)
        buf = torch.empty(n + offset, device="cuda")
        buf[offset:] = torch.randn(n, generator=gen, device="cuda")
        return buf[offset:].view(shape)

    for B, H, KVH, S, D, offset in (
            [(*c, 0) for c in TRAIN_FLASH_CASES]
            + [(*c, 1) for c in TRAIN_FLASH_UNALIGNED]):
        G = H // KVH
        qg = drawn((B, S, KVH, G, D), offset)
        k, v = (drawn((B, S, KVH, D), offset) for _ in range(2))
        q, kt, vt = (qg.reshape(B, S, H, D).transpose(1, 2),
                     k.transpose(1, 2), v.transpose(1, 2))
        do = drawn((B, S, H, D), offset).transpose(1, 2)
        o, lse = fk.flash_attention_fwd_lse(q, kt, vt)
        if offset:
            buf = torch.empty(o.numel() + offset, device="cuda")
            o = buf[offset:].view(B, S, H, D).copy_(
                o.transpose(1, 2)).transpose(1, 2)
        got = fk.flash_attention_bwd(q, kt, vt, o, lse, do)
        again = fk.flash_attention_bwd(q, kt, vt, o, lse, do)
        torch.cuda.synchronize()
        case = (B, H, KVH, S, D) + ((offset,) if offset else ())
        check(q.data_ptr() % 8 == 4 * offset % 8,
              f"flash_attention_bwd {case}: the operands' alignment")
        if offset:  # bitwise the vector instance's on aligned copies
            aligned = fk.flash_attention_bwd(
                *(t.contiguous() for t in (q, kt, vt, o)), lse,
                do.contiguous())
            check(all(torch.equal(a, b) for a, b in zip(got, aligned)),
                  f"flash_attention_bwd {case}: not bitwise the aligned "
                  f"operands' gradients")
        check(torch.equal(o, fk.flash_attention_hsd(q, kt, vt)),
              f"flash_attention_fwd_lse {case}: O not bitwise the serving "
              f"forward's")
        _, lse_ref = attention_lse_ref(q, kt, vt)
        lse_err = (lse - lse_ref).abs().max().item()
        check(lse_err <= TOL["float32"],
              f"flash_attention_fwd_lse {case}: lse max_abs_err {lse_err}")
        want = attention_bwd_ref(q, kt, vt, o, lse, do)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        check(all(torch.isfinite(a).all().item() for a in got),
              f"flash_attention_bwd {case}: non-finite gradients")
        check(err <= BWD_TOL * max(1.0, scale),
              f"flash_attention_bwd {case}: max_abs_err {err} > "
              f"{BWD_TOL} x max(1, {scale})")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_bwd {case}: a repeat is not bitwise")
        qc, kc, vc = (t.contiguous().requires_grad_() for t in (q, kt, vt))
        sdpa = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                              enable_gqa=True)
        dc = do.contiguous()
        pairs = attended_pairs(S, True, 0)
        specs = {
            "flash_attention_fwd_lse": dict(
                kernel=lambda: fk.flash_attention_fwd_lse(q, kt, vt),
                plain=lambda: attention_lse_ref(q, kt, vt),
                library=lambda: F.scaled_dot_product_attention(
                    qc.detach(), kc.detach(), vc.detach(), is_causal=True,
                    enable_gqa=True),
                nbytes=4 * (2 * B * H * S * D + 2 * B * KVH * S * D
                            + B * H * S),
                ops=4 * D * B * H * pairs, err=lse_err),
            "flash_attention_bwd": dict(
                kernel=lambda: fk.flash_attention_bwd(q, kt, vt, o, lse, do),
                plain=lambda: attention_bwd_ref(q, kt, vt, o, lse, do),
                library=lambda: torch.autograd.grad(
                    sdpa, (qc, kc, vc), dc, retain_graph=True),
                # q, o, dO, dq; k, v, dk, dv; lse
                nbytes=4 * (4 * B * H * S * D + 4 * B * KVH * S * D
                            + B * H * S),
                # s, dP, dQ, dK, dV: 2 D each per attended pair; Δ per row
                ops=B * H * (10 * D * pairs + 2 * D * S), err=err)}
        for name, sp in specs.items():
            dev_us, floor_us, dev_kernels = beside_floor(sp["kernel"])
            t_bytes = sp["nbytes"] / H100_BYTES_PER_S
            t_ops = sp["ops"] / PEAK_OPS["float32"]
            library_dev_us, _ = device_us(sp["library"])
            row = {"shape": list(case[:5]), "offset_floats": offset,
                   "max_abs_err": sp["err"],
                   "tol": BWD_TOL if name == "flash_attention_bwd"
                   else TOL["float32"],
                   "ms": cuda_time_ms(sp["kernel"], 200),
                   "device_us": dev_us, "launch_floor_us": floor_us,
                   "device_kernels": dev_kernels,
                   "plain_ms": cuda_time_ms(sp["plain"], 50),
                   "library_ms": cuda_time_ms(sp["library"], 200),
                   "library_device_us": library_dev_us,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": sp["nbytes"], "ops": sp["ops"]}
            print(f"{name}_case " + json.dumps(row))
            rows[name][case] = row
    return rows


def scan_tol(T):
    """The kernels fuse `b + c*acc` into one FMA where the plain loop
    rounds twice, and the discounted-return kernels compose the steps'
    maps in a scan over time, not in order: rtol = atol = 1e-5 at
    T <= 128, 1e-4 at T = 2048."""
    return 1e-5 if T <= 128 else 1e-4


def phase_scan_kernels():
    """The discounted-return scan, its adjoint and V-trace against their
    plain versions on the card; returns {name: row at the path shape}."""
    import torch
    from repro_torch.kernels.advantages.kernel import (
        discounted_return_adjoint_tb, discounted_return_tb)
    from repro_torch.kernels.advantages.ref import (
        discounted_return_adjoint_ref, discounted_return_ref)
    from repro_torch.kernels.vtrace.kernel import vtrace_tb
    from repro_torch.kernels.vtrace.ref import vtrace_ref
    from repro_torch.launch.profiling import beside_floor
    gen = torch.Generator(device="cuda").manual_seed(0)
    path = {}
    for T, B in SCAN_SHAPES:
        def mat(scale=1.0):
            return scale * torch.randn((T, B), generator=gen, device="cuda")
        base, g, rew, val = mat(), mat(), mat(), mat()
        coef = 0.99 * torch.rand((T, B), generator=gen, device="cuda")
        init = torch.randn((B,), generator=gen, device="cuda")
        log_rhos = mat(0.5)
        out = discounted_return_ref(base, coef, init)
        cases = {
            # name: (kernel, plain, bytes moved, f32 operations per (t, b))
            "discounted_return_tb": (
                lambda: (discounted_return_tb(base, coef, init),),
                lambda: (discounted_return_ref(base, coef, init),),
                4 * (3 * T * B + B), 2),
            "discounted_return_adjoint_tb": (
                lambda: discounted_return_adjoint_tb(g, coef, out, init),
                lambda: discounted_return_adjoint_ref(g, coef, out, init),
                4 * (5 * T * B + 2 * B), 3),
            "vtrace_tb": (
                lambda: vtrace_tb(log_rhos, coef, rew, val, init),
                lambda: vtrace_ref(log_rhos, coef, rew, val, init),
                4 * (6 * T * B + B), 16),
        }
        tol = scan_tol(T)
        for name, (kernel, plain, nbytes, ops_per) in cases.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err = 0.0
            for a, b in zip(got, want):
                check(torch.isfinite(a).all().item(),
                      f"{name} non-finite at {(T, B)}")
                check(bool(((a - b).abs() <= tol + tol * b.abs()).all()),
                      f"{name} {(T, B)} outside rtol = atol = {tol}")
                err = max(err, (a - b).abs().max().item())
            ms = cuda_time_ms(kernel, 200)
            plain_ms = cuda_time_ms(plain, 5 if T > 128 else 50, warmup=2)
            dev_us, floor_us, dev_kernels = beside_floor(kernel)
            t_bytes = nbytes / H100_BYTES_PER_S
            t_ops = ops_per * T * B / PEAK_OPS["float32"]
            # beside the bound: a serial chain of T dependent FMAs a column
            # (what a kernel that scans each column in order must take)
            t_chain = T * FMA_CYCLES / SM_CLOCK_HZ
            row = {"name": name, "shape": [T, B], "max_abs_err": err,
                   "tol": tol, "ms": ms, "device_us": dev_us,
                   "launch_floor_us": floor_us,
                   "device_kernels": dev_kernels, "plain_ms": plain_ms,
                   "library_ms": None,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops
                   else "operations", "bytes": nbytes,
                   "ops": ops_per * T * B, "chain_ms": t_chain * 1e3}
            print("kernel_case " + json.dumps(row))
            if (T, B) == SCAN_SHAPES[0]:
                path[name] = row
    print("kernels_checked " + json.dumps({"kernels": sorted(path)}))
    return path


def phase_replay_kernel():
    """The prioritized replay draw against its plain version on the card;
    returns its row at the path shape."""
    import torch
    from repro_torch.kernels.replay_sample.kernel import prioritized_sample_c
    from repro_torch.kernels.replay_sample.ref import prioritized_sample_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    path = None
    for C, size, n, ties in REPLAY_CASES:
        prio = torch.randn((C,), generator=gen, device="cuda").abs() + 0.01
        u = torch.rand((C,), generator=gen, device="cuda")
        gumbel = -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
        if ties:
            prio[1::7] = prio[0]
            gumbel[1::7] = gumbel[0]
        s = torch.tensor([size], dtype=torch.int32, device="cuda")

        def kernel():
            return prioritized_sample_c(prio, gumbel, s, n)

        def plain():
            return prioritized_sample_ref(prio, s[0], gumbel, n)

        nvalid = max(size, 1)
        valid = torch.arange(C, device="cuda") < nvalid
        scores = torch.where(valid, 0.6 * torch.log(prio + 1e-6) + gumbel,
                             -torch.inf)

        def library():
            return torch.topk(scores, n)

        idx, w = kernel()
        torch.cuda.synchronize()
        ridx, rw = plain()
        check(torch.equal(idx, ridx),
              f"prioritized_sample_c {(C, size, n, ties)}: indices differ "
              f"from the plain draw")
        check(torch.isfinite(w).all().item(),
              f"prioritized_sample_c non-finite weights at {(C, size, n)}")
        err = (w - rw).abs().max().item()
        check(bool(((w - rw).abs() <= REPLAY_TOL
                    + REPLAY_TOL * rw.abs()).all()),
              f"prioritized_sample_c {(C, size, n, ties)}: weights outside "
              f"rtol = atol = {REPLAY_TOL} (max_abs_err {err})")
        check(all(torch.equal(a, b) for a, b in zip(kernel(), (idx, w))),
              f"prioritized_sample_c {(C, size, n, ties)}: not bitwise "
              f"repeatable")
        iters = 20 if C > 100000 else 100
        ms = cuda_time_ms(kernel, iters)
        plain_ms = cuda_time_ms(plain, iters)
        library_ms = cuda_time_ms(library, iters)
        dev_us, dev_kernels = device_us(kernel)
        library_dev_us, _ = device_us(library)
        # the draw reads p and g of the filled slots (and size) and writes
        # idx and w; per filled slot ~6 f32 operations (log, mul, add,
        # exp, sub, add)
        nbytes = 8 * nvalid + 4 + 8 * n
        ops = 6 * nvalid
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / PEAK_OPS["float32"]
        row = {"name": "prioritized_sample_c", "shape": [C, size, n],
               "ties": ties, "max_abs_err": err, "tol": REPLAY_TOL,
               "ms": ms, "device_us": dev_us, "device_kernels": dev_kernels,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_us": library_dev_us,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        print("kernel_case " + json.dumps(row))
        if path is None:
            path = row
    print("kernels_checked " + json.dumps(
        {"kernels": ["prioritized_sample_c"]}))
    return path


def phase_shard_kernel():
    """The sharded replay service's per-shard draw against its plain
    version on the card; returns its row at the replay=2 path shape."""
    import torch
    from repro_torch.kernels.replay_sample.kernel import shard_topk_c
    from repro_torch.kernels.replay_sample.ref import \
        shard_gumbel_topk_stack_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    path = None
    for R, chunk, counts, k, ties in SHARD_CASES:
        prio = torch.randn((R, chunk), generator=gen,
                           device="cuda").abs() + 0.01
        u = torch.rand((R, chunk), generator=gen, device="cuda")
        gumbel = -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
        if ties:
            prio[:, 1::7] = prio[:, :1]
            gumbel[:, 1::7] = gumbel[:, :1]
        nvalid = torch.tensor(counts, dtype=torch.int32, device="cuda")

        def kernel():
            return shard_topk_c(prio, gumbel, nvalid, k)

        def plain():
            return shard_gumbel_topk_stack_ref(prio, nvalid, gumbel, k)

        valid = torch.arange(chunk, device="cuda") < nvalid[:, None]
        scores = torch.where(valid, 0.6 * torch.log(prio + 1e-6) + gumbel,
                             -torch.inf)

        def library():
            return torch.topk(scores, k, dim=-1)

        s, idx = kernel()
        torch.cuda.synchronize()
        rs, ridx = plain()
        case = (R, chunk, counts, k, ties)
        check(torch.equal(idx, ridx),
              f"shard_topk_c {case}: indices differ from the plain draw")
        check(torch.equal(s, rs),
              f"shard_topk_c {case}: scores not bitwise the plain draw's")
        err = (s - rs).abs().nan_to_num(0.0).max().item()
        iters = 20 if chunk > 100000 else 100
        ms = cuda_time_ms(kernel, iters)
        plain_ms = cuda_time_ms(plain, iters)
        library_ms = cuda_time_ms(library, iters)
        dev_us, dev_kernels = device_us(kernel)
        library_dev_us, _ = device_us(library)
        # the draw reads p and g of the filled slots and the R counts, and
        # writes R*k (score, index) pairs; ~4 f32 operations per filled
        # slot (add, log, mul, add)
        filled = sum(counts)
        nbytes = 8 * filled + 8 * R * k + 4 * R
        ops = 4 * filled
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / PEAK_OPS["float32"]
        row = {"name": "shard_topk_c", "shape": [R, chunk, list(counts), k],
               "ties": ties, "max_abs_err": err, "tol": 0.0, "ms": ms,
               "device_us": dev_us, "device_kernels": dev_kernels,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_us": library_dev_us,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        print("kernel_case " + json.dumps(row))
        if path is None:
            path = row
    print("kernels_checked " + json.dumps({"kernels": ["shard_topk_c"]}))
    return path


def phase_slice(card):
    import numpy as np
    import torch
    import repro_torch.envs as envs
    from repro_torch.core.networks import TrunkPolicy
    from repro_torch.core.serving import ParamStore, ServeEngine
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_hsd
    from repro_torch.launch.serve_policy import run_offered_load

    runs = []
    flash_attention_hsd.launches = 0
    for name in ("cartpole", "pendulum"):
        spec = envs.make(name).spec
        policy = TrunkPolicy.for_spec(spec, reduced=False)
        check(policy.lm.cfg.d_model == 256 and policy.lm.cfg.n_layers == 4
              and policy.lm.cfg.n_kv_heads == 2, "not the full-width trunk")
        params = policy.init(torch.Generator().manual_seed(0))
        swap = {k: v * (1 + 1e-3) for k, v in params.items()}
        obs_rows = spec.observation.sample(
            torch.Generator().manual_seed(1), 160).numpy()
        for buckets in ((1, 4, 16), (8, 32)):
            store = ParamStore()
            store.publish(params)
            engine = ServeEngine(policy, spec.observation, buckets=buckets,
                                 store=store, seed=0)
            warm = engine.warmup()
            cells = [run_offered_load(engine, obs_rows, load, 160,
                                      swap_params=swap)
                     for load in (500.0, 2000.0)]
            check(engine.compile_count == warm,
                  f"{name} {buckets}: compile_count rose after warmup "
                  f"({warm} -> {engine.compile_count})")
            runs.append((name, buckets, policy, params, engine, obs_rows,
                         cells))
    launches = flash_attention_hsd.launches
    dispatches = sum(r[4].stats["batches"] for r in runs)
    n_layers = 4
    check(launches >= n_layers * dispatches > 0,
          f"flash_attention_hsd launched {launches} times over "
          f"{dispatches} dispatches; expected {n_layers} per dispatch")
    print(f"slice: {dispatches} dispatches, flash_attention_hsd launches "
          f"{launches} ({launches / dispatches:g} per dispatch)")

    # checks below launch the kernel again; they are not the main path
    for name, buckets, policy, params, engine, obs_rows, cells in runs:
        space = envs.make(name).spec.action
        for r in engine.results.values():
            check(math.isfinite(r["logp"]) and math.isfinite(r["value"]),
                  f"{name}: non-finite response {r}")
            check(space.contains(np.asarray(r["action"])),
                  f"{name}: action {r['action']} outside {space}")
        check(all(c["versions"] >= 2 and c["hot_swaps"] == 1 for c in cells),
              f"{name} {buckets}: hot swap not served")
        b = buckets[-1]
        _, cur = engine.store.get()
        a_b, l_b, v_b = engine.eval_bucket(list(obs_rows[:5]), range(5), b,
                                           params=cur)
        for i in range(5):
            a1, l1, v1 = engine.eval_bucket([obs_rows[i]], [i], b,
                                            params=cur)
            check(torch.equal(a_b[i], a1[0]) and torch.equal(l_b[i], l1[0])
                  and torch.equal(v_b[i], v1[0]),
                  f"{name} bucket {b}: row {i} not bitwise per-request")
        for c in cells:
            print("slice_cell " + json.dumps(dict(
                c, env=name, buckets="-".join(map(str, buckets)),
                card=card)))
    for name in ("cartpole", "pendulum"):
        run = next(r for r in runs if r[0] == name)
        policy, params, obs_rows = run[2], run[3], run[5]
        plain = TrunkPolicy.for_spec(envs.make(name).spec, reduced=False,
                                     use_kernels=False)
        obs = torch.as_tensor(obs_rows[:32], device="cuda")
        with torch.inference_mode():
            pk, vk = policy.apply(params, obs)
            pr, vr = plain.apply(params, obs)
        err = max((pk - pr).abs().max().item(), (vk - vr).abs().max().item())
        check(err <= 1e-4, f"{name}: kernel path vs use_kernels=False "
                           f"max_abs_err {err} > 1e-4")
        print(f"slice {name}: kernel path vs use_kernels=False "
              f"max_abs_err {err:.3e}")
    return launches


def train_counters():
    from repro_torch.kernels.advantages.kernel import (
        discounted_return_adjoint_tb, discounted_return_tb)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd, flash_attention_fwd_lse)
    from repro_torch.kernels.replay_sample.kernel import (
        prioritized_sample_c, shard_topk_c)
    from repro_torch.kernels.vtrace.kernel import vtrace_tb
    return {f.__name__: f for f in (discounted_return_tb,
                                    discounted_return_adjoint_tb,
                                    vtrace_tb, prioritized_sample_c,
                                    shard_topk_c, flash_attention_fwd_lse,
                                    flash_attention_bwd)}


# each algorithm's scan or draw kernel launches an iteration
ALGO_KERNELS = {"ppo": {"discounted_return_tb": 1},
                "a3c": {"discounted_return_tb": 1,
                        "discounted_return_adjoint_tb": 1},
                "impala": {"vtrace_tb": 1},
                "dqn": {"prioritized_sample_c": 1}}


def trunk_launches(algo, n_layers):
    """A trunk fit's kernel launches an iteration: its algorithm's, and
    the training attention's forward with lse and backward per layer."""
    fwd, bwd = TRUNK_LAUNCHES[algo]
    return dict(ALGO_KERNELS[algo], flash_attention_fwd_lse=fwd * n_layers,
                flash_attention_bwd=bwd * n_layers)


def phase_training(card, path_rows):
    """Drive the training path; returns the launch counts of the run."""
    import torch
    from repro_torch.core.trainer import Trainer, TrainerConfig
    from repro_torch.envs.gridworld import GridWorld
    from repro_torch.launch.rl_train import main as rl_main
    import repro_torch.envs as envs
    counters = train_counters()
    cfg = TrainerConfig()          # the default config: 60 x 32 x 32
    grid = TrainerConfig(algo="dqn", **GRID_CFG)
    trunk = dataclasses.replace(cfg, iters=TRUNK_ITERS, superstep=TRUNK_ITERS,
                                log_every=1)

    def trunk_fit(algo):
        """A full-width trunk fit through Trainer (4 layers, d_model
        256, D 64)."""
        run = dataclasses.replace(trunk, algo=algo, algo_kwargs={
            "policy": "trunk", "trunk_kwargs": {"reduced": False}})
        trainer = Trainer(envs.make("cartpole"), run)
        check(trainer.agent.policy.lm.cfg.d_model == 256
              and trainer.agent.policy.lm.cfg.n_layers == 4,
              "not the full-width trunk")
        return trainer.fit()[1]

    def rl_train(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, _, history = rl_main(argv)
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(json.dumps(out["history"]) == json.dumps(history[-5:]),
              f"rl_train {argv}: printed history {out['history']}")
        return history

    # (label, algo, env, config, run it, launches per iteration, bar as
    # (number of last logged returns, threshold) or None)
    runs = [
        (algo, algo, "cartpole", cfg,
         lambda algo=algo: rl_train(["--algo", algo, "--env", "cartpole"]),
         ALGO_KERNELS[algo], (2, BARS[algo]))
        for algo in ("ppo", "a3c", "impala")
    ] + [
        ("ppo-pendulum", "ppo", "pendulum",
         dataclasses.replace(cfg, iters=20),
         lambda: rl_train(["--algo", "ppo", "--env", "pendulum",
                           "--iters", "20"]),
         ALGO_KERNELS["ppo"], None),
        ("dqn", "dqn", "cartpole", cfg,
         lambda: rl_train(["--algo", "dqn", "--env", "cartpole"]),
         ALGO_KERNELS["dqn"], None),
    ] + [
        (f"{algo}-{mech}", algo, "cartpole",
         dataclasses.replace(cfg, iters=SYNC_ITERS),
         lambda algo=algo, mech=mech: rl_train([
             "--algo", algo, "--env", "cartpole", "--sync", mech,
             "--iters", str(SYNC_ITERS)]),
         ALGO_KERNELS[algo], None)
        for algo in ("ppo", "dqn") for mech in ("asp", "ssp")
    ] + [
        (f"dqn-gridworld-seed{seed}", "dqn", "gridworld(4,16)",
         dataclasses.replace(grid, seed=seed),
         lambda seed=seed: Trainer(GridWorld(n=4, max_steps=16),
                                   dataclasses.replace(grid, seed=seed)
                                   ).fit()[1],
         ALGO_KERNELS["dqn"], (4, None)) for seed in GRID_SEEDS
    ] + [
        ("ppo-pendulum-norm", "ppo", "pendulum-norm",
         dataclasses.replace(cfg, iters=SYNC_ITERS),
         lambda: rl_train(["--algo", "ppo", "--env", "pendulum-norm",
                           "--iters", str(SYNC_ITERS)]),
         ALGO_KERNELS["ppo"], None),
        ("impala-cartpole-repeat", "impala", "cartpole-repeat",
         dataclasses.replace(cfg, iters=SYNC_ITERS),
         lambda: rl_train(["--algo", "impala", "--env", "cartpole-repeat",
                           "--iters", str(SYNC_ITERS)]),
         ALGO_KERNELS["impala"], None),
    ] + [
        (f"{algo}-trunk", algo, "cartpole", trunk,
         lambda algo=algo: rl_train([
             "--algo", algo, "--env", "cartpole", "--policy", "trunk",
             "--iters", str(TRUNK_ITERS), "--superstep", str(TRUNK_ITERS),
             "--log-every", "1"]),
         trunk_launches(algo, 2), None) for algo in ("ppo", "a3c", "impala",
                                                     "dqn")
    ] + [
        (f"{algo}-trunk-full-width", algo, "cartpole", trunk,
         lambda algo=algo: trunk_fit(algo), trunk_launches(algo, 4), None)
        for algo in ("ppo", "impala")]
    for fn in counters.values():
        fn.launches = 0
    totals = dict.fromkeys(counters, 0)
    grid_means = []
    for label, algo, env, run_cfg, drive, per_iter, bar in runs:
        iters = run_cfg.iters
        before = {n: f.launches for n, f in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: f.launches - before[n] for n, f in counters.items()}
        want = {n: per_iter.get(n, 0) * iters for n in counters}
        check(got == want, f"{label}: kernel launches {got}, expected "
                           f"{want}")
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"{label}: non-finite loss in {hist}")
        n_last, threshold = bar or (2, None)
        rets = [h["episode_return"] for h in hist[-n_last:]]
        mean_ret = sum(rets) / len(rets)
        check(math.isfinite(mean_ret), f"{label}: returns {rets}")
        if threshold is not None:
            check(mean_ret >= threshold,
                  f"{label}: mean of the last {n_last} logged returns "
                  f"{mean_ret} below the bar {threshold}")
        env_steps = iters * run_cfg.n_envs * run_cfg.unroll
        share = {n: got[n] * path_rows[n]["ms"] / (wall * 1e3)
                 for n in counters if got[n]}
        print("train_run " + json.dumps({
            "run": label, "algo": algo, "env": env, "iters": iters,
            "n_envs": run_cfg.n_envs, "unroll": run_cfg.unroll,
            "wall_s": wall, "ms_per_iter": wall * 1e3 / iters,
            "env_steps_per_s": env_steps / wall, "launches": got,
            "kernel_share_of_wall": share, "last_returns": rets,
            "mean_last": mean_ret, "bar": threshold, "history": hist,
            "card": card}))
        for n in counters:
            totals[n] += got[n]
        if label.startswith("dqn-gridworld"):
            grid_means.append(mean_ret)
    grid_mean = sum(grid_means) / len(grid_means)
    print("train_bar " + json.dumps({
        "run": "dqn-gridworld", "seeds": list(GRID_SEEDS),
        "mean_last_four": grid_means, "mean_over_seeds": grid_mean,
        "bar": GRID_BAR, "card": card}))
    check(grid_mean >= GRID_BAR,
          f"dqn-gridworld: mean over seeds {list(GRID_SEEDS)} of the mean "
          f"of the last four logged returns {grid_mean} below the bar "
          f"{GRID_BAR}")
    return totals


def tree_equal(a, b):
    """Bitwise equality of two nests of dicts of tensors."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k])
                                            for k in a)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def phase_replay_training(card, shard_row):
    """Drive the slice's main path, dqn on the sharded replay service
    through `rl_train --plan`, once per replay axis size; returns the
    shard_topk_c launches of those runs."""
    import torch
    import repro_torch.envs as envs
    from repro_torch.core.distribution import DistPlan
    from repro_torch.core.positions import tree_leaves, tree_map
    from repro_torch.core.trainer import Trainer, TrainerConfig
    from repro_torch.envs.host_env import HostPipelined
    from repro_torch.launch.rl_train import main as rl_main
    counters = train_counters()
    cfg = TrainerConfig(algo="dqn")          # the default config
    hist_json = lambda h: json.dumps(h)      # NaN-safe equality
    flat_state, flat_hist = Trainer(envs.make("cartpole"), dataclasses.replace(
        cfg, algo_kwargs={"use_kernel": False})).fit()
    total = 0
    for R in REPLAY_SHARDS:
        spec = f"workers=1:allreduce:bsp,replay={R}:allreduce:bsp:replay"
        argv = ["--algo", "dqn", "--env", "cartpole", "--plan", spec]
        # the main path: counts at 0 just before, read just after
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trainer, state, hist = rl_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: f.launches for n, f in counters.items()}
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        want = dict.fromkeys(counters, 0)
        want["shard_topk_c"] = cfg.iters
        check(got == want, f"dqn replay={R}: kernel launches {got}, "
                           f"expected {want}")
        check(out["partition_replay"] == {
            "axis": "replay", "n_shards": R, "capacity": 20000,
            "chunk": 20000 // R} and out["plan"] == spec
            and out["n_devices"] == R, f"dqn replay={R}: CLI line {out}")
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"dqn replay={R}: non-finite loss in {hist}")
        total += got["shard_topk_c"]
        # checks below are not the main path
        plain_state, plain_hist = Trainer(
            envs.make("cartpole"), dataclasses.replace(
                cfg, plan=DistPlan.replay(1, R),
                algo_kwargs={"use_kernel": False})).fit()
        check(counters["shard_topk_c"].launches == got["shard_topk_c"],
              f"dqn replay={R}: the use_kernel=False fit launched the "
              f"kernel")
        for what, a, b in (("kernel vs plain", state, plain_state),
                           ("plain vs flat plain", plain_state,
                            flat_state)):
            for part in ("params", "opt_state", "extra", "ring"):
                check(tree_equal(getattr(a, part), getattr(b, part)),
                      f"dqn replay={R} {what}: {part} not bitwise equal")
        check(hist_json(hist) == hist_json(plain_hist) == hist_json(
            flat_hist), f"dqn replay={R}: histories differ")
        check(state.extra["replay"]["prio"].shape == (20000,),
              f"dqn replay={R}: fit did not return the flat buffer")
        iters = cfg.iters
        print("train_run " + json.dumps({
            "run": f"dqn-replay{R}", "algo": "dqn", "env": "cartpole",
            "plan": spec, "iters": iters, "n_envs": cfg.n_envs,
            "unroll": cfg.unroll, "wall_s": wall,
            "ms_per_iter": wall * 1e3 / iters,
            "env_steps_per_s": iters * cfg.n_envs * cfg.unroll / wall,
            "launches": got, "kernel_share_of_wall": {
                "shard_topk_c": got["shard_topk_c"] * shard_row["ms"]
                / (wall * 1e3)},
            "partition_replay": out["partition_replay"],
            "bitwise": ["kernel vs use_kernel=False", "vs flat plain"],
            "last_returns": [h["episode_return"] for h in hist[-2:]],
            "history": hist, "card": card}))
    return total


def phase_distribution(card, path_rows=None):
    """Drive the slice's main path: plans with several data positions on
    the one card through `rl_train`; returns the launch counts of its
    runs."""
    import torch
    import repro_torch.envs as envs
    from repro_torch.core.distribution import DistPlan
    from repro_torch.core.positions import tree_leaves, tree_map
    from repro_torch.core.trainer import Trainer, TrainerConfig
    from repro_torch.envs.host_env import HostPipelined
    from repro_torch.launch.rl_train import main as rl_main
    counters = train_counters()
    totals = dict.fromkeys(counters, 0)

    def run(label, argv, per_iter, W, bar=None):
        """One rl_train fit, counts at 0 just before and read just after;
        gated on W x the flat run's launches and finite losses."""
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trainer, state, hist = rl_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: f.launches for n, f in counters.items()}
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        iters, cfg = trainer.cfg.iters, trainer.cfg
        want = {n: W * per_iter.get(n, 0) * iters for n in counters}
        check(got == want, f"{label}: kernel launches {got}, expected "
                           f"{want}")
        check(trainer.n_positions == W, f"{label}: {trainer.n_positions} "
                                        f"positions, expected {W}")
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"{label}: non-finite loss in {hist}")
        rets = [h["episode_return"] for h in hist[-2:]]
        mean_ret = sum(rets) / len(rets)
        if bar is not None:
            check(mean_ret >= bar, f"{label}: mean of the last two logged "
                                   f"returns {mean_ret} below the bar {bar}")
        share = {n: got[n] * path_rows[n]["ms"] / (wall * 1e3)
                 for n in counters if got[n] and path_rows
                 and n in path_rows}
        print("train_run " + json.dumps({
            "run": label, "algo": cfg.algo, "env": "cartpole",
            "plan": out["plan"], "W": W, "n_devices": out["n_devices"],
            "iters": iters, "n_envs": cfg.n_envs, "unroll": cfg.unroll,
            "wall_s": wall, "ms_per_iter": wall * 1e3 / iters,
            "env_steps_per_s": iters * cfg.n_envs * cfg.unroll / wall,
            "launches": got, "kernel_share_of_wall": share,
            "actor_shards": out["actor_shards"], "last_returns": rets,
            "mean_last": mean_ret, "bar": bar, "history": hist,
            "card": card}))
        for n in counters:
            totals[n] += got[n]
        return trainer, state, hist, out

    workers = ["--n-workers", str(DIST_W)]
    # 1. the main path at the default config
    for algo in ("impala", "ppo", "a3c", "dqn"):
        run(f"{algo}-w{DIST_W}", ["--algo", algo, "--env", "cartpole",
                                  "--iters", str(DIST_ITERS[algo])] + workers,
            ALGO_KERNELS[algo], DIST_W, DIST_BARS.get(algo))
    # 2. nested all-allreduce plans: bitwise the flat plan
    short = ["--algo", "impala", "--env", "cartpole", "--iters",
             str(DIST_SHORT), "--log-every", "1"]
    fits = {}
    for label, flags in (
            ("flat", workers),
            ("1x4", ["--plan", "hosts=1:allreduce:bsp,workers=4:allreduce:"
                     "bsp"]),
            ("2x2", ["--plan", "hosts=2:allreduce:bsp,workers=2:allreduce:"
                     "bsp"]),
            ("ps", workers + ["--topology", "ps"])):
        _, state, hist, _ = run(f"impala-{label}", short + flags,
                                ALGO_KERNELS["impala"], DIST_W)
        fits[label] = (state, hist)
    flat_state, flat_hist = fits["flat"]
    for label in ("1x4", "2x2"):
        state, hist = fits[label]
        check(tree_equal(state.params, flat_state.params)
              and json.dumps(hist) == json.dumps(flat_hist),
              f"impala {label}: not bitwise the flat 4-worker fit")
    a, p = flat_hist[-1]["loss"], fits["ps"][1][-1]["loss"]
    check(abs(p - a) <= 1e-3 * abs(a), f"impala ps last loss {p} against "
                                       f"allreduce {a}: beyond rel 1e-3")
    print(f"dist nested: flat, 1x4 and 2x2 bitwise; ps {p} vs allreduce {a}")
    # 3. mixed topologies and sync
    run("impala-2x2-allreduce-gossip-asp", short + [
        "--plan", "hosts=2:allreduce:bsp,workers=2:gossip:asp"],
        ALGO_KERNELS["impala"], DIST_W)
    run("impala-ssp-w4", short + workers + ["--sync", "ssp"],
        ALGO_KERNELS["impala"], DIST_W)
    # 4. elastic actors= schedules (examples/es_cartpole.py's baseline)
    actors, iters, superstep = DIST_ELASTIC
    sched = [int(n) for n in actors.split(",")]
    for W in (1, DIST_W):
        trainer, _, _, out = run(
            f"a3c-actors-w{W}", ["--algo", "a3c", "--env", "cartpole",
                                 "--iters", str(iters), "--superstep",
                                 str(superstep), "--actors", actors,
                                 "--n-envs", str(sched[0]),
                                 "--n-workers", str(W)],
            ALGO_KERNELS["a3c"], W)
        want = [sched[i % len(sched)] for i in range(iters // superstep)]
        check(trainer.actor_shards == want, f"a3c actors W={W}: "
              f"actor_shards {trainer.actor_shards}, expected {want}")
    # 5. the replay service under two positions
    spec = "workers=2:allreduce:bsp,replay=2:allreduce:bsp:replay"
    _, state, _, out = run("dqn-w2-replay2", [
        "--algo", "dqn", "--env", "cartpole", "--iters",
        str(DIST_ITERS["dqn"]), "--plan", spec],
        {"shard_topk_c": 1}, 2)
    check(out["partition_replay"] == {
        "axis": "replay", "n_shards": 2, "capacity": 20000, "chunk": 10000}
        and out["n_devices"] == 4, f"dqn w2 x replay2: CLI line {out}")
    check(state.extra["replay"]["prio"].shape == (20000,),
          "dqn w2 x replay2: fit did not return the flat buffer")
    # 6. the reduced trunk at two positions: twice the flat launches
    run("impala-trunk-w2", ["--algo", "impala", "--env", "cartpole",
                            "--policy", "trunk", "--iters", str(TRUNK_ITERS),
                            "--superstep", str(TRUNK_ITERS), "--log-every",
                            "1", "--n-workers", "2"],
        trunk_launches("impala", 2), 2)
    # 7. kernel path against use_kernel=False (not the main path)
    cfg = TrainerConfig(algo="impala", iters=DIST_SHORT,
                        plan=DistPlan.flat(DIST_W))
    kern, _ = Trainer(envs.make("cartpole"), cfg).fit()
    before = counters["vtrace_tb"].launches
    plain, _ = Trainer(envs.make("cartpole"), dataclasses.replace(
        cfg, algo_kwargs={"use_kernel": False})).fit()
    check(counters["vtrace_tb"].launches == before,
          "the use_kernel=False fit launched vtrace_tb")
    err = max((kern.params[k] - plain.params[k]).abs().max().item()
              for k in kern.params)
    print(f"dist kernel vs plain: impala W={DIST_W} {DIST_SHORT}-iteration "
          f"fit params max_abs_err {err:.3e}")
    check(err <= DIST_TOL, f"impala W={DIST_W}: kernel vs plain params "
                           f"max_abs_err {err} > {DIST_TOL}")
    return totals, fits["flat"]


def state_equal(a, b, parts=("params", "opt_state", "extra", "ring",
                             "steps")):
    """Bitwise equality of two TrainStates, part by part: the names of the
    parts that differ."""
    import torch
    from repro_torch.core.positions import tree_leaves
    bad = []
    for part in parts:
        la, lb = tree_leaves(getattr(a, part)), tree_leaves(getattr(b, part))
        if len(la) != len(lb) or not all(
                x.shape == y.shape and x.dtype == y.dtype
                and torch.equal(x, y) for x, y in zip(la, lb)):
            bad.append(part)
    return bad


def phase_pipeline_zero(card, path_rows, flat4):
    """Drive the slice's main paths: the pipelined actor-learner and the
    ZeRO-2/3 sharded learner states on the one card, through `rl_train`
    where a flag reaches them; returns the launch counts of its runs.
    `flat4` is the distribution phase's 10-iteration impala flat(4) fit
    (state, history), which the ZeRO fits must equal bitwise."""
    import torch
    import repro_torch.envs as envs
    from repro_torch.checkpoint import load_train_state, save_train_state
    from repro_torch.core import agent as agent_api
    from repro_torch.core.distribution import DistPlan
    from repro_torch.core.serving import ParamStore, ServeEngine
    from repro_torch.core.topology import ZeRO3Agent
    from repro_torch.core.positions import tree_leaves, tree_map
    from repro_torch.core.trainer import Trainer, TrainerConfig
    from repro_torch.envs.host_env import HostPipelined
    from repro_torch.launch.rl_train import main as rl_main
    counters = train_counters()
    totals = dict.fromkeys(counters, 0)
    hist_json = lambda h: json.dumps(h)      # NaN-safe equality

    def drive(label, fit, per_iter, W, bar=None):
        """One fit (`fit()` -> (trainer, state, history, CLI line or
        None)), counts at 0 just before and read just after; gated on W
        x `per_iter` launches per consumed iteration and finite losses."""
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, state, hist, out = fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: f.launches for n, f in counters.items()}
        cfg = trainer.cfg
        want = {n: W * per_iter.get(n, 0) * cfg.iters for n in counters}
        check(got == want, f"{label}: kernel launches {got}, expected "
                           f"{want}")
        check(trainer.n_positions == W, f"{label}: {trainer.n_positions} "
                                        f"positions, expected {W}")
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"{label}: non-finite loss in {hist}")
        if out is not None:
            check(out["pipeline_depth"] == trainer.pipeline_depth
                  and out["pipeline_capacity"] == trainer.pipeline_capacity
                  and out["partition"] == trainer.partition
                  and hist_json(out["history"]) == hist_json(hist[-5:]),
                  f"{label}: CLI line {out}")
        rets = [h["episode_return"] for h in hist[-2:]]
        mean_ret = sum(rets) / len(rets)
        if bar is not None:
            check(mean_ret >= bar, f"{label}: mean of the last two logged "
                                   f"returns {mean_ret} below the bar {bar}")
        share = {n: got[n] * path_rows[n]["ms"] / (wall * 1e3)
                 for n in counters if got[n] and n in path_rows}
        print("train_run " + json.dumps({
            "run": label, "algo": cfg.algo, "plan": trainer.plan.describe(),
            "W": W, "pipeline": cfg.pipeline,
            "pipeline_depth": trainer.pipeline_depth,
            "partition": trainer.partition, "iters": cfg.iters,
            "n_envs": cfg.n_envs, "unroll": cfg.unroll, "wall_s": wall,
            "ms_per_iter": wall * 1e3 / cfg.iters,
            "env_steps_per_s": cfg.iters * cfg.n_envs * cfg.unroll / wall,
            "launches": got, "kernel_share_of_wall": share,
            "state_bytes": trainer.state_bytes,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "last_returns": rets, "mean_last": mean_ret, "bar": bar,
            "history": hist, "card": card}))
        for n in counters:
            totals[n] += got[n]
        return trainer, state, hist

    def cli(argv):
        def fit():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer, state, hist = rl_main(argv)
            out = json.loads(buf.getvalue().strip().splitlines()[-1])
            return trainer, state, hist, out
        return fit

    def trainer_fit(cfg, full_width=False, env="cartpole"):
        def fit():
            tr = Trainer(env if isinstance(env, envs.Env) else
                         envs.make(env), cfg)
            if full_width:
                check(tr.agent.policy.lm.cfg.d_model == 256
                      and tr.agent.policy.lm.cfg.n_layers == 4,
                      "not the full-width trunk")
            state, hist = tr.fit()
            return tr, state, hist, None
        return fit

    def same(label, a, ha, b, hb, parts=("params", "opt_state", "extra",
                                         "ring", "steps")):
        bad = state_equal(a, b, parts)
        check(not bad and hist_json(ha) == hist_json(hb),
              f"{label}: not bitwise ({bad or 'history'})")

    base = ["--env", "cartpole"]
    ssp = ["--sync", "ssp", "--staleness-bound", "1", "--pipeline"]
    # 1. the pipelined fits at ssp depth 1 (one position)
    for algo in ("ppo", "a3c", "impala", "dqn"):
        tr, _, _ = drive(f"{algo}-pipeline-ssp1", cli(
            ["--algo", algo, "--iters", str(PIPE_ITERS[algo])] + base + ssp),
            ALGO_KERNELS[algo], 1, PIPE_BARS.get(algo))
        check((tr.pipeline_depth, tr.pipeline_capacity) == (1, 1),
              f"{algo} ssp: depth {tr.pipeline_depth}")
    algo, iters, depth = PIPE_ASP
    tr, _, _ = drive(f"{algo}-pipeline-asp{depth}", cli(
        ["--algo", algo, "--iters", str(iters), "--sync", "asp",
         "--max-delay", str(depth), "--pipeline"] + base),
        ALGO_KERNELS[algo], 1)
    check((tr.pipeline_depth, tr.pipeline_capacity) == (depth, depth),
          f"{algo} asp: depth {tr.pipeline_depth}")
    # 2. depth 0 is the fused fit; chunking a depth-1 fit changes nothing
    short = ["--iters", str(DIST_SHORT), "--log-every", "1"] + base
    for algo in ("impala", "dqn"):
        fits = {}
        for label, flags in (
                ("fused", []), ("pipeline-d0", ["--pipeline"]),
                ("pipeline-ssp1-k2", ssp + ["--superstep", "2"]),
                ("pipeline-ssp1-k10", ssp + ["--superstep", "10"])):
            _, state, hist = drive(f"{algo}-{label}", cli(
                ["--algo", algo] + short + flags), ALGO_KERNELS[algo], 1)
            fits[label] = (state, hist)
        same(f"{algo} depth 0 vs fused", *fits["fused"],
             *fits["pipeline-d0"])
        same(f"{algo} depth 1 k=2 vs k=10", *fits["pipeline-ssp1-k2"],
             *fits["pipeline-ssp1-k10"])
    print("pipe bitwise: depth 0 = fused, depth-1 k=2 = k=10 (impala, dqn)")
    # 2b. HostPipelined: the env stepped on the host, the card's tensors
    # crossing to it and back every step. One cartpole step comes back on
    # the card holding the host's numbers bitwise; a depth-1 impala fit
    # on gridworld (integer moves, correctly rounded obs: the same bits
    # on either device) is bitwise the on-device env's fit
    cart = envs.make("cartpole")
    s0 = cart.reset(torch.Generator(device="cuda").manual_seed(3), 64)
    act = torch.randint(0, 2, (64,), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(4))
    got = HostPipelined(cart).step({"inner": s0, "wrap": {}}, act)
    want = cart.step(tree_map(lambda a: a.cpu(), s0), act.cpu())
    dev = cart.step(s0, act)
    check(all(a.is_cuda and torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(got[0]["inner"]) + list(got[1:]),
        tree_leaves(want[0]) + list(want[1:]))),
        "HostPipelined: a cartpole step is not the host's step, on the card")
    print("host env step: " + json.dumps({
        "bitwise_host": True, "max_abs_vs_device_step": float(
            (got[1] - dev[1]).abs().max())}))
    host_cfg = TrainerConfig(algo="impala", iters=DIST_SHORT, superstep=5,
                             log_every=1, pipeline=True,
                             plan=DistPlan.flat(1, sync="ssp",
                                                staleness_bound=1,
                                                max_delay=1))
    fits = {label: drive(f"impala-gridworld-pipeline-ssp1-{label}",
                         trainer_fit(host_cfg, env=env),
                         ALGO_KERNELS["impala"], 1)[1:]
            for label, env in (
                ("device", "gridworld"),
                ("host", HostPipelined(envs.make("gridworld"))))}
    same("impala HostPipelined vs on-device gridworld, depth 1",
         *fits["device"], *fits["host"])
    print("pipe bitwise: HostPipelined = on-device env (impala, depth 1)")
    # 3. ZeRO-2 and ZeRO-3: bitwise the distribution phase's flat(4)
    flat_state, flat_hist = flat4
    zero_fits = {}
    for role in ("shard", "zero3"):
        spec = f"workers=2:allreduce:bsp,shard=2:allreduce:bsp:{role}"
        tr, state, hist = drive(f"impala-{role}-2x2", cli(
            ["--algo", "impala", "--plan", spec] + short),
            ALGO_KERNELS["impala"], 4)
        same(f"impala {role}(2, 2) vs flat(4)", flat_state, flat_hist,
             state, hist)
        zero_fits[role] = (tr, state)
    print("zero bitwise: impala zero(2, 2) and zero3(2, 2) = flat(4)")
    # 4. dqn zero3 + replay against flat(2); the per-shard draw is bitwise
    # the plain draw (the sharded-replay phase), the flat draw's kernel
    # only within 1e-5 in its weights, so the flat fit runs plain
    spec = ("workers=1:allreduce:bsp,shard=2:allreduce:bsp:zero3,"
            "replay=2:allreduce:bsp:replay")
    _, state, hist = drive("dqn-zero3-replay", cli(
        ["--algo", "dqn", "--plan", spec, "--iters", str(ZERO_DQN_ITERS)]
        + base), {"shard_topk_c": 1}, 2)
    _, fstate, fhist = drive("dqn-w2-plain", trainer_fit(TrainerConfig(
        algo="dqn", iters=ZERO_DQN_ITERS, plan=DistPlan.flat(2),
        algo_kwargs={"use_kernel": False})), {}, 2)
    same("dqn zero3 + replay vs flat(2) plain", fstate, fhist, state, hist)
    check(state.extra["replay"]["prio"].shape == (20000,),
          "dqn zero3 + replay: fit did not return the flat buffer")
    # 5. the full-width trunk under impala, zero3(1, 2) layer-wise
    trunk_cfg = TrainerConfig(
        algo="impala", iters=TRUNK_ITERS, superstep=TRUNK_ITERS,
        log_every=1, algo_kwargs={"policy": "trunk",
                                  "trunk_kwargs": {"reduced": False}})
    per_iter = trunk_launches("impala", 4)
    _, tstate, thist = drive("impala-trunk-full-w2", trainer_fit(
        dataclasses.replace(trunk_cfg, plan=DistPlan.flat(2)), True),
        per_iter, 2)
    ztr, zstate, zhist = drive("impala-trunk-full-zero3-1x2", trainer_fit(
        dataclasses.replace(trunk_cfg, plan=DistPlan.zero3(1, 2)), True),
        per_iter, 2)
    check(ztr.partition["listwise"] and ztr.partition["entries"] == 5,
          f"trunk zero3: partition {ztr.partition}")
    same("trunk zero3(1, 2) vs flat(2)", tstate, thist, zstate, zhist)
    # 6. memory: every position's TrainState at W = 4 after two iterations
    mem = {}
    for label, plan in (("flat4", DistPlan.flat(4)),
                        ("zero2-1x4", DistPlan.zero(1, 4)),
                        ("zero3-1x4", DistPlan.zero3(1, 4))):
        tr, state, _ = drive(f"impala-trunk-full-{label}", trainer_fit(
            dataclasses.replace(trunk_cfg, iters=ZERO_MEM_ITERS,
                                superstep=ZERO_MEM_ITERS, plan=plan), True),
            per_iter, 4)
        P = sum(v.numel() for v in state.params.values())
        mem[label] = (tr, P, tr.state_bytes,
                      torch.cuda.max_memory_allocated())
    P = mem["flat4"][1]
    z2, z3 = mem["zero2-1x4"][0].partition, mem["zero3-1x4"][0].partition
    check(z2["size"] == z3["size"] == P, f"partition sizes {z2} {z3} vs {P}")
    # f32 params, ring (one slot), adamw m and v; int32 counters: steps
    # and the optimizer's step (one per entry, layer-wise)
    want = {"flat4": 4 * (4 * P * 4 + 8),
            "zero2-1x4": 4 * (2 * P * 4 + 2 * z2["chunk"] * 4 + 8),
            "zero3-1x4": 4 * (4 * z3["chunk"] * 4 + 4
                              + 4 * z3["entries"])}
    table = {label: {"P": P, "state_bytes": got, "predicted": want[label],
                     "over_P_f32": got / (4 * P),
                     "max_memory_allocated": peak}
             for label, (_, _, got, peak) in mem.items()}
    print("zero_memory " + json.dumps({"table": table, "card": card}))
    for label, row in table.items():
        check(row["state_bytes"] == row["predicted"],
              f"memory {label}: {row['state_bytes']} bytes, predicted "
              f"{row['predicted']}")
    # 7. checkpoints: a zero3 fit served live, restored plain, and
    # restored through wrappers at 2 and 4 shards, bitwise
    env = envs.make("cartpole")
    for label, (tr, state) in (("mlp", zero_fits["zero3"]),
                               ("trunk", (ztr, zstate))):
        path = save_train_state(os.path.join(
            ROOT, "build", f"zero3_{label}.npz"), state)
        kw = tr.cfg.algo_kwargs
        make = lambda: agent_api.make("impala", env=env, ring_size=1,
                                      total_iters=tr.cfg.iters, **kw)
        stores = [ParamStore(), ParamStore()]
        stores[0].publish_from_state(tr.agent, state)
        stores[1].load_checkpoint(path, make())
        for n in (2, 4):
            wrapped = ZeRO3Agent(make(), "shard", n)
            stores.append(ParamStore())
            stores[-1].publish_from_state(
                wrapped, wrapped.shard_state(load_train_state(path)))
        obs = list(env.spec.observation.sample(
            torch.Generator().manual_seed(7), 5).numpy())
        outs = [ServeEngine(tr.agent.policy, env.spec.observation,
                            buckets=(8,), store=st, seed=11).eval_bucket(
            obs, list(range(5)), 8) for st in stores]
        check(all(all(torch.equal(a, b) for a, b in zip(outs[0], o))
                  for o in outs[1:]),
              f"zero3 {label} checkpoint: served outputs differ")
        os.remove(path)
        print(f"zero3 checkpoint {label}: live, plain, 2 and 4 shards "
              f"bitwise")
    return totals


# phase 4e: each data position a process over gloo, all on the one card
# (NCCL refuses two ranks on one card): (label, rl_train flags, kernel
# launches an iteration per position, W, iterations, superstep). Supersteps
# of a few iterations (bitwise any other) give steady-state times beside
# the first dispatch, which holds a fresh process's CUDA warm-up
PROC_SHORT = ["--env", "cartpole", "--iters", str(DIST_SHORT),
              "--superstep", "2", "--log-every", "1"]
PROC_CASES = [
    ("impala-w4", ["--algo", "impala", "--n-workers", "4"] + PROC_SHORT,
     ALGO_KERNELS["impala"], 4, DIST_SHORT, 2),
    ("ppo-2x2-allreduce-gossip-asp",
     ["--algo", "ppo", "--plan", "hosts=2:allreduce:bsp,workers=2:gossip:asp"]
     + PROC_SHORT, ALGO_KERNELS["ppo"], 4, DIST_SHORT, 2),
    ("impala-w2-shard2",
     ["--algo", "impala", "--plan",
      "workers=2:allreduce:bsp,shard=2:allreduce:bsp:shard"] + PROC_SHORT,
     ALGO_KERNELS["impala"], 4, DIST_SHORT, 2),
    ("dqn-w2-replay2",
     ["--algo", "dqn", "--env", "cartpole", "--iters",
      str(DIST_ITERS["dqn"]), "--superstep", "5", "--plan",
      "workers=2:allreduce:bsp,replay=2:allreduce:bsp:replay"],
     {"shard_topk_c": 1}, 2, DIST_ITERS["dqn"], 5),
    ("a3c-w2-pipeline-ssp1",
     ["--algo", "a3c", "--n-workers", "2", "--sync", "ssp",
      "--staleness-bound", "1", "--pipeline"] + PROC_SHORT,
     ALGO_KERNELS["a3c"], 2, DIST_SHORT, 2),
    ("impala-trunk-w2",
     ["--algo", "impala", "--env", "cartpole", "--policy", "trunk",
      "--iters", str(TRUNK_ITERS), "--superstep", "1",
      "--log-every", "1", "--n-workers", "2"],
     None, 2, TRUNK_ITERS, 1),
]


def nccl_one_rank(group):
    """In a one-rank NCCL group's process: its hook (flat(4)'s gradient
    mean and gossip's mix, over a lead of 1), shard_gather and metric
    all-gather against `PositionGroup(1)`'s on the same inputs; returns
    the names of those that differ."""
    import torch
    from repro_torch.core.distribution import DistPlan
    from repro_torch.core.positions import PositionGroup, tree_leaves
    gen = torch.Generator(device=group.device).manual_seed(0)
    tree = {"a": torch.randn((3, 4), generator=gen, device=group.device),
            "b": torch.randn((5,), generator=gen, device=group.device)}
    threads = PositionGroup(1)
    bad = []
    try:
        for spec in ("workers=4:allreduce:bsp", "workers=4:gossip:bsp"):
            for i, fn in enumerate(DistPlan.parse(spec).compile_collectives()):
                if fn is None:
                    continue
                want = threads.run(lambda r: threads.hook(r, fn, (1,))(
                    tree))[0]
                got = group.hook(0, fn, (1,))(tree)
                if not all(torch.equal(x, y) for x, y in zip(
                        tree_leaves(got), tree_leaves(want))):
                    bad.append(f"{spec} hook {i}")
        chunks = [tree["a"].reshape(-1), tree["b"]]
        want = threads.run(lambda r: threads.shard_gather(r, [[0]])(
            chunks))[0]
        got = group.shard_gather(0, [[0]])(chunks)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            bad.append("shard_gather")
        if not torch.equal(group.all_gather(tree["a"])[0], tree["a"]):
            bad.append("all_gather")
    finally:
        threads.close()
    return {"differ": bad, "device": str(group.device),
            "backend": group.backend}


def phase_processes(card, path_rows, flat4):
    """Phase 4e: the process backend on the one card. Each case through
    `rl_train` twice, in turns: `--backend positions` (threads) and then
    `--backend gloo` (a process a position, every rank on cuda:0), counts
    at 0 just before each; the two fits bitwise equal, every rank's
    launches summed equal to the threaded run's (W x the flat run's);
    impala-w4 also bitwise the distribution phase's flat(4) fit `flat4`,
    and the ZeRO-2 fit bitwise the threaded flat(4). Then NCCL: a
    one-rank group's collectives against `PositionGroup(1)`, and the
    refusal of `--backend nccl --n-workers 2` before any process starts.
    Returns the launch counts of the runs."""
    import multiprocessing
    import torch
    from repro_torch.core.positions import run_processes
    from repro_torch.launch.rl_train import main as rl_main
    counters = train_counters()
    totals = dict.fromkeys(counters, 0)
    hist_json = lambda h: json.dumps(h)      # NaN-safe equality
    t_phase = time.perf_counter()

    def fit(label, argv, per_iter, W, iters, backend):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run, state, hist = rl_main(argv + ["--backend", backend])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        here = {n: f.launches for n, f in counters.items()}
        steps = run.superstep_s
        if backend == "positions":
            got, fit_s = here, wall
        else:
            check(not any(here.values()), f"{label} {backend}: the "
                  f"launcher launched kernels itself: {here}")
            check(run.n_processes == W and out["n_processes"] == W
                  and out["backend"] == backend,
                  f"{label} {backend}: {run.n_processes} processes, line "
                  f"{out}")
            got = {n: sum(r[n] for r in run.launches) for n in counters}
            fit_s = run.fit_s[0]
        want = {n: W * per_iter.get(n, 0) * iters for n in counters}
        check(got == want, f"{label} {backend}: kernel launches {got}, "
                           f"expected {want}")
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"{label} {backend}: non-finite loss in {hist}")
        for n in counters:
            totals[n] += got[n]
        return state, hist, out, got, fit_s, wall, steps

    def steady_ms(steps, iters, K):
        """ms an iteration over the supersteps after the first."""
        return sum(steps[1:]) * 1e3 / (iters - K) if len(steps) > 1 \
            else None

    threaded_flat4 = None
    for label, argv, per_iter, W, iters, K in PROC_CASES:
        per_iter = per_iter or trunk_launches("impala", 2)
        ref = fit(label, argv, per_iter, W, iters, "positions")
        got = fit(label, argv, per_iter, W, iters, "gloo")
        bad = state_equal(got[0], ref[0])
        check(not bad and hist_json(got[1]) == hist_json(ref[1]),
              f"{label}: the gloo fit is not bitwise the threaded fit "
              f"({bad or 'history'})")
        line = dict(ref[2], **{k: got[2][k] for k in ("backend",
                                                        "n_processes")})
        line.pop("wall_s"), got[2].pop("wall_s")
        check(hist_json(line) == hist_json(got[2]),
              f"{label}: the gloo line {got[2]} is not the threaded "
              f"line {ref[2]} plus backend and n_processes")
        if label == "impala-w4":
            threaded_flat4 = ref
            bad = state_equal(got[0], flat4[0])
            check(not bad and hist_json(got[1]) == hist_json(flat4[1]),
                  f"impala-w4 gloo: not bitwise the distribution phase's "
                  f"flat(4) fit ({bad or 'history'})")
        if label == "impala-w2-shard2":
            bad = state_equal(got[0], threaded_flat4[0])
            check(not bad and hist_json(got[1]) == hist_json(
                threaded_flat4[1]), f"impala-w2-shard2 gloo: not bitwise "
                                    f"the flat(4) fit ({bad or 'history'})")
        if label == "dqn-w2-replay2":
            check(got[0].extra["replay"]["prio"].shape == (20000,),
                  "dqn w2 x replay2 gloo: fit did not return the flat "
                  "buffer")
        print("train_run " + json.dumps({
            "run": label, "backend": "gloo", "n_processes": W,
            "plan": got[2]["plan"], "W": W, "iters": iters,
            "superstep": K, "ms_per_iter": got[4] * 1e3 / iters,
            "threaded_ms_per_iter": ref[4] * 1e3 / iters,
            "steady_ms_per_iter": steady_ms(got[6], iters, K),
            "threaded_steady_ms_per_iter": steady_ms(ref[6], iters, K),
            "first_superstep_s": got[6][0],
            "threaded_first_superstep_s": ref[6][0],
            "launcher_wall_s": got[5], "threaded_wall_s": ref[5],
            "launches": got[3], "threaded_launches": ref[3],
            "kernel_share_of_wall": {
                n: got[3][n] / W * path_rows[n]["ms"] / (got[4] * 1e3)
                for n in counters if got[3][n] and n in path_rows},
            "bitwise_threaded": True, "history": got[1], "card": card}))
    # NCCL at world size 1, and the refusal of two ranks on one card
    t0 = time.perf_counter()
    res = run_processes(nccl_one_rank, n=1, backend="nccl",
                        devices=["cuda:0"], deadline=300)[0]
    check(not res["differ"], f"nccl world size 1: {res['differ']} differ "
                             f"from PositionGroup(1)")
    print(f"processes: nccl world size 1 on {res['device']}: hook, "
          f"shard_gather and all_gather equal PositionGroup(1)'s "
          f"({time.perf_counter() - t0:.1f} s)")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        try:
            rl_main(["--algo", "impala", "--n-workers", "2", "--iters", "1",
                     "--backend", "nccl"])
        except SystemExit as e:
            code = e.code
        else:
            code = 0
    cards = torch.cuda.device_count()
    check(code not in (0, None) and f"2 ranks, {cards} card" in
          err.getvalue() and not multiprocessing.active_children(),
          f"--backend nccl --n-workers 2 on {cards} card(s): exit {code}, "
          f"{err.getvalue()[-500:]}")
    print(f"processes: --backend nccl --n-workers 2 refused before "
          f"spawning: {err.getvalue().strip().splitlines()[-1]} "
          f"({time.perf_counter() - t0:.2f} s)")
    print(f"processes: {len(PROC_CASES)} cases bitwise; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return totals


def phase_path_agreement():
    """One learner_step per algorithm from the same state and trajectory,
    with the kernels and with the plain scans, on the card."""
    import torch
    import repro_torch.envs as envs
    from repro_torch.core import agent as agent_api
    from repro_torch.core.rollout import rollout_fresh
    env = envs.make("cartpole")
    for algo in ("ppo", "a3c", "impala"):
        kern = agent_api.make(algo, env=env, use_kernel=True)
        plain = agent_api.make(algo, env=env, use_kernel=False)
        state = kern.init(torch.Generator().manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(1)
        traj, env_state = rollout_fresh(kern.policy, kern.actor_policy(
            state, 0), env, gen, 32, 32)
        boot = env.obs(env_state)
        if algo == "ppo":
            perms = torch.rand((kern.n_epochs, 32 * 32), generator=gen,
                               device="cuda").argsort(dim=-1, stable=True)
            a, la = kern.learner_step_perms(state, traj, boot, perms)
            b, lb = plain.learner_step_perms(state, traj, boot, perms)
        else:
            a, la = kern.learner_step(state, traj, boot)
            b, lb = plain.learner_step(state, traj, boot)
        err = max((a.params[k] - b.params[k]).abs().max().item()
                  for k in a.params)
        check(err <= 1e-5, f"{algo}: kernel vs plain learner_step params "
                           f"max_abs_err {err} > 1e-5")
        print(f"path {algo}: kernels vs plain learner_step params "
              f"max_abs_err {err:.3e}, loss {la['loss'].item():.6f} vs "
              f"{lb['loss'].item():.6f}")
    dqn_path_agreement(env)
    for R in REPLAY_SHARDS:
        dqn_sharded_path_agreement(env, R)
    trunk_path_agreement(env)


def trunk_path_agreement(env):
    """Per algorithm, the full-width trunk's learner loss and gradients
    (a ppo minibatch, a3c and impala on the whole batch, a dqn batch of
    64) from one state and trajectory, with the training attention's
    kernels (use_kernels) and with the plain attention."""
    import torch
    from repro_torch.core import agent as agent_api
    from repro_torch.core.algos.dqn import prefixed, sub
    from repro_torch.core.rollout import rollout_fresh
    for algo in ("ppo", "a3c", "impala", "dqn"):
        extra = {"warmup": 0} if algo == "dqn" else {}
        agents = [agent_api.make(algo, env=env, policy="trunk",
                                 total_iters=10, trunk_kwargs={
                                     "reduced": False, "use_kernels": uk},
                                 **extra) for uk in (True, False)]
        state = agents[0].init(torch.Generator().manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(1)
        traj, env_state = rollout_fresh(agents[0].policy, agents[0]
                                        .actor_policy(state, 0), env, gen,
                                        32, 32)
        boot = env.obs(env_state)
        results = []
        for ag in agents:
            if algo == "dqn":
                batch = {k: v[:64] for k, v in ag.transitions(traj).items()}
                res = agent_api.value_and_grad(
                    lambda on, ag=ag, batch=batch: ag.dqn.loss(
                        {**state.params, **prefixed("online", on)}, batch)[0],
                    sub(state.params, "online"))
            elif algo == "ppo":
                mb = {k: v[:256] for k, v in ag.algo.make_batch(
                    state.params, traj, boot).items()}
                res = agent_api.value_and_grad(ag.algo.loss, state.params,
                                               mb)
            else:
                res = agent_api.value_and_grad(ag.algo.loss, state.params,
                                               traj, boot)
            results.append(res)
        (lk, gk), (lp, gp) = results
        scale = max(g.abs().max().item() for g in gp.values())
        err = max((gk[k] - gp[k]).abs().max().item() for k in gp)
        check(math.isfinite(lk.item()) and abs(lk.item() - lp.item())
              <= 1e-5 * max(1.0, abs(lp.item())),
              f"trunk {algo}: loss {lk.item()} vs plain {lp.item()}")
        check(err <= TRUNK_GRAD_TOL * scale,
              f"trunk {algo}: gradients max_abs_err {err} > "
              f"{TRUNK_GRAD_TOL} x {scale}")
        print(f"path trunk {algo}: full-width learner gradients, kernels vs "
              f"plain attention, max_abs_err {err:.3e} (max |g| "
              f"{scale:.3e}), loss {lk.item():.6f} vs {lp.item():.6f}")


def phase_evolution(card):
    """ES and DeepGA on cartpole and ERL on pendulum for a few
    generations on the card, each population a batch there; finite
    fitness."""
    import torch
    import repro_torch.envs as envs
    from repro_torch.core.evo import ERL, ES, DeepGA
    from repro_torch.core.networks import MLPPolicy
    from repro_torch.optim import adamw
    cpu = torch.Generator().manual_seed(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cart, pend = envs.make("cartpole"), envs.make("pendulum")
    runs = {}
    es = ES(MLPPolicy.for_spec(cart.spec, hidden=(32,)), cart, pop_size=32,
            sigma=0.1, lr=0.05, max_steps=200)
    theta = es.init(cpu)
    ga = DeepGA(MLPPolicy.for_spec(cart.spec, hidden=(32,)), cart,
                pop_size=32, truncation=8, max_steps=200)
    ga_state = ga.init(cpu)
    erl = ERL(MLPPolicy.for_spec(pend.spec, hidden=(32,)), pend, pop_size=8,
              max_steps=200)
    erl_state, replay = erl.init(cpu)
    opt = adamw(1e-3)
    ostate = opt.init(erl.layout.unravel(erl_state["learner"]))

    def es_gen():
        nonlocal theta
        theta, f, comm = es.step(theta, gen)
        return float(f), comm

    def ga_gen():
        nonlocal ga_state
        ga_state, f, comm = ga.step(ga_state, gen)
        return float(f), comm

    def erl_gen():
        nonlocal erl_state, ostate
        erl_state, ostate, fits = erl.step(erl_state, replay, gen, opt,
                                           ostate, learner_updates=8)
        return float(fits.mean()), None

    for name, step, n in (("es", es_gen, 4), ("deep_ga", ga_gen, 4),
                          ("erl", erl_gen, 3)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits = [step() for _ in range(n)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(math.isfinite(f) for f, _ in fits),
              f"{name}: fitness {fits}")
        runs[name] = {"generations": n, "fitness": [f for f, _ in fits],
                      "comm_bytes": fits[-1][1], "wall_s": wall,
                      "s_per_generation": wall / n, "card": card}
        print("evolution " + json.dumps(dict(runs[name], method=name)))
    check(bool(torch.isfinite(erl_state["pop"]).all()),
          "erl: non-finite population")
    return runs


def dqn_sharded_path_agreement(env, R):
    """One DQN learner_step through the sharded replay service, the
    per-shard kernel against its plain version, from one state (13
    iterations in, size 13312 of 20000), trajectory and Gumbel vector:
    bitwise equal params and priorities. The kernel step runs under sync
    debug mode "error": a host sync inside it raises."""
    import torch
    from repro_torch.core import agent as agent_api
    from repro_torch.core.replay_service import ShardedPrioritizedReplay
    from repro_torch.core.rollout import rollout
    from repro_torch.kernels.replay_sample.kernel import shard_topk_c
    kern = agent_api.make("dqn", env=env, total_iters=60, warmup=0)
    plain = agent_api.make("dqn", env=env, total_iters=60, warmup=0)
    kern.replay = ShardedPrioritizedReplay(20000, "replay", R)
    plain.replay = ShardedPrioritizedReplay(20000, "replay", R,
                                            use_kernel=False)
    state = kern.init(torch.Generator().manual_seed(0))
    state = agent_api.TrainState(
        state.params, state.opt_state,
        {"replay": kern.replay.shard_state(state.extra["replay"])},
        state.ring, state.steps)
    gen = torch.Generator(device="cuda").manual_seed(1)
    env_state = env.reset(gen, 32)
    for _ in range(13):
        traj, env_state = rollout(kern.policy, kern.actor_policy(state, 0),
                                  env, gen, env_state, 32)
        state, _ = kern.learner_step(state, traj, env.obs(env_state), gen)
    traj, env_state = rollout(kern.policy, kern.actor_policy(state, 0), env,
                              gen, env_state, 32)
    boot = env.obs(env_state)
    g = kern.replay.noise(gen, kern.batch_size)
    before = shard_topk_c.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, la = kern.learner_step_noise(state, traj, boot, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(shard_topk_c.launches == before + 1,
          f"dqn replay={R}: the step did not launch shard_topk_c once")
    b, lb = plain.learner_step_noise(state, traj, boot, g)
    check(int(a.params["steps"]) == 14, "dqn: the step did not update")
    check(tree_equal(a.params, b.params),
          f"dqn replay={R}: kernel vs plain learner_step params differ")
    check(torch.equal(a.extra["replay"]["prio"], b.extra["replay"]["prio"]),
          f"dqn replay={R}: kernel vs plain priorities differ")
    print(f"path dqn replay={R}: params and priorities bitwise the plain "
          f"step's (size {int(state.extra['replay']['size'])}), loss "
          f"{la['loss'].item():.6f} vs {lb['loss'].item():.6f}; the kernel "
          f"step ran under sync debug mode 'error'")


def dqn_path_agreement(env):
    """One DQN learner_step with the replay kernel against one with the
    plain draw, from one state (13 iterations in: 13312 of 20000 slots
    filled, past warmup), trajectory and Gumbel vector: the same indices,
    params within 1e-6. The kernel step runs under sync debug mode
    "error": a host sync inside it raises."""
    import torch
    from repro_torch.core import agent as agent_api
    from repro_torch.core.rollout import rollout
    kern = agent_api.make("dqn", env=env, total_iters=60, warmup=0)
    plain = agent_api.make("dqn", env=env, total_iters=60, warmup=0,
                           use_kernel=False)
    state = kern.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    env_state = env.reset(gen, 32)
    for _ in range(13):
        traj, env_state = rollout(kern.policy, kern.actor_policy(state, 0),
                                  env, gen, env_state, 32)
        state, _ = kern.learner_step(state, traj, env.obs(env_state), gen)
    traj, env_state = rollout(kern.policy, kern.actor_policy(state, 0), env,
                              gen, env_state, 32)
    boot = env.obs(env_state)
    g = kern.replay.noise(gen, kern.batch_size)
    rstate = kern.replay.add_batch(state.extra["replay"],
                                   kern.transitions(traj))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, la = kern.learner_step_noise(state, traj, boot, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b, lb = plain.learner_step_noise(state, traj, boot, g)
    _, ia, wa = kern.replay.sample_with(rstate, g, kern.batch_size)
    _, ib, wb = plain.replay.sample_with(rstate, g, kern.batch_size)
    check(torch.equal(ia, ib), "dqn: kernel and plain draws differ")
    check(int(a.params["steps"]) == 14, "dqn: the step did not update")
    err = max((a.params[k].float() - b.params[k].float()).abs().max().item()
              for k in a.params)
    check(err <= 1e-6, f"dqn: kernel vs plain learner_step params "
                       f"max_abs_err {err} > 1e-6")
    check(torch.equal(a.extra["replay"]["prio"], b.extra["replay"]["prio"]),
          "dqn: kernel vs plain priorities differ")
    print(f"path dqn: same {ia.numel()} indices (size "
          f"{int(rstate['size'])}), weights max_abs_err "
          f"{(wa - wb).abs().max().item():.3e}, params max_abs_err "
          f"{err:.3e}, loss {la['loss'].item():.6f} vs "
          f"{lb['loss'].item():.6f}; the kernel step ran under sync debug "
          f"mode 'error'")


def phase_flash_guard():
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_hsd
    q = torch.randn((1, 2, 4, 64), device="cuda", requires_grad=True)
    k = torch.randn((1, 1, 4, 64), device="cuda")
    try:
        flash_attention_hsd(q, k, k)
    except RuntimeError as e:
        print(f"flash guard: raised under grad: {e}")
    else:
        fail("flash_attention_hsd ran on an input that requires grad")


def phase_cli():
    from repro_torch.launch.serve_policy import main as serve_main
    for algo in ("ppo", "dqn"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_main(["--algo", algo, "--quick"])
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(out["recompiles_after_warmup"] == 0 and out["hot_swaps"] == 4
              and out["source"] == "trained-in-process"
              and out["algo"] == algo
              and out["device"].startswith("cuda"), f"CLI summary {out}")
        print("cli " + json.dumps(out))


def phase_gmm_kernel():
    """The grouped matmul against its plain version on the card; returns
    {(shape, dtype): row}."""
    import torch
    from repro_torch.kernels.gmm.kernel import gmm_ecd
    from repro_torch.kernels.gmm.ref import gmm_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    cases = [(c, dname) for dname in ("bfloat16", "float32")
             for c in GMM_CASES] + [(c, "bfloat16") for c in ZOO_GMM_CASES]
    for (E, C, d, f), dname in cases:
        dt = getattr(torch, dname)
        x = torch.randn((E, C, d), generator=gen, device="cuda").to(dt)
        w = (torch.randn((E, d, f), generator=gen, device="cuda")
             * d ** -0.5).to(dt)

        def kernel():
            return gmm_ecd(x, w)

        def plain():
            return gmm_ref(x, w)

        def library():
            return torch.bmm(x, w)

        out = kernel()
        torch.cuda.synchronize()
        ref = gmm_ref(x.float(), w.float())
        check(torch.isfinite(out.float()).all().item(),
              f"gmm_ecd non-finite at {(E, C, d, f)} {dname}")
        scale = ref.abs().max().item()
        err = (out.float() - ref).abs().max().item()
        ok = ((out.float() - ref).abs()
              <= 1e-4 * scale + GMM_RTOL[dname] * ref.abs()).all()
        check(bool(ok), f"gmm_ecd {dname} {(E, C, d, f)} outside rtol "
                        f"{GMM_RTOL[dname]}, atol 1e-4 x {scale} "
                        f"(max_abs_err {err})")
        check(torch.equal(kernel(), out),
              f"gmm_ecd {(E, C, d, f)} {dname}: not bitwise repeatable")
        big = E * d * f > 10 ** 8
        ms = cuda_time_ms(kernel, 50 if big else 200)
        plain_ms = cuda_time_ms(plain, 10 if big else 50, warmup=2)
        library_ms = cuda_time_ms(library, 50 if big else 200)
        dev_us, dev_kernels = device_us(kernel)
        library_dev_us, _ = device_us(library)
        es = torch.finfo(dt).bits // 8
        nbytes = es * (E * C * d + E * d * f + E * C * f)
        ops = 2 * E * C * d * f
        t_bytes, t_ops = (nbytes / H100_BYTES_PER_S,
                          ops / PEAK_OPS[dname])
        row = {"name": "gmm_ecd", "shape": [E, C, d, f], "dtype": dname,
               "max_abs_err": err, "max_abs_ref": scale,
               "rtol": GMM_RTOL[dname], "ms": ms, "device_us": dev_us,
               "device_kernels": dev_kernels, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_device_us": library_dev_us,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops,
               "gb_per_s": nbytes / ms / 1e6}
        print("kernel_case " + json.dumps(row))
        rows[((E, C, d, f), dname)] = row
        del x, w, out, ref
    torch.cuda.empty_cache()
    print("kernels_checked " + json.dumps({"kernels": ["gmm_ecd"]}))
    return rows


def phase_lm_serve(card):
    """Serve the full-width deepseek-moe-16b (bf16, use_kernels) through
    `repro_torch.launch.serve.serve`; returns its launch counts."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_hsd
    from repro_torch.kernels.gmm.kernel import gmm_ecd
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import ModelOpts, build_model
    arch, B, S, gen_len = (LM[k] for k in ("arch", "batch", "prompt_len",
                                           "gen_len"))
    model = build_model(arch, ModelOpts(dtype="bfloat16", remat=False,
                                        use_kernels=True))
    cfg = model.cfg
    check((cfg.n_layers, cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff)
          == (28, 2048, 64, 1408), f"{arch}: not the full-width config")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    n_params = sum(v.numel() for v in params.values())
    # param_count (the reference's) leaves out the norm scales
    n_norm = (2 * cfg.n_layers + 1) * cfg.d_model
    check(n_params == cfg.param_count() + n_norm,
          f"{arch}: {n_params} params, config says {cfg.param_count()} + "
          f"{n_norm} norm scales")
    prompts = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(1))

    # the main path: counts at 0 just before, read just after
    flash_attention_hsd.launches = 0
    gmm_ecd.launches = 0
    res = serve(arch, reduced=False, batch=B, prompt_len=S,
                gen_len=gen_len, seed=0, dtype="bfloat16", device="cuda",
                use_kernels=True, params=params, prompts=prompts)
    launches = {"gmm_ecd": gmm_ecd.launches,
                "flash_attention_hsd": flash_attention_hsd.launches}
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    want = {"gmm_ecd": 3 * n_moe * (2 + gen_len + 1),
            "flash_attention_hsd": 2 * cfg.n_layers}
    check(want == {"gmm_ecd": 1539, "flash_attention_hsd": 56},
          f"expected launch counts {want}")
    check(launches == want, f"{arch} serve: launches {launches}, expected "
                            f"{want}")
    check(res["generated_shape"] == [B, gen_len],
          f"{arch} serve: generated_shape {res['generated_shape']}")
    peak = torch.cuda.max_memory_allocated()

    # checks below launch the kernels again; they are not the main path
    agree = lm_agreement(model, params, prompts, S + gen_len)
    print("lm_serve " + json.dumps(dict(
        res, init_s=init_s, weight_bytes=weight_bytes, n_params=n_params,
        init_peak_bytes=init_peak, serve_peak_bytes=peak,
        launches=launches, agreement=agree, card=card)))
    del params, model
    torch.cuda.empty_cache()

    # smollm-360m at full width, flash attention only (the CLI's default)
    flash_attention_hsd.launches = 0
    gmm_ecd.launches = 0
    res = serve("smollm-360m", reduced=False, batch=B, prompt_len=S,
                gen_len=gen_len, seed=0, dtype="bfloat16", device="cuda",
                use_kernels=True)
    small = {"gmm_ecd": gmm_ecd.launches,
             "flash_attention_hsd": flash_attention_hsd.launches}
    check(small == {"gmm_ecd": 0, "flash_attention_hsd": 64},
          f"smollm-360m serve: launches {small}")
    check(res["generated_shape"] == [B, gen_len], f"smollm-360m {res}")
    print("lm_serve " + json.dumps(dict(res, launches=small, card=card)))
    torch.cuda.empty_cache()
    return launches


def lm_agreement(model, params, prompts, capacity, frontend=None):
    """The kernel path against use_kernels=False on the same (bf16)
    params. bf16 compute end to end is dominated by rounding for this
    random-init model (the reference's fan-in of the (E, d, f) expert
    weights is E, so the residual stream grows to ~10^3 and one bf16 ulp
    there moves the router): the bf16 plain path alone lands as far from
    the f32 plain path as the bf16 kernel path does. So the gates are:
      * f32 compute on the same params (each bf16 weight cast to f32 at
        use), end to end: prefill and first decode-step logits, kernels
        (f32 gmm_ecd and flash) against plain, within LM_F32_TOL x
        max|logit|, all four paths' logits finite;
      * bf16 compute, layer by layer on the plain path's activations:
        each causal full-attention layer's mixer (flash vs blockwise) on
        the same input and each MoE layer's FFN (gmm_ecd vs einsum) on
        the same input, within LM_BF16_TOL x max|plain output| (the other
        mixers and FFNs run no kernel: they advance the activations).
    The bf16 end-to-end logits of both paths are reported against the f32
    plain logits, ungated. `frontend` is the model's stub input, if it
    has one."""
    import torch
    from repro_torch.checkpoint.convert import unflatten_tree
    from repro_torch.configs.base import ATTN
    from repro_torch.models import blocks
    from repro_torch.models.layers import apply_norm, apply_params
    from repro_torch.models.model import ModelOpts, build_model
    arch, cfg = model.cfg.name, model.cfg
    models = {(dt, k): build_model(cfg, ModelOpts(dtype=dt, remat=False,
                                                  use_kernels=k))
              for dt in ("float32", "bfloat16") for k in (False, True)}
    S = prompts.shape[1]
    logits = {}
    tok = None
    with torch.inference_mode():
        for key, m in models.items():
            lp, cache = m.prefill(params, prompts, capacity,
                                  frontend=frontend)
            if tok is None:  # every path decodes the f32 plain path's token
                tok = torch.argmax(lp[:, -1].float(), dim=-1)[:, None]
            ld, _ = m.decode_step(params, tok, cache, S + m.n_prefix)
            logits[key] = {"prefill": lp.float(), "decode": ld.float()}
            del cache
            torch.cuda.empty_cache()
    out = {}
    for name in ("prefill", "decode"):
        ref = logits[("float32", False)][name]
        scale = ref.abs().max().item()
        for key, got in logits.items():
            check(torch.isfinite(got[name]).all().item(),
                  f"{arch} {name} {key}: non-finite logits")
            err = (got[name] - ref).abs().max().item()
            out[f"{name} {key[0]} kernels={key[1]} vs f32 plain"] = {
                "max_abs_err": err, "max_abs_logit": scale,
                "argmax_equal": int((got[name].argmax(-1)
                                     == ref.argmax(-1)).sum()),
                "rows": ref.shape[0]}
        err = out[f"{name} float32 kernels=True vs f32 plain"]["max_abs_err"]
        check(err <= LM_F32_TOL * scale,
              f"{arch} {name}: f32 kernel path vs use_kernels=False logits "
              f"max_abs_err {err} > {LM_F32_TOL} x {scale}")

    tree = unflatten_tree(params)
    kern, plain = models[("bfloat16", True)], models[("bfloat16", False)]
    worst = {"attention": 0.0, "ffn": 0.0}
    with torch.inference_mode():
        x, enc_out = apply_params(plain, params, prompts, mode="inputs",
                                  frontend=frontend)
        for name, blk in plain.layers():
            p = tree
            for part in name.split("/"):
                p = p[int(part)] if part.isdigit() else p[part]
            h = apply_norm(p["norm1"], x)
            ap, _ = blocks.mixer_seq(cfg, p, blk.kind, h, 0, plain.attn_opts)
            pairs = []
            if blk.kind == ATTN:
                ak, _ = blocks.mixer_seq(cfg, p, blk.kind, h, 0,
                                         kern.attn_opts)
                pairs.append(("attention", ak, ap))
            x = x + ap
            if enc_out is not None:
                x = x + blocks.cross_seq(cfg, p, apply_norm(p["xnorm"], x),
                                         enc_out, plain.attn_opts)[0]
            h2 = apply_norm(p["norm2"], x)
            fp, _ = blocks.ffn(cfg, p, blk.is_moe, blk.gelu_mlp, h2,
                               plain.attn_opts)
            if blk.is_moe:
                fk, _ = blocks.ffn(cfg, p, True, False, h2, kern.attn_opts)
                pairs.append(("ffn", fk, fp))
            for part, a, b in pairs:
                rel = ((a.float() - b.float()).abs().max()
                       / b.float().abs().max()).item()
                worst[part] = max(worst[part], rel)
                check(rel <= LM_BF16_TOL,
                      f"{arch} {name} {part}: bf16 kernel vs plain "
                      f"max_abs_err / max|plain| = {rel} > {LM_BF16_TOL}")
            x = x + fp
    out["bf16 per-layer worst max_abs_err / max|plain|"] = worst
    del models
    torch.cuda.empty_cache()
    return out


def wkv_ops(B, T, H, N):
    """f32 operations the WKV recurrence needs on these shapes, whatever
    its blocking (an exp counts one), per step and (b, h): r_t·S (2N²),
    S <- w ⊙ S + k vᵀ (3N²), w = exp(logw) (N), r·(u ⊙ k) (3N) and that
    scalar times v added to y (2N). The chunked kernel does more (the
    pairwise decays of each chunk); the bound counts only what the
    function needs."""
    return B * H * T * (5 * N * N + 6 * N)


def phase_wkv6_kernel():
    """The chunked WKV against its plain version (the per-step scan) on
    the card, y and the final state, with a nonzero u and initial state,
    f32 at every WKV_CASES shape and bf16 r, k, v, u at WKV_BF16_CASES
    (the plain version on their f32 values); returns {shape: row} for
    f32 and {(shape, "bfloat16"): row} for bf16."""
    import torch
    from repro_torch.kernels.wkv6.kernel import wkv6_btHN
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    cases = [(c, "float32") for c in WKV_CASES] + [
        (c, "bfloat16") for c in WKV_BF16_CASES]
    for (B, T, H, N, L), dname in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, k, v = randn(B, T, H, N), randn(B, T, H, N), randn(B, T, H, N)
        logw = -torch.exp(0.5 * randn(B, T, H, N))
        u = 0.3 + 0.2 * randn(H, N)
        s0 = 0.2 * randn(B, H, N, N)
        dt = getattr(torch, dname)
        r, k, v, u = (a.to(dt) for a in (r, k, v, u))
        rf, kf, vf, uf = (a.float() for a in (r, k, v, u))

        def plain():
            return wkv6_ref(rf, kf, vf, logw, uf, s0)

        state = s0.clone()   # the kernel writes the final S over it
        y, S = wkv6_btHN(r, k, v, logw, u, state, chunk=L)
        torch.cuda.synchronize()
        case = f"wkv6_btHN {dname} {(B, T, H, N, L)}"
        check(S is state, f"{case}: the final S was not written over the "
                          f"given state")
        ry, rS = plain()
        err = 0.0
        for name, a, b in (("y", y, ry), ("S", S, rS)):
            check(torch.isfinite(a).all().item(),
                  f"{case}: non-finite {name}")
            ok = ((a - b).abs() <= WKV_TOL["atol"]
                  + WKV_TOL["rtol"] * b.abs()).all()
            err = max(err, (a - b).abs().max().item())
            check(bool(ok), f"{case} {name} outside atol"
                            f" {WKV_TOL['atol']}, rtol "
                            f"{WKV_TOL['rtol']} (max_abs_err {err})")
        y2, S2 = wkv6_btHN(r, k, v, logw, u, s0.clone(), chunk=L)
        check(torch.equal(y2, y) and torch.equal(S2, S),
              f"{case}: not bitwise repeatable")

        def kernel():  # timed on one state that it carries, as decode does
            return wkv6_btHN(r, k, v, logw, u, state, chunk=L)

        ms = cuda_time_ms(kernel, 200 if T <= 64 else 50)
        plain_ms = cuda_time_ms(plain, 20 if T <= 64 else 3, warmup=2)
        dev_us, dev_kernels = device_us(kernel)
        es = torch.finfo(dt).bits // 8  # r, k, v, u; logw, y, S in f32
        nbytes = (es * (3 * B * T * H * N + H * N)
                  + 4 * (2 * B * T * H * N + 2 * B * H * N * N))
        ops = wkv_ops(B, T, H, N)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / PEAK_OPS["float32"]
        row = {"name": "wkv6_btHN", "shape": [B, T, H, N], "chunk": L,
               "dtype": dname, "max_abs_err": err, "tol": WKV_TOL, "ms": ms,
               "device_us": dev_us, "device_kernels": dev_kernels,
               "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        print("kernel_case " + json.dumps(row))
        rows[(B, T, H, N, L) if dname == "float32"
             else ((B, T, H, N, L), dname)] = row
    print("kernels_checked " + json.dumps({"kernels": ["wkv6_btHN"]}))
    return rows


def phase_wkv6_guard():
    import torch
    from repro_torch.kernels.wkv6.kernel import wkv6_btHN
    x = torch.randn((1, 4, 2, 8), device="cuda", requires_grad=True)
    u = torch.zeros((2, 8), device="cuda")
    try:
        wkv6_btHN(x, x, x, -x.abs(), u)
    except RuntimeError as e:
        print(f"wkv6 guard: raised under grad: {e}")
    else:
        fail("wkv6_btHN ran on an input that requires grad")


def perturb_rwkv(params, seed=0):
    """The RWKV constants the reference's init leaves at trivial values
    (u = 0 hides the diagonal bonus, w0 = -6 makes every decay ~0.9975,
    unit head-norm scales, lerps at 0.5), redrawn in place from a numpy
    seed, so that the kernel's u-term and its decays are exercised."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    draws = {"u": lambda s: 0.5 * rng.standard_normal(s),
             "w0": lambda s: rng.uniform(-5.0, 1.0, s),
             "ln_scale": lambda s: 1.0 + 0.2 * rng.standard_normal(s),
             "mu": lambda s: rng.uniform(0.0, 1.0, s),
             "cm_mu": lambda s: rng.uniform(0.0, 1.0, s)}
    for key, t in params.items():
        draw = draws.get(key.rsplit("/", 1)[-1])
        if draw is not None and "/mixer/" in key:
            t.copy_(torch.from_numpy(draw(tuple(t.shape)).astype(
                np.float32)))


def rwkv_param_count(cfg):
    """Exact leaf count of the port's (and the reference's) RWKV model:
    `param_count` approximates each mixer (it leaves out the token-shift
    lerps mu/cm_mu, w0, u and ln_scale, and counts the lerp and decay
    LoRAs as 4·d·64 where they hold 2·5·32·d + 2·64·d) and leaves out
    the layernorms' scales and biases."""
    d, H, N, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    mixer = (5 * d + d * 160 + 5 * 32 * d + 5 * d * d + d + 2 * 64 * d
             + 2 * H * N + 2 * d + 2 * d * f + d * d)
    norms = 2 * 2 * d
    return 2 * cfg.vocab * d + cfg.n_layers * (mixer + norms) + 2 * d


def phase_rwkv_serve(card):
    """Serve the full-width rwkv6-1.6b (bf16, use_kernels) through
    `repro_torch.launch.serve.serve`, then hold the kernel path against
    use_kernels=False in f32; returns the main path's launch counts."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_hsd
    from repro_torch.kernels.gmm.kernel import gmm_ecd
    from repro_torch.kernels.wkv6.kernel import wkv6_btHN
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import ModelOpts, build_model
    arch, B, S, gen_len = (RWKV[k] for k in ("arch", "batch", "prompt_len",
                                             "gen_len"))
    model = build_model(arch, ModelOpts(dtype="bfloat16", remat=False,
                                        use_kernels=True))
    cfg = model.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
           cfg.vocab) == (24, 2048, 32, 64, 7168, 65536),
          f"{arch}: not the full-width config")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    perturb_rwkv(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    n_params = sum(v.numel() for v in params.values())
    check(n_params == rwkv_param_count(cfg),
          f"{arch}: {n_params} params, its template holds "
          f"{rwkv_param_count(cfg)}")
    prompts = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(1))
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts at 0 just before, read just after
    flash_attention_hsd.launches = gmm_ecd.launches = 0
    wkv6_btHN.launches = 0
    res = serve(arch, reduced=False, batch=B, prompt_len=S,
                gen_len=gen_len, seed=0, dtype="bfloat16", device="cuda",
                use_kernels=True, params=params, prompts=prompts)
    launches = {"wkv6_btHN": wkv6_btHN.launches, "gmm_ecd": gmm_ecd.launches,
                "flash_attention_hsd": flash_attention_hsd.launches}
    want = {"wkv6_btHN": cfg.n_layers * (2 + gen_len + 1), "gmm_ecd": 0,
            "flash_attention_hsd": 0}
    check(want["wkv6_btHN"] == 456, f"expected launch counts {want}")
    check(launches == want, f"{arch} serve: launches {launches}, expected "
                            f"{want}")
    check(res["generated_shape"] == [B, gen_len],
          f"{arch} serve: generated_shape {res['generated_shape']}")
    peak = torch.cuda.max_memory_allocated()

    # checks below launch the kernel again; they are not the main path
    agree = rwkv_agreement(model, params, prompts)
    print("lm_serve " + json.dumps(dict(
        res, init_s=init_s, weight_bytes=weight_bytes, n_params=n_params,
        param_count=cfg.param_count(), serve_peak_bytes=peak,
        launches=launches, agreement=agree, card=card)))
    del params, model
    torch.cuda.empty_cache()
    return launches


def rwkv_layer_agreement(cfg, params, toks, models):
    """Each layer's block, kernel path against plain path on the same
    input: the prefill on the plain path's activations (its output and
    the S it leaves in its cache), then one decode step of each path from
    its own prefill cache (the kernel writing S into it). Returns the
    worst max_abs_err / max|plain| over the layers for each mode."""
    import torch
    from repro_torch.models.layers import apply_params, embed_tokens
    kern, plain = models
    kblocks = dict(kern.layers())
    S = toks.shape[1]
    x = embed_tokens({"tok": params["embed/tok"]}, toks, cfg, torch.float32)
    xt = embed_tokens({"tok": params["embed/tok"]}, toks[:, -1:], cfg,
                      torch.float32)
    worst = {"prefill": 0.0, "prefill_S": 0.0, "decode": 0.0,
             "decode_S": 0.0}
    for name, blk in plain.layers():
        sub = {k[len(name) + 1:]: v for k, v in params.items()
               if k.startswith(name + "/")}
        xk, ck, _ = apply_params(kblocks[name], sub, x, 0, S + 1)
        x, cache, _ = apply_params(blk, sub, x, 0, S + 1)
        pairs = [("prefill", xk, x), ("prefill_S", ck["S"].clone(),
                                      cache["S"].clone())]
        dk, _, _ = apply_params(kblocks[name], sub, xt, cache=ck, pos=S)
        dp, _, _ = apply_params(blk, sub, xt, cache=cache, pos=S)
        pairs += [("decode", dk, dp), ("decode_S", ck["S"], cache["S"])]
        for mode, a, b in pairs:
            rel = ((a - b).abs().max() / b.abs().max()).item()
            worst[mode] = max(worst[mode], rel)
            check(rel <= LM_F32_TOL,
                  f"rwkv {name} {mode}: f32 kernel vs plain on the same "
                  f"input max_abs_err / max|plain| = {rel} > {LM_F32_TOL}")
        xt = dp
    return worst


def rwkv_agreement(model, params, prompts):
    """The kernel path against use_kernels=False on the same (bf16,
    perturbed) params, in f32 compute (each bf16 weight cast to f32 at
    use), at each prompt length of RWKV["agree_prompts"] (512 crosses
    eight chunk boundaries):
      * gated, layer by layer on the same input (`rwkv_layer_agreement`):
        every block's prefill output and state, its first decode step's
        output and new state from its own prefill cache, within
        LM_F32_TOL x max|plain|;
      * reported, end to end: the prefill and first decode logits of the
        f32 and bf16 paths against the f32 plain path. This random model
        amplifies an f32 rounding difference ~2x per layer (24 layers:
        experiments/rwkv_wkv_agreement.py), so end to end the two f32
        paths land as far apart as two f32 summation orders of the plain
        path do, not within LM_F32_TOL."""
    import torch
    from repro_torch.models.model import ModelOpts, build_model
    cfg = model.cfg
    out = {}
    models = {(dt, k): build_model(cfg, ModelOpts(dtype=dt, remat=False,
                                                  use_kernels=k))
              for dt in ("float32", "bfloat16") for k in (False, True)}
    for S in RWKV["agree_prompts"]:
        toks = prompts
        if S > prompts.shape[1]:
            toks = torch.randint(0, cfg.vocab, (prompts.shape[0], S),
                                 device="cuda", generator=torch.Generator(
                                     device="cuda").manual_seed(S))
        logits, tok = {}, None
        with torch.inference_mode():
            out[f"prompt {S} f32 per-layer worst max_abs_err / max|plain|"] \
                = rwkv_layer_agreement(cfg, params, toks, (
                    models[("float32", True)], models[("float32", False)]))
            for key, m in models.items():
                lp, cache = m.prefill(params, toks, S + 1)
                if tok is None:  # every path decodes the same token
                    tok = torch.argmax(lp[:, -1].float(), -1)[:, None]
                ld, _ = m.decode_step(params, tok, cache, S)
                logits[key] = {"prefill": lp.float(), "decode": ld.float()}
                del cache
        for name in ("prefill", "decode"):
            ref = logits[("float32", False)][name]
            scale = ref.abs().max().item()
            for key, got in logits.items():
                check(torch.isfinite(got[name]).all().item(),
                      f"rwkv prompt {S} {name} {key}: non-finite logits")
                out[f"prompt {S} {name} {key[0]} kernels={key[1]} vs f32 "
                    f"plain"] = {
                    "max_abs_err": (got[name] - ref).abs().max().item(),
                    "max_abs_logit": scale,
                    "argmax_equal": int((got[name].argmax(-1)
                                         == ref.argmax(-1)).sum()),
                    "rows": ref.shape[0]}
        del logits
        torch.cuda.empty_cache()
    return out


def zoo_param_count(cfg):
    """Exact leaf count of the port's (and the reference's) model of
    `cfg`: `param_count` (the reference's) plus what it leaves out, less
    what it counts that the model does not hold:
      * the norms: norm1, norm2 (and a decoder block's xnorm) a layer,
        two a whisper encoder block, the final norms; a layernorm holds a
        scale and a bias;
      * MLA's q_norm and kv_norm scales (q_lora_rank + kv_lora_rank);
      * Mamba's conv_b, dt_proj, dt_bias, D (di each) and A_log (di·N),
        where param_count counts 2·di for the dt projection, A and D;
      * whisper's encoder position table (enc_tokens·d) and each decoder
        block's cross attention (as many weights as its self attention),
        less d·d_ff for each decoder and encoder block (a GELU MLP holds
        two matrices where param_count counts SwiGLU's three); an encoder
        block's attention holds what a decoder block's does, where
        param_count counts 4·d² (the same at whisper's widths: MHA,
        n_heads·head_dim = d);
      * paligemma's projector (frontend_dim·d)."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    norm = 2 * d if cfg.norm == "layernorm" else d
    kinds = cfg.pattern()
    n = cfg.param_count()
    n += (L * (3 if cfg.enc_layers else 2) + 1) * norm
    n += kinds.count("mla") * (cfg.q_lora_rank + cfg.kv_lora_rank)
    di = cfg.ssm_expand * d
    n += kinds.count("mamba") * (2 * di + di * cfg.ssm_state)
    if cfg.enc_layers:
        attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
        n += (2 * cfg.enc_layers + 1) * norm + cfg.enc_tokens * d
        n += L * attn + cfg.enc_layers * (attn - 4 * d * d)
        n -= (L + cfg.enc_layers) * d * cfg.d_ff
    if cfg.frontend == "vision_stub":
        n += (cfg.frontend_dim or d) * d
    return n


def phase_lm_zoo(card):
    """Serve the rest of the LM zoo (ZOO) at full width, bf16, with
    use_kernels, through `repro_torch.launch.serve.serve` on weights
    drawn on the card from seed 0 and the reference's stub frontends;
    each config's launches exactly as ZOO says, then the kernel path
    against use_kernels=False (`lm_agreement`). Returns the launches of
    the seven serves, summed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_hsd
    from repro_torch.kernels.gmm.kernel import gmm_ecd
    from repro_torch.launch.serve import serve, stub_frontend
    from repro_torch.models.model import ModelOpts, build_model
    B, S, gen_len = (LM[k] for k in ("batch", "prompt_len", "gen_len"))
    total = {"flash_attention_hsd": 0, "gmm_ecd": 0}
    for arch, n_layers, widths, n_flash, n_gmm in ZOO:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=n_layers)
        got = {k: getattr(cfg, k) for k in widths if k != "moe"}
        if "moe" in widths:
            m = cfg.moe
            got["moe"] = (m.n_experts, m.top_k, m.d_ff, m.n_shared, m.every)
        check(got == widths, f"{arch}: widths {got}, published {widths}")
        check(n_layers <= full.n_layers and (
            n_layers == full.n_layers
            or n_layers % math.lcm(len(cfg.layer_pattern),
                                   cfg.moe.every if cfg.moe else 1) == 0),
              f"{arch}: {n_layers} layers is not whole periods")
        n_attn = cfg.pattern().count("attn")
        n_moe = sum(cfg.is_moe_layer(i) for i in range(n_layers))
        want = {"flash_attention_hsd": 2 * n_attn,
                "gmm_ecd": 3 * n_moe * (2 + gen_len + 1)}
        check(want == {"flash_attention_hsd": n_flash, "gmm_ecd": n_gmm},
              f"{arch}: expected launch counts {want}")
        model = build_model(cfg, ModelOpts(dtype="bfloat16", remat=False,
                                           use_kernels=True))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        weight_bytes = sum(v.numel() * v.element_size()
                           for v in params.values())
        n_params = sum(v.numel() for v in params.values())
        check(n_params == zoo_param_count(cfg),
              f"{arch}: {n_params} params, its config holds "
              f"{zoo_param_count(cfg)}")
        prompts = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(1))
        torch.cuda.reset_peak_memory_stats()

        # the main path: counts at 0 just before, read just after
        flash_attention_hsd.launches = gmm_ecd.launches = 0
        res = serve(cfg, reduced=False, batch=B, prompt_len=S,
                    gen_len=gen_len, seed=0, dtype="bfloat16", device="cuda",
                    use_kernels=True, params=params, prompts=prompts)
        launches = {"flash_attention_hsd": flash_attention_hsd.launches,
                    "gmm_ecd": gmm_ecd.launches}
        check(launches == want, f"{arch} serve: launches {launches}, "
                                f"expected {want}")
        check(res["generated_shape"] == [B, gen_len],
              f"{arch} serve: generated_shape {res['generated_shape']}")
        peak = torch.cuda.max_memory_allocated()
        for k, v in launches.items():
            total[k] += v

        # checks below launch the kernels again; they are not the main path
        agree = lm_agreement(model, params, prompts, S + gen_len,
                             frontend=stub_frontend(cfg, B, "cuda"))
        print("lm_zoo " + json.dumps(dict(
            res, n_layers=n_layers, n_layers_config=full.n_layers,
            init_s=init_s, weight_bytes=weight_bytes, n_params=n_params,
            param_count=cfg.param_count(), init_peak_bytes=init_peak,
            serve_peak_bytes=peak, launches=launches, agreement=agree,
            card=card)))
        del params, model
        torch.cuda.empty_cache()
    return total


def kernel_counters():
    """Every kernel wrapper of the port, by name (each counts its own
    launches)."""
    from repro_torch.kernels import wrappers
    return wrappers()


def lm_train_run(arch, **kw):
    """One `train` on the card from an empty cache: the result, the step
    ms (the mean over the logged steps after the first two, every step
    logged and synced by reading its CE; the log lines are kept out of
    this script's output) and the peak bytes allocated."""
    import torch
    from repro_torch.launch.train import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        out = train(arch, reduced=kw.pop("reduced", False), log_every=1,
                    device="cuda", **kw)
    torch.cuda.synchronize()
    h = out["history"]
    ces = [r["ce"] for r in h]
    check(all(math.isfinite(c) for c in ces), f"{arch} train: CE {ces}")
    ms = 1e3 * (h[-1]["elapsed_s"] - h[1]["elapsed_s"]) / (len(h) - 2)
    return out, ces, ms, torch.cuda.max_memory_allocated()


def phase_lm_train(card):
    """LM training on the card through repro_torch.launch.train.train
    (use_kernels=False, as the reference trains): smollm-360m at full
    width in f32, in bf16 on f32 master weights and with remat; the other
    configs that fit the card for a few steps; the learning bars. No
    kernel launches in the phase: training takes the model's path."""
    import torch
    counters = kernel_counters()
    before = {n: f.launches for n, f in counters.items()}
    t_phase = time.perf_counter()
    arch = LM_TRAIN["arch"]
    kw = {k: v for k, v in LM_TRAIN.items() if k != "arch"}
    runs = {}
    for name, dtype, remat in (("f32", "float32", False),
                               ("bf16", "bfloat16", False),
                               ("remat", "float32", True)):
        out, ces, ms, peak = lm_train_run(arch, dtype=dtype, remat=remat,
                                          return_state=True, **kw)
        check(ces[-1] < ces[0], f"{arch} {name}: CE {ces[0]} -> {ces[-1]}")
        if name == "bf16":
            check(all(v.dtype == torch.float32 for tree in (
                out["params"], out["opt_state"]["m"], out["opt_state"]["v"])
                for v in tree.values()),
                f"{arch} bf16: a master or moment leaf is not f32")
        runs[name] = dict(ces=ces, ms=ms, peak=peak,
                          n_params=out["n_params"])
        print("lm_train " + json.dumps(dict(
            arch=arch, run=name, dtype=dtype, remat=remat, ce=ces,
            ms_per_step=ms, peak_bytes=peak, n_params=out["n_params"],
            optimal_ce=out["optimal_ce"], card=card)))
        del out
    a, b = runs["f32"]["ces"][:REMAT_MATCH], runs["remat"]["ces"][
        :REMAT_MATCH]
    rel = max(abs(x - y) / abs(y) for x, y in zip(b, a))
    check(rel <= 1e-6, f"{arch}: remat CE {b} against {a}")
    check(runs["remat"]["peak"] < runs["f32"]["peak"],
          f"{arch}: remat peak {runs['remat']['peak']} not below "
          f"{runs['f32']['peak']}")
    print("lm_train remat " + json.dumps(dict(
        bitwise=a == b, max_rel=rel, peak_bytes=runs["remat"]["peak"],
        plain_peak_bytes=runs["f32"]["peak"], card=card)))
    for arch in LM_TRAIN_FULL:
        out, ces, ms, peak = lm_train_run(
            arch, steps=LM_TRAIN_FULL_STEPS, batch=LM_TRAIN["batch"],
            seq=LM_TRAIN["seq"], lr=LM_TRAIN["lr"], dtype="bfloat16",
            remat=True)
        print("lm_train " + json.dumps(dict(
            arch=arch, run="full_bf16_remat", ce=ces, ms_per_step=ms,
            peak_bytes=peak, n_params=out["n_params"], card=card)))
        del out
    bars = {}
    for arch in LM_BARS["archs"]:
        kw = {k: v for k, v in LM_BARS.items() if k != "archs"}
        out, ces, ms, peak = lm_train_run(arch, reduced=True, **kw)
        bars[arch] = dict(first=ces[0], final=ces[-1],
                          optimal_ce=out["optimal_ce"], ms_per_step=ms)
        check(ces[-1] <= out["optimal_ce"] + LM_BAR_MARGIN,
              f"{arch}: final CE {ces[-1]} above optimal "
              f"{out['optimal_ce']} + {LM_BAR_MARGIN}")
    print("lm_train bars " + json.dumps(dict(bars, card=card)))
    after = {n: f.launches for n, f in counters.items()}
    check(after == before, f"lm_train launched kernels: {before} -> {after}")
    print(f"lm_train: no kernel launches; "
          f"{time.perf_counter() - t_phase:.1f} s")


def phase_gmm_guard():
    import torch
    from repro_torch.kernels.gmm.kernel import gmm_ecd
    x = torch.randn((2, 8, 64), device="cuda", requires_grad=True)
    w = torch.randn((2, 64, 32), device="cuda")
    try:
        gmm_ecd(x, w)
    except RuntimeError as e:
        print(f"gmm guard: raised under grad: {e}")
    else:
        fail("gmm_ecd ran on an input that requires grad")


def start_dryrun():
    """The dry-run cases, each in a process of its own (a dry-run makes
    its process a rank of a fake process group; it allocates nothing
    and uses the host's CPU, not the card), all started together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return [(case, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c", DRYRUN_SCRIPT, case[0], case[1],
         ",".join(map(str, case[2])), str(case[3])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for case in DRYRUN_CASES]


def finish_dryrun(procs, card):
    """Every case at full width must be ok: its three terms (data-sheet
    H100 constants), the bottleneck and the collective bytes a kind."""
    t0 = min(t for _, t, _ in procs)
    from repro_torch.configs import get_config
    for (arch, shape, mesh, layers), _, proc in procs:
        try:
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"dryrun {arch} {shape} {mesh}: over "
                 f"{DRYRUN_TIMEOUT_S} s")
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        check(proc.returncode == 0 and lines,
              f"dryrun {arch} {shape} {mesh}: exit {proc.returncode}: "
              f"{err[-2000:]}")
        rec = json.loads(lines[-1][len("RESULT "):])
        check(rec["status"] == "ok", f"dryrun {arch} {shape} {mesh}: "
              f"{rec.get('error')}\n{rec.get('traceback')}")
        cb = rec["collective_bytes"]
        print("dryrun " + json.dumps(dict(
            arch=arch, shape=shape, mesh=list(mesh),
            config="full width" + (
                "" if layers is None else
                f", {layers} of {get_config(arch).n_layers} layers (one "
                f"whole period; full depth over DRYRUN_TIMEOUT_S)"),
            policy=rec["policy"], fsdp=rec["fsdp"],
            param_dtype=rec["param_dtype"],
            compute_term_s=rec["compute_term_s"],
            memory_term_s=rec["memory_term_s"],
            collective_term_s=rec["collective_term_s"],
            bottleneck=rec["bottleneck"],
            collective_bytes={k: cb[k] for k in cb if k != "counts"},
            collective_counts=cb["counts"],
            collective_bytes_by_axis=rec["collective_bytes_by_axis"],
            counted_flops=rec["counted_flops"],
            flops_per_chip=rec["flops_per_chip"], trace_s=rec["trace_s"],
            wall_s=rec["wall_s"], host=card)))
    print(f"dryrun: {len(procs)} cases ok; "
          f"{time.perf_counter() - t0:.1f} s")


def phase_examples(card):
    """The port's six examples at their defaults on the card, each a
    process in a temp directory, all at once, and `serve_policy --quick
    --out DIR`: each exits 0; train_lm's final CE within LM_BAR_MARGIN
    of its floor, serve_policy_cartpole's programs flat after warmup,
    es_cartpole's fitness finite; the BENCH_torch_serve.json record
    valid and stamped with the card."""
    import tempfile
    import torch
    from repro_torch.launch.bench_record import validate_bench_json
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in EXAMPLES + ["serve_policy"]:
            cwd = os.path.join(tmp, name)
            os.makedirs(cwd)
            cmd = ([os.path.join(ROOT, "examples", "repro_torch",
                                 name + ".py")] if name in EXAMPLES else
                   ["-m", "repro_torch.launch.serve_policy", "--quick",
                    "--out", cwd])
            procs[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, *cmd], cwd=cwd, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = {}
        for name, (start, proc) in procs.items():
            try:
                out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                fail(f"example {name}: over {EXAMPLE_TIMEOUT_S} s")
            check(proc.returncode == 0,
                  f"example {name}: exit {proc.returncode}: {err[-2000:]}")
            outs[name] = out
            print(f"example {name}: exit 0, "
                  f"{time.perf_counter() - start:.1f} s")

        def field(text, key):
            found = [float(x) for x in
                     re.findall(rf"{key}=(-?[\d.]+|nan|inf)", text)]
            check(found, f"no {key}= in {text[-500:]}")
            return found

        final = field(outs["train_lm"], "final_ce")[-1]
        floor = field(outs["train_lm"], "entropy_floor")[-1]
        check(final <= floor + LM_BAR_MARGIN,
              f"train_lm: final CE {final} above {floor} + "
              f"{LM_BAR_MARGIN}")
        warm = int(re.search(r"warmup compiles: (\d+)",
                             outs["serve_policy_cartpole"]).group(1))
        after = int(re.search(r"compiles: (\d+)\s*$",
                              outs["serve_policy_cartpole"]).group(1))
        check(warm == after == 2, f"serve_policy_cartpole: programs "
              f"{warm} at warmup, {after} after the offered load")
        fits = (field(outs["es_cartpole"], "mean_fitness")
                + field(outs["es_cartpole"], "best_fitness"))
        check(len(fits) == 20 and all(math.isfinite(f) for f in fits),
              f"es_cartpole: fitness {fits}")
        path = os.path.join(tmp, "serve_policy", "BENCH_torch_serve.json")
        with open(path) as f:
            doc = validate_bench_json(json.load(f))
        check(doc["backend"] == "cuda" and doc["meta"]["device_name"]
              == torch.cuda.get_device_name(0) and doc["meta"]["quick"],
              f"BENCH_torch_serve.json meta {doc['meta']}")
        summary = json.loads(outs["serve_policy"].strip().splitlines()[-1])
        check(summary["recompiles_after_warmup"] == 0
              and summary["bench"] == "BENCH_torch_serve.json",
              f"serve_policy summary {summary}")
        print("examples " + json.dumps(dict(
            train_lm_final_ce=final, optimal_ce=floor,
            serve_policy_cartpole_programs=after,
            es_fitness_last=[fits[9], fits[19]],
            bench_rows=len(doc["rows"]), card=card,
            wall_s=time.perf_counter() - t0)))


def main():
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    card = phase_device()
    cases = phase_kernels()
    bwd_rows = phase_flash_bwd_kernel()
    scan_rows = phase_scan_kernels()
    replay_row = phase_replay_kernel()
    shard_row = phase_shard_kernel()
    gmm_rows = phase_gmm_kernel()
    launches = phase_slice(card)
    train_path = TRAIN_FLASH_CASES[0]
    train_launches = phase_training(
        card, dict(scan_rows, prioritized_sample_c=replay_row,
                   **{n: r[train_path] for n, r in bwd_rows.items()}))
    shard_launches = phase_replay_training(card, shard_row)
    path_rows = dict(
        scan_rows, prioritized_sample_c=replay_row, shard_topk_c=shard_row,
        **{n: r[train_path] for n, r in bwd_rows.items()})
    dist_launches, flat4 = phase_distribution(card, path_rows)
    pipe_launches = phase_pipeline_zero(card, path_rows, flat4)
    proc_launches = phase_processes(card, path_rows, flat4)
    for launches_of in (dist_launches, pipe_launches, proc_launches):
        for name, n in launches_of.items():
            if name == "shard_topk_c":
                shard_launches += n
            else:
                train_launches[name] += n
    phase_path_agreement()
    phase_evolution(card)
    phase_flash_guard()
    phase_cli()
    phase_gmm_guard()
    lm_launches = phase_lm_serve(card)
    wkv_rows = phase_wkv6_kernel()
    phase_wkv6_guard()
    rwkv_launches = phase_rwkv_serve(card)
    zoo_launches = phase_lm_zoo(card)
    # the dry-runs use the host's CPU for minutes: they run beside the LM
    # training phase and the examples, whose times they slow
    dryrun_procs = start_dryrun()
    phase_lm_train(card)
    phase_examples(card)
    finish_dryrun(dryrun_procs, card)
    serve = cases[(SERVE_CASE, "float32")]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict({
        "name": "flash_attention_hsd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
        "launches": launches + zoo_launches["flash_attention_hsd"]},
        **{k: serve[k] for k in keys})]
    # the training attention: the forward kernel writing lse, and its
    # backward (no pallas_call of its own: the adjoint of the forward's)
    for name in ("flash_attention_fwd_lse", "flash_attention_bwd"):
        row = bwd_rows[name][train_path]
        kernels.append(dict({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      + ("flash_attention_bwd.cu" if name.endswith("bwd")
                         else "flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention/kernel.py:96"
                        + (" (its backward; the reference has none)"
                           if name.endswith("bwd") else ""),
            "launches": train_launches[name]}, **{k: row[k] for k in keys}))
    replaces = {
        "discounted_return_tb": "src/repro/kernels/advantages/kernel.py:43",
        "discounted_return_adjoint_tb":
            "src/repro/kernels/advantages/kernel.py:43",
        "vtrace_tb": "src/repro/kernels/vtrace/kernel.py:55"}
    for name, row in scan_rows.items():
        src = "vtrace/csrc/vtrace.cu" if name == "vtrace_tb" \
            else "advantages/csrc/advantages.cu"
        kernels.append(dict({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}",
            "replaces": replaces[name],
            "launches": train_launches[name]}, **{k: row[k] for k in keys}))
    kernels.append(dict({
        "name": "prioritized_sample_c", "route": "cuda",
        "source": "src/repro_torch/kernels/replay_sample/csrc/"
                  "replay_sample.cu",
        "replaces": "src/repro/kernels/replay_sample/kernel.py:137",
        "launches": train_launches["prioritized_sample_c"]},
        **{k: replay_row[k] for k in keys}))
    kernels.append(dict({
        "name": "shard_topk_c", "route": "cuda",
        "source": "src/repro_torch/kernels/replay_sample/csrc/"
                  "replay_sample.cu",
        "replaces": "src/repro/kernels/replay_sample/kernel.py:113",
        "launches": shard_launches}, **{k: shard_row[k] for k in keys}))
    gmm_row = gmm_rows[(GMM_PATH[0], "bfloat16")]
    kernels.append(dict({
        "name": "gmm_ecd", "route": "cuda",
        "source": "src/repro_torch/kernels/gmm/csrc/gmm.cu",
        "replaces": "src/repro/kernels/gmm/kernel.py:42",
        "launches": lm_launches["gmm_ecd"] + zoo_launches["gmm_ecd"]},
        **{k: gmm_row[k] for k in keys}))
    # the serve path hands the kernel bf16 r, k, v, u: its prefill row
    wkv_row = wkv_rows[(WKV_BF16_CASES[0], "bfloat16")]
    kernels.append(dict({
        "name": "wkv6_btHN", "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:69",
        "launches": rwkv_launches["wkv6_btHN"], "dtype": wkv_row["dtype"]},
        **{k: wkv_row[k] for k in keys}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
