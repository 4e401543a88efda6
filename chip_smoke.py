#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card, exits 0 if all pass
    python3 chip_smoke.py --base DIR # A/B of the kernels against DIR

``--base DIR`` (DIR another checkout, e.g. the parent commit unpacked
with ``git archive`` under ``build/``) runs no phase: it builds this
tree's and DIR's kernels (one nvcc per source, all started together),
runs rows 1-10 at full qwen2-0.5b width under every PRNG impl (and the
buffered hw instances of rows 1-3 and 5-7) through this tree's wrappers
on either tree's kernels (``rbd_step.kernels_from``), holds every output
bit for bit against DIR's, times each in turns (DIR, this, this, DIR)
and exits non-zero if any output differs; then times gemma3-4b's bf16
prefill of phase 20 (depth 6, 2,048 tokens) through either tree's flash
wrapper and kernels in the same turns, logging each tree's flash
launches by kernel and how far apart their logits are.

Phases, each printing its own lines; any failure exits non-zero before the
result line:

1. device   -- card name and power limit, TF32 off, kernels built from
               ``src/repro_torch/kernels/csrc`` (build time, ptxas report);
               the pipe probes (PIPE_PROBE, built beside the kernels):
               each instruction class's rate in lanes per SM per clock
               (IMAD.WIDE.U32, IMAD, LOP3, FFMA, I2FP, MUFU, F2I, and
               pairs interleaved to see which share a pipe; logged, a
               diagnostic), the SASS instructions a value of
               Philox4x32-10, Threefry-2x32-20 and the normal transform
               by pipe class, Philox feeding the transform timed; the
               must path of the hot loops of ``project_kernel`` and
               ``reconstruct_apply_kernel`` <normal, hw> and <normal,
               threefry> counted in ``cuobjdump -sass`` (LDL / STL too);
               the bounds take the counts (value_counts) at the peaks of
               PIPE_LANES_PER_SM;
2. generator -- the ``generate_tile`` kernel against the plain generator
               under each PRNG impl (threefry, hw_emulated, hw) at three
               tile corners, the 2**32 wrap included: bits bit-exact for
               every distribution, samples bit-exact except normal (held
               to a stated tolerance); the hw paths' normal transform
               (``hw_logf``, ``hw_sqrtf``, ``hw_cosf``) bit for bit the
               CUDA library's on all 2**24 inputs of each; the plain
               generator's card form (fused passes, column chunks replayed
               as CUDA graphs) bit for bit its stepwise form
               (``rng.stepwise_form``), every impl and distribution;
3. kernels  -- ``project_packed`` and ``reconstruct_apply_packed`` against
               their plain versions on full-width qwen2-0.5b slices (one
               layer's 12 segments plus ``final_norm``; one dir-block of
               ``embed`` over all its positions): errors, zero padding,
               bit-identical reruns, in-place apply;
4. training -- ``repro_torch.launch.train`` at full qwen2-0.5b width and
               depth, 3 steps; exactly two kernel launches per step;
5. loss     -- the reduced tinyllama run of the reference's
               ``test_lm_training_reduces_loss``: loss drops by > 0.1;
6. timing   -- the plain versions at the main path's full shapes (timed,
               and held against the kernels there), the bound of each
               kernel;
7. workers  -- ``reconstruct_apply_packed_workers`` against its plain
               version: one full-width layer (K = 1 and 3, four
               distributions), one dir-block of ``embed`` (K = 2), the main
               path's full shapes (K = 2); K = 1 bit-identical to the
               single-worker kernel on worker seed fold_seed(s, 1);
8. K-worker -- the independent-bases simulation at full qwen2-0.5b width
               and depth (``SubspaceOptimizer(k_workers=4)``, 4 worker
               batches of 8 x 128, 3 steps, rsqrt_dim and exact): K
               projections plus ONE K-worker apply per step, then the
               plain version at K = 4 for the timing row;
9. exchange -- the launcher with a one-rank NCCL group in both
               ``--rbd-mode``s: one coordinate collective and two kernel
               launches per step;
10. adapters -- ``reconstruct_apply_packed_adapters`` against its plain
               version: one full-width layer (B = 1 and 3, four
               distributions), one dir-block of ``embed`` (B = 2), the full
               shapes (B = 4, timed, plain timed at B = 4); reruns
               bit-identical, padding exactly 0, and every row
               bit-identical to ``reconstruct_apply_packed``;
11. serving -- ``MultiTenantEngine`` serving qwen2-0.5b at full width and
               depth in bf16 (3 tenants' (seed, coords) adapters, 4 slots,
               6 requests, then the same 6 again): one adapter launch per
               admission tick with misses, none in decode or in the
               cache-hit round, greedy tokens identical across rounds and
               equal to ``Engine``'s on the tenant's parameters; every
               prefilled prompt launches the flash kernel once per layer
               (24 times), a decode tick never;
12. leaf kernels -- ``project_flat``, ``reconstruct_flat`` and
               ``reconstruct_apply_flat`` against their plain versions on
               full-width leaves (one layer's 12 stacked leaves at n_stack
               2, ``final_norm``, one 2-dir-block slice of ``embed``): four
               distributions, f32 and bf16 theta, bit-identical reruns and
               in-place apply, bf16 rounded once, and ``project_flat``
               bit-identical to ``project_packed`` on the same seeds;
13. per-leaf -- the launcher at full qwen2-0.5b width and depth, 3 steps
               each, one-rank NCCL group: ``--packed off`` (fused_per_leaf:
               14 project_flat + 14 reconstruct_apply_flat launches per
               step), ``--weight-decay 0.01`` (full_space: 14 + 14
               reconstruct_flat), ``--mode sgd`` (no launch and, on
               one rank, no collective); one collective per step on the
               other two; one fused_per_leaf step against one
               fused_packed step from the same parameters and batch; the
               plain versions timed at the main path's full shapes;
14. sharded kernels -- ``project_packed_sharded``,
               ``reconstruct_apply_packed_sharded`` and
               ``reconstruct_apply_packed_workers_sharded`` at full
               qwen2-0.5b width for model groups of m = 2 and 4, every
               shard in turn on the one card: each slab's apply (and K = 2
               worker apply) bit-identical to the slice of the unsharded
               kernel's output, the shard-ordered sum of the partial
               projections within tolerance of ``project_packed``,
               padding exactly 0, each kernel against its plain version
               on shards 1 and 3 of m = 4, per-shard times beside the
               unsharded kernels' in the same call;
15. sharded step -- the model-sharded packed step at full qwen2-0.5b
               width and depth, m = 2 shards in turn
               (``SubspaceOptimizer.step_shards_in_turn``), bf16 compute,
               batch 8 x 128, 3 steps each of sgd/rsqrt_dim,
               momentum/exact and independent bases, over a one-rank
               NCCL data group: 2 launches per shard per step, theta
               within tolerance of a ``fused_packed`` step from the same
               state;
16. prefill -- the two flash-attention kernels: the tensor-core one's
               SASS (``cuobjdump -sass``: HGMMA and UTMALDG in each of its
               four instances, head size 64, 80, 128 and 256, the highest
               register, no local memory; registers and spills from
               ptxas, 0 bytes spilled); each case
               through the kernel the wrapper chooses (tensor-core for
               bf16 at its head sizes, CUDA-core otherwise) against
               the plain version with that kernel's p_dtype (f32 and bf16;
               qwen2-0.5b's and tinyllama's heads, Sq = Sk in 1, 127, 200
               and 4,096, window None, 100 and 1,024, one non-causal Sq !=
               Sk case, batch 2 ragged, hd 128 windowed, kv_block 64
               ragged, Sq = 1; the CUDA-core kernel also on the bf16 cases
               the other takes; reruns bit-identical), then
               ``Engine.generate`` on one 8,192-token prompt at full
               qwen2-0.5b width and depth in bf16 with 32 new tokens:
               exactly 24 flash launches in the prefill, all of them the
               tensor-core kernel's, and none in decode, the last-position
               logits against ``transformer.forward`` (the blockwise
               function) beside the same layers through the plain version,
               the same prefill with f32 compute against forward at a
               tight limit, the greedy first token, the prefill timed
               beside the same layers through the blockwise function, peak
               memory; both kernels alone at 4,096, 8,192 and 32,768
               tokens held against their plain versions (reruns
               bit-identical) and timed in turns with the library's
               ``scaled_dot_product_attention``, the plain versions at
               8,192, and the bound; the tensor-core kernel's gate
               refusing two faults planted at 8,192 (the last K/V tile
               dropped, the causal edge one key short); the CUDA-core
               kernel's row logged;
17. prng     -- the tile-keyed PRNG path: the launcher's packed step at
               full width and depth, 3 steps each under ``--prng-impl hw``
               (the port's tile-keyed Philox4x32-10; the auto rule takes
               the unbuffered kernels on a card) and ``hw_emulated``: the
               expected ``prng impl:`` and ``prng kernels:`` lines, 2
               launches a step, finite losses; the buffered ``hw``
               kernels (the reference's auto rule) driven through the
               kernel API for 3 steps; rows 1-10 under both impls against
               their plain versions (phase 3's full-width layer, four
               distributions on rows 1-2, embed's first dir-block under
               hw, buffered and unbuffered on rows 1-2; K = 2, B = 2 with
               row 0 equal to the single apply, m = 2 slabs equal to the
               slices; one stacked leaf for rows 8-10); double_buffer on and off bit-identical on rows 1-3
               and 5-7 under all three impls; ``project_packed`` and
               ``reconstruct_apply_packed`` timed at full width under
               threefry, hw_emulated, hw and hw + buffer in turns, each
               tile-keyed plain version once at the full shapes and held
               against each timed variant of its kernel;
18. resilience -- the guarded packed step at full qwen2-0.5b width and
               depth (batch 8 x 128, rbd-dim 1024, adam, Threefry) through
               ``launch.train.run_training`` with the guard, the sentinel
               every 2 steps, the replay log and a snapshot every 3 steps,
               a NaN gradient at step 1: (a) 6 steps straight through,
               (b) killed before step 4, (c) resumed from (b)'s directory;
               (c)'s theta, adam state and guard state bit for bit (a)'s,
               recovery from snapshot 3 with 1 record replayed (1
               ``reconstruct_apply_packed`` launch, no projection), step 1
               rejected as ``nonfinite_local``, 2 launches and 1 all-reduce
               (the rider on it) a live step; one guarded and one
               unguarded ``train_step`` under
               ``torch.cuda.set_sync_debug_mode("warn")`` (the guard adds
               no host synchronization), both timed; the snapshot's size,
               write and verified restore times, the replay of one record
               timed beside a step; the directory removed at the end;
19. basis    -- the basis layer.  (a) FPD (a fixed random basis) with
               L-BFGS (history 8), coordinate clipping at norm 1 and a
               cosine schedule with 1 warmup step on the packed kernels at
               full qwen2-0.5b width and depth (batch 8 x 128, rbd-dim
               1024, Threefry, one-rank NCCL group), 4 steps: exactly 2
               launches and one (d,) all-reduce a step, finite losses, the
               L-BFGS ring's fill after each step, step wall and launch
               ms, and no more synchronizing operations in one such step
               than in one step of bare sgd (``set_sync_debug_mode``);
               (b) the resident basis at the largest size one card holds:
               full width cut to depth 1, rbd-dim 14 (total_dim 25,
               q_packed 151,049,216, a 15.1 GB basis): the draw and the
               QR (``projector.orthonormal_rows``, CholeskyQR2) timed
               apart, their peak memory, max|B B^T - I| <= 1e-4, padding
               columns exactly 0, both products timed against their byte
               bounds, then ``launch.train.run_training`` with
               ``--basis trajectory_pca --coord-optimizer lbfgs`` for 3
               steps: 0 RBD launches, the run's basis held the same way,
               theta's padding exactly 0, the collector's host pull of
               theta timed; (c) the reference's acceptance experiment
               (``tests/test_basis.py:343``) at its own size (reduced
               qwen2-0.5b, rbd-dim 40, batch 2 x 16, 40 steps): random +
               sgd at lr 0.5 on the kernels, trajectory_pca + lbfgs at lr
               1.0 refreshed every 8 steps, tail-mean losses and their
               order reported; gradient_informed + momentum, 8 steps,
               refresh every 3: the basis changed, same shape,
               orthonormal within 1e-4;
20. zoo      -- the decoder-only model zoo at full width, one drive at a
               time, each freed before the next (ZOO_DRIVES): mixtral-8x7b
               at depth 2, gemma3-4b at depth 6 (5 local layers, window
               1,024, 1 global; the tied 262,144 vocabulary), rwkv6-1.6b
               and zamba2-2.7b at full depth, llava-next-mistral-7b at
               depth 2 with 576 patches, phi3.5-moe and granite-34b at
               depth 1.  (a) The packed step (shared basis, Threefry) for
               3 steps (1 for the depth-1 drives): 2 launches a step after
               the first, finite losses, theta moved; launch ms, step wall,
               peak memory.  (b) ``Engine.generate`` on one prompt (512
               tokens; gemma3 2,048; llava 576 patches + 64) with 16 greedy
               tokens: the prefill's flash launches one per attention layer
               and per hybrid group (rwkv6 none), none in decode, ``len``
               advancing; the last-position logits against forward's in
               bf16 (within 4%, or twice the plain-version route's reading
               where a deep stack carries more bf16 noise) and with f32
               compute (PREFILL_F32_RTOL), and each bf16 route (kernel,
               forward, plain version) against the f32 forward
               (ZOO_BF16_F32_RTOL); the bf16 prefill launches only the
               tensor-core flash kernel, the f32 one only the CUDA-core
               kernel.  (c) Both flash kernels at gemma3's heads (8 / 4 of
               256, window None and 1,024) and zamba2's (32 / 32 of 80),
               bf16, at 2,048 and 8,192 tokens: the tensor-core
               instances' registers and spills; each kernel against the
               plain version with its p_dtype within row 11's gate, reruns
               bit-identical, timed in turns with
               ``scaled_dot_product_attention``, the plain versions timed
               at 8,192, where the tensor-core kernel's gate must refuse
               the two planted faults;
21. encdec / vision -- (a) whisper-tiny at full width and depth (4 + 4
               layers, 1,500 frames, vocabulary 51,865), bf16, the packed
               step (shared basis, Threefry, rbd-dim 1024) on batch 8 x
               (1,500 frames + 128 tokens) through ``train/step.py`` for 3
               steps: 2 launches a step after the first, finite losses,
               theta moved; launch ms, step wall, peak memory.  (b)
               ``encdec.prefill_cross_cache`` on 2 x 1,500 frames and 32
               greedy ``decode_step``s: exactly 4 flash launches in the
               prefill, all the tensor-core kernel's, none in decode; the
               encoder's output through the kernel against the same layers
               through the blockwise function, and every decoded
               position's logits against a teacher-forced ``forward`` on
               the same tokens, in bf16 within 4% of the largest magnitude
               or twice the plain-version route's reading, with f32
               compute within PREFILL_F32_RTOL; prefill ms, decode ms a
               token.  (c) The tensor-core flash kernel alone at the
               encoder's shape (6 / 6 heads of 64, Sq = Sk = 1,500,
               non-causal, bf16) within row 11's gate of its plain
               version, reruns bit-identical, timed in turns with
               ``scaled_dot_product_attention``.  (d) FC, CNN and ResNet8
               at 32 x 32 x 3, batch 32, make_plan(params, 250), 5 RBD
               steps each through ``projector.rbd_gradient`` on the
               per-leaf kernels: one ``project_flat`` and one
               ``reconstruct_flat`` launch a leaf a step, the first step's
               sketch against the torch backend's; the reference's
               acceptance run (tests/test_system.py:55: FC at 14 x 14 x 1,
               rbd-dim 128, lr 2.0, 120 steps) with its gate, accuracy >
               0.5; RBD against FPD (:63: rbd-dim 64, 150 steps, 2 seeds),
               reported;
22. tools    -- (a) ``examples.quickstart`` at its own settings (FC at 28
               x 28 x 1, a global 'exact' plan of d 250, lr 2.0, batch 32,
               300 steps): ``fused_per_leaf``, one ``project_flat`` and
               one ``reconstruct_flat`` a step (a flattened plan
               reconstructs, then subtracts, as the reference's
               ``reconstruct_apply`` does), its first 5 losses against
               the same steps on the plain backend on the card, accuracy
               > 0.5 at step 299, ms a step; (b) ``core.nes.nes_gradient``
               on that plan (sigma 0.02, one batch): one ``project_flat``
               (the 'exact' norm pass) and one ``reconstruct_flat``,
               cosine > 0.99 with the RBD sketch at the same seed, the
               kernels' delta against the plain version on the same
               coordinates, ms of its 500 forward passes; (c)
               ``examples.train_lm --workers 1`` (qwen2-100m, rbd-dim
               4,096, batch 16 x 256): the step count from the plan's
               live basis values at phase 4's rate of rows 1-2, 2 launches
               a step, finite losses, the preamble's D, d, reduction and
               traffic those of ``make_plan`` / ``grad_comm_bytes``,
               launch ms, step wall, peak memory; (d) ``train.loop.train``
               on qwen2-0.5b at full width and depth with phase 4's
               arguments, the guard on, an evaluation every 2 steps and a
               checkpoint every 3: its losses phase 4's bit for bit, each
               step's synchronizing operations (``set_sync_debug_mode``,
               by ``train_step``, evaluation, checkpoint and the loop's
               own) and step 1's no more than the launcher's guarded
               step, no deferred observe off a log boundary;
23. pjit     -- pjit-style parameter sharding.  (a) The launcher's
               ``--mode pjit --data 1 --model 1`` on qwen2-0.5b at full
               width and depth (pure data parallel: nothing cut), 8 x 128,
               3 steps: ``fused_per_leaf`` with the reference's reason, 14
               + 14 launches a step (rows 8 and 10), the losses phase 13's
               per-leaf route's bit for bit; collectives a step, step
               wall.  (b) rwkv6-1.6b at full width and depth on the
               megatron layout of a model group of 4 (embed cut on 0,
               the in-projections on -1, the out-projections on -2), run
               one shard after the other on one step's gradient: the
               projector on each rank's leaf shards (rows 8-10's shard
               instances, counted and timed per shard), every shard's
               reconstruct and apply bit for bit the unsharded kernels'
               slices, the partials summed in shard order within
               PROJ_ULPS of the unsharded projection; each shard
               instance against its plain version on a window (layer 0 of
               ``cmix/wk`` and ``cmix/wv`` on every shard, embed's first
               2**20 local positions on shard 1), the plain versions
               timed there; the bound of the group's shard work;
24. dryrun   -- the dry run (``launch.dryrun``) against the card.  (a)
               phase 4's step traced on meta tensors in a fake world of
               one rank, its prediction logged before the same step runs
               on the card: kernel calls equal to LAUNCHES, collective
               sites to COLLECTIVES, flops to FlopCounterMode's on the
               real step; the predicted temp memory within DRY_MEM_RTOL
               + DRY_MEM_ATOL of max_memory_allocated over the step; the
               roofline's max(t_compute, t_memory) beside the step wall
               (reported); (b) host microseconds a call through each
               kernel op against the launch function called directly
               (the path before the ops), for rows 1-2 at phase 4's
               shapes and rows 8-9 at the FC image model's largest leaf,
               the wrappers' whole calls and FC's ``rbd_gradient``; (c)
               ``dryrun --all`` runs on the CPU outside the phase;
25. slab resilience -- phase 18's run on the model-sharded slabs: m = 2
               shards in turn (``SubspaceOptimizer.step_shards_in_turn``)
               at full qwen2-0.5b width and depth, adam, rbd-dim 1024, 8
               x 128, the guard, the sentinel every 2 steps, the replay
               log and a snapshot every 3, a NaN gradient at step 1.  (a)
               6 steps straight through: the reasons phase 18 (a)'s step
               for step, the slabs concatenated and cut to q_packed within
               THETA_RTOL of phase 18 (a)'s theta, the padding exactly 0,
               rows 5 and 6 once a shard every step (the rejected step's
               apply counted); (b) killed before step 4, the snapshot the
               (q_padded,) buffer; (c) resumed from (b)'s directory: the
               slabs, adam and guard state bit for bit (a)'s, the replay
               one row-6 launch a shard and nothing else; the snapshot's
               bytes, write, verified restore and replay seconds; the
               directory (under ``build/``) removed at the end;
then the ``kernels`` line (eleven rows, then the six tile-keyed rows
``[hw_emulated]``, ``[hw,db]`` and ``[hw]`` of rows 1-2, then the
tensor-core flash kernel's rows at head sizes 80 and 256 (launches: the
bf16 prefills of phase 20) and the CUDA-core kernel's there (launches:
the f32 prefills), then the tensor-core kernel's at the encoder's
non-causal 1,500-token shape (launches: phase 21's bf16 prefill), then
the three shard instances of rows 8-10 (launches: phase 23 (b)'s path,
ms its per-step sum over the 4 shards, plain ms on its window); rows
1-2 count phase 19 (a)'s, phase 20's, phase 21's and phase 22's
launches too, rows 8-9 phase 21's image models' and phase 22's, rows 8
and 10 phase 23 (a)'s, rows 1-2 phase 24's, rows 5-6 phase 25's, row 11
phase 20's at head size 128 and phase 21's encoder), the card line and
the result line.

It imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 3
ARCH_ARGS = ["--arch", "qwen2-0.5b", "--mode", "sharedseed", "--data", "1",
             "--rbd-backend", "cuda", "--rbd-dim", "1024", "--batch", "8",
             "--seq", "128", "--steps", str(STEPS), "--kernel-times"]
DISTS = ("normal", "uniform", "rademacher", "sparse")
# Tolerances (reasons in PERF.md):
NORMAL_SAMPLE_ATOL = 1e-6   # normal samples: CUDA logf/cosf vs torch's, ulps
U_RTOL = 2e-5    # |du| / (||g_seg|| sqrt(sq/Q)): f32 sums in another order
SQ_RTOL = 2e-5   # |dsq| / sq: f32 sums of squares in another order
THETA_RTOL = 1e-4  # |dtheta| / max|update|, plus 2 ulp of max|theta|
# Operation counts of one live basis value (see csrc/rbd_step.cu): the
# generator's and the normal transform's are read from the SASS of phase
# 1's probes (PIPE_PROBE, value_counts); the other distributions' sample
# mappings are counted from the source (FP32 instructions); the
# contraction adds FMAs.
FP_OPS_PER_VALUE = {"normal": 41, "uniform": 6, "rademacher": 1,
                    "sparse": 5}
FMA_PER_VALUE = {"project_packed": 2, "reconstruct_apply_packed": 1,
                 "reconstruct_apply_packed_workers": 1,
                 "reconstruct_apply_packed_adapters": 1,
                 "project_flat": 2, "reconstruct_flat": 1,
                 "reconstruct_apply_flat": 1, "project_packed_sharded": 2,
                 "reconstruct_apply_packed_sharded": 1,
                 "reconstruct_apply_packed_workers_sharded": 1}
K_SIM = 4          # workers of the phase-8 simulation
B_FULL = 4         # adapters of the phase-10 full-shape launch
# phase 11: the serving run (prompt lengths 32-128, 32 new tokens each)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 256, 32
SIM_STEPS = 3
# phases 14-15: model groups, the workers of the sharded K-worker apply,
# the shards of m = 4 held against the plain versions (shard 1 straddles
# the end of embed, shard 3 holds the padding tail), the row's shard
M_SHARDS = (2, 4)
K_SHARDED = 2
PLAIN_SHARDS = (1, 3)
ROW_SHARD = (4, 1)
SHARDED_KERNELS = ("project_packed_sharded",
                   "reconstruct_apply_packed_sharded",
                   "reconstruct_apply_packed_workers_sharded")
# phase 15's runs: (label, rbd mode, optimizer, normalization)
SHARD_RUNS = (("sgd/rsqrt_dim", "shared_basis", "sgd", "rsqrt_dim"),
              ("momentum/exact", "shared_basis", "momentum", "exact"),
              ("independent/rsqrt_dim", "independent_bases", "sgd",
               "rsqrt_dim"))
SHARD_M = 2
# phase 16: the flash kernel against its plain version -- head layouts
# (H, KV, hd) of qwen2-0.5b and tinyllama-1.1b, lengths Sq = Sk, windows;
# the long-prompt prefill at full qwen2-0.5b width and depth; the lengths
# the kernel alone is timed at (32,768 is the reference's prefill_32k
# shape, batch cut to 1); the kernels line's row at 8,192 bf16
FLASH_HEADS = {"qwen2-0.5b": (14, 2, 64), "tinyllama-1.1b": (32, 4, 64)}
FLASH_LENGTHS = (1, 127, 200, 4096)
FLASH_WINDOWS = (None, 100, 1024)
FLASH_TIMED = (4096, 8192, 32768)
# launches timed back to back between one pair of events (the rest: 1)
FLASH_BURST = {(4096, "bfloat16"): 8, (8192, "bfloat16"): 4}
PREFILL_LEN, PREFILL_NEW = 8192, 32
# Tolerances of phase 16 (readings in PERF.md).  A kernel against its
# plain version, element by element: the two compute the same f32 values
# up to sums over another tiling (within 1e-5 of max|v|: the output is a
# convex combination of v's rows) and, for bf16 outputs, each rounds once
# (one bf16 ulp of the larger value: |rnd(x) - rnd(y)| <= |x - y| + ulp).
# The tensor-core kernel (bf16 at head size 64, 80, 128, 256) rounds P to
# bf16 for P V, as its plain version with p_dtype=bfloat16 does at the
# same tiles (128 keys, 64 at head size 256); where the two f32 p of a key lie on either side of a rounding
# midpoint they land one bf16 ulp (<= 2**-7 p) apart and move the row by
# 2**-7 of that key's weight p / l times its v: allowed once a row, at
# max|v| and the largest weight a key that can land so may have.  The
# row's largest key has p = exp(0) = 1 on both sides, exact in bf16, and
# weight 1 / l (l of the plain version); any other has at most min(1 / l,
# 1 - 1 / l), so the term never exceeds 2**-8 max|v|.  On top,
# the whole output within 2**-10 of its norm (relative L2: agreeing f32
# values round alike, so only the few near a midpoint differ).  The gate
# must refuse two faults planted at 8,192 tokens, read on the rows past
# 4,096: the last K/V tile dropped, the causal edge one key short.
#
# The bf16 prefill's last-position logits against forward's (the
# blockwise function) within 4% of max|logits|: twice the 2.02% that the
# same layers through the plain version, a second sound route, read
# against forward on the H100 (each layer's attention output rounds to
# bf16 from f32 values that agree to ~1e-6, an element may land one bf16
# ulp apart, and 24 layers of residual carry it).  With f32 compute the
# two routes differ by f32 rounding only: within 2e-5 of max|logits|,
# seven times the 2.84e-6 read there; a wrong mask or a bf16 round on the
# way is far above it.
FLASH_ATOL_OF_V = 1e-5
FLASH_P_FLIP = 2.0 ** -7
FLASH_REL_L2 = 2.0 ** -10
PREFILL_LOGIT_RTOL = 0.04
PREFILL_F32_RTOL = 2e-5
# phase 18: the resilience runs (adam at the launcher's adam rate), the
# fault plan (a NaN gradient at step 1, a kill before step 4) and the
# steps timed of each of the guarded and the unguarded train_step
RES_STEPS, RES_LR, RES_TIMED = 6, 0.02, 4
PHASE18 = {}   # (a)'s reasons step by step, losses, final theta (host)
# phase 19: (a) the FPD + L-BFGS run's steps; (b) the depth-1 resident
# basis's rbd-dim and steps, the column chunk of its Gram check; (c) the
# reference's acceptance run and its gradient_informed check
BASIS_STEPS = 4
RESIDENT_DIM, RESIDENT_STEPS = 14, 3
GRAM_CHUNK = 1 << 24
ACCEPT_STEPS, ACCEPT_REFRESH, ACCEPT_TAIL = 40, 8, 5
GI_STEPS, GI_REFRESH = 8, 3
# phase 20: each zoo drive (arch, depth cut or None for full, batch, text
# length, rbd-dim, steps, serving prompt length) at full width; the
# drives' learning rate, theta's sample stride, the new tokens served; the
# flash kernel at gemma3's (8 / 4 heads of 256) and zamba2's (32 / 32 of
# 80) heads with their windows, at these lengths
ZOO_DRIVES = (
    ("mixtral-8x7b", 2, 4, 128, 256, 3, 512),
    ("gemma3-4b", 6, 1, 2048, 256, 3, 2048),
    ("rwkv6-1.6b", None, 8, 128, 1024, 3, 512),
    ("zamba2-2.7b", None, 2, 128, 1024, 3, 512),
    ("llava-next-mistral-7b", 2, 2, 64, 1024, 3, 64),
    ("phi3.5-moe-42b-a6.6b", 1, 4, 128, 256, 1, 512),
    ("granite-34b", 1, 4, 128, 256, 1, 512),
)
ZOO_LR, ZOO_THETA_STRIDE, ZOO_NEW = 0.1, 997, 16
# The bf16 prefill's last-position logits against forward's: within 4% of
# max|logits| (phase 16's limit for qwen2-0.5b's 24 layers), or twice what
# the second sound route (the same layers through the plain version) reads
# against forward, where a deeper stack carries more bf16 noise (zamba2's
# 54 layers); the f32-compute check at PREFILL_F32_RTOL is the tight one.
# Each of the three bf16 routes (kernel prefill, forward, plain version)
# is also held against the f32 forward, which shares no bf16 cast with
# them, within the drive's ZOO_BF16_F32_RTOL of its max|logits|: about
# 1.5x the largest of the three read on the H100 at 700 W for the deep
# recurrent stacks (rwkv6 33.8% on all three routes, zamba2 19.7-20.7%:
# bf16 drift at full depth), 2% for the attention drives (0.19-0.70%)
ZOO_SOUND_FACTOR = 2.0
ZOO_BF16_F32_RTOL = {arch: 0.02 for arch, *_ in ZOO_DRIVES}
ZOO_BF16_F32_RTOL.update({"rwkv6-1.6b": 0.5, "zamba2-2.7b": 0.32})
ZOO_FLASH_HEADS = ((8, 4, 256, (None, 1024)), (32, 32, 80, (None,)))
ZOO_HEAD_SIZES = tuple(sorted(hd for _, _, hd, _ in ZOO_FLASH_HEADS))
ZOO_FLASH_LENGTHS = (2048, 8192)
# launches timed back to back between one pair of events, by length
ZOO_FLASH_BURST = {2048: 4}
# phase 21: whisper-tiny's packed step at full width and depth (batch,
# tokens beside its 1,500 frames, rbd-dim, steps); its decode (batch,
# greedy steps); the flash kernel at the encoder's shape (heads, kv heads,
# head size, frames) and the launches of one timed burst; the image models
# at the paper's CIFAR geometry (shape, batch, rbd-dim, steps) and their
# learning rate; the reference's acceptance run (tests/test_system.py:55:
# shape, rbd-dim, lr, steps), its RBD-against-FPD run (:63: rbd-dim, steps,
# seeds) and their evaluation images
ENC_TRAIN = (8, 128, 1024, 3)
ENC_DECODE_B, ENC_NEW = 2, 32
ENC_FLASH = (6, 6, 64, 1500)
ENC_FLASH_BURST = 16
# ~2.5 ms of an H100 SM's clock: longer than the host takes to issue a
# burst, which it queues while the stream sleeps
ENC_SLEEP_CYCLES = 5_000_000
VISION_RUN = ((32, 32, 3), 32, 250, 5)
VISION_LR = 2.0
VISION_ACCEPT = ((14, 14, 1), 128, 2.0, 120)
VISION_FPD = (64, 150, 2)
VISION_EVAL = 512
# Peak rates of an H100 SM (sm_90) in lanes a clock, the bound's table:
# 4 schedulers issue one warp instruction a clock each (128); the integer
# ALU 64 (LOP3, shifts, compares, selects, I2FP); the FP32 "heavy" pipe 64,
# the only one that runs IMAD (IMAD.WIDE's 64-bit result takes it twice);
# the FP32 "lite" pipe 64; the XU 16 (MUFU, F2I and the other
# conversions).  Adds and moves (IADD3, LEA, MOV and their IMAD forms) run
# on the ALU or the heavy pipe, FFMA / FMUL / FADD on either FP32 pipe.
# Phase 1's probes measure each class's rate; they are logged, not used.
ISSUE_LANES_PER_SM = 128
PIPE_LANES_PER_SM = {"alu": 64, "heavy": 64, "lite": 64, "xu": 16}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
# peaks of the H100 SXM at 700 W (NVIDIA's data sheet, dense): bf16 on the
# tensor cores, f32 on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


T_START = time.perf_counter()


def log(msg: str = "") -> None:
    if msg.startswith("== phase"):   # each phase's start, in the run's time
        msg += f"  [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# Phase 1's probes (PIPE_PROBE): loops timed on the whole card whose SASS
# is read with cuobjdump.  Each probe kernel runs `trips` trips of one
# fully unrolled body; thread 0 of each block stamps the SM's clock64 at
# entry and after a block barrier at exit, with the SM's id, so a class's
# rate is its lanes over the SMs' cycles (lanes per SM per clock), whatever
# clock the card runs at.  Single-class probes: 8 independent chains of
# one PTX instruction (mad.wide.u32 -> IMAD.WIDE.U32, mad.lo.u32 -> IMAD,
# lop3.b32 -> LOP3, fma.rn.f32 -> FFMA, cvt.rn.f32.u32 -> I2F,
# rsqrt.approx.f32 -> MUFU.RSQ), 4 trips of 8 chains a trip.  Generator
# probes, each in two sizes whose bodies differ by 8 basis values (the
# difference is what one value costs, loop overhead cancelled): Philox
# as the hw projection runs it (philox_start / philox_rounds under round
# keys in shared memory, 1 or 2 columns of 4 calls, its words folded with
# 3-input xors: 2 LOP3 a call), Threefry-2x32-20 (4 or 8
# calls, each folded with one LOP3), the normal transform alone on bits
# from an LCG (8 or 16 values; 2 IMAD for the bits and one FADD for the
# sum a value) in the hw form (the library's fast paths, one-FFMA
# uniforms) and in Threefry's (the library calls); and
# Philox feeding the hw transform (16 values a trip, summed).
PIPE_PROBE = r"""
#include <stdint.h>
#include <string.h>
#include "philox.cuh"
#include "threefry.cuh"

__device__ __forceinline__ void stamp(long long t0, long long* clk) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    clk[3 * blockIdx.x] = t0;
    clk[3 * blockIdx.x + 1] = clock64();
    clk[3 * blockIdx.x + 2] = sm;
  }
}

__device__ __forceinline__ uint32_t fold(uint64_t v) {
  return static_cast<uint32_t>(v) ^ static_cast<uint32_t>(v >> 32);
}
__device__ __forceinline__ uint32_t fold(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t fold(float v) { return __float_as_uint(v); }

#define CHAIN_PROBE(NAME, T, INIT, ASM, ...)                                 \
  extern "C" __global__ void NAME(uint32_t s, int trips, uint32_t* sink,     \
                                  long long* clk) {                          \
    const long long t0 = clock64();                                          \
    T a[8];                                                                  \
    _Pragma("unroll") for (int k = 0; k < 8; ++k) a[k] = INIT;               \
    _Pragma("unroll 1") for (int t = 0; t < trips; ++t) {                    \
      _Pragma("unroll") for (int u = 0; u < 4; ++u) {                        \
        _Pragma("unroll") for (int k = 0; k < 8; ++k) {                      \
          asm volatile(ASM : __VA_ARGS__);                                   \
        }                                                                    \
      }                                                                      \
    }                                                                        \
    uint32_t acc = 0;                                                        \
    _Pragma("unroll") for (int k = 0; k < 8; ++k) acc ^= fold(a[k]);         \
    sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;                       \
    stamp(t0, clk);                                                          \
  }

CHAIN_PROBE(p_imad_wide, uint64_t, s + threadIdx.x * 8u + k,
            "mad.wide.u32 %0, %1, %2, %0;",
            "+l"(a[k]) : "r"(static_cast<uint32_t>(a[k])), "r"(0xD2511F53u))
CHAIN_PROBE(p_imad, uint32_t, s + threadIdx.x * 8u + k,
            "mad.lo.u32 %0, %0, %1, %2;",
            "+r"(a[k]) : "r"(0xD2511F53u), "r"(a[(k + 1) & 7]))
CHAIN_PROBE(p_lop3, uint32_t, s + threadIdx.x * 8u + k,
            "lop3.b32 %0, %0, %1, %2, 0x96;",
            "+r"(a[k]) : "r"(a[(k + 1) & 7]), "r"(a[(k + 2) & 7]))
CHAIN_PROBE(p_ffma, float, 1.0f + 1e-3f * (threadIdx.x + k),
            "fma.rn.f32 %0, %0, %1, %2;",
            "+f"(a[k]) : "f"(0.999f), "f"(a[(k + 1) & 7]))
CHAIN_PROBE(p_i2f, float, static_cast<float>(s + threadIdx.x + k),
            "cvt.rn.f32.u32 %0, %1;",
            "+f"(a[k]) : "r"(__float_as_uint(a[k])))
CHAIN_PROBE(p_mufu, float, 1.0f + 1e-3f * (threadIdx.x + k),
            "rsqrt.approx.f32 %0, %0;", "+f"(a[k]))
CHAIN_PROBE(p_f2i, float, 1.0f + 1e-3f * (threadIdx.x + k),
            "{.reg .s32 t; cvt.rni.s32.f32 t, %0; mov.b32 %0, t;}",
            "+f"(a[k]))
// two classes interleaved, 16 of each a trip: do they share a pipe?
CHAIN_PROBE(p_lop3_i2f, uint32_t, s + threadIdx.x * 8u + k,
            "{.reg .f32 t; lop3.b32 %0, %0, %1, %2, 0x96; "
            "cvt.rn.f32.u32 t, %0; mov.b32 %0, t;}",
            "+r"(a[k]) : "r"(a[(k + 1) & 7]), "r"(a[(k + 2) & 7]))
CHAIN_PROBE(p_ffma_imad, float, 1.0f + 1e-3f * (threadIdx.x + k),
            "{.reg .u32 t; fma.rn.f32 %0, %0, %1, %2; mov.b32 t, %0; "
            "mad.lo.u32 t, t, 3, t; mov.b32 %0, t;}",
            "+f"(a[k]) : "f"(0.999f), "f"(a[(k + 1) & 7]))

// the round keys of the key (s, s ^ salt) in shared memory, as the hw
// projection holds them
__device__ __forceinline__ const uint32_t* probe_round_keys(uint32_t s) {
  __shared__ __align__(16) uint32_t rk[2 * rbd::kPhiloxRounds];
  if (threadIdx.x == 0) rbd::philox_store_round_keys(s, s ^ 0x85EBCA6Bu, rk);
  __syncthreads();
  return rk;
}

template <int NC>
__device__ __forceinline__ void philox_body(uint32_t s, int trips,
                                            uint32_t* sink, long long* clk) {
  const long long t0 = clock64();
  const uint32_t* rk = probe_round_keys(s);
  uint32_t acc = 0;
#pragma unroll 1
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      uint32_t w[4][4];
      rbd::philox_start(threadIdx.x + 256u * n + t, w);
      rbd::philox_rounds<0, rbd::kPhiloxRounds>(rk, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc ^= w[j][0] ^ w[j][1];
        acc ^= w[j][2] ^ w[j][3];
      }
    }
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  stamp(t0, clk);
}
extern "C" __global__ void p_philox8(uint32_t s, int trips, uint32_t* sink,
                                     long long* clk) {
  philox_body<1>(s, trips, sink, clk);
}
extern "C" __global__ void p_philox16(uint32_t s, int trips, uint32_t* sink,
                                      long long* clk) {
  philox_body<2>(s, trips, sink, clk);
}

template <int CALLS>
__device__ __forceinline__ void threefry_body(uint32_t s, int trips,
                                              uint32_t* sink,
                                              long long* clk) {
  const long long t0 = clock64();
  uint32_t acc = 0;
#pragma unroll 1
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int i = 0; i < CALLS; ++i) {
      uint32_t b0, b1;
      rbd::basis_bits(s, static_cast<uint32_t>(i), threadIdx.x + t, b0, b1);
      acc ^= b0 ^ b1;
    }
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  stamp(t0, clk);
}
extern "C" __global__ void p_threefry4(uint32_t s, int trips, uint32_t* sink,
                                       long long* clk) {
  threefry_body<4>(s, trips, sink, clk);
}
extern "C" __global__ void p_threefry8(uint32_t s, int trips, uint32_t* sink,
                                       long long* clk) {
  threefry_body<8>(s, trips, sink, clk);
}

template <int VALUES, bool FMA_U>
__device__ __forceinline__ void normal_body(uint32_t s, int trips,
                                            uint32_t* sink, long long* clk) {
  const long long t0 = clock64();
  uint32_t x = s ^ (threadIdx.x * 0x9E3779B9u);
  float acc = 0.0f;
#pragma unroll 1
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int i = 0; i < VALUES; ++i) {
      const uint32_t b0 = x * 1664525u + 1013904223u;
      x = b0 * 1664525u + 1013904223u;
      acc += rbd::bits_to_sample<rbd::kNormal, FMA_U>(b0, x);
    }
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = __float_as_uint(acc);
  stamp(t0, clk);
}
extern "C" __global__ void p_normal8(uint32_t s, int trips, uint32_t* sink,
                                     long long* clk) {
  normal_body<8, true>(s, trips, sink, clk);
}
extern "C" __global__ void p_normal16(uint32_t s, int trips, uint32_t* sink,
                                      long long* clk) {
  normal_body<16, true>(s, trips, sink, clk);
}
extern "C" __global__ void p_normal8t(uint32_t s, int trips, uint32_t* sink,
                                      long long* clk) {
  normal_body<8, false>(s, trips, sink, clk);
}
extern "C" __global__ void p_normal16t(uint32_t s, int trips, uint32_t* sink,
                                       long long* clk) {
  normal_body<16, false>(s, trips, sink, clk);
}

extern "C" __global__ void p_philox_normal(uint32_t s, int trips,
                                           uint32_t* sink, long long* clk) {
  const long long t0 = clock64();
  const uint32_t* rk = probe_round_keys(s);
  float acc = 0.0f;
#pragma unroll 1
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t w[4][4];
      rbd::philox_start(threadIdx.x + 256u * n + t, w);
      rbd::philox_rounds<0, rbd::kPhiloxRounds>(rk, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc += rbd::bits_to_sample<rbd::kNormal, true>(w[j][0], w[j][1]);
        acc += rbd::bits_to_sample<rbd::kNormal, true>(w[j][2], w[j][3]);
      }
    }
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = __float_as_uint(acc);
  stamp(t0, clk);
}

typedef void (*Probe)(uint32_t, int, uint32_t*, long long*);
extern "C" int run_probe(const char* name, uint32_t s, int trips, int blocks,
                         uint32_t* sink, long long* clk, void* stream) {
  static const struct { const char* name; Probe fn; } probes[] = {
      {"p_imad_wide", p_imad_wide}, {"p_imad", p_imad},
      {"p_lop3", p_lop3}, {"p_ffma", p_ffma}, {"p_i2f", p_i2f},
      {"p_mufu", p_mufu}, {"p_f2i", p_f2i}, {"p_lop3_i2f", p_lop3_i2f},
      {"p_ffma_imad", p_ffma_imad}, {"p_philox8", p_philox8},
      {"p_philox16", p_philox16}, {"p_threefry4", p_threefry4},
      {"p_threefry8", p_threefry8}, {"p_normal8", p_normal8},
      {"p_normal16", p_normal16}, {"p_normal8t", p_normal8t},
      {"p_normal16t", p_normal16t}, {"p_philox_normal", p_philox_normal}};
  for (const auto& p : probes) {
    if (strcmp(p.name, name) != 0) continue;
    p.fn<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(s, trips,
                                                               sink, clk);
    return static_cast<int>(cudaGetLastError());
  }
  return -1;
}
"""
# the single-class probes: (kernel, its opcode class, chains x unroll a trip)
# (kernel, rate key, the opcodes counted): 8 chains of one instruction,
# or two classes interleaved (a rate near one class's alone means they
# share a pipe; near the sum, that they do not)
CHAIN_PROBES = (("p_imad_wide", "imad_wide", ("IMAD.WIDE",)),
                ("p_imad", "imad", ("IMAD",)),
                ("p_lop3", "alu", ("LOP3",)),
                ("p_ffma", "fp32", ("FFMA",)),
                ("p_i2f", "cvt", ("I2FP", "I2F")),
                ("p_mufu", "xu", ("MUFU",)),
                ("p_f2i", "f2i", ("F2I",)),
                ("p_lop3_i2f", "alu+cvt", ("LOP3", "I2FP", "I2F")),
                ("p_ffma_imad", "fp32+imad", ("FFMA", "IMAD")))
# the generator probes: (label, kernel of the smaller body, of the larger,
# values the larger adds, instructions a value of the fold/bits/sum)
DIFF_PROBES = (("philox", "p_philox8", "p_philox16", 8, {"alu": 1.0}),
               ("threefry", "p_threefry4", "p_threefry8", 4, {"alu": 1.0}),
               ("normal_hw", "p_normal8", "p_normal16", 8,
                {"imad": 2.0, "fp32": 1.0}),
               ("normal", "p_normal8t", "p_normal16t", 8,
                {"imad": 2.0, "fp32": 1.0}))
# Opcode classes of the bound (PIPE_LANES_PER_SM): "alu" runs only on the
# integer ALU, "iadd" (adds and moves) on the ALU or the heavy pipe,
# "imad" (a multiply) only on the heavy pipe, "imad_wide" on it twice,
# "fp32" on either FP32 pipe, "xu" on the XU.  VIADD (an add ptxas folds
# in any chain of its own) and the rest count for issue only.
PIPE_OF = {"IMAD": "imad", "FFMA": "fp32", "FMUL": "fp32", "FADD": "fp32",
           "I2F": "xu", "F2F": "xu", "FRND": "xu", "MUFU": "xu",
           "F2I": "xu",
           "LOP3": "alu", "SHF": "alu", "ISETP": "alu", "FSETP": "alu",
           "SEL": "alu", "FSEL": "alu", "PRMT": "alu", "IMNMX": "alu",
           "FMNMX": "alu", "IABS": "alu", "PLOP3": "alu", "R2P": "alu",
           "P2R": "alu", "FCHK": "alu", "LOP": "alu", "SHL": "alu",
           "SHR": "alu", "I2FP": "alu",
           "IADD3": "iadd", "IADD": "iadd", "LEA": "iadd", "MOV": "iadd"}
# IMAD forms that only add, move or shift: "iadd"
IMAD_ADDS = ("MOV", "IADD", "SHL", "X")
# the kernels' hot loops whose SASS phase 1 counts (DBUF off, normal):
# label -> (mangled-name fragment, source file)
HOT_LOOPS = {
    "project_kernel<normal, hw>": ("project_kernelILi0ELi2ELb0E",
                                   "rbd_step.cu"),
    "project_kernel<normal, threefry>": ("project_kernelILi0ELi0ELb0E",
                                         "rbd_step.cu"),
    "reconstruct_apply_kernel<normal, hw>": (
        "reconstruct_apply_kernelILi0ELi2ELb0E", "rbd_step.cu"),
    "reconstruct_apply_kernel<normal, threefry>": (
        "reconstruct_apply_kernelILi0ELi0ELb0E", "rbd_step.cu"),
}
PROBE_BLOCKS_PER_SM = 8
PIPES = {}       # filled by phase 1: measured rates and SASS counts


def _sass_functions(sass: str) -> dict:
    """{function name: its SASS text} of ``cuobjdump -sass`` output."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = body
    return out


def _sass_ops(body: str):
    """The instructions of one function: [(opcode with modifiers, branch
    target label or address or None, predicated)], and {label or address:
    index}."""
    import re

    ops, at = [], {}
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            at[m.group(1)] = len(ops)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        at[int(m.group(1), 16)] = len(ops)
        words = m.group(2).split()
        pred = words[0].startswith("@")
        if pred:
            words = words[1:]
        t = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))",
                      m.group(2))
        target = (t.group(1) or int(t.group(2), 16)) if t else None
        ops.append((words[0], target, pred))
    return ops, at


def _must_path(ops, at, lo: int, hi: int) -> list[str]:
    """Opcodes of the loop ops[lo .. hi] (hi its branch back to lo) that
    every trip runs: the basic blocks on every path from the head to the
    back branch.  A branch's other side (a slow path of logf / cosf /
    sqrtf, an early exit) is left out when a path runs around it, so this
    is the trip's fast path, a floor on what it issues."""
    ops_in = ops[lo:hi + 1]
    idx = {k: v - lo for k, v in at.items() if lo <= v <= hi}
    leaders = {0}
    for i, (op, target, _) in enumerate(ops_in):
        if target is not None:
            if target in idx:
                leaders.add(idx[target])
            leaders.add(i + 1)
        elif op in ("EXIT", "RET", "BRX", "JMX"):
            leaders.add(i + 1)
    starts = sorted(x for x in leaders if x < len(ops_in))
    block_of = {}
    for b, s0 in enumerate(starts):
        e0 = starts[b + 1] if b + 1 < len(starts) else len(ops_in)
        for i in range(s0, e0):
            block_of[i] = b
    ends = [(starts[b + 1] if b + 1 < len(starts) else len(ops_in)) - 1
            for b in range(len(starts))]
    succ = []
    for b, e0 in enumerate(ends):
        op, target, pred = ops_in[e0]
        out = set()
        if target is not None and target in idx and idx[target] > 0:
            out.add(block_of[idx[target]])
        falls = not ((target is not None or op in ("EXIT", "RET", "BRX",
                                                   "JMX")) and not pred)
        if falls and e0 + 1 < len(ops_in):
            out.add(block_of[e0 + 1])
        succ.append(out)
    latch = block_of[len(ops_in) - 1]

    def reaches(skip):
        seen, todo = {0}, [0]
        while todo:
            b = todo.pop()
            if b == latch:
                return True
            for n in succ[b]:
                if n != skip and n not in seen:
                    seen.add(n)
                    todo.append(n)
        return False

    must = [b for b in range(len(starts))
            if b in (0, latch) or not reaches(b)]
    return [ops_in[i][0] for b in must for i in range(starts[b], ends[b] + 1)]


def _sass_loops(body: str) -> list[tuple[list[str], list[str]]]:
    """Every loop (a branch back to an earlier instruction) of one
    function: (all its opcodes, its must-path opcodes)."""
    ops, at = _sass_ops(body)
    loops = []
    for i, (_, target, _) in enumerate(ops):
        if target is not None and target in at and at[target] <= i:
            lo = at[target]
            loops.append(([op for op, _, _ in ops[lo:i + 1]],
                          _must_path(ops, at, lo, i)))
    return loops


def _sass_loop(sass: str, function: str) -> list[str]:
    """Must-path opcodes of the longest loop of one function."""
    loops = _sass_loops(_sass_functions(sass)[function])
    check(bool(loops), f"no loop found in the SASS of {function}")
    return max(loops, key=lambda lp: len(lp[0]))[1]


def _pipe_class(op: str) -> str:
    """The bound's class of one opcode with its modifiers (PIPE_OF)."""
    base, *mods = op.split(".")
    if base == "IMAD" and "WIDE" in mods:
        return "imad_wide"
    if base == "IMAD" and any(m in IMAD_ADDS for m in mods):
        return "iadd"
    return PIPE_OF.get(base, "other")


def _pipe_counts(opcodes) -> dict:
    """{pipe class: count} of a list of opcodes (_pipe_class), the rest
    under "other" ("all" counts every instruction)."""
    counts = {"all": len(opcodes)}
    for op in opcodes:
        cls = _pipe_class(op)
        counts[cls] = counts.get(cls, 0) + 1
    return counts


def _hot_loop(body: str) -> tuple[list[str], list[str], int]:
    """The hot loop of a kernel on the normal distribution: the smallest
    loop whose must path holds the most MUFU.RSQ (one per value: sqrtf);
    returns its opcodes, its must-path opcodes and its values a trip (those
    MUFU.RSQ)."""
    loops = _sass_loops(body)
    check(bool(loops), "no loop in a kernel's SASS")
    rsq = [sum(op.startswith("MUFU.RSQ") for op in must) for _, must in loops]
    values = max(rsq)
    check(values > 0, "no MUFU.RSQ on the must path of a kernel's loops")
    loop, must = min((lp for lp, n in zip(loops, rsq) if n == values),
                     key=lambda lp: len(lp[0]))
    return loop, must, values


def _cuobjdump(path, functions=()) -> str:
    """``cuobjdump -sass`` of a built library, only ``functions`` (mangled
    names) if given."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    args = [a for f in functions for a in ("-fun", f)]
    return subprocess.run([tool, "-sass", *args, str(path)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout


def start_probe_build():
    """Write PIPE_PROBE and start its nvcc (the kernels' flags); returns
    (process, library path)."""
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "pipe_probe.cu"
    src.write_text(PIPE_PROBE)
    lib = src.with_suffix(".so")
    proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                             str(build.CSRC), "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def pipe_probes(proc, lib_path, sms: int) -> dict:
    """Finish the probe build; read each probe's loop body from its SASS,
    time each probe on the whole card (CUDA events, clock64 spans), and
    return {"rates": {class: lanes per SM per clock}, "per_value":
    {generator: {class: instructions a value}}, "clock_mhz": the SM clock
    the probes ran at, "lines": what to log}.  The rates are a diagnostic:
    the bounds take the peaks of PIPE_LANES_PER_SM."""
    import collections
    import ctypes

    import torch

    log_text, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"probe nvcc failed:\n{log_text}")
    sass = _cuobjdump(lib_path)
    lib_path.with_suffix(".sass").write_text(sass)
    funcs = _sass_functions(sass)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.run_probe
    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    blocks = sms * PROBE_BLOCKS_PER_SM
    sink = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    clk = torch.zeros(blocks * 3, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def timed(name, trips):
        """(ms, SM-cycles summed over SMs) of one launch, after a warm-up."""
        for _ in range(2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = fn(name.encode(), 12345, trips, blocks, sink.data_ptr(),
                    clk.data_ptr(), stream)
            b.record()
            torch.cuda.synchronize()
            check(rc == 0, f"probe {name} launch failed ({rc})")
        c = clk.view(-1, 3).cpu()
        spans = {}
        for t0, t1, sm in c.tolist():
            lo, hi = spans.get(sm, (t0, t1))
            spans[sm] = (min(lo, t0), max(hi, t1))
        cycles = sum(hi - lo for lo, hi in spans.values())
        return a.elapsed_time(b), cycles, len(spans)

    lines, rates, clocks = [], {}, []
    bodies = {}
    for name in funcs:
        if name.startswith("p_"):
            bodies[name] = _sass_loop(sass, name)
    # chain probes: 4 x 8 chained instructions a trip
    for name, key, opcodes in CHAIN_PROBES:
        body = bodies[name]
        n = sum(op.startswith(opcodes) for op in body)
        trips = 4096
        ms, cycles, n_sm = timed(name, trips)
        lanes = blocks * 256 * trips
        rates[key] = n * lanes / cycles
        clocks.append(cycles / n_sm / (ms * 1e-3) / 1e6)
        lines.append(
            f"  probe {name}: body "
            f"{dict(collections.Counter(body).most_common())}; {ms:.3f} "
            f"ms, {cycles / n_sm:,.0f} cycles an SM -> {key} "
            f"{rates[key]:.2f} lanes/SM/clock, all instructions "
            f"{len(body) * lanes / cycles:.2f}")
    # I2FP shares the ALU when, interleaved with LOP3, the two together
    # run at no more than 1.25 x the faster alone
    shares = rates["alu+cvt"] <= 1.25 * max(rates["alu"], rates["cvt"])
    lines.append(f"  I2FP shares the ALU pipe with LOP3: {shares}")
    per_value = {}
    for label, small, large, values, extra in DIFF_PROBES:
        c_small = _pipe_counts(bodies[small])
        c_large = _pipe_counts(bodies[large])
        counts = {k: (c_large.get(k, 0) - c_small.get(k, 0)) / values
                  for k in set(c_small) | set(c_large)}
        for k, v in extra.items():   # the fold, the bits, the sum
            counts[k] = counts.get(k, 0.0) - v
            counts["all"] -= v
        per_value[label] = {k: v for k, v in counts.items() if v}
        check(per_value[label]["all"] > 0,
              f"{label} SASS count {per_value[label]}")
        ms, cycles, n_sm = timed(large, 256)
        vals = blocks * 256 * 256 * 2 * values
        lines.append(
            f"  probe {large}/{small}: bodies {len(bodies[large])} / "
            f"{len(bodies[small])} -> {label} a value "
            f"{ {k: round(v, 3) for k, v in sorted(per_value[label].items())} }"
            f"; {large} {ms:.3f} ms, {vals * 1.0 / cycles:.3f} values/SM/"
            f"clock, issue {len(bodies[large]) * blocks * 256 * 256 / cycles:.1f}"
            f" lanes/SM/clock")
    body = bodies["p_philox_normal"]
    ms, cycles, n_sm = timed("p_philox_normal", 256)
    vals = blocks * 256 * 256 * 16
    lines.append(f"  probe p_philox_normal (Philox feeding the hw transform,"
                 f" 16 values a trip): body {_pipe_counts(body)}; "
                 f"{ms:.3f} ms, {vals / cycles:.3f} values/SM/clock, "
                 f"issue {len(body) * blocks * 256 * 256 / cycles:.1f} "
                 f"lanes/SM/clock")
    clock = sorted(clocks)[len(clocks) // 2]
    lines.append(f"  SM clock under the probes (cycles / event time): "
                 f"{clock:.0f} MHz")
    return {"rates": rates, "per_value": per_value,
            "clock_mhz": clock, "lines": lines}


def hot_loop_counts(libs) -> list[str]:
    """The must paths of HOT_LOOPS in the built libraries' SASS, as lines
    to log: instructions a value by class, LDL / STL counted."""
    import re

    sass = {}
    lines = []
    for label, (frag, source) in HOT_LOOPS.items():
        if source not in sass:
            # the entries HOT_LOOPS names, from ptxas's report of the build
            # (the whole library's SASS if the build was reused)
            entries = re.findall(r"Compiling entry function '(\S+)'",
                                 libs[source].log)
            want = [e for e in entries
                    if any(f in e for f, src in HOT_LOOPS.values()
                           if src == source)]
            text = _cuobjdump(libs[source].path, want)
            sass[source] = _sass_functions(text)
            libs[source].path.with_suffix(".sass").write_text(text)
        names = [n for n in sass[source] if frag in n]
        if not names:   # -fun took none of them: the whole library
            sass[source] = _sass_functions(_cuobjdump(libs[source].path))
            names = [n for n in sass[source] if frag in n]
        check(len(names) == 1, f"{label}: functions {names}")
        loop, must, values = _hot_loop(sass[source][names[0]])
        counts = _pipe_counts(must)
        local = sum(op.startswith(("LDL", "STL")) for op in loop)
        local_must = sum(op.startswith(("LDL", "STL")) for op in must)
        lines.append(
            f"  hot loop {label}: {len(loop)} instructions, {len(must)} on "
            f"the must path for {values} values -> {len(must) / values:.2f}"
            f" a value; LDL/STL {local} in the loop, {local_must} on the "
            f"must path; by class "
            f"{ {k: round(v / values, 2) for k, v in sorted(counts.items())} }")
    return lines


def cuda_ms(fn, repeat: int = 1) -> list[float]:
    import torch

    out = []
    for _ in range(repeat):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch
    from repro_torch.kernels import rbd_step

    log("== phase 1: device")
    smi = nvidia_smi("name,power.limit")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    probe = start_probe_build()   # beside the kernels' nvcc
    libs = rbd_step.libraries()   # one nvcc per source, started together
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for built in libs.values():
        log(f"  nvcc {built.seconds:.1f} s -> {built.path.name}")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"SMs {props.multi_processor_count}, max SM clock {clock_mhz} MHz")
    PIPES.update(pipe_probes(*probe, props.multi_processor_count))
    hot_lines = hot_loop_counts(libs)
    log("pipe probes (PIPE_PROBE; measured rates in lanes per SM per "
        "clock, a diagnostic: the bounds take the peaks "
        f"{PIPE_LANES_PER_SM}, issue {ISSUE_LANES_PER_SM}):")
    for line in PIPES["lines"] + hot_lines:
        log(line)
    return {"smi": smi, "sms": props.multi_processor_count,
            "clock_hz": clock_mhz * 1e6}


def phase_generator():
    import torch
    from repro_torch.core import rng
    from repro_torch.kernels import rbd_step

    log("== phase 2: generator (generate_tile kernel vs plain)")
    seed = int(rng.to_uint32(rng.fold_seed(5)))
    for dist in ("normal", "uniform", "bernoulli", "rademacher", "sparse"):
        for row0, col0 in ((16, 1024), (2**32 - 4, 2**32 - 300), (0, 0)):
            kb0, kb1, ks = rbd_step.generate_tile(
                seed, row0, col0, (8, 512), dist, device="cuda")
            for where in ("cuda", "cpu"):
                r, c = rng.tile_counters(row0, col0, (8, 512), where)
                pb0, pb1 = rng._bits_for_counters(seed, c, r)
                ps = rng.bits_to_sample(dist, pb0, pb1)
                check(torch.equal(kb0.cpu(), pb0.cpu())
                      and torch.equal(kb1.cpu(), pb1.cpu()),
                      f"{dist} bits differ from plain ({where})")
                diff = (ks.cpu() - ps.cpu()).abs()
                n_diff = int((diff != 0).sum())
                if dist == "normal":
                    check(float(diff.max()) <= NORMAL_SAMPLE_ATOL,
                          f"normal samples off by {float(diff.max())}")
                else:
                    check(n_diff == 0, f"{dist} samples differ ({where})")
                log(f"  {dist:10s} tile ({row0},{col0}) vs plain on {where}:"
                    f" bits exact, samples max|d|={float(diff.max()):.3g}"
                    f" ({n_diff} of 4096 differ)")
    # the hw paths' normal transform (the library's fast paths without
    # the code their inputs never reach) against logf / sqrtf / cosf on
    # all 2**24 inputs each can get: bit for bit
    mism = rbd_step.hw_transform_mismatches()
    check(mism["radius"] == 0 and mism["cosine"] == 0,
          f"hw transform differs from the library's: {mism}")
    log(f"  hw normal transform vs logf/sqrtf and cosf on all 2^24 inputs:"
        f" {mism['radius']} + {mism['cosine']} differ")
    # the tile-keyed impls: the whole (8, 512) shape is one tile keyed by
    # (seed, row0, col0); b0/b1 are its two streams
    for impl in TILE_KEYED:
        for dist in ("normal", "uniform", "bernoulli", "rademacher",
                     "sparse"):
            for row0, col0 in ((16, 1024), (2**32 - 4, 2**32 - 300),
                               (0, 0)):
                kb0, kb1, ks = rbd_step.generate_tile(
                    seed, row0, col0, (8, 512), dist, device="cuda",
                    prng=impl)
                for where in ("cuda", "cpu"):
                    r, c = rng.tile_counters(0, 0, (8, 512), where)
                    key = rng.hw_tile_key(seed, row0, col0).to(where)
                    pb0, pb1 = rng.tile_keyed_bits(impl, key, r, c, 512)
                    ps = rng.bits_to_sample(dist, pb0, pb1)
                    check(torch.equal(kb0.cpu(), pb0.cpu())
                          and torch.equal(kb1.cpu(), pb1.cpu()),
                          f"{impl}/{dist} bits differ from plain ({where})")
                    diff = (ks.cpu() - ps.cpu()).abs()
                    tol = NORMAL_SAMPLE_ATOL if dist == "normal" else 0.0
                    check(float(diff.max()) <= tol,
                          f"{impl}/{dist} samples off by {float(diff.max())}"
                          f" ({where})")
                log(f"  {impl:11s} {dist:10s} tile ({row0},{col0}): bits "
                    f"exact on cuda and cpu, samples max|d|="
                    f"{float(diff.max()):.3g}")
    # the plain generator's card form (five passes a Threefry round,
    # in-place sample mapping, column chunks replayed as CUDA graphs)
    # against its stepwise form: every impl and distribution, blocks of
    # several chunks and a ragged one, bit for bit
    shape = (1024, 3 * 2048 + 1536)
    for impl in rng.PRNG_IMPLS:
        for dist in ("normal", "uniform", "bernoulli", "rademacher",
                     "sparse"):
            for col0 in (0, 2**31 - 4096):
                got = rng.generate_tiled_block(impl, seed, col0, shape, dist,
                                               device="cuda")
                with rng.stepwise_form():
                    want = rng.generate_tiled_block(impl, seed, col0, shape,
                                                    dist, device="cuda")
                check(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                      f"plain generator {impl}/{dist} at column {col0}: the "
                      "card form differs from the stepwise form")
        log(f"  plain generator {impl}: card form (chunks of "
            f"{rng.GEN_CHUNK[impl]} values) bit for bit the stepwise form "
            f"on {shape} blocks, every distribution")


def _sub_plans(full_plan):
    """One layer's segments plus final_norm, and one dir-block of embed,
    both at full width, as plans of unstacked leaves."""
    from repro_torch.core.compartments import Plan

    by_name = {lp.name: lp for lp in full_plan.leaves}
    layer = [dataclasses.replace(lp, shape=lp.shape[1:], stacked=False,
                                 n_stack=1)
             for lp in full_plan.leaves if lp.stacked]
    layer.append(by_name["final_norm"])
    emb = dataclasses.replace(by_name["embed"], dim=8)

    def plan(leaves):
        return Plan(leaves=tuple(leaves),
                    total_dim=sum(lp.dim for lp in leaves),
                    total_params=sum(lp.size for lp in leaves),
                    distribution=full_plan.distribution,
                    normalization=full_plan.normalization)

    return {"layer0+final_norm": plan(layer), "embed[dir-block 0]":
            plan([emb])}


def _valid_mask(layout, device):
    import torch

    mask = torch.zeros((layout.q_packed,), dtype=torch.bool, device=device)
    for off, size in zip(layout.seg_param_off, layout.seg_size):
        mask[int(off): int(off) + int(size)] = True
    return mask


def _check_project(case, u, sq, up, sqp, g, lay) -> float:
    """Kernel (u, sq) against the plain version's; returns max|du|."""
    import torch

    gnorm = torch.zeros_like(u)
    for s in range(lay.n_segments):
        o, p = int(lay.seg_param_off[s]), int(lay.seg_size[s])
        c, n = int(lay.seg_coord_off[s]), int(lay.seg_pdim[s])
        gnorm[c: c + n] = g[o: o + p].norm() / math.sqrt(p)
    du = (u - up).abs()
    rel_u = float((du / (gnorm * torch.sqrt(sqp)).clamp(min=1e-30)).max())
    rel_sq = float(((sq - sqp).abs() / sqp.clamp(min=1e-30)).max())
    log(f"    {case} project: max|du|={float(du.max()):.3g} rel={rel_u:.3g} "
        f"(tol {U_RTOL}), max rel dsq={rel_sq:.3g} (tol {SQ_RTOL})")
    check(rel_u <= U_RTOL and rel_sq <= SQ_RTOL,
          f"{case}: projection outside tolerance")
    return float(du.max())


def _check_apply(case, out, ref, theta) -> float:
    """Kernel theta' against the plain version's, 2 ulp of theta's own
    dtype (float32 or bfloat16); returns max|dtheta|."""
    ulp = 2.0**-23 if theta.element_size() == 4 else 2.0**-7
    out, ref, theta = out.float(), ref.float(), theta.float()
    dt = float((out - ref).abs().max())
    upd = float((ref - theta).abs().max())
    tol = THETA_RTOL * upd + 2 * ulp * float(theta.abs().max())
    log(f"    {case} apply: max|dtheta|={dt:.3g} (tol {tol:.3g}, "
        f"max|update|={upd:.3g})")
    check(dt <= tol, f"{case}: apply outside tolerance")
    return dt


def phase_kernels(full_plan):
    import torch
    from repro_torch.core import projector, rng
    from repro_torch.kernels import rbd_step

    log("== phase 3: kernels vs plain at full qwen2-0.5b width")
    errs = {"project_packed": 0.0, "reconstruct_apply_packed": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, sub in _sub_plans(full_plan).items():
        lay = sub.packed()
        valid = _valid_mask(lay, "cuda")
        log(f"  case {name}: {lay.n_segments} segments, "
            f"{int(lay.seg_size.sum()):,} parameters, d_packed "
            f"{lay.d_packed}, q_packed {lay.q_packed:,}")
        for dist in (DISTS if name.startswith("layer") else ("normal",)):
            seeds = projector.segment_seeds(sub, rng.fold_seed(0, 0))
            g = torch.randn(lay.q_packed, generator=gen, device="cuda")
            g = torch.where(valid, g, 0.0)
            u, sq = rbd_step.project_packed(seeds, g, lay, dist)
            u2, sq2 = rbd_step.project_packed(seeds, g, lay, dist)
            check(torch.equal(u, u2) and torch.equal(sq, sq2),
                  f"{name}/{dist}: projection reruns differ")
            log(f"    {name}/{dist}: projection reruns bit-identical")
            up, sqp = rbd_step.project_packed_plain(seeds, g, lay, dist)
            du = _check_project(f"{name}/{dist}", u, sq, up, sqp, g, lay)
            errs["project_packed"] = max(errs["project_packed"], du)

            theta = torch.where(valid, torch.randn(
                lay.q_packed, generator=gen, device="cuda"), 0.0)
            scale = torch.randn(lay.d_packed, generator=gen, device="cuda")
            scale = scale * 1e-3 * torch.from_numpy(lay.coord_valid).cuda()
            out = rbd_step.reconstruct_apply_packed(seeds, scale, theta, lay,
                                                    dist)
            out2 = rbd_step.reconstruct_apply_packed(seeds, scale, theta,
                                                     lay, dist)
            inplace = theta.clone()
            rbd_step.reconstruct_apply_packed(seeds, scale, inplace, lay,
                                              dist, out=inplace)
            check(torch.equal(out, out2) and torch.equal(out, inplace),
                  f"{name}/{dist}: apply reruns / in-place differ")
            check(bool((out[~valid] == 0).all()),
                  f"{name}/{dist}: padding of theta is not exactly 0")
            log(f"    {name}/{dist}: apply reruns and in-place bit-identical,"
                " padding exactly 0")
            ref = rbd_step.reconstruct_apply_packed_plain(seeds, scale,
                                                          theta, lay, dist)
            dt = _check_apply(f"{name}/{dist}", out, ref, theta)
            errs["reconstruct_apply_packed"] = max(
                errs["reconstruct_apply_packed"], dt)
    return errs


def phase_training():
    import torch
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import train as launcher

    log("== phase 4: training qwen2-0.5b at full width and depth")
    log("  python -m repro_torch.launch.train " + " ".join(ARCH_ARGS))
    rbd_step.reset_counts()
    res = launcher.main(ARCH_ARGS)
    launches = dict(rbd_step.LAUNCHES)
    log(f"  launches: {launches}")
    check(res.sub_opt.plan_execution().strategy == "fused_packed",
          "update path is not fused_packed")
    check(all(math.isfinite(x) for x in res.losses), f"losses {res.losses}")
    theta_sum = float(res.state.params.double().sum())
    check(theta_sum != res.theta_init_sum, "theta did not change")
    check(launches["project_packed"] == STEPS
          and launches["reconstruct_apply_packed"] == STEPS
          and launches["reconstruct_apply_packed_workers"] == 0
          and launches["generate_tile"] == 0,
          f"expected 2 port-kernel launches per step, got {launches}")
    check(res.collectives["all_reduce"] == STEPS
          and res.collectives["all_gather"] == 0,
          f"expected one all-reduce per step, got {res.collectives}")
    log(f"  collectives {res.collectives}")
    log(f"  peak memory {res.peak_bytes / 2**30:.2f} GiB, theta sum "
        f"{res.theta_init_sum:.6g} -> {theta_sum:.6g}")
    return res, launches


def phase_loss():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.data import synthetic
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    log("== phase 5: loss goes down (reduced tinyllama, 30 steps)")
    cfg = get_config("tinyllama-1.1b").reduced(compute_dtype="float32")
    model = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=512,
                                                backend="cuda"),
                       learning_rate=0.5, steps=30)
    init_state, train_step = steplib.make_train_step(model, tcfg,
                                                     device="cuda")
    state = init_state(0)
    data = synthetic.lm_batches(0, 8, 64, cfg.vocab, device="cuda")
    losses = []
    for _ in range(30):
        state, m = train_step(state, next(data))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    log(f"  losses[::10] {[round(x, 4) for x in losses[::10]]} last "
        f"{losses[-1]:.4f}")
    check(losses[-1] < losses[0] - 0.1, f"loss did not drop: {losses}")


def phase_timing(full_plan, res, launches, errs, dev):
    import torch
    from repro_torch.core import projector, rng
    from repro_torch.kernels import rbd_step

    log("== phase 6: plain versions at the main path's shapes, bounds")
    lay = full_plan.packed()
    seeds = projector.segment_seeds(full_plan, rng.fold_seed(0, 0))
    theta = res.state.params
    gen = torch.Generator(device="cuda").manual_seed(2)
    g = torch.where(_valid_mask(lay, "cuda"),
                    torch.randn(lay.q_packed, generator=gen, device="cuda"),
                    0.0)
    scale = torch.randn(lay.d_packed, generator=gen, device="cuda") * 1e-4
    scale = scale * torch.from_numpy(lay.coord_valid).cuda()
    dist = full_plan.distribution
    plain = {}
    plain_ms = {
        "project_packed": cuda_ms(lambda: plain.update(
            proj=rbd_step.project_packed_plain(seeds, g, lay, dist)))[0],
        "reconstruct_apply_packed": cuda_ms(lambda: plain.update(
            apply=rbd_step.reconstruct_apply_packed_plain(
                seeds, scale, theta, lay, dist)))[0],
    }
    u, sq = rbd_step.project_packed(seeds, g, lay, dist)
    errs["project_packed"] = max(errs["project_packed"], _check_project(
        "full width", u, sq, *plain["proj"], g, lay))
    out = rbd_step.reconstruct_apply_packed(seeds, scale, theta, lay, dist)
    errs["reconstruct_apply_packed"] = max(
        errs["reconstruct_apply_packed"],
        _check_apply("full width", out, plain["apply"], theta))
    del plain, out
    rows = []
    for name in ("project_packed", "reconstruct_apply_packed"):
        times = sorted(res.kernel_ms[name])
        rows.append(kernel_row(name, lay, dist, dev, 1, launches[name],
                               errs[name], times[len(times) // 2],
                               plain_ms[name]))
    return rows


# the TPU kernel each row replaces: the kernel body its wrapper's
# pl.pallas_call runs (project_packed:241 -> pallas_call:286 ->
# _project_kernel:100; reconstruct_apply_packed:314 -> pallas_call:361 ->
# _recon_apply_kernel:144), and for the K-worker apply, whose body is
# row 2's, its own pallas_call (reconstruct_apply_packed_workers:387)
REPLACES = {
    "project_packed": "src/repro/kernels/rbd_step.py:100",
    "reconstruct_apply_packed": "src/repro/kernels/rbd_step.py:144",
    "reconstruct_apply_packed_workers": "src/repro/kernels/rbd_step.py:443",
    # reconstruct_apply_packed_adapters:469 -> pallas_call:526 ->
    # _adapter_recon_kernel:185
    "reconstruct_apply_packed_adapters": "src/repro/kernels/rbd_step.py:185",
    # project_flat:133 -> pallas_call:107 -> _project_kernel:41;
    # reconstruct_flat:87 -> pallas_call:110 -> _recon_kernel:33;
    # reconstruct_apply_flat:132 -> pallas_call:167 -> _recon_apply_kernel:57
    "project_flat": "src/repro/kernels/rbd_project.py:41",
    "reconstruct_flat": "src/repro/kernels/rbd_reconstruct.py:33",
    "reconstruct_apply_flat": "src/repro/kernels/rbd_reconstruct.py:57",
    # the sharded wrappers' own pallas_calls (project_packed_sharded:575,
    # reconstruct_apply_packed_sharded:645,
    # reconstruct_apply_packed_workers_sharded:715), over the bodies of
    # rows 1 and 2 on one shard's tables
    "project_packed_sharded": "src/repro/kernels/rbd_step.py:617",
    "reconstruct_apply_packed_sharded": "src/repro/kernels/rbd_step.py:689",
    "reconstruct_apply_packed_workers_sharded":
        "src/repro/kernels/rbd_step.py:762",
    # flash_attention:87 -> pallas_call:108 -> _flash_kernel:34
    "flash_attention": "src/repro/kernels/flash_attention.py:34",
}
FLAT_KERNELS = ("project_flat", "reconstruct_flat", "reconstruct_apply_flat")


TILE_VALUES = 8 * 512   # values of one (8, 512) tile


def value_counts(name, prng, dist) -> dict:
    """{pipe class: instructions} of one basis value of kernel ``name``,
    from this run's probe SASS (phase 1): the generator (Threefry-2x32-20;
    one Threefry per bit stream plus the within-tile index for
    hw_emulated; half a Philox4x32-10 call for hw), the sample transform
    (normal: the hw form -- the library's fast paths and one-FFMA
    uniforms, the same bits -- the least; the other distributions
    from the source, FP_OPS_PER_VALUE), the contraction's FMAs; for the
    tile-keyed impls, the tile key (one Threefry) and its 18 round-key
    adds once per (8, 512) tile.  Classes as _pipe_class."""
    pv = PIPES["per_value"]
    out = {}

    def add(counts, times=1.0):
        for k, v in counts.items():
            out[k] = out.get(k, 0.0) + times * v

    if prng == "hw":
        add(pv["philox"])
    elif prng == "hw_emulated":
        streams = 2 if dist in ("normal", "sparse") else 1
        add(pv["threefry"], streams)
        add({"all": 1, "iadd": 1}, streams)
    else:
        add(pv["threefry"])
    if prng != "threefry":
        add(pv["threefry"], 1.0 / TILE_VALUES)
        add({"all": 18, "iadd": 18}, 1.0 / TILE_VALUES)
    if dist == "normal":
        add(pv["normal_hw"])
    else:
        add({"all": FP_OPS_PER_VALUE[dist], "fp32": FP_OPS_PER_VALUE[dist]})
    add({"all": FMA_PER_VALUE[name], "fp32": FMA_PER_VALUE[name]})
    return out


def pipe_seconds(values, counts, dev) -> dict:
    """Seconds that ``values`` basis values of ``counts`` (value_counts)
    need on the whole card at the peaks of PIPE_LANES_PER_SM, one term per
    limit: total issue; the XU; the classes that run on one pipe only (the
    ALU's, IMAD's on the heavy pipe); the FP32 pipes, which FFMA shares
    with IMAD; the integer work (ALU, adds, IMAD) on the ALU and the
    heavy pipe; all of it on the three.  The largest term is the least
    time the counts can be spread over the pipes each class may use."""
    lanes = PIPE_LANES_PER_SM
    alu, iadd = counts.get("alu", 0), counts.get("iadd", 0)
    imad = counts.get("imad", 0) + 2 * counts.get("imad_wide", 0)
    fp32 = counts.get("fp32", 0)
    per_clock = {
        "issue": counts["all"] / ISSUE_LANES_PER_SM,
        "xu": counts.get("xu", 0) / lanes["xu"],
        "alu": alu / lanes["alu"],
        "imad": imad / lanes["heavy"],
        "fp32": (fp32 + imad) / (lanes["heavy"] + lanes["lite"]),
        "int": (alu + iadd + imad) / (lanes["alu"] + lanes["heavy"]),
        "alu+fp32": (alu + iadd + imad + fp32) / (
            lanes["alu"] + lanes["heavy"] + lanes["lite"]),
    }
    return {k: values * v / (dev["sms"] * dev["clock_hz"])
            for k, v in per_clock.items()}


def ops_bound(values, nbytes, counts, dev) -> tuple[float, str, str]:
    """(ms, "operations" or "bytes", what sets it): the larger of the
    bytes over HBM_BYTES_PER_S and the largest term of pipe_seconds."""
    t = pipe_seconds(values, counts, dev)
    pipe = max(t, key=t.get)
    t_bytes = nbytes / HBM_BYTES_PER_S
    note = (f"set by {pipe}; "
            + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in t.items())
            + f"; {counts['all']:.2f} instructions a value "
            + str({k: round(v, 3) for k, v in sorted(counts.items())}))
    if t_bytes > t[pipe]:
        return 1e3 * t_bytes, "bytes", note
    return 1e3 * t[pipe], "operations", note


def bound_ms(name, lay, dist, dev, k_workers=1, prng="threefry"):
    """(least time in ms, "operations" or "bytes") for one launch;
    ``k_workers`` counts workers, or adapters for the adapter apply."""
    values = k_workers * int((lay.seg_dim * lay.seg_size).sum())
    if name == "project_packed":
        nbytes = 4 * lay.q_packed + 4 * lay.n_segments + 8 * lay.d_packed
    elif name == "reconstruct_apply_packed_adapters":
        # theta read once, B rows written, B seed rows and scale rows read
        nbytes = (4 * lay.q_packed + 4 * k_workers * lay.q_packed
                  + 4 * k_workers * lay.n_segments
                  + 4 * k_workers * lay.d_packed)
    else:
        nbytes = (8 * lay.q_packed + 4 * k_workers * lay.n_segments
                  + 4 * k_workers * lay.d_packed)
    ms, by, note = ops_bound(values, nbytes,
                             value_counts(name, prng, dist), dev)
    log(f"  bound {name}[{prng}] (K or B={k_workers}): {ms:.3f} ms -- "
        f"{note}")
    return ms, by


def flat_bound_ms(name, plan, dist, dev):
    """(least time in ms, "operations" or "bytes") for the 14 per-leaf
    launches of one step: live values over the pipes, against each
    leaf's rows read once and written once."""
    values = sum(lp.n_stack * lp.dim * lp.size for lp in plan.leaves)
    q, d = plan.total_params, plan.total_dim
    n_seeds = sum(lp.n_stack for lp in plan.leaves)
    if name == "project_flat":      # g read, u and sq written
        nbytes = 4 * q + 8 * d + 4 * n_seeds
    elif name == "reconstruct_flat":  # delta written
        nbytes = 4 * q + 4 * d + 4 * n_seeds
    else:                           # theta read and written
        nbytes = 8 * q + 4 * d + 4 * n_seeds
    ms, by, note = ops_bound(values, nbytes,
                             value_counts(name, "threefry", dist), dev)
    log(f"  bound {name} (14 leaves): {ms:.3f} ms -- {note}")
    return ms, by


def kernel_row(name, lay, dist, dev, k_workers, launches, err, ms,
               plain_ms, plan=None):
    """One row of the kernels line; ``plan`` (per-leaf kernels) bounds the
    one step's launches over the plan's leaves instead of one packed
    launch."""
    if plan is not None:
        b_ms, by = flat_bound_ms(name, plan, dist, dev)
        values = sum(lp.n_stack * lp.dim * lp.size for lp in plan.leaves)
    else:
        b_ms, by = bound_ms(name, lay, dist, dev, k_workers)
        values = k_workers * int((lay.seg_dim * lay.seg_size).sum())
    log(f"  {name} (K or B={k_workers}): {values:,} basis values; ms "
        f"{ms:.3f} (median), plain {plain_ms:.1f}, bound "
        f"{b_ms:.3f} ({by}), {b_ms / ms:.1%} of bound")
    source = "rbd_flat.cu" if name in FLAT_KERNELS else "rbd_step.cu"
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def _check_workers(case, wseeds, scale, theta, lay, dist, valid):
    """Kernel vs plain K-worker apply: reruns, in place, padding,
    tolerance.  Returns (max|dtheta|, kernel out)."""
    import torch
    from repro_torch.kernels import rbd_step

    out = rbd_step.reconstruct_apply_packed_workers(wseeds, scale, theta,
                                                    lay, dist)
    out2 = rbd_step.reconstruct_apply_packed_workers(wseeds, scale, theta,
                                                     lay, dist)
    inplace = theta.clone()
    rbd_step.reconstruct_apply_packed_workers(wseeds, scale, inplace, lay,
                                              dist, out=inplace)
    check(torch.equal(out, out2) and torch.equal(out, inplace),
          f"{case}: workers apply reruns / in-place differ")
    check(bool((out[~valid] == 0).all()),
          f"{case}: padding of theta is not exactly 0")
    log(f"    {case}: reruns and in-place bit-identical, padding exactly 0")
    ref = rbd_step.reconstruct_apply_packed_workers_plain(wseeds, scale,
                                                          theta, lay, dist)
    return _check_apply(case, out, ref, theta), out


def phase_workers(full_plan, dev):
    import torch
    from repro_torch.core import projector, rng
    from repro_torch.kernels import rbd_step

    log("== phase 7: K-worker apply kernel vs plain at full qwen2-0.5b "
        "width")
    err = 0.0
    gen = torch.Generator(device="cuda").manual_seed(3)
    step_seed = rng.fold_seed(0, 0)
    subs = _sub_plans(full_plan)
    subs["full plan"] = full_plan
    for name, sub in subs.items():
        lay = sub.packed()
        valid = _valid_mask(lay, "cuda")
        if name.startswith("layer"):
            cases = [(d, k) for d in DISTS for k in (1, 3)]
        else:
            cases = [("normal", 2)]
        for dist, k in cases:
            case = f"{name}/{dist}/K={k}"
            wseeds = projector.worker_segment_seeds(sub, step_seed, k)
            theta = torch.where(valid, torch.randn(
                lay.q_packed, generator=gen, device="cuda"), 0.0)
            scale = torch.randn((k, lay.d_packed), generator=gen,
                                device="cuda")
            scale = scale * 1e-3 * torch.from_numpy(lay.coord_valid).cuda()
            if name == "full plan":
                ms = cuda_ms(lambda: rbd_step.reconstruct_apply_packed_workers(
                    wseeds, scale, theta, lay, dist), repeat=2)
                plain = {}
                plain_ms = cuda_ms(lambda: plain.update(
                    out=rbd_step.reconstruct_apply_packed_workers_plain(
                        wseeds, scale, theta, lay, dist)))[0]
                out = rbd_step.reconstruct_apply_packed_workers(
                    wseeds, scale, theta, lay, dist)
                dt = _check_apply(case, out, plain["out"], theta)
                b_ms, by = bound_ms("reconstruct_apply_packed_workers",
                                    lay, dist, dev, k)
                log(f"    {case}: kernel ms {ms}, plain {plain_ms:.1f}, "
                    f"bound {b_ms:.3f} ({by}), {b_ms / min(ms):.1%} of "
                    "bound")
                del plain, out
            else:
                dt, out = _check_workers(case, wseeds, scale, theta, lay,
                                         dist, valid)
            err = max(err, dt)
            if k == 1:
                single = rbd_step.reconstruct_apply_packed(
                    projector.segment_seeds(sub, rng.fold_seed(step_seed, 1)),
                    scale[0].contiguous(), theta, lay, dist)
                check(torch.equal(out, single),
                      f"{case}: K=1 differs from the single-worker kernel")
                log(f"    {case}: bit-identical to reconstruct_apply_packed "
                    "on worker seed fold_seed(s, 1)")
    return err


def phase_k_workers(full_plan, dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.core import projector, rng
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim import subspace
    from repro_torch.train import step as steplib

    log(f"== phase 8: K-worker simulation, K={K_SIM}, qwen2-0.5b full width "
        "and depth")
    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    loss_fn = steplib.make_loss_fn(model, cfg.router_aux_coef)
    launches = dict.fromkeys(rbd_step.KERNELS, 0)
    times = {k: [] for k in rbd_step.KERNELS}
    for norm in ("rsqrt_dim", "exact"):
        rbd = RBDConfig(total_dim=1024, backend="cuda",
                        mode="independent_bases", normalization=norm)
        tcfg = TrainConfig(model=cfg, rbd=rbd, learning_rate=0.125)
        sub = subspace.SubspaceOptimizer.from_config(
            tcfg, transform=steplib.make_transform(model, rbd),
            k_workers=K_SIM, params_template=model.param_template())
        eplan = sub.plan_execution()
        log(f"  {norm}: update path: {eplan.strategy} -- {eplan.reason}")
        log(f"  {norm}: exchange schedule: {eplan.overlap_exchange} -- "
            f"{eplan.overlap_reason}")
        check(sub.joint_subspace and eplan.strategy == "fused_packed",
              "the K-worker simulation does not plan the joint subspace")
        params = sub.prepare_params(model.init(0, device="cuda"))
        st_r = sub.init_rbd_state()
        st_o = sub.init_opt_state(device="cuda")
        stream = synthetic.lm_batches(0, 8, 128, cfg.vocab, device="cuda")
        lay = sub.transform.plan.packed()
        grads = torch.empty((K_SIM, lay.q_packed), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(SIM_STEPS):
            t0 = time.perf_counter()
            losses = []
            for k in range(K_SIM):
                stored = params.detach().requires_grad_(True)
                loss, _ = loss_fn(sub.materialize_params(stored),
                                  next(stream))
                (grads[k],) = torch.autograd.grad(loss, stored)
                losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rbd_step.reset_counts()
            rbd_step.set_timing(True)
            with torch.no_grad():
                params, st_r, st_o, aux = sub.step(params, grads, st_r,
                                                   st_o)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step_ms = rbd_step.kernel_times_ms()
            rbd_step.set_timing(False)
            got = dict(rbd_step.LAUNCHES)
            check(got["project_packed"] == K_SIM
                  and got["reconstruct_apply_packed_workers"] == 1
                  and got["reconstruct_apply_packed"] == 0,
                  f"{norm} step {i}: expected {K_SIM} projections and one "
                  f"K-worker apply, got {got}")
            for k, v in got.items():
                launches[k] += v
            for k, v in step_ms.items():
                times[k] += v
            check(all(math.isfinite(x) for x in losses)
                  and math.isfinite(float(aux.update_norm)),
                  f"{norm} step {i}: non-finite loss or update")
            ms = {k: [round(x, 2) for x in v] for k, v in step_ms.items()}
            log(f"  {norm} step {i}: losses {[round(x, 4) for x in losses]}"
                f" forward+backward x{K_SIM} {t1 - t0:.3f} s, optimizer "
                f"step {t2 - t1:.3f} s; project ms {ms['project_packed']}, "
                "workers apply ms "
                f"{ms['reconstruct_apply_packed_workers']}; launches {got}")
        log(f"  {norm}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(bool((params[~_valid_mask(lay, 'cuda')] == 0).all()),
              f"{norm}: theta padding is not exactly 0")
        del grads, params, st_o
    log(f"  launches over {2 * SIM_STEPS} steps: {launches}")
    # the plain version at the simulation's K, for the timing row
    lay = full_plan.packed()
    gen = torch.Generator(device="cuda").manual_seed(4)
    wseeds = projector.worker_segment_seeds(full_plan, rng.fold_seed(0, 0),
                                            K_SIM)
    theta = torch.where(_valid_mask(lay, "cuda"), torch.randn(
        lay.q_packed, generator=gen, device="cuda"), 0.0)
    scale = torch.randn((K_SIM, lay.d_packed), generator=gen, device="cuda")
    scale = scale * 1e-4 * torch.from_numpy(lay.coord_valid).cuda()
    plain = {}
    plain_ms = cuda_ms(lambda: plain.update(
        out=rbd_step.reconstruct_apply_packed_workers_plain(
            wseeds, scale, theta, lay, full_plan.distribution)))[0]
    out = rbd_step.reconstruct_apply_packed_workers(
        wseeds, scale, theta, lay, full_plan.distribution)
    err = _check_apply(f"full plan/K={K_SIM}", out, plain["out"], theta)
    name = "reconstruct_apply_packed_workers"
    ts = sorted(times[name])
    return kernel_row(name, lay, full_plan.distribution, dev, K_SIM,
                      launches[name], err, ts[len(ts) // 2], plain_ms)


def phase_exchange():
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import train as launcher

    log("== phase 9: the coordinate exchange on a one-rank NCCL group")
    for mode, apply, kind in (
            ("independent_bases", "reconstruct_apply_packed_workers",
             "all_gather"),
            ("shared_basis", "reconstruct_apply_packed", "all_reduce")):
        args = ARCH_ARGS[:-1] + ["--rbd-mode", mode]
        log("  python -m repro_torch.launch.train " + " ".join(args))
        rbd_step.reset_counts()
        res = launcher.main(args)
        launches = dict(rbd_step.LAUNCHES)
        log(f"  {mode}: launches {launches}, collectives "
            f"{res.collectives}, losses {res.losses}")
        want = dict.fromkeys(rbd_step.KERNELS, 0)
        want.update({"project_packed": STEPS, apply: STEPS})
        check(launches == want,
              f"{mode}: expected two kernel launches per step, got "
              f"{launches}")
        other = "all_reduce" if kind == "all_gather" else "all_gather"
        check(res.collectives[kind] == STEPS and res.collectives[other] == 0,
              f"{mode}: expected one {kind} per step, got {res.collectives}")
        check(all(math.isfinite(x) for x in res.losses),
              f"{mode}: losses {res.losses}")


def _check_adapters(case, aseeds, sub, scale, theta, lay, dist, valid,
                    plain=True):
    """Kernel vs plain B-adapter apply: reruns, padding, every row
    bit-identical to the single-tenant kernel, rows within tolerance of
    the plain version.  Returns (max|dtheta|, kernel out)."""
    import torch
    from repro_torch.core import projector
    from repro_torch.kernels import rbd_step

    aseg = projector.adapter_segment_seeds(sub, aseeds)
    out = rbd_step.reconstruct_apply_packed_adapters(aseg, scale, theta, lay,
                                                     dist)
    out2 = rbd_step.reconstruct_apply_packed_adapters(aseg, scale, theta,
                                                      lay, dist)
    check(torch.equal(out, out2), f"{case}: adapter apply reruns differ")
    check(bool((out[:, ~valid] == 0).all()),
          f"{case}: padding of a row is not exactly 0")
    for a in range(out.shape[0]):
        single = rbd_step.reconstruct_apply_packed(
            projector.segment_seeds(sub, int(aseeds[a])),
            scale[a].contiguous(), theta, lay, dist)
        check(torch.equal(out[a], single),
              f"{case}: row {a} differs from reconstruct_apply_packed")
        del single
    log(f"    {case}: reruns bit-identical, padding exactly 0, every row "
        "bit-identical to reconstruct_apply_packed")
    err = 0.0
    if plain:
        ref = rbd_step.reconstruct_apply_packed_adapters_plain(
            aseg, scale, theta, lay, dist)
        for a in range(out.shape[0]):
            err = max(err, _check_apply(f"{case} row {a}", out[a], ref[a],
                                        theta))
    return err, out


def phase_adapters(full_plan, dev):
    import numpy as np
    import torch
    from repro_torch.core import projector
    from repro_torch.kernels import rbd_step

    log("== phase 10: adapter apply kernel vs plain at full qwen2-0.5b "
        "width")
    name = "reconstruct_apply_packed_adapters"
    err = 0.0
    gen = torch.Generator(device="cuda").manual_seed(5)
    subs = _sub_plans(full_plan)
    for sname, sub in subs.items():
        lay = sub.packed()
        valid = _valid_mask(lay, "cuda")
        cases = ([(d, b) for d in DISTS for b in (1, 3)]
                 if sname.startswith("layer") else [("normal", 2)])
        for dist, b in cases:
            aseeds = np.arange(1000, 1000 + b, dtype=np.uint32)
            theta = torch.where(valid, torch.randn(
                lay.q_packed, generator=gen, device="cuda"), 0.0)
            scale = torch.randn((b, lay.d_packed), generator=gen,
                                device="cuda")
            scale = scale * 1e-3 * torch.from_numpy(lay.coord_valid).cuda()
            dt, _ = _check_adapters(f"{sname}/{dist}/B={b}", aseeds, sub,
                                    scale, theta, lay, dist, valid)
            err = max(err, dt)
    # the full shapes at B = 4: timed, against the plain version timed too
    lay = full_plan.packed()
    dist = full_plan.distribution
    valid = _valid_mask(lay, "cuda")
    aseeds = np.arange(2000, 2000 + B_FULL, dtype=np.uint32)
    aseg = projector.adapter_segment_seeds(full_plan, aseeds)
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device="cuda"), 0.0)
    scale = torch.randn((B_FULL, lay.d_packed), generator=gen, device="cuda")
    scale = scale * 1e-4 * torch.from_numpy(lay.coord_valid).cuda()
    ms = cuda_ms(lambda: rbd_step.reconstruct_apply_packed_adapters(
        aseg, scale, theta, lay, dist), repeat=3)
    plain = {}
    plain_ms = cuda_ms(lambda: plain.update(
        out=rbd_step.reconstruct_apply_packed_adapters_plain(
            aseg, scale, theta, lay, dist)))[0]
    out = rbd_step.reconstruct_apply_packed_adapters(aseg, scale, theta, lay,
                                                     dist)
    for a in range(B_FULL):
        err = max(err, _check_apply(f"full plan/B={B_FULL} row {a}", out[a],
                                    plain["out"][a], theta))
    del plain, out
    dt, out = _check_adapters(f"full plan/B={B_FULL}", aseeds, full_plan,
                              scale, theta, lay, dist, valid, plain=False)
    del out
    b_ms, by = bound_ms(name, lay, dist, dev, B_FULL)
    med = sorted(ms)[len(ms) // 2]
    log(f"    full plan/B={B_FULL}: kernel ms {ms}, plain {plain_ms:.1f}, "
        f"bound {b_ms:.3f} ({by}), {b_ms / med:.1%} of bound")
    return {"err": err, "ms": med, "plain_ms": plain_ms}


def _serve_requests(vocab):
    """The six requests of a serving round: (prompt, adapter, temperature,
    seed), prompts of 32-128 tokens drawn with numpy."""
    import numpy as np

    rs = np.random.default_rng(11)
    spec = [("t0", 0.0), ("t1", 0.0), (None, 0.0), ("t2", 0.0), (None, 0.0),
            ("t1", 0.7)]
    return [(rs.integers(0, vocab, int(rs.integers(32, 129))), aid, temp,
             7 + i) for i, (aid, temp) in enumerate(spec)]


def _profile_decode_ticks(mt, requests, torch, n_ticks=5):
    """Device busy share of ``n_ticks`` decode ticks with every slot
    decoding: the device-side events torch.profiler records (kernels and
    copies, on one stream, so they do not overlap) over the ticks' host
    wall time.  Printed as not measured if it records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p, aid, _, seed in requests[:mt.n_slots]:
        mt.submit(p[:32], n_ticks + 2, adapter_id=aid, seed=seed)
    mt._admit_and_prefill()
    mt._decode_tick()                       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            mt._decode_tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mt.run()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in device)
    tick_ms = 1e3 * wall / n_ticks
    if busy_us <= 0:
        log(f"  decode tick ({mt.n_slots} slots decoding): {tick_ms:.2f} ms;"
            " device busy share not measured (the profiler recorded no "
            "device time)")
        return
    share = busy_us / 1e6 / wall
    log(f"  decode tick ({mt.n_slots} slots decoding, profiled): "
        f"{tick_ms:.2f} ms, device busy {busy_us / 1e3 / n_ticks:.2f} ms "
        f"({share:.1%}, idle {1 - share:.1%}), "
        f"{sum(e.count for e in device) / n_ticks:.0f} device ops")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:5]:
        ms = e.self_device_time_total / 1e3 / n_ticks
        log(f"    {e.key[:64]:64s} {ms:7.3f} ms x{e.count / n_ticks:.0f} "
            "per tick")


def phase_serving(dev):
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import compartments, projector
    from repro_torch.kernels import rbd_step
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    from repro_torch.serve.adapters import (AdapterCache, AdapterRegistry,
                                            AdapterSpec)
    from repro_torch.serve.engine import Engine, MultiTenantEngine

    log("== phase 11: serving qwen2-0.5b at full width and depth (bf16)")
    name = "reconstruct_apply_packed_adapters"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    params = model.init(0, device="cuda")
    plan = compartments.make_plan(model.param_shapes(), 1024,
                                  granularity="layer",
                                  is_stacked=model.is_stacked)
    lay = plan.packed()
    log(f"  plan: d_packed {lay.d_packed}, q_packed {lay.q_packed:,}, "
        f"compute {cfg.compute_dtype}")
    rs = np.random.default_rng(3)
    reg = AdapterRegistry()
    for i in range(3):
        reg.register(AdapterSpec(f"t{i}", 501 + i,
                                 0.05 * rs.standard_normal(lay.d_packed)))
    cache = AdapterCache(4 * 4 * lay.q_packed)
    mt = MultiTenantEngine(model, params, plan, registry=reg,
                           delta_cache=cache, n_slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN, pin_on_miss=True)
    personalize_ms = []
    orig = mt._personalize_slots

    def timed_personalize(admitted):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(admitted)
        torch.cuda.synchronize()
        personalize_ms.append(1e3 * (time.perf_counter() - t0))

    mt._personalize_slots = timed_personalize
    requests = _serve_requests(cfg.vocab)
    rounds, tenant_row_checked, flash_prefilled = [], False, 0
    rbd_step.reset_counts()
    rbd_step.set_timing(True)
    for rnd in range(2):
        rids = [mt.submit(p, SERVE_NEW, adapter_id=aid, temperature=temp,
                          seed=seed) for p, aid, temp, seed in requests]
        admit_s, decode_s = [], []
        t_round = time.perf_counter()
        while not mt.scheduler.all_done():
            before = rbd_step.LAUNCHES[name]
            flash0 = rbd_step.LAUNCHES["flash_attention"]
            misses0, admitted0 = cache.misses, mt.scheduler.n_admitted
            prefills0 = mt.stats["prefills"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mt._admit_and_prefill()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launched = rbd_step.LAUNCHES[name] - before
            want = 1 if cache.misses > misses0 else 0
            check(launched == want,
                  f"round {rnd}: admission tick made {launched} adapter "
                  f"launches, expected {want}")
            flash = rbd_step.LAUNCHES["flash_attention"] - flash0
            prefills = mt.stats["prefills"] - prefills0
            check(flash == cfg.n_layers * prefills,
                  f"round {rnd}: {prefills} prefills made {flash} flash "
                  f"launches, expected {cfg.n_layers} each")
            flash_prefilled += prefills
            if mt.scheduler.n_admitted > admitted0:
                admit_s.append(t1 - t0)
            if not tenant_row_checked:
                slot = next(i for i, r in enumerate(mt.scheduler.slots)
                            if r is not None and r.adapter_id == "t0")
                check(bool((mt._slot_thetas[slot] != mt.theta).any()),
                      "tenant t0's slot row equals the base")
                tenant_row_checked = True
            before = rbd_step.LAUNCHES[name]
            flash0 = rbd_step.LAUNCHES["flash_attention"]
            t2 = time.perf_counter()
            mt._decode_tick()
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t2)
            check(rbd_step.LAUNCHES[name] == before,
                  f"round {rnd}: a decode tick launched the adapter kernel")
            check(rbd_step.LAUNCHES["flash_attention"] == flash0,
                  f"round {rnd}: a decode tick launched the flash kernel")
        wall = time.perf_counter() - t_round
        res = mt.scheduler.results()
        toks = [res[rid] for rid in rids]
        n_tok = sum(len(v) for v in toks)
        check(all(len(v) == SERVE_NEW for v in toks),
              f"round {rnd}: lengths {[len(v) for v in toks]}")
        rounds.append(toks)
        dec = sorted(decode_s)
        log(f"  round {rnd}: {n_tok} tokens in {wall:.3f} s "
            f"({n_tok / wall:.1f} tokens/s), admission ticks "
            f"{[round(1e3 * x, 1) for x in admit_s]} ms (personalize + "
            f"prefill), decode ms per tick median {1e3 * dec[len(dec) // 2]:.2f}"
            f" (min {1e3 * dec[0]:.2f}, max {1e3 * dec[-1]:.2f}, "
            f"{len(dec)} ticks); stats {mt.stats}; cache {cache.stats()}")
        if rnd == 0:
            check(mt.stats["fused_launches"] == 1,
                  f"round 0: {mt.stats['fused_launches']} fused launches")
            launches_round0 = rbd_step.LAUNCHES[name]
    launches = rbd_step.LAUNCHES[name]
    kernel_ms = rbd_step.kernel_times_ms()[name]
    rbd_step.set_timing(False)
    check(launches == mt.stats["fused_launches"] == launches_round0 == 1,
          f"adapter launches {launches}, engine fused_launches "
          f"{mt.stats['fused_launches']}, after round 0 {launches_round0}")
    log(f"  adapter launches {launches} (== stats fused_launches), kernel ms "
        f"{[round(x, 2) for x in kernel_ms]}; personalization ms "
        f"{[round(x, 1) for x in personalize_ms]}; flash launches "
        f"{rbd_step.LAUNCHES['flash_attention']} = {cfg.n_layers} x "
        f"{flash_prefilled} prefills, none in decode")
    _profile_decode_ticks(mt, requests, torch)
    r0, r1 = rounds
    for i, (_, aid, temp, _) in enumerate(requests):
        check(np.array_equal(r0[i], r1[i]),
              f"request {i} ({aid}, T={temp}): rounds differ")
    log("  every request's tokens identical across the two rounds")
    # a tenant's greedy tokens == Engine's on that tenant's parameters
    row = mt.theta + cache.get(reg.get("t0").base_seed)
    eng = Engine(model, projector.unpack_tree(row, plan, lay, params),
                 max_len=SERVE_MAX_LEN)
    ref = eng.generate(requests[0][0][None, :], SERVE_NEW).cpu().numpy()[0]
    check(np.array_equal(ref, r0[0]),
          "tenant t0's tokens differ from Engine on its parameters")
    log(f"  tenant t0 tokens == Engine on its parameters: {ref[:8].tolist()}"
        " ...")
    # prefill of the longest prompt alone, timed
    p_long = max((p for p, *_ in requests), key=len)
    prompt = torch.from_numpy(p_long).cuda()[None, :]
    ms = cuda_ms(lambda: transformer.prefill(cfg, eng._cparams, prompt,
                                             SERVE_MAX_LEN), repeat=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  prefill of {len(p_long)} tokens: {[round(x, 2) for x in ms]} ms; "
        f"peak memory {peak:.2f} GiB")
    del mt, eng, row, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel_ms": kernel_ms}


def _leaf_cases(full_plan):
    """Phase 12's full-width per-leaf cases: (name, leaf plan, n_stack,
    dim) -- each stacked leaf's first two layers, final_norm, and embed
    cut to its first two dir-blocks (16 directions over all positions)."""
    cases = [(lp.name, lp, 2, lp.dim) for lp in full_plan.leaves
             if lp.stacked]
    by_name = {lp.name: lp for lp in full_plan.leaves}
    cases.append(("final_norm", by_name["final_norm"], 1,
                  by_name["final_norm"].dim))
    cases.append(("embed[2 dir-blocks]", by_name["embed"], 1, 16))
    return cases


def _check_delta(case, out, ref) -> float:
    """Kernel reconstruct_flat against the plain version's delta: the
    update's tolerance, 1e-4 of its largest value."""
    dd = float((out - ref).abs().max())
    tol = THETA_RTOL * float(ref.abs().max())
    log(f"    {case} reconstruct: max|ddelta|={dd:.3g} (tol {tol:.3g})")
    check(dd <= tol, f"{case}: reconstruct_flat outside tolerance")
    return dd


def _check_flat_project(case, u, sq, up, sqp, g) -> float:
    """Kernel project_flat's (u, sq) against the plain version's, row by
    row: |du| within U_RTOL of ||g_s|| sqrt(sq / Q), sq within SQ_RTOL.
    Returns max|du|."""
    gnorm = g.norm(dim=1, keepdim=True) / math.sqrt(g.shape[1])
    du = (u - up).abs()
    rel_u = float((du / (gnorm * sqp.sqrt()).clamp(min=1e-30)).max())
    rel_sq = float(((sq - sqp).abs() / sqp.clamp(min=1e-30)).max())
    log(f"    {case} project: max|du|={float(du.max()):.3g} rel={rel_u:.3g} "
        f"(tol {U_RTOL}), max rel dsq={rel_sq:.3g} (tol {SQ_RTOL})")
    check(rel_u <= U_RTOL and rel_sq <= SQ_RTOL,
          f"{case}: project_flat outside tolerance")
    return float(du.max())


def phase_leaf_kernels(full_plan):
    import torch
    from repro_torch.core import projector, rng
    from repro_torch.core.compartments import Plan
    from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step

    log("== phase 12: per-leaf kernels vs plain at full qwen2-0.5b width")
    errs = dict.fromkeys(FLAT_KERNELS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(6)
    step_seed = rng.fold_seed(0, 0)
    layer = {}   # dist -> [(leaf plan, g, u, sq)] of one layer pair
    for name, lp, n, dim in _leaf_cases(full_plan):
        q = lp.size
        seeds = projector._leaf_seeds(step_seed, lp)[:n]
        for dist in (DISTS if n == 2 else ("normal",)):
            case = f"{name}/{dist}"
            g = torch.randn((n, q), generator=gen, device="cuda")
            u, sq = rbd_project.project_flat(seeds, g, dim, dist)
            u2, sq2 = rbd_project.project_flat(seeds, g, dim, dist)
            up, sqp = rbd_project.project_flat_plain(seeds, g, dim, dist)
            check(torch.equal(u, u2) and torch.equal(sq, sq2),
                  f"{case}: project_flat reruns differ")
            errs["project_flat"] = max(errs["project_flat"],
                                       _check_flat_project(case, u, sq, up,
                                                           sqp, g))
            if lp.stacked:
                layer.setdefault(dist, []).append((lp, g, u, sq))

            scale = torch.randn((n, dim), generator=gen, device="cuda") * 1e-3
            d1 = rbd_reconstruct.reconstruct_flat(seeds, scale, q, dist)
            d2 = rbd_reconstruct.reconstruct_flat(seeds, scale, q, dist)
            check(torch.equal(d1, d2), f"{case}: reconstruct reruns differ")
            errs["reconstruct_flat"] = max(
                errs["reconstruct_flat"], _check_delta(
                    case, d1, rbd_reconstruct.reconstruct_flat_plain(
                        seeds, scale, q, dist)))
            del d1, d2
            theta = torch.randn((n, q), generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                th = theta.to(dtype)
                out = rbd_reconstruct.reconstruct_apply_flat(
                    seeds, scale, th, 0.125, dist)
                again = rbd_reconstruct.reconstruct_apply_flat(
                    seeds, scale, th, 0.125, dist)
                inplace = th.clone()
                rbd_reconstruct.reconstruct_apply_flat(
                    seeds, scale, inplace, 0.125, dist, out=inplace)
                check(torch.equal(out, again) and torch.equal(out, inplace),
                      f"{case}: apply reruns / in-place differ ({dtype})")
                if dtype == torch.bfloat16:
                    # rounded once: the float32 kernel on the same values,
                    # cast once
                    wide = rbd_reconstruct.reconstruct_apply_flat(
                        seeds, scale, th.float(), 0.125, dist)
                    check(torch.equal(out, wide.to(torch.bfloat16)),
                          f"{case}: bf16 apply is not rounded once")
                    del wide
                ref = rbd_reconstruct.reconstruct_apply_flat_plain(
                    seeds, scale, th, 0.125, dist)
                errs["reconstruct_apply_flat"] = max(
                    errs["reconstruct_apply_flat"],
                    _check_apply(f"{case} {dtype}", out, ref, th))
                del out, again, inplace, ref
            log(f"    {case}: apply reruns and in-place bit-identical, bf16 "
                "rounded once")
            del g, theta
    # per-leaf seeds are the packed segment seeds: the per-leaf launches of
    # one layer pair equal one project_packed launch bit for bit
    for dist, leaves in layer.items():
        sub = Plan(leaves=tuple(
            dataclasses.replace(lp, shape=(2,) + lp.shape[1:], n_stack=2)
            for lp, *_ in leaves), total_dim=0, total_params=0,
            distribution=dist)
        lay = sub.packed()
        packed_g = projector.pack_tree({lp.name: g for lp, g, _, _ in leaves},
                                       sub, lay)
        pu, psq = rbd_step.project_packed(
            projector.segment_seeds(sub, step_seed), packed_g, lay, dist)
        for (lp, _, u, sq), cu, csq in zip(
                leaves, projector.unpack_coords(pu, sub, lay),
                projector.unpack_coords(psq, sub, lay)):
            check(torch.equal(u, cu) and torch.equal(sq, csq),
                  f"{lp.name}/{dist}: project_flat differs from "
                  "project_packed")
        log(f"  {dist}: {len(leaves)} leaves' project_flat bit-identical to "
            "one project_packed launch on the same seeds")
    return errs


def _per_step(times, n_leaves):
    """Per-step sums of a run's per-launch ms (n_leaves launches a step,
    embed first) and embed's per-launch ms."""
    steps = [times[i: i + n_leaves] for i in range(0, len(times), n_leaves)]
    return [sum(t) for t in steps], [t[0] for t in steps]


# phase 13's launcher runs: (label, extra flags, apply kernel, collective
# per step -- none for the SGD baseline on one rank, which runs with
# axis_name=None as the reference's launcher does)
PER_LEAF_RUNS = (
    ("fused_per_leaf", ["--packed", "off"], "reconstruct_apply_flat",
     "all_reduce"),
    ("weight decay", ["--weight-decay", "0.01"], "reconstruct_flat",
     "all_reduce"),
    ("sgd baseline", ["--mode", "sgd"], None, None),
)
# the run whose counts and times make each per-leaf kernel's row
ROW_RUN = {"project_flat": "fused_per_leaf",
           "reconstruct_flat": "weight decay",
           "reconstruct_apply_flat": "fused_per_leaf"}


def _per_leaf_launcher_runs(n_leaves):
    import gc

    import torch
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import train as launcher

    # earlier phases' tensors go before the first run, so that each run's
    # peak memory is its own
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    for label, extra, apply, kind in PER_LEAF_RUNS:
        args = ARCH_ARGS + extra
        log("  python -m repro_torch.launch.train " + " ".join(args))
        rbd_step.reset_counts()
        res = launcher.main(args)
        launches = dict(rbd_step.LAUNCHES)
        want = dict.fromkeys(rbd_step.KERNELS, 0)
        if apply:
            want.update({"project_flat": n_leaves * STEPS,
                         apply: n_leaves * STEPS})
        log(f"  {label}: update path {res.sub_opt.plan_execution().strategy}"
            f", launches {launches}, collectives {res.collectives}, losses "
            f"{res.losses}, peak memory {res.peak_bytes / 2**30:.2f} GiB")
        check(launches == want,
              f"{label}: expected {n_leaves} + {n_leaves} launches per step "
              f"(none for sgd), got {launches}")
        if kind is None:
            check(not any(res.collectives.values()),
                  f"{label}: expected no collective, got {res.collectives}")
        else:
            others = sum(v for k, v in res.collectives.items()
                         if k not in (kind, "scalar"))
            check(res.collectives[kind] == STEPS and others == 0,
                  f"{label}: expected one {kind} per step, got "
                  f"{res.collectives}")
        check(all(math.isfinite(x) for x in res.losses),
              f"{label}: losses {res.losses}")
        check(launcher.params_sum(res.state.params) != res.theta_init_sum,
              f"{label}: theta did not change")
        for name in FLAT_KERNELS:
            if res.kernel_ms.get(name):
                sums, embed = _per_step(res.kernel_ms[name], n_leaves)
                log(f"    {name}: per-step sums of {n_leaves} launches "
                    f"{[round(x, 2) for x in sums]} ms; embed launch "
                    f"{[round(x, 2) for x in embed]} ms")
        runs[label] = (launches, res.kernel_ms)
        if label == "fused_per_leaf":
            PHASE13["losses"] = list(res.losses)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def _per_leaf_vs_packed_step(model, params, cfg):
    """One fused_per_leaf and one fused_packed step from the same
    parameters and batch: theta within the apply tolerance (the
    projections are bit-identical; the applies fold eta at different
    places)."""
    import torch
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.data import synthetic
    from repro_torch.train import step as steplib

    batch = next(synthetic.lm_batches(0, 8, 128, cfg.vocab, device="cuda"))
    thetas = {}
    for packed in ("on", "off"):
        tcfg = TrainConfig(model=cfg, rbd=RBDConfig(
            total_dim=1024, backend="cuda", packed=packed),
            learning_rate=0.125)
        init_state, train_step, sub = steplib.make_train_step(
            model, tcfg, device="cuda", return_optimizer=True)
        state, _ = train_step(init_state(params=params), batch)
        thetas[packed] = {k: v.clone() for k, v in
                          sub.materialize_params(state.params).items()}
        del state
    worst = 0.0
    for name, p0 in params.items():
        a, b = thetas["on"][name], thetas["off"][name]
        dt = float((a - b).abs().max())
        tol = (THETA_RTOL * float((a - p0).abs().max())
               + 2 * 2.0**-23 * float(p0.abs().max()))
        check(dt <= tol, f"{name}: fused_per_leaf vs fused_packed theta "
              f"differ by {dt:.3g} (tol {tol:.3g})")
        worst = max(worst, dt / max(tol, 1e-30))
    log("  one fused_per_leaf step vs one fused_packed step from the same "
        f"parameters and batch: every leaf within tolerance (worst "
        f"{worst:.3g} of it)")
    torch.cuda.synchronize()


def _plain_at_full_shapes(full_plan, params):
    """The plain versions over one step's leaves at the main path's full
    shapes, timed, each held against its kernel.  Returns (ms, errs)."""
    import torch
    from repro_torch.core import projector, rng
    from repro_torch.kernels import rbd_project, rbd_reconstruct

    dist = full_plan.distribution
    gen = torch.Generator(device="cuda").manual_seed(7)
    step_seed = rng.fold_seed(0, 0)
    errs = dict.fromkeys(FLAT_KERNELS, 0.0)
    plain_ms = dict.fromkeys(FLAT_KERNELS, 0.0)
    for lp in full_plan.leaves:
        seeds = projector._leaf_seeds(step_seed, lp)
        theta = params[lp.name].reshape(lp.n_stack, lp.size)
        g = torch.randn(theta.shape, generator=gen, device="cuda")
        scale = torch.randn((lp.n_stack, lp.dim), generator=gen,
                            device="cuda") * 1e-4
        plain = {}
        plain_ms["project_flat"] += cuda_ms(lambda: plain.update(
            p=rbd_project.project_flat_plain(seeds, g, lp.dim, dist)))[0]
        u, sq = rbd_project.project_flat(seeds, g, lp.dim, dist)
        errs["project_flat"] = max(errs["project_flat"], _check_flat_project(
            f"full {lp.name}", u, sq, *plain.pop("p"), g))
        del u, sq
        plain_ms["reconstruct_flat"] += cuda_ms(lambda: plain.update(
            r=rbd_reconstruct.reconstruct_flat_plain(seeds, scale, lp.size,
                                                     dist)))[0]
        errs["reconstruct_flat"] = max(errs["reconstruct_flat"], _check_delta(
            f"full {lp.name}", rbd_reconstruct.reconstruct_flat(
                seeds, scale, lp.size, dist), plain.pop("r")))
        plain_ms["reconstruct_apply_flat"] += cuda_ms(lambda: plain.update(
            a=rbd_reconstruct.reconstruct_apply_flat_plain(
                seeds, scale, theta, 0.125, dist)))[0]
        errs["reconstruct_apply_flat"] = max(
            errs["reconstruct_apply_flat"], _check_apply(
                f"full {lp.name}", rbd_reconstruct.reconstruct_apply_flat(
                    seeds, scale, theta, 0.125, dist), plain.pop("a"), theta))
        del plain, g
    log(f"  plain versions over the {len(full_plan.leaves)} leaves: "
        f"{ {k: round(v, 1) for k, v in plain_ms.items()} } ms")
    return plain_ms, errs


def phase_per_leaf(full_plan):
    """Returns (name, launches, max_abs_err, ms, plain_ms) per per-leaf
    kernel: launches from its main-path run, ms the median per-step sum
    of its 14 launches there."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    log("== phase 13: per-leaf strategies, qwen2-0.5b full width and depth")
    n_leaves = len(full_plan.leaves)
    runs = _per_leaf_launcher_runs(n_leaves)
    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    params = model.init(0, device="cuda")
    _per_leaf_vs_packed_step(model, params, cfg)
    plain_ms, errs = _plain_at_full_shapes(full_plan, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for name in FLAT_KERNELS:
        launches, kernel_ms = runs[ROW_RUN[name]]
        sums, _ = _per_step(kernel_ms[name], n_leaves)
        rows.append((name, launches[name], errs[name],
                     sorted(sums)[len(sums) // 2], plain_ms[name]))
    return rows


def shard_bound_ms(name, sl, shard, dist, dev, k_workers=1):
    """(least time in ms, "operations" or "bytes") for one launch on one
    slab: the shard's live basis values over the pipes, against the
    slab read once and written once (the apply) or read once (the
    projection, which writes the (d_packed,) partials)."""
    lay = sl.base
    values = k_workers * sl.live_values(shard)
    if name == "project_packed_sharded":
        nbytes = 4 * sl.q_slab + 4 * lay.n_segments + 8 * lay.d_packed
    else:
        nbytes = (8 * sl.q_slab + 4 * k_workers * lay.n_segments
                  + 4 * k_workers * lay.d_packed)
    ms, by, note = ops_bound(values, nbytes,
                             value_counts(name, "threefry", dist), dev)
    log(f"  bound {name} shard {shard} (K={k_workers}): {ms:.3f} ms -- "
        f"{note}")
    return ms, by


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def phase_sharded_kernels(full_plan, dev):
    """Returns ({kernel: max_abs_err against the plain version}, {kernel:
    (ms, plain_ms, bound_ms, bound_by)} on shard ROW_SHARD[1] of m =
    ROW_SHARD[0])."""
    import torch
    from repro_torch.core import compartments, projector, rng
    from repro_torch.kernels import rbd_step

    log("== phase 14: model-sharded slab kernels at full qwen2-0.5b width, "
        f"m in {M_SHARDS}, every shard in turn")
    lay = full_plan.packed()
    q = lay.q_packed
    dist = full_plan.distribution
    step_seed = rng.fold_seed(0, 0)
    seeds = projector.segment_seeds(full_plan, step_seed)
    wseeds = projector.worker_segment_seeds(full_plan, step_seed, K_SHARDED)
    gen = torch.Generator(device="cuda").manual_seed(14)
    valid = _valid_mask(lay, "cuda")
    g = torch.where(valid, torch.randn(q, generator=gen, device="cuda"), 0.0)
    theta = torch.where(valid, torch.randn(q, generator=gen, device="cuda"),
                        0.0)
    wscale = torch.randn((K_SHARDED, lay.d_packed), generator=gen,
                         device="cuda")
    wscale = wscale * 1e-4 * torch.from_numpy(lay.coord_valid).cuda()
    scale = wscale[0].contiguous()
    full = {}
    unsharded = {
        "project_packed": cuda_ms(lambda: full.update(
            p=rbd_step.project_packed(seeds, g, lay, dist)), repeat=3),
        "reconstruct_apply_packed": cuda_ms(lambda: full.update(
            a=rbd_step.reconstruct_apply_packed(seeds, scale, theta, lay,
                                                dist)), repeat=3),
        "reconstruct_apply_packed_workers": cuda_ms(lambda: full.update(
            w=rbd_step.reconstruct_apply_packed_workers(
                wseeds, wscale, theta, lay, dist)), repeat=3),
    }
    log("  unsharded kernels on the same inputs (K=2 for the workers "
        "apply), ms: " + ", ".join(
            f"{k} {[round(x, 2) for x in v]}" for k, v in unsharded.items()))
    sharded_of = dict(zip(unsharded, SHARDED_KERNELS))
    errs = dict.fromkeys(SHARDED_KERNELS, 0.0)
    row = {}
    for m in M_SHARDS:
        sl = compartments.sharded_packed_layout(lay, m)
        zeros = g.new_zeros((sl.q_padded - q,))
        gp, tp = torch.cat([g, zeros]), torch.cat([theta, zeros])
        gen_total = sum(sl.generated_values(s) for s in range(m))
        log(f"  m={m}: q_slab {sl.q_slab:,}, q_padded {sl.q_padded:,} "
            f"({sl.q_padded - q:,} padding), {sl.blocks_per_shard:,} "
            "pos-blocks a slab")
        sums = dict.fromkeys(SHARDED_KERNELS, 0.0)
        u_sum = sq_sum = None
        slabs, wslabs = [], []
        for shard in range(m):
            a, b = sl.slab_range(shard)
            res = {}
            ms = {
                "project_packed_sharded": cuda_ms(lambda: res.update(
                    p=rbd_step.project_packed_sharded(
                        seeds, gp[a:b], sl, shard, dist)), repeat=3),
                "reconstruct_apply_packed_sharded": cuda_ms(
                    lambda: res.update(
                        a=rbd_step.reconstruct_apply_packed_sharded(
                            seeds, scale, tp[a:b], sl, shard, dist)),
                    repeat=3),
                "reconstruct_apply_packed_workers_sharded": cuda_ms(
                    lambda: res.update(
                        w=rbd_step.reconstruct_apply_packed_workers_sharded(
                            wseeds, wscale, tp[a:b], sl, shard, dist)),
                    repeat=3),
            }
            for k, v in ms.items():
                sums[k] += _median(v)
            u, sq = res["p"]
            u_sum = u if u_sum is None else u_sum + u
            sq_sum = sq if sq_sum is None else sq_sum + sq
            slabs.append(res["a"])
            wslabs.append(res["w"])
            log(f"    shard {shard}: {sl.live_values(shard):,} live basis "
                f"values ({sl.generated_values(shard) / gen_total:.1%} of "
                "the pass generated); ms " + ", ".join(
                    f"{k.replace('reconstruct_apply_packed', 'apply')} "
                    f"{[round(x, 2) for x in v]}" for k, v in ms.items()))
            if m == 4 and shard in PLAIN_SHARDS:
                plain_ms = _sharded_vs_plain(
                    f"m={m}/shard {shard}", res, seeds, wseeds, scale,
                    wscale, gp[a:b], tp[a:b], sl, shard, g, lay, dist, errs)
                if (m, shard) == ROW_SHARD:
                    row = _sharded_rows(sl, shard, dist, dev, ms, plain_ms)
        for name, out, want in (("apply", slabs, full["a"]),
                                ("K=2 workers apply", wslabs, full["w"])):
            cat = torch.cat(out)
            check(torch.equal(cat[:q], want),
                  f"m={m}: the {name} slabs differ from the unsharded "
                  "kernel's output")
            check(bool((cat[q:] == 0).all()),
                  f"m={m}: {name} padding is not exactly 0")
        log(f"  m={m}: every {m} slabs of the apply and of the K=2 workers "
            "apply bit-identical to the unsharded kernels' output, padding "
            "exactly 0")
        _check_project(f"m={m} completed", u_sum, sq_sum, *full["p"], g, lay)
        log(f"  m={m}: summed over the shards, ms " + ", ".join(
            f"{k} {sums[sk]:.2f} ({sums[sk] / _median(v):.3f} x unsharded)"
            for k, v in unsharded.items() for sk in [sharded_of[k]]))
    return errs, row


def _sharded_vs_plain(case, res, seeds, wseeds, scale, wscale, gs, ts, sl,
                      shard, g, lay, dist, errs):
    """One slab's three kernels (outputs in ``res``) against their plain
    versions, timed; folds the errors into ``errs``, returns the plain
    versions' ms."""
    from repro_torch.kernels import rbd_step

    plain = {}
    plain_ms = {
        "project_packed_sharded": cuda_ms(lambda: plain.update(
            p=rbd_step.project_packed_sharded_plain(seeds, gs, sl, shard,
                                                    dist)))[0],
        "reconstruct_apply_packed_sharded": cuda_ms(lambda: plain.update(
            a=rbd_step.reconstruct_apply_packed_sharded_plain(
                seeds, scale, ts, sl, shard, dist)))[0],
        "reconstruct_apply_packed_workers_sharded": cuda_ms(
            lambda: plain.update(
                w=rbd_step.reconstruct_apply_packed_workers_sharded_plain(
                    wseeds, wscale, ts, sl, shard, dist)))[0],
    }
    found = {
        "project_packed_sharded": _check_project(
            case, *res["p"], *plain["p"], g, lay),
        "reconstruct_apply_packed_sharded": _check_apply(
            case, res["a"], plain["a"], ts),
        "reconstruct_apply_packed_workers_sharded": _check_apply(
            f"{case} K=2", res["w"], plain["w"], ts),
    }
    log(f"    {case}: plain ms " + ", ".join(
        f"{k} {v:.1f}" for k, v in plain_ms.items()))
    for k, v in found.items():
        errs[k] = max(errs[k], v)
    return plain_ms


def _sharded_rows(sl, shard, dist, dev, ms, plain_ms):
    """(ms, plain_ms, bound_ms, bound_by) of each sharded kernel on one
    slab."""
    row = {}
    for k in SHARDED_KERNELS:
        kw = K_SHARDED if "workers" in k else 1
        b_ms, by = shard_bound_ms(k, sl, shard, dist, dev, kw)
        row[k] = (_median(ms[k]), plain_ms[k], b_ms, by)
        log(f"    {k} on shard {shard} of m={sl.n_shards}: "
            f"{kw * sl.live_values(shard):,} basis values; ms "
            f"{_median(ms[k]):.3f}, plain {plain_ms[k]:.1f}, bound "
            f"{b_ms:.3f} ({by}), {b_ms / _median(ms[k]):.1%} of bound")
    return row


def phase_sharded_training(full_plan):
    """Returns the launches by kernel over the main-path steps."""
    import copy
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.core import distributed
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    gc.collect()
    torch.cuda.empty_cache()
    log(f"== phase 15: model-sharded packed step, m={SHARD_M} shards in "
        "turn, qwen2-0.5b full width and depth")
    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    loss_fn = steplib.make_loss_fn(model, cfg.router_aux_coef)
    q = full_plan.packed().q_packed
    launches = dict.fromkeys(rbd_step.KERNELS, 0)
    mesh = meshlib.init_mesh(1, 1, "cuda")   # the one-rank data group
    try:
        for label, mode, optimizer, norm in SHARD_RUNS:
            rbd = RBDConfig(total_dim=1024, backend="cuda", mode=mode,
                            normalization=norm)
            tcfg = TrainConfig(model=cfg, rbd=rbd, learning_rate=0.125,
                               optimizer=optimizer)
            transform = steplib.make_transform(model, rbd)
            sub = steplib.make_subspace_optimizer(
                model, tcfg, transform, "data", model_sharded=True,
                model_axis="model", model_shards=SHARD_M)
            ref = steplib.make_subspace_optimizer(model, tcfg, transform,
                                                  "data")
            eplan = sub.plan_execution()
            log(f"  {label}: update path: {eplan.strategy} -- "
                f"{eplan.reason}")
            check(eplan.strategy == "fused_packed" and eplan.packed_resident,
                  f"{label}: the sharded plan is not fused_packed")
            apply = ("reconstruct_apply_packed_workers_sharded"
                     if sub.joint_subspace
                     else "reconstruct_apply_packed_sharded")
            kind = "all_gather" if sub.joint_subspace else "all_reduce"
            padded = sub.padded_params(model.init(0, device="cuda"))
            slabs = [sub.slab_of(padded, s).clone() for s in range(SHARD_M)]
            del padded
            st_r = sub.init_rbd_state()
            st_o = sub.init_opt_state(device="cuda")
            stream = synthetic.lm_batches(0, 8, 128, cfg.vocab,
                                          device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            worst = 0.0
            for i in range(STEPS):
                t0 = time.perf_counter()
                # the forward's all-gather of the slabs, in turn
                full = torch.cat(slabs).requires_grad_(True)
                loss, _ = loss_fn(sub.materialize_params(full),
                                  next(stream))
                (grad,) = torch.autograd.grad(loss, full)
                full = full.detach()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                opt_before = copy.deepcopy(st_o)
                rbd_step.reset_counts()
                distributed.reset_counts()
                rbd_step.set_timing(True)
                with torch.no_grad():
                    slabs, new_r, st_o, aux = sub.step_shards_in_turn(
                        slabs, [sub.slab_of(grad, s)
                                for s in range(SHARD_M)], st_r, st_o)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                got = dict(rbd_step.LAUNCHES)
                coll = dict(distributed.COLLECTIVES)
                step_ms = rbd_step.kernel_times_ms()
                rbd_step.set_timing(False)
                want = dict.fromkeys(rbd_step.KERNELS, 0)
                want.update({"project_packed_sharded": SHARD_M,
                             apply: SHARD_M})
                check(got == want, f"{label} step {i}: expected 2 launches "
                      f"per shard, got {got}")
                check(coll[kind] == 1 and sum(coll.values()) == 1,
                      f"{label} step {i}: expected one {kind}, got {coll}")
                for k, v in got.items():
                    launches[k] += v
                # a fused_packed step from the same state and gradient
                with torch.no_grad():
                    want_theta = ref.step(full[:q].clone(), grad[:q], st_r,
                                          opt_before)[0]
                new = torch.cat(slabs)
                dt = float((new[:q] - want_theta).abs().max())
                upd = float((want_theta - full[:q]).abs().max())
                tol = (THETA_RTOL * upd
                       + 2 * 2.0**-23 * float(full.abs().max()))
                check(dt <= tol, f"{label} step {i}: theta off the "
                      f"fused_packed step by {dt:.3g} (tol {tol:.3g})")
                check(bool((new[q:] == 0).all()),
                      f"{label} step {i}: padding is not exactly 0")
                check(math.isfinite(float(loss.detach()))
                      and math.isfinite(float(aux.update_norm)),
                      f"{label} step {i}: non-finite loss or update")
                worst = max(worst, dt / max(tol, 1e-30))
                st_r = new_r
                ms = {k: [round(x, 2) for x in v]
                      for k, v in step_ms.items() if v}
                log(f"  {label} step {i}: loss {float(loss.detach()):.4f}, "
                    f"forward+backward {t1 - t0:.3f} s, optimizer step "
                    f"{t2 - t1:.3f} s; launches "
                    f"{ {k: v for k, v in got.items() if v} }; ms {ms}; "
                    f"theta vs fused_packed {dt:.3g} (tol {tol:.3g})")
                del full, grad, want_theta, new
            log(f"  {label}: peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"worst theta {worst:.3g} of the tolerance")
            del slabs, st_o
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        meshlib.destroy_mesh(mesh)
    log(f"  launches over {len(SHARD_RUNS)} x {STEPS} steps: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


# ---------------------------------------------------------------------------
# phase 16: long-prompt prefill through the flash kernel
# ---------------------------------------------------------------------------


def flash_bound_ms(b, sq, sk, h, kv, hd, dtype, causal=True, window=None):
    """(least time in ms, "operations" or "bytes") of one flash launch: 4
    hd flops per live (q, k) pair (the pairs the causal / window band
    leaves) at the dtype's peak, against q, k, v read once and o written
    once at the memory rate."""
    pairs = 0
    for qp in range(sq):
        hi = min(sk, qp + 1) if causal else sk
        lo = max(0, qp - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    ops = 4 * b * h * hd * pairs
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * (2 * b * sq * h * hd + 2 * b * sk * kv * hd)
    t_ops = ops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _flash_inputs(torch, b, sq, sk, h, kv, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, sk, kv, hd), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    return q, k, v


def _flash_gate(torch, out, ref, v, l=None):
    """(max|kernel - plain|, the largest |difference| / tolerance, the
    relative L2 difference): the tolerance one bf16 ulp of the larger
    value (bf16 outputs) + FLASH_ATOL_OF_V max|v| + given ``l`` (the
    plain version's, tensor-core kernel) FLASH_P_FLIP max|v| min(1 / l,
    1 - 1 / l) of the row."""
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    vmax = float(v.float().abs().max())
    tol = torch.full_like(diff, FLASH_ATOL_OF_V * vmax)
    if out.dtype == torch.bfloat16:
        big = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
        tol += torch.exp2(torch.floor(torch.log2(big)) - 7)
    if l is not None:
        w = 1.0 / l[..., None]
        tol += FLASH_P_FLIP * vmax * torch.minimum(w, 1.0 - w)
    rel = float(torch.linalg.vector_norm(diff)
                / torch.linalg.vector_norm(b).clamp(min=1e-30))
    return float(diff.max()), float((diff / tol).max()), rel


def _flash_err(torch, out, ref, v, kernel="fma", l=None) -> tuple:
    """_flash_gate's reading after checking it (``l`` for the tensor-core
    kernel, against the plain version with p_dtype=bfloat16)."""
    d, ratio, rel = _flash_gate(torch, out, ref, v, l)
    check(ratio <= 1.0 and rel <= FLASH_REL_L2,
          f"flash kernel [{kernel}] off its plain version: max|d| {d:.3g}, "
          f"{ratio:.3g} of the tolerance, relative L2 {rel:.3g} (limit "
          f"{FLASH_REL_L2:.3g})")
    return d, ratio, rel


def _flash_vs_plain():
    """Each case through the kernel the wrapper chooses (the tensor-core
    one for bf16 at head size 64 / 128 here, else the CUDA-core one; head
    sizes 80 / 256 in phase 20), against
    the plain version with that kernel's p_dtype, reruns bit-identical;
    the CUDA-core kernel also on every bf16 case the tensor-core one
    takes, against the f32-P plain version, as before.  Returns the
    largest |difference| of each kernel."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rbd_step

    cases = [(1, s, s, *heads, True, w, 128)
             for heads in FLASH_HEADS.values() for s in FLASH_LENGTHS
             for w in FLASH_WINDOWS]
    cases.append((2, 200, 456, 14, 2, 64, False, None, 128))  # non-causal
    # batch 2 with a ragged Sk (the rows past Sk of a 128-row box are the
    # hardware's zeros), head size 128 with a window, kv_block 64 with Sk
    # = 150 (Sk_pad 192, not a whole 128-row tile) and rows with no live
    # key, Sq = 1 against 77 keys
    cases += [(2, 300, 200, 14, 2, 64, True, None, 128),
              (1, 512, 512, 4, 2, 128, True, 200, 128),
              (1, 400, 150, 2, 1, 64, True, 50, 64),
              (2, 1, 77, 14, 2, 128, False, None, 128)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, sq, sk, h, kv, hd, causal, window, kvb) in enumerate(
                cases):
            q, k, v = _flash_inputs(torch, b, sq, sk, h, kv, hd, dtype, i)
            kernel = flash.kernel_for(dtype, hd)
            key = f"flash_attention[{kernel}]"
            before = rbd_step.VARIANT_LAUNCHES.get(key, 0)
            kw = dict(causal=causal, window=window, kv_block=kvb)
            out = flash.flash_attention(q, k, v, **kw)
            again = flash.flash_attention(q, k, v, **kw)
            ref, l = flash.flash_attention_plain(
                q, k, v, **kw, p_dtype=flash.P_DTYPE[kernel], return_l=True)
            torch.cuda.synchronize()
            check(rbd_step.VARIANT_LAUNCHES.get(key, 0) == before + 2,
                  f"case {i} ({dtype}) did not run the {kernel} kernel")
            check(torch.equal(out, again),
                  f"flash rerun differs (case {i}, {dtype})")
            got = _flash_err(torch, out, ref, v, kernel,
                             l if kernel == "wgmma" else None)
            name = f"{kernel} {str(dtype).split('.')[-1]}"
            worst[name] = [max(x, y) for x, y in
                           zip(worst.get(name, (0.0,) * 3), got)]
            if kernel == "wgmma":
                out = flash._launch_kernel(q, k, v, kernel="fma", **kw)
                again = flash._launch_kernel(q, k, v, kernel="fma", **kw)
                ref = flash.flash_attention_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                check(torch.equal(out, again),
                      f"fma rerun differs (case {i}, {dtype})")
                got = _flash_err(torch, out, ref, v)
                worst["fma bfloat16"] = [
                    max(x, y) for x, y in
                    zip(worst.get("fma bfloat16", (0.0,) * 3), got)]
    log(f"  kernels vs plain: {2 * len(cases)} cases (heads "
        f"{list(FLASH_HEADS.values())}, Sq = Sk in {FLASH_LENGTHS}, window "
        f"in {FLASH_WINDOWS}, one non-causal 200 x 456, batch 2 ragged, "
        f"hd 128 windowed, kv_block 64 ragged, Sq = 1; f32 and bf16; bf16 "
        f"at hd 64 / 128 through both kernels), reruns bit-identical; "
        f"largest max|d|, share of the tolerance, relative L2: "
        f"{ {k: [float(f'{x:.3g}') for x in w] for k, w in worst.items()} }")
    return {name: w[0] for name, w in worst.items()}


def _prefill_run(cfg, model, torch):
    """Engine.generate on one 8,192-token prompt at full qwen2-0.5b width
    and depth: flash launches, logits against forward, greedy token, the
    prefill timed beside the blockwise function's; returns the launches of
    the main-path prefill."""
    import numpy as np
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rbd_step
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine

    params = model.init(0, device="cuda")
    eng = Engine(model, params, max_len=PREFILL_LEN + PREFILL_NEW)
    cp = eng._cparams
    tokens = np.random.default_rng(16).integers(0, cfg.vocab,
                                                (1, PREFILL_LEN))
    prompt = torch.from_numpy(tokens).cuda()
    name = "flash_attention"
    with torch.no_grad():
        # the main path: the prefill alone, then generate (its prefill and
        # the decode of 32 new tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rbd_step.reset_counts()
        logits, _ = transformer.prefill(cfg, cp, prompt, eng.max_len)
        torch.cuda.synchronize()
        prefill_launches = rbd_step.LAUNCHES[name]
        prefill_variants = dict(rbd_step.VARIANT_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rbd_step.reset_counts()
        out = eng.generate(prompt, PREFILL_NEW).cpu().numpy()[0]
        torch.cuda.synchronize()
        gen_launches = rbd_step.LAUNCHES[name]
        gen_variants = dict(rbd_step.VARIANT_LAUNCHES)
        check(prefill_launches == cfg.n_layers,
              f"the prefill made {prefill_launches} flash launches, "
              f"expected {cfg.n_layers}")
        every_wgmma = {f"{name}[wgmma]": cfg.n_layers}
        check(prefill_variants == every_wgmma and gen_variants == every_wgmma,
              f"the prefill's / generate's launches by kernel "
              f"{prefill_variants} / {gen_variants}, expected {every_wgmma}")
        check(gen_launches == prefill_launches,
              f"generate made {gen_launches} flash launches: "
              f"{gen_launches - prefill_launches} in decode, expected 0")
        check(len(out) == PREFILL_NEW, f"{len(out)} new tokens")
        # the last position against forward (the blockwise function), and
        # the same layers through the plain version against forward: two
        # sound routes, whose distance is the bf16 noise the tolerance
        # rests on
        full, _ = transformer.forward(cfg, params, prompt)
        want = full[0, -1].float()
        del full
        got = logits[0, 0].float()
        xp = transformer._run_prompt(cfg, cp, prompt,
                                     flash.flash_attention_plain)[0]
        sound = transformer._logits(cfg, cp, xp[:, -1:])[0, 0].float()
        del xp
        scale = float(want.abs().max())
        d = float((got - want).abs().max())
        d_sound = float((sound - want).abs().max())
        d_plain = float((got - sound).abs().max())
        top2 = torch.topk(want, 2).values
        margin = float(top2[0] - top2[1])
        tol = PREFILL_LOGIT_RTOL * scale
        log(f"  prefill of {PREFILL_LEN} tokens (bf16, {cfg.n_layers} "
            f"layers): {prefill_launches} flash launches {prefill_variants}"
            f", generate {gen_launches} (decode 0); last-position logits vs "
            f"forward "
            f"max|d| {d:.4g} of max|logits| {scale:.4g} "
            f"({d / scale:.3%}; tolerance {PREFILL_LOGIT_RTOL:.1%}); the "
            f"layers through the plain version vs forward {d_sound:.4g} "
            f"({d_sound / scale:.3%}), vs the kernel's prefill "
            f"{d_plain:.4g} ({d_plain / scale:.3%}); top-1/top-2 margin "
            f"{margin:.4g}; peak {peak:.2f} GiB")
        check(d <= tol, f"prefill logits off forward's by {d:.4g} > "
              f"{tol:.4g}")
        # the routing at a tight limit: the same prefill and forward with
        # f32 compute, where the two routes differ by f32 rounding only
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        l32, cache32 = transformer.prefill(cfg32, params, prompt,
                                           eng.max_len)
        del cache32
        full, _ = transformer.forward(cfg32, params, prompt)
        want32 = full[0, -1]
        del full
        scale32 = float(want32.abs().max())
        d32 = float((l32[0, 0] - want32).abs().max())
        log(f"  f32 compute: prefill's last-position logits vs forward "
            f"max|d| {d32:.4g} of max|logits| {scale32:.4g} "
            f"({d32 / scale32:.3g} of it; tolerance {PREFILL_F32_RTOL:g})")
        check(d32 <= PREFILL_F32_RTOL * scale32,
              f"f32 prefill logits off forward's by {d32:.4g}")
        # the greedy first token is forward's wherever the top-1/top-2
        # margin exceeds the tolerance
        first = int(torch.argmax(want))
        if margin > tol:
            check(int(out[0]) == first,
                  f"first token {int(out[0])} != forward's argmax {first}")
        log(f"  first greedy token {int(out[0])}, forward's argmax {first}"
            f"{'' if margin > tol else ' (margin within tolerance)'}; "
            f"tokens {out[:8].tolist()} ...")
        # the prefill timed beside the same layers through the blockwise
        # function; with the host's time to issue it (close to the
        # events' when the device waits on the host)
        host = []

        def issued():
            t = time.perf_counter()
            transformer.prefill(cfg, cp, prompt, eng.max_len)
            host.append(1e3 * (time.perf_counter() - t))

        t_prefill = cuda_ms(issued, repeat=3)
        t_flash = cuda_ms(lambda: transformer._run_prompt(
            cfg, cp, prompt, flash.flash_attention), repeat=3)
        t_block = cuda_ms(lambda: transformer._run_prompt(
            cfg, cp, prompt, attn.flash_attention), repeat=3)
        log(f"  prefill ms {[round(x, 1) for x in t_prefill]} (issued by "
            f"the host in {[round(x, 1) for x in host]}); the layers "
            f"through the flash kernel {[round(x, 1) for x in t_flash]}, "
            f"through the blockwise function "
            f"{[round(x, 1) for x in t_block]}")
    return prefill_launches


def _flash_planted(torch, flash, q, k, v, ref, l):
    """The tensor-core kernel's gate against two faults planted in its
    inputs, read on the rows past S / 2 against the sound plain output
    ``ref`` (its ``l``): the last K/V tile dropped (K and V cut by 128
    rows: the last 128 rows miss their last tile) and the causal edge one
    key short (q from row 1: row r sees the keys up to r - 1 of its own
    position).  Each must be refused; logs the reading beside that of a
    flat 2**-8 max|v| term in place of the per-row one."""
    half = q.shape[1] // 2
    cut = flash.flash_attention(q, k[:, :-128].contiguous(),
                                v[:, :-128].contiguous())
    short = flash.flash_attention(q[:, 1:].contiguous(), k, v)
    vmax = float(v.float().abs().max())
    want, l = ref[:, half:], l[:, half:]
    for name, got in (("last K/V tile dropped", cut[:, half:]),
                      ("causal edge one key short", short[:, half - 1:])):
        d, ratio, rel = _flash_gate(torch, got, want, v, l)
        a, b = got.float(), want.float()
        big = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
        flat = ((2.0 ** -8 + FLASH_ATOL_OF_V) * vmax
                + torch.exp2(torch.floor(torch.log2(big)) - 7))
        flat_ratio = float(((a - b).abs() / flat).max())
        log(f"  planted fault at S={q.shape[1]}, rows past {half}: {name}: "
            f"max|d| {d:.3g}, {ratio:.3g} of the tolerance, relative L2 "
            f"{rel:.3g} (limit {FLASH_REL_L2:.3g}); a flat 2**-8 max|v| "
            f"would read {flat_ratio:.3g} of its tolerance")
        check(ratio > 1.0 or rel > FLASH_REL_L2,
              f"the flash gate passed a planted fault: {name}")


def _flash_timing():
    """Both kernels alone at qwen2-0.5b's heads, B = 1, causal: at each
    timed length (bf16) the tensor-core kernel (the wrapper's choice), the
    CUDA-core kernel and the library call, in turns (cuda-core,
    tensor-core, library, library, tensor-core, cuda-core; each the
    median of 3 bursts of FLASH_BURST back-to-back launches, so the
    host's time per call hides behind the device's), each kernel held
    against the plain version with its p_dtype there (reruns
    bit-identical), the plain version timed at 8,192, where the
    tensor-core kernel's gate must refuse the planted faults of
    _flash_planted; the CUDA-core kernel in f32 at 8,192 as before.
    Returns both kernels' rows at 8,192 bf16
    and their largest |kernel - plain|."""
    import torch
    from repro_torch.kernels import flash_attention as flash

    h, kv, hd = FLASH_HEADS["qwen2-0.5b"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, worst = {}, {"wgmma": 0.0, "fma": 0.0}
    timed = [(s, torch.bfloat16) for s in FLASH_TIMED]
    timed.append((PREFILL_LEN, torch.float32))
    with torch.no_grad():
        for s, dtype in timed:
            key = str(dtype).split(".")[-1]
            q, k, v = _flash_inputs(torch, 1, s, s, h, kv, hd, dtype, s)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            runs = {"fma": lambda: flash._launch_kernel(q, k, v,
                                                        kernel="fma"),
                    "library": lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)}
            kernels = ["fma"]
            if dtype == torch.bfloat16:
                runs["wgmma"] = lambda: flash.flash_attention(q, k, v)
                kernels.append("wgmma")
                order = ("fma", "wgmma", "library", "library", "wgmma",
                         "fma")
            else:
                order = ("fma", "library", "library", "fma")
            times = {name: [] for name in runs}
            reps = FLASH_BURST.get((s, key), 1)
            for name in order:
                runs[name]()                       # warm
                burst = cuda_ms(lambda: [runs[name]() for _ in range(reps)],
                                repeat=3)
                times[name].append(sorted(burst)[1] / reps)
            ms = {name: sum(t) / len(t) for name, t in times.items()}
            b_ms, by = flash_bound_ms(1, s, s, h, kv, hd, key)
            # each kernel against its plain version at every timed length
            # (the prefill's 8,192 included), reruns bit-identical
            errs, plain_ms, lib_err = {}, {}, None
            for kernel in kernels:
                out, again = runs[kernel](), runs[kernel]()
                p_dtype = flash.P_DTYPE[kernel]
                ref, l = flash.flash_attention_plain(q, k, v, p_dtype=p_dtype,
                                                     return_l=True)
                torch.cuda.synchronize()
                check(torch.equal(out, again),
                      f"flash [{kernel}] rerun differs (S={s}, {key})")
                errs[kernel] = _flash_err(torch, out, ref, v, kernel,
                                          l if kernel == "wgmma" else None)
                worst[kernel] = max(worst[kernel], errs[kernel][0])
                if s == PREFILL_LEN:
                    plain_ms[kernel] = cuda_ms(
                        lambda: flash.flash_attention_plain(
                            q, k, v, p_dtype=p_dtype))[0]
                    if kernel == "fma":
                        lib_err = float((runs["library"]().transpose(1, 2)
                                         .float() - ref.float()).abs().max())
                    elif key == "bfloat16":
                        _flash_planted(torch, flash, q, k, v, ref, l)
                del out, again, ref, l
            for kernel in kernels:
                if s == PREFILL_LEN and dtype == torch.bfloat16:
                    rows[kernel] = {"ms": ms[kernel],
                                    "plain_ms": plain_ms[kernel],
                                    "bound_ms": b_ms, "bound_by": by,
                                    "library_ms": ms["library"]}
                turns = [round(t, 4) for t in times[kernel]]
                extra = (f", plain {plain_ms[kernel]:.1f} ms"
                         if kernel in plain_ms else "")
                d, ratio, rel = errs[kernel]
                log(f"  flash [{kernel}] {key} S={s}: {ms[kernel]:.4f} ms "
                    f"(turns {turns}), library sdpa {ms['library']:.4f} ms "
                    f"(turns {[round(t, 4) for t in times['library']]}), "
                    f"bound {b_ms:.4f} ({by}), {b_ms / ms[kernel]:.2%} of "
                    f"bound; vs plain max|d| {d:.3g} ({ratio:.3g} of the "
                    f"tolerance, relative L2 {rel:.3g}), rerun "
                    f"bit-identical{extra}")
            if lib_err is not None:
                log(f"  library (sdpa) {key} S={s} max|d| vs the f32-P "
                    f"plain version {lib_err:.3g}")
            del q, k, v, qt, kt, vt, runs
    return rows, worst


def flash_instances(lib_path, log_text) -> dict:
    """The tensor-core kernel's instances in the flash library, by head
    size: their SASS (``cuobjdump -sass``, left in
    ``build/repro_torch/flash_attention.sass``) counts of HGMMA (wgmma),
    UTMALDG (TMA loads), MUFU.EX2, BAR.SYNC and local-memory traffic, the
    highest register the SASS names (the consumers run past the launch
    bound's count after setmaxnreg), and ptxas's report of the build
    (registers, spill stores and loads)."""
    import re

    from repro_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    (build.BUILD_DIR / "flash_attention.sass").write_text(sass)
    found = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        hit = re.search(r"flash_wgmma_kernelILi(\d+)E", name)
        if hit is None:
            continue
        counts = {op: fn.count(op) for op in
                  ("HGMMA", "UTMALDG", "MUFU.EX2", "BAR.SYNC", "STL", "LDL")}
        top = max(int(r) for r in re.findall(r"\bR(\d+)\b", fn))
        found[int(hit.group(1))] = {"name": name, "sass": counts,
                                    "max_register": top}
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        hit = re.search(r"flash_wgmma_kernelILi(\d+)E", line)
        if "Compiling entry function" in line and hit:
            found.setdefault(int(hit.group(1)), {})["ptxas"] = " ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 2: i + 4])
    return found


def _log_instance(hd, inst) -> None:
    """Logs one tensor-core instance (flash_instances) and checks that its
    SASS holds HGMMA and UTMALDG and that ptxas spilled nothing."""
    import re

    counts = inst["sass"]
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
          f"flash_wgmma_kernel<{hd}>: no HGMMA or UTMALDG in its SASS "
          f"({counts})")
    # an empty report is a build reused from an earlier run (no ptxas
    # output); its SASS has no local-memory traffic either way
    report = inst.get("ptxas", "")
    check(counts["STL"] == 0 and counts["LDL"] == 0
          and (not report or re.search(
              r"(^|[^0-9])0 bytes spill stores, 0 bytes spill loads",
              report)),
          f"flash_wgmma_kernel<{hd}> spills: {report} {counts}")
    log(f"  flash_wgmma_kernel<{hd}>: SASS {counts}, highest register "
        f"R{inst['max_register']}; ptxas: {report or 'build reused'}")


def flash_sass(lib_path, log_text):
    """The tensor-core kernel's four instances (head size 64, 80, 128 and
    256): each must hold HGMMA and UTMALDG and spill nothing; logs
    flash_instances' reading of each."""
    found = flash_instances(lib_path, log_text)
    check(sorted(found) == [64, 80, 128, 256],
          f"tensor-core flash instances at head sizes {sorted(found)}, "
          "expected 64, 80, 128 and 256")
    for hd, inst in sorted(found.items()):
        _log_instance(hd, inst)


def phase_prefill():
    """Returns the kernels line's row of the flash kernel (the tensor-core
    one, which the prefill runs); logs the CUDA-core kernel's row."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import rbd_step
    from repro_torch.models.registry import get_model

    gc.collect()
    torch.cuda.empty_cache()
    log("== phase 16: long-prompt prefill through the flash kernel "
        "(qwen2-0.5b, full width and depth, bf16)")
    built = rbd_step.library(rbd_step.FLASH_SOURCE)
    flash_sass(built.path, built.log)
    errs = _flash_vs_plain()
    cfg = get_config("qwen2-0.5b")
    launches = _prefill_run(cfg, get_model(cfg), torch)
    gc.collect()
    torch.cuda.empty_cache()
    rows, timed = _flash_timing()
    fma_err = max(v for k, v in errs.items() if k.startswith("fma"))
    old = {"name": "flash_attention[fma]", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": REPLACES["flash_attention"], "launches": 0,
           "max_abs_err": max(fma_err, timed["fma"]), **rows["fma"]}
    log(f"  the CUDA-core kernel's row (f32; bf16 at head size 16 / 32; "
        f"bf16 at 64 here for comparison, no main-path launch): "
        f"{json.dumps(old)}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_wgmma.cuh",
            "replaces": REPLACES["flash_attention"], "launches": launches,
            "max_abs_err": max(errs["wgmma bfloat16"], timed["wgmma"]),
            **rows["wgmma"]}


# ---------------------------------------------------------------------------
# phase 17: the tile-keyed PRNG path (--prng-impl hw | hw_emulated) and the
# two-slot schedule
# ---------------------------------------------------------------------------

TILE_KEYED = ("hw_emulated", "hw")
# the kernels that take double_buffer (rows 1-3 and 5-7)
BUFFERED = ("project_packed", "reconstruct_apply_packed",
            "reconstruct_apply_packed_workers", "project_packed_sharded",
            "reconstruct_apply_packed_sharded",
            "reconstruct_apply_packed_workers_sharded")
# timed at full width: (label, prng, double_buffer)
PRNG_TIMED = (("threefry", "threefry", False),
              ("hw_emulated", "hw_emulated", False),
              ("hw", "hw", False), ("hw,db", "hw", True),
              ("hw_emulated,db", "hw_emulated", True))
PRNG_TIMED_REPS = 2     # launches of each config per pass, two passes
# the TPU kernel parts each tile-keyed row replaces
PRNG_REPLACES = {
    "hw": "src/repro/core/rng.py:348",
    "hw,db": "src/repro/core/rng.py:348 (_hw_tile) + "
             "src/repro/kernels/rbd_step.py:68 (_buffered_tile)",
    "hw_emulated": "src/repro/core/rng.py:340",
}


def _run_launcher_with_prng(impl):
    """The launcher's sharedseed packed step at full width and depth under
    ``--prng-impl impl``: its prng line and its prng kernels line, 2
    launches a step (the variant the auto double-buffer rule picks on a
    card: unbuffered), finite losses.  Returns (the run's per-launch
    kernel ms, its variant launch counts)."""
    import contextlib
    import io

    from repro_torch.core import rng
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import train as launcher

    args = ARCH_ARGS + ["--prng-impl", impl]
    log("  python -m repro_torch.launch.train " + " ".join(args))
    buf = io.StringIO()
    rbd_step.reset_counts()
    with contextlib.redirect_stdout(buf):
        res = launcher.main(args)
    launches = dict(rbd_step.VARIANT_LAUNCHES)
    for line in buf.getvalue().splitlines():
        log("    " + line)
    _, why = rng.resolve_prng_impl(impl, strategy="fused_packed",
                                   backend="cuda", hw_available=True)
    check(f"prng impl: {impl} -- {why}" in buf.getvalue().splitlines(),
          f"--prng-impl {impl}: no 'prng impl: {impl}' line")
    db = rbd_step.resolve_double_buffer(None, impl, "cuda")
    want = {rbd_step.variant_name("project_packed", impl, db): STEPS,
            rbd_step.variant_name("reconstruct_apply_packed", impl, db):
                STEPS}
    check(any(line.startswith("prng kernels: " + ", ".join(want))
              for line in buf.getvalue().splitlines()),
          f"--prng-impl {impl}: no 'prng kernels: {', '.join(want)}' line")
    check(launches == want, f"--prng-impl {impl}: launches {launches}, "
          f"expected {want}")
    check(all(math.isfinite(x) for x in res.losses),
          f"--prng-impl {impl}: losses {res.losses}")
    log(f"  --prng-impl {impl}: launches {launches}, losses "
        f"{[round(x, 4) for x in res.losses]}")
    return res.kernel_ms, launches


def _prng_kernels_vs_plain(full_plan):
    """Rows 1-10 under each tile-keyed impl against their plain versions
    on phase 3's full-width layer (and rows 1-2 on embed's first
    dir-block under hw), rows 1-2 under hw both buffered (the auto rule)
    and unbuffered; the double buffer bit-identical on rows 1-3 and 5-7
    under all three impls.  Returns {(kernel, label): max|err|}, the
    label that of a PRNG_TIMED config ("hw,db" for hw's auto rule)."""
    import torch
    from repro_torch.core import compartments, projector, rng
    from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step

    errs = {}

    def note(name, impl, err, label=None):
        key = (name, label or impl)   # the auto rule: unbuffered on a card
        errs[key] = max(errs.get(key, 0.0), err)

    gen = torch.Generator(device="cuda").manual_seed(17)
    subs = _sub_plans(full_plan)
    for case, sub in subs.items():
        lay = sub.packed()
        valid = _valid_mask(lay, "cuda")
        cvalid = torch.from_numpy(lay.coord_valid).cuda()
        seeds = projector.segment_seeds(sub, rng.fold_seed(0, 17))
        wseeds = projector.worker_segment_seeds(sub, rng.fold_seed(0, 17), 2)
        layer = case.startswith("layer")
        for impl in (TILE_KEYED if layer else ("hw",)):
            for dist in (DISTS if layer else ("normal",)):
                tag = f"{case}/{impl}/{dist}"
                g = torch.where(valid, torch.randn(
                    lay.q_packed, generator=gen, device="cuda"), 0.0)
                theta = torch.where(valid, torch.randn(
                    lay.q_packed, generator=gen, device="cuda"), 0.0)
                scale = torch.randn((2, lay.d_packed), generator=gen,
                                    device="cuda") * 1e-3 * cvalid
                u, sq = rbd_step.project_packed(seeds, g, lay, dist,
                                                prng=impl)
                up, sqp = rbd_step.project_packed_plain(seeds, g, lay, dist,
                                                        prng=impl)
                note("project_packed", impl,
                     _check_project(tag, u, sq, up, sqp, g, lay))
                out = rbd_step.reconstruct_apply_packed(
                    seeds, scale[0], theta, lay, dist, prng=impl)
                ref = rbd_step.reconstruct_apply_packed_plain(
                    seeds, scale[0], theta, lay, dist, prng=impl)
                check(bool((out[~valid] == 0).all()),
                      f"{tag}: padding of theta is not exactly 0")
                note("reconstruct_apply_packed", impl,
                     _check_apply(tag, out, ref, theta))
                if impl == "hw":
                    # the buffered kernels against the same plain
                    u1, sq1 = rbd_step.project_packed(
                        seeds, g, lay, dist, prng=impl, double_buffer=True)
                    note("project_packed", impl, _check_project(
                        f"{tag} buffered", u1, sq1, up, sqp, g, lay),
                        "hw,db")
                    note("reconstruct_apply_packed", impl, _check_apply(
                        f"{tag} buffered",
                        rbd_step.reconstruct_apply_packed(
                            seeds, scale[0], theta, lay, dist, prng=impl,
                            double_buffer=True), ref, theta), "hw,db")
                    del u1, sq1
                if not layer or dist != "normal":
                    continue
                w = rbd_step.reconstruct_apply_packed_workers(
                    wseeds, scale, theta, lay, dist, prng=impl)
                wp = rbd_step.reconstruct_apply_packed_workers_plain(
                    wseeds, scale, theta, lay, dist, prng=impl)
                note("reconstruct_apply_packed_workers", impl,
                     _check_apply(f"{tag} K=2", w, wp, theta))
                a = rbd_step.reconstruct_apply_packed_adapters(
                    wseeds, scale, theta, lay, dist, prng=impl)
                check(torch.equal(a[0], rbd_step.reconstruct_apply_packed(
                    wseeds[:lay.n_segments], scale[0], theta, lay, dist,
                    prng=impl, double_buffer=False)),
                      f"{tag}: adapter row 0 differs from the single apply")
                ap = rbd_step.reconstruct_apply_packed_adapters_plain(
                    wseeds, scale, theta, lay, dist, prng=impl)
                note("reconstruct_apply_packed_adapters", impl, max(
                    _check_apply(f"{tag} B=2 row {i}", a[i], ap[i], theta)
                    for i in range(2)))
                del a, ap
                sl = compartments.sharded_packed_layout(lay, 2)
                pad = sl.q_padded - lay.q_packed
                gp = torch.cat([g, g.new_zeros(pad)])
                tp = torch.cat([theta, theta.new_zeros(pad)])
                outp = torch.cat([out, out.new_zeros(pad)])
                wp = torch.cat([w, w.new_zeros(pad)])
                us = 0
                for shard in range(2):
                    lo, hi = sl.slab_range(shard)
                    su, ssq = rbd_step.project_packed_sharded(
                        seeds, gp[lo:hi].contiguous(), sl, shard, dist,
                        prng=impl)
                    spu, spsq = rbd_step.project_packed_sharded_plain(
                        seeds, gp[lo:hi].contiguous(), sl, shard, dist,
                        prng=impl)
                    du = float((su - spu).abs().max())
                    check(du <= U_RTOL * float(up.abs().max()) + 1e-6,
                          f"{tag}: shard {shard} partial off by {du}")
                    note("project_packed_sharded", impl, du)
                    us = us + su
                    so = rbd_step.reconstruct_apply_packed_sharded(
                        seeds, scale[0], tp[lo:hi].contiguous(), sl, shard,
                        dist, prng=impl)
                    check(torch.equal(so, outp[lo:hi]),
                          f"{tag}: slab {shard} apply is not the slice")
                    sw = rbd_step.reconstruct_apply_packed_workers_sharded(
                        wseeds, scale, tp[lo:hi].contiguous(), sl, shard,
                        dist, prng=impl)
                    check(torch.equal(sw, wp[lo:hi]),
                          f"{tag}: slab {shard} K=2 apply is not the slice")
                    note("reconstruct_apply_packed_sharded", impl, 0.0)
                    note("reconstruct_apply_packed_workers_sharded", impl,
                         0.0)
                _check_project(f"{tag} m=2 sum", us, sq, up, sqp, g, lay)
                log(f"    {tag}: K=2 apply, B=2 adapters (row 0 = the "
                    "single apply), m=2 slabs (applies = slices) vs plain")
                del w, gp, tp, outp, wp
    # rows 8-10: the per-leaf kernels under the tile-keyed impls (the
    # kernel flag; no route resolves them), one stacked leaf
    lp = next(lp for lp in full_plan.leaves if lp.stacked)
    fseeds = projector._leaf_seeds(rng.fold_seed(0, 17), lp)[:2]
    for impl in TILE_KEYED:
        tag = f"{lp.name}[2 layers]/{impl}"
        fg = torch.randn((2, lp.size), generator=gen, device="cuda")
        fu, fsq = rbd_project.project_flat(fseeds, fg, lp.dim, "normal",
                                           prng=impl)
        fup, fsqp = rbd_project.project_flat_plain(fseeds, fg, lp.dim,
                                                   "normal", prng=impl)
        note("project_flat", impl,
             _check_flat_project(tag, fu, fsq, fup, fsqp, fg))
        fsc = torch.randn((2, lp.dim), generator=gen, device="cuda") * 1e-3
        note("reconstruct_flat", impl, _check_delta(
            tag, rbd_reconstruct.reconstruct_flat(fseeds, fsc, lp.size,
                                                  "normal", prng=impl),
            rbd_reconstruct.reconstruct_flat_plain(fseeds, fsc, lp.size,
                                                   "normal", prng=impl)))
        fth = torch.randn((2, lp.size), generator=gen, device="cuda")
        note("reconstruct_apply_flat", impl, _check_apply(
            tag, rbd_reconstruct.reconstruct_apply_flat(
                fseeds, fsc, fth, 0.125, "normal", prng=impl),
            rbd_reconstruct.reconstruct_apply_flat_plain(
                fseeds, fsc, fth, 0.125, "normal", prng=impl), fth))
    # the double buffer: on and off give the same bits, every impl
    sub = subs["layer0+final_norm"]
    lay = sub.packed()
    sl = compartments.sharded_packed_layout(lay, 2)
    valid = _valid_mask(lay, "cuda")
    seeds = projector.segment_seeds(sub, rng.fold_seed(1, 17))
    wseeds = projector.worker_segment_seeds(sub, rng.fold_seed(1, 17), 2)
    g = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                       device="cuda"), 0.0)
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device="cuda"), 0.0)
    scale = torch.randn((2, lay.d_packed), generator=gen, device="cuda") \
        * 1e-3 * torch.from_numpy(lay.coord_valid).cuda()
    gs = torch.cat([g, g.new_zeros(sl.q_padded - lay.q_packed)])
    ts = torch.cat([theta, theta.new_zeros(sl.q_padded - lay.q_packed)])
    calls = {
        "project_packed": lambda p, d: rbd_step.project_packed(
            seeds, g, lay, "normal", prng=p, double_buffer=d),
        "reconstruct_apply_packed": lambda p, d:
            rbd_step.reconstruct_apply_packed(
                seeds, scale[0], theta, lay, "normal", prng=p,
                double_buffer=d),
        "reconstruct_apply_packed_workers": lambda p, d:
            rbd_step.reconstruct_apply_packed_workers(
                wseeds, scale, theta, lay, "normal", prng=p,
                double_buffer=d),
    }
    for shard in range(2):
        lo, hi = sl.slab_range(shard)
        calls[f"project_packed_sharded/{shard}"] = (
            lambda p, d, lo=lo, hi=hi, shard=shard:
            rbd_step.project_packed_sharded(
                seeds, gs[lo:hi].contiguous(), sl, shard, "normal", prng=p,
                double_buffer=d))
        calls[f"reconstruct_apply_packed_sharded/{shard}"] = (
            lambda p, d, lo=lo, hi=hi, shard=shard:
            rbd_step.reconstruct_apply_packed_sharded(
                seeds, scale[0], ts[lo:hi].contiguous(), sl, shard,
                "normal", prng=p, double_buffer=d))
        calls[f"reconstruct_apply_packed_workers_sharded/{shard}"] = (
            lambda p, d, lo=lo, hi=hi, shard=shard:
            rbd_step.reconstruct_apply_packed_workers_sharded(
                wseeds, scale, ts[lo:hi].contiguous(), sl, shard, "normal",
                prng=p, double_buffer=d))
    for impl in ("threefry",) + TILE_KEYED:
        for name, fn in calls.items():
            off, on = fn(impl, False), fn(impl, True)
            off = off if isinstance(off, tuple) else (off,)
            on = on if isinstance(on, tuple) else (on,)
            check(all(torch.equal(a, b) for a, b in zip(off, on)),
                  f"{name}/{impl}: double_buffer on and off differ")
        log(f"  {impl}: double_buffer on and off bit-identical on "
            f"{', '.join(calls)}")
    return errs


def _prng_timing(full_plan):
    """project_packed and reconstruct_apply_packed at full width under
    each PRNG_TIMED config, in turns (configs in order, then reversed);
    then each tile-keyed plain version once at the full shapes, held
    against its kernel (under hw both the buffered and the unbuffered
    kernel against the one plain output).  Returns ({(kernel, label):
    [ms]}, {(kernel, impl): plain ms}, {(kernel, label): max|err|})."""
    import torch
    from repro_torch.core import projector, rng
    from repro_torch.kernels import rbd_step

    lay = full_plan.packed()
    seeds = projector.segment_seeds(full_plan, rng.fold_seed(0, 17))
    gen = torch.Generator(device="cuda").manual_seed(170)
    valid = _valid_mask(lay, "cuda")
    g = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                       device="cuda"), 0.0)
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device="cuda"), 0.0)
    scale = torch.randn(lay.d_packed, generator=gen, device="cuda") * 1e-4
    scale = scale * torch.from_numpy(lay.coord_valid).cuda()
    dist = full_plan.distribution
    fns = {
        "project_packed": lambda p, d: rbd_step.project_packed(
            seeds, g, lay, dist, prng=p, double_buffer=d),
        "reconstruct_apply_packed": lambda p, d:
            rbd_step.reconstruct_apply_packed(
                seeds, scale, theta, lay, dist, prng=p, double_buffer=d),
    }
    times = {}
    for order in (PRNG_TIMED, PRNG_TIMED[::-1]):
        for label, impl, db in order:
            for name, fn in fns.items():
                times.setdefault((name, label), []).extend(
                    cuda_ms(lambda: fn(impl, db), PRNG_TIMED_REPS))
    for (name, label), ms in times.items():
        log(f"  {name}[{label}]: ms {[round(x, 3) for x in ms]}")
    plain_ms, errs = {}, {}
    for impl in TILE_KEYED:
        # the configs of PRNG_TIMED's rows: (label, double_buffer)
        dbs = ((("hw", False), ("hw,db", True)) if impl == "hw"
               else ((impl, False),))
        plain = {}
        plain_ms[("project_packed", impl)] = cuda_ms(lambda: plain.update(
            proj=rbd_step.project_packed_plain(seeds, g, lay, dist,
                                               prng=impl)))[0]
        for label, db in dbs:
            u, sq = fns["project_packed"](impl, db)
            errs[("project_packed", label)] = _check_project(
                f"full width/{label}", u, sq, *plain["proj"], g, lay)
            del u, sq
        del plain["proj"]
        plain_ms[("reconstruct_apply_packed", impl)] = cuda_ms(
            lambda: plain.update(
                apply=rbd_step.reconstruct_apply_packed_plain(
                    seeds, scale, theta, lay, dist, prng=impl)))[0]
        for label, db in dbs:
            errs[("reconstruct_apply_packed", label)] = _check_apply(
                f"full width/{label}",
                fns["reconstruct_apply_packed"](impl, db), plain["apply"],
                theta)
        del plain["apply"]
        log(f"  plain at full shapes, {impl}: project "
            f"{plain_ms[('project_packed', impl)]:.1f} ms, apply "
            f"{plain_ms[('reconstruct_apply_packed', impl)]:.1f} ms")
    return times, plain_ms, errs


def _drive_buffered_hw(full_plan):
    """The packed step's two launches through the kernel wrappers with
    ``prng="hw", double_buffer=True`` (the reference's auto rule for hw;
    on a card the port's auto rule takes the unbuffered kernels), STEPS
    times at full width: the [hw,db] rows' path.  Returns ({kernel: ms
    list}, variant launch counts)."""
    import torch
    from repro_torch.core import projector, rng
    from repro_torch.kernels import rbd_step

    lay = full_plan.packed()
    gen = torch.Generator(device="cuda").manual_seed(171)
    valid = _valid_mask(lay, "cuda")
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device="cuda"), 0.0)
    cvalid = torch.from_numpy(lay.coord_valid).cuda()
    dist = full_plan.distribution
    ms = {"project_packed": [], "reconstruct_apply_packed": []}
    rbd_step.reset_counts()
    for step in range(STEPS):
        seeds = projector.segment_seeds(full_plan, rng.fold_seed(0, step))
        g = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device="cuda"), 0.0)
        res = {}
        ms["project_packed"] += cuda_ms(lambda: res.update(
            u=rbd_step.project_packed(seeds, g, lay, dist, prng="hw",
                                      double_buffer=True)))
        u, sq = res["u"]
        scale = u * cvalid * 1e-6
        ms["reconstruct_apply_packed"] += cuda_ms(
            lambda: rbd_step.reconstruct_apply_packed(
                seeds, scale, theta, lay, dist, out=theta, prng="hw",
                double_buffer=True))
        check(bool(torch.isfinite(theta).all()), "buffered hw step: theta "
              "is not finite")
    launches = dict(rbd_step.VARIANT_LAUNCHES)
    check(launches == {"project_packed[hw,db]": STEPS,
                       "reconstruct_apply_packed[hw,db]": STEPS},
          f"buffered hw drive: launches {launches}")
    return ms, launches


def phase_prng(full_plan, dev):
    log("== phase 17: the tile-keyed PRNG path (--prng-impl hw | "
        "hw_emulated) and the double buffer, qwen2-0.5b full width and "
        "depth")
    runs = {impl: _run_launcher_with_prng(impl) for impl in TILE_KEYED}
    db_ms, db_launches = _drive_buffered_hw(full_plan)
    errs = _prng_kernels_vs_plain(full_plan)
    times, plain_ms, full_errs = _prng_timing(full_plan)
    lay = full_plan.packed()
    dist = full_plan.distribution
    rows = []
    for label, impl in (("hw_emulated", "hw_emulated"), ("hw,db", "hw"),
                        ("hw", "hw")):
        for name in ("project_packed", "reconstruct_apply_packed"):
            variant = f"{name}[{label}]"
            if label == "hw,db":
                launches, ms_list = db_launches[variant], db_ms[name]
            else:
                kernel_ms, launch = runs[impl]
                launches, ms_list = launch[variant], kernel_ms[name]
            ms = sorted(ms_list)[len(ms_list) // 2]
            b_ms, by = bound_ms(name, lay, dist, dev, prng=impl)
            # the error of the variant the row times, on the sub-plans
            # and at full width
            err = max(errs[(name, label)], full_errs[(name, label)])
            log(f"  {variant}: launches {launches}, ms {ms:.3f} (median), "
                f"plain {plain_ms[(name, impl)]:.1f}, bound {b_ms:.3f} "
                f"({by}), {b_ms / ms:.1%} of bound")
            rows.append({
                "name": variant, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rbd_step.cu",
                "replaces": PRNG_REPLACES[label], "launches": launches,
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms[(name, impl)], "bound_ms": b_ms,
                "bound_by": by, "library_ms": None})
    for (name, label), err in sorted(errs.items()):
        log(f"  {name}[{label}] vs plain: max|err| {err:.3g}")
    return rows


# ---------------------------------------------------------------------------
# --base DIR: rows 1-10 of this tree against another tree's kernels
# ---------------------------------------------------------------------------

AB_IMPLS = ("threefry", "hw_emulated", "hw")
AB_K = 2           # workers of row 3 and 7, adapters of row 4
AB_TURNS = ("base", "this", "this", "base")
# the prefill timed in both trees: phase 20's gemma3 drive (arch, depth,
# prompt length)
AB_PREFILL = ("gemma3-4b", 6, 2048)


def _ab_cases(full_plan):
    """{(kernel, impl, double_buffer): fn returning its outputs} at full
    width: rows 1-4 on the packed layout, 5-7 on shard 0 of m = 2 (the
    slab holding embed), 8-10 over the plan's 14 leaves; the inputs made
    once from seeds on the card."""
    import torch
    from repro_torch.core import compartments, projector, rng
    from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step

    lay = full_plan.packed()
    gen = torch.Generator(device="cuda").manual_seed(190)
    valid = _valid_mask(lay, "cuda")
    seeds = projector.segment_seeds(full_plan, rng.fold_seed(0, 19))
    wseeds = projector.worker_segment_seeds(full_plan, rng.fold_seed(0, 19),
                                            AB_K)
    g = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                       device="cuda"), 0.0)
    theta = torch.where(valid, torch.randn(lay.q_packed, generator=gen,
                                           device="cuda"), 0.0)
    cvalid = torch.from_numpy(lay.coord_valid).cuda()
    scale = torch.randn((AB_K, lay.d_packed), generator=gen,
                        device="cuda") * 1e-4 * cvalid
    sl = compartments.sharded_packed_layout(lay, 2)
    lo, hi = sl.slab_range(0)
    g_slab, t_slab = g[lo:hi].contiguous(), theta[lo:hi].contiguous()
    leaves = full_plan.leaves
    fseeds = [projector._leaf_seeds(rng.fold_seed(0, 19), lp)
              for lp in leaves]
    fg = [torch.randn((lp.n_stack, lp.size), generator=gen, device="cuda")
          for lp in leaves]
    fsc = [torch.randn((lp.n_stack, lp.dim), generator=gen, device="cuda")
           * 1e-4 for lp in leaves]
    dist = full_plan.distribution
    buffered = {
        "project_packed": lambda p, d: rbd_step.project_packed(
            seeds, g, lay, dist, prng=p, double_buffer=d),
        "reconstruct_apply_packed": lambda p, d:
            rbd_step.reconstruct_apply_packed(
                seeds, scale[0], theta, lay, dist, prng=p, double_buffer=d),
        "reconstruct_apply_packed_workers": lambda p, d:
            rbd_step.reconstruct_apply_packed_workers(
                wseeds, scale, theta, lay, dist, prng=p, double_buffer=d),
        "project_packed_sharded": lambda p, d:
            rbd_step.project_packed_sharded(seeds, g_slab, sl, 0, dist,
                                            prng=p, double_buffer=d),
        "reconstruct_apply_packed_sharded": lambda p, d:
            rbd_step.reconstruct_apply_packed_sharded(
                seeds, scale[0], t_slab, sl, 0, dist, prng=p,
                double_buffer=d),
        "reconstruct_apply_packed_workers_sharded": lambda p, d:
            rbd_step.reconstruct_apply_packed_workers_sharded(
                wseeds, scale, t_slab, sl, 0, dist, prng=p,
                double_buffer=d),
    }
    unbuffered = {
        "reconstruct_apply_packed_adapters": lambda p:
            rbd_step.reconstruct_apply_packed_adapters(
                wseeds, scale, theta, lay, dist, prng=p),
        "project_flat": lambda p: [
            rbd_project.project_flat(s, x, lp.dim, dist, prng=p)
            for s, x, lp in zip(fseeds, fg, leaves)],
        "reconstruct_flat": lambda p: [
            rbd_reconstruct.reconstruct_flat(s, c, lp.size, dist, prng=p)
            for s, c, lp in zip(fseeds, fsc, leaves)],
        "reconstruct_apply_flat": lambda p: [
            rbd_reconstruct.reconstruct_apply_flat(s, c, x, 0.5, dist,
                                                   prng=p)
            for s, c, x in zip(fseeds, fsc, fg)],
    }
    cases = {}
    for impl in AB_IMPLS:
        for db in ((False, True) if impl == "hw" else (False,)):
            for name, fn in buffered.items():
                cases[(name, impl, db)] = functools.partial(fn, impl, db)
        for name, fn in unbuffered.items():
            cases[(name, impl, False)] = functools.partial(fn, impl)
    return cases


def _ab_prefill(base, csrc, smi) -> dict:
    """gemma3-4b's bf16 prefill at phase 20's size (AB_PREFILL: depth 6,
    one 2,048-token prompt, random weights from seed 0) through each
    tree's flash wrapper (DIR's ``kernels/flash_attention.py``, loaded
    from its file) and kernels, timed in turns (AB_TURNS, 3 a turn); each
    tree's flash launches by kernel and the two trees' last-position
    logits apart are logged (their kernels round P at other points: not
    bit for bit).  Returns the medians."""
    import importlib.util

    import numpy as np
    import torch
    from repro_torch.kernels import rbd_step
    from repro_torch.models import layers, transformer
    from repro_torch.models.registry import get_model

    arch, depth, prompt_len = AB_PREFILL
    spec = importlib.util.spec_from_file_location(
        "base_flash_attention", os.path.join(
            base, "src", "repro_torch", "kernels", "flash_attention.py"))
    base_flash = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base_flash)
    this_flash = transformer.flash

    @contextlib.contextmanager
    def base_tree():
        with rbd_step.kernels_from(csrc):
            transformer.flash = base_flash
            try:
                yield
            finally:
                transformer.flash = this_flash

    trees = {"this": contextlib.nullcontext, "base": base_tree}
    cfg = _zoo_config(arch, depth)
    params = layers.cast_for_compute(get_model(cfg).init(0, device="cuda"),
                                     layers.dtype_of(cfg.compute_dtype))
    tokens = np.random.default_rng(20).integers(0, cfg.vocab,
                                                (1, prompt_len))
    prompt = torch.from_numpy(tokens).cuda()

    def run():
        return transformer.prefill(cfg, params, prompt, prompt_len)[0]

    logits, launches, times = {}, {}, {}
    with torch.no_grad():
        for tree in ("base", "this"):
            with trees[tree]():
                rbd_step.reset_counts()
                logits[tree] = run()[0, 0].float()
                torch.cuda.synchronize()
                launches[tree] = dict(rbd_step.VARIANT_LAUNCHES)
        for tree in AB_TURNS:
            with trees[tree]():
                times.setdefault(tree, []).extend(cuda_ms(run, repeat=3))
    scale = float(logits["this"].abs().max())
    d = float((logits["this"] - logits["base"]).abs().max())
    med = {tree: statistics.median(t) for tree, t in times.items()}
    log(f"  {arch} depth {depth} bf16 prefill of {prompt_len} tokens: base "
        f"{med['base']:.3f} ms ({launches['base']}), this {med['this']:.3f} "
        f"ms ({launches['this']}), this/base "
        f"{med['this'] / med['base']:.4f} (turns "
        f"{ {t: [round(x, 3) for x in v] for t, v in times.items()} }); "
        f"last-position logits apart max|d| {d:.4g} of {scale:.4g} "
        f"({d / scale:.3%}) [{smi}]")
    return {"arch": arch, "base_ms": med["base"], "this_ms": med["this"],
            "ratio": med["this"] / med["base"]}


def _tensors(out) -> list:
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return [out]


def ab_against(base: str) -> int:
    """``--base DIR``: the A/B described in the module docstring; returns
    the exit code."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig
    from repro_torch.kernels import build, rbd_step
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    csrc = os.path.join(os.path.abspath(base), "src", "repro_torch",
                        "kernels", "csrc")
    check(os.path.isdir(csrc), f"--base {base}: no {csrc}")
    smi = nvidia_smi("name,power.limit")
    log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    sources = (rbd_step.SOURCE, rbd_step.FLAT_SOURCE, rbd_step.FLASH_SOURCE)
    started = {}   # one nvcc per distinct source: equal files share a build
    for tree, where in (("this", build.CSRC), ("base", csrc)):
        for src in sources:
            if build.output_path(src, where) not in started:
                started[build.output_path(src, where)] = (
                    tree, build.start_build(src, where))
    for tree, (proc, out) in started.values():
        built = build.finish_build(proc, out, t0)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  [{tree}] ptxas: {line.strip()}")
    log(f"both trees built in {time.perf_counter() - t0:.1f} s")
    trees = {"this": contextlib.nullcontext,
             "base": lambda: rbd_step.kernels_from(csrc)}
    full_plan = steplib.make_plan(get_model(get_config("qwen2-0.5b")),
                                  RBDConfig(total_dim=1024))
    cases = _ab_cases(full_plan)
    differ = []
    for key, fn in cases.items():
        with trees["base"]():
            ref = _tensors(fn())
        out = _tensors(fn())
        if not all(torch.equal(a, b) for a, b in zip(ref, out)):
            differ.append(key)
        del ref, out
    log(f"outputs bit-identical to the base tree's: "
        f"{len(cases) - len(differ)} of {len(cases)} (kernel, impl, "
        f"double_buffer)" + (f"; differ: {differ}" if differ else ""))
    times = {}
    for tree in AB_TURNS:
        with trees[tree]():
            for key, fn in cases.items():
                times.setdefault((tree,) + key, []).extend(cuda_ms(fn))
    rows = []
    for key in cases:
        b = statistics.median(times[("base",) + key])
        t = statistics.median(times[("this",) + key])
        name, impl, db = key
        label = f"{name}[{impl}{',db' if db else ''}]"
        turns = {tree: [round(x, 3) for x in times[(tree,) + key]]
                 for tree in ("base", "this")}
        log(f"  {label}: base {b:.3f} ms, this {t:.3f} ms, this/base "
            f"{t / b:.4f} (turns {turns})")
        rows.append({"kernel": name, "impl": impl, "double_buffer": db,
                     "base_ms": b, "this_ms": t, "ratio": t / b})
    prefill = _ab_prefill(base, csrc, smi)
    print(json.dumps({"ab": rows, "differ": [list(k) for k in differ],
                      "prefill": prefill}), flush=True)
    print(smi, flush=True)
    return 1 if differ else 0


MARK = "chip_smoke mark:"   # _sync_timeline's marks (phase 22)


def _sync_warnings(torch, fn) -> dict:
    """The synchronizing CUDA operations ``fn`` runs, counted under
    ``torch.cuda.set_sync_debug_mode("warn")``, by the Python line that
    issued each."""
    import collections

    return dict(collections.Counter(
        what for kind, what in _sync_timeline(torch, fn) if kind == "sync"))


def _sync_timeline(torch, fn) -> list:
    """``fn()`` under ``set_sync_debug_mode("warn")``: the synchronizing
    CUDA operations it runs, in order, as ``("sync", "file:line")``,
    between the ``("mark", text)`` entries that ``warnings.warn(MARK +
    text)`` calls made inside ``fn`` leave."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out = []
    for w in caught:
        text = str(w.message)
        if text.startswith(MARK):
            out.append(("mark", text[len(MARK):]))
        elif "synchroniz" in text:
            out.append(("sync", f"{os.path.relpath(w.filename, ROOT)}:"
                                f"{w.lineno}"))
    return out


def _guard_vs_unguarded(cfg, smi):
    """One guarded and one unguarded ``train_step`` (the phase's config
    without faults) under the sync debug mode, then RES_TIMED steps of
    each timed in turns.  Returns the guarded and unguarded step times."""
    import torch
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.core import resilience as res
    from repro_torch.data import synthetic
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    model = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=1024,
                                                backend="cuda"),
                       optimizer="adam", learning_rate=RES_LR,
                       batch_size=8, seq_len=128)
    runs = {}
    for name, rcfg in (("unguarded", None),
                       ("guarded", res.ResilienceConfig(
                           guard=res.GuardConfig(), sentinel_every=2))):
        init_state, train_step = steplib.make_train_step(
            model, tcfg, device="cuda", resilience=rcfg)
        data = synthetic.lm_batches(0, 8, 128, cfg.vocab, device="cuda")
        runs[name] = [train_step, init_state(0), data]
    for run in runs.values():                         # warm-up, both
        train_step, state, data = run
        for _ in range(2):
            state, _ = train_step(state, next(data))
        run[1] = state
    warns = {}
    for name, run in runs.items():
        train_step, state, data = run
        batch = next(data)
        out = {}
        warns[name] = _sync_warnings(
            torch, lambda: out.update(r=train_step(state, batch)))
        run[1] = out["r"][0]
    n = {k: sum(v.values()) for k, v in warns.items()}
    log(f"  synchronizing CUDA operations in one train_step: {n}; by "
        f"line: {warns} [{smi}]")
    check(n["guarded"] <= n["unguarded"],
          f"the guard adds host synchronization: {warns}")
    times = {name: [] for name in runs}
    order = list(runs)
    for turn in range(RES_TIMED):
        for name in (order if turn % 2 == 0 else order[::-1]):
            train_step, state, data = runs[name]
            batch = next(data)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            runs[name][1] = state
        check(int(runs["guarded"][1].guard.nonfinite_count) == 0,
              "the guarded step rejected a healthy step")
    check(torch.equal(runs["guarded"][1].params,
                      runs["unguarded"][1].params),
          "the healthy guarded steps are not the unguarded steps bit for "
          "bit")
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"  step wall (host clock, synchronized), {RES_TIMED} in turns: "
        f"guarded {[round(x, 4) for x in times['guarded']]} median "
        f"{med['guarded']:.4f} s, unguarded "
        f"{[round(x, 4) for x in times['unguarded']]} median "
        f"{med['unguarded']:.4f} s (x{med['guarded'] / med['unguarded']:.4f})"
        f"; in turns, alternating first; theta bit-identical [{smi}]")
    params = runs["guarded"][1].params
    ms = cuda_ms(lambda: res.state_checksum(params), repeat=3)
    log(f"  sgd's rider (state_checksum of the {params.numel():,}-element "
        f"packed buffer, chunks of {res._CHECKSUM_CHUNK:,}): "
        f"{[round(x, 3) for x in ms]} ms [{smi}]")
    return med


def phase_resilience(dev):
    import shutil

    import torch
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_config
    from repro_torch.core import resilience as res
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import train as launcher

    smi = dev["smi"]
    log("== phase 18: resilience of the packed step (guard, sentinel, "
        "replay log, snapshots, kill and resume) at full qwen2-0.5b")
    cfg = get_config("qwen2-0.5b")
    plan = res.FaultPlan((res.FaultEvent(1, "nan_grad"),
                          res.FaultEvent(4, "kill")))
    directory = os.path.join(ROOT, "build", "resilience_smoke")
    snap_dir = os.path.join(directory, "snapshots")
    kw = dict(mode="sharedseed", data=1, steps=RES_STEPS, batch=8, seq=128,
              rbd_dim=1024, rbd_backend="cuda", optimizer="adam", lr=RES_LR,
              device="cuda")

    def rcfg(d, faults):
        return res.ResilienceConfig(directory=d, snapshot_every=3,
                                    guard=res.GuardConfig(),
                                    sentinel_every=2, fault_plan=faults)

    def launches():
        n = dict(rbd_step.LAUNCHES)
        return n["project_packed"], n["reconstruct_apply_packed"]

    shutil.rmtree(directory, ignore_errors=True)
    try:
        log("  (a) 6 steps, a NaN gradient at step 1, no kill, no directory")
        rbd_step.reset_counts()
        t = time.perf_counter()
        ref = launcher.run_training(
            cfg, **kw, resilience=rcfg(None, plan.without("kill")))
        log(f"  (a) {time.perf_counter() - t:.1f} s, launches {launches()}, "
            f"collectives {ref.collectives}, losses {ref.losses}")
        check(launches() == (RES_STEPS, RES_STEPS),
              f"(a): expected 2 launches a step, got {launches()}")
        check(ref.collectives["all_reduce"] == RES_STEPS
              and ref.collectives["all_gather"] == 0,
              f"(a): expected one all-reduce a step, {ref.collectives}")
        events = [(e.step, res.reason_name(e.reason))
                  for e in ref.monitor.events]
        check(events == [(1, "nonfinite_local")],
              f"(a): expected step 1 rejected as nonfinite_local: {events}")
        check(int(ref.state.guard.nonfinite_count) == 1,
              "(a): the guard did not count one rejected step")
        check(all(math.isfinite(x) for x in ref.losses),
              f"(a): losses {ref.losses}")
        # phase 25 holds the slab run to (a): its reasons, theta on the host
        rejected = dict((e.step, e.reason) for e in ref.monitor.events)
        PHASE18.update(
            reasons=[rejected.get(i, res.REASON_OK)
                     for i in range(RES_STEPS)],
            losses=list(ref.losses), theta=ref.state.params.cpu())

        log("  (b) the same with the replay log, a snapshot every 3 "
            "steps, killed before step 4")
        rbd_step.reset_counts()
        t = time.perf_counter()
        try:
            launcher.run_training(cfg, **kw, resilience=rcfg(directory,
                                                             plan))
            check(False, "(b): the fault plan's kill did not fire")
        except res.SimulatedWorkerKill as e:
            log(f"  (b) {time.perf_counter() - t:.1f} s: {e}")
        check(launches() == (4, 4),
              f"(b): expected 2 launches a step, got {launches()}")
        snap = os.path.join(snap_dir, "ckpt_00000003.npz")
        snap_bytes = os.path.getsize(snap)
        log_bytes = os.path.getsize(os.path.join(directory, "replay.log"))
        log(f"  snapshot {snap_bytes:,} B ({snap_bytes / 1e9:.3f} GB), "
            f"replay log {log_bytes:,} B for 4 records")

        log("  (c) resumed from (b)'s directory, the kill dropped")
        rbd_step.reset_counts()
        t = time.perf_counter()
        resumed = launcher.run_training(
            cfg, **kw, resume=True,
            resilience=rcfg(directory, plan.without("kill")))
        rec = resumed.recovery
        log(f"  (c) {time.perf_counter() - t:.1f} s: snapshot "
            f"{rec['snapshot_step']}, replayed {rec['replayed']}, recovery "
            f"launches {rec['launches']}, then launches {launches()}, "
            f"collectives {resumed.collectives}")
        check(rec["snapshot_step"] == 3 and rec["replayed"] == 1,
              f"(c): expected snapshot 3 and 1 record replayed: {rec}")
        check(rec["launches"]["reconstruct_apply_packed"] == 1
              and rec["launches"]["project_packed"] == 0
              and sum(rec["launches"].values()) == 1,
              f"(c): the replay should be one apply: {rec['launches']}")
        check(launches() == (2, 3),
              f"(c): expected 2 live steps + 1 replayed apply, got "
              f"{launches()}")
        check(resumed.collectives["all_reduce"] == 2
              and resumed.collectives["resync"] == 0,
              f"(c): expected one all-reduce a live step, "
              f"{resumed.collectives}")
        a, c = ref.state, resumed.state
        check(c.step == a.step == RES_STEPS, f"steps {a.step} {c.step}")
        same = {
            "theta": torch.equal(a.params, c.params),
            "adam count": torch.equal(a.opt_state.count, c.opt_state.count),
            "adam mu": torch.equal(a.opt_state.mu, c.opt_state.mu),
            "adam nu": torch.equal(a.opt_state.nu, c.opt_state.nu),
            "guard": all(torch.equal(x, y) for x, y in zip(a.guard,
                                                          c.guard)),
        }
        log(f"  resumed == uninterrupted, bit for bit: {same}; guard "
            f"{[x.item() for x in c.guard]}")
        check(all(same.values()), f"(c) is not (a) bit for bit: {same}")
        check(int(c.guard.nonfinite_count) == 1,
              "(c): the guard's count is not 1")

        # the recovery's pieces timed: the verified restore (CRC of every
        # array), the replay of one record, the snapshot's write
        sub = resumed.sub_opt
        torch.cuda.synchronize()
        t = time.perf_counter()
        restored = ckpt_io.restore(snap_dir, c, 3)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        _, records, _ = res.ReplayLog.read(os.path.join(directory,
                                                        "replay.log"))
        record = [r for r in records if r.step == 3]
        replay_ms, outs = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, n = res.replay_records(sub, restored, record)
            torch.cuda.synchronize()
            replay_ms.append(1e3 * (time.perf_counter() - t))
            outs.append(out.params)
        check(n == 1 and all(torch.equal(x, outs[0]) for x in outs),
              "the replay of record 3 is not bit-identical across reruns")
        del outs
        shutil.rmtree(snap_dir)
        monitor = res.ResilienceMonitor(rcfg(directory, None), sub)
        torch.cuda.synchronize()
        t = time.perf_counter()
        monitor.snapshot(restored)
        write_s = time.perf_counter() - t
        monitor.log.close()
        log(f"  snapshot write (device to host, npz, CRC32s, fsync) "
            f"{write_s:.3f} s, verified restore {restore_s:.3f} s for "
            f"{snap_bytes / 1e9:.3f} GB [{smi}]")
        log(f"  replay of one record (1 reconstruct_apply_packed launch) "
            f"{[round(x, 1) for x in replay_ms]} ms [{smi}]")
        del ref, resumed, restored, a, c
        torch.cuda.empty_cache()
        med = _guard_vs_unguarded(cfg, smi)
        log(f"  replay of one record / a guarded step: "
            f"{statistics.median(replay_ms) / 1e3 / med['guarded']:.3f} "
            f"[{smi}]")
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def materialized_bytes(d: int, q: int) -> dict:
    """Bytes the two materialized products must move: the (d, q) float32
    basis read once, plus the projection's (q,) gradient read and (d,)
    coordinates written, the apply's (d,) coordinates and (q,) theta read
    and (q,) theta written."""
    basis = 4 * d * q
    return {"project_materialized": basis + 4 * q + 4 * d,
            "reconstruct_apply_materialized": basis + 4 * d + 8 * q}


def _gram_error(basis) -> float:
    """max|B B^T - I| of a (d, q) basis, the Gram summed in float64 over
    column chunks."""
    import torch

    d, q = basis.shape
    gram = torch.zeros((d, d), dtype=torch.float64, device=basis.device)
    for i in range(0, q, GRAM_CHUNK):
        c = basis[:, i: i + GRAM_CHUNK].to(torch.float64)
        gram.addmm_(c, c.T)
    eye = torch.eye(d, dtype=torch.float64, device=basis.device)
    return float((gram - eye).abs().max())


def _basis_fpd_lbfgs(smi) -> dict:
    """(a): returns the launches of rows 1-2 over its steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.core import distributed
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    rbd = RBDConfig(total_dim=1024, backend="cuda", redraw=False)
    common = dict(model=cfg, rbd=rbd, learning_rate=0.125,
                  steps=BASIS_STEPS, batch_size=8, seq_len=128)
    lbfgs_cfg = TrainConfig(optimizer="lbfgs", lbfgs_history=8,
                            coord_clip_norm=1.0, lr_schedule="cosine",
                            lr_warmup_steps=1, **common)
    mesh = meshlib.init_mesh(1, 1, "cuda")   # the one-rank data group
    try:
        init_state, train_step, sub = steplib.make_train_step(
            model, lbfgs_cfg, axis_name="data", device="cuda",
            return_optimizer=True)
        eplan = sub.plan_execution()
        log(f"  (a) update path: {eplan.strategy} -- FPD (redraw=False), "
            "lbfgs history 8, clip 1.0, cosine with 1 warmup step")
        check(eplan.strategy == "fused_packed",
              f"(a) plans {eplan.strategy}, not fused_packed")
        state = init_state(0)
        data = synthetic.lm_batches(0, 8, 128, cfg.vocab, device="cuda")
        rbd_step.reset_counts()
        distributed.reset_counts()
        rbd_step.set_timing(True)
        losses, walls, fills = [], [], []
        for _ in range(BASIS_STEPS):
            batch = next(data)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            losses.append(float(metrics["loss"]))
            fills.append(int(state.opt_state[1].mask.sum()))
        kms = rbd_step.kernel_times_ms()
        rbd_step.set_timing(False)
        launches = dict(rbd_step.LAUNCHES)
        coll = dict(distributed.COLLECTIVES)
        log(f"  (a) losses {losses}; L-BFGS pairs held after each step "
            f"{fills}; step wall {[round(x, 4) for x in walls]} s [{smi}]")
        log(f"  (a) launches {launches}; collectives {coll}; launch ms "
            + "; ".join(f"{k} {[round(x, 3) for x in v]}"
                        for k, v in kms.items() if v) + f" [{smi}]")
        check(all(math.isfinite(x) for x in losses), f"(a) losses {losses}")
        check(launches["project_packed"] == BASIS_STEPS
              and launches["reconstruct_apply_packed"] == BASIS_STEPS
              and sum(launches.values()) == 2 * BASIS_STEPS,
              f"(a) expected 2 launches a step, got {launches}")
        check(coll["all_reduce"] == BASIS_STEPS and coll["all_gather"] == 0
              and coll["grad_all_reduce"] == 0
              and coll["basis_grad_all_reduce"] == 0,
              f"(a) expected one (d,) all-reduce a step, got {coll}")
        check(fills[0] == 0 and max(fills) <= 8,
              f"(a) L-BFGS ring fill {fills}")
        # steps of each under the sync debug mode, bare sgd (no clip, no
        # schedule) warmed by one step first; two rounds in turns, since
        # the first step measured also counts a first-call sync inside
        # torch.cuda, and each config's fewer counts
        sgd_init, sgd_step = steplib.make_train_step(
            model, TrainConfig(optimizer="sgd", **common),
            axis_name="data", device="cuda")
        sgd_state, _ = sgd_step(sgd_init(0), next(data))
        batch = next(data)
        steps = {"lbfgs": lambda: train_step(state, batch),
                 "sgd": lambda: sgd_step(sgd_state, batch)}
        warns = {k: [] for k in steps}
        for order in (("lbfgs", "sgd"), ("sgd", "lbfgs")):
            for k in order:
                warns[k].append(_sync_warnings(torch, steps[k]))
        n = {k: min(sum(w.values()) for w in v) for k, v in warns.items()}
        log(f"  (a) synchronizing CUDA operations in one step (fewer of "
            f"two rounds): {n}; by line: {warns} [{smi}]")
        check(n["lbfgs"] <= n["sgd"],
              f"(a) the L-BFGS step synchronizes more than sgd's: {warns}")
    finally:
        meshlib.destroy_mesh(mesh)
    return {k: launches[k] for k in ("project_packed",
                                     "reconstruct_apply_packed")}


def _basis_resident(smi):
    """(b): the 15.1 GB basis at full width, depth 1."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig
    from repro_torch.core import projector
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import train as launcher
    from repro_torch.models.registry import get_model
    from repro_torch.train import loop
    from repro_torch.train import step as steplib

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=1)
    plan = steplib.make_plan(get_model(cfg),
                             RBDConfig(total_dim=RESIDENT_DIM))
    lay = plan.packed()
    d, q = plan.total_dim, lay.q_packed
    log(f"  (b) qwen2-0.5b width, depth 1, rbd-dim {RESIDENT_DIM}: "
        f"total_dim {d}, q_packed {q:,}, basis {4 * d * q:,} B")
    valid = torch.from_numpy(lay.param_valid).cuda()
    pad = ~valid.bool()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.perf_counter()
    a = torch.randn((q, d), generator=gen, dtype=torch.float32,
                    device="cuda")
    a.mul_(valid[:, None])
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t
    t = time.perf_counter()
    basis = projector.orthonormal_rows(a)
    del a
    torch.cuda.synchronize()
    qr_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - held
    err = _gram_error(basis)
    pad_zero = bool((basis[:, pad] == 0).all())
    log(f"  (b) draw {draw_s:.3f} s, QR (CholeskyQR2, float64 Gram) "
        f"{qr_s:.3f} s, peak {peak / 1e9:.2f} GB above the {held / 1e9:.2f}"
        f" GB held; max|B B^T - I| {err:.3e}; padding columns zero "
        f"{pad_zero} [{smi}]")
    check(err <= 1e-4, f"(b) the basis is not orthonormal: {err}")
    check(pad_zero, "(b) the basis's padding columns are not zero")
    check(torch.equal(basis, projector.materialize_random_basis(
        plan, lay, 0, device="cuda")),
        "(b) materialize_random_basis is not the timed draw + QR")
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(q, generator=gen, device="cuda") * valid
    theta = torch.randn(q, generator=gen, device="cuda") * valid
    c = torch.randn(d, generator=gen, device="cuda")
    times = {
        "project_materialized": cuda_ms(
            lambda: projector.project_materialized(basis, g), repeat=3),
        "reconstruct_apply_materialized": cuda_ms(
            lambda: projector.reconstruct_apply_materialized(
                c, basis, theta, 0.125), repeat=3),
    }
    for name, nbytes in materialized_bytes(d, q).items():
        b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        med = statistics.median(times[name])
        log(f"  (b) {name}: {[round(x, 3) for x in times[name]]} ms, "
            f"bound {b_ms:.3f} ms ({nbytes:,} B at HBM_BYTES_PER_S), "
            f"{b_ms / med:.1%} of bound [{smi}]")
    del basis, g, theta, c
    torch.cuda.empty_cache()

    rbd_step.reset_counts()
    t = time.perf_counter()
    res = launcher.run_training(
        cfg, steps=RESIDENT_STEPS, batch=8, seq=128, rbd_dim=RESIDENT_DIM,
        rbd_backend="cuda", basis="trajectory_pca", optimizer="lbfgs",
        device="cuda")
    run_s = time.perf_counter() - t
    launches = dict(rbd_step.LAUNCHES)
    basis = res.state.rbd_state.basis
    err = _gram_error(basis)
    log(f"  (b) run_training {RESIDENT_STEPS} steps in {run_s:.1f} s: "
        f"losses {res.losses}, launches {launches}, collectives "
        f"{res.collectives}, refreshes {res.collector.refreshes}, ring "
        f"{len(res.collector.ring)}; peak during the steps "
        f"{res.peak_bytes / 1e9:.2f} GB; max|B B^T - I| {err:.3e} [{smi}]")
    check(sum(launches.values()) == 0,
          f"(b) the materialized step launched RBD kernels: {launches}")
    check(all(math.isfinite(x) for x in res.losses), f"(b) {res.losses}")
    check(err <= 1e-4, f"(b) the run's basis is not orthonormal: {err}")
    check(bool((basis[:, pad] == 0).all()),
          "(b) the run's basis has nonzero padding columns")
    check(bool((res.state.params[pad] == 0).all()),
          "(b) theta's padding is not zero")
    pulls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop._host(res.state.params)
        pulls.append(time.perf_counter() - t)
    log(f"  (b) the collector's host pull of theta ({4 * q:,} B): "
        f"{[round(x, 4) for x in pulls]} s [{smi}]")
    del res, basis
    torch.cuda.empty_cache()


def _basis_acceptance(smi):
    """(c): the reference's acceptance run and the gradient_informed
    refresh, at the reference's reduced size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import projector
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import train as launcher

    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    kw = dict(batch=2, seq=16, rbd_dim=40, rbd_backend="cuda",
              device="cuda")
    tails = {}
    for name, optimizer, basis, lr in (
            ("random_sgd", "sgd", "random", 0.5),
            ("pca_lbfgs", "lbfgs", "trajectory_pca", 1.0)):
        rbd_step.reset_counts()
        t = time.perf_counter()
        res = launcher.run_training(
            cfg, steps=ACCEPT_STEPS, lr=lr, optimizer=optimizer, basis=basis,
            basis_refresh_every=ACCEPT_REFRESH, **kw)
        tails[name] = statistics.mean(res.losses[-ACCEPT_TAIL:])
        n = (rbd_step.LAUNCHES["project_packed"],
             rbd_step.LAUNCHES["reconstruct_apply_packed"])
        refreshes = res.collector.refreshes if res.collector else 0
        log(f"  (c) {name}: {time.perf_counter() - t:.1f} s, launches {n}, "
            f"refreshes {refreshes}, loss {res.losses[0]:.4f} -> "
            f"{res.losses[-1]:.4f}, tail mean of {ACCEPT_TAIL} "
            f"{tails[name]:.4f}")
        check(all(math.isfinite(x) for x in res.losses),
              f"(c) {name} losses {res.losses}")
        want = ((ACCEPT_STEPS, ACCEPT_STEPS) if basis == "random"
                else (0, 0))
        check(n == want, f"(c) {name}: launches {n}, expected {want}")
        if basis != "random":
            check(refreshes == ACCEPT_STEPS // ACCEPT_REFRESH,
                  f"(c) {name}: {refreshes} refreshes")
    order = ("below" if tails["pca_lbfgs"] < tails["random_sgd"]
             else "not below")
    log(f"  (c) tail means {tails}: trajectory_pca + lbfgs {order} random "
        f"+ sgd (a result, not a gate) [{smi}]")
    res = launcher.run_training(
        cfg, steps=GI_STEPS, lr=0.5, optimizer="momentum",
        basis="gradient_informed", basis_refresh_every=GI_REFRESH, **kw)
    plan = res.sub_opt.transform.plan
    basis0 = projector.materialize_random_basis(plan, plan.packed(), 0,
                                                device="cuda")
    basis = res.state.rbd_state.basis
    err = _gram_error(basis)
    log(f"  (c) gradient_informed + momentum: refreshes "
        f"{res.collector.refreshes}, collectives {res.collectives}, "
        f"max|B B^T - I| {err:.3e}, changed "
        f"{not torch.equal(basis, basis0)}")
    check(res.collector.refreshes == GI_STEPS // GI_REFRESH,
          f"(c) gradient_informed: {res.collector.refreshes} refreshes")
    check(basis.shape == basis0.shape and not torch.equal(basis, basis0),
          "(c) gradient_informed: the refresh did not change the basis")
    check(err <= 1e-4, f"(c) gradient_informed basis: {err}")
    check(res.collectives["basis_grad_all_reduce"] == GI_STEPS,
          f"(c) gradient_informed: {res.collectives}")


def phase_basis(dev) -> dict:
    """Returns the launches of rows 1-2 in (a)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smi = dev["smi"]
    log("== phase 19: the basis layer (FPD + L-BFGS on the packed kernels, "
        "the resident basis, the reference's acceptance run)")
    launches = _basis_fpd_lbfgs(smi)
    _basis_resident(smi)
    _basis_acceptance(smi)
    log(f"  phase 19 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 20: the decoder-only model zoo through the packed step, the serving
# engine and the flash kernel at head sizes 80 and 256
# ---------------------------------------------------------------------------


def _zoo_config(arch, depth):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def _zoo_attention_launches(cfg) -> int:
    """Flash launches of one prefill: one per attention layer, one per
    hybrid group."""
    from repro_torch.models import transformer

    return ((cfg.n_layers if cfg.block_kind == "attn" else 0)
            + transformer.n_groups(cfg))


def _zoo_train(cfg, model, b, s, rbd_dim, steps, smi):
    """The packed step (shared basis, Threefry) for ``steps`` steps, the
    launches counted over the steps after the first (over the one step
    when ``steps`` is 1).  Returns (state, optimizer, launches of rows
    1-2, a log line)."""
    import torch
    from repro_torch.configs.base import InputShape, RBDConfig, TrainConfig
    from repro_torch.kernels import rbd_step
    from repro_torch.train import step as steplib

    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=rbd_dim,
                                                backend="cuda"),
                       learning_rate=ZOO_LR, steps=steps, batch_size=b,
                       seq_len=s)
    init_state, train_step, sub = steplib.make_train_step(
        model, tcfg, device="cuda", return_optimizer=True)
    eplan = sub.plan_execution()
    check(eplan.strategy == "fused_packed" and eplan.prng_impl == "threefry",
          f"{cfg.name}: plans {eplan.strategy} / {eplan.prng_impl}")
    shape = InputShape("zoo", s + cfg.n_patches, b, "train")
    batches = [model.make_batch(shape, seed=i, device="cuda")
               for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = init_state(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t
    sample = state.params[::ZOO_THETA_STRIDE].clone()
    losses, walls, launches, kms = [], [], {}, {}
    for i, batch in enumerate(batches):
        if i == min(1, steps - 1):
            rbd_step.reset_counts()
            rbd_step.set_timing(True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
    kms = rbd_step.kernel_times_ms()
    rbd_step.set_timing(False)
    launches = {k: rbd_step.LAUNCHES[k] for k in ("project_packed",
                                                   "reconstruct_apply_packed")}
    counted = steps - 1 if steps > 1 else 1
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = float((state.params[::ZOO_THETA_STRIDE] - sample).abs().max())
    check(all(math.isfinite(x) for x in losses),
          f"{cfg.name}: losses {losses}")
    check(launches == {"project_packed": counted,
                       "reconstruct_apply_packed": counted}
          and sum(rbd_step.LAUNCHES.values()) == 2 * counted,
          f"{cfg.name}: expected 2 launches a step over {counted}, got "
          f"{dict(rbd_step.LAUNCHES)}")
    check(moved > 0, f"{cfg.name}: theta did not move")
    lay = sub.transform.plan.packed()
    ms = "; ".join(f"{k} {[round(x, 2) for x in v]}"
                   for k, v in kms.items() if v)
    line = (f"q_packed {lay.q_packed:,} d_packed {lay.d_packed} (total_dim "
            f"{sub.transform.plan.total_dim}); init "
            f"{t_init:.2f} s; losses {[round(x, 4) for x in losses]}; step "
            f"wall {[round(x, 3) for x in walls]} s; launch ms {ms}; "
            f"peak {peak:.2f} GiB; theta moved (max|d| {moved:.3g} on a "
            f"1/{ZOO_THETA_STRIDE} sample) [{smi}]")
    del sample, batches
    return state, sub, launches, line


def _zoo_serve(cfg, model, params, prompt_len, smi):
    """Engine.generate on one prompt (after the VLM's patches) with
    ZOO_NEW greedy tokens: the prefill's flash launches (bf16: all of the
    tensor-core kernel; f32 compute: all of the CUDA-core one), its
    last-position logits against forward's, the cache's len.  Returns the
    bf16 and the f32 prefill's launches by kernel and a log line."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rbd_step
    from repro_torch.models import frontends, transformer
    from repro_torch.serve.engine import Engine

    n_extra = cfg.n_patches
    eng = Engine(model, params, max_len=n_extra + prompt_len + ZOO_NEW)
    caches = []

    def decode_step(p, cache, token):
        out = model.decode_step(p, cache, token)
        caches[:] = [out[1]]
        return out

    eng.model = dataclasses.replace(model, decode_step=decode_step)
    tokens = np.random.default_rng(20).integers(0, cfg.vocab,
                                                (1, prompt_len))
    prompt = torch.from_numpy(tokens).cuda()
    patches = (frontends.vision_patches(cfg, 1, device="cuda")
               if n_extra else None)
    want_flash = _zoo_attention_launches(cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rbd_step.reset_counts()
        t = time.perf_counter()
        logits, cache = transformer.prefill(cfg, eng._cparams, prompt,
                                            eng.max_len, extra_embeds=patches)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t
        variants = dict(rbd_step.VARIANT_LAUNCHES)
        n_flash = rbd_step.LAUNCHES["flash_attention"]
        check(n_flash == want_flash,
              f"{cfg.name}: the prefill made {n_flash} flash launches, "
              f"expected {want_flash}")
        want_variants = ({"flash_attention[wgmma]": want_flash}
                         if want_flash else {})
        check(variants == want_variants,
              f"{cfg.name}: the bf16 prefill's launches by kernel "
              f"{variants}, expected {want_variants}")
        check(int(cache["len"]) == n_extra + prompt_len,
              f"{cfg.name}: prefill len {int(cache['len'])}")
        del cache
        full, _ = transformer.forward(cfg, params, prompt,
                                      extra_embeds=patches)
        want = full[0, -1].float()
        del full
        # a second sound route: the same layers with the attention through
        # the plain version; its distance to forward is the bf16 noise of
        # this depth
        xp = transformer._run_prompt(
            cfg, eng._cparams, prompt, flash.flash_attention_plain,
            extra_embeds=patches)[0]
        sound = transformer._logits(cfg, eng._cparams, xp[:, -1:])[0, 0]
        del xp
        scale = float(want.abs().max())
        d = float((logits[0, 0].float() - want).abs().max())
        d_sound = float((sound.float() - want).abs().max())
        top2 = torch.topk(want, 2).values
        margin = float(top2[0] - top2[1])
        tol = max(PREFILL_LOGIT_RTOL * scale, ZOO_SOUND_FACTOR * d_sound)
        check(d <= tol,
              f"{cfg.name}: prefill logits off forward's by {d:.4g} "
              f"({d / scale:.3%} of max|logits|; the plain route "
              f"{d_sound / scale:.3%})")
        # f32 compute: the two routes differ by f32 rounding only
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        rbd_step.reset_counts()
        l32, cache32 = transformer.prefill(cfg32, params, prompt,
                                           eng.max_len, extra_embeds=patches)
        variants32 = dict(rbd_step.VARIANT_LAUNCHES)
        want32_variants = ({"flash_attention[fma]": want_flash}
                           if want_flash else {})
        check(variants32 == want32_variants,
              f"{cfg.name}: the f32 prefill's launches by kernel "
              f"{variants32}, expected {want32_variants}")
        del cache32
        full, _ = transformer.forward(cfg32, params, prompt,
                                      extra_embeds=patches)
        want32 = full[0, -1]
        del full
        scale32 = float(want32.abs().max())
        d32 = float((l32[0, 0] - want32).abs().max())
        check(d32 <= PREFILL_F32_RTOL * scale32,
              f"{cfg.name}: f32 prefill logits off forward's by {d32:.4g} "
              f"({d32 / scale32:.3g} of max|logits|)")
        # the witness that shares no bf16 step: each bf16 route against
        # the f32 forward
        off32 = {name: float((x.float() - want32).abs().max()) / scale32
                 for name, x in (("kernel", logits[0, 0]), ("forward", want),
                                 ("plain", sound))}
        lim32 = ZOO_BF16_F32_RTOL[cfg.name]
        check(max(off32.values()) <= lim32,
              f"{cfg.name}: bf16 logits off the f32 forward's by "
              f"{off32} of max|logits| > {lim32:g}")
        rbd_step.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.generate(prompt, ZOO_NEW, extra_embeds=patches).cpu()
        t_gen = time.perf_counter() - t
        gen_flash = rbd_step.LAUNCHES["flash_attention"]
        check(gen_flash == want_flash,
              f"{cfg.name}: generate made {gen_flash} flash launches, "
              f"{gen_flash - want_flash} in decode (expected 0)")
        check(tuple(out.shape) == (1, ZOO_NEW), f"{tuple(out.shape)}")
        n_len = int(caches[0]["len"])
        check(n_len == n_extra + prompt_len + ZOO_NEW - 1,
              f"{cfg.name}: len {n_len} after {ZOO_NEW - 1} decode steps")
        first = int(torch.argmax(want))
        if margin > tol:
            check(int(out[0, 0]) == first,
                  f"{cfg.name}: first token {int(out[0, 0])} != forward's "
                  f"argmax {first}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode_ms = 1e3 * (t_gen - t_prefill) / (ZOO_NEW - 1)
    line = (f"prompt {n_extra} + {prompt_len}: prefill {1e3 * t_prefill:.1f}"
            f" ms, {n_flash} flash launches {variants}; last-position logits"
            f" vs forward max|d| {d:.4g} of {scale:.4g} ({d / scale:.3%}; "
            f"tolerance {tol / scale:.3%}), the plain route "
            f"{d_sound / scale:.3%}, f32 compute {d32 / scale32:.3g} "
            f"({variants32}); "
            f"bf16 vs the f32 forward: kernel {off32['kernel']:.3%}, forward "
            f"{off32['forward']:.3%}, plain {off32['plain']:.3%} (limit "
            f"{lim32:.1%}); "
            f"top-1/top-2 margin {margin:.4g}; generate {ZOO_NEW} tokens {t_gen:.2f} s (~"
            f"{decode_ms:.1f} ms a decode step), len {n_len}; peak "
            f"{peak:.2f} GiB [{smi}]")
    del eng
    return variants, variants32, line


def _zoo_flash(smi) -> tuple[dict, dict]:
    """Both flash kernels at gemma3's heads (8 / 4 of 256, window None and
    1,024) and zamba2's (32 / 32 of 80), bf16, causal, B = 1, at each of
    ZOO_FLASH_LENGTHS: the tensor-core kernel (the wrapper's choice) and
    the CUDA-core one (named) each against the plain version with its
    p_dtype within row 11's gate, reruns bit-identical, timed in turns
    with ``scaled_dot_product_attention`` (a band mask where windowed) as
    _flash_timing times them; at the longest length the plain versions
    timed and, without a window, _flash_planted's faults refused by the
    tensor-core kernel's gate.  Logs the tensor-core instances' registers
    and spills first.  Returns the worst max|kernel - plain| and the row
    at the longest length, window None, by (kernel, head size)."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rbd_step

    built = rbd_step.library(rbd_step.FLASH_SOURCE)
    found = flash_instances(built.path, built.log)
    for hd in ZOO_HEAD_SIZES:
        _log_instance(hd, found[hd])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    longest = max(ZOO_FLASH_LENGTHS)
    worst, rows = {}, {}
    with torch.no_grad():
        for h, kv, hd, windows in ZOO_FLASH_HEADS:
            for s in ZOO_FLASH_LENGTHS:
                for window in windows:
                    q, k, v = _flash_inputs(torch, 1, s, s, h, kv, hd,
                                            torch.bfloat16, s + hd)
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    check(flash.kernel_for(q.dtype, hd) == "wgmma",
                          f"bf16 at hd {hd} does not take the tensor-core "
                          "kernel")
                    if window is None:
                        def lib():
                            return sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
                    else:
                        pos = torch.arange(s, device="cuda")
                        band = ((pos[None, :] <= pos[:, None])
                                & (pos[None, :] > pos[:, None] - window))

                        def lib():
                            return sdpa(qt, kt, vt, attn_mask=band,
                                        enable_gqa=True)

                    runs = {"wgmma": lambda: flash.flash_attention(
                                q, k, v, window=window),
                            "fma": lambda: flash._launch_kernel(
                                q, k, v, kernel="fma", window=window),
                            "library": lib}
                    errs, plain_ms = {}, {}
                    for kernel in ("wgmma", "fma"):
                        key = f"flash_attention[{kernel}]"
                        before = rbd_step.VARIANT_LAUNCHES.get(key, 0)
                        out, again = runs[kernel](), runs[kernel]()
                        p_dtype = flash.P_DTYPE[kernel]
                        ref, l = flash.flash_attention_plain(
                            q, k, v, window=window, p_dtype=p_dtype,
                            return_l=True)
                        torch.cuda.synchronize()
                        check(rbd_step.VARIANT_LAUNCHES.get(key, 0)
                              == before + 2,
                              f"hd {hd} S={s}: the {kernel} kernel did not "
                              "run")
                        check(torch.equal(out, again),
                              f"flash [{kernel}] hd {hd} rerun differs "
                              f"(S={s}, window {window})")
                        errs[kernel] = _flash_err(
                            torch, out, ref, v, kernel,
                            l if kernel == "wgmma" else None)
                        worst[(kernel, hd)] = max(
                            worst.get((kernel, hd), 0.0), errs[kernel][0])
                        if s == longest:
                            plain_ms[kernel] = cuda_ms(
                                lambda: flash.flash_attention_plain(
                                    q, k, v, window=window,
                                    p_dtype=p_dtype))[0]
                            if kernel == "wgmma" and window is None:
                                _flash_planted(torch, flash, q, k, v, ref, l)
                        del out, again, ref, l
                    times = {name: [] for name in runs}
                    reps = ZOO_FLASH_BURST.get(s, 1)
                    for name in ("fma", "wgmma", "library", "library",
                                 "wgmma", "fma"):
                        runs[name]()                       # warm
                        burst = cuda_ms(
                            lambda: [runs[name]() for _ in range(reps)],
                            repeat=3)
                        times[name].append(sorted(burst)[1] / reps)
                    ms = {n: sum(t) / len(t) for n, t in times.items()}
                    b_ms, by = flash_bound_ms(1, s, s, h, kv, hd, "bfloat16",
                                              window=window)
                    f32_ms, _ = flash_bound_ms(1, s, s, h, kv, hd, "float32",
                                               window=window)
                    for kernel in ("wgmma", "fma"):
                        d, ratio, rel = errs[kernel]
                        extra = (f"; {f32_ms / ms[kernel]:.2%} of the f32 "
                                 f"CUDA cores' {f32_ms:.4f}"
                                 if kernel == "fma" else "")
                        log(f"  (c) flash [{kernel}] hd {hd} heads {h}/{kv} "
                            f"S={s} window {window}: {ms[kernel]:.4f} ms "
                            f"(turns {[round(t, 4) for t in times[kernel]]}"
                            f"), sdpa {ms['library']:.4f} ms (turns "
                            f"{[round(t, 4) for t in times['library']]}), "
                            f"bound {b_ms:.4f} ({by}, bf16 tensor cores), "
                            f"{b_ms / ms[kernel]:.2%} of bound{extra}; vs "
                            f"plain max|d| {d:.3g} ({ratio:.3g} of the "
                            f"tolerance, relative L2 {rel:.3g}), rerun "
                            f"bit-identical"
                            + (f"; plain {plain_ms[kernel]:.1f} ms"
                               if kernel in plain_ms else "")
                            + f" [{smi}]")
                        if s == longest and window is None:
                            rows[(kernel, hd)] = {
                                "ms": ms[kernel],
                                "plain_ms": plain_ms[kernel],
                                "bound_ms": b_ms, "bound_by": by,
                                "library_ms": ms["library"]}
                    del q, k, v, qt, kt, vt, runs
    return worst, rows


def phase_zoo(dev) -> tuple[dict, list]:
    """Returns the zoo's launches by kernel row (rows 1-2, row 11's
    tensor-core kernel at head sizes 64 / 128, the tensor-core kernel at
    head sizes 80 and 256 from the bf16 prefills, the CUDA-core kernel
    there from the f32 prefills) and the kernels line's rows of both
    kernels at head sizes 80 and 256."""
    import gc

    import torch
    from repro_torch.models.registry import get_model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smi = dev["smi"]
    log("== phase 20: the decoder-only model zoo (full width; packed "
        "step, serving, the flash kernels at head sizes 80 and 256)")
    totals = {"project_packed": 0, "reconstruct_apply_packed": 0,
              "flash_attention": 0}
    for kernel in ("wgmma", "fma"):
        for hd in ZOO_HEAD_SIZES:
            totals[f"flash_attention[{kernel}] hd{hd}"] = 0
    for arch, depth, b, s, rbd_dim, steps, prompt_len in ZOO_DRIVES:
        t = time.perf_counter()
        cfg = _zoo_config(arch, depth)
        model = get_model(cfg)
        state, sub, launches, line = _zoo_train(cfg, model, b, s, rbd_dim,
                                                steps, smi)
        log(f"  (a) {arch} depth {cfg.n_layers}, batch {b} x "
            f"({cfg.n_patches} + {s}), rbd-dim {rbd_dim}, {steps} steps: "
            + line)
        for k, n in launches.items():
            totals[k] += n
        params = sub.materialize_params(state.params)
        variants, variants32, line = _zoo_serve(cfg, model, params,
                                                prompt_len, smi)
        log(f"  (b) {arch}: " + line)
        wgmma = variants.get("flash_attention[wgmma]", 0)
        if cfg.d_head in ZOO_HEAD_SIZES:
            totals[f"flash_attention[wgmma] hd{cfg.d_head}"] += wgmma
            totals[f"flash_attention[fma] hd{cfg.d_head}"] += variants32.get(
                "flash_attention[fma]", 0)
        else:
            totals["flash_attention"] += wgmma
        del state, sub, params, model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {arch}: {time.perf_counter() - t:.1f} s")
    worst, rows = _zoo_flash(smi)
    out = []
    for kernel, source in (("wgmma", "flash_wgmma.cuh"),
                           ("fma", "flash_attention.cu")):
        for hd in ZOO_HEAD_SIZES:
            name = f"flash_attention[{kernel}] hd{hd}"
            check(totals[name] > 0, f"{name} did not launch in phase 20")
            out.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}",
                        "replaces": REPLACES["flash_attention"],
                        "launches": totals[name],
                        "max_abs_err": worst[(kernel, hd)],
                        **rows[(kernel, hd)]})
    log(f"  zoo launches {totals}")
    log(f"  phase 20 took {time.perf_counter() - t0:.1f} s")
    return totals, out


# ---------------------------------------------------------------------------
# phase 21: the encoder-decoder (whisper-tiny) and the paper's image models
# ---------------------------------------------------------------------------


def _packed_vs_plain(model, state, sub, batch, lr=ZOO_LR) -> dict:
    """Rows 1-2 against their plain versions on the inputs of the packed
    step that would follow ``state``: the loss gradient of the stored
    buffer on ``batch``, that step's segment seeds, and the apply's scale
    (the plain coordinates through the plan's normalization, times the
    learning rate ``lr``) on the stored theta; phase 3's gates.  Returns max|err|
    by kernel."""
    import torch
    from repro_torch.core import projector
    from repro_torch.kernels import rbd_step
    from repro_torch.train import step as steplib

    t = sub.transform
    plan = t.plan
    lay = plan.packed()
    dist = plan.distribution
    loss_fn = steplib.make_loss_fn(model, model.cfg.router_aux_coef)
    stored = state.params.detach().requires_grad_(True)
    loss, _ = loss_fn(sub.materialize_params(stored), batch)
    (g,) = torch.autograd.grad(loss, stored)
    del loss, stored
    theta = state.params.detach()
    seeds = projector.segment_seeds(plan, t.step_seed(state.rbd_state.step))
    tag = f"{model.cfg.name} step {state.step}"
    with torch.no_grad():
        u, sq = rbd_step.project_packed(seeds, g, lay, dist)
        up, sqp = rbd_step.project_packed_plain(seeds, g, lay, dist)
        errs = {"project_packed": _check_project(tag, u, sq, up, sqp, g,
                                                 lay)}
        del u, sq
        scale = up * projector.packed_norm_factor(plan, lay, sqp) * lr
        out = rbd_step.reconstruct_apply_packed(seeds, scale, theta, lay,
                                                dist)
        ref = rbd_step.reconstruct_apply_packed_plain(seeds, scale, theta,
                                                      lay, dist)
        errs["reconstruct_apply_packed"] = _check_apply(tag, out, ref,
                                                        theta)
    return errs


def _checked_flash(errs: dict):
    """The flash wrapper, each call held against the plain version of the
    kernel it chose on the same inputs (row 11's gate); the largest
    |difference| and share of the tolerance go into ``errs``."""
    import torch
    from repro_torch.kernels import flash_attention as flash

    def attention(q, k, v, *, causal=True, **kw):
        out = flash.flash_attention(q, k, v, causal=causal, **kw)
        kernel = flash.kernel_for(q.dtype, q.shape[-1])
        ref, l = flash.flash_attention_plain(
            q, k, v, causal=causal, **kw, p_dtype=flash.P_DTYPE[kernel],
            return_l=True)
        d, ratio, _ = _flash_err(torch, out, ref, v, kernel,
                                 l if kernel == "wgmma" else None)
        errs[kernel] = max(errs.get(kernel, 0.0), d)
        errs["ratio"] = max(errs.get("ratio", 0.0), ratio)
        return out

    return attention


def _encdec_decode(cfg, model, params, frames, tokens, attention):
    """``prefill_cross_cache`` (the encoder through ``attention``), then one
    decode step per column of ``tokens`` (B, N): teacher-forced, or greedy
    from the first column when ``tokens`` is (B, 1) -- ENC_NEW steps.
    Returns (every step's logits (B, N, V) float32, the tokens fed (B, N),
    the prefill's flash launches by kernel, the prefill's and the decode's
    seconds, synchronized)."""
    import torch
    from repro_torch.kernels import rbd_step
    from repro_torch.models import encdec

    b = frames.shape[0]
    n = tokens.shape[1] if tokens.shape[1] > 1 else ENC_NEW
    with torch.no_grad():
        torch.cuda.synchronize()
        rbd_step.reset_counts()
        t = time.perf_counter()
        cache = encdec.prefill_cross_cache(
            cfg, params, model.init_cache(b, n, device="cuda"), frames,
            attention)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t
        variants = dict(rbd_step.VARIANT_LAUNCHES)
        fed, outs = [tokens[:, :1]], []
        t = time.perf_counter()
        for i in range(n):
            logits, cache = model.decode_step(params, cache, fed[-1])
            outs.append(logits[:, 0])
            if i + 1 < n:
                fed.append(tokens[:, i + 1:i + 2] if tokens.shape[1] > 1
                           else logits[:, 0].argmax(-1, keepdim=True))
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t
        check(int(cache["len"]) == n,
              f"{cfg.name}: len {int(cache['len'])} after {n} steps")
        check(dict(rbd_step.VARIANT_LAUNCHES) == variants,
              f"{cfg.name}: decode launched the flash kernel "
              f"({dict(rbd_step.VARIANT_LAUNCHES)}; prefill {variants})")
    return (torch.stack(outs, 1).float(), torch.cat(fed, 1), variants,
            t_prefill, t_decode)


def _encdec_serve(cfg, model, params, smi):
    """Phase 21 (b): ``prefill_cross_cache`` on ``cfg.enc_seq`` frames at
    batch ENC_DECODE_B and ENC_NEW greedy decode steps.  The encoder's
    output through the flash kernel against the same layers through the
    blockwise function, and every decoded position's logits against a
    teacher-forced ``forward`` on the fed tokens: in bf16 within
    PREFILL_LOGIT_RTOL of the largest magnitude, or twice what the route
    through the plain version reads (phase 20's rule); with f32 compute
    within PREFILL_F32_RTOL.  The prefill launches the flash kernel once a
    layer (bf16: all the tensor-core kernel's; f32: the CUDA-core one's),
    decode never.  Each layer's flash launch at this shape is held against
    its plain version on the same inputs (``_checked_flash``: in the
    kernel's encoder run, bf16, and in the f32 prefill).  Returns the bf16
    prefill's launches by kernel, the flash checks' largest |difference|
    by kernel and a log line."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import attention as attn
    from repro_torch.models import encdec, frontends
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model

    frames = frontends.audio_frames(cfg, ENC_DECODE_B, seed=21)
    gen = torch.Generator(device="cuda").manual_seed(21)
    first = torch.randint(0, cfg.vocab, (ENC_DECODE_B, 1), generator=gen,
                          device="cuda")
    cparams = L.cast_for_compute(params, L.dtype_of(cfg.compute_dtype))
    n_enc = cfg.n_enc_layers
    flash_errs = {}
    checked = _checked_flash(flash_errs)
    with torch.no_grad():
        enc = {name: encdec.encode(cfg, cparams, frames, fn).float()
               for name, fn in (("kernel", checked),
                                ("plain", flash.flash_attention_plain),
                                ("blockwise", attn.flash_attention))}
        e_scale = float(enc["blockwise"].abs().max())
        e_d = float((enc["kernel"] - enc["blockwise"]).abs().max())
        e_sound = float((enc["plain"] - enc["blockwise"]).abs().max())
        e_plain = float((enc["kernel"] - enc["plain"]).abs().max())
        e_tol = max(PREFILL_LOGIT_RTOL * e_scale, ZOO_SOUND_FACTOR * e_sound)
        del enc
        check(e_d <= e_tol, f"{cfg.name}: the encoder's output through the "
              f"kernel off the blockwise function's by {e_d:.4g} > "
              f"{e_tol:.4g}")
        # the main path: the encoder through the kernel, greedy decode
        logits, fed, variants, t_prefill, t_decode = _encdec_decode(
            cfg, model, params, frames, first, flash.flash_attention)
        want = {"flash_attention[wgmma]": n_enc}
        check(variants == want, f"{cfg.name}: the bf16 prefill's flash "
              f"launches {variants}, expected {want}")
        full, _ = model.forward(params, {"tokens": fed, "frames": frames})
        scale = float(full.abs().max())
        d = float((logits - full).abs().max())
        # the second sound route: the encoder through the plain version,
        # teacher-forced on the same tokens
        sound = _encdec_decode(cfg, model, params, frames, fed,
                               flash.flash_attention_plain)[0]
        d_sound = float((sound - full).abs().max())
        tol = max(PREFILL_LOGIT_RTOL * scale, ZOO_SOUND_FACTOR * d_sound)
        check(d <= tol, f"{cfg.name}: decoded logits off forward's by "
              f"{d:.4g} > {tol:.4g} ({d / scale:.3%} of max|logits|)")
        agree = float((full.argmax(-1)[:, :-1] == fed[:, 1:]).float().mean())
        del full, sound
        # f32 compute: the two routes differ by f32 rounding only
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        model32 = get_model(cfg32)
        l32, _, variants32, _, _ = _encdec_decode(
            cfg32, model32, params, frames, fed, checked)
        check(variants32 == {"flash_attention[fma]": n_enc},
              f"{cfg.name}: the f32 prefill's flash launches {variants32}")
        full32, _ = model32.forward(params, {"tokens": fed,
                                             "frames": frames})
        scale32 = float(full32.abs().max())
        d32 = float((l32 - full32).abs().max())
        del l32, full32
        n_new = fed.shape[1]
        check(d32 <= PREFILL_F32_RTOL * scale32,
              f"{cfg.name}: f32 decoded logits off forward's by {d32:.4g} "
              f"({d32 / scale32:.3g} of max|logits|)")
    line = (f"encoder output (batch {ENC_DECODE_B} x {frames.shape[1]} "
            f"frames) through the kernel vs the blockwise function max|d| "
            f"{e_d:.4g} of {e_scale:.4g} ({e_d / e_scale:.3%}; the plain "
            f"version {e_sound / e_scale:.3%}, kernel vs plain "
            f"{e_plain / e_scale:.3%}; tolerance {e_tol / e_scale:.3%}); "
            f"each layer's flash launch vs its plain version on the same "
            f"inputs max|d| wgmma {flash_errs['wgmma']:.3g}, fma "
            f"{flash_errs['fma']:.3g}, at most {flash_errs['ratio']:.3g} "
            f"of row 11's tolerance; "
            f"prefill_cross_cache {1e3 * t_prefill:.1f} ms, {variants}; "
            f"{n_new} greedy decode steps {1e3 * t_decode / n_new:.2f} ms "
            f"a token, none launching flash; every "
            f"position's logits vs teacher-forced forward max|d| {d:.4g} "
            f"of {scale:.4g} ({d / scale:.3%}; the plain route "
            f"{d_sound / scale:.3%}; tolerance {tol / scale:.3%}); "
            f"forward's argmax is the next greedy token at {agree:.1%} of "
            f"positions; f32 compute {d32 / scale32:.3g} of max|logits| "
            f"(tolerance {PREFILL_F32_RTOL:g}; {variants32}) [{smi}]")
    return variants, flash_errs, line


def _queued_ms(torch, fn, reps: int) -> float:
    """Device ms of one of ``reps`` calls of ``fn`` queued back to back
    behind ENC_SLEEP_CYCLES of ``torch.cuda._sleep``: the host issues the
    calls while the stream sleeps, so the events bracket the device's work
    alone (as long as the sleep outlasts the issue)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(ENC_SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _encoder_flash(dev) -> dict:
    """Phase 21 (c): the tensor-core flash kernel alone at the encoder's
    shape (ENC_FLASH: B = 1, 6 / 6 heads of 64, Sq = Sk = 1,500,
    non-causal, bf16) against the plain version with P rounded to bf16
    within row 11's gate, reruns bit-identical, timed in turns with
    ``scaled_dot_product_attention`` (bursts of ENC_FLASH_BURST: queued
    behind a sleep for the device's time, issued back to back for the
    host's pace), the plain version once.  Returns the kernels line's
    numbers."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rbd_step

    h, kv, hd, s = ENC_FLASH
    smi = dev["smi"]
    key = "flash_attention[wgmma]"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        q, k, v = _flash_inputs(torch, 1, s, s, h, kv, hd, torch.bfloat16,
                                s + hd)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        check(flash.kernel_for(q.dtype, hd) == "wgmma",
              f"bf16 at hd {hd} does not take the tensor-core kernel")
        runs = {"wgmma": lambda: flash.flash_attention(q, k, v,
                                                       causal=False),
                "library": lambda: sdpa(qt, kt, vt)}
        before = rbd_step.VARIANT_LAUNCHES.get(key, 0)
        out, again = runs["wgmma"](), runs["wgmma"]()
        ref, l = flash.flash_attention_plain(q, k, v, causal=False,
                                             p_dtype=torch.bfloat16,
                                             return_l=True)
        torch.cuda.synchronize()
        check(rbd_step.VARIANT_LAUNCHES.get(key, 0) == before + 2,
              "the encoder-shape flash case did not run the tensor-core "
              "kernel")
        check(torch.equal(out, again), "encoder-shape flash rerun differs")
        d, ratio, rel = _flash_err(torch, out, ref, v, "wgmma", l)
        lib_d = float((runs["library"]().transpose(1, 2).float()
                       - ref.float()).abs().max())
        plain_ms = cuda_ms(lambda: flash.flash_attention_plain(
            q, k, v, causal=False, p_dtype=torch.bfloat16))[0]
        # a launch here is shorter than the host's time to issue one, so
        # a burst issued back to back measures the host; the device's
        # time is read with the burst queued behind a sleep of the stream
        times = {name: [] for name in runs}
        issued = {name: [] for name in runs}
        for name in ("wgmma", "library", "library", "wgmma"):
            runs[name]()                                   # warm
            queued = [_queued_ms(torch, runs[name], ENC_FLASH_BURST)
                      for _ in range(3)]
            times[name].append(sorted(queued)[1])
            burst = cuda_ms(lambda: [runs[name]()
                                     for _ in range(ENC_FLASH_BURST)],
                            repeat=3)
            issued[name].append(sorted(burst)[1] / ENC_FLASH_BURST)
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        ms_issued = {name: sum(t) / len(t) for name, t in issued.items()}
        b_ms, by = flash_bound_ms(1, s, s, h, kv, hd, "bfloat16",
                                  causal=False)
        ctas = -(-s // flash.Q_BLOCK) * h
        log(f"  (c) flash [wgmma] encoder shape, heads {h}/{kv} x {hd}, "
            f"Sq = Sk = {s}, non-causal, bf16: {ms['wgmma']:.4f} ms on the "
            f"device (turns {[round(t, 4) for t in times['wgmma']]}; "
            f"issued back to back {ms_issued['wgmma']:.4f}), sdpa "
            f"{ms['library']:.4f} ms (turns "
            f"{[round(t, 4) for t in times['library']]}; issued back to "
            f"back {ms_issued['library']:.4f}), bound "
            f"{b_ms:.4f} ({by}), {b_ms / ms['wgmma']:.2%} of bound; "
            f"{ctas} CTAs ({-(-s // flash.Q_BLOCK)} query blocks x {h} "
            f"heads) for {dev['sms']} SMs; vs plain max|d| {d:.3g} "
            f"({ratio:.3g} of the tolerance, relative L2 {rel:.3g}), rerun "
            f"bit-identical; plain {plain_ms:.2f} ms; sdpa vs the plain "
            f"version max|d| {lib_d:.3g} [{smi}]")
        del q, k, v, qt, kt, vt, out, again, ref, l, runs
    return {"max_abs_err": d, "ms": ms["wgmma"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": ms["library"]}


def _vision_step(apply, params, x, y, transform, step, lr):
    """One step of the reference's acceptance loop (tests/test_system.py:
    _train): the loss gradient, its RBD sketch (``rbd_gradient``, one
    ``project_flat`` and one ``reconstruct_flat`` launch a leaf on the
    cuda backend), theta - lr * sketch.  Returns (params, loss, grads,
    sketch)."""
    import torch
    from repro_torch.core import projector

    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = torch.nn.functional.cross_entropy(apply(p, x), y)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    sketch = projector.rbd_gradient(grads, transform.plan,
                                    transform.step_seed(step),
                                    backend=transform.backend)
    with torch.no_grad():
        new = {k: v.detach() - lr * sketch[k] for k, v in p.items()}
    return new, loss.detach(), grads, sketch


def _vision_train(name, shape, dim, lr, steps, *, seed=0, redraw=True,
                  batch=32, noise=1.0, after_step=None):
    """``steps`` RBD (or FPD: ``redraw=False``) steps of image model
    ``name`` (parameters of seed 0, the data and the basis of ``seed``) on
    the per-leaf kernels; ``after_step(step, transform, grads, sketch)``
    runs after each step, outside its wall.  Returns (apply, params,
    transform, losses, step walls)."""
    import torch
    from repro_torch.core import compartments
    from repro_torch.core.rbd import RandomBasesTransform
    from repro_torch.data import synthetic
    from repro_torch.models import vision

    init, apply = vision.get_vision_model(name)
    params = init(0, shape)
    plan = compartments.make_plan(params, dim)
    t = RandomBasesTransform(plan, seed, redraw=redraw, backend="cuda")
    data = synthetic.mixture_dataset(seed, batch, shape=shape, noise=noise,
                                     device="cuda")
    losses, walls = [], []
    for step in range(steps):
        x, y = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss, grads, sketch = _vision_step(apply, params, x, y, t,
                                                   step, lr)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        if after_step is not None:
            after_step(step, t, grads, sketch)
    return apply, params, t, [float(x) for x in losses], walls


def _accuracy(apply, params, shape) -> float:
    """On the 512 images of the reference's evaluation set (noise 0.8),
    drawn here from the generator seeded 99."""
    import torch
    from repro_torch.data import synthetic

    x, y = synthetic.mixture_images(torch.Generator().manual_seed(99),
                                    VISION_EVAL, shape=shape, noise=0.8,
                                    device="cuda")
    with torch.no_grad():
        return float((apply(params, x).argmax(-1) == y).float().mean())


def _vision_runs(smi) -> dict:
    """Phase 21 (d): FC, CNN and ResNet8 at VISION_RUN's geometry through
    the per-leaf kernels, the first step's sketch against the torch
    backend's, launches one a leaf a step; the reference's acceptance run
    (gate: accuracy > 0.5); RBD against FPD (reported).  Returns the
    launches of ``project_flat`` and ``reconstruct_flat``."""
    from repro_torch.core import projector
    from repro_torch.kernels import rbd_step
    from repro_torch.models import vision

    totals = {"project_flat": 0, "reconstruct_flat": 0}
    shape, batch, dim, steps = VISION_RUN
    for name in sorted(vision.MODELS):
        worst = [0.0]

        def after_step(step, t, grads, sketch, name=name, worst=worst):
            n = len(t.plan.leaves) * (step + 1)
            want = {"project_flat": n, "reconstruct_flat": n}
            got = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
            check(got == want, f"{name}: launches {got} after step {step}, "
                  f"expected {want}")
            if step:
                return
            # the kernels' sketch against the torch backend's on the same
            # gradient, leaf by leaf at phase 12's reconstruct tolerance
            # (the coordinates' error, U_RTOL, is below it)
            plain = projector.rbd_gradient(grads, t.plan, t.step_seed(0),
                                           backend="torch")
            for k in plain:
                dd = float((sketch[k] - plain[k]).abs().max())
                lim = THETA_RTOL * float(plain[k].abs().max())
                check(dd <= lim, f"{name}/{k}: the kernels' sketch off "
                      f"the torch backend's by {dd:.3g} > {lim:.3g}")
                worst[0] = max(worst[0], dd / max(lim, 1e-30))

        rbd_step.reset_counts()
        _, params, t, losses, walls = _vision_train(
            name, shape, dim, VISION_LR, steps, batch=batch,
            after_step=after_step)
        check(all(math.isfinite(x) for x in losses),
              f"{name}: losses {losses}")
        for k in totals:
            totals[k] += rbd_step.LAUNCHES[k]
        # the host's share: the step seed and every leaf's compartment
        # seeds, folded by Threefry in torch ops on the host, which
        # rbd_gradient does twice a step (projection, reconstruction)
        seed = t.step_seed(steps)
        t0 = time.perf_counter()
        for lp in t.plan.leaves:
            projector._leaf_seeds(seed, lp)
        seeds_ms = 1e3 * (time.perf_counter() - t0)
        log(f"  (d) {name} at {shape}, batch {batch}, make_plan(params, "
            f"{dim}): {vision.count_params(params):,} parameters, "
            f"{len(t.plan.leaves)} leaves, total_dim {t.plan.total_dim}; "
            f"{steps} steps, {rbd_step.LAUNCHES['project_flat']} "
            f"project_flat + {rbd_step.LAUNCHES['reconstruct_flat']} "
            f"reconstruct_flat launches (one a leaf a step); first sketch "
            f"vs the torch backend at most {worst[0]:.3g} of the "
            f"tolerance; losses {[round(x, 4) for x in losses]}; step wall "
            f"{[round(1e3 * w, 2) for w in walls]} ms, of which the host "
            f"folds the seeds twice: {seeds_ms:.2f} ms a pass over the "
            f"leaves [{smi}]")
    # the reference's acceptance run (tests/test_system.py:55)
    shape, dim, lr, steps = VISION_ACCEPT
    rbd_step.reset_counts()
    apply, params, t, losses, walls = _vision_train(
        "fc", shape, dim, lr, steps, noise=0.8)
    acc = _accuracy(apply, params, shape)
    for k in totals:
        check(rbd_step.LAUNCHES[k] == len(t.plan.leaves) * steps,
              f"acceptance run: {rbd_step.LAUNCHES[k]} {k} launches")
        totals[k] += rbd_step.LAUNCHES[k]
    check(acc > 0.5, f"RBD failed to learn: accuracy {acc}")
    log(f"  (d) acceptance (FC at {shape}, make_plan(params, {dim}), lr "
        f"{lr}, {steps} steps of 32 at noise 0.8): accuracy {acc:.4f} on "
        f"{VISION_EVAL} images (gate > 0.5); last loss {losses[-1]:.4f}; "
        f"median step {1e3 * statistics.median(walls):.2f} ms [{smi}]")
    # RBD against FPD at equal dimension (tests/test_system.py:63)
    dim, steps, seeds = VISION_FPD
    accs, last = {}, {}
    rbd_step.reset_counts()
    for mode, redraw in (("rbd", True), ("fpd", False)):
        for s in range(seeds):
            apply, params, _, losses, _ = _vision_train(
                "fc", shape, dim, lr, steps, seed=s, redraw=redraw,
                noise=0.8)
            accs.setdefault(mode, []).append(
                round(_accuracy(apply, params, shape), 4))
            last.setdefault(mode, []).append(round(losses[-1], 4))
    for k in totals:
        totals[k] += rbd_step.LAUNCHES[k]
    mean = {m: sum(a) / len(a) for m, a in accs.items()}
    log(f"  (d) RBD vs FPD (FC, make_plan(params, {dim}), {steps} steps, "
        f"seeds {list(range(seeds))}): accuracy rbd {accs['rbd']} (mean "
        f"{mean['rbd']:.4f}), fpd {accs['fpd']} (mean {mean['fpd']:.4f}); "
        f"last losses rbd {last['rbd']}, fpd {last['fpd']}; RBD "
        f"{'above' if mean['rbd'] > mean['fpd'] else 'NOT above'} FPD "
        f"(reported, not gated: the port's data are torch draws) [{smi}]")
    return totals


def phase_encdec_vision(dev) -> tuple[dict, dict, dict]:
    """Returns the phase's launches by kernel row (rows 1-2: whisper's
    packed steps; 8-9: the image models' steps; 11: the bf16 prefill's
    encoder), the kernels line's row of the flash kernel at the encoder's
    shape and rows 1-2's largest |difference| from their plain versions
    at whisper's layout."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models.registry import get_model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smi = dev["smi"]
    log("== phase 21: the encoder-decoder (whisper-tiny at full width and "
        "depth) and the paper's image models")
    cfg = get_config("whisper-tiny")
    model = get_model(cfg)
    b, s, rbd_dim, steps = ENC_TRAIN
    state, sub, launches, line = _zoo_train(cfg, model, b, s, rbd_dim,
                                            steps, smi)
    log(f"  (a) {cfg.name} {cfg.n_enc_layers} + {cfg.n_layers} layers, "
        f"batch {b} x ({cfg.enc_seq} frames + {s} tokens), rbd-dim "
        f"{rbd_dim}, {steps} steps: " + line)
    t1 = time.perf_counter()
    errs = _packed_vs_plain(model, state, sub, model.make_batch(
        InputShape("zoo", s, b, "train"), seed=steps, device="cuda"))
    log(f"  (a) {cfg.name}: rows 1-2 vs their plain versions on step "
        f"{state.step}'s gradient, seeds and theta at the packed layout "
        f"{errs} ({time.perf_counter() - t1:.1f} s) [{smi}]")
    params = sub.materialize_params(state.params)
    del state, sub
    variants, flash_errs, line = _encdec_serve(cfg, model, params, smi)
    log(f"  (b) {cfg.name}: " + line)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    row = _encoder_flash(dev)
    row["max_abs_err"] = max(row["max_abs_err"], flash_errs["wgmma"])
    totals = dict(launches)
    totals["flash_attention"] = variants["flash_attention[wgmma]"]
    totals.update(_vision_runs(smi))
    h, kv, hd, s = ENC_FLASH
    row = {"name": f"flash_attention[wgmma] non-causal S{s}",
           "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_wgmma.cuh",
           "replaces": REPLACES["flash_attention"],
           "launches": totals["flash_attention"],
           **row}
    log(f"  encdec / vision launches {totals}")
    log(f"  phase 21 took {time.perf_counter() - t0:.1f} s")
    return totals, row, errs


# ---------------------------------------------------------------------------
# phase 22: the tools -- the quickstart, NES, train_lm, loop.train
# ---------------------------------------------------------------------------

QUICK_PLAIN_STEPS = 5      # (a) steps held against the plain backend
QUICK_LOSS_RTOL = 1e-6     # (a) kernels vs plain versions, relative
QUICK_ACCEPT = 0.5         # (a) the reference's gate for RBD on FC
NES_RUN = (250, 0.02)      # (b) d, sigma (the quickstart's plan)
NES_COSINE = 0.99          # (b) the reference's collinearity gate
LM_BUDGET_S = 12.0         # (c) the train_lm run's share of the phase
LM_STEPS = (2, 3)          # (c) fewest and most steps
LOOP_STEPS = 3             # (d) phase 4's steps
LOOP_EVAL_EVERY = 2
LOOP_CKPT_EVERY = 3
LOOP_LOG_EVERY = 2         # step 1 is not a log boundary
PHASE4 = {}                # phase 4's losses and rows 1-2's ms per value
PHASE13 = {}               # phase 13's fused_per_leaf losses


@contextlib.contextmanager
def _marked_steps(losses: list):
    """Every ``train_step`` that ``train.step.make_train_step`` builds
    while this is open (the launcher's and ``train.loop``'s) leaves a
    "step begin" and a "step end" mark for :func:`_sync_timeline` and
    appends its loss (a device tensor: no read) to ``losses``.  A caller
    that bound the name some other way leaves no marks, and its check of
    the number of marked steps fails."""
    from repro_torch.train import loop
    from repro_torch.train import step as steplib

    make = steplib.make_train_step

    def marked(*args, **kw):
        init_state, train_step, *rest = make(*args, **kw)

        def step(state, batch):
            _mark("step begin")
            state, metrics = train_step(state, batch)
            losses.append(metrics["loss"])
            _mark("step end")
            return state, metrics

        return (init_state, step, *rest)

    steplib.make_train_step = loop.make_train_step = marked
    try:
        yield
    finally:
        steplib.make_train_step = loop.make_train_step = make


def _mark(text: str) -> None:
    import warnings

    warnings.warn(MARK + text, stacklevel=2)


def _by_step(timeline) -> list[dict]:
    """A marked timeline cut into steps (each from its "step begin" to the
    next), each step's synchronizing operations by where they ran:
    ``step`` (inside train_step), ``eval`` (inside the evaluation),
    ``ckpt`` (the checkpoint's copies) and ``loop`` (the rest: the next
    batch's host-to-device copy, reads of the metrics, observes)."""
    steps, where = [], None
    for kind, what in timeline:
        if kind == "mark":
            if what == "step begin":
                steps.append({"step": [], "eval": [], "ckpt": [],
                              "loop": []})
            where = {"step begin": "step", "eval begin": "eval"}.get(
                what, "loop")
        elif steps:
            part = ("ckpt" if where == "loop" and "checkpoint/" in what
                    else where)
            steps[-1][part].append(what)
    return steps


def _launcher_guarded_syncs(cfg) -> dict:
    """The synchronizing operations of the launcher's guarded step
    (``run_training`` with ``--guard``, phase 4's arguments, 3 steps):
    step 1's, the first after the one-time uploads, inside train_step
    and in the launcher's loop (its per-step loss read and observe, the
    next batch's copy)."""
    import torch
    from repro_torch.core import resilience as res
    from repro_torch.launch import train as launcher

    losses = []
    with _marked_steps(losses):
        steps = _by_step(_sync_timeline(torch, lambda: launcher.run_training(
            cfg, mode="sharedseed", data=1, steps=LOOP_STEPS, batch=8,
            seq=128, rbd_dim=1024, rbd_backend="cuda", device="cuda",
            resilience=res.ResilienceConfig(guard=res.GuardConfig()))))
    check(len(steps) == LOOP_STEPS, f"{len(steps)} marked launcher steps")
    return {k: len(v) for k, v in steps[1].items()}


def _quickstart_step0(plan) -> dict:
    """(a) The quickstart's two kernels at its plan against their plain
    versions on the inputs of its step 0: the loss gradient of its
    initial parameters on its first batch and that step's compartment
    seeds (``project_flat``: u and the row norms), and the update's scale
    (the plain coordinates through 'exact', twice, times the learning
    rate: ``reconstruct_flat``); phase 12's gates.  Returns max|err| by
    kernel."""
    import torch
    from repro_torch.core import projector
    from repro_torch.core.rbd import RandomBasesTransform
    from repro_torch.data import synthetic
    from repro_torch.examples import quickstart
    from repro_torch.kernels import rbd_project, rbd_reconstruct
    from repro_torch.models import vision

    init, apply = vision.get_vision_model("fc")
    params = {k: v.requires_grad_(True) for k, v in
              init(0, quickstart.SHAPE, device="cuda").items()}
    x, y = next(synthetic.mixture_dataset(0, quickstart.BATCH,
                                          shape=quickstart.SHAPE,
                                          noise=quickstart.NOISE,
                                          device="cuda"))
    loss = quickstart.cross_entropy(apply, params, x, y)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    (lp,) = plan.leaves
    seeds = projector._leaf_seeds(
        RandomBasesTransform(plan, base_seed=0).step_seed(0), lp)
    g = projector._ravel_tree(grads, plan)          # (n_stack, Q)
    q, dist, case = lp.size, plan.distribution, "(a) quickstart step 0"
    with torch.no_grad():
        u, sq = rbd_project.project_flat(seeds, g, lp.dim, dist)
        up, sqp = rbd_project.project_flat_plain(seeds, g, lp.dim, dist)
        errs = {"project_flat": _check_flat_project(case, u, sq, up, sqp,
                                                    g)}
        scale = quickstart.LR * projector._recon_scale(
            plan, lp, seeds, projector._norm_scales(plan, lp, up, sqp),
            None, sqp)
        errs["reconstruct_flat"] = _check_delta(
            case, rbd_reconstruct.reconstruct_flat(seeds, scale, q, dist),
            rbd_reconstruct.reconstruct_flat_plain(seeds, scale, q, dist))
    return errs


def _quickstart_run(smi) -> dict:
    """(a) The quickstart at its own settings on the card, one
    ``project_flat`` and one ``reconstruct_flat`` a step (a flattened
    plan reconstructs, then subtracts: the reference's
    ``reconstruct_apply``), its first steps against the plain backend's,
    its step 0's kernels against their plain versions."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import rbd_step

    rbd_step.reset_counts()
    out = quickstart.main([])
    launches = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
    steps = quickstart.STEPS
    check(out["eplan"].strategy == "fused_per_leaf",
          f"(a) plans {out['eplan'].strategy}")
    check(launches == {"project_flat": steps, "reconstruct_flat": steps},
          f"(a) expected one project_flat and one reconstruct_flat a step "
          f"over {steps} steps, got {launches}")
    acc = out["accuracy"][steps - 1]
    check(all(math.isfinite(x) for x in out["losses"]),
          "(a) non-finite losses")
    check(acc > QUICK_ACCEPT, f"(a) accuracy {acc} at step {steps - 1}, "
          f"gate > {QUICK_ACCEPT}")
    rbd_step.reset_counts()
    plain = quickstart.main(["--steps", str(QUICK_PLAIN_STEPS)],
                            backend="torch")
    check(sum(rbd_step.LAUNCHES.values()) == 0,
          f"the plain backend launched {dict(rbd_step.LAUNCHES)}")
    head = out["losses"][:QUICK_PLAIN_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(head, plain["losses"]))
    check(rel <= QUICK_LOSS_RTOL, f"(a) first {QUICK_PLAIN_STEPS} losses "
          f"{head} vs the plain backend's {plain['losses']}: {rel:.3g} > "
          f"{QUICK_LOSS_RTOL}")
    errs = _quickstart_step0(out["plan"])
    ms = 1e3 * out["wall"] / steps
    log(f"  (a) quickstart (FC at 28 x 28 x 1, D 101,770, global exact d "
        f"250, lr 2.0, batch 32, {steps} steps): launches {launches}; "
        f"accuracy {[(s, round(a, 4)) for s, a in out['accuracy'].items()]}"
        f" (gate > {QUICK_ACCEPT} at step {steps - 1}); first "
        f"{QUICK_PLAIN_STEPS} losses {[round(x, 6) for x in head]}, the "
        f"plain backend's within {rel:.3g} relative (tol "
        f"{QUICK_LOSS_RTOL}); step 0's kernels vs their plain versions "
        f"max|err| {errs}; {ms:.3f} ms a step over {out['wall']:.2f} s "
        f"with 7 evaluations of 2,048 images [{smi}]")
    return {"launches": launches, "acc": acc, "ms": ms, "errs": errs}


def _nes_run(smi) -> dict:
    """(b) NES at the quickstart's width: one batch, its reconstruction
    launches counted, its cosine with the RBD sketch at the same seed,
    the kernel's delta against the plain version on the same
    coordinates."""
    import torch
    from repro_torch.core import compartments, nes, projector, rng
    from repro_torch.data import synthetic
    from repro_torch.examples import quickstart
    from repro_torch.kernels import rbd_step
    from repro_torch.models import vision

    init, apply = vision.get_vision_model("fc")
    params = init(0, quickstart.SHAPE, device="cuda")
    x, y = next(synthetic.mixture_dataset(0, quickstart.BATCH,
                                          shape=quickstart.SHAPE,
                                          noise=quickstart.NOISE,
                                          device="cuda"))
    dim, sigma = NES_RUN
    plan = compartments.make_plan(params, dim, granularity="global",
                                  normalization="exact")
    seed = rng.fold_seed(1)

    def loss(p):
        return quickstart.cross_entropy(apply, p, x, y)

    nes.nes_gradient(loss, params, plan, seed, sigma=sigma)   # warm-up
    rbd_step.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    est = nes.nes_gradient(loss, params, plan, seed, sigma=sigma)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
    check(launches == {"project_flat": 1, "reconstruct_flat": 1},
          f"(b) expected one norm pass and one reconstruction, {launches}")
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
    sketch = projector.rbd_gradient(grads, plan, seed, backend="cuda")
    a = torch.cat([est[k].reshape(-1) for k in params]).double()
    b = torch.cat([sketch[k].reshape(-1) for k in params]).double()
    cos = float(a @ b / (a.norm() * b.norm()))
    check(cos > NES_COSINE, f"(b) NES vs the RBD sketch: cosine {cos}")
    coords = nes.nes_coordinates(loss, params, plan, seed, sigma=sigma)
    kern = projector.reconstruct(coords, plan, seed, params, backend="cuda")
    plain = projector.reconstruct(coords, plan, seed, params,
                                  backend="torch")
    err, worst = 0.0, 0.0
    for k in plain:
        d = float((kern[k] - plain[k]).abs().max())
        lim = THETA_RTOL * float(plain[k].abs().max())
        check(d <= lim, f"(b) {k}: the kernels' delta off the plain "
              f"version's by {d:.3g} > {lim:.3g}")
        err, worst = max(err, d), max(worst, d / max(lim, 1e-30))
    log(f"  (b) NES (FC at 28 x 28 x 1, global exact d {dim}, sigma "
        f"{sigma}, one batch of {quickstart.BATCH}): {2 * dim} forward "
        f"passes in {1e3 * wall:.1f} ms, launches {launches}; cosine with "
        f"the RBD sketch at the same seed {cos:.6f} (gate > {NES_COSINE}); "
        f"the kernels' delta vs the plain version on the same coordinates "
        f"max|d| {err:.3g}, {worst:.3g} of the tolerance [{smi}]")
    return {"launches": launches, "errs": {"reconstruct_flat": err},
            "ms": 1e3 * wall, "cos": cos}


def _train_lm_run(smi) -> dict:
    """(c) ``examples.train_lm`` at its own config on one card: the step
    count from the plan's live basis values at rows 1-2's measured rate,
    2 launches a step, finite losses, the preamble's numbers those of
    ``make_plan`` / ``grad_comm_bytes``; rows 1-2 against their plain
    versions at its layout on the next step's inputs."""
    import torch
    from repro_torch.configs.base import RBDConfig
    from repro_torch.core import distributed
    from repro_torch.data import synthetic
    from repro_torch.examples import train_lm
    from repro_torch.kernels import rbd_step
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    cfg = train_lm.qwen2_100m()
    rbd_dim = 4096
    plan = steplib.make_plan(get_model(cfg), RBDConfig(total_dim=rbd_dim))
    lay = plan.packed()
    live = int((lay.seg_dim * lay.seg_size).sum())
    # rows 1-2 at qwen2-0.5b (phase 4; PERF.md's 221.6 + 235.4 ms for
    # 4.130e10 live values when phase 4 did not run)
    rate = PHASE4.get("ms_per_value", (221.6 + 235.4) / 4.130e10)
    est = live * rate / 1e3
    steps = max(LM_STEPS[0], min(LM_STEPS[1], int(LM_BUDGET_S / est) - 1))
    log(f"  (c) train_lm: {live:,} live basis values a pass (q_packed "
        f"{lay.q_packed:,}, d_packed {lay.d_packed}); at rows 1-2's "
        f"{rate * 1e9:.3f} ms per 1e9 values a step's launches take ~"
        f"{1e3 * est:.0f} ms: {steps} steps")
    rbd_step.reset_counts()
    rbd_step.set_timing(True)
    out = train_lm.main(["--workers", "1", "--steps", str(steps),
                         "--rbd-dim", str(rbd_dim)])
    kms = rbd_step.kernel_times_ms()
    rbd_step.set_timing(False)
    res = out["result"]
    launches = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
    check(launches == {"project_packed": steps,
                       "reconstruct_apply_packed": steps},
          f"(c) expected 2 launches a step, got {launches}")
    check(all(math.isfinite(x) for x in res.losses), f"(c) {res.losses}")
    check(res.sub_opt.plan_execution().strategy == "fused_packed",
          "(c) not the packed step")
    n_params = sum(int(math.prod(s)) for s in
                   get_model(cfg).param_shapes().values())
    check(out["n_params"] == n_params == plan.total_params
          and out["plan"].total_dim == plan.total_dim
          == res.sub_opt.transform.plan.total_dim
          and out["plan"].reduction_factor == plan.reduction_factor,
          f"(c) preamble D / d / reduction {out['n_params']} "
          f"{out['plan'].total_dim} {out['plan'].reduction_factor}")
    for m, c in out["comm"].items():
        check(c == distributed.grad_comm_bytes(plan, n_params, 1, m),
              f"(c) preamble traffic {m}: {c}")
    # the launcher's stream (seed 0) past the run's batches
    t1 = time.perf_counter()
    batch = next(synthetic.lm_batches(0, train_lm.BATCH, train_lm.SEQ,
                                      cfg.vocab, device="cuda").skip(steps))
    errs = _packed_vs_plain(get_model(cfg), res.state, res.sub_opt, batch,
                            lr=train_lm.LR)
    log(f"  (c) train_lm: rows 1-2 vs their plain versions on step "
        f"{res.state.step}'s gradient, seeds and theta at the packed layout "
        f"{errs} ({time.perf_counter() - t1:.1f} s) [{smi}]")
    del batch
    walls = res.step_seconds
    ms = {k: [round(x, 2) for x in v] for k, v in kms.items() if v}
    log(f"  (c) train_lm --workers 1 (qwen2-100m: D {n_params:,}, d "
        f"{plan.total_dim}, {plan.reduction_factor:.0f}x; batch 16 x 256, "
        f"lr 0.5): losses {[round(x, 4) for x in res.losses]}; step wall "
        f"{[round(x, 3) for x in walls]} s; launch ms {ms}; peak "
        f"{res.peak_bytes / 2**30:.2f} GiB; preamble {out['lines']} "
        f"[{smi}]")
    med = statistics.median(walls[1:] or walls)
    del out, res
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "step_s": med,
            "errs": errs}


def _loop_run(smi, phase4_losses) -> dict:
    """(d) ``train.loop.train`` on qwen2-0.5b at full width and depth with
    phase 4's arguments, an evaluation every 2 steps, a checkpoint every
    3, the guard on: its losses against phase 4's; the synchronizing
    operations of each step (train_step, the evaluation, the checkpoint
    and the loop's own) against the launcher's guarded step."""
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.core import resilience as res
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_step
    from repro_torch.models.registry import get_model
    from repro_torch.train import loop
    from repro_torch.train import step as steplib

    cfg = get_config("qwen2-0.5b")
    launcher_step = _launcher_guarded_syncs(cfg)
    model = get_model(cfg)
    # phase 4's run: the launcher's defaults at rbd-dim 1024, 8 x 128
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=1024,
                                                backend="cuda"),
                       learning_rate=0.125, steps=LOOP_STEPS, batch_size=8,
                       seq_len=128)
    held = next(synthetic.lm_batches(1, 8, 128, cfg.vocab, device="cuda"))
    loss_fn = steplib.make_loss_fn(model, cfg.router_aux_coef)

    def eval_fn(params):
        _mark("eval begin")
        with torch.no_grad():
            out = loss_fn(params, held)[0]
        _mark("eval end")
        return out

    directory = os.path.join(ROOT, "build", "loop_smoke")
    shutil.rmtree(directory, ignore_errors=True)
    result, step_losses = {}, []
    rbd_step.reset_counts()
    try:
        t = time.perf_counter()
        with _marked_steps(step_losses):
            timeline = _sync_timeline(torch, lambda: result.update(
                out=loop.train(
                    model, tcfg, synthetic.lm_batches(0, 8, 128, cfg.vocab,
                                                      device="cuda"),
                    eval_fn=eval_fn, eval_every=LOOP_EVAL_EVERY,
                    log_every=LOOP_LOG_EVERY, checkpoint_dir=directory,
                    checkpoint_every=LOOP_CKPT_EVERY,
                    resilience=res.ResilienceConfig(
                        guard=res.GuardConfig()))))
        wall = time.perf_counter() - t
        state, hist, monitor = result["out"]
        launches = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
        ckpts = sorted(os.listdir(directory))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    losses = [float(x) for x in step_losses]
    check(launches == {"project_packed": LOOP_STEPS,
                       "reconstruct_apply_packed": LOOP_STEPS},
          f"(d) expected 2 launches a step, got {launches}")
    check(state.step == LOOP_STEPS and len(losses) == LOOP_STEPS,
          f"(d) {state.step} steps, losses {losses}")
    logged = {h["step"]: h["loss"] for h in hist if "loss" in h}
    check(logged == {s: losses[s] for s in (0, LOOP_STEPS - 1)},
          f"(d) history {hist}, losses {losses}")
    evals = {h["step"]: h["eval"] for h in hist if "eval" in h}
    check(sorted(evals) == [1] and all(map(math.isfinite, evals.values())),
          f"(d) evaluations {evals}")
    check(ckpts == ["ckpt_00000002.json", "ckpt_00000002.npz"],
          f"(d) checkpoint files {ckpts}")
    check(monitor.events == [], f"(d) recovery events {monitor.events}")
    same = losses == list(phase4_losses)
    if phase4_losses:
        check(same, f"(d) losses {losses} differ from phase 4's "
              f"{list(phase4_losses)}")
    steps = _by_step(timeline)
    check(len(steps) == LOOP_STEPS, f"(d) {len(steps)} marked steps")
    counts = [{k: len(v) for k, v in s.items()} for s in steps]
    # step 1: after the one-time uploads, not a log boundary
    ours = counts[1]["step"] + counts[1]["loop"]
    theirs = launcher_step["step"] + launcher_step["loop"]
    check(ours <= theirs, f"(d) step 1 of the loop synchronizes {ours} "
          f"times (evaluation apart), the launcher's guarded step {theirs}")
    deferred = [w for w in steps[1]["loop"] if "core/resilience" in w]
    check(not deferred, f"(d) the guard-only monitor observed at step 1, "
          f"not a log boundary: {deferred}")
    log(f"  (d) loop.train on qwen2-0.5b at full width and depth (phase "
        f"4's arguments, guard on, eval every {LOOP_EVAL_EVERY}, log every "
        f"{LOOP_LOG_EVERY}, checkpoint every {LOOP_CKPT_EVERY}): "
        f"{wall:.1f} s; launches {launches}; losses {losses} "
        f"{'==' if same else '!='} phase 4's {list(phase4_losses)} (bit for "
        f"bit); logged {logged}; eval {evals}; checkpoint {ckpts}; "
        f"synchronizing operations by step {counts}, step 1 {ours} (train_"
        f"step {counts[1]['step']} + the loop's own {counts[1]['loop']}: "
        f"{sorted(set(steps[1]['loop']))}) against the launcher's guarded "
        f"step {theirs} ({launcher_step}) [{smi}]")
    del state, result
    torch.cuda.empty_cache()
    return {"launches": launches, "syncs": counts, "launcher": theirs,
            "ours": ours}


def phase_tools(dev) -> tuple[dict, dict]:
    """Phase 22: the quickstart, NES, train_lm and loop.train on the card
    (the loop's losses held against phase 4's when it ran).  Returns the
    phase's launches by kernel row and, by kernel, the largest
    |difference| from its plain version at the shapes of (a)-(c)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smi = dev["smi"]
    log("== phase 22: tools -- the quickstart, NES, train_lm and loop.train")
    totals, errs = {}, {}
    quick = _quickstart_run(smi)
    nes_out = _nes_run(smi)
    lm = _train_lm_run(smi)
    lp = _loop_run(smi, PHASE4.get("losses", ()))
    for part in (quick, nes_out, lm, lp):
        for k, v in part["launches"].items():
            totals[k] = totals.get(k, 0) + v
        for k, v in part.get("errs", {}).items():
            errs[k] = max(errs.get(k, 0.0), v)
    log(f"  tools launches {totals}; vs the plain versions max|err| {errs}")
    log(f"  phase 22 took {time.perf_counter() - t0:.1f} s")
    return totals, errs


# phase 23: (b)'s model (arch, batch, text length, rbd-dim), its model
# group run in turn, the local positions of embed's window held to the
# plain versions, and the summed projections' tolerance against the
# unsharded kernel's: PROJ_ULPS * sqrt(n_chunk) f32 ulps of S -- S =
# ||g_s|| sqrt(sq) for u (the Cauchy-Schwarz bound on sum |g b|, whose
# ulp sets the rounding of the same terms summed in another order), S =
# sq for sq (a sum of squares) -- n_chunk the unsharded kernel's chunk
# partials of the compartment, summed one after the other (their
# rounding grows as a random walk)
PJIT_DRIVE = ("rwkv6-1.6b", 8, 128, 1024)
PJIT_M = 4
PJIT_WINDOW = 1 << 20
PROJ_ULPS = 8
SHARD_KERNELS = {"project_flat_shard": "project_flat",
                 "reconstruct_flat_shard": "reconstruct_flat",
                 "reconstruct_apply_flat_shard": "reconstruct_apply_flat"}


def phase_pjit(dev) -> tuple[dict, list]:
    """Phase 23, pjit-style parameter sharding.  (a) The launcher's
    ``--mode pjit --data 1 --model 1`` on qwen2-0.5b at full width and
    depth (pure data parallel: nothing cut): its losses are phase 13's
    per-leaf route's bit for bit.  (b) rwkv6-1.6b at full width and depth
    on the megatron layout of a model group of PJIT_M ranks, run one
    shard after the other: one step's gradient, then the projector on
    each rank's leaf shards (rows 8-10's shard instances), the partials
    summed in shard order -- against the unsharded per-leaf kernels (the
    applies and reconstructions bit for bit, the sums within PROJ_ULPS)
    and, on a window, against the shard instances' plain versions.
    Returns ({kernel: launches of (a)}, the shard instances' rows)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig
    from repro_torch.core import projector, rng
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step
    from repro_torch.launch import train as launcher
    from repro_torch.models import registry
    from repro_torch.sharding import rules
    from repro_torch.train import step as steplib

    t0 = time.perf_counter()
    log("== phase 23: pjit-style parameter sharding: the launcher's --mode "
        f"pjit on qwen2-0.5b, then rows 8-10's shard instances on "
        f"{PJIT_DRIVE[0]}'s leaf shards, m = {PJIT_M} in turn")
    # (a) the route through the launcher
    gc.collect()
    torch.cuda.empty_cache()
    args = ARCH_ARGS + ["--mode", "pjit", "--data", "1", "--model", "1"]
    log("  (a) python -m repro_torch.launch.train " + " ".join(args))
    rbd_step.reset_counts()
    res = launcher.main(args)
    launches = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
    eplan = res.sub_opt.plan_execution()
    n_leaves = len(res.sub_opt.transform.plan.leaves)
    log(f"  (a) update path: {eplan.strategy} -- {eplan.reason}")
    check(eplan.strategy == "fused_per_leaf",
          f"(a): --mode pjit planned {eplan.strategy}")
    want = {"project_flat": n_leaves * STEPS,
            "reconstruct_apply_flat": n_leaves * STEPS}
    check(launches == want, f"(a): launches {launches}, expected {want}")
    check(res.losses == PHASE13["losses"],
          f"(a): losses {res.losses} are not phase 13's per-leaf route's "
          f"{PHASE13['losses']} bit for bit")
    per_step = {k: v / STEPS for k, v in res.collectives.items() if v}
    log(f"  (a) losses {res.losses}: phase 13's fused_per_leaf run's bit "
        f"for bit; launches {launches}; collectives a step {per_step} (one "
        "data rank: no coordinate exchange, no dense mean); step wall "
        f"{[round(x, 3) for x in res.step_seconds]} s; peak "
        f"{res.peak_bytes / 2**30:.2f} GiB")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the shard instances at full width on a megatron layout
    arch, batch, seq, dim = PJIT_DRIVE
    cfg = get_config(arch)
    model = registry.get_model(cfg)
    plan = steplib.make_plan(model, RBDConfig(total_dim=dim))
    dist = plan.distribution
    shapes = model.param_shapes()
    layout = rules.layout_policy(shapes, cfg)
    shards = registry.leaf_shards(model, PJIT_M)
    check(layout == "megatron", f"(b): {arch} planned {layout}")
    # the cut dimension as the rules name it: embed's 0, the stacked
    # leaves' -1 and -2 counted from the right
    by_dim = {}
    for k, d in shards.dims.items():
        by_dim.setdefault(d if k == "embed" else d - len(shapes[k]),
                          []).append(k)
    log(f"  (b) {arch}: {sum(math.prod(x) for x in shapes.values()):,} "
        f"parameters, layout {layout}; leaves cut by dimension: "
        + "; ".join(f"{d}: {', '.join(v)}" for d, v in sorted(by_dim.items()))
        + f"; replicated: {len(shapes) - len(shards.dims)} leaves")
    check({0, -1, -2} == set(by_dim) and by_dim[0] == ["embed"],
          f"(b): expected embed cut on 0 and the rest on -1 / -2, got "
          f"{by_dim}")
    params = model.init(0, device="cuda")
    data = next(synthetic.lm_batches(0, batch, seq, cfg.vocab,
                                     device="cuda"))
    loss_fn = steplib.make_loss_fn(model, cfg.router_aux_coef)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, _ = loss_fn(leaves, data)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    del leaves, loss
    torch.cuda.synchronize()
    log(f"  (b) one gradient at batch {batch} x {seq}: "
        f"{time.perf_counter() - t0:.1f} s into the phase")
    seed = rng.fold_seed(0, 0)
    eta = 0.125
    rows = {lp.name: lp for lp in plan.leaves}

    def rows_of(x, lp):
        return x.reshape(lp.n_stack, -1).contiguous()

    # the unsharded per-leaf kernels on the whole leaves (comparison only;
    # each launch timed with CUDA events, as the shards' are below)
    whole_u, whole_sq, whole_d, whole_a = {}, {}, {}, {}
    rbd_step.set_timing(True)
    for lp in plan.leaves:
        whole_u[lp.name], whole_sq[lp.name] = rbd_project.project_flat(
            projector._leaf_seeds(seed, lp), rows_of(grads[lp.name], lp),
            lp.dim, dist)
    coords = [projector._norm_scales(plan, lp, whole_u[lp.name], None)
              for lp in plan.leaves]
    for i, lp in enumerate(plan.leaves):
        seeds = projector._leaf_seeds(seed, lp)
        scale = projector._recon_scale(plan, lp, seeds, coords[i], None)
        whole_d[lp.name] = rbd_reconstruct.reconstruct_flat(
            seeds, scale, lp.size, dist)
        whole_a[lp.name] = rbd_reconstruct.reconstruct_apply_flat(
            seeds, scale, rows_of(params[lp.name], lp), eta, dist)
    t_whole = {k: sum(v) for k, v in rbd_step.kernel_times_ms().items()
               if v}
    rbd_step.set_timing(False)
    log("  (b) the unsharded per-leaf kernels over the whole leaves, ms "
        "(launches summed): " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in t_whole.items()))

    # the path: each rank's leaf shards in turn, counted and timed; each
    # shard's reconstruct and apply held to the unsharded kernels' slices
    # bit for bit as soon as they are made
    rbd_step.reset_counts()
    parts, times = [], []
    for r in range(PJIT_M):
        sh = shards.with_rank(r)
        rbd_step.set_timing(True)
        parts.append(projector.project_partials(
            registry.shard_params(grads, sh), plan, seed, backend="cuda",
            shards=sh))
        local = registry.shard_params(params, sh)
        out = {"reconstruct": projector.reconstruct(
            coords, plan, seed, local, backend="cuda", shards=sh),
            "apply": projector.reconstruct_apply(
                coords, plan, seed, local, eta, backend="cuda", shards=sh)}
        times.append({k: sum(v) for k, v in rbd_step.kernel_times_ms().items()
                      if v})
        rbd_step.set_timing(False)
        for lp in plan.leaves:
            for what, whole in (("reconstruct", whole_d), ("apply", whole_a)):
                want = sh.cut(lp.name, whole[lp.name].reshape(lp.shape))
                check(torch.equal(out[what][lp.name].reshape(want.shape),
                                  want),
                      f"(b) {lp.name} shard {r}: the {what} is not the "
                      "unsharded kernel's slice bit for bit")
        del local, out
    path = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
    n_cut = len(shards.dims)
    for k in SHARD_KERNELS:
        check(path.get(k, 0) == PJIT_M * n_cut,
              f"(b): {k} launched {path.get(k, 0)} times, expected "
              f"{PJIT_M} x {n_cut}")
    log(f"  (b) launches over the {PJIT_M} shards: {path}; every shard's "
        "reconstruct and apply bit-identical to the unsharded kernels' "
        "slices")
    for r, t in enumerate(times):
        log(f"    shard {r}: ms " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in sorted(t.items())))
    sums = {k: sum(t.get(k, 0.0) for t in times) for k in SHARD_KERNELS}
    log("  (b) shard instances summed over the shards, ms: " + ", ".join(
        f"{k} {v:.2f} ({v / t_whole[b]:.3f} x the unsharded kernel's)"
        for k, b in SHARD_KERNELS.items() for v in [sums[k]]))

    # the summed partials against the unsharded kernel: within PROJ_ULPS
    worst_u = worst_sq = 0.0
    for i, lp in enumerate(plan.leaves):
        u = sum(p[0][i] for p in parts)
        sq = sum(p[1][i] for p in parts)
        g = rows_of(grads[lp.name], lp)
        wu, wsq = whole_u[lp.name], whole_sq[lp.name]
        n_chunk = -(-lp.size // (rbd_project.POS_CHUNK
                                 * rbd_project.POS_BLOCK))
        ulps = PROJ_ULPS * math.sqrt(n_chunk) * 2.0**-23
        tol_u = (ulps * g.norm(dim=1, keepdim=True)
                 * wsq.sqrt()).clamp(min=1e-30)
        tol_sq = (ulps * wsq).clamp(min=1e-30)
        ru = float(((u - wu).abs() / tol_u).max())
        rsq = float(((sq - wsq).abs() / tol_sq).max())
        check(ru <= 1.0 and rsq <= 1.0,
              f"(b) {lp.name}: summed shard projections off the unsharded "
              f"kernel's by {ru:.3g} (u) / {rsq:.3g} (sq) of the tolerance")
        worst_u, worst_sq = max(worst_u, ru), max(worst_sq, rsq)
    log(f"  (b) the summed projections within {worst_u:.3g} (u) and "
        f"{worst_sq:.3g} (sq) of the tolerance ({PROJ_ULPS} sqrt(n_chunk) "
        "ulps)")
    del whole_d, whole_a, parts
    gc.collect()
    torch.cuda.empty_cache()

    # a window against the plain versions: layer 0 of cmix/wk (-1) and
    # cmix/wv (-2) on every shard, embed's (0) first PJIT_WINDOW local
    # positions on shard 1
    errs = dict.fromkeys(SHARD_KERNELS, 0.0)
    plain_ms = dict.fromkeys(SHARD_KERNELS, 0.0)
    window_ms = dict.fromkeys(SHARD_KERNELS, 0.0)
    cases = [(name, r) for name in ("layers/cmix/wk", "layers/cmix/wv")
             for r in range(PJIT_M)] + [("embed", 1)]
    gen = torch.Generator(device="cuda").manual_seed(23)
    for name, r in cases:
        lp = rows[name]
        sh = shards.with_rank(r)
        cm = sh.colmap(name, lp.stacked)
        seeds = projector._leaf_seeds(seed, lp)[:1]
        g = rows_of(sh.cut(name, grads[name]), lp)[:1]
        th = rows_of(sh.cut(name, params[name]), lp)[:1]
        if name == "embed":
            cm = (PJIT_WINDOW, cm[1], cm[2])
            g, th = g[:, :PJIT_WINDOW], th[:, :PJIT_WINDOW]
        g, th = g.contiguous(), th.contiguous()
        scale = torch.randn((1, lp.dim), generator=gen, device="cuda") * 1e-3
        q = g.shape[1]
        res = {}
        window_ms["project_flat_shard"] += cuda_ms(lambda: res.update(
            p=rbd_project.project_flat_shard(seeds, g, lp.dim, dist,
                                             colmap=cm)))[0]
        window_ms["reconstruct_flat_shard"] += cuda_ms(lambda: res.update(
            d=rbd_reconstruct.reconstruct_flat_shard(seeds, scale, q, dist,
                                                     colmap=cm)))[0]
        window_ms["reconstruct_apply_flat_shard"] += cuda_ms(
            lambda: res.update(a=rbd_reconstruct.reconstruct_apply_flat_shard(
                seeds, scale, th, eta, dist, colmap=cm)))[0]
        plain = {}
        plain_ms["project_flat_shard"] += cuda_ms(lambda: plain.update(
            p=rbd_project.project_flat_shard_plain(seeds, g, lp.dim, dist,
                                                   colmap=cm)))[0]
        plain_ms["reconstruct_flat_shard"] += cuda_ms(lambda: plain.update(
            d=rbd_reconstruct.reconstruct_flat_shard_plain(
                seeds, scale, q, dist, colmap=cm)))[0]
        plain_ms["reconstruct_apply_flat_shard"] += cuda_ms(
            lambda: plain.update(
                a=rbd_reconstruct.reconstruct_apply_flat_shard_plain(
                    seeds, scale, th, eta, dist, colmap=cm)))[0]
        case = f"(b) window {name} shard {r}"
        errs["project_flat_shard"] = max(
            errs["project_flat_shard"],
            _check_flat_project(case, *res["p"], *plain["p"], g))
        errs["reconstruct_flat_shard"] = max(
            errs["reconstruct_flat_shard"],
            _check_delta(case, res["d"], plain["d"]))
        errs["reconstruct_apply_flat_shard"] = max(
            errs["reconstruct_apply_flat_shard"],
            _check_apply(case, res["a"], plain["a"], th))
    log("  (b) window, kernel ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in window_ms.items()) + "; plain ms "
        + ", ".join(f"{k} {v:.1f}" for k, v in plain_ms.items()))

    # rows: the bound of the whole model group's shard work (every cut
    # leaf's live values once), against its ms summed over the shards
    cut = [lp for lp in plan.leaves if lp.name in shards.dims]
    values = sum(lp.n_stack * lp.dim * lp.size for lp in cut)
    q_cut = sum(lp.n_stack * lp.size for lp in cut)
    d_cut = sum(lp.n_stack * lp.dim for lp in cut)
    n_seeds = PJIT_M * sum(lp.n_stack for lp in cut)
    nbytes = {"project_flat_shard": 4 * q_cut + 8 * PJIT_M * d_cut
              + 4 * n_seeds,
              "reconstruct_flat_shard": 4 * q_cut + 4 * PJIT_M * d_cut
              + 4 * n_seeds,
              "reconstruct_apply_flat_shard": 8 * q_cut + 4 * PJIT_M * d_cut
              + 4 * n_seeds}
    out_rows = []
    for k, base in SHARD_KERNELS.items():
        b_ms, by, note = ops_bound(values, nbytes[k],
                                   value_counts(base, "threefry", dist), dev)
        log(f"  bound {k} ({PJIT_M} shards, {len(cut)} cut leaves, "
            f"{values:,} live values): {b_ms:.3f} ms -- {note}")
        log(f"  {k}: ms {sums[k]:.3f} summed over the shards, bound "
            f"{b_ms:.3f} ({by}), {b_ms / sums[k]:.1%} of bound; plain "
            f"{plain_ms[k]:.1f} on the window (the kernel "
            f"{window_ms[k]:.2f} there)")
        out_rows.append({
            "name": k, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rbd_flat.cu",
            "replaces": REPLACES[base], "launches": path[k],
            "max_abs_err": errs[k], "ms": sums[k], "plain_ms": plain_ms[k],
            "bound_ms": b_ms, "bound_by": by, "library_ms": None})
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 23: {time.perf_counter() - t0:.1f} s")
    return {k: launches.get(k, 0) for k in FLAT_KERNELS}, out_rows


# phase 24: the dry run's prediction of phase 4's step against the card.
# Its peak (arguments + temp) is held to the step's measured
# max_memory_allocated over what was allocated before it within
# DRY_MEM_RTOL of the prediction plus DRY_MEM_ATOL bytes (the caching
# allocator rounds each block up to 512 bytes; the kernels' scratch --
# partial sums and arrival counters, allocated inside the launch -- is
# outside the trace).
DRY_MEM_RTOL = 0.10
DRY_MEM_ATOL = 64 << 20
DRY_HOST_REPS = 50       # calls a host-cost reading averages
DRY_HOST_REPS_FULL = 5   # the same at phase 4's full width (each launch
                         # queues ~0.22 s of device work)


def _dry_step(device, mesh):
    """Phase 4's step (the launcher's ARCH_ARGS: qwen2-0.5b, sharedseed
    over a data group of one, rbd-dim 1024, the packed kernels, sgd at lr
    0.125) placed on ``mesh`` as the launcher places it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.launch.train import step_route
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    cfg = get_config("qwen2-0.5b")
    net = get_model(cfg)
    tcfg = TrainConfig(model=cfg, rbd=RBDConfig(total_dim=1024,
                                                backend="cuda"),
                       learning_rate=0.125, batch_size=8, seq_len=128)
    transform = steplib.make_transform(net, tcfg.rbd)
    route = step_route(net, tcfg, transform, mode="sharedseed", mesh=mesh,
                       device=device)
    init, step, sub = steplib.make_train_step(
        net, tcfg, transform, model_shards=1, device=device,
        return_optimizer=True, **route)
    return net, init, step, sub


def _dry_prediction() -> dict:
    """Phase 24 (a)'s prediction: the step traced on meta tensors in a
    fake one-rank world (launch.dryrun's machinery), on this host's CPU."""
    import torch
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch import mesh as meshlib

    t0 = time.perf_counter()
    mesh = meshlib.init_fake_mesh(1, 1)
    try:
        net, init, step, sub = _dry_step("meta", mesh)
        state = init(params=net.param_template())
        batch = {k: torch.empty((8, 128), dtype=torch.int64, device="meta")
                 for k in ("tokens", "labels")}
        tr = hlo_analysis.trace(step, state, batch)
    finally:
        meshlib.destroy_mesh(mesh)
    terms = dryrun.roofline(tr)
    return {"trace": tr, "terms": terms, "seconds":
            time.perf_counter() - t0,
            "d": sub.transform.plan.packed().d_packed}


def _host_us(torch, fn, reps: int = DRY_HOST_REPS) -> float:
    """Host microseconds a call of ``fn``, issued behind a stalled stream
    (``torch.cuda._sleep``) so the device's work does not hold the host."""
    torch.cuda.synchronize()
    torch.cuda._sleep(ENC_SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def _op_host_cost(torch, net, state, sub) -> dict:
    """Phase 24 (b): host microseconds of a kernel's call through its op
    (``torch.ops.repro_torch.<name>``, the wrappers' path) and of the same
    launch function called directly (the path before the ops), on phase
    4's packed step's two kernels and on an image model's per-leaf
    kernels (FC, phase 21's host-bound step), plus the wrapper's whole
    call and the image model's ``rbd_gradient``."""
    from repro_torch.core import compartments, projector, rng
    from repro_torch.core.rbd import RandomBasesTransform
    from repro_torch.kernels import rbd_project, rbd_reconstruct, rbd_step
    from repro_torch.models import vision

    out = {}
    lay = sub.transform.plan.packed()
    seeds = projector.segment_seeds(sub.transform.plan, rng.fold_seed(3))
    t = rbd_step._device_tables(lay, state.params.device)
    dseeds = rbd_step._seeds_on(seeds, lay.n_segments, state.params.device)
    g = torch.zeros_like(state.params)
    scale = torch.zeros((lay.d_packed,), device=g.device)
    pargs = (g, dseeds, t["size"], t["param_off"], t["coord_off"],
             t["n_chunk"], t["proj_blocks"], lay.n_segments,
             t["n_proj_blocks"], lay.pos_block, lay.d_packed, 0, 0, 0)
    full = DRY_HOST_REPS_FULL
    out["project_packed"] = (
        _host_us(torch, lambda: torch.ops.repro_torch.project_packed(
            *pargs), full),
        _host_us(torch, lambda: rbd_step.LAUNCH_FNS["project_packed"](
            *pargs), full),
        _host_us(torch, lambda: rbd_step.project_packed(seeds, g, lay),
                 full))
    theta = state.params
    aargs = (scale, theta, theta, dseeds, t["size"], t["pdim"],
             t["param_off"], t["coord_off"], t["recon_blocks"],
             lay.n_segments, t["n_recon_blocks"], lay.pos_block,
             t["max_ndb"], 0, 0, 0)
    out["reconstruct_apply_packed"] = (
        _host_us(torch, lambda: torch.ops.repro_torch.
                 reconstruct_apply_packed(*aargs), full),
        _host_us(torch, lambda: rbd_step.LAUNCH_FNS[
            "reconstruct_apply_packed"](*aargs), full),
        _host_us(torch, lambda: rbd_step.reconstruct_apply_packed(
            seeds, scale, theta, lay, out=theta), full))
    # the image model's per-leaf kernels: FC's largest leaf
    init, _ = vision.get_vision_model("fc")
    params = init(0, (28, 28, 1))
    plan = compartments.make_plan(params, 128)
    tr = RandomBasesTransform(plan, 0, backend="cuda")
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    lp = max(plan.leaves, key=lambda x: x.size)
    fseeds = projector._leaf_seeds(tr.step_seed(0), lp)
    dfs = rbd_step._seeds_on(fseeds, lp.n_stack, "cuda")
    fg = torch.zeros((lp.n_stack, lp.size), device="cuda")
    n_db = rbd_project.padded_dim(lp.dim) // rbd_project.DIR_BLOCK
    cc = rbd_project.POS_CHUNK * rbd_project.POS_BLOCK
    fargs = (fg, dfs, n_db, max(1, -(-lp.size // cc)), cc, 0, 0)
    out["project_flat"] = (
        _host_us(torch, lambda: torch.ops.repro_torch.project_flat(*fargs)),
        _host_us(torch, lambda: rbd_step.LAUNCH_FNS["project_flat"](
            *fargs)),
        _host_us(torch, lambda: rbd_project.project_flat(fseeds, fg,
                                                         lp.dim)))
    sc = torch.zeros((lp.n_stack, n_db * rbd_project.DIR_BLOCK),
                     device="cuda")
    rargs = (sc, dfs, lp.size, 0, 0)
    out["reconstruct_flat"] = (
        _host_us(torch, lambda: torch.ops.repro_torch.reconstruct_flat(
            *rargs)),
        _host_us(torch, lambda: rbd_step.LAUNCH_FNS["reconstruct_flat"](
            *rargs)),
        _host_us(torch, lambda: rbd_reconstruct.reconstruct_flat(
            fseeds, sc[:, :lp.dim], lp.size)))
    out["fc rbd_gradient"] = (_host_us(
        torch, lambda: projector.rbd_gradient(grads, plan, tr.step_seed(0),
                                              backend="cuda"), reps=10),)
    return out


def phase_dryrun(dev) -> dict:
    """Phase 24: the dry run (``launch.dryrun``) against the card.  (a)
    phase 4's step traced on meta tensors in a fake world of one rank --
    the prediction logged before the real step runs -- then the same step
    on the card: kernel calls against LAUNCHES, collective sites against
    COLLECTIVES and flops against FlopCounterMode's count of the real
    step, all equal; the predicted peak against max_memory_allocated
    within DRY_MEM_RTOL + DRY_MEM_ATOL; the roofline's max(t_compute,
    t_memory) beside the measured step wall (reported).  (b) the kernel
    ops' host cost.  (c) ``dryrun --all`` is a CPU tool of minutes a
    combination set: it runs outside this phase (PERF.md)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core import distributed
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib

    log("== phase 24: the dry run's prediction of phase 4's step against "
        "the card")
    pred = _dry_prediction()
    tr, terms = pred["trace"], pred["terms"]
    kinds: dict = {}
    for c in tr.collectives:
        key = "scalar" if c.elements == 1 else c.primitive
        kinds[key] = kinds.get(key, 0) + 1
    p_peak = tr.argument_bytes + tr.temp_bytes
    log(f"  prediction (meta trace, {pred['seconds']:.1f} s on the host): "
        f"kernel calls {tr.kernel_calls}; collective sites "
        f"{[(c.primitive, c.elements) for c in tr.collectives]}; flops "
        f"{tr.flops:,}; bytes {tr.bytes_accessed:,}; arguments "
        f"{tr.argument_bytes:,} B, temp {tr.temp_bytes:,} B, peak "
        f"{p_peak:,} B; t_compute {terms['t_compute'] * 1e3:.3f} ms, "
        f"t_memory {terms['t_memory'] * 1e3:.3f} ms "
        f"({dryrun.HARDWARE})")
    mesh = meshlib.init_mesh(1, 1, "cuda")
    try:
        net, init, step, sub = _dry_step(mesh.device, mesh)
        state = init()
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = {k: torch.randint(0, net.cfg.vocab, (8, 128), generator=gen,
                                  device="cuda")
                 for k in ("tokens", "labels")}
        state, _ = step(state, batch)           # warm-up: cuBLAS, tables
        torch.cuda.synchronize()
        rbd_step.reset_counts()
        distributed.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
        colls = {k: v for k, v in distributed.COLLECTIVES.items() if v}
        state = new
        del new
        with FlopCounterMode(display=False) as fc:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        real_flops = fc.get_total_flops()
        check(math.isfinite(float(metrics["loss"])), "phase 24 loss")
        host = _op_host_cost(torch, net, state, sub)
    finally:
        meshlib.destroy_mesh(mesh)
    want = {}
    for k in tr.kernel_calls:
        want[k] = want.get(k, 0) + 1
    log(f"  card: launches {launches}, collectives {colls}, flops "
        f"{real_flops:,}, memory before the step {before:,} B, peak "
        f"{peak:,} B, step wall {wall * 1e3:.3f} ms")
    check(launches == want, f"kernel calls {want} != launches {launches}")
    check(kinds == {"psum": 1, "scalar": 1}
          and colls == {"all_reduce": 1, "scalar": 1},
          f"collective sites {kinds} != COLLECTIVES {colls}")
    check(real_flops == tr.flops,
          f"flops: predicted {tr.flops:,}, FlopCounterMode {real_flops:,}")
    m_temp = peak - before
    err = m_temp - tr.temp_bytes
    log(f"  memory: predicted temp {tr.temp_bytes:,} B, measured "
        f"{m_temp:,} B ({err:+,} B, {err / tr.temp_bytes:+.2%}); predicted "
        f"arguments {tr.argument_bytes:,} B beside {before:,} B allocated "
        f"before the step")
    check(abs(err) <= DRY_MEM_RTOL * tr.temp_bytes + DRY_MEM_ATOL,
          f"predicted temp {tr.temp_bytes:,} B, measured {m_temp:,} B")
    roof = max(terms["t_compute"], terms["t_memory"])
    log(f"  roofline max(t_compute, t_memory) {roof * 1e3:.3f} ms beside "
        f"the measured step wall {wall * 1e3:.3f} ms "
        f"({roof / wall:.1%}; reported, not gated)")
    for name, us in host.items():
        if len(us) == 3:
            log(f"  host us a call [{name}]: op {us[0]:.1f}, the launch "
                f"function direct {us[1]:.1f} (the op adds "
                f"{us[0] - us[1]:.1f}), the wrapper {us[2]:.1f}")
        else:
            log(f"  host us a call [{name}]: {us[0]:.1f}")
    log("  dryrun --all: run on the CPU outside this phase (a combination "
        "set takes minutes there; PERF.md has its table)")
    return {"launches": launches, "host_us": host, "wall": wall,
            "peak": peak}



# ---------------------------------------------------------------------------
# phase 25: resilience on the model-sharded slabs, the shards in turn
# ---------------------------------------------------------------------------

SLAB_RES_M = 2     # shards of phase 25's model group, run in turn


def _slab_drive(model, tcfg, transform, rcfg, *, resume=False, ref=None):
    """Phase 25's training loop on the slabs in turn, phase 18's arguments:
    the forward and backward on the concatenated slabs (the all-gather of
    one rank), then ``step_shards_in_turn`` with the guard, the sentinel
    and the fault plan, the monitor fed what the launcher feeds it.  Every
    step must launch rows 5 and 6 once a shard.  With ``ref`` (the
    unsharded guarded optimizer) each accepted step is held to ``ref``'s
    step from the same state and gradient within THETA_RTOL (phase 15's
    gate), and a rejected step must leave the slabs bit for bit.  Returns
    the final state, the reasons, losses and launches of the live steps,
    the worst step against ``ref`` as a share of its tolerance, the kill
    (if the plan fired one), the snapshot step's observe seconds and --
    resumed -- the recovery's info, seconds and launches."""
    import torch
    from repro_torch.core import resilience as res
    from repro_torch.data import synthetic
    from repro_torch.kernels import rbd_step
    from repro_torch.train import step as steplib
    from repro_torch.train.step import TrainState

    m = SLAB_RES_M
    sub = steplib.make_subspace_optimizer(
        model, tcfg, transform, "data", model_sharded=True,
        model_axis="model", model_shards=m, device="cuda", resilience=rcfg)
    loss_fn = steplib.make_loss_fn(model, model.cfg.router_aux_coef)
    padded = sub.padded_params(model.init(tcfg.seed, device="cuda"))
    state = TrainState([sub.slab_of(padded, s).clone() for s in range(m)],
                       sub.init_rbd_state(),
                       sub.init_opt_state(device="cuda"), 0,
                       res.guard_init("cuda"))
    del padded
    out = {"sub": sub, "reasons": [], "losses": [], "killed": None,
           "launches": dict.fromkeys(rbd_step.KERNELS, 0), "worst": 0.0}
    q = sub.transform.plan.packed().q_packed
    if resume:
        rbd_step.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, info = res.recover(rcfg, sub, state)
        torch.cuda.synchronize()
        out["recovery"] = dict(
            info, seconds=time.perf_counter() - t,
            launches={k: v for k, v in rbd_step.LAUNCHES.items() if v})
    monitor = res.ResilienceMonitor(rcfg, sub)
    stream = synthetic.lm_batches(tcfg.seed, tcfg.batch_size, tcfg.seq_len,
                                  model.cfg.vocab, device="cuda")
    stream.skip(state.step)
    want = {"project_packed_sharded": m,
            "reconstruct_apply_packed_sharded": m}
    try:
        for i in range(state.step, RES_STEPS):
            if monitor.should_kill(i):
                out["killed"] = f"fault plan kills step {i}"
                break
            full = torch.cat(state.params).requires_grad_(True)
            loss, _ = loss_fn(sub.materialize_params(full), next(stream))
            (grad,) = torch.autograd.grad(loss, full)
            full = full.detach()
            before = state
            rbd_step.reset_counts()
            with torch.no_grad():
                slabs, new_r, new_o, aux = sub.step_shards_in_turn(
                    state.params, [sub.slab_of(grad, s) for s in range(m)],
                    state.rbd_state, state.opt_state, state.guard)
            got = {k: v for k, v in rbd_step.LAUNCHES.items() if v}
            check(got == want, f"step {i}: expected rows 5-6 once a shard, "
                  f"got {got}")
            for k, v in got.items():
                out["launches"][k] += v
            new = torch.cat(slabs)
            if ref is not None and int(aux.reason) == res.REASON_OK:
                with torch.no_grad():
                    theta = ref.step(full[:q].clone(), grad[:q],
                                     before.rbd_state, before.opt_state,
                                     before.guard)[0]
                dt = float((new[:q] - theta).abs().max())
                tol = (THETA_RTOL * float((theta - full[:q]).abs().max())
                       + 2 * 2.0**-23 * float(full.abs().max()))
                check(dt <= tol, f"step {i}: theta off the unsharded step "
                      f"by {dt:.3g} (tol {tol:.3g})")
                out["worst"] = max(out["worst"], dt / tol)
                del theta
            elif ref is not None:
                check(torch.equal(new, full), f"step {i}: the rejected "
                      "step moved the slabs")
            del grad, full, new
            state = TrainState(slabs, new_r, new_o, state.step + 1,
                               aux.guard)
            metrics = {"guard_reason": aux.reason,
                       "guard_lr_scale": aux.guard.lr_scale,
                       "sentinel_diverged": aux.diverged}
            if sub.capture_coords:
                metrics.update(replay_coords=aux.coords,
                               replay_row_sq=aux.row_sq)
            torch.cuda.synchronize()
            t = time.perf_counter()
            monitor.observe(state, metrics)
            torch.cuda.synchronize()
            if rcfg.directory and (i + 1) % rcfg.snapshot_every == 0:
                out["write_s"] = time.perf_counter() - t
            out["reasons"].append(int(aux.reason))
            out["losses"].append(float(loss.detach()))
    finally:
        if monitor.log is not None:
            monitor.log.close()
    out["state"] = state
    return out


def phase_slab_resilience(dev) -> dict:
    """Returns the launches by kernel over the phase's main-path steps and
    replay."""
    import gc
    import shutil

    import torch
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig, TrainConfig
    from repro_torch.core import resilience as res
    from repro_torch.kernels import rbd_step
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    smi = dev["smi"]
    t_phase = time.perf_counter()
    log(f"== phase 25: resilience on the model-sharded slabs, m = "
        f"{SLAB_RES_M} shards in turn, qwen2-0.5b full width and depth "
        "(phase 18's arguments)")
    check(bool(PHASE18), "phase 18 left no uninterrupted run to hold to")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    rbd = RBDConfig(total_dim=1024, backend="cuda")
    tcfg = TrainConfig(model=cfg, rbd=rbd, learning_rate=RES_LR,
                       optimizer="adam", steps=RES_STEPS, batch_size=8,
                       seq_len=128)
    transform = steplib.make_transform(model, rbd)
    plan = res.FaultPlan((res.FaultEvent(1, "nan_grad"),
                          res.FaultEvent(4, "kill")))
    directory = os.path.join(ROOT, "build", "slab_resilience_smoke")
    snap_dir = os.path.join(directory, "snapshots")

    def rcfg(d, faults):
        return res.ResilienceConfig(directory=d, snapshot_every=3,
                                    guard=res.GuardConfig(),
                                    sentinel_every=2, fault_plan=faults)

    launches = dict.fromkeys(rbd_step.KERNELS, 0)

    def count(run):
        for k, v in run["launches"].items():
            launches[k] += v

    mesh = meshlib.init_mesh(1, 1, "cuda")   # the one-rank data group
    shutil.rmtree(directory, ignore_errors=True)
    try:
        log("  (a) 6 steps, a NaN gradient at step 1, no kill, no "
            "directory; each step against the unsharded guarded step from "
            "the same state and gradient")
        ref = steplib.make_subspace_optimizer(
            model, tcfg, transform, "data", device="cuda",
            resilience=res.ResilienceConfig(guard=res.GuardConfig()))
        t = time.perf_counter()
        a = _slab_drive(model, tcfg, transform,
                        rcfg(None, plan.without("kill")), ref=ref)
        count(a)
        sub = a["sub"]
        q = sub.transform.plan.packed().q_packed
        log(f"  (a) {time.perf_counter() - t:.1f} s: reasons "
            f"{a['reasons']} (phase 18 (a) {PHASE18['reasons']}), losses "
            f"{a['losses']} (phase 18 (a) {PHASE18['losses']})")
        check(a["reasons"] == PHASE18["reasons"],
              f"(a): reasons {a['reasons']} are not phase 18 (a)'s "
              f"{PHASE18['reasons']}")
        check(int(a["state"].guard.nonfinite_count) == 1,
              "(a): the guard did not count one rejected step")
        log(f"  (a) every accepted step within THETA_RTOL of the unsharded "
            f"step from its state, the worst at {a['worst']:.3g} of its "
            "tolerance; the rejected step left the slabs bit for bit")
        # the whole trajectory against phase 18 (a)'s: reported, not
        # gated -- the bf16 forward turns the slab sums' f32 order into
        # bf16 noise in the next gradients, which adam's per-coordinate
        # normalization carries into every later step
        new = torch.cat(a["state"].params)
        want = PHASE18["theta"].to("cuda")
        theta0 = sub.padded_params(model.init(tcfg.seed, device="cuda"))
        dt = float((new[:q] - want).abs().max())
        upd = float((want - theta0[:q]).abs().max())
        del want, theta0
        log(f"  (a) final theta vs phase 18 (a)'s unsharded run: max "
            f"{dt:.3g}, {dt / upd:.3g} of its largest cumulative update "
            f"{upd:.3g}")
        check(bool((new[q:] == 0).all()), "(a): padding is not exactly 0")
        check(all(math.isfinite(x) for x in a["losses"]),
              f"(a): losses {a['losses']}")
        del new

        log("  (b) the same with the replay log, a snapshot every 3 "
            "steps, killed before step 4")
        t = time.perf_counter()
        b = _slab_drive(model, tcfg, transform, rcfg(directory, plan))
        count(b)
        check(b["killed"] == "fault plan kills step 4" and len(
            b["reasons"]) == 4, f"(b): the kill did not fire before step "
            f"4: {b['killed']}, {len(b['reasons'])} steps")
        del b["state"]
        snap = os.path.join(snap_dir, "ckpt_00000003")
        snap_bytes = os.path.getsize(snap + ".npz")
        with open(snap + ".json") as fh:
            shapes = json.load(fh)["shapes"]
        slayout = sub.sharded_layout()
        log(f"  (b) {time.perf_counter() - t:.1f} s; snapshot "
            f"{snap_bytes:,} B ({snap_bytes / 1e9:.3f} GB), .params "
            f"{shapes['.params']} (q_padded {slayout.q_padded:,}); write "
            f"(the slabs concatenated, device to host, npz, CRC32s, fsync) "
            f"{b['write_s']:.3f} s [{smi}]")
        check(shapes[".params"] == [slayout.q_padded],
              f"(b): the snapshot's params are {shapes['.params']}, not "
              f"the (q_padded,) buffer")

        log("  (c) resumed from (b)'s directory, the kill dropped")
        t = time.perf_counter()
        c = _slab_drive(model, tcfg, transform,
                        rcfg(directory, plan.without("kill")), resume=True)
        count(c)
        rec = c["recovery"]
        for k, v in rec["launches"].items():
            launches[k] += v
        log(f"  (c) {time.perf_counter() - t:.1f} s: snapshot "
            f"{rec['snapshot_step']}, replayed {rec['replayed']}, recover "
            f"(verified restore + replay) {rec['seconds']:.3f} s, its "
            f"launches {rec['launches']}; then reasons {c['reasons']} "
            f"[{smi}]")
        check(rec["snapshot_step"] == 3 and rec["replayed"] == 1,
              f"(c): expected snapshot 3 and 1 record replayed: {rec}")
        check(rec["launches"] == {"reconstruct_apply_packed_sharded":
                                  SLAB_RES_M},
              f"(c): the replay should be one slab apply a shard: "
              f"{rec['launches']}")
        check(c["reasons"] == PHASE18["reasons"][4:],
              f"(c): reasons {c['reasons']}")
        sa, sc = a["state"], c["state"]
        same = {
            "slabs": all(torch.equal(x, y) for x, y in zip(sa.params,
                                                          sc.params)),
            "adam": all(torch.equal(x, y) for x, y in zip(sa.opt_state,
                                                          sc.opt_state)),
            "guard": all(torch.equal(x, y) for x, y in zip(sa.guard,
                                                          sc.guard)),
            "step": sa.step == sc.step == RES_STEPS}
        log(f"  resumed == uninterrupted, bit for bit: {same}")
        check(all(same.values()), f"(c) is not (a) bit for bit: {same}")

        # the recovery's pieces timed apart: the verified restore, the
        # replay of one record on the slabs
        torch.cuda.synchronize()
        t = time.perf_counter()
        restored = ckpt_io.restore(
            snap_dir, res._restore_template(sub, sc), 3)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        restored = restored._replace(params=res._stored_like(
            sub, restored.params, sc.params))
        _, records, _ = res.ReplayLog.read(os.path.join(directory,
                                                        "replay.log"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        res.replay_records(sub, restored, [r for r in records
                                           if r.step == 3])
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t
        log(f"  verified restore {restore_s:.3f} s for {snap_bytes / 1e9:.3f}"
            f" GB; replay of one record ({SLAB_RES_M} slab applies) "
            f"{replay_s * 1e3:.1f} ms [{smi}]")
        del a, c, sa, sc, restored, ref
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        meshlib.destroy_mesh(mesh)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  phase 25 {time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} } [{smi}]")
    return launches


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", metavar="DIR",
                    help="A/B rows 1-10 against DIR's kernels; no phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.base:
        return ab_against(args.base)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RBDConfig
    from repro_torch.core import compartments
    from repro_torch.kernels import rbd_step
    from repro_torch.models.registry import get_model
    from repro_torch.train import step as steplib

    t0 = time.perf_counter()
    dev = phase_device()
    phase_generator()
    full_plan = steplib.make_plan(get_model(get_config("qwen2-0.5b")),
                                  RBDConfig(total_dim=1024))
    lay = full_plan.packed()
    blocks = compartments.segment_tables(lay, rbd_step.PROJECT_POS_CHUNK)
    log(f"full plan: q {full_plan.total_params:,} q_packed {lay.q_packed:,}"
        f" segments {lay.n_segments} d_packed {lay.d_packed} total_dim "
        f"{full_plan.total_dim} projection tiles {lay.n_proj_tiles:,}; "
        f"basis values per launch {int((lay.seg_pdim * lay.seg_size).sum()):,}"
        f" generated, {int((lay.seg_dim * lay.seg_size).sum()):,} live; CUDA "
        f"blocks {int(blocks['proj_blocks'][-1]):,} (project), "
        f"{int(blocks['recon_blocks'][-1]):,} (apply)")
    errs = phase_kernels(full_plan)
    res, launches = phase_training()
    phase_loss()
    rows = phase_timing(full_plan, res, launches, errs, dev)
    PHASE4.update(losses=list(res.losses), ms_per_value=(
        (rows[0]["ms"] + rows[1]["ms"]) / int((lay.seg_dim
                                               * lay.seg_size).sum())))
    del res
    workers_err = phase_workers(full_plan, dev)
    row = phase_k_workers(full_plan, dev)
    row["max_abs_err"] = max(row["max_abs_err"], workers_err)
    rows.append(row)
    phase_exchange()
    adapters = phase_adapters(full_plan, dev)
    serving = phase_serving(dev)
    name = "reconstruct_apply_packed_adapters"
    row = kernel_row(name, lay, full_plan.distribution, dev, B_FULL,
                     serving["launches"], adapters["err"], adapters["ms"],
                     adapters["plain_ms"])
    rows.append(row)
    leaf_errs = phase_leaf_kernels(full_plan)
    for name, launches, err, ms, plain_ms in phase_per_leaf(full_plan):
        rows.append(kernel_row(name, lay, full_plan.distribution, dev, 1,
                               launches, max(err, leaf_errs[name]), ms,
                               plain_ms, plan=full_plan))
    errs, sharded = phase_sharded_kernels(full_plan, dev)
    launches = phase_sharded_training(full_plan)
    for name in SHARDED_KERNELS:
        ms, plain_ms, b_ms, by = sharded[name]
        check(launches[name] > 0, f"{name} did not launch in phase 15")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rbd_step.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None})
    rows.append(phase_prefill())
    rows.extend(phase_prng(full_plan, dev))
    phase_resilience(dev)
    for name, n in phase_basis(dev).items():
        for row in rows:
            if row["name"] == name:
                row["launches"] += n
    zoo, zoo_rows = phase_zoo(dev)
    for row in rows:
        row["launches"] += zoo.get(row["name"], 0)
    rows.extend(zoo_rows)
    encdec, enc_row, enc_errs = phase_encdec_vision(dev)
    for row in rows:
        row["launches"] += encdec.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"],
                                 enc_errs.get(row["name"], 0.0))
    rows.append(enc_row)
    tools, tool_errs = phase_tools(dev)
    for row in rows:
        row["launches"] += tools.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"],
                                 tool_errs.get(row["name"], 0.0))
    pjit, shard_rows = phase_pjit(dev)
    for row in rows:
        row["launches"] += pjit.get(row["name"], 0)
    rows.extend(shard_rows)
    dry = phase_dryrun(dev)
    for row in rows:
        row["launches"] += dry["launches"].get(row["name"], 0)
    slab = phase_slab_resilience(dev)
    for row in rows:
        row["launches"] += slab.get(row["name"], 0)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
