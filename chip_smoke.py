#!/usr/bin/env python3
"""Drive repro_torch's main paths on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # from the repository root

Phases (each one fails the run by raising):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one process
   per source, in parallel) and print the seconds;
2. least squares at full size: the paper's Sec 5.1.1 simulation (X ~
   U[-10, 10], 20% of the betas nonzero in [-1, 1], N(0, 1) noise) at
   n = 1000, p = 100,000, float64, solved three ways — ``auto`` (K1/K2
   screen + the Gram engine's sweep K6, as the reference routes least
   squares), ``inner_backend="cuda"`` (the K3 burst) and ``torch``/``torch``
   (the plain path, on the card). Each solve
   must be certified on the card (gap <= eps, KKT residual <= 1e-3 lam) and
   all three must find the same support;
3. logistic at full size: gaussian design, 40 true features, labels from
   their sign (n = 1000, p = 100,000, float64); ``auto`` must route the
   burst through K3; the same certificates;
4. the fused transform at full width: phase 2's X through ``prepare_fused``
   on a chain under ``auto`` launches K4 exactly once, and K4 equals its
   plain version bit for bit in float64 and float32, at full width and at
   edge shapes (13 rows, p = 1 to 5,000, signed zeros and NaN in the first
   and last columns, a view whose rows start off a 16-byte boundary; NaN
   where the plain version has NaN);
5. fused least squares: the chain problem of benchmarks/bench_fused.py at
   n = 1000, p = 5,000, float64, at FUSED_LS_LAM lambda_max, through
   ``saif_fused`` under ``auto`` (K4, K1, K2 and K6 with b's weight 0) and
   plain; each
   certified (gap <= eps and the KKT residual with b's weight 0 <= 1e-3
   lam), one support;
6. fused logistic on the same design, labels sign(X beta + 0.3 noise), at
   FUSED_LOGIT_LAM lambda_max, the same two ways (K3-pen) and
   certificates;
7. ``fused_path`` over 4 lambdas from 0.7 to 0.3 lambda_max (geometric) on
   phase 5's problem: every point certified, supports growing;
8. every kernel against its plain version on the card, in float64 and
   float32, at the shapes the solves gave it: max error against a stated
   tolerance, the kernel's own device time per launch (``ms``, from
   torch.profiler) beside the time of a call of its wrapper (``call_ms``,
   CUDA events around the calls), the plain version's time, the time of a
   PyTorch call computing the same function where one exists, and the
   least time the card could take (bytes or operations, whichever
   bounds); K2's histogram and tail entries bit for bit their twins at the
   solve's shapes and on inputs with ties, ub on a bound, -inf and NaN ub
   and +inf bounds (h = 1 to 1024); ``[screen-step]``: the device
   activities and host microseconds of one serial screen call;
9. the least-squares fleet at full width: phase 2's X with B = 16
   responses built as benchmarks/bench_batch.py's ``_fleet_problem``
   builds them (15 true features in [-1, 1], N(0, 1) noise, a seed per
   response), lambda_b spread geometrically from 0.8 down to 0.3 of each
   problem's lambda_max, through ``fleet_solve`` under ``auto`` (K1b, K2b,
   K6b and no serial kernel); every problem certified (gap <= eps, KKT
   <= 1e-3 lambda_b) and its row bit for bit the port's serial ``saif``
   on the card (K1/K2/K6); the fleet's wall against the sum of the 16
   serial walls, and the fleet profiled; ``[fleet-ls/cuda]`` the same
   with ``inner_backend="cuda"`` (K3b, rows bitwise their K3 serials);
   ``[fleet-fast/working|float32|bfloat16]`` the same fleet under
   ``parity="fast"`` in each screen dtype (K1b in working precision or in
   its mixed mode, K2b, K6b sweeping each problem's slot range, no K3b):
   every row certified with the bitwise fleet's support, the wall against
   the bitwise fleet's, outer steps, launches, escalated rows, host reads
   per outer step, and each profiled;
10. the logistic fleet: B = 8 label vectors over phase 3's design (40 true
   features each, a seed per vector), lambda from 0.5 down to 0.2
   lambda_max, the same checks;
11. the plain fleet on the card: ``torch`` screen and inner on 2 problems
   of phase 9 (its largest and smallest lambda): the kernel fleet's
   support, beta within rtol 1e-6, gap <= eps;
12. K1b, K2b and K3b against their plain versions at the fleet's shapes
   (B = 16, n = 1000, p = 100,000, the h, k_max and final active blocks
   of ``[fleet-ls/cuda]``, K3b's own fleet), in float64 and
   float32, and each against B launches of its serial kernel (K1, K2,
   K3), bit for bit; K1b and K2b's tail also with per-problem column
   norms (the 16 subsample masks of phase 14), against their twins and
   16 launches of K1 and K2 each with its own norms; K2b on the edge
   inputs; ``[screen-step]`` of one fleet screen call;
13. ``[cv-ls]``: ``cv_solve`` with K = 5 folds over the lambda grid
   CV_GRID (geometric, fractions of lambda_max) on phase 2's X and a
   response built as the fleets' are (15 true features); the fold fleets
   (``refit=False``, counted alone) must run K1b + K2b + the Gram sweep
   K6b and nothing else, the serial refit at the best lambda (counted
   alone) K1/K2/K3; every (fold, lambda) certified (gap <= eps, weighted
   KKT <= 1e-3 lambda), the refit certified; at two lambdas the 5-fold
   weighted fleet equals five weighted fleets of one bit for bit; at one
   lambda fold 1 (solved to eps = 1e-9) has the support of the serial
   solve on its 800 weight-1 rows (K1/K2/K3) and beta within 1e-9;
14. ``[select]``: ``select_solve`` over the CV grid with 16 half
   subsamples (one weighted fleet, K1b + K2b + K6b), every subsample
   problem certified, the true features' frequencies and the stable
   support; ``[select/fast]`` the same under ``parity="fast"`` with the
   bf16 screen (the subsample fleet on the lockstep engine, K1b's bf16
   mode): the bitwise selection's lambda and stable support;
15. the weighted logistic fleet under ``auto`` raises on the card, naming
   ``inner_backend="torch"``;
16. ``[cm-epochs]``: ``ops.cm_epochs`` (K5) as a caller drives it, on
   the LS solve's final active block in float32;
17. K5 against its plain version (1 and 40 epochs, the objective
   non-increasing epoch by epoch; and no epoch, a nonzero beta on dead
   slots, n = 2,048, 2,049 and 7,900, k = 1), and the Gram sweep K6
   against its plain version on the LS Gram solve's final carry in float64 and
   float32, and K6b on the CV's 5 fold carries at its last lambda against
   its plain version and bit for bit 5 launches of K6; both sweeps start
   from beta = 0, as the K3 and K5 checks do; K1b (B = 16) and K1 in
   their mixed mode (bf16 inputs on the tensor-core scan, float32 inputs
   on the fma chains; float32 sums), at full width and at p = 777, n =
   1001 (there also m = 5 and 17): every score within its route's
   certified bound gamma_total ||theta|| ||x_i|| of the float64 product
   (the wgmma sums certified as a truncating float32 adder, u = 2^-23) and
   within the sums' bound (gamma_n(2^-24) + gamma_n(u_route)) sum_j
   |theta_j x_ji| of the twin (the same rounded inputs), the tile winners
   the twin's where they stand clear, timed beside cuBLAS on the same cast
   inputs; K6b with the identity
   order on ``[fleet-fast/working]``'s carries (dead slots interleaved, a
   frozen problem, 1-40 epochs) against its twin;
18. K7 against its plain version in float64 and float32 (rel 1e-9 and
   1e-3): one epoch from beta = 0 over 20,000 columns of the LS design,
   masked slots, an unpenalized slot, k = 1, one and two slots repeated,
   n = 2,048 and 2,049, logistic (also with an unpenalized slot), orders
   of 3-9 slots and n = 1,024, 1,025 and 12,792 (the redesign's
   boundaries), and in float64 5 epochs at the LS design's full width
   from a warm beta; its
   device time per launch at 20,000 columns, on 2,000 columns and at full
   width, and microseconds per step;
19. ``[baselines-ls]``: the paper's baselines on phase 2's problem:
   ``dynamic_screening``, ``sequential_path`` and
   ``homotopy_path(kkt_check=True)`` over BASE_PATH, the unsafe
   ``homotopy_path`` (its recall and precision against the safe one's
   supports) and the unscreened ``solve_lasso_cm`` (tol 1e-6), each
   counted alone: K7 and no other kernel. Every safe baseline is certified
   by the KKT residual over all p (<= 1e-3 lambda at every lambda) and
   finds SAIF's support; wall, outer steps, coordinate updates, K7
   launches, the wall over SAIF's, and (profiled after it) K7's device
   time and the idle share;
20. the Session front door at full width, run last:
   ``[session-ls]``: ``open_session(Problem(X, y), SaifConfig(eps=1e-6))``
   on phase 2's problem (admission, prep and open times; ``prepare_path``
   counted), then a request mix served twice: Scalar(0.3 lambda_max), a
   second cold Scalar in its h bucket, Scalar(0.3, warm=True), a Path
   over 4 lambdas 0.6 -> 0.3, phase 9's Fleet, a 5-fold CV over 6
   lambdas 0.9 -> 0.3 (refit=False); every request certified and counted
   (K1/K2/K6 serial, K1b/K2b/K6b for Fleet and CV), every cold request
   bit for bit its direct call (phases 2 and 9's results where they
   match) and, in the second pass, its first; one preparation in the
   session's life; each request's hot wall beside its direct call's; a
   hot Scalar profiled; ``[session-pad]``: ``pad_to=(1000, 131072)`` a
   Scalar and the Fleet bit for bit phases 2 and 9, ``pad_to=(1024,
   131072)`` a Scalar with phase 2's support, beta within rtol 1e-10,
   certified; ``[session-cache]``: a ``WarmCache`` session, Scalar(0.5)
   misses, Scalar(0.3) hits, certified with the cold support, its outer
   steps against the cold solve's, the digest's cost, the cache's stats
   and events; ``[session-fused]``: phase 5's chain problem through
   ``Problem(penalty=fused(parent))``, K4 once at open, a Scalar and
   phase 7's Path bit for bit ``saif_fused`` / ``fused_path``;
21. the fault-tolerant serving runtime, after the sessions:
   ``[serving-ls]``: phase 20's request mix once through ``open_serving``
   on phase 2's problem, every verdict ok and not degraded, no retry, the
   breaker closed, each value bit for bit and each request's launches
   equal to phase 20's first pass, each request's ``kkt_check_ms`` beside
   its wall; ``[serving-drill]`` under a ``FaultInjector``: a NaN poke on
   Scalar(0.3) with ``ladder=("oracle",)`` (ok, degraded, the rung K7 and
   no other kernel, the cold support, the rung's wall), ``fail_at={1}``
   (one retry, then the cold Scalar bit for bit), the breaker
   (``fail_at={1, 2, 3}``: a typed ``BackendFault``, recorded in
   ``stats()``, the next request refused, no launch and no plain solve
   after it), and a full-width warm
   checkpoint restored by a second ``open_serving`` whose warm Scalar is
   bit for bit the uninterrupted one's (digest, write and restore times).
   Every phase but the drill's breaker fails if the breaker opens;
22. ``[online-ls]``, online row updates: phase 2's problem through
   ``open_session`` and Scalar(0.3 lambda_max), then four ``Update``s of
   STREAM_M = 64 rows of the Sec 5.1.1 law (phase 2's true beta, seeded
   rows; capacity 2,048 rows), a STREAM_WINDOW = 1,000-row ring streamed
   four times on a second session, and the guard drill on the ring (64
   rows scaled by 1e8 ingested with ``resolve=False``, then normal rows
   until they leave the ring, the last re-solving): every re-solve counted
   (K1/K2/K6), certified on the card over the resident rows (gap <= eps,
   KKT <= 1e-3 lambda over all p), no Gram carry rebuild but the drill's
   one (``online_downdate_rebuild``), each stream's last re-solve with the
   support of the cold session on its rows (max |dbeta| printed); each
   update's wall beside the cold solve's, K1 on the padded design beside
   its bound at the capacity and at the resident rows;
23. ``[server-ls]``, the async front end: ``open_server(autostart=False,
   max_batch=16, max_sessions=2)``, phase 9's 16 responses and lambdas
   submitted as 16 Scalars of ``Problem(X, Y[b])``, then ``run``: one
   coalesced batch in the p bucket 131,072, each rider ok and bit for bit
   phase 9's fleet row, the launches ``[session-pad]``'s Fleet's; the
   submit time (the design digest, hashed once) and the wall from ``run``
   to the last future beside phase 9's fleet and serial walls; a
   ``deadline_s=0.001`` Scalar expiring in the queue with no launch; on a
   second server a priority-5 Scalar on a second design dispatched before
   a priority-0 one submitted first; on a third a poisoned rider
   (``FaultInjector(nan_at={1}, nan_unit=3, tags={"fleet"})``, no ladder,
   no retry) failing alone, the other 15 bit for bit their rows; the
   servers' stats;
24. ``[group-ls]`` and ``[group-logit]``, the group LASSO: phase 2's and
   phase 3's designs in 10,000 groups of GROUP_SIZE = 10 consecutive
   columns, a response from 50 true groups with N(0, 1) coefficients
   (least squares y = X beta + N(0, 1); logistic labels sign(X beta + 0.3
   noise)), ``prepare_group`` on the card (h = 128, k_max = 1024), a
   Scalar at GROUP_LAM (GROUP_LOGIT_LAM) of the group lambda_max and a
   4-point Path from GROUP_PATH_HI down to it (each point entered from
   the last), eps = 1e-6, through ``group_solve`` under ``auto`` (B-n3
   and no other kernel), for logistic a Scalar at GROUP_LOGIT_HI too,
   and the Path's first GROUP_PLAIN_POINTS points (the cold one, for
   each loss) again under
   ``backend="torch"`` (no kernel; the plain burst's block step takes
   about 150 times B-n3's, so the rest of the Path and the Scalar would
   take many minutes, PERF.md section 6): every solve
   certified on the card (gap <= eps, max_g ||X_g^T theta|| <= 1 + 1e-3
   over all groups at its final dual point), the two backends' group
   supports equal, their outer steps and live groups side by side;
25. ``[group-oracle]``: the unscreened ``solve_group_lasso_bcd`` (a B-n3
   launch an epoch) on the first 2,000 columns with ``group_solve``'s
   group support there; ``group_solve`` opens at the default 128 slots,
   which the support outgrows, and must flag the overflow and grow;
26. ``[session-group]`` and ``[serving-group]``: ``open_session(Problem(X,
   y, penalty=group(10)))`` serving phase 24's Scalar, a warm Scalar and
   its Path, each certified, bit for bit and launch for launch the
   direct ``group_solve`` calls; the same requests through
   ``open_serving``: every verdict ok, gap-certified with
   ``kkt_residual == 0.0``, no rung, no retry, the breaker shut, bit for
   bit and launch for launch the session's;
27. B-n3 against its plain version on the card in float64 and float32
   (rel 1e-12 and 1e-5): a 40-epoch burst from beta = 0 on phase 24's
   final live blocks (least squares and logistic), gsize 1, 3 and 17, the
   register form's column bound and one past it (gsize 10 and 11), one
   live slot, every slot masked, n at the edges of its rows a thread
   (511, 512, 513, 1,023, 1,024 and 1,025). Its device time per
   launch, microseconds per block step, the plain version's time and the
   bound are taken after phase 8's kernel rows, on blocks of the two
   cells' sizes (their groups of largest c0);
28. ``[sharded-ls/w1]``, feature-sharded SAIF (``distributed/
   saif_sharded.py``) after phase 23: an NCCL process group of one rank
   in this process (a ``file://`` store in a temporary directory) and a
   1-D ``DeviceMesh``; on one session over phase 2's problem a sharded
   Scalar, a warm sharded Scalar, a sharded Path over SHARDED_PATH and
   phase 9's Fleet sharded, and on phase 5's fused session a sharded
   Scalar: each bit for bit the session's unsharded answer with the same
   outer steps, certified (gap <= eps, KKT <= 1e-3 lambda over all p), its
   wall against the unsharded wall, K1/K2 (K1b/K2b) launches against the
   unsharded run's, collectives per outer step; the fused sharded Scalar
   profiled (NCCL device time, idle share). ``[sharded-ls/w2]``: two gloo
   ranks, subprocesses of this script on cuda:0 with a ``file://`` store,
   each holding X_local (1000, p/2) on the card and solving one sharded
   Scalar: rank 0's answer phase 2's ``auto`` Scalar bit for bit, K1 and
   K2 launched on each rank's shard; a rank that fails or outlives
   SHARDED_TIMEOUT_S fails the run;
29. the LM scaffold, run last (it launches none of the kernels above):
   ``[lm-archs]``, all ten architectures of
   ``repro_torch.configs`` at their SMOKE configs in float32, weights from
   a seed, the card's forward logits and 16-step decode against the port's
   CPU run of the same weights (1e-4 x scale) and the card's decode against
   its forward pass (2e-4 x scale; MoE at capacity 64 there);
   ``[lm-hymba/full]``, the published hymba-1.5b config (1.662 B
   parameters) initialised on the card: in float32, B = 4 sequences of
   1,100 tokens through the first LM_F32_LAYERS = 8 of its 32 layers
   (``backbone``) and, token by token, through ``make_serve_step`` (the
   1,024-slot ring wraps), within 2e-4 x scale at every position; in
   bfloat16 at full depth, ``make_prefill`` on B = 4 prompts of 2,048
   tokens against the float32 prefill (LM_BF16_BOUND), 64 greedy decode
   steps, every logit finite; prefill tokens/s, decode ms a step, peak
   memory, and a profiled prefill and 8 steps (busy time, idle share, top
   device ops, device activities a step);
30. the LM scaffold's training, after phase 29 (no kernel either):
   ``[lm-train/archs]``, the ten SMOKE configs in float32: a
   ``make_train_step`` step on the card against the port's CPU step from
   the same seeded weights and batch (loss, per-leaf gradients, their
   global norm; the updated parameters' difference printed), and
   microbatch 2 against 1 on
   the card; ``[lm-train/hymba/full]``, hymba-1.5b at full width and depth
   (float32 masters, bfloat16 compute, remat) trained by the trainer's
   loop (``launch/train.py::train_loop``) on ``TokenPipeline`` (seed 0) at
   4 x 1,024 tokens, AdamW lr 1e-3, warmup 2, total 8, for 8 steps with a
   checkpoint after step 6, then resumed from it: every loss finite, the
   8th below the 1st, steps 7-8 replayed bit for bit under deterministic
   algorithms; each step's ms, tokens/s, loss and gradient norm, peak
   memory, one profiled step with the doubling scan's share of its device
   time; in float32 at 2 x 512, microbatch 2 against 1, each against
   float64, and at 2 layers of full width remat on against off, bit for
   bit; ``[lm-train/cli]``, the
   trainer CLI's ``main`` on the card (stablelm_3b SMOKE): 6 steps,
   resumed to 12, the last 3 printed losses of a straight 12-step run.
31. the dry-run and data parallelism (``launch/dryrun.py``,
   ``launch/train.py::DataParallel``): ``[dryrun/saif-screen/w256|w512]``,
   after the kernel checks and before the first profiles, the dry-run's
   row of the feature-sharded screen on the production mesh of 256 and
   512 ranks (a fake process group) beside K1
   (float32) on one rank's block of it, 4,096 x 262,144 and 4,096 x
   131,072: its device time against the record's memory and collective
   times, its plain version's time, cuBLAS's and the byte bound, and K1
   against its plain version on a column slice (tile maxima within 1e-4,
   the same candidate ids where the scores stand apart);
   ``[lm-train/dp2]``, after phase 30, two gloo ranks on cuda:0
   (subprocesses of this script) training stablelm_3b SMOKE in float32
   with ZeRO-1 moments at a global batch of 8 x 128 for 4 steps, held to
   one rank's run on the card within 1e-5 (losses, parameters leaf by
   leaf), step ms and each rank's moment bytes; ``[dryrun/hymba]``, the
   dry-run records of hymba-1.5b's prefill (4 x 2,048) and train step
   (4 x 1,024) on a 1 x 1 mesh, counted by a subprocess on one core
   (host work) beside ``[lm-train/hymba/full]``'s device-bound steps and
   read before ``[lm-train/cli]``, beside the prefill and step times
   phases 29-30 measured.

Launch counters are zeroed just before each solve (and the transform of
phase 4, the CV fleets, the CV refit, the selection, the K5 call, each
baseline, each session, serving and streaming request, each server's run,
the oracle rung, the fused session's open, each group solve, path and
oracle, and each sharded request) and read just after; the kernel
launches of phases 8, 12, 17, 18 and 27, of the checks of phases 13-14,
of the comparisons of phase 4, of the serial solves that phases 9-10
compare with, of the lambda_max helpers and of one extra solve under
torch.profiler (the device's busy time and idle share; these run after
phase 18, the baselines' after phase 19, the group solves' after phase
27) do not count, nor do phase 31's K1 launches. The last two lines are the
card's name and power limit and ``{"ok": true, "device": {...}}``; the line
before them is the per-kernel JSON record.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# cuBLAS's deterministic workspace, read once at its first call: phase 30
# replays training steps bit for bit under torch's deterministic
# algorithms, which refuse cuBLAS without it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense non-tensor peaks;
# bf16 is the dense tensor-core rate (the bf16 mode's wgmma scan)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}
N = 1000
# lambda / lambda_max. Least squares sits at 0.3, the lowest fraction the
# port certifies within max_outer at this size: at 0.2 and below the
# duality gap stalls above eps = 1e-6 (PERF.md, section 4, from
# scripts/ls_lambda_probe_torch.py).
LS_LAM = 0.3
LOGIT_LAM = 0.2
# The fused phases run where the solve certifies. On the chain problem
# cyclic CM crawls on the nearly collinear suffix-sum columns and ends
# max_outer uncertified, in the reference as in the port: least squares
# past p of about 10,000, logistic at p = 5,000 below about 0.6
# lambda_max (PERF.md, section 4, from scripts/ref_fused_probe.py and
# scripts/fused_lambda_probe_torch.py).
FUSED_P = 5000
FUSED_LS_LAM = 0.3
FUSED_LOGIT_LAM = 0.7
FUSED_PATH = (0.7, 0.3, 4)       # first, last lambda / lambda_max, points
# fleets: first and last lambda / lambda_max (geometric), problems
FLEET_LS = (0.8, 0.3, 16)
FLEET_LOGIT = (0.5, 0.2, 8)
# cross-validation: first and last lambda / lambda_max (geometric), points,
# folds; the stability selection's subsamples and their row fraction
CV_GRID = (0.9, 0.004, 24)
CV_FOLDS = 5
CV_PROFILE_POINTS = 8
SELECT_SUBSAMPLES = (16, 0.5)
# [baselines-ls]: the sequential and homotopy paths run geometric from 0.95
# to LS_LAM lambda_max in 5 points (benchmarks/bench_baselines.py:106),
# every baseline at eps = 1e-6, on phase 2's full design: the five take
# about 50 s there (PERF.md, section 4)
BASE_PATH = (0.95, LS_LAM, 5)
# K7's short orders (slot counts) at its design's boundaries: the beta of
# step s + 2 read behind step s's barrier (in hand up to a count of 2), the
# slot of step s + 5; all shorter than the prefetch warp's 32 records a batch
WIDE_COUNTS = (3, 4, 5, 6, 8, 9)
# [online-ls]: row blocks of this many rows from the Sec 5.1.1 simulation,
# appended four times, then a 1,000-row ring streamed four times
STREAM_M = 64
STREAM_UPDATES = 4
STREAM_WINDOW = N
# the group phases: phase 2's and phase 3's designs in groups of 10
# consecutive columns (10,000 groups; the defaults give h = 128 and k_max
# = 1024 groups), 50 true groups; a Scalar at GROUP_LAM (least squares) or
# GROUP_LOGIT_LAM (logistic) times the group lambda_max and a 4-point Path
# from GROUP_PATH_HI down to it, eps = 1e-6
# (scripts/group_lambda_probe_torch.py sets the fractions)
GROUP_SIZE = 10
GROUP_TRUE = 50
GROUP_LAM = 0.1
GROUP_LOGIT_LAM = 0.1
# a second logistic Scalar, and the logistic timing block, at this fraction
GROUP_LOGIT_HI = 0.3
GROUP_PATH_HI = 0.6
GROUP_EPS = 1e-6
# live groups of B-n3's timing blocks: the group cells' Scalars at
# GROUP_LAM and GROUP_LOGIT_HI end with these many (PERF.md section 6)
GROUP_TIMING_LIVE = {"least_squares": 314, "logistic": 250}
# the Path's leading points that the plain burst solves too, by loss (its
# block step takes about 150 times B-n3's; least squares' warm second
# point took 43 s of the run, and the CPU tests hold the plain burst's
# warm solves, tests/test_torch_group.py)
GROUP_PLAIN_POINTS = {"least_squares": 1, "logistic": 1}
# the LM scaffold (phase 29, run last): [lm-archs] decodes
# this many steps at B = 2; [lm-hymba/full] runs B = 4 sequences of
# LM_F32_LEN tokens in float32 through its first LM_F32_LAYERS layers at
# full width (past the 1,024-token window: the decode ring wraps, and
# Mamba pads 1,100 to 1,152; the decode is host-bound at about 2.5 ms a
# layer a step, so all 32 layers took 88 s of the run), then B = 4
# prompts of LM_PROMPT tokens in bfloat16 through all 32 layers and
# LM_SERVE_STEPS greedy decode steps, and profiles one prefill and
# LM_PROFILE_STEPS steps
LM_DECODE = 16
LM_BATCH = 4
LM_F32_LEN = 1100
LM_F32_LAYERS = 8
LM_PROMPT = 2048
LM_SERVE_STEPS = 64
LM_PROFILE_STEPS = 8
# bfloat16 against float32 on the prefill's last-position logits: the rms
# of the difference within LM_BF16_BOUND of the float32 logits' rms, and
# its max within LM_BF16_BOUND x (max|float32 logits| + 1) (PERF.md's
# findings derive it)
LM_BF16_BOUND = 0.25
# the training phase (30): [lm-train/archs] at B x S = LM_TRAIN_ARCH_BS;
# [lm-train/hymba/full] trains LM_TRAIN_STEPS steps of LM_TRAIN_BATCH x
# LM_TRAIN_SEQ tokens (the schedule's total), checkpoints after
# LM_TRAIN_CKPT steps and resumes from there; its float32 microbatch
# check runs at LM_TRAIN_F32_BS
LM_TRAIN_ARCH_BS = (4, 32)
LM_TRAIN_BATCH = 4
LM_TRAIN_SEQ = 1024
LM_TRAIN_STEPS = 8
LM_TRAIN_CKPT = 6
LM_TRAIN_F32_BS = (2, 512)
# card against CPU and microbatch 2 against 1: the loss within
# LM_TRAIN_LOSS_REL relative, each gradient leaf within LM_TRAIN_GRAD_REL x
# its largest entry (the CPU tests' bounds against the reference)
LM_TRAIN_LOSS_REL = 1e-5
LM_TRAIN_GRAD_REL = 1e-4
# hymba's A_log at full width in float32, its own bound: each of its
# entries sums the terms of 1,024 tokens and 16 state channels of both
# signs, and microbatch 2 parted from 1 by 1.22e-4 of its largest entry
# in one chip run (PERF.md, section 6). Both float32 gradients are held to
# a float64 one of the same weights and batch within this bound too, the
# witness that neither is wrong
LM_TRAIN_ALOG_REL = 5e-4
# the dry-run (phase 31): the screen row's n, log2 p and h, and the block
# columns K1 is held to its plain version on; hymba's records at the
# LM phases' shapes come from a subprocess (host work on one core, run
# beside [lm-train/hymba/full]'s device-bound steps), which fails the run
# past DRYRUN_TIMEOUT_S
DRYRUN_SCREEN = (4096, 26, 64)
DRYRUN_SLICE = 8192
DRYRUN_TIMEOUT_S = 300
# [lm-train/dp2]: two gloo ranks on cuda:0, stablelm_3b SMOKE in float32,
# global batch DP_BATCH (rows, tokens) for DP_STEPS steps, held to one
# rank's run within DP_REL (losses; parameters leaf by leaf, the norm of
# the difference over the leaf's norm: Adam moves an entry whose gradient
# is near zero by up to 2 lr on a last-bit difference)
DP_BATCH = (8, 128)
DP_STEPS = 4
DP_REL = 1e-5
DP_TIMEOUT_S = 120


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def simulation_data(n, p, seed=0, with_beta=False):
    """Paper Sec 5.1.1: X ~ U[-10,10], 20% active betas in [-1,1], N(0,1).
    ``with_beta``: the true beta too, for more rows of the same law."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.uniform(-10, 10, (n, p))
    beta = np.zeros(p)
    idx = rng.choice(p, int(0.2 * p), replace=False)
    beta[idx] = rng.uniform(-1, 1, len(idx))
    y = X @ beta + rng.normal(0, 1, n)
    return (X, y, beta) if with_beta else (X, y)


def stream_shape(n):
    """(row capacity, resident rows) of ``[online-ls]``'s append stream
    from n rows (the power-of-two headroom of ``core/online.py``)."""
    filled = n + STREAM_UPDATES * STREAM_M
    return 1 << (max(2 * n, n + 4 * STREAM_M) - 1).bit_length(), filled


def simulation_rows(beta, m, seed, device, scale=1.0):
    """``m`` more rows of the Sec 5.1.1 law for the true ``beta`` (numpy),
    on ``device``: X ~ U[-10, 10] (times ``scale``), y = X beta + N(0, 1)
    (no noise when ``scale`` is not 1: the guard drill's rows)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    Xn = scale * rng.uniform(-10, 10, (m, beta.shape[0]))
    yn = Xn @ beta
    if scale == 1.0:
        yn = yn + rng.normal(0, 1, m)
    return torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)


def logistic_data(n, p, seed=2, k=40):
    """Gaussian design, k true features, labels sign(X w + 0.3 noise)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    w = np.zeros(p)
    w[rng.choice(p, k, replace=False)] = rng.uniform(-2, 2, k)
    y = np.sign(X @ w + 0.3 * rng.normal(size=n))
    y[y == 0] = 1.0
    return X, y


def fused_chain_data(n, p, seed=0, logistic=False):
    """benchmarks/bench_fused.py's chain problem: X ~ N(0, 1), beta = 2 on
    the first p/8 and -1 on the next p/8, y = X beta + 0.1 noise; with
    ``logistic`` the labels are sign(X beta + 0.3 noise) instead."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[: p // 8] = 2.0
    beta[p // 8: p // 4] = -1.0
    if not logistic:
        return X, X @ beta + 0.1 * rng.normal(size=n)
    y = np.sign(X @ beta + 0.3 * rng.normal(size=n))
    y[y == 0] = 1.0
    return X, y


def group_response(X, seed, logistic=False, gsize=GROUP_SIZE,
                   k=GROUP_TRUE):
    """A response over the design ``X`` (on its device) from ``k`` true
    groups of ``gsize`` consecutive columns with N(0, 1) coefficients:
    y = X beta + N(0, 1), or with ``logistic`` the labels
    sign(X beta + 0.3 noise). Seeded with numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n, p = X.shape
    beta = np.zeros(p)
    for g in rng.choice(p // gsize, k, replace=False):
        beta[g * gsize:(g + 1) * gsize] = rng.normal(size=gsize)
    noise = torch.from_numpy(rng.normal(size=n)).to(X.device)
    z = X @ torch.from_numpy(beta).to(X.device)
    if not logistic:
        return z + noise
    y = torch.sign(z + 0.3 * noise)
    y[y == 0] = 1.0
    return y


def group_kkt(loss, X, y, res, lam, gsize=GROUP_SIZE):
    """max_g ||X_g^T theta|| over every group at the dual point of a group
    solve's final step: hat = -f'(X beta) / lam scaled by 1 / max(1, the
    largest live group's ||X_g^T hat||). At most 1 (+ rounding) when the
    solve is optimal."""
    import torch
    hat = -loss.grad(X @ res.beta, y) / lam
    s = torch.linalg.vector_norm((X.T @ hat).view(-1, gsize), dim=1)
    live = res.gidx[res.gmask]
    top = float(s[live].max()) if live.numel() else 0.0
    return float(s.max()) / max(top, 1.0)


def group_support(beta, gsize=GROUP_SIZE, tol=1e-8):
    import torch
    return set(torch.nonzero(torch.linalg.vector_norm(
        beta.view(-1, gsize), dim=1) > tol).flatten().tolist())


# K4's edge shapes: one column, a tile less one, one tile, a tile plus one,
# no whole 16-byte rows, whole rows with a partial tile, many tiles
CHAIN_EDGE_P = (1, 255, 256, 257, 777, 1000, 5000)


def chain_edge_input(n, p, dtype, seed):
    """A gaussian (n, p) design for K4 with -0.0 and NaN in its first and
    last columns, and row 6 all -0.0 (when n > 6)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(n, p, generator=g, dtype=torch.float64)
    X[0::3, -1] = -0.0
    X[1::6, -1] = float("nan")
    X[2::4, 0] = -0.0
    X[3::8, 0] = float("nan")
    if n > 6:
        X[6, :] = -0.0
    return X.to(dtype)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, one warm-up):
    the call's time, host work between launches included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_events(fn, reps: int, expect=None):
    """The device activities (kernels, copies, memsets) that ``reps`` calls
    of ``fn`` put on the card, from torch.profiler after one warm-up.
    Late in a run a session can miss some of its launches (one or two of
    200, whatever the waits around them; a fresh process misses none), so
    callers average over the launches it kept. ``expect`` = (name, launches
    per call): a session that kept under half of that kernel's launches
    is run again, three times at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if expect is None:
            return ev
        seen = sum(expect[0] in e.name for e in ev)
        if 2 * seen >= expect[1] * reps:
            return ev
        print(f"[profiler] kept {seen} of {reps} x {expect[1]} launches of "
              f"{expect[0]}; again", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler kept under half of {reps} x "
                       f"{expect[1]} launches of {expect[0]} three times")


def kernel_durations(fn, reps: int, kernel: str):
    """The device durations (us) of the launches whose name holds
    ``kernel`` that ``reps`` calls of ``fn`` put on the card, after one
    warm-up: torch.profiler recording device activities only, read from
    its raw events (as :func:`profile_solve` reads them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e.duration_ns() / 1e3
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and kernel in e.name()]


# profiler sessions :func:`device_ms` may take to keep half its launches
# (in two runs a session kept none of 10 or 20 launches twice in a row)
DEVICE_MS_SESSIONS = 5


def device_ms(fn, reps: int, kernel: str) -> float:
    """The kernel's own device time per launch, in ms: the durations of
    the launches whose name holds ``kernel`` over ``reps`` calls (one
    each; ten at least, as a session may miss one or two), summed and
    divided by their number (the wrapper's other device work, such as a
    fill or a cast, is left out). A session that kept under half of the
    launches is followed by another, DEVICE_MS_SESSIONS in all at most,
    whose kept launches join the first's until they make half of
    ``reps``."""
    reps = max(reps, 10)
    kept = []
    for _ in range(DEVICE_MS_SESSIONS):
        kept += kernel_durations(fn, reps, kernel)
        if 2 * len(kept) >= reps:
            return sum(kept) / len(kept) / 1e3
        print(f"[profiler] {len(kept)} launches of {kernel} kept so far of "
              f"{reps} wanted; again", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler kept {len(kept)} launches of {kernel} "
                       f"in {DEVICE_MS_SESSIONS} sessions of {reps}")


def kernel_ms(fn, reps: int, kernel: str):
    """(device ms per launch of ``kernel``, ms per call of ``fn``)."""
    return device_ms(fn, reps, kernel), time_ms(fn, reps)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def support(beta, tol=1e-8):
    import torch
    return set(torch.nonzero(beta.abs() > tol).flatten().tolist())


def profile_solve(tag, solve, wall, kernels=(), match=(), per=1,
                  host_ops=False, ranges=()):
    """Run ``solve`` once more under torch.profiler and print the device's
    busy time (the sum of its activities' durations, one stream) against
    the unprofiled wall time ``wall``, and the kernels that take most of
    it (a kernel's template instances counted together), the device
    time and launches of each kernel named in ``kernels``, and those of
    the activities whose name holds a substring of ``match`` (any case);
    with ``per`` > 1 (``solve`` runs that many steps), the activities,
    busy and wall ms a step too. The profiler records device activities
    only (recording the host's ops cost it more time than the profiled
    runs took), unless ``host_ops``: without them it recorded none of
    NCCL's kernels. For each name in ``ranges`` (host ranges that
    ``solve`` opens with ``record_function``; needs ``host_ops``), the
    device time launched inside them and inside the backward of the
    autograd nodes recorded there (:func:`range_device_us`), and its share
    of the busy time. Returns the busy seconds (None when the profiler
    recorded no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        solve()
        torch.cuda.synchronize()
    # (name, us) of each device activity, read from the profiler's raw
    # events: building its function events (``prof.events()``) took about
    # 0.14 ms an activity on the card's host, 15 s for a training step
    # (the device's copies of the ``ranges`` are spans, not activities)
    raw = prof.profiler.kineto_results.events()
    ev = [(e.name(), e.duration_ns() / 1e3) for e in raw
          if e.device_type() == DeviceType.CUDA and e.name() not in ranges]
    busy_s = sum(us for _, us in ev) / 1e6
    if busy_s == 0.0:
        print(f"[profile {tag}] device time: not measured (the profiler "
              f"recorded no device activity)", flush=True)
        return
    # one line per kernel, its template instances summed
    fam = {}
    for full, us in ev:
        name = full.split("<")[0].split("::")[-1].split("(")[0].strip()
        t, c = fam.get(name, (0.0, 0))
        fam[name] = (t + us, c + 1)
    top = sorted(fam.items(), key=lambda kv: -kv[1][0])[:5]
    tops = "; ".join(f"{name[:60]} {t / 1e3:.2f} ms x{c}"
                     for name, (t, c) in top)
    named = "".join(f" {kn}_ms={fam.get(kn, (0.0, 0))[0] / 1e3:.3f} "
                    f"{kn}_launches={fam.get(kn, (0.0, 0))[1]}"
                    for kn in kernels)
    for m in match:
        hit = [us for full, us in ev if m in full.lower()]
        named += f" {m}_ms={sum(hit) / 1e3:.3f} {m}_ops={len(hit)}"
    for r in ranges:
        us, nested = range_device_us(raw, r)
        named += (f" {r}_ms={us / 1e3:.3f} {r}_share_of_busy="
                  f"{us / 1e6 / busy_s:.3f} {r}_backward_ranges_holding_"
                  f"one={nested}")
    if per > 1:
        named += (f" per_step: ops={len(ev) / per:.1f} busy_ms="
                  f"{1e3 * busy_s / per:.3f} wall_ms={1e3 * wall / per:.3f}")
    print(f"[profile {tag}] device_busy_s={busy_s:.4f} wall_s={wall:.4f} "
          f"idle_share={1 - busy_s / wall:.3f} device_ops={len(ev)}{named} "
          f"top: {tops}", flush=True)
    return busy_s


def range_device_us(raw, name):
    """(device us, nested) of the profiler's raw events ``raw`` (host ops
    recorded): the durations of the device activities whose launching op
    started inside a host range called ``name``, or inside the autograd
    engine's backward of a node that an op in such a range recorded (the
    engine's ``evaluate_function`` range carries the forward op's sequence
    number and thread). ``nested`` counts those backward ranges that hold a
    ``name`` range themselves (a checkpoint's recompute run inside one:
    then more than the range's own work is counted)."""
    import bisect
    from torch.autograd import DeviceType
    bw_tag = "autograd::engine::evaluate_function"
    # (name, thread, start, end, correlation, sequence number, forward
    # thread) of torch's ops and ranges, read once; the CUDA API's calls
    # (cu*) number their correlations apart, so their ids would collide
    host, dev = [], []
    for e in raw:
        nm = e.name()
        if e.device_type() == DeviceType.CPU:
            if not nm.startswith("cu"):
                t = e.start_ns()
                host.append((nm, e.start_thread_id(), t, t + e.duration_ns(),
                             e.correlation_id(), e.sequence_nr(),
                             e.fwd_thread_id()))
        elif nm != name:
            dev.append((e.linked_correlation_id(), e.duration_ns()))

    def spans(rows):
        """{thread: sorted, merged [(start, end)]}"""
        by = {}
        for r in rows:
            by.setdefault(r[1], []).append((r[2], r[3]))
        for tid, r in by.items():
            r.sort()
            merged = [r[0]]
            for a, b in r[1:]:
                if a <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], b))
                else:
                    merged.append((a, b))
            by[tid] = merged
        return by

    def inside(by, tid, t):
        r = by.get(tid)
        if not r:
            return False
        i = bisect.bisect_right(r, (t, math.inf)) - 1
        return i >= 0 and t <= r[i][1]

    ranges = [r for r in host if r[0] == name]
    fwd = spans(ranges)
    keys = {(r[1], r[5]) for r in host
            if r[5] >= 0 and not r[0].startswith(bw_tag)
            and inside(fwd, r[1], r[2])}
    bw_rows = [r for r in host if r[0].startswith(bw_tag)
               and (r[6], r[5]) in keys]
    bw = spans(bw_rows)
    nested = sum(1 for r in ranges if inside(bw, r[1], r[2]))
    both = spans(ranges + bw_rows)
    launch = {r[4]: (r[1], r[2]) for r in host if r[4] > 0}
    us = 0.0
    for corr, ns in dev:
        at = launch.get(corr)
        if at is not None and inside(both, *at):
            us += ns / 1e3
    return us, nested


# profiled re-runs of the solves, (tag, solve, wall[, kernels]), run after
# the kernel checks: the kernel rows' short profiler sessions come first
DEFERRED_PROFILES = []
# (start, last mark) of the run, for :func:`mark`
MARKS = [0.0, 0.0]
# unprofiled wall of each counted solve of solve_phase, by "name/label"
WALLS = {}
# launch counts kept for a later phase's comparison
COUNTS = {}


def run_deferred_profiles():
    """Profile the solves queued in DEFERRED_PROFILES, and empty it."""
    while DEFERRED_PROFILES:
        tag, solve, wall, *kernels = DEFERRED_PROFILES.pop(0)
        profile_solve(tag, solve, wall, *kernels)


def solve_phase(name, lam, cfg, runs, expect, solve, kkt, profiled=()):
    """Run ``solve(config)`` once per entry of ``runs`` (label -> config
    overrides), certify each solve on the card (gap <= eps and
    ``kkt(result) <= 1e-3 lam``) and check the launch counts; the labels
    in ``profiled`` are then profiled in one more, uncounted solve."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops

    results, launches = {}, {}
    for label, over in runs.items():
        c = dataclasses.replace(cfg, **over)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        kkt_v = float(kkt(res))
        gap = float(res.gap)
        print(f"[{name}/{label}] outer={res.n_outer} n_active="
              f"{res.n_active} k_max={res.active_idx.shape[0]} gap={gap:.3e}"
              f" eps={c.eps:.1e} kkt={kkt_v:.3e} kkt_limit={1e-3 * lam:.3e} "
              f"wall_s={wall:.3f} launches={counts}", flush=True)
        if not (gap <= c.eps and kkt_v <= 1e-3 * lam):
            raise RuntimeError(f"{name}/{label}: solve not certified")
        check_launches(f"{name}/{label}", counts, expect[label])
        results[label] = res
        launches[label] = counts
        WALLS[f"{name}/{label}"] = wall
        if label in profiled:
            DEFERRED_PROFILES.append((f"{name}/{label}",
                                      lambda c=c: solve(c), wall))
    sups = {label: support(r.beta) for label, r in results.items()}
    first = next(iter(sups.values()))
    if any(s != first for s in sups.values()):
        raise RuntimeError(f"{name}: supports differ across runs: "
                           f"{ {k: len(v) for k, v in sups.items()} }")
    print(f"[{name}] support size {len(first)} identical across "
          f"{list(sups)}", flush=True)
    return results, launches


def check_launches(tag, counts, expect):
    """``expect``: kernel -> True (launched at least once), False (never)
    or an int (exactly that many times). K7 (``cm_sweep_wide``), the
    baselines' sweep, and B-n3 (``group_bcd``), the group engine's, must
    not launch where ``expect`` does not name them."""
    for kname, must in {"cm_sweep_wide": False, "group_bcd": False,
                        **expect}.items():
        got = counts[kname]
        if must is True and got == 0:
            raise RuntimeError(f"{tag}: kernel {kname} was never launched "
                               f"on the main path")
        if must is False and got != 0:
            raise RuntimeError(f"{tag}: kernel {kname} launched {got} times "
                               f"where it has no place")
        if not isinstance(must, bool) and got != must:
            raise RuntimeError(f"{tag}: kernel {kname} launched {got} times,"
                               f" expected {must}")


def mark(label):
    """Print the seconds since the run started and since the last mark,
    on both streams (a run stopped at its time limit shows its last phase
    in the end of its errors)."""
    now = time.perf_counter()
    line = (f"[time] {label} at_s={now - MARKS[0]:.1f} took_s="
            f"{now - MARKS[1]:.1f}")
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    MARKS[1] = now


def errs(pairs):
    """(max abs error, max error over each reference's own scale) on the
    finite entries; a different non-finite pattern is inf."""
    import torch
    worst_abs = worst_rel = 0.0
    for a, b in pairs:
        fin = torch.isfinite(b)
        if not bool((a[~fin] == b[~fin]).all()):
            return float("inf"), float("inf")
        if bool(fin.any()):
            d = float((a[fin] - b[fin]).abs().max())
            worst_abs = max(worst_abs, d)
            worst_rel = max(worst_rel,
                            d / max(float(b[fin].abs().max()), 1e-300))
    return worst_abs, worst_rel


def burst_error(loss_name, out, ref, ys, lam_s):
    """K3's error against its plain twin: beta, z, theta against their own
    scale; the gap, a difference P - D of two near-equal objectives,
    against the scale of D."""
    import repro_torch as rt
    abs3, err3 = errs(zip(out[:3], ref[:3]))
    d_scale = 1.0 + abs(float(rt.get_loss(loss_name).dual_objective(
        ys, ref[2], lam_s)))
    gap_err = abs(float(out[3]) - float(ref[3]))
    return max(abs3, gap_err), max(err3, gap_err / d_scale)


def burst_inputs(Xs, idx, mask):
    """K3's inputs on a solve's final active block ``Xs[:, idx]`` (dead
    slots zeroed), from beta = 0: (A, A^T, col_sq, order, live count,
    beta0)."""
    import torch
    from repro_torch.core.active_set import compact_order
    k = mask.shape[0]
    order = compact_order(torch.arange(k, device=mask.device), mask)
    A = torch.where(mask[None, :], Xs[:, idx], 0.0)
    cn = torch.where(mask, torch.linalg.vector_norm(A, dim=0), 0.0)
    return (A, A.T.contiguous(), cn * cn, order, int(mask.sum()),
            torch.zeros(k, dtype=Xs.dtype, device=Xs.device))


def gram_slots(X, y, idx, mask, dt, w=None):
    """K6's inputs on a final active block ``X[:, idx]`` (dead slots
    zeroed; ``w``: a fold's sample weights), from beta = 0: (G, rho,
    beta0, mask, order, live count)."""
    import torch
    from repro_torch.core.active_set import compact_order
    k = mask.shape[0]
    Xa = torch.where(mask[None, :], X[:, idx], 0.0)
    Xw = Xa if w is None else w[:, None] * Xa
    order = compact_order(torch.arange(k, device=mask.device), mask)
    return ((Xa.T @ Xw).to(dt), (Xw.T @ y).to(dt),
            torch.zeros(k, dtype=dt, device=mask.device), mask, order,
            int(mask.sum()))


def same_bits(outs, refs):
    """Every output equals its reference bit for bit (NaN where it has NaN,
    the same dtype and shape)."""
    import torch
    for a, b in zip(outs, refs):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.is_floating_point():
            nan = torch.isnan(b)
            if not torch.equal(torch.isnan(a), nan):
                return False
            ints = torch.int64 if a.dtype == torch.float64 else torch.int32
            if not torch.equal(a[~nan].view(ints), b[~nan].view(ints)):
                return False
        elif not torch.equal(a, b):
            return False
    return True


def tail_edge_inputs(dtype, b, h, per_problem, p=777, seed=31):
    """Inputs of K2's tail entry with every edge at once: p not a multiple
    of 256; -inf ub (active columns) and a NaN ub; tied candidates; a
    padding candidate (score -inf, id >= p, so lb = +inf); two ub exactly
    on a candidate's bound. Returns (ub, tmax, cand_score, cand_idx,
    col_norm, r) on the card, ub (b, p)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    dt, dev = getattr(torch, dtype), torch.device("cuda")
    rng = np.random.default_rng(seed + h)
    ub = 2.0 * rng.normal(size=(b, p))
    ub[rng.random((b, p)) < 0.1] = -np.inf
    ub[:, 5] = np.nan
    score = np.abs(rng.normal(size=(b, h)))
    idx = rng.integers(0, p, (b, h))
    if h > 1:
        score[:, 1] = score[:, 0]
        idx[:, 1] = idx[:, 0]                  # a tied bound
        score[:, h - 1] = -np.inf
        idx[:, h - 1] = p + 3                  # a padding lane
    cn = np.abs(rng.normal(size=(b, p) if per_problem else (p,)))
    r = rng.uniform(0.0, 0.5, b)

    def t(a, d=dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, d)

    args = [t(ub), None, t(score), t(idx, torch.int64), t(cn), t(r)]
    # ub exactly on two candidates' bounds (the twin's)
    lb = ops.screen_tail_batch_ref(args[0], args[0][:, :1], *args[2:])[1]
    args[0][:, 7] = lb[:, 0]
    args[0][:, 9] = lb[:, min(2, h - 1)]
    pb = -(-p // 256)
    pad = torch.full((b, pb * 256 - p), -torch.inf, dtype=dt, device=dev)
    args[1] = torch.cat([args[0], pad], 1).reshape(b, pb, 256).amax(2)
    return args


def check_tail_edges(dtype, batch):
    """K2's two entries against their twins bit for bit on
    :func:`tail_edge_inputs` at h = 1, 3, 16, 300 (the block-wide sort)
    and 1024; with ``batch`` K2b on 3 problems, with shared and with
    per-problem norms, each row also bitwise the serial kernel's."""
    import torch
    from repro_torch.kernels import ops
    ok = True
    for h in (1, 3, 16, 300, 1024):
        for per_problem in ((False, True) if batch else (False,)):
            b = 3 if batch else 1
            ub, tmax, sc, ix, cn, r = tail_edge_inputs(dtype, b, h,
                                                       per_problem)
            if batch:
                out = ops.screen_tail_batch(ub, tmax, sc, ix, cn, r)
                ref = ops.screen_tail_batch_ref(ub, tmax, sc, ix, cn, r)
                ok = ok and same_bits(out, ref)
                for i in range(b):
                    one = ops.screen_tail(ub[i], tmax[i], sc[i], ix[i],
                                          cn[i] if per_problem else cn, r[i])
                    ok = ok and same_bits([o[i] for o in out], one)
                lbs = torch.sort(ref[1], dim=1).values
                ok = ok and same_bits([ops.ub_histogram_batch(ub, lbs)],
                                      [ops.ub_histogram_batch_ref(ub, lbs)])
            else:
                args = (ub[0], tmax[0], sc[0], ix[0], cn, r[0])
                ref = ops.screen_tail_ref(*args)
                ok = ok and same_bits(ops.screen_tail(*args), ref)
                lbs = torch.sort(ref[1]).values
                ok = ok and same_bits([ops.ub_histogram(ub[0], lbs)],
                                      [ops.ub_histogram_ref(ub[0], lbs)])
    print(f"[kernel {'ub_histogram_batch' if batch else 'ub_histogram'} "
          f"{dtype} edges] p=777 h=1,3,16,300,1024 ties, ub on a bound, "
          f"-inf and NaN ub, +inf lb{', shared and per-problem norms' if batch else ''}: "
          f"bitwise_twin={ok}", flush=True)
    if not ok:
        raise RuntimeError(f"K2 {dtype} (batch={batch}) differs from its "
                           f"twin on the edge inputs")


def screen_step(tag, screen, reps=50, calls=10):
    """One screen call as the engine makes it: the device activities the
    profiler counts in it (those after the scan apart; means over
    ``calls`` calls, as a session may miss a launch), and the host's
    microseconds per call (issue only, and to the end of the work)."""
    import torch
    ev = device_events(screen, calls, ("screen_fused_kernel", 1))
    after = [e for e in ev if "screen_fused_kernel" not in e.name]
    names = {}
    for e in after:
        k = e.name.split("<")[0].split("(")[0].split("::")[-1].strip()[:40]
        names[k] = names.get(k, 0) + 1
    names = {k: round(v / calls, 1) for k, v in names.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        screen()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    ops, ops_after = len(ev) / calls, len(after) / calls
    dev_us = sum(e.device_time_total for e in ev) / calls
    after_us = sum(e.device_time_total for e in after) / calls
    print(f"[screen-step {tag}] device_ops_per_call={ops:.1f} after_scan="
          f"{ops_after:.1f} device_us_per_call={dev_us:.2f} after_scan_us="
          f"{after_us:.2f} host_us_per_call={host * 1e6:.1f} "
          f"wall_us_per_call={wall * 1e6:.1f} after_scan_ops={names}",
          flush=True)
    return {"device_ops": ops, "after_scan": ops_after, "device_us": dev_us,
            "after_scan_us": after_us, "host_us": host * 1e6,
            "wall_us": wall * 1e6}


def check_kernels(dtype, X, y, lam, h, ls_res, logit, logit_res, fused,
                  records):
    """Hold K1, K2, K3 and K3-pen against their plain versions at the
    solves' shapes; ``fused`` holds (loss, Xt, y, lam, result) of the
    fused solves."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    dt = getattr(torch, dtype)
    isz = torch.finfo(dt).bits // 8
    # scan: one length-n dot per column, summed in another order than the
    # plain matvec; burst: thousands of dependent steps, each rounding
    tol = {"float64": 1e-10, "float32": 1e-4}[dtype]
    tol3 = {"float64": 1e-9, "float32": 1e-3}[dtype]
    Xd, yd = X.to(dt), y.to(dt)
    n, p = Xd.shape
    g = torch.Generator(device="cpu").manual_seed(0)
    theta = (torch.randn(n, generator=g, dtype=torch.float64) / n).to(
        Xd.device, dt)
    col_norm = torch.linalg.vector_norm(Xd, dim=0)
    active = torch.zeros(p, dtype=torch.bool, device=Xd.device)
    active[ls_res.active_idx[ls_res.active_mask]] = True
    r = 0.05

    # K1 masked (the main path's mode) and unmasked
    k1 = ops.screen_fused(Xd, theta, col_norm, active, r, h=h)
    k1_ref = ops.screen_fused_ref(Xd, theta, col_norm, active, r, h=h)
    abs1, err1 = errs(zip((k1[0], k1[1], k1[2], k1[3], k1[5]),
                          (k1_ref[0], k1_ref[1], k1_ref[2], k1_ref[3],
                           k1_ref[5])))
    # candidate ids: equal wherever the plain scores are told apart; where
    # two plain scores tie within the tolerance, the sum order may swap them
    fin = torch.isfinite(k1_ref[3])
    ids_k, ids_p = k1[4][fin].long(), k1_ref[4][fin].long()
    swapped = ids_k != ids_p
    s_ref = k1_ref[0]
    scale1 = float(k1_ref[3][fin].abs().max())
    tie = ((s_ref[ids_k[swapped]] - s_ref[ids_p[swapped]]).abs()
           <= tol * scale1)
    ids_ok = bool(tie.all())
    n_swapped = int(swapped.sum())
    k1u = ops.screen_scores(Xd, theta, col_norm, r)
    k1u_ref = ops.screen_scores_ref(Xd, theta, col_norm, r)
    err1u = errs(zip(k1u, k1u_ref))[1]
    ms1, call1 = kernel_ms(lambda: ops.screen_fused(
        Xd, theta, col_norm, active, r, h=h), 20, "screen_fused_kernel")
    plain1 = time_ms(lambda: ops.screen_fused_ref(Xd, theta, col_norm,
                                                  active, r, h=h), 5)
    lib1 = time_ms(lambda: torch.abs(theta @ Xd), 20)
    ms1u = device_ms(lambda: ops.screen_scores(Xd, theta, col_norm, r), 20,
                     "screen_fused_kernel")
    plain1u = time_ms(lambda: ops.screen_scores_ref(Xd, theta, col_norm, r),
                      5)
    h_tile = min(h, 256)
    pb = -(-p // 256)
    b1, by1 = bound_ms(n * p * isz + n * isz + p * isz + p + 3 * p * isz
                       + pb * h_tile * (isz + 4) + pb * isz,
                       2 * n * p, dtype)
    print(f"[kernel screen_fused {dtype}] n={n} p={p} h={h} "
          f"max_abs_err={abs1:.3e} rel_err={err1:.3e} tol={tol:.0e} "
          f"ids_ok={ids_ok} "
          f"(ids differing at near-ties: {n_swapped} of {int(fin.sum())}) "
          f"unmasked_rel_err={err1u:.3e} ms={ms1:.4f} call_ms={call1:.4f} "
          f"unmasked_ms={ms1u:.4f}"
          f" plain_ms={plain1:.4f} unmasked_plain_ms={plain1u:.4f} "
          f"library_ms(abs(theta@X))={lib1:.4f} "
          f"bound_ms={b1:.4f} ({by1})", flush=True)
    if not (err1 <= tol and err1u <= tol and ids_ok):
        raise RuntimeError(f"screen_fused {dtype} disagrees with its plain "
                           f"version")
    if dtype == "float64":
        # K1 at [online-ls]'s padded shape (the scan reads every row, zero
        # or not), timed here: the profiler keeps launches early in a run
        n_cap, filled = stream_shape(n)
        Xp = torch.cat([Xd, Xd.new_zeros((n_cap - n, p))])
        thp = torch.cat([theta, theta.new_zeros(n_cap - n)])
        ms_cap, call_cap = kernel_ms(lambda: ops.screen_fused(
            Xp, thp, col_norm, active, r, h=h), 20, "screen_fused_kernel")
        del Xp
        bounds = [bound_ms(rows * p * isz + rows * isz + p * isz + p
                           + 3 * p * isz + pb * h_tile * (isz + 4)
                           + pb * isz, 2 * rows * p, dtype)[0]
                  for rows in (n_cap, filled)]
        WALLS["k1/n_cap"] = (ms_cap, call_cap, *bounds)
        print(f"[kernel screen_fused {dtype} n_cap] rows={n_cap} (of which "
              f"{filled} resident at [online-ls]'s end) p={p} h={h} "
              f"ms={ms_cap:.4f} call_ms={call_cap:.4f} bound_ms_at_n_cap="
              f"{bounds[0]:.4f} bound_ms_at_resident={bounds[1]:.4f} (bytes)",
              flush=True)

    # K2: the histogram entry at the screen's candidate count on the
    # scan's ub; the tail entry as the screen calls it, on the scan's
    # outputs and the merged tile winners; both bit for bit their twins
    ub, tmax = k1_ref[1], k1_ref[5]
    lb_sorted = torch.sort(k1_ref[2][torch.isfinite(k1_ref[2])][:h]).values
    hist = ops.ub_histogram(ub, lb_sorted)
    err2 = int((hist - ops.ub_histogram_ref(ub, lb_sorted)).abs().max())
    ms2h, call2h = kernel_ms(lambda: ops.ub_histogram(ub, lb_sorted), 50,
                             "screen_tail_kernel")
    vals, pos = torch.sort(k1_ref[3].reshape(-1), descending=True,
                           stable=True)
    targs = (ub, tmax, vals[:h], k1_ref[4].reshape(-1)[pos[:h]].long(),
             col_norm, torch.tensor(r, dtype=dt, device=Xd.device))
    same2 = same_bits(ops.screen_tail(*targs), ops.screen_tail_ref(*targs))
    ms2, call2 = kernel_ms(lambda: ops.screen_tail(*targs), 50,
                           "screen_tail_kernel")
    plain2 = time_ms(lambda: ops.screen_tail_ref(*targs), 5)
    hh = targs[2].shape[0]
    b2, by2 = bound_ms(p * isz + pb * isz + hh * (3 * isz + 8 + 4) + 2 * isz
                       + 4, p * hh.bit_length(), dtype)
    print(f"[kernel ub_histogram {dtype}] p={p} h={hh} tail: bitwise_twin="
          f"{same2} ms={ms2:.4f} call_ms={call2:.4f} plain_ms={plain2:.4f} "
          f"bound_ms={b2:.6f} ({by2}); histogram entry: max_abs_err={err2} "
          f"tol=0 ms={ms2h:.4f} call_ms={call2h:.4f}", flush=True)
    if err2 != 0 or not same2:
        raise RuntimeError(f"ub_histogram {dtype} disagrees")
    check_tail_edges(dtype, batch=False)
    if dtype == "float64":
        from repro_torch.core.screen_backend import make_screen_cuda
        sfn = make_screen_cuda(Xd, col_norm, h)
        screen_step("serial", lambda: sfn(theta, targs[5], active))

    # K3 on both losses, at each solve's final active block, from beta = 0,
    # one polish burst (the main path's longest)
    k3 = {}
    for loss_name, Xs, ys, lam_s, res in (
            ("least_squares", Xd, yd, lam, ls_res),
            ("logistic", logit[0].to(dt), logit[1].to(dt), logit[2],
             logit_res)):
        mask = res.active_mask
        k = mask.shape[0]
        A, AT, col_sq, order, count, beta0 = burst_inputs(
            Xs, res.active_idx, mask)
        n_ep = 40

        def run_k(AT=AT, ys=ys, col_sq=col_sq, mask=mask, order=order,
                  lam_s=lam_s, count=count, loss_name=loss_name,
                  beta0=beta0):
            return ops.cm_burst_xt(AT, ys, beta0, col_sq, mask, order, lam_s,
                                   n_ep, count, loss_name=loss_name)

        def run_p(A=A, ys=ys, col_sq=col_sq, mask=mask, order=order,
                  lam_s=lam_s, count=count, loss_name=loss_name,
                  beta0=beta0):
            return ops.cm_burst_ref(A, ys, beta0, col_sq, mask, order, lam_s,
                                    n_ep, count, loss_name=loss_name)

        out, ref = run_k(), run_p()
        abs3, err3 = burst_error(loss_name, out, ref, ys, lam_s)
        ms3, call3 = kernel_ms(run_k, 3, "cm_burst_kernel")
        plain3 = time_ms(run_p, 1)
        steps = n_ep * count
        flops = steps * 4 * Xs.shape[0] + 4 * Xs.shape[0] * k
        b3, by3 = bound_ms(k * Xs.shape[0] * isz + 3 * Xs.shape[0] * isz
                           + 3 * k * isz + 5 * k + isz, flops, dtype)
        print(f"[kernel cm_burst {dtype} {loss_name}] n={Xs.shape[0]} k={k} "
              f"count={count} n_epochs={n_ep} max_abs_err={abs3:.3e} "
              f"rel_err={err3:.3e} "
              f"tol={tol3:.0e} ms={ms3:.4f} call_ms={call3:.4f} us_per_step="
              f"{ms3 * 1e3 / steps:.4f} plain_ms={plain3:.4f} "
              f"bound_ms={b3:.6f} ({by3})", flush=True)
        if not err3 <= tol3:
            raise RuntimeError(f"cm_burst {dtype} {loss_name} disagrees")
        k3[loss_name] = (abs3, ms3, call3, plain3, b3, by3)

    # K3-pen at each fused solve's final block, pen from its slot map
    k3p = {}
    for loss_name, Xt, ys, lam_s, res in fused:
        Xs, ys = Xt.to(dt), ys.to(dt)
        mask = res.active_mask
        k = mask.shape[0]
        A, AT, col_sq, order, count, beta0 = burst_inputs(
            Xs, res.active_idx, mask)
        pen = torch.where(mask & (res.active_idx == Xs.shape[1] - 1), 0.0,
                          1.0).to(dt)
        n_ep = 40

        def run_k(AT=AT, ys=ys, col_sq=col_sq, mask=mask, order=order,
                  pen=pen, lam_s=lam_s, count=count, loss_name=loss_name,
                  beta0=beta0):
            return ops.cm_burst_pen_xt(AT, ys, beta0, col_sq, mask, order,
                                       pen, lam_s, n_ep, count,
                                       loss_name=loss_name)

        def run_p(A=A, ys=ys, col_sq=col_sq, mask=mask, order=order,
                  pen=pen, lam_s=lam_s, count=count, loss_name=loss_name,
                  beta0=beta0):
            return ops.cm_burst_ref(A, ys, beta0, col_sq, mask, order, lam_s,
                                    n_ep, count, pen, loss_name=loss_name)

        out, ref = run_k(), run_p()
        abs4, err4 = burst_error(loss_name, out, ref, ys, lam_s)
        ms4, call4 = kernel_ms(run_k, 3, "cm_burst_kernel")
        plain4 = time_ms(run_p, 1)
        n_s = Xs.shape[0]
        steps = n_ep * count
        # the sweep's steps, and the tail: fresh z, 4 x 2 polish dots for
        # logistic, 2 projection dots, the dual correlations
        flops = (steps * 4 * n_s + 4 * n_s * k
                 + (16 * n_s if loss_name == "logistic" else 0) + 4 * n_s)
        b4, by4 = bound_ms(k * n_s * isz + 3 * n_s * isz + 4 * k * isz
                           + 5 * k + isz, flops, dtype)
        print(f"[kernel cm_burst_pen {dtype} {loss_name}] n={n_s} k={k} "
              f"count={count} n_epochs={n_ep} max_abs_err={abs4:.3e} "
              f"rel_err={err4:.3e} tol={tol3:.0e} ms={ms4:.4f} "
              f"call_ms={call4:.4f} us_per_step={ms4 * 1e3 / steps:.4f} "
              f"plain_ms={plain4:.4f} bound_ms={b4:.6f} ({by4})",
              flush=True)
        if not err4 <= tol3:
            raise RuntimeError(f"cm_burst_pen {dtype} {loss_name} "
                               f"disagrees")
        k3p[loss_name] = (abs4, ms4, call4, plain4, b4, by4)

    if dtype == "float64":
        e3, m3, c3, pl3, bb3, bby3 = k3["least_squares"]
        records["screen_fused"].update(
            max_abs_err=abs1, ms=ms1, call_ms=call1, plain_ms=plain1,
            bound_ms=b1, bound_by=by1, library_ms=lib1)
        records["ub_histogram"].update(
            max_abs_err=err2, ms=ms2, call_ms=call2, plain_ms=plain2,
            bound_ms=b2, bound_by=by2, library_ms=None)
        records["cm_burst"].update(
            max_abs_err=max(e3, k3["logistic"][0]), ms=m3, call_ms=c3,
            plain_ms=pl3, bound_ms=bb3, bound_by=bby3, library_ms=None)
        e4, m4, c4, pl4, bb4, bby4 = k3p["least_squares"]
        records["cm_burst_pen"].update(
            max_abs_err=max(e4, k3p["logistic"][0]), ms=m4, call_ms=c4,
            plain_ms=pl4, bound_ms=bb4, bound_by=bby4, library_ms=None)


def transform_phase(X, records):
    """Phase 4: ``prepare_fused`` on a chain at full width launches K4 once;
    K4 equals its plain version bit for bit in float64 and float32, at full
    width and at the edge shapes (NaN where the twin has NaN); times
    against the bound, the latency floor and the cumsum yardstick."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused.fused import add_latency_cycles

    n, p = X.shape
    parent = np.arange(p) - 1
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    design = rt.prepare_fused(X, parent)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()         # the host part, timed once more alone
    rt.build_schedule(rt.build_tree(parent))
    host = time.perf_counter() - t0
    print(f"[fused-transform] n={n} p={p} float64 prepare_fused "
          f"wall_s={wall:.3f} (build_tree + build_schedule on the host "
          f"alone: {host:.3f} s) launches={counts}", flush=True)
    check_launches("fused-transform", counts,
                   {k: (1 if k == "chain_suffix_sums" else False)
                    for k in counts})
    launches = counts["chain_suffix_sums"]

    def bits(t):
        return t.view(torch.int64 if t.dtype == torch.float64
                      else torch.int32)

    def yardstick(A):
        return torch.flip(torch.cumsum(torch.flip(A, [1]), 1), [1])

    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    rec = None
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        # the edge shapes: 13 rows (a CTA of 8 and one of 5), every tile
        # case, signed zeros and NaN in the first and last columns, and a
        # view whose rows start off a 16-byte boundary (element copies)
        edges = [chain_edge_input(13, q, dt, seed=q).to(X.device)
                 for q in CHAIN_EDGE_P]
        off = torch.empty(13 * 1000 + 1, dtype=dt, device=X.device)
        edges.append(off[1:].view(13, 1000).copy_(
            chain_edge_input(13, 1000, dt, seed=1)))
        edge_ok = all(same_bits([ops.chain_suffix_sums(E)],
                                [ops.chain_suffix_sums_ref(E)])
                      for E in edges)
        del edges, off
        Xd = X.to(dt)
        S = ops.chain_suffix_sums(Xd)
        S_ref = ops.chain_suffix_sums_ref(Xd)
        torch.cuda.synchronize()
        same = bool(torch.equal(bits(S), bits(S_ref)))
        if dtype == "float64":
            same = same and bool(torch.equal(
                bits(design.Xt), bits(torch.cat([S_ref[:, 1:],
                                                 S_ref[:, :1]], 1))))
            del design
        err = float((S - S_ref).abs().max())
        ycut = float((yardstick(Xd) - S_ref).abs().max())
        del S, S_ref
        ms, call = kernel_ms(lambda: ops.chain_suffix_sums(Xd), 10,
                             "chain_suffix_kernel")
        plain = time_ms(lambda: ops.chain_suffix_sums_ref(Xd), 1)
        lib = time_ms(lambda: yardstick(Xd), 10)
        isz = Xd.element_size()
        bnd, by = bound_ms(2 * n * p * isz, n * (p - 1), dtype)
        cyc = add_latency_cycles(dt)
        floor = (p - 1) * cyc / (clock * 1e6) * 1e3
        print(f"[kernel chain_suffix_sums {dtype}] n={n} p={p} "
              f"bitwise_equal={same} edge_shapes_bitwise={edge_ok} "
              f"(n=13, p={','.join(map(str, CHAIN_EDGE_P))} and an "
              f"unaligned view; NaN where the twin has NaN) "
              f"max_abs_err={err:.3e} tol=0 (bits) "
              f"ms={ms:.4f} call_ms={call:.4f} plain_ms={plain:.4f} "
              f"library_ms(flip-cumsum-flip)={lib:.4f} "
              f"library_max_abs_dev={ycut:.3e} bound_ms={bnd:.4f} ({by}) "
              f"add_latency_cycles={cyc:.2f} max_sm_clock_mhz={clock:.0f} "
              f"latency_floor_ms={floor:.4f}", flush=True)
        if not (same and edge_ok):
            raise RuntimeError(f"chain_suffix_sums {dtype} is not bitwise "
                               f"its plain version")
        if rec is None:
            rec = dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                       bound_ms=bnd, bound_by=by, library_ms=lib,
                       latency_floor_ms=floor, add_latency_cycles=cyc)
        else:
            rec[dtype] = dict(ms=ms, call_ms=call, plain_ms=plain,
                              bound_ms=bnd, bound_by=by, library_ms=lib,
                              latency_floor_ms=floor,
                              add_latency_cycles=cyc)
        del Xd
    records["chain_suffix_sums"].update(rec)
    return launches


def fused_phases():
    """Phases 5-7: fused least squares and logistic at FUSED_P, and the
    fused path. Returns the kernel-path results, the problems, the summed
    launch counts and the least-squares problem with its ``auto`` result
    and path (for ``[session-fused]``)."""
    import numpy as np
    import torch
    import repro_torch as rt

    dev = torch.device("cuda")
    p = FUSED_P
    parent = np.arange(p) - 1
    pen = torch.ones(p, dtype=torch.float64, device=dev)
    pen[p - 1] = 0.0
    Xn, yn = fused_chain_data(N, p)
    X = torch.from_numpy(Xn).to(dev)
    Xt = rt.prepare_fused(X, parent).Xt
    # logistic: K3-pen; least squares: the Gram sweep K6 with its pen
    on_logit = {"screen_fused": True, "ub_histogram": True,
                "cm_burst": False, "cm_burst_pen": True,
                "chain_suffix_sums": 1, "screen_fused_batch": False,
                "ub_histogram_batch": False, "cm_burst_batch": False,
                "cm_epochs": False, "gram_sweep": False,
                "gram_sweep_batch": False, "screen_fused_mixed": False,
                "screen_fused_batch_mixed": False}
    on_ls = {**on_logit, "cm_burst_pen": False, "gram_sweep": True}
    off = {k: False for k in on_ls}
    out, launches, fused = {}, [], []
    for loss_name, frac, logistic in (("least_squares", FUSED_LS_LAM, False),
                                      ("logistic", FUSED_LOGIT_LAM, True)):
        on = on_ls if loss_name == "least_squares" else on_logit
        y = torch.from_numpy(fused_chain_data(N, p, logistic=logistic)[1]
                             ).to(dev)
        loss = rt.get_loss(loss_name)
        lam = frac * rt.fused_lambda_max(X, y, parent, loss=loss_name)
        cfg = rt.SaifConfig(eps=1e-6, loss=loss_name)
        res, counts = solve_phase(
            f"fused-{loss_name}", lam, cfg,
            {"auto": {},
             "plain": {"screen_backend": "torch", "inner_backend": "torch"}},
            {"auto": on, "plain": off},
            lambda c, y=y, lam=lam: rt.saif_fused(   # profiled later
                X, y, parent, lam, c, transform_backend=(
                    "torch" if c.inner_backend == "torch" else "auto"))[1],
            lambda r: rt.kkt_residual(loss, Xt, y, r.beta, lam, pen),
            profiled=("auto",) if loss_name == "least_squares" else ())
        launches.append(counts["auto"])
        fused.append((loss_name, Xt, y, lam, res["auto"]))
        out[loss_name] = (y, lam)

    # the path, on the least-squares problem
    y, _ = out["least_squares"]
    loss = rt.get_loss("least_squares")
    lm = rt.fused_lambda_max(X, y, parent)
    hi, lo, m = FUSED_PATH
    lams = np.geomspace(hi * lm, lo * lm, m)
    cfg = rt.SaifConfig(eps=1e-6)
    torch.cuda.synchronize()
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fp = rt.fused_path(X, y, parent, lams, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    sizes = []
    for lam, r in zip(fp.lams, fp.path.results):
        kkt = float(rt.kkt_residual(loss, Xt, y, r.beta, lam, pen))
        sizes.append(len(support(r.beta)))
        print(f"[fused-path] lam/lam_max={lam / lm:.4f} outer={r.n_outer} "
              f"n_active={r.n_active} support={sizes[-1]} "
              f"gap={float(r.gap):.3e} kkt={kkt:.3e} "
              f"kkt_limit={1e-3 * lam:.3e}", flush=True)
        if not (float(r.gap) <= cfg.eps and kkt <= 1e-3 * lam):
            raise RuntimeError("fused-path: a point is not certified")
    print(f"[fused-path] {m} lambdas wall_s={wall:.3f} launches={counts}",
          flush=True)
    check_launches("fused-path", counts, on_ls)
    if sizes != sorted(sizes):
        raise RuntimeError(f"fused-path: supports shrink down the path: "
                           f"{sizes}")
    launches.append(counts)
    fused_ls = {"X": X, "y": y, "parent": parent, "lam": fused[0][3],
                "res": fused[0][4], "path_lams": lams, "path": fp}
    return fused, launches, fused_ls


def fleet_responses(X, b, seed, logistic=False, k=15):
    """B responses over the design X on the card: per response (its own
    seed) k true features, in [-1, 1] with N(0, 1) noise
    (bench_batch.py's ``_fleet_problem``), or, for ``logistic``, in
    [-2, 2] with labels sign(X w + 0.3 noise) (phase 3's protocol)."""
    import numpy as np
    import torch
    n, p = X.shape
    ys = []
    for i in range(b):
        rng = np.random.default_rng(seed + i)
        w = np.zeros(p)
        lo = 2.0 if logistic else 1.0
        w[rng.choice(p, k, replace=False)] = rng.uniform(-lo, lo, k)
        noise = rng.normal(0, 1, n) * (0.3 if logistic else 1.0)
        y = X @ torch.from_numpy(w).to(X.device) + torch.from_numpy(
            noise).to(X.device)
        if logistic:
            y = torch.where(y >= 0, 1.0, -1.0).to(X.dtype)
        ys.append(y)
    return torch.stack(ys)


def fleet_phase(name, X, Y, fracs, loss_name, serial_expect, fleet_expect,
                **over):
    """Solve the fleet under ``auto`` (or the config overrides ``over``;
    counted) and certify each problem; solve each problem serially with
    the same config (uncounted) and hold the fleet's row against it bit
    for bit; print the walls and profile the fleet. Returns (result,
    lams, launch counts, the fleet's h, its wall)."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    loss = rt.get_loss(loss_name)
    lms = [float(rt.lambda_max(loss, X, y)) for y in Y]
    lams = [f * lm for f, lm in zip(fracs, lms)]
    cfg = rt.SaifConfig(eps=1e-6, loss=loss_name, **over)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = rt.fleet_solve(X, Y, lams, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[{name}] B={Y.shape[0]} n={X.shape[0]} p={X.shape[1]} "
          f"k_max={res.active_idx.shape[1]} wall_s={wall:.3f} "
          f"launches={counts}", flush=True)
    check_launches(name, counts, fleet_expect)
    walls, bad = [], []
    for i, lam in enumerate(lams):
        kkt = float(rt.kkt_residual(loss, X, Y[i], res.beta[i], lam))
        gap = float(res.gap[i])
        t0 = time.perf_counter()
        s = rt.saif(X, Y[i], lam, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        same = (torch.equal(res.beta[i], s.beta)
                and torch.equal(res.gap[i], s.gap)
                and int(res.n_outer[i]) == s.n_outer
                and int(res.n_active[i]) == s.n_active
                and bool(res.overflowed[i]) == s.overflowed
                and all(torch.equal(getattr(res, f)[i], getattr(s, f))
                        for f in ("trace_gap", "trace_dual",
                                  "trace_n_active", "trace_screened",
                                  "trace_survivors", "trace_post_viol")))
        print(f"[{name}/{i}] lam/lam_max={fracs[i]:.4f} "
              f"outer={int(res.n_outer[i])} n_active={int(res.n_active[i])} "
              f"support={len(support(res.beta[i]))} gap={gap:.3e} "
              f"kkt={kkt:.3e} kkt_limit={1e-3 * lam:.3e} "
              f"serial_k_max={s.active_idx.shape[0]} serial_wall_s="
              f"{walls[-1]:.3f} bitwise_serial={same}", flush=True)
        if not (gap <= cfg.eps and kkt <= 1e-3 * lam and same):
            bad.append(i)
    # the serial solves' own kernels (uncounted above)
    ops.reset_launch_counts()
    rt.saif(X, Y[0], lams[0], cfg)
    check_launches(f"{name}/serial", ops.launch_counts(), serial_expect)
    WALLS[f"{name}/serial_sum"] = sum(walls)
    print(f"[{name}] fleet_wall_s={wall:.3f} serial_walls_sum_s="
          f"{sum(walls):.3f} outer_per_problem="
          f"{res.n_outer.tolist()}", flush=True)
    if bad:
        raise RuntimeError(f"{name}: problems {bad} not certified or not "
                           f"bitwise their serial solves")
    DEFERRED_PROFILES.append(
        (name, lambda: rt.fleet_solve(X, Y, lams, cfg), wall))
    from repro_torch.core.batch import fleet_batch_sizes, prepare_fleet
    _, h = fleet_batch_sizes(prepare_fleet(X, Y, cfg), lams, cfg)
    return res, lams, counts, h, wall


def fast_fleet_phase(X, Y, lams, screen_dtype, bit, bit_wall, expect):
    """``[fleet-fast/<screen_dtype>]``: the LS fleet of ``[fleet-ls]``
    under ``parity="fast"`` (counted): every row certified (gap <= eps,
    KKT <= 1e-3 lambda over all p) with the support of the bitwise fleet's
    row (``bit``); its wall against the bitwise fleet's, outer steps,
    launches, escalated rows and host reads per outer step; profiled
    later. Returns (result, launch counts, stats)."""
    import torch
    import repro_torch as rt
    from repro_torch.core.batch_fast import solve_fleet_fast
    from repro_torch.kernels import ops

    name = f"fleet-fast/{screen_dtype}"
    ls = rt.get_loss("least_squares")
    cfg = rt.SaifConfig(eps=1e-6, parity="fast", screen_dtype=screen_dtype)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = rt.fleet_solve(X, Y, lams, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = dict(solve_fleet_fast.stats)
    bad, worst_kkt = [], 0.0
    for i, lam in enumerate(lams):
        kkt = float(rt.kkt_residual(ls, X, Y[i], res.beta[i], lam))
        worst_kkt = max(worst_kkt, kkt / lam)
        if not (float(res.gap[i]) <= cfg.eps and kkt <= 1e-3 * lam
                and support(res.beta[i]) == support(bit.beta[i])):
            bad.append(i)
    print(f"[{name}] B={Y.shape[0]} k_max={res.active_idx.shape[1]} "
          f"wall_s={wall:.4f} bitwise_fleet_wall_s={bit_wall:.4f} "
          f"bitwise_over_fast={bit_wall / wall:.2f} outer_per_problem="
          f"{res.n_outer.tolist()} outer_steps={st['steps']} host_reads="
          f"{st['host_reads']} host_reads_per_step="
          f"{st['host_reads'] / max(st['steps'], 1):.2f} screens="
          f"{st['screens']} rows_screened={st['rows_screened']} "
          f"escalated_rows={st['escalated_rows']} max_gap="
          f"{float(res.gap.max()):.3e} max_kkt_over_lam={worst_kkt:.3e} "
          f"supports_of_bitwise_fleet={not bad} launches={counts}",
          flush=True)
    check_launches(name, counts, expect)
    if bad:
        raise RuntimeError(f"{name}: rows {bad} not certified or off the "
                           f"bitwise fleet's support")
    DEFERRED_PROFILES.append(
        (name, lambda: rt.fleet_solve(X, Y, lams, cfg), wall,
         ("screen_fused_kernel", "screen_tc_kernel", "screen_tail_kernel",
          "gram_sweep_kernel")))
    return res, counts, st


def results_equal(a, b, p=None):
    """Two SaifResults bit for bit: every tensor field (the inner carry's
    too), count and flag; ``beta`` cut to its first ``p`` columns."""
    import torch
    for f, x, y in zip(a._fields, a, b):
        if f == "beta" and p is not None:
            x = x[..., :p]
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif isinstance(x, tuple):
            if not all(torch.equal(u, v) for u, v in zip(x, y)):
                return False
        elif x != y:
            return False
    return True


def timed(fn):
    """(fn(), host seconds up to a synchronize)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def session_ls_phase(X, y, lm, ls_auto, Yf, fl_lams, fl_res, fl_wall,
                     serial_expect, fleet_expect):
    """``[session-ls]``: ``open_session(Problem(X, y), SaifConfig(eps=
    1e-6))`` on phase 2's design (admission, prep and open times), then
    the request mix twice: Scalar(0.3), a second cold Scalar in its h
    bucket, Scalar(0.3, warm=True), a 4-point Path 0.6 -> 0.3, phase 9's
    Fleet, a 5-fold CV over 6 lambdas 0.9 -> 0.3 (refit=False). Every
    request certified on the card and counted (K1/K2/K6 for the serial
    ones, K1b/K2b/K6b for Fleet and CV); every cold request bit for bit
    its direct call (phases 2 and 9's results where they match), and in
    the second pass bit for bit its first; the preparation counted (one,
    at open); each request's hot wall beside its direct call's; one hot
    Scalar profiled later. Returns (the session, launch counts, and the
    first pass: the requests, their results, walls and launch counts)."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.core.saif import add_batch_size_static
    from repro_torch.kernels import ops

    ls = rt.get_loss("least_squares")
    n, p = X.shape
    cfg = rt.SaifConfig(eps=1e-6)
    lam = LS_LAM * lm
    prep = rt.prepare_path(X, y, cfg)

    def h_of(l):
        return add_batch_size_static(cfg.c, l, prep.c0_max, prep.c0_median,
                                     p)
    lam2 = next(f * lm for f in (0.29, 0.31, 0.28, 0.32, 0.27)
                if h_of(f * lm) == h_of(lam))
    del prep
    path_lams = np.geomspace(0.6 * lm, LS_LAM * lm, 4).tolist()
    cv_lams = np.geomspace(0.9 * lm, LS_LAM * lm, 6).tolist()
    W = rt.kfold_weights(n, CV_FOLDS).to(X)

    saif_mod = sys.modules["repro_torch.core.saif"]
    real_prepare = saif_mod.prepare_path
    prepares = []

    def counted(*a, **k):
        prepares.append(1)
        return real_prepare(*a, **k)
    saif_mod.prepare_path = counted
    try:
        prob, t_adm = timed(lambda: rt.Problem(X=X, y=y))
        sess, t_prep = timed(lambda: rt.open_session(prob, cfg))
    finally:
        saif_mod.prepare_path = real_prepare
    print(f"[session-ls] open n={n} p={p}: admission_s={t_adm:.4f} "
          f"prep_s={t_prep:.4f} open_s={t_adm + t_prep:.4f} "
          f"prepare_path_calls={len(prepares)}", flush=True)
    if len(prepares) != 1:
        raise RuntimeError("session-ls: open_session did not prepare once")

    reqs = [("scalar", rt.Scalar(lam), serial_expect),
            ("scalar2", rt.Scalar(lam2), serial_expect),
            ("scalar/warm", rt.Scalar(lam, warm=True), serial_expect),
            ("path", rt.Path(tuple(path_lams)), serial_expect),
            ("fleet", rt.Fleet(Y=Yf, lams=fl_lams), fleet_expect),
            ("cv", rt.CV(n_folds=CV_FOLDS, lams=tuple(cv_lams),
                         keep_fold_betas=True, refit=False), fleet_expect)]

    def certify(name, res):
        """Worst (gap, KKT / lambda) of a request's result; raises when
        one is not certified."""
        cells = []
        if name.startswith("scalar"):
            cells = [(y, None, res, lam2 if name == "scalar2" else lam)]
        elif name == "path":
            cells = [(y, None, r, l) for r, l in zip(res.results, res.lams)]
        elif name == "fleet":
            cells = [(Yf[i], None, res, fl_lams[i], i)
                     for i in range(Yf.shape[0])]
        else:
            cells = [(y, W[k], fr, l, k) for l, fr in
                     zip(res.lams, res.fold_results)
                     for k in range(CV_FOLDS)]
        worst_gap = worst_kkt = 0.0
        for cell in cells:
            yy, w, r, l = cell[:4]
            beta, gap = r.beta, r.gap
            if len(cell) == 5:
                beta, gap = r.beta[cell[4]], r.gap[cell[4]]
            kkt = float(rt.kkt_residual(ls, X, yy, beta, float(l),
                                        sample_w=w))
            gap = float(gap)
            worst_gap = max(worst_gap, gap)
            worst_kkt = max(worst_kkt, kkt / float(l))
            if not (gap <= cfg.eps and kkt <= 1e-3 * float(l)):
                raise RuntimeError(f"session-ls/{name}: not certified "
                                   f"(gap {gap:.3e}, kkt {kkt:.3e})")
        return worst_gap, worst_kkt

    def same(name, a, b):
        if name == "path":
            return all(results_equal(u, v)
                       for u, v in zip(a.results, b.results))
        if name == "cv":
            return (np.array_equal(a.cv_mean, b.cv_mean)
                    and np.array_equal(a.cv_se, b.cv_se)
                    and a.best_lam == b.best_lam
                    and all(torch.equal(u, v)
                            for u, v in zip(a.fold_betas, b.fold_betas)))
        return results_equal(a, b)

    # the direct calls: phases 2 and 9's results where they match
    direct = {"scalar": (ls_auto, WALLS["ls/auto"]),
              "fleet": (fl_res, fl_wall)}
    direct["scalar2"] = timed(lambda: rt.saif(X, y, lam2, cfg))
    direct["path"] = timed(lambda: rt.run_path(rt.prepare_path(X, y, cfg),
                                               path_lams, cfg)[0])
    direct["cv"] = timed(lambda: rt.cv_solve(
        X, y, cv_lams, CV_FOLDS, cfg, keep_fold_betas=True, refit=False))

    total = {k: 0 for k in ops.KERNELS}
    first, walls, hot, first_counts = {}, {}, {}, {}
    saif_mod.prepare_path = counted
    try:
        for rnd in (1, 2):
            for name, req, expect in reqs:
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                res, wall = timed(lambda: sess.solve(req))
                counts = ops.launch_counts()
                check_launches(f"session-ls/{name}", counts, expect)
                for k in total:
                    total[k] += counts[k]
                gap, kkt = certify(name, res)
                cold = name in direct
                if rnd == 1:
                    first[name], walls[name] = res, wall
                    first_counts[name] = counts
                    ok = same(name, res, direct[name][0]) if cold else None
                    line = (f"bitwise_direct={ok} direct_wall_s="
                            f"{direct[name][1]:.4f}" if cold else
                            "warm (no direct call)")
                else:
                    hot[name] = wall
                    ok = same(name, res, first[name]) if cold else None
                    line = (f"bitwise_first_pass={ok} first_wall_s="
                            f"{walls[name]:.4f} direct_wall_s="
                            f"{direct[name][1]:.4f}" if cold else
                            f"first_wall_s={walls[name]:.4f}")
                outer = (res.n_outer if name.startswith("scalar") else
                         [r.n_outer for r in res.results] if name == "path"
                         else res.n_outer.tolist() if name == "fleet" else
                         [fr.n_outer.tolist() for fr in res.fold_results])
                print(f"[session-ls/{name}] pass={rnd} wall_s={wall:.4f} "
                      f"{line} outer={outer} max_gap={gap:.3e} "
                      f"max_kkt_over_lam={kkt:.3e} launches={counts}",
                      flush=True)
                if ok is False:
                    raise RuntimeError(f"session-ls/{name}: pass {rnd} not "
                                       f"bit for bit its reference")
    finally:
        saif_mod.prepare_path = real_prepare
    session_prepares = len(prepares)
    print(f"[session-ls] requests={sess.compile_stats().requests} "
          f"prepare_path_in_session_life={session_prepares} "
          f"hot_scalar_wall_s={hot['scalar']:.4f} direct_saif_wall_s="
          f"{WALLS['ls/auto']:.4f} hot_over_direct="
          f"{hot['scalar'] / WALLS['ls/auto']:.3f}", flush=True)
    if session_prepares != 1:
        raise RuntimeError(f"session-ls: prepare_path ran "
                           f"{session_prepares} times in the session")
    _, hot = timed(lambda: sess.solve(rt.Scalar(lam)))
    DEFERRED_PROFILES.append(
        ("session-ls/scalar", lambda: sess.solve(rt.Scalar(lam)), hot,
         ("screen_fused_kernel", "screen_tail_kernel", "gram_sweep_kernel")))
    return sess, total, (reqs, first, walls, first_counts)


def session_pad_phase(X, y, lm, ls_auto, Yf, fl_lams, fl_res,
                      serial_expect, fleet_expect):
    """``[session-pad]``: ``pad_to=(1000, 131072)``: a Scalar at 0.3
    lambda_max and phase 9's Fleet, each bit for bit its unpadded
    counterpart (phase 2's ``auto`` solve, phase 9's fleet);
    ``pad_to=(1024, 131072)``: a Scalar with phase 2's support, beta
    within rtol 1e-10 / atol 1e-12 of it, certified. Returns the launch
    counts."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    ls = rt.get_loss("least_squares")
    n, p = X.shape
    cfg = rt.SaifConfig(eps=1e-6)
    lam = LS_LAM * lm
    prob = rt.Problem(X=X, y=y)
    total = {k: 0 for k in ops.KERNELS}
    for bucket in ((n, 131072), (1024, 131072)):
        sess, t_open = timed(lambda: rt.open_session(prob, cfg,
                                                     pad_to=bucket))
        ops.reset_launch_counts()
        res, wall = timed(lambda: sess.solve(rt.Scalar(lam)))
        counts = ops.launch_counts()
        check_launches(f"session-pad{bucket}/scalar", counts, serial_expect)
        for k in total:
            total[k] += counts[k]
        kkt = float(rt.kkt_residual(ls, X, y, res.beta, lam))
        live_ok = bool((res.active_idx[res.active_mask] < p).all())
        cert = float(res.gap) <= cfg.eps and kkt <= 1e-3 * lam
        if bucket[0] == n:
            ok = results_equal(res, ls_auto)
            line = f"bitwise_unpadded={ok}"
        else:
            close = torch.allclose(res.beta, ls_auto.beta, rtol=1e-10,
                                   atol=1e-12)
            ok = support(res.beta) == support(ls_auto.beta) and close
            err = float((res.beta - ls_auto.beta).abs().max())
            line = (f"same_support={support(res.beta) == support(ls_auto.beta)}"
                    f" allclose_1e-10={close} max_abs_diff={err:.3e}")
        print(f"[session-pad] pad_to={bucket} open_s={t_open:.4f} scalar "
              f"wall_s={wall:.4f} unpadded_wall_s={WALLS['ls/auto']:.4f} "
              f"outer={res.n_outer} unpadded_outer={ls_auto.n_outer} "
              f"gap={float(res.gap):.3e} kkt={kkt:.3e} {line} "
              f"no_pad_in_slots={live_ok} launches={counts}", flush=True)
        if not (ok and cert and live_ok):
            raise RuntimeError(f"session-pad {bucket}: scalar not "
                               f"certified or off its unpadded solve")
        if bucket[0] == n:
            ops.reset_launch_counts()
            fl, wall = timed(lambda: sess.solve(rt.Fleet(Y=Yf,
                                                         lams=fl_lams)))
            counts = COUNTS["session-pad/fleet"] = ops.launch_counts()
            check_launches("session-pad/fleet", counts, fleet_expect)
            for k in total:
                total[k] += counts[k]
            ok = results_equal(fl, fl_res)
            worst = max(float(rt.kkt_residual(ls, X, Yf[i], fl.beta[i],
                                              fl_lams[i])) / fl_lams[i]
                        for i in range(Yf.shape[0]))
            cert = bool((fl.gap <= cfg.eps).all()) and worst <= 1e-3
            print(f"[session-pad] pad_to={bucket} fleet B={Yf.shape[0]} "
                  f"wall_s={wall:.4f} bitwise_unpadded={ok} max_gap="
                  f"{float(fl.gap.max()):.3e} max_kkt_over_lam={worst:.3e} "
                  f"launches={counts}", flush=True)
            if not (ok and cert):
                raise RuntimeError("session-pad: fleet not certified or "
                                   "off its unpadded fleet")
        del sess
        torch.cuda.empty_cache()
    return total


def session_cache_phase(X, y, lm, ls_auto, serial_expect):
    """``[session-cache]``: a session with a ``WarmCache``: Scalar(0.5)
    misses, Scalar(0.3) hits (entering by the Theorem-2 seed from the 0.5
    solution); the hit certified, with phase 2's cold support, its outer
    steps against the cold solve's; the digest's cost, ``cache.stats()``
    and ``drain_events()``. Returns the launch counts."""
    import torch
    import repro_torch as rt
    from repro_torch.core.warm_cache import problem_digest
    from repro_torch.kernels import ops

    ls = rt.get_loss("least_squares")
    cfg = rt.SaifConfig(eps=1e-6)
    lam = LS_LAM * lm
    cache = rt.WarmCache(rt.WarmCacheConfig())
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg, warm_cache=cache)
    digest, t_dig = timed(lambda: problem_digest(X, y))
    total = {k: 0 for k in ops.KERNELS}
    out = {}
    for frac in (0.5, LS_LAM):
        ops.reset_launch_counts()
        res, wall = timed(lambda: sess.solve(rt.Scalar(frac * lm)))
        counts = ops.launch_counts()
        check_launches(f"session-cache/{frac}", counts, serial_expect)
        for k in total:
            total[k] += counts[k]
        events = sess.drain_events()
        kkt = float(rt.kkt_residual(ls, X, y, res.beta, frac * lm))
        cert = float(res.gap) <= cfg.eps and kkt <= 1e-3 * frac * lm
        out[frac] = (res, events, cert)
        print(f"[session-cache] lam/lam_max={frac} wall_s={wall:.4f} "
              f"events={list(events)} outer={res.n_outer} n_active="
              f"{res.n_active} k_max={res.active_idx.shape[0]} gap="
              f"{float(res.gap):.3e} kkt={kkt:.3e} certified={cert} "
              f"launches={counts}", flush=True)
    hit, events, cert = out[LS_LAM]
    miss_ok = out[0.5][1] == ("warm_cache_miss",)
    hit_ok = len(events) == 1 and events[0].startswith("warm_cache_hit")
    same_sup = support(hit.beta) == support(ls_auto.beta)
    st = cache.stats()
    print(f"[session-cache] hit_outer={hit.n_outer} cold_outer="
          f"{ls_auto.n_outer} hit_over_cold={hit.n_outer / ls_auto.n_outer:.3f}"
          f" cold_support={same_sup} digest_s={t_dig:.4f} "
          f"digest_memo_equal={sess._digest_memo == digest} stats={st._asdict()}",
          flush=True)
    if not (miss_ok and hit_ok and cert and same_sup and st.hits == 1
            and st.misses == 1):
        raise RuntimeError("session-cache: the hit did not certify with the "
                           "cold support, or the cache did not hit")
    return total


def session_fused_phase(fused_ls):
    """``[session-fused]``: phase 5's chain problem through
    ``Problem(penalty=fused(parent))``: K4 launches exactly once, at
    open, and never again; a Scalar and phase 7's 4-point Path bit for bit
    ``saif_fused`` / ``fused_path`` (phases 5 and 7). Returns the launch
    counts (open included)."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    X, y, parent = fused_ls["X"], fused_ls["y"], fused_ls["parent"]
    cfg = rt.SaifConfig(eps=1e-6)
    ops.reset_launch_counts()
    sess, t_open = timed(lambda: rt.open_session(
        rt.Problem(X=X, y=y, penalty=rt.fused(parent)), cfg))
    open_counts = ops.launch_counts()
    ops.reset_launch_counts()
    (beta, res), wall = timed(lambda: sess.solve(rt.Scalar(fused_ls["lam"])))
    pr, wall_p = timed(lambda: sess.solve(rt.Path(tuple(
        fused_ls["path_lams"]))))
    counts = ops.launch_counts()
    check_launches("session-fused/open", open_counts,
                   {"chain_suffix_sums": 1, "screen_fused": 0,
                    "gram_sweep": 0})
    check_launches("session-fused", counts,
                   {"screen_fused": True, "ub_histogram": True,
                    "gram_sweep": True, "chain_suffix_sums": 0,
                    "cm_burst": False, "cm_burst_pen": False,
                    "screen_fused_batch": False, "gram_sweep_batch": False})
    ok_s = results_equal(res, fused_ls["res"])
    fp = fused_ls["path"]
    ok_p = (all(results_equal(a, b) for a, b in
                zip(pr.path.results, fp.path.results))
            and all(torch.equal(a, b) for a, b in zip(pr.betas, fp.betas)))
    print(f"[session-fused] p={X.shape[1]} open_s={t_open:.4f} open_launches="
          f"{open_counts['chain_suffix_sums']} (K4) scalar_wall_s={wall:.4f}"
          f" path_wall_s={wall_p:.4f} bitwise_saif_fused={ok_s} "
          f"bitwise_fused_path={ok_p} outer={res.n_outer} "
          f"launches={counts}", flush=True)
    if not (ok_s and ok_p):
        raise RuntimeError("session-fused: not bit for bit saif_fused / "
                           "fused_path")
    return {k: open_counts[k] + counts[k] for k in counts}



def check_no_breaker(tag, srv, verdicts):
    """A non-drill phase must not open the circuit breaker: the plain path
    on the card is never a silent fallback."""
    opened = [e for v in verdicts for e in v.events
              if e.startswith("breaker_open")]
    if srv.stats().breaker_open or srv.breaker_open or opened:
        raise RuntimeError(f"{tag}: the circuit breaker opened ({opened})")


def serving_ls_phase(X, y, first_pass, serial_expect, fleet_expect):
    """``[serving-ls]``: phase 20's request mix once through
    ``open_serving`` on phase 2's problem: every verdict ok, not degraded,
    no retry, the breaker closed; each value bit for bit the plain
    session's first pass; each request's launches equal to that pass's
    (K1/K2/K6 serial, K1b/K2b/K6b for Fleet and CV); each request's
    ``kkt_check_ms`` beside its wall. Returns the launch counts."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    reqs, first, walls, first_counts = first_pass
    cfg = rt.SaifConfig(eps=1e-6)
    srv, t_open = timed(lambda: rt.open_serving(rt.Problem(X=X, y=y), cfg))
    print(f"[serving-ls] open_s={t_open:.4f}", flush=True)
    total = {k: 0 for k in ops.KERNELS}
    verdicts = []
    for name, req, expect in reqs:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out, wall = timed(lambda: srv.solve(req))
        counts = ops.launch_counts()
        check_launches(f"serving-ls/{name}", counts, expect)
        for k in total:
            total[k] += counts[k]
        v = out.verdict
        verdicts.append(v)
        if name == "path":
            same = all(results_equal(u, w) for u, w in
                       zip(out.value.results, first[name].results))
        elif name == "cv":
            a, b = out.value, first[name]
            same = (np.array_equal(a.cv_mean, b.cv_mean)
                    and a.best_lam == b.best_lam
                    and all(torch.equal(u, w)
                            for u, w in zip(a.fold_betas, b.fold_betas)))
        else:
            same = results_equal(out.value, first[name])
        print(f"[serving-ls/{name}] wall_s={wall:.4f} session_wall_s="
              f"{walls[name]:.4f} kkt_check_ms={v.kkt_check_ms:.3f} "
              f"ok={v.ok} degraded={v.degraded} retries={v.retries} "
              f"gap={v.gap:.3e} kkt={v.kkt_residual:.3e} kkt_tol="
              f"{v.kkt_tol:.3e} units={len(v.unit_ok or ())} events="
              f"{list(v.events)} bitwise_session={same} "
              f"launches_equal_session={counts == first_counts[name]}",
              flush=True)
        if not (v.ok and not v.degraded and v.retries == 0 and not v.rungs
                and same and counts == first_counts[name]):
            raise RuntimeError(f"serving-ls/{name}: not served as the "
                               f"plain session served it")
    check_no_breaker("serving-ls", srv, verdicts)
    st = srv.stats()
    print(f"[serving-ls] stats={st._asdict()}", flush=True)
    return total


def serving_drill_phase(X, y, lm, ls_auto, serial_expect):
    """``[serving-drill]``, under a ``FaultInjector``: (1) NaN poked into
    every engine call of Scalar(0.3) with ``ladder=("oracle",)``: ok,
    degraded, the rung K7
    and no other kernel, the cold support, the rung's wall; (2)
    ``fail_at={1}``: one retry, then bit for bit the cold Scalar; (3) the
    breaker: three failures raise a typed ``BackendFault`` and open it,
    recorded in ``stats()``, the backends untouched, and the next request
    is refused with no kernel launched and no plain solve; (4) a warm checkpoint at full width into a temporary
    directory, then a second ``open_serving`` restored from it whose warm
    Scalar is bit for bit the uninterrupted one's, with the write,
    restore and digest times. Returns the launch counts of (1), (2) and
    (4)."""
    import tempfile
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops
    from repro_torch.runtime.inject import FaultInjector

    ls = rt.get_loss("least_squares")
    cfg = rt.SaifConfig(eps=1e-6)
    lam = LS_LAM * lm
    prob = rt.Problem(X=X, y=y)
    total = {k: 0 for k in ops.KERNELS}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # (1) a poisoned result: the screening-free oracle rung (K7)
    srv = rt.open_serving(prob, cfg,
                          serving=rt.ServingConfig(ladder=("oracle",)))
    rung = {}
    real_oracle = srv._oracle_solve

    def oracle(*a, **k):
        torch.cuda.synchronize()
        rung["primary"] = ops.launch_counts()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = real_oracle(*a, **k)
        torch.cuda.synchronize()
        rung["wall"] = time.perf_counter() - t0
        rung["counts"] = ops.launch_counts()
        return out
    srv._oracle_solve = oracle
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    # every engine call poked: the cold solve overflows its first capacity
    # and regrows, so its answer comes from the second call
    with FaultInjector(nan_at=set(range(1, 9))) as inj:
        out, wall = timed(lambda: srv.solve(rt.Scalar(lam)))
    v = out.verdict
    if "counts" not in rung:
        raise RuntimeError(f"serving-drill/nan-oracle: the oracle rung did "
                           f"not finish: rungs={v.rungs} events={v.events}")
    rc = rung["counts"]
    check_launches("serving-drill/nan-oracle primary", rung["primary"],
                   serial_expect)
    add(rung["primary"])
    add(rc)
    only_k7 = rc["cm_sweep_wide"] > 0 and all(
        c == 0 for k, c in rc.items() if k != "cm_sweep_wide")
    kkt = float(rt.kkt_residual(ls, X, y, out.value.beta, lam))
    cold_sup = support(out.value.beta) == support(ls_auto.beta)
    print(f"[serving-drill/nan-oracle] log={inj.log} ok={v.ok} degraded="
          f"{v.degraded} rungs={[(r.name, r.ok) for r in v.rungs]} events="
          f"{list(v.events)} rung_wall_s={rung['wall']:.3f} request_wall_s="
          f"{wall:.3f} rung_launches={rc} only_k7={only_k7} gap={v.gap:.3e} "
          f"kkt={kkt:.3e} kkt_limit={1e-3 * lam:.3e} cold_support={cold_sup} "
          f"kkt_check_ms={v.kkt_check_ms:.3f}", flush=True)
    if not (v.ok and v.degraded and [r.name for r in v.rungs] == ["oracle"]
            and only_k7 and cold_sup and kkt <= 1e-3 * lam
            and "degraded:oracle" in v.events):
        raise RuntimeError("serving-drill/nan-oracle: not certified by the "
                           "oracle rung alone, or off the cold support")
    check_no_breaker("serving-drill/nan-oracle", srv, [v])

    # (2) a transient launch fault: one retry, then the cold solve
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with FaultInjector(fail_at={1}) as inj:
        out, wall = timed(lambda: srv.solve(rt.Scalar(lam)))
    counts = ops.launch_counts()
    check_launches("serving-drill/retry", counts, serial_expect)
    add(counts)
    v = out.verdict
    same = results_equal(out.value, ls_auto)
    print(f"[serving-drill/retry] log={inj.log} ok={v.ok} retries="
          f"{v.retries} events={list(v.events)} wall_s={wall:.3f} "
          f"bitwise_cold={same} launches={counts}", flush=True)
    if not (v.ok and v.retries == 1 and not v.degraded and same
            and v.events == ("retry:1:RuntimeError",)):
        raise RuntimeError("serving-drill/retry: not one retry then the "
                           "cold solve bit for bit")
    check_no_breaker("serving-drill/retry", srv, [v])

    # (3) the breaker: retries exhausted on the card raise a typed
    # BackendFault, the breaker opens and the session refuses the next
    # request; no plain solve anywhere, no launch after it
    c0 = srv.session.config
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with FaultInjector(fail_at={1, 2, 3}) as inj:
        try:
            srv.solve(rt.Scalar(lam))
            fault = None
        except rt.BackendFault as e:
            fault = str(e)
    torch.cuda.synchronize()
    t_trip = time.perf_counter() - t0
    tripped = ops.launch_counts()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        srv.solve(rt.Scalar(lam))
        refused = None
    except rt.BackendFault as e:
        refused = str(e)
    torch.cuda.synchronize()
    t_refuse = time.perf_counter() - t0
    after = ops.launch_counts()
    c = srv.session.config
    print(f"[serving-drill/breaker] log={inj.log} fault={fault!r} "
          f"refused={refused!r} breaker_open={srv.stats().breaker_open} "
          f"backends={(c.screen_backend, c.inner_backend)} trip_s="
          f"{t_trip:.4f} refuse_ms={t_refuse * 1e3:.3f} "
          f"launches_tripping={tripped} launches_after={after}", flush=True)
    check_launches("serving-drill/breaker after", after,
                   {k: False for k in ops.KERNELS})
    if not (fault and "retries exhausted" in fault and refused
            and "breaker is open" in refused and srv.stats().breaker_open
            and inj.calls == 3 and c is c0):
        raise RuntimeError("serving-drill/breaker: no typed BackendFault, "
                           "not recorded, or a request served after it")
    del srv

    # (4) warm checkpoint / restore at full width
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="serving-ckpt-",
                                     dir=ROOT / "build") as d:
        sc = rt.ServingConfig(ckpt_dir=d)
        a = rt.open_serving(prob, cfg, serving=sc)
        ops.reset_launch_counts()
        a.solve(rt.Scalar(lam))
        _, t_digest = timed(a._digest)
        path, t_write = timed(a.checkpoint)
        torch.cuda.synchronize()
        want = a.solve(rt.Scalar(lam, warm=True))
        b, t_open = timed(lambda: rt.open_serving(prob, cfg, serving=sc))
        restored = b.restored
        _, t_restore = timed(b._maybe_restore)
        got, wall = timed(lambda: b.solve(rt.Scalar(lam, warm=True)))
        counts = ops.launch_counts()
        check_launches("serving-drill/ckpt", counts, serial_expect)
        add(counts)
        k_max = a.session.warm_capacity
        mb = sum(f.stat().st_size for f in Path(path).iterdir()) / 2**20
        same = results_equal(got.value, want.value)
        print(f"[serving-drill/ckpt] k_max={k_max} files_MiB={mb:.3f} "
              f"digest_s={t_digest:.4f} write_ms={t_write * 1e3:.2f} "
              f"open_restored_s={t_open:.4f} restore_ms="
              f"{t_restore * 1e3:.2f} restored={restored} warm_outer="
              f"{got.value.n_outer} warm_wall_s={wall:.4f} "
              f"bitwise_uninterrupted={same} ok={got.verdict.ok}",
              flush=True)
        if not (restored and same and got.verdict.ok and want.verdict.ok):
            raise RuntimeError("serving-drill/ckpt: the restored session's "
                               "warm Scalar is not the uninterrupted one's")
        check_no_breaker("serving-drill/ckpt", b, [got.verdict])
    return total


def stream_step(tag, sess, req, expect, total):
    """One counted Update (or Scalar) on ``sess``: the launches (checked
    against ``expect``), the Gram carry rebuilds and the wall."""
    import torch
    from repro_torch.core.inner_backend import make_inner_gram
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    r0 = make_inner_gram.rebuilds
    res, wall = timed(lambda: sess.solve(req))
    counts = ops.launch_counts()
    check_launches(tag, counts, expect)
    for k in total:
        total[k] += counts[k]
    return res, wall, make_inner_gram.rebuilds - r0, counts


def resident_cert(tag, sess, res, lam, eps):
    """Certify a streamed solve on the card over the session's resident
    rows (the zero capacity rows are exact): gap <= eps, KKT <= 1e-3 lam
    over all p. Returns (gap, kkt)."""
    import repro_torch as rt
    prep = sess._prep
    kkt = float(rt.kkt_residual(rt.get_loss("least_squares"), prep.X,
                                prep.y, res.beta, lam))
    gap = float(res.gap)
    if not (gap <= eps and kkt <= 1e-3 * lam):
        raise RuntimeError(f"{tag}: not certified on the resident rows "
                           f"(gap {gap:.3e}, kkt {kkt:.3e})")
    return gap, kkt


def cold_against(tag, Xc, yc, lam, cfg, res, serial_expect, total):
    """The cold session solve of the rows ``Xc``/``yc`` (counted), held
    against the streamed ``res``: the same support; prints max |dbeta|.
    Returns the cold wall."""
    import torch
    import repro_torch as rt
    sess = rt.open_session(rt.Problem(X=Xc, y=yc), cfg)
    cold, wall, _, counts = stream_step(f"{tag}/cold", sess, rt.Scalar(lam),
                                        serial_expect, total)
    ls = rt.get_loss("least_squares")
    kkt = float(rt.kkt_residual(ls, Xc, yc, cold.beta, lam))
    same = support(res.beta) == support(cold.beta)
    diff = float((res.beta - cold.beta).abs().max())
    print(f"[{tag}/cold] n={Xc.shape[0]} wall_s={wall:.4f} outer="
          f"{cold.n_outer} n_active={cold.n_active} gap={float(cold.gap):.3e}"
          f" kkt={kkt:.3e} same_support={same} max_abs_dbeta={diff:.3e} "
          f"launches={counts}", flush=True)
    if not (same and float(cold.gap) <= cfg.eps and kkt <= 1e-3 * lam):
        raise RuntimeError(f"{tag}: the streamed solve's support is not the "
                           f"cold solve's, or the cold solve not certified")
    del sess
    torch.cuda.empty_cache()
    return wall


def online_ls_phase(X, y, lm, beta_true, serial_expect):
    """``[online-ls]``, phase 22: phase 2's problem through
    ``open_session(Problem(X, y), SaifConfig(eps=1e-6))`` and
    Scalar(0.3 lambda_max), then (1) four appended Updates of STREAM_M rows
    of the Sec 5.1.1 law (capacity 2,048 rows), (2) a STREAM_WINDOW-row ring
    streamed four times on a second session, (3) the guard drill on the
    ring: STREAM_M rows scaled by 1e8 ingested (``resolve=False``), then
    normal rows until they leave the ring, the last re-solving. Every
    re-solve counted (K1/K2/K6), certified on the card over the resident
    rows (gap <= eps, KKT <= 1e-3 lambda over all p), no Gram carry
    rebuild but the drill's one; each stream's last re-solve has the
    support of the cold session on its rows. Prints each update's wall
    beside the cold solve's, and K1's device time on the capacity-padded
    design beside its bound at the capacity and at the resident rows.
    Returns the launch counts."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.core.saif import add_batch_size_static
    from repro_torch.kernels import ops

    cfg = rt.SaifConfig(eps=1e-6)
    lam = LS_LAM * lm
    n, p = X.shape
    total = {k: 0 for k in ops.KERNELS}
    batches = [simulation_rows(beta_true, STREAM_M, 700 + i, X.device)
               for i in range(STREAM_UPDATES)]
    n_cap = stream_shape(n)[0]

    # (1) the append stream
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg)
    stream_step("online-ls/scalar", sess, rt.Scalar(lam), serial_expect,
                total)
    walls, rebuilds = [], 0
    for i, (Xn, yn) in enumerate(batches):
        res, wall, rb, counts = stream_step(
            f"online-ls/append{i}", sess,
            rt.Update(rows=Xn, responses=yn, lam=lam), serial_expect, total)
        gap, kkt = resident_cert(f"online-ls/append{i}", sess, res, lam,
                                 cfg.eps)
        walls.append(wall)
        rebuilds += rb
        st = sess._online
        print(f"[online-ls/append{i}] m={STREAM_M} filled={st.filled} "
              f"n_cap={st.n_cap} wall_s={wall:.4f} outer={res.n_outer} "
              f"n_active={res.n_active} gap={gap:.3e} kkt={kkt:.3e} "
              f"gram_rebuilds={rb} launches={counts}", flush=True)
    events = sess.drain_events()
    st = sess._online
    Xc = torch.cat([X] + [b[0] for b in batches])
    yc = torch.cat([y] + [b[1] for b in batches])
    cold_wall = cold_against("online-ls/append", Xc, yc, lam, cfg, res,
                             serial_expect, total)
    print(f"[online-ls/append] update_walls_s={[round(w, 4) for w in walls]}"
          f" cold_wall_s={cold_wall:.4f} update_over_cold="
          f"{[round(w / cold_wall, 3) for w in walls]} gram_rebuilds="
          f"{rebuilds} events={list(events)} grows={st.grows}", flush=True)
    if not (rebuilds == 0 and st.n_cap == n_cap and st.filled == Xc.shape[0]
            and events == (f"online_stream_entered:n_cap={n_cap}",)):
        raise RuntimeError("online-ls/append: a Gram rebuild, or not the "
                           "expected capacity and events")
    # K1 on the capacity-padded design (the stream's scan reads every row):
    # a call's time here by CUDA events, its device time at this shape
    # from phase 8 (the profiler loses launches late in a run)
    prep = sess._prep
    h = add_batch_size_static(cfg.c, lam, prep.c0_max, prep.c0_median, p)
    g = torch.Generator(device="cpu").manual_seed(0)
    theta = (torch.randn(st.n_cap, generator=g, dtype=torch.float64)
             / st.n_cap).to(X.device)
    theta[st.filled:] = 0.0
    active = torch.zeros(p, dtype=torch.bool, device=X.device)
    active[res.active_idx[res.active_mask]] = True
    call = time_ms(lambda: ops.screen_fused(
        prep.X, theta, prep.col_norm, active, 0.05, h=h), 20)
    ms, _, b_cap, b_res = WALLS["k1/n_cap"]
    print(f"[online-ls/k1] n_cap={st.n_cap} filled={st.filled} p={p} h={h} "
          f"call_ms={call:.4f} ms(phase 8, this shape)={ms:.4f} "
          f"bound_ms_at_n_cap={b_cap:.4f} bound_ms_at_filled={b_res:.4f} "
          f"(bytes)", flush=True)
    del sess, prep, Xc, yc
    torch.cuda.empty_cache()

    # (2) the ring, on a second session
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg)
    stream_step("online-ls/ring-scalar", sess, rt.Scalar(lam), serial_expect,
                total)
    walls, rebuilds = [], 0
    for i, (Xn, yn) in enumerate(batches):
        res, wall, rb, counts = stream_step(
            f"online-ls/ring{i}", sess,
            rt.Update(rows=Xn, responses=yn, lam=lam, window=STREAM_WINDOW),
            serial_expect, total)
        gap, kkt = resident_cert(f"online-ls/ring{i}", sess, res, lam,
                                 cfg.eps)
        walls.append(wall)
        rebuilds += rb
        print(f"[online-ls/ring{i}] head={sess._online.head} wall_s="
              f"{wall:.4f} outer={res.n_outer} n_active={res.n_active} "
              f"gap={gap:.3e} kkt={kkt:.3e} gram_rebuilds={rb}", flush=True)
    rows = [X] + [b[0] for b in batches]
    resp = [y] + [b[1] for b in batches]
    cold_wall = cold_against(
        "online-ls/ring", torch.cat(rows)[-STREAM_WINDOW:].contiguous(),
        torch.cat(resp)[-STREAM_WINDOW:].contiguous(), lam, cfg, res,
        serial_expect, total)
    print(f"[online-ls/ring] window={STREAM_WINDOW} update_walls_s="
          f"{[round(w, 4) for w in walls]} cold_wall_s={cold_wall:.4f} "
          f"gram_rebuilds={rebuilds} downdate_rebuilds="
          f"{sess._online.rebuilds}", flush=True)
    if rebuilds or sess._online.rebuilds or sess._online.n_cap != \
            STREAM_WINDOW:
        raise RuntimeError("online-ls/ring: a rebuild in a clean ring")

    # (3) the guard drill: 1e8-scale rows in, then pushed out of the ring
    Xb, yb = simulation_rows(beta_true, STREAM_M, 800, X.device, scale=1e8)
    stream_step("online-ls/guard-in", sess, rt.Update(
        rows=Xb, responses=yb, window=STREAM_WINDOW, resolve=False),
        {k: False for k in ops.KERNELS}, total)
    rows.append(Xb)
    resp.append(yb)
    sess.drain_events()
    left, i, trips, walls = STREAM_WINDOW, 0, [], []
    while left:
        m = min(STREAM_M, left)
        left -= m
        Xn, yn = simulation_rows(beta_true, m, 900 + i, X.device)
        rows.append(Xn)
        resp.append(yn)
        last = left == 0
        res, wall, rb, counts = stream_step(
            f"online-ls/guard{i}", sess, rt.Update(
                rows=Xn, responses=yn, lam=lam, window=STREAM_WINDOW,
                resolve=last),
            serial_expect if last else {k: False for k in ops.KERNELS},
            total)
        trips.append(sess._online.rebuilds)
        walls.append(wall)
        i += 1
    events = sess.drain_events()
    gap, kkt = resident_cert("online-ls/guard", sess, res, lam, cfg.eps)
    print(f"[online-ls/guard] updates={i} downdate_rebuilds_by_update="
          f"{trips} events={list(events)} resolve_wall_s={walls[-1]:.4f} "
          f"ingest_walls_s_max={max(walls[:-1]):.4f} gram_rebuilds={rb} "
          f"outer={res.n_outer} gap={gap:.3e} kkt={kkt:.3e}", flush=True)
    cold_against("online-ls/guard",
                 torch.cat(rows)[-STREAM_WINDOW:].contiguous(),
                 torch.cat(resp)[-STREAM_WINDOW:].contiguous(), lam, cfg,
                 res, serial_expect, total)
    if not (trips[-1] >= 1 and "online_downdate_rebuild" in events
            and rb == 1):
        raise RuntimeError("online-ls/guard: the downdate guard did not "
                           "rebuild the statistics and the carry")
    del sess, rows, resp
    torch.cuda.empty_cache()
    return total


def server_ls_phase(X, Yf, fl_lams, fl_res, fl_wall, fleet_expect):
    """``[server-ls]``, phase 23: ``open_server(autostart=False,
    max_batch=16, max_sessions=2)`` on the card: (1) phase 9's 16 responses
    and lambdas as 16 Scalars of ``Problem(X, Y[b])``, then ``run``: one
    coalesced batch of 16 in the p bucket 131,072, each rider ok and bit
    for bit phase 9's fleet row, the launches those of ``[session-pad]``'s
    Fleet; the submit time (the design digest memo), the wall from ``run``
    to the last future beside phase 9's fleet wall and its 16 serial walls;
    (3) on the same server, its dispatcher running, a ``deadline_s=0.001``
    Scalar expiring in the queue, no launch; (2) on a second server, a
    priority-5 Scalar on a second design dispatched before a priority-0
    one submitted first (the done callbacks); (4) on a third server with
    ``ladder=()`` and ``max_retries=0``, ``FaultInjector(nan_at={1},
    nan_unit=3, tags={"fleet"})``: rider 3 fails alone, the other 15 bit
    for bit their rows. Each server starts its dispatcher after its
    requests are in. Returns the launch counts."""
    import torch
    import repro_torch as rt
    from repro_torch.core import server as S
    from repro_torch.core.api import _row
    from repro_torch.kernels import ops
    from repro_torch.runtime.inject import FaultInjector

    cfg = rt.SaifConfig(eps=1e-6)
    B = Yf.shape[0]
    n, p = X.shape
    p_bucket = 1 << (p - 1).bit_length()
    total = {k: 0 for k in ops.KERNELS}
    rows = [S._to_host(_row(fl_res, i)) for i in range(B)]

    def add(counts):
        for k in total:
            total[k] += counts[k]

    def riders(srv, stamps):
        futs = []
        for b in range(B):
            f = srv.submit(rt.Problem(X=X, y=Yf[b]), rt.Scalar(fl_lams[b]))
            f.add_done_callback(lambda f: stamps.append(time.perf_counter()))
            futs.append(f)
        return futs

    # (1) the coalesced fleet
    srv = rt.open_server(autostart=False, max_batch=B, max_sessions=2,
                         solver=cfg)
    try:
        stamps = []
        futs, t_submit = timed(lambda: riders(srv, stamps))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        srv.run(timeout=0)
        outs = [f.result(timeout=300) for f in futs]
        torch.cuda.synchronize()
        wall = max(stamps) - t0
        counts = ops.launch_counts()
        check_launches("server-ls/fleet", counts, fleet_expect)
        add(counts)
        same = [results_equal(o.value, r) for o, r in zip(outs, rows)]
        ok = [o.verdict.ok for o in outs]
        srv.drain(timeout=60)
        st = srv.stats()
        want = COUNTS["session-pad/fleet"]
        print(f"[server-ls/fleet] B={B} p_bucket={next(iter(srv._lru))[-1]} "
              f"submit_s={t_submit:.4f} run_to_last_future_s={wall:.4f} "
              f"fleet_wall_s={fl_wall:.4f} serial_walls_sum_s="
              f"{WALLS['fleet-ls/serial_sum']:.4f} all_ok={all(ok)} "
              f"bitwise_fleet_rows={all(same)} launches_equal_session_pad="
              f"{counts == want} launches={counts}", flush=True)
        if not (all(ok) and all(same) and counts == want
                and st.coalesced_batches == 1 and st.coalesced_requests == B
                and st.sessions_opened == 1
                and next(iter(srv._lru))[-1] == p_bucket):
            raise RuntimeError("server-ls/fleet: not one coalesced batch of "
                               "the fleet's rows, bit for bit")

        # (3) a deadline that expires in the queue (the dispatcher runs)
        ops.reset_launch_counts()
        fd = srv.submit(rt.Problem(X=X, y=Yf[1]),
                        rt.Scalar(fl_lams[1], deadline_s=0.001))
        exc = fd.exception(timeout=60)
        srv.drain(timeout=60)
        counts = ops.launch_counts()
        dl_ok = isinstance(exc, rt.DeadlineExceeded) and \
            not any(counts.values())
        st = srv.stats()
        print(f"[server-ls/deadline] exception={type(exc).__name__} "
              f"launches={sum(counts.values())} deadline_misses="
              f"{st.deadline_misses} ok={dl_ok}", flush=True)
        print(f"[server-ls] stats={st._asdict()}", flush=True)
        if not (dl_ok and st.deadline_misses == 1):
            raise RuntimeError("server-ls/deadline: not expired in the queue")
    finally:
        srv.close()

    # (2) priority, on a server whose dispatcher starts after both are in
    X2n, y2n = simulation_data(n, p // 5, seed=5)
    X2 = torch.from_numpy(X2n).to(X.device)
    y2 = torch.from_numpy(y2n).to(X.device)
    lm2 = float(rt.lambda_max(rt.get_loss("least_squares"), X2, y2))
    srv = rt.open_server(autostart=False, max_batch=B, max_sessions=2,
                         solver=cfg)
    try:
        order = []
        f0 = srv.submit(rt.Problem(X=X, y=Yf[0]),
                        rt.Scalar(fl_lams[0], priority=0))
        f5 = srv.submit(rt.Problem(X=X2, y=y2),
                        rt.Scalar(LS_LAM * lm2, priority=5))
        f0.add_done_callback(lambda f: order.append(0))
        f5.add_done_callback(lambda f: order.append(5))
        ops.reset_launch_counts()
        srv.run(timeout=0)
        o0, o5 = f0.result(timeout=300), f5.result(timeout=300)
        srv.drain(timeout=60)
        counts = ops.launch_counts()
        check_launches("server-ls/priority", counts, fleet_expect)
        add(counts)
        # a fleet of one: row 0's coefficients and gap (its capacity is
        # its own)
        prio_ok = (order == [5, 0] and o0.verdict.ok and o5.verdict.ok
                   and torch.equal(o0.value.beta, rows[0].beta)
                   and torch.equal(o0.value.gap, rows[0].gap))
        print(f"[server-ls/priority] order={order} ok={prio_ok} "
              f"stats={srv.stats()._asdict()}", flush=True)
        if not prio_ok:
            raise RuntimeError("server-ls/priority: the priority-5 request "
                               "was not dispatched first")
    finally:
        srv.close()
    del X2, y2
    torch.cuda.empty_cache()

    # (4) a poisoned rider, contained
    srv = rt.open_server(autostart=False, max_batch=B, max_sessions=2,
                         solver=cfg, serving=rt.ServingConfig(
                             ladder=(), max_retries=0))
    try:
        stamps = []
        futs = riders(srv, stamps)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with FaultInjector(nan_at={1}, nan_unit=3, tags={"fleet"}) as inj:
            srv.run(timeout=0)
            outs = [f.result(timeout=300) for f in futs]
        srv.drain(timeout=60)
        counts = ops.launch_counts()
        check_launches("server-ls/poisoned", counts, fleet_expect)
        add(counts)
        bad = [i for i, o in enumerate(outs) if not o.verdict.ok]
        same = all(results_equal(o.value, r) for i, (o, r) in
                   enumerate(zip(outs, rows)) if i != 3)
        v3 = outs[3].verdict
        st = srv.stats()
        print(f"[server-ls/poisoned] log={inj.log} failed_riders={bad} "
              f"rider3_events={list(v3.events)} rider3_unit_ok={v3.unit_ok} "
              f"others_bitwise={same} stats={st._asdict()}", flush=True)
        if not (bad == [3] and same and "nonfinite" in v3.events
                and st.coalesced_batches == 1):
            raise RuntimeError("server-ls/poisoned: the poisoned rider was "
                               "not contained to itself")
    finally:
        srv.close()
    return total


MIXED = (("bfloat16", "bf16"), ("float32", "f32"))


def check_mixed_scans(X, records):
    """``[kernel screen_fused_batch bf16|f32]`` and ``[kernel screen_fused
    bf16|f32]``: K1b and K1 in the mixed mode, X cast once in its scan's
    layout, at the smoke's shapes (m = 16 and 1) and at p = 777 with n odd
    (m = 1, 5, 16, 17: a chunk of 8 with three empty rows, a second chunk of
    one problem; m = 16 also with per-problem norms). The bf16 mode runs
    the tensor-core scan (route=wgmma), the float32-input mode the fma
    chains (route=fma). Each score within
    its route's certified bound gamma_total ||theta|| ||x_i|| of the
    float64 product (``scan_gamma``: the wgmma sums are certified as a
    truncating float32 adder, u = 2^-23). Kernel and twin multiply the same
    rounded inputs exactly and differ by their float32 sums only: each
    score within (gamma_n(2^-24) + gamma_n(u_route)) sum_j |theta_j|
    |x_ji| of the twin's (the twin rounds to nearest), ub within that plus
    the epilogue's float32 rounding, and tile-winner ids equal the twin's
    wherever neighbouring scores stand more than that apart. Timed at full
    size beside the twin and cuBLAS on the same cast inputs."""
    import torch
    from repro_torch.core.duality import dot_error_gamma, unit_roundoff
    from repro_torch.core.screen_backend import scan_gamma, scan_unit_roundoff
    from repro_torch.kernels import ops
    from repro_torch.kernels.screen.screen import scan_input

    dev = X.device
    g = torch.Generator(device="cpu").manual_seed(21)
    small = (torch.rand(1001, 777, generator=g, dtype=torch.float64) * 20
             - 10).to(dev)
    k1_rows = []
    u32 = unit_roundoff(torch.float32)
    cases = [(X, True, m, False) for m in (16, 1)] + [
        (small, False, m, m == 16 and own) for m in (16, 1, 5, 17)
        for own in (False, True) if m == 16 or not own]
    for Xs, full, m, own in cases:
        n, p = Xs.shape
        cn = torch.linalg.vector_norm(Xs, dim=0)
        if own:             # per-problem norms, as a weighted fleet has
            cn = cn * torch.linspace(0.5, 1.5, m, dtype=torch.float64,
                                     device=dev)[:, None]
        Th = (torch.randn(m, n, generator=g, dtype=torch.float64)
              / (10 * n ** 0.5)).to(dev)
        act = (torch.rand(m, p, generator=g) < 0.05).to(dev)
        r = torch.linspace(1e-3, 1e-2, m, dtype=torch.float64,
                           device=dev)
        exact = torch.abs(Th @ Xs)
        free = ~act
        h = 32
        for mode, short in MIXED:
            dt = getattr(torch, mode)
            Xc, cn32, r32 = scan_input(Xs, dt), cn.float(), r.float()
            guard = 1.0 + 8.0 * u32
            route = "wgmma" if dt == torch.bfloat16 else "fma"
            gam = scan_gamma(n, dt, dev)
            u_route = scan_unit_roundoff(dt, dev)
            bound = (gam * torch.linalg.vector_norm(Th, dim=1)[:, None]
                     * (cn if own else cn[None, :]))
            # kernel against twin: both sums' bounds over the products
            # of the rounded inputs (exact in float64)
            pair = ((dot_error_gamma(n, u32)
                     + dot_error_gamma(n, u_route))
                    * (Th.to(dt).double().abs() @ Xc.double().abs()))
            if m > 1:
                def call(Xc=Xc, Th=Th, cn32=cn32, act=act, r32=r32,
                         mode=mode, guard=guard):
                    return ops.screen_fused_batch(
                        Xc, Th, cn32, act, r32, h=h, in_dtype=mode,
                        guard=guard)
            else:
                def call(Xc=Xc, Th=Th, cn32=cn32, act=act, r32=r32,
                         mode=mode, guard=guard):
                    return tuple(t[None] for t in ops.screen_fused(
                        Xc, Th[0], cn32, act[0], r32[0], h=h,
                        in_dtype=mode, guard=guard))

            def twin(Xc=Xc, Th=Th, cn32=cn32, act=act, r32=r32, dt=dt,
                     guard=guard):
                return ops.screen_fused_batch_ref(
                    Xc.float(), Th.to(dt).float(), cn32, act, r32, h=h,
                    guard=guard)
            out, ref = call(), twin()
            d_exact = ((out[0].double() - exact).abs() - bound)[free]
            d_twin = ((out[0] - ref[0]).abs().double() - pair)[free]
            ub_slack = ((out[1] - ref[1]).abs().double() - guard * pair
                        - 8 * u32 * ref[1].abs().double())[free]
            err = float((out[0] - ref[0]).abs()[free].max())
            err_share = float(((out[0] - ref[0]).abs().double()
                               / pair.clamp(min=1e-300))[free].max())
            # tile winners: the twin's sorted tops, decided where they
            # stand clear of both neighbours
            ts = ref[3].double()
            tol = pair.max(dim=1).values[:, None, None]
            inf = torch.full_like(ts[..., :1], float("inf"))
            dif = torch.cat([inf, ts], -1) - torch.cat([ts, -inf], -1)
            clear = ((dif[..., :-1].abs() > tol)
                     & (dif[..., 1:].abs() > tol) & torch.isfinite(ts))
            ids_ok = bool((out[4][clear] == ref[4][clear]).all())
            ok = (float(d_exact.max()) <= 0 and float(d_twin.max()) <= 0
                  and float(ub_slack.max()) <= 0 and ids_ok)
            kname = "screen_fused_batch" if m > 1 else "screen_fused"
            line = (f"[kernel {kname} {short}] route={route} n={n} p={p}"
                    f" m={m}{' norms=per-problem' if own else ''} "
                    f"gamma={gam:.3e} u_sums={u_route:.3e} "
                    f"max_abs_err_vs_twin={err:.3e} "
                    f"score_vs_f64_slack={float(d_exact.max()):.3e} "
                    f"score_vs_twin_slack={float(d_twin.max()):.3e} "
                    f"err_over_twin_bound={err_share:.3e} "
                    f"ub_slack={float(ub_slack.max()):.3e} "
                    f"ids_ok={ids_ok} (decided {int(clear.sum())} of "
                    f"{int(torch.isfinite(ts).sum())})")
            if full:
                isz = torch.finfo(dt).bits // 8
                ms, call_ms = kernel_ms(
                    call, 20, "screen_tc_kernel" if route == "wgmma"
                    else "screen_fused_kernel")
                plain = time_ms(twin, 3)
                Thc = Th.to(dt)
                lib = time_ms(lambda: torch.abs(Thc @ Xc), 20)
                pb = -(-p // 256)
                bnd, by = bound_ms(
                    n * p * isz + m * n * isz + p * 4 + m * p + 4 * m
                    + 3 * m * p * 4 + m * pb * h * 8 + m * pb * 4,
                    2 * m * n * p, mode)
                line += (f" ms={ms:.4f} call_ms={call_ms:.4f} "
                         f"plain_ms={plain:.4f} library_ms(abs(Theta_"
                         f"{short} @ X_{short}), cuBLAS, {short} out)="
                         f"{lib:.4f} bound_ms={bnd:.4f} ({by})")
                rec = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                           plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=lib, err_over_twin_bound=err_share)
                if m > 1:
                    records[f"screen_fused_batch_{short}"].update(rec)
                else:
                    k1_rows.append({"in_dtype": mode, "route": route,
                                    **rec})
            print(line, flush=True)
            if not ok:
                raise RuntimeError(f"{kname} {mode} (m = {m}): outside "
                                   f"the certified bounds")
    # K1's mixed mode is on no path (the serial engine has no screen
    # dtype): its numbers ride in K1's record
    records["screen_fused"]["mixed"] = k1_rows


def check_gram_lockstep(res, lams, records):
    """``[kernel gram_sweep_batch lockstep]``: K6b with the identity order
    over each problem's slots [0, hi) (the fast fleet's sweep) on the final
    carries of ``[fleet-fast/working]`` from beta = 0, every third live slot
    masked off (dead slots interleaved), problem 0 frozen (no epoch) and
    budgets of 1 to 40 epochs; against its twin (rel 1e-12) and timed."""
    import torch
    from repro_torch.kernels import ops

    G, rho = res.inner.G.contiguous(), res.inner.rho.contiguous()
    b, k = rho.shape
    dev = G.device
    mask = res.active_mask.clone()
    mask[:, 1::3] = False
    beta = torch.zeros_like(rho)
    order = torch.arange(k, dtype=torch.int32, device=dev).expand(
        b, -1).contiguous()
    hi = torch.amax(torch.where(mask, torch.arange(
        1, k + 1, dtype=torch.int32, device=dev), 0), dim=1)
    nep = torch.tensor([0] + [1 + (7 * i) % 40 for i in range(1, b)],
                       dtype=torch.int32, device=dev)
    lam = torch.tensor(lams, dtype=G.dtype, device=dev)
    args = (G, rho, beta, mask, lam, order, hi, nep)
    out = ops.gram_sweep_batch(*args)
    ref = ops.gram_sweep_batch_ref(*args)
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-300)
    frozen = bool((out[0] == 0).all())
    ms, call = kernel_ms(lambda: ops.gram_sweep_batch(*args), 10,
                         "gram_sweep_kernel")
    plain = time_ms(lambda: ops.gram_sweep_batch_ref(*args), 1)
    steps = int((nep.long() * hi.long()).sum())
    bnd, by = bound_ms(b * (k * k * 8 + 4 * k * 8 + 5 * k),
                       steps * 2 * k + b * 2 * k * k, "float64")
    print(f"[kernel gram_sweep_batch lockstep] B={b} k_max={k} hi="
          f"{hi.tolist()} live={mask.sum(1).tolist()} n_epochs="
          f"{nep.tolist()} from beta=0 nonzero={(ref != 0).sum(1).tolist()}"
          f" frozen_kept={frozen} max_abs_err={err:.3e} rel_err={rel:.3e} "
          f"tol=1e-12 ms={ms:.4f} call_ms={call:.4f} us_per_step="
          f"{ms * 1e3 / int((nep.long() * hi.long()).max()):.4f} "
          f"plain_ms={plain:.4f} bound_ms={bnd:.6f} ({by})", flush=True)
    if not (rel <= 1e-12 and frozen):
        raise RuntimeError("gram_sweep_batch lockstep disagrees")
    records["gram_sweep_batch_lockstep"].update(
        max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain, bound_ms=bnd,
        bound_by=by, library_ms=None)


def plain_fleet_phase(X, Y, lams, kres):
    """The plain fleet (``torch`` screen and inner) on the card against the
    kernel fleet's rows ``kres``."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    cfg = rt.SaifConfig(eps=1e-6, screen_backend="torch",
                        inner_backend="torch")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = rt.fleet_solve(X, Y, lams, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("fleet-plain", ops.launch_counts(),
                   {k: False for k in ops.KERNELS})
    for i in range(Y.shape[0]):
        ok = (support(res.beta[i]) == support(kres[i])
              and bool(torch.allclose(res.beta[i], kres[i], rtol=1e-6,
                                      atol=1e-8))
              and float(res.gap[i]) <= cfg.eps)
        print(f"[fleet-plain/{i}] outer={int(res.n_outer[i])} "
              f"support={len(support(res.beta[i]))} "
              f"gap={float(res.gap[i]):.3e} max_abs_dev_vs_kernel_fleet="
              f"{float((res.beta[i] - kres[i]).abs().max()):.3e} ok={ok}",
              flush=True)
        if not ok:
            raise RuntimeError("fleet-plain disagrees with the kernel fleet")
    print(f"[fleet-plain] B={Y.shape[0]} wall_s={wall:.3f}", flush=True)


def check_screen_per_problem_norms(dtype, Xd, Theta, active, r, h, Wn,
                                   tol):
    """K1b with (B, p) norms, one row per problem, against its twin and B
    launches of K1, each with its own norms."""
    import torch
    from repro_torch.kernels import ops
    XX = Xd * Xd
    cn = torch.stack([torch.sqrt(w @ XX) for w in Wn])
    del XX
    b = Theta.shape[0]
    k1 = ops.screen_fused_batch(Xd, Theta, cn, active, r, h=h)
    ref = ops.screen_fused_batch_ref(Xd, Theta, cn, active, r, h=h)
    abs1, err1 = errs(zip((k1[0], k1[1], k1[2], k1[3], k1[5]),
                          (ref[0], ref[1], ref[2], ref[3], ref[5])))
    fin = torch.isfinite(ref[3])
    swapped = k1[4][fin] != ref[4][fin]
    rows = torch.nonzero(fin)[:, 0][swapped]
    scale1 = float(ref[3][fin].abs().max())
    tie = ((ref[0][rows, k1[4][fin][swapped].long()]
            - ref[0][rows, ref[4][fin][swapped].long()]).abs()
           <= tol * scale1)
    ids_ok = bool(tie.all()) and (dtype == "float32" or
                                  int(swapped.sum()) == 0)
    same = True
    for i in range(b):
        one = ops.screen_fused(Xd, Theta[i].contiguous(), cn[i].contiguous(),
                               active[i].contiguous(), r[i], h=h)
        same = same and all(torch.equal(a[i], o) for a, o in zip(k1, one))
    ms, call = kernel_ms(lambda: ops.screen_fused_batch(
        Xd, Theta, cn, active, r, h=h), 10, "screen_fused_kernel")
    print(f"[kernel screen_fused_batch {dtype} per-problem norms] B={b} "
          f"max_abs_err={abs1:.3e} rel_err={err1:.3e} tol={tol:.0e} "
          f"ids_ok={ids_ok} (ids differing at near-ties: "
          f"{int(swapped.sum())}) bitwise_B_x_K1_own_norms={same} "
          f"ms={ms:.4f} call_ms={call:.4f}", flush=True)
    if not (err1 <= tol and ids_ok and same):
        raise RuntimeError(f"screen_fused_batch {dtype} with per-problem "
                           f"norms disagrees")


def check_fleet_kernels(dtype, X, Y, lams, h, res, loss_name, records,
                        Wn=None):
    """K1b, K2b and K3b against their plain versions and against B
    launches of K1, K2 and K3, at the fleet's shapes; with ``Wn`` (B, n)
    sample weights, K1b also with the per-problem norms sqrt(w_b . X^2)."""
    import torch
    from repro_torch.core.active_set import compact_order
    from repro_torch.kernels import ops
    from repro_torch.kernels.screen.screen import _scan

    dt = getattr(torch, dtype)
    isz = torch.finfo(dt).bits // 8
    tol = {"float64": 1e-10, "float32": 1e-4}[dtype]
    Xd = X.to(dt)
    n, p = Xd.shape
    b = Y.shape[0]
    g = torch.Generator(device="cpu").manual_seed(1)
    Theta = (torch.randn(b, n, generator=g, dtype=torch.float64) / n).to(
        Xd.device, dt)
    col_norm = torch.linalg.vector_norm(Xd, dim=0)
    active = torch.zeros(b, p, dtype=torch.bool, device=Xd.device)
    for i in range(b):
        active[i, res.active_idx[i][res.active_mask[i]]] = True
    r = torch.linspace(0.01, 0.1, b, dtype=dt, device=Xd.device)
    h_tile = min(h, 256)
    pb = -(-p // 256)

    # K1b against its twin; candidate ids as K1's (near ties reported)
    k1 = ops.screen_fused_batch(Xd, Theta, col_norm, active, r, h=h)
    ref = ops.screen_fused_batch_ref(Xd, Theta, col_norm, active, r, h=h)
    abs1, err1 = errs(zip((k1[0], k1[1], k1[2], k1[3], k1[5]),
                          (ref[0], ref[1], ref[2], ref[3], ref[5])))
    fin = torch.isfinite(ref[3])
    ids_k, ids_p = k1[4][fin].long(), ref[4][fin].long()
    swapped = ids_k != ids_p
    rows = torch.nonzero(fin)[:, 0][swapped]
    s_ref = ref[0]
    scale1 = float(ref[3][fin].abs().max())
    tie = ((s_ref[rows, ids_k[swapped]] - s_ref[rows, ids_p[swapped]]).abs()
           <= tol * scale1)
    ids_ok = bool(tie.all()) and (dtype == "float32" or
                                  int(swapped.sum()) == 0)
    # bitwise B launches of K1
    same1 = True
    for i in range(b):
        one = ops.screen_fused(Xd, Theta[i].contiguous(), col_norm,
                               active[i].contiguous(), r[i], h=h)
        same1 = same1 and all(torch.equal(a[i], o) for a, o in zip(k1, one))
    ms1, call1 = kernel_ms(lambda: ops.screen_fused_batch(
        Xd, Theta, col_norm, active, r, h=h), 10, "screen_fused_kernel")
    # the same scan without the mask and the tile top-h epilogue: the split
    # of the kernel's time between its scan and its epilogue
    ms1u = device_ms(lambda: _scan("screen_fused_batch", Xd, Theta, col_norm,
                                   None, r, 1, False), 10,
                     "screen_fused_kernel")
    plain1 = time_ms(lambda: ops.screen_fused_batch_ref(
        Xd, Theta, col_norm, active, r, h=h), 2)
    lib1 = time_ms(lambda: torch.abs(Theta @ Xd), 10)
    b1, by1 = bound_ms(n * p * isz + b * n * isz + p * isz + b * p + b
                       * isz + 3 * b * p * isz + b * pb * h_tile * (isz + 4)
                       + b * pb * isz, 2 * n * p * b, dtype)
    print(f"[kernel screen_fused_batch {dtype}] B={b} n={n} p={p} h={h} "
          f"max_abs_err={abs1:.3e} rel_err={err1:.3e} tol={tol:.0e} "
          f"ids_ok={ids_ok} (ids differing at near-ties: "
          f"{int(swapped.sum())} of {int(fin.sum())}) bitwise_B_x_K1="
          f"{same1} ms={ms1:.4f} call_ms={call1:.4f} unmasked_ms="
          f"{ms1u:.4f} plain_ms="
          f"{plain1:.4f} library_ms(abs(Theta@X))={lib1:.4f} "
          f"bound_ms={b1:.4f} ({by1})", flush=True)
    if not (err1 <= tol and ids_ok and same1):
        raise RuntimeError(f"screen_fused_batch {dtype} disagrees")
    if Wn is not None:
        check_screen_per_problem_norms(dtype, Xd, Theta, active, r, h,
                                       Wn.to(dt), tol)

    # K2b: the histogram entry on the scan's ub against each problem's h
    # smallest finite lb; the tail entry as the fleet screen calls it, with
    # the shared norms and with the 16 subsample masks' norms; both bit
    # for bit their twins and, row by row, the serial kernel
    ub, tmax = ref[1], ref[5]
    lb_sorted = torch.stack([torch.sort(ref[2][i][torch.isfinite(
        ref[2][i])][:h]).values for i in range(b)])
    hist = ops.ub_histogram_batch(ub, lb_sorted)
    err2 = int((hist - ops.ub_histogram_batch_ref(ub, lb_sorted)).abs().max())
    same2 = all(torch.equal(hist[i], ops.ub_histogram(ub[i], lb_sorted[i]))
                for i in range(b))
    ms2h, call2h = kernel_ms(lambda: ops.ub_histogram_batch(ub, lb_sorted),
                             20, "screen_tail_kernel")
    vals, pos = torch.sort(ref[3].reshape(b, -1), dim=1, descending=True,
                           stable=True)
    cidx = torch.gather(ref[4].reshape(b, -1), 1, pos[:, :h]).long()
    norms = [col_norm]
    if Wn is not None:
        XX = Xd * Xd
        norms.append(torch.stack([torch.sqrt(w @ XX) for w in Wn.to(dt)]))
        del XX
    tails = []
    for cn in norms:
        targs = (ub, tmax, vals[:, :h], cidx, cn, r)
        out = ops.screen_tail_batch(*targs)
        ok = same_bits(out, ops.screen_tail_batch_ref(*targs))
        for i in range(b):
            ok = ok and same_bits([o[i] for o in out], ops.screen_tail(
                ub[i], tmax[i], vals[i, :h], cidx[i],
                cn if cn.ndim == 1 else cn[i], r[i]))
        tails.append(ok)
    targs = (ub, tmax, vals[:, :h], cidx, col_norm, r)
    ms2, call2 = kernel_ms(lambda: ops.screen_tail_batch(*targs), 20,
                           "screen_tail_kernel")
    plain2 = time_ms(lambda: ops.screen_tail_batch_ref(*targs), 2)
    b2, by2 = bound_ms(b * (p * isz + pb * isz + h * (3 * isz + 8 + 4)
                            + 2 * isz + 4), b * p * h.bit_length(), dtype)
    print(f"[kernel ub_histogram_batch {dtype}] B={b} p={p} h={h} tail: "
          f"bitwise_twin_and_B_x_K2 (shared{', per-problem' if Wn is not None else ''} norms)={tails} "
          f"ms={ms2:.4f} call_ms={call2:.4f} plain_ms={plain2:.4f} "
          f"bound_ms={b2:.6f} ({by2}); histogram entry: max_abs_err={err2} "
          f"tol=0 bitwise_B_x_K2={same2} ms={ms2h:.4f} call_ms={call2h:.4f}",
          flush=True)
    if err2 != 0 or not same2 or not all(tails):
        raise RuntimeError(f"ub_histogram_batch {dtype} disagrees")
    check_tail_edges(dtype, batch=True)
    if dtype == "float64":
        from repro_torch.core.screen_backend import make_batch_screen_cuda
        fsc = make_batch_screen_cuda(Xd, col_norm, h)
        thetas = list(Theta)
        rs = list(r)
        acts = list(active)
        do = [True] * b
        screen_step(f"fleet B={b}", lambda: fsc(thetas, rs, acts, do))

    # K3b at each problem's final active block, from beta = 0, one polish
    # burst; the last problem frozen (0 epochs), as the fleet does
    mask = res.active_mask
    k = mask.shape[1]
    count = mask.sum(dim=1).to(torch.int32)
    order = torch.stack([compact_order(torch.arange(k, device=mask.device),
                                       m) for m in mask])
    AT = torch.where(mask[:, :, None], Xd.T[res.active_idx], 0.0)
    cn = torch.where(mask, col_norm[res.active_idx], 0.0)
    col_sq = cn * cn
    Yd = Y.to(dt)
    lam_t = torch.tensor(lams, dtype=dt, device=Xd.device)
    n_ep = torch.full((b,), 40, dtype=torch.int32, device=Xd.device)
    n_ep[-1] = 0
    beta0 = torch.zeros(b, k, dtype=dt, device=Xd.device)

    def run_k():
        return ops.cm_burst_batch_xt(AT, Yd, beta0, col_sq, mask, order,
                                     lam_t, n_ep, count, loss_name=loss_name)

    def run_p():
        return ops.cm_burst_batch_ref(AT.transpose(1, 2), Yd, beta0, col_sq,
                                      mask, order, lam_t, n_ep, count,
                                      loss_name=loss_name)

    out, pout = run_k(), run_p()
    abs3 = err3 = 0.0
    same3 = True
    for i in range(b):
        a_i, e_i = burst_error(loss_name, [o[i] for o in out],
                               [o[i] for o in pout], Yd[i], lams[i])
        abs3, err3 = max(abs3, a_i), max(err3, e_i)
        one = ops.cm_burst_xt(AT[i].contiguous(), Yd[i].contiguous(),
                              beta0[i], col_sq[i].contiguous(), mask[i],
                              order[i], float(lam_t[i]), int(n_ep[i]),
                              int(count[i]),
                              loss_name=loss_name)
        same3 = same3 and all(torch.equal(o[i], s) for o, s in zip(out, one))
    tol3 = {"float64": 1e-12, "float32": 1e-3}[dtype]
    ms3, call3 = kernel_ms(run_k, 3, "cm_burst_kernel")
    plain3 = time_ms(run_p, 1)
    steps = int((n_ep.long() * count.long()).sum())
    flops = steps * 4 * n + b * 4 * n * k
    b3, by3 = bound_ms(b * (k * n * isz + 3 * n * isz + 3 * k * isz + 5 * k
                            + isz), flops, dtype)
    print(f"[kernel cm_burst_batch {dtype} {loss_name}] B={b} n={n} k={k} "
          f"live={count.tolist()} n_epochs=40 (last problem 0) "
          f"max_abs_err={abs3:.3e} rel_err={err3:.3e} tol={tol3:.0e} "
          f"bitwise_B_x_K3={same3} ms={ms3:.4f} call_ms={call3:.4f} "
          f"us_per_step="
          f"{ms3 * 1e3 / (40 * int(count.max())):.4f} plain_ms="
          f"{plain3:.4f} bound_ms={b3:.6f} ({by3})", flush=True)
    if not (err3 <= tol3 and same3):
        raise RuntimeError(f"cm_burst_batch {dtype} disagrees")
    if dtype == "float64":
        records["screen_fused_batch"].update(
            max_abs_err=abs1, ms=ms1, call_ms=call1, plain_ms=plain1,
            bound_ms=b1, bound_by=by1, library_ms=lib1)
        records["ub_histogram_batch"].update(
            max_abs_err=err2, ms=ms2, call_ms=call2, plain_ms=plain2,
            bound_ms=b2, bound_by=by2, library_ms=None)
        records["cm_burst_batch"].update(
            max_abs_err=abs3, ms=ms3, call_ms=call3, plain_ms=plain3,
            bound_ms=b3, bound_by=by3, library_ms=None)


def cv_screen_h(X, y, lams):
    """The candidate count of the ``[cv-ls]`` fold fleets' K1b scans: the
    largest h of the grid, computed as ``cv_solve`` computes it."""
    import repro_torch as rt
    from repro_torch.core.batch import prepare_fleet
    from repro_torch.core.saif import add_batch_size_static
    cfg = rt.SaifConfig(eps=1e-6)
    n, p = X.shape
    prep = prepare_fleet(X, y.expand(CV_FOLDS, n).contiguous(), cfg,
                         weights=rt.kfold_weights(n, CV_FOLDS).to(X),
                         device=X.device)
    return max(add_batch_size_static(cfg.c, float(lam), mx, md, p)
               for lam in lams
               for mx, md in zip(prep.c0_max, prep.c0_median))


def check_screen_cv_shape(dtype, X, cv, h):
    """K1b at the ``[cv-ls]`` fold fleets' shape: B = 5 folds, each with its
    own column norms sqrt(w_k . X^2), the folds' active sets at the grid's
    last lambda, the grid's largest h; against its twin and bit for bit 5
    launches of K1, each with its own norms; masked and unmasked times."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops
    from repro_torch.kernels.screen.screen import _scan
    dt = getattr(torch, dtype)
    tol = {"float64": 1e-10, "float32": 1e-4}[dtype]
    Xd = X.to(dt)
    n, p = Xd.shape
    W = rt.kfold_weights(n, CV_FOLDS).to(X)
    XX = X * X
    cn = torch.stack([torch.sqrt(w @ XX) for w in W]).to(dt)
    del XX
    fr = cv.fold_results[-1]
    active = torch.zeros(CV_FOLDS, p, dtype=torch.bool, device=X.device)
    for k in range(CV_FOLDS):
        active[k, fr.active_idx[k][fr.active_mask[k]]] = True
    g = torch.Generator(device="cpu").manual_seed(2)
    Theta = (torch.randn(CV_FOLDS, n, generator=g, dtype=torch.float64)
             / n).to(X.device, dt)
    r = torch.linspace(0.01, 0.1, CV_FOLDS, dtype=dt, device=X.device)
    k1 = ops.screen_fused_batch(Xd, Theta, cn, active, r, h=h)
    ref = ops.screen_fused_batch_ref(Xd, Theta, cn, active, r, h=h)
    abs1, err1 = errs(zip((k1[0], k1[1], k1[2], k1[3], k1[5]),
                          (ref[0], ref[1], ref[2], ref[3], ref[5])))
    fin = torch.isfinite(ref[3])
    swapped = k1[4][fin] != ref[4][fin]
    rows = torch.nonzero(fin)[:, 0][swapped]
    scale1 = float(ref[3][fin].abs().max())
    tie = ((ref[0][rows, k1[4][fin][swapped].long()]
            - ref[0][rows, ref[4][fin][swapped].long()]).abs()
           <= tol * scale1)
    ids_ok = bool(tie.all()) and (dtype == "float32" or
                                  int(swapped.sum()) == 0)
    same = all(all(torch.equal(a[i], o) for a, o in zip(k1, ops.screen_fused(
        Xd, Theta[i].contiguous(), cn[i].contiguous(),
        active[i].contiguous(), r[i], h=h))) for i in range(CV_FOLDS))
    ms, call = kernel_ms(lambda: ops.screen_fused_batch(
        Xd, Theta, cn, active, r, h=h), 10, "screen_fused_kernel")
    ms_u = device_ms(lambda: _scan("screen_fused_batch", Xd, Theta, cn, None,
                                   r, 1, False), 10, "screen_fused_kernel")
    print(f"[kernel screen_fused_batch {dtype} cv shape] B={CV_FOLDS} n={n} "
          f"p={p} h={h} (the [cv-ls] grid's largest) active="
          f"{active.sum(1).tolist()} max_abs_err={abs1:.3e} rel_err="
          f"{err1:.3e} tol={tol:.0e} ids_ok={ids_ok} (ids differing at "
          f"near-ties: {int(swapped.sum())}) bitwise_B_x_K1_own_norms={same}"
          f" ms={ms:.4f} call_ms={call:.4f} unmasked_ms={ms_u:.4f}",
          flush=True)
    if not (err1 <= tol and ids_ok and same):
        raise RuntimeError(f"screen_fused_batch {dtype} at the cv shape "
                           f"disagrees")


def tie_probe(dtype):
    """K1 and K1b on scores that tie bit for bit: X and Theta hold small
    integers, so every sum is exact in any order, and X's columns repeat
    (40 distinct columns over p = 777, a partial last tile). One problem has
    a fully active tile, another an active partial last tile; B = 20 takes
    K1b over two chunks of problems. At h = 256 and h = 3 every output of
    K1b must equal its plain version exactly, and each row must equal K1
    on that problem bit for bit (and K1 its plain version)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    n, p, b = 64, 777, 20
    rng = np.random.default_rng(11)
    base = rng.integers(-3, 4, (n, 40)).astype(np.float64)
    Xd = torch.from_numpy(np.ascontiguousarray(
        base[:, rng.integers(0, 40, p)])).to(dev, dt)
    Theta = torch.from_numpy(rng.integers(-2, 3, (b, n)).astype(
        np.float64)).to(dev, dt)
    cn = torch.linalg.vector_norm(Xd, dim=0)
    act = rng.random((b, p)) < 0.1
    act[0, 256:512] = True
    act[1, 768:] = True
    active = torch.from_numpy(act).to(dev)
    r = torch.linspace(0.0, 0.5, b, dtype=dt, device=dev)
    results = []
    for h in (256, 3):
        k1 = ops.screen_fused_batch(Xd, Theta, cn, active, r, h=h)
        ref = ops.screen_fused_batch_ref(Xd, Theta, cn, active, r, h=h)
        exact = all(torch.equal(a, c) for a, c in zip(k1, ref))
        serial = True
        for i in range(b):
            one = ops.screen_fused(Xd, Theta[i].contiguous(), cn,
                                   active[i].contiguous(), r[i], h=h)
            one_ref = ops.screen_fused_ref(Xd, Theta[i].clone(), cn,
                                           active[i], r[i], h=h)
            serial = serial and all(
                torch.equal(a[i], o) and torch.equal(o, q)
                for a, o, q in zip(k1, one, one_ref))
        ties = int((ref[3][:, :, 1:] == ref[3][:, :, :-1]).sum())
        results.append((h, exact, serial, ties))
    print(f"[tie-probe {dtype}] n={n} p={p} B={b} (h, outputs equal the "
          f"plain version, rows bitwise K1, tied neighbours among the tile "
          f"winners): {results}", flush=True)
    if not all(e and s for _, e, s, _ in results):
        raise RuntimeError(f"tie probe {dtype}: K1/K1b differ from their "
                           f"plain versions or from each other")


def weighted_cert(loss_name, X, y, w, beta, lam):
    """(gap, weighted KKT) of a weighted problem's solution over all p
    columns: the weighted dual tail on the full design (one matvec for the
    feasible scaling) and the weighted KKT residual."""
    import repro_torch as rt
    from repro_torch.core.inner_backend import _dual_and_gap
    loss = rt.get_loss(loss_name)
    _, gap = _dual_and_gap(loss, X, y, beta, X @ beta, None, lam,
                           sample_w=w)
    kkt = rt.kkt_residual(loss, X, y, beta, lam, sample_w=w)
    return float(gap), float(kkt)


def true_features(p, seed, k=15):
    """The true features of ``fleet_responses(X, 1, seed)``: its
    ``w[rng.choice(...)] = rng.uniform(...)`` draws the values first."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rng.uniform(-1.0, 1.0, k)
    return np.sort(rng.choice(p, k, replace=False))


def bitwise_rows(a, i, b, j):
    """Fleet row i of ``a`` equals row j of ``b`` bit for bit."""
    import torch
    return (torch.equal(a.beta[i], b.beta[j]) and torch.equal(a.gap[i],
                                                              b.gap[j])
            and int(a.n_outer[i]) == int(b.n_outer[j])
            and int(a.n_active[i]) == int(b.n_active[j])
            and all(torch.equal(getattr(a, f)[i], getattr(b, f)[j])
                    for f in ("trace_gap", "trace_dual", "trace_n_active",
                              "trace_screened", "trace_survivors",
                              "trace_post_viol")))


def cv_phase(X, y, fleet_expect, refit_expect):
    """Phase 13: the fold fleets of cv_solve on the card (``refit=False``,
    the path select_solve takes, counted alone), then the serial refit at
    the best lambda (counted alone), then the checks (uncounted). Returns
    (CVPathResult, lambdas, launch counts of both, lambda_max)."""
    import dataclasses
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.core.inner_backend import make_inner_gram
    from repro_torch.kernels import ops

    ls = rt.get_loss("least_squares")
    n, p = X.shape
    lm = float(rt.lambda_max(ls, X, y))
    hi, lo, m = CV_GRID
    lams = (np.geomspace(hi, lo, m) * lm).tolist()
    cfg = rt.SaifConfig(eps=1e-6)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    make_inner_gram.rebuilds = 0
    t0 = time.perf_counter()
    cv = rt.cv_solve(X, y, lams, n_folds=CV_FOLDS, config=cfg,
                     keep_fold_betas=True, refit=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rebuilds = make_inner_gram.rebuilds
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    refit = rt.saif(X, y, cv.best_lam, cfg)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    refit_counts = ops.launch_counts()
    W = rt.kfold_weights(n, CV_FOLDS).to(X)
    k_max = cv.fold_results[0].active_idx.shape[1]
    bad = []
    for li, (lam, fr) in enumerate(zip(cv.lams, cv.fold_results)):
        for k in range(CV_FOLDS):
            gap = float(fr.gap[k])
            _, kkt = weighted_cert("least_squares", X, y, W[k], fr.beta[k],
                                   float(lam))
            ok = gap <= cfg.eps and kkt <= 1e-3 * lam
            if not ok:
                bad.append((li, k))
        print(f"[cv-ls] lam/lam_max={lam / lm:.4f} outer="
              f"{fr.n_outer.tolist()} n_active={fr.n_active.tolist()} "
              f"max_gap={float(fr.gap.max()):.3e} eps={cfg.eps:.0e} "
              f"cv_mean={cv.cv_mean[li]:.6f} cv_se={cv.cv_se[li]:.6f}",
              flush=True)
    kkt_r = float(rt.kkt_residual(ls, X, y, refit.beta, cv.best_lam))
    refit_ok = (float(refit.gap) <= cfg.eps
                and kkt_r <= 1e-3 * cv.best_lam)
    lam_1se = rt.one_se_lambda(cv.lams, cv.cv_mean, cv.cv_se)
    print(f"[cv-ls] K={CV_FOLDS} L={m} n={n} p={p} k_max={k_max} "
          f"fold_fleets_wall_s={wall:.3f} refit_wall_s={wall_r:.3f} "
          f"best_lam/lam_max={cv.best_lam / lm:.4f} "
          f"lam_1se/lam_max={lam_1se / lm:.4f} cv_mean={cv.cv_mean.tolist()}"
          f" cv_se={cv.cv_se.tolist()} outer_per_fold_lambda="
          f"{[fr.n_outer.tolist() for fr in cv.fold_results]} "
          f"gram_full_rebuilds={rebuilds} launches={counts} "
          f"refit_launches={refit_counts} refit: outer={refit.n_outer} gap="
          f"{float(refit.gap):.3e} kkt={kkt_r:.3e} "
          f"support={len(support(refit.beta))} ok={refit_ok}", flush=True)
    check_launches("cv-ls fleets", counts, fleet_expect)
    check_launches("cv-ls refit", refit_counts, refit_expect)
    if bad or not refit_ok:
        raise RuntimeError(f"cv-ls: (lambda, fold) {bad} not certified or "
                           f"the refit not certified ({refit_ok})")
    # at two lambdas the 5-fold weighted fleet against five fleets of one
    # (uncounted), both at the CV's capacity
    cfg_k = dataclasses.replace(cfg, k_max=k_max)
    Y = y.expand(CV_FOLDS, n).contiguous()
    for li in (2, m - 2):
        lam = float(cv.lams[li])
        fl = rt.fleet_solve(X, Y, lam, cfg_k, weights=W)
        same = [bitwise_rows(fl, k, rt.fleet_solve(
            X, y[None], lam, cfg_k, weights=W[k:k + 1]), 0)
            for k in range(CV_FOLDS)]
        print(f"[cv-ls] lam/lam_max={lam / lm:.4f} weighted fleet of "
              f"{CV_FOLDS} vs fleets of one: bitwise={same}", flush=True)
        if not all(same):
            raise RuntimeError("cv-ls: a weighted fleet row differs from "
                               "its fleet of one")
    # fold 1 against the serial solve on its weight-1 rows (n = 800)
    li = 3
    lam = float(cv.lams[li])
    tight = rt.SaifConfig(eps=1e-9, use_seq_ball=False)
    tr = W[1] > 0
    one = rt.fleet_solve(X, y[None], lam, tight, weights=W[1:2])
    ops.reset_launch_counts()
    sub = rt.saif(X[tr].contiguous(), y[tr].contiguous(), lam, tight)
    sub_counts = ops.launch_counts()
    dev = float((one.beta[0] - sub.beta).abs().max())
    ok = (support(one.beta[0]) == support(sub.beta)
          == support(cv.fold_results[li].beta[1]) and dev <= 1e-9
          and float(one.gap[0]) <= tight.eps and float(sub.gap) <= tight.eps)
    print(f"[cv-ls] fold 1 at lam/lam_max={lam / lm:.4f} eps=1e-9: weighted "
          f"gap={float(one.gap[0]):.3e}, serial on {int(tr.sum())} rows "
          f"gap={float(sub.gap):.3e} launches={sub_counts}; support "
          f"{len(support(sub.beta))} (cv row {len(support(cv.fold_results[li].beta[1]))})"
          f" max_abs_dev={dev:.3e} ok={ok}", flush=True)
    check_launches("cv-ls serial subsample", sub_counts,
                   {"screen_fused": True, "ub_histogram": True,
                    "gram_sweep": True, "cm_burst": False})
    if not ok:
        raise RuntimeError("cv-ls: fold 1 differs from its row-subsampled "
                           "serial solve")
    # the profile reads the grid's first CV_PROFILE_POINTS lambdas: the
    # profiler's own processing of the whole grid's 370,000 device events
    # took minutes of the run
    head = lams[:CV_PROFILE_POINTS]
    _, wall_h = timed(lambda: rt.cv_solve(X, y, head, n_folds=CV_FOLDS,
                                          config=cfg, refit=False))
    DEFERRED_PROFILES.append((f"cv-ls (first {len(head)} of {len(lams)} "
                              f"lambdas)", lambda: rt.cv_solve(
        X, y, head, n_folds=CV_FOLDS, config=cfg, refit=False), wall_h))
    return cv, lams, {k: counts[k] + refit_counts[k] for k in counts}, lm


def select_phase(X, y, lams, lm, true_idx, fleet_expect, tag="select",
                 bit=None, **over):
    """Phase 14: select_solve (counted), its stability fleet certified row by
    row (the same fleet once more, uncounted); with the config overrides
    ``over`` (``[select/fast]``) its stable support must equal the bitwise
    selection's (``bit``). Returns (launch counts, the subsample weights,
    the report)."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    ls = rt.get_loss("least_squares")
    cfg = rt.SaifConfig(eps=1e-6, **over)
    b, frac = SELECT_SUBSAMPLES
    req = rt.Select(lams=tuple(lams), n_folds=CV_FOLDS, n_subsamples=b,
                    subsample_frac=frac)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = rt.select_solve(X, y, req, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    freq, fl = rt.stability_frequencies(X, y, rep.lam, cfg, b, frac,
                                        seed=req.seed + 1)
    W = rt.subsample_weights(X.shape[0], b, frac, seed=req.seed + 1).to(X)
    bad = []
    for i in range(b):
        gap = float(fl.gap[i])
        _, kkt = weighted_cert("least_squares", X, y, W[i], fl.beta[i],
                               rep.lam)
        if not (gap <= cfg.eps and kkt <= 1e-3 * rep.lam):
            bad.append(i)
    kkt_r = float(rt.kkt_residual(ls, X, y, rep.beta, rep.lam))
    gap_r = float(rep.best_result.gap)
    ok = (not bad and (freq == rep.frequencies).all() and gap_r <= cfg.eps
          and kkt_r <= 1e-3 * rep.lam)
    if bit is not None:
        ok = ok and (np.array_equal(rep.stable_support, bit.stable_support)
                     and rep.lam == bit.lam)
    print(f"[{tag}] B={b} frac={frac} lam_1se/lam_max={rep.lam_1se / lm:.4f}"
          f" lam_min/lam_max={rep.lam_min / lm:.4f} true_feature_freq="
          f"{rep.frequencies[true_idx].tolist()} stable_support="
          f"{rep.stable_support.tolist()} (size {len(rep.stable_support)}, "
          f"true in it {len(set(rep.stable_support) & set(true_idx))}) "
          f"subsample_outer={fl.n_outer.tolist()} subsample_max_gap="
          f"{float(fl.gap.max()):.3e} refit gap={gap_r:.3e} kkt={kkt_r:.3e} "
          f"kkt_limit={1e-3 * rep.lam:.3e} wall_s={wall:.3f} "
          f"launches={counts} ok={ok}"
          + ("" if bit is None else " (stable support and lambda: the "
             "bitwise selection's)"), flush=True)
    check_launches(tag, counts, fleet_expect)
    if not ok:
        raise RuntimeError(f"{tag}: subsample problems {bad} not certified,"
                           f" or the refit, frequencies or stable support "
                           f"wrong")
    return counts, W, rep


def weighted_logistic_phase(XL, yL):
    """Phase 15: a weighted logistic fleet under ``auto`` raises on the
    card and names the plain backend."""
    import repro_torch as rt
    W = rt.kfold_weights(XL.shape[0], 2).to(XL)
    lam = 0.5 * float(rt.lambda_max(rt.get_loss("logistic"), XL, yL))
    try:
        rt.fleet_solve(XL, yL.expand(2, -1).contiguous(), lam,
                       rt.SaifConfig(loss="logistic"), weights=W)
    except ValueError as e:
        msg = str(e)
        print(f"[fleet-logistic-weighted] auto raises: {msg}", flush=True)
        if 'inner_backend="torch"' not in msg:
            raise RuntimeError("weighted logistic fleet: the message does "
                               "not name inner_backend=\"torch\"")
        return
    raise RuntimeError("weighted logistic fleet under auto did not raise")


def cm_epochs_block(X, y, lam, res):
    """The LS solve's final active block for K5 (dead columns zeroed): A
    (n, k) and its squared column norms, y and the mask, in float32."""
    import torch
    mask = res.active_mask
    A = torch.where(mask[None, :], X[:, res.active_idx], 0.0).float()
    return A, y.float(), (A * A).sum(0), mask, float(lam)


def cm_epochs_phase(X, y, lam, res):
    """Phase 16: ``ops.cm_epochs`` as a caller drives it (counted): 40
    epochs from zero on the LS solve's final block; finite float32 output
    that lowers the objective."""
    import torch
    from repro_torch.kernels import ops
    A, yf, csq, mask, lam = cm_epochs_block(X, y, lam, res)
    k = A.shape[1]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    beta, r = ops.cm_epochs(A, yf, torch.zeros(k, device=A.device), csq,
                            mask, lam, n_epochs=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    obj0 = 0.5 * float((yf.double() ** 2).sum())
    obj = cm_objective(A, yf, beta, lam)
    ok = (beta.dtype == r.dtype == torch.float32
          and bool(torch.isfinite(beta).all() and torch.isfinite(r).all())
          and obj < obj0 and bool((beta[~mask] == 0).all()))
    print(f"[cm-epochs] n={A.shape[0]} k={k} live={int(mask.sum())} "
          f"n_epochs=40 float32 objective {obj0:.6e} -> {obj:.6e} "
          f"wall_s={wall:.4f} launches={counts} ok={ok}", flush=True)
    check_launches("cm-epochs", counts,
                   {kn: (1 if kn == "cm_epochs" else False) for kn in counts})
    if not ok:
        raise RuntimeError("cm-epochs: bad output")
    return counts


def cm_objective(A, y, beta, lam):
    """0.5 ||y - A beta||^2 + lam ||beta||_1 in float64."""
    Ad, bd = A.double(), beta.double()
    r = y.double() - Ad @ bd
    return float(0.5 * (r * r).sum() + lam * bd.abs().sum())


def cm_epochs_edge_cases(A, yf, csq, mask, lam):
    """K5's edge cases beside the LS block: (name, A, y, col_sq, mask, lam,
    beta0, n_epochs). From the block: no epoch and a nonzero beta (r = y -
    A beta alone), and a nonzero beta on every slot, the dead ones
    included, for 3 epochs. Synthetic gaussian blocks (64 slots, 60 live,
    3 epochs): n = 2,048 (8 rows a thread in registers), 2,049 and 7,900
    (r in shared memory); and k = 1 at n = 1000 for 40 epochs."""
    import torch
    dev = A.device
    g = torch.Generator().manual_seed(17)
    beta_nz = (0.01 * torch.randn(A.shape[1], generator=g)).to(dev)
    out = [("n_epochs=0", A, yf, csq, mask, lam, beta_nz, 0),
           ("dead slots beta!=0", A, yf, csq, mask, lam, beta_nz, 3)]
    for n, k, live, n_ep in ((2048, 64, 60, 3), (2049, 64, 60, 3),
                             (7900, 64, 60, 3), (1000, 1, 1, 40)):
        B = torch.randn(n, k, generator=g)
        m = torch.arange(k) < live
        B = torch.where(m[None, :], B, 0.0)
        yy = B[:, :min(k, 20)].sum(1) + torch.randn(n, generator=g)
        out.append((f"n={n} k={k}", B.to(dev), yy.to(dev),
                    (B * B).sum(0).to(dev), m.to(dev),
                    0.3 * float((B.T @ yy).abs().max()),
                    torch.zeros(k, device=dev), n_ep))
    return out


def check_cm_epochs(X, y, lam, res, records):
    """K5 against its plain version at 1 and 40 epochs on the LS solve's
    final block, the objective non-increasing epoch by epoch, and at the
    edge cases of ``cm_epochs_edge_cases`` (beta and r, the same
    tolerance)."""
    import torch
    from repro_torch.kernels import ops
    A, yf, csq, mask, lam = cm_epochs_block(X, y, lam, res)
    n, k = A.shape
    beta0 = torch.zeros(k, device=A.device)
    worst, errs_r = 0.0, []
    for n_ep in (1, 40):
        b1, r1 = ops.cm_epochs(A, yf, beta0, csq, mask, lam, n_epochs=n_ep)
        b2, r2 = ops.cm_epochs_ref(A, yf, beta0, csq, mask, lam,
                                   n_epochs=n_ep)
        e = float((b1 - b2).abs().max())
        errs_r.append(e / max(float(b2.abs().max()), 1e-30))
        worst = max(worst, e)
    edge = []
    for name, A_e, y_e, c_e, m_e, lam_e, b_e, n_ep in cm_epochs_edge_cases(
            A, yf, csq, mask, lam):
        b1, r1 = ops.cm_epochs(A_e, y_e, b_e, c_e, m_e, lam_e, n_epochs=n_ep)
        b2, r2 = ops.cm_epochs_ref(A_e, y_e, b_e, c_e, m_e, lam_e,
                                   n_epochs=n_ep)
        e = max(float((b1 - b2).abs().max()) / max(float(b2.abs().max()),
                                                   1e-30),
                float((r1 - r2).abs().max()) / max(float(r2.abs().max()),
                                                   1e-30))
        # dead slots end at 0 (no epoch: beta comes back as it went in)
        held = (bool((b1[~m_e] == 0).all()) if n_ep
                else bool(torch.equal(b1, b_e)))
        edge.append((name, e, held))
    objs = [cm_objective(A, yf, beta0, lam)]
    b = beta0
    for _ in range(5):
        b, _ = ops.cm_epochs(A, yf, b, csq, mask, lam, n_epochs=1)
        objs.append(cm_objective(A, yf, b, lam))
    mono = all(c <= p_ * (1 + 1e-6) for p_, c in zip(objs, objs[1:]))
    ms, call = kernel_ms(lambda: ops.cm_epochs(A, yf, beta0, csq, mask, lam,
                                               n_epochs=40), 3,
                         "cm_epochs_kernel")
    plain = time_ms(lambda: ops.cm_epochs_ref(A, yf, beta0, csq, mask, lam,
                                              n_epochs=40), 1)
    steps = 40 * k
    bnd, by = bound_ms(4 * (n * k + 2 * n + 3 * k) + k,
                       steps * 4 * n + 2 * n * k, "float32")
    print(f"[kernel cm_epochs float32] n={n} k={k} live={int(mask.sum())} "
          f"epochs=1,40 max_abs_err={worst:.3e} rel_err={max(errs_r):.3e} "
          f"tol=1e-03 objective_by_epoch={objs} non_increasing={mono} "
          f"ms={ms:.4f} call_ms={call:.4f} us_per_step="
          f"{ms * 1e3 / steps:.4f} "
          f"plain_ms={plain:.4f} bound_ms={bnd:.6f} ({by})", flush=True)
    print("[kernel cm_epochs float32 edges] " + " ".join(
        f"{name}: rel_err={e:.3e} dead_slots_ok={held};"
        for name, e, held in edge) + " tol=1e-03", flush=True)
    edges_ok = all(e <= 1e-3 and held for _, e, held in edge)
    if not (max(errs_r) <= 1e-3 and mono and edges_ok):
        raise RuntimeError("cm_epochs disagrees with its plain version")
    records["cm_epochs"].update(max_abs_err=worst, ms=ms, call_ms=call,
                                plain_ms=plain, bound_ms=bnd, bound_by=by,
                                library_ms=None,
                                us_per_step=ms * 1e3 / steps)


def check_gram_sweep(dtype, X, y, lam, gram_res, cv, records):
    """K6 against its plain version on the LS Gram solve's final slots
    (G and rho of its final active block, 40 epochs from beta = 0, so the
    steps make the solve's updates rather than sit at its fixed point);
    K6b on the CV's 5 fold carries at its last lambda (their weighted G
    and rho, from beta = 0) against its twin and bit for bit 5 launches
    of K6. ``nonzero`` counts the slots the sweep moved off 0."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops
    dt = getattr(torch, dtype)
    isz = torch.finfo(dt).bits // 8
    tol = {"float64": 1e-12, "float32": 1e-3}[dtype]
    n_ep = 40

    def slots(idx, mask, w=None):
        return gram_slots(X, y, idx, mask, dt, w)

    G, rho, beta, mask, order, count = slots(gram_res.active_idx,
                                             gram_res.active_mask)
    k = G.shape[0]
    lam_t = torch.tensor(lam, dtype=dt, device=G.device)
    out = ops.gram_sweep(G, rho, beta, mask, lam_t, order, count, n_ep)
    ref = ops.gram_sweep_ref(G, rho, beta, mask, lam_t, order, count, n_ep)
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-300)
    ms, call = kernel_ms(lambda: ops.gram_sweep(G, rho, beta, mask, lam_t,
                                                order, count, n_ep), 5,
                         "gram_sweep_kernel")
    plain = time_ms(lambda: ops.gram_sweep_ref(G, rho, beta, mask, lam_t,
                                               order, count, n_ep), 1)
    steps = n_ep * count
    bnd, by = bound_ms(k * k * isz + 4 * k * isz + 5 * k,
                       steps * 2 * k + 2 * k * k, dtype)
    print(f"[kernel gram_sweep {dtype}] k_max={k} live={count} "
          f"n_epochs={n_ep} from beta=0 nonzero={int((ref != 0).sum())} "
          f"max_abs_err={err:.3e} rel_err={rel:.3e} "
          f"tol={tol:.0e} ms={ms:.4f} call_ms={call:.4f} "
          f"us_per_step={ms * 1e3 / steps:.4f} "
          f"plain_ms={plain:.4f} bound_ms={bnd:.6f} ({by})", flush=True)
    if not rel <= tol:
        raise RuntimeError(f"gram_sweep {dtype} disagrees")
    # K6b on the CV's fold carries at its last lambda
    fr = cv.fold_results[-1]
    m = fr.beta.shape[0]
    W = rt.kfold_weights(X.shape[0], m).to(X)
    per = [slots(fr.active_idx[i], fr.active_mask[i], W[i])
           for i in range(m)]
    Gb, rb, bb, mb, ob = (torch.stack([t[j] for t in per]).contiguous()
                          for j in range(5))
    cnt = torch.tensor([t[5] for t in per], dtype=torch.int32,
                       device=G.device)
    nep = torch.full((m,), n_ep, dtype=torch.int32, device=G.device)
    lams = torch.full((m,), float(cv.lams[-1]), dtype=dt, device=G.device)
    outb = ops.gram_sweep_batch(Gb, rb, bb, mb, lams, ob, cnt, nep)
    refb = ops.gram_sweep_batch_ref(Gb, rb, bb, mb, lams, ob, cnt, nep)
    errb = float((outb - refb).abs().max())
    relb = errb / max(float(refb.abs().max()), 1e-300)
    same = all(torch.equal(outb[i], ops.gram_sweep(
        Gb[i], rb[i], bb[i], mb[i], lams[i], ob[i], per[i][5], n_ep))
        for i in range(m))
    msb, callb = kernel_ms(lambda: ops.gram_sweep_batch(
        Gb, rb, bb, mb, lams, ob, cnt, nep), 5, "gram_sweep_kernel")
    plainb = time_ms(lambda: ops.gram_sweep_batch_ref(Gb, rb, bb, mb, lams,
                                                      ob, cnt, nep), 1)
    kb = Gb.shape[1]
    stepsb = n_ep * int(cnt.sum())
    bndb, byb = bound_ms(m * (kb * kb * isz + 4 * kb * isz + 5 * kb),
                         stepsb * 2 * kb + m * 2 * kb * kb, dtype)
    print(f"[kernel gram_sweep_batch {dtype}] B={m} k_max={kb} "
          f"live={cnt.tolist()} n_epochs={n_ep} from beta=0 nonzero="
          f"{(refb != 0).sum(1).tolist()} max_abs_err={errb:.3e} "
          f"rel_err={relb:.3e} tol={tol:.0e} bitwise_B_x_K6={same} "
          f"ms={msb:.4f} call_ms={callb:.4f} "
          f"us_per_step={msb * 1e3 / (n_ep * int(cnt.max())):.4f}"
          f" plain_ms={plainb:.4f} bound_ms={bndb:.6f} ({byb})",
          flush=True)
    if not (relb <= tol and same):
        raise RuntimeError(f"gram_sweep_batch {dtype} disagrees")
    if dtype == "float64":
        records["gram_sweep"].update(max_abs_err=err, ms=ms, call_ms=call,
                                     plain_ms=plain, bound_ms=bnd,
                                     bound_by=by, library_ms=None)
        records["gram_sweep_batch"].update(
            max_abs_err=errb, ms=msb, call_ms=callb, plain_ms=plainb,
            bound_ms=bndb, bound_by=byb, library_ms=None)


def baseline_runs(X, y, lam, lams):
    """The five runs of ``[baselines-ls]`` as (name, call, safe): ``call()``
    returns (beta at ``lam``, the betas along ``lams`` or None, outer steps
    or None, coordinate updates or None, a summary list or None)."""
    import repro_torch as rt

    def dynamic():
        r = rt.dynamic_screening(X, y, lam, rt.DynConfig(eps=1e-6))
        return r.beta, None, r.n_outer, r.coord_updates, r.survivor_history

    def sequential():
        r = rt.sequential_path(X, y, lams, rt.SeqConfig(eps=1e-6))
        return (r.betas[-1], r.betas, None, r.coord_updates,
                [round(float(f), 4) for f in r.screened_frac])

    def homotopy(kkt_check):
        r = rt.homotopy_path(X, y, lams, rt.HomotopyConfig(
            eps=1e-6, kkt_check=kkt_check))
        return (r.betas[-1], r.betas, None, r.coord_updates,
                [len(s) for s in r.supports])

    def no_screening():
        beta = rt.solve_lasso_cm(rt.get_loss("least_squares"), X, y, lam,
                                 tol=1e-6)
        return beta, None, None, None, None

    return [("dynamic", dynamic, True), ("sequential", sequential, True),
            ("homotopy-safe", lambda: homotopy(True), True),
            ("homotopy-unsafe", lambda: homotopy(False), False),
            ("no-screening", no_screening, True)]


def baselines_phase(X, y, lam, lm, saif_beta, saif_wall):
    """Phase 19, ``[baselines-ls]``: the paper's baselines on the LS design
    ``X`` at ``lam`` (eps = 1e-6), each counted alone (K7 and no other
    kernel): dynamic screening; the sequential path and the KKT-checked
    homotopy over BASE_PATH; the unsafe homotopy, its recall and precision
    at each lambda against the safe homotopy's supports; the unscreened CM
    (``solve_lasso_cm``, tol 1e-6). Every safe baseline is certified by
    the KKT residual over all p (<= 1e-3 lambda, at every lambda of a
    path) and must find SAIF's ``auto`` support at ``lam``; its wall is
    printed against SAIF's (``saif_wall``). Each run is
    queued for a profiled rerun. Returns the summed launch counts."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    ls = rt.get_loss("least_squares")
    p = X.shape[1]
    hi, lo, m = BASE_PATH
    lams = (np.geomspace(hi, lo, m) * lm).tolist()
    truth = support(saif_beta)
    total = {k: 0 for k in ops.KERNELS}
    safe_sups = None
    for name, call, safe in baseline_runs(X, y, lam, lams):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        beta, betas, outer, updates, summary = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        k7 = counts["cm_sweep_wide"]
        if name == "no-screening":        # one K7 launch an epoch
            outer, updates = k7, k7 * p
        path = betas if betas is not None else [beta]
        at = lams if betas is not None else [lam]
        kkt = [float(rt.kkt_residual(ls, X, y, b, l)) / l
               for b, l in zip(path, at)]
        sups = [support(b) for b in path]
        if name == "homotopy-safe":
            safe_sups = sups
        line = (f"[baselines-ls/{name}] p={p} wall_s={wall:.3f} "
                f"wall_over_saif_auto={wall / saif_wall:.2f} outer="
                f"{outer if outer is not None else '-'} coord_updates="
                f"{updates} k7_launches={k7} max_kkt_over_lam="
                f"{max(kkt):.3e} support={len(sups[-1])}")
        if summary is not None:
            line += f" summary={summary}"
        if safe:
            ok = max(kkt) <= 1e-3 and sups[-1] == truth
            line += f" saif_support={sups[-1] == truth} certified={ok}"
        else:
            rp = [rt.support_metrics(np.array(sorted(a), dtype=int),
                                     np.array(sorted(b), dtype=int))
                  for a, b in zip(sups, safe_sups)]
            ok = True
            line += (" recall=" + str([round(r, 4) for r, _ in rp])
                     + " precision=" + str([round(q, 4) for _, q in rp]))
        print(line + f" launches={counts}", flush=True)
        check_launches(f"baselines-ls/{name}", counts,
                       {k: k == "cm_sweep_wide" for k in counts})
        if not ok:
            raise RuntimeError(f"baselines-ls/{name}: not certified or not "
                               f"SAIF's support")
        for k in total:
            total[k] += counts[k]
        DEFERRED_PROFILES.append((f"baselines-ls/{name}", call, wall,
                                  ("cm_wide_kernel",)))
    return total


def wide_cases(X, y, lam, XL, yL, lamL, dtype):
    """K7's checks in ``dtype``: (name, args, loss). One epoch from beta = 0
    over the first 20,000 columns of the LS design; on 2,000 of them 3
    epochs with a tenth of the slots masked and a nonzero beta on some of
    those, and with an unpenalized slot; one slot (40 epochs); two slots
    alternating and one slot repeated (5 epochs, each step's beta taken
    in hand); n = 2,048 (8 rows a thread in registers) and 2,049 (rows in
    shared memory) on gaussian blocks; logistic on 2,000 columns of its
    design, also with an unpenalized slot (fused_baseline_cm's sweep);
    short orders of ``WIDE_COUNTS`` slots (7 epochs) and n = 1,024 (4 rows
    a thread), 1,025 (8) and 12,792 (the largest n the shared-memory gate
    takes in float64) on gaussian blocks."""
    import torch
    from repro_torch.core.cm import sweep_order
    dev = X.device
    g = torch.Generator().manual_seed(23)
    out = []

    def add(name, XT, yy, lam_, n_ep=1, mask=None, beta=None, pen=None,
            count=None, loss_name="least_squares"):
        k = XT.shape[0]
        mask = (torch.ones(k, dtype=torch.bool, device=dev) if mask is None
                else mask)
        beta = (torch.zeros(k, dtype=dtype, device=dev) if beta is None
                else beta.to(dtype))
        order, cnt = sweep_order(mask, beta)
        out.append((name, (XT, yy.to(dtype), beta, XT.T @ beta,
                           (XT * XT).sum(1), mask, order, lam_, n_ep,
                           cnt if count is None else count, pen), loss_name))

    XT20 = X[:, :20_000].T.contiguous().to(dtype)
    add("k=20000", XT20, y, lam)
    XT2 = XT20[:2000]
    m = (torch.rand(2000, generator=g) > 0.1).to(dev)
    b = torch.where(torch.rand(2000, generator=g) < 0.3,
                    0.01 * torch.randn(2000, generator=g), 0.0).to(dev)
    add("masked", XT2, y, lam, 3, mask=m, beta=b)
    w = torch.ones(2000, dtype=dtype, device=dev)
    w[0] = 0.0
    add("pen-0 slot", XT2, y, lam, 3, pen=w)
    add("k=1", XT20[:1], y, 0.01 * lam, 40)
    add("count=2 alternating", XT20[:2], y, 0.01 * lam, 5)
    add("count=1 repeated", XT20[:2], y, 0.01 * lam, 5, count=1)
    for n in (2048, 2049):
        B = torch.randn(n, 64, generator=g, dtype=torch.float64)
        yy = B[:, :20].sum(1) + torch.randn(n, generator=g,
                                            dtype=torch.float64)
        add(f"n={n} k=64", B.T.contiguous().to(dev, dtype), yy.to(dev),
            0.3 * float((B.T @ yy).abs().max()), 3)
    XL2 = XL[:, :2000].T.contiguous().to(dtype)
    add("logistic k=2000", XL2, yL, lamL, 3, loss_name="logistic")
    add("logistic pen-0 slot", XL2, yL, lamL, 3, pen=w,
        loss_name="logistic")
    # the redesign's boundaries: a short order wrapping past the beta read
    # two steps ahead and the slot read five ahead, orders shorter than
    # the 32 records the prefetch warp reads at a time, the
    # register forms' row limits and the shared-memory gate's edge (f64)
    for c in WIDE_COUNTS:
        add(f"count={c}", XT20[:16], y, 0.01 * lam, 7, count=c)
    for n in (1024, 1025, 12_792):
        B = torch.randn(n, 64, generator=g, dtype=torch.float64)
        yy = B[:, :20].sum(1) + torch.randn(n, generator=g,
                                            dtype=torch.float64)
        add(f"n={n} k=64", B.T.contiguous().to(dev, dtype), yy.to(dev),
            0.3 * float((B.T @ yy).abs().max()), 3)
    return out


def check_cm_wide_warm(a, tol):
    """K7 at full width as the baselines launch it most: 5 epochs from a
    warm beta (one K7 epoch from 0, z = X beta), as dynamic screening's
    first stage after its first outer step, against the plain version on
    the same inputs copied to the host, where its loop makes no device
    synchronisation a step. Raises past
    ``tol`` (rel); returns the max abs error."""
    import torch
    from repro_torch.kernels import ops
    XT, yy, _, _, col_sq, mask, order, lam, _, k = a
    beta = ops.cm_sweep_wide(*a)[0]
    warm = (XT, yy, beta, XT.T @ beta, col_sq, mask, order, lam, 5, k)
    b1, z1 = ops.cm_sweep_wide(*warm)
    t0 = time.perf_counter()
    b2, z2 = ops.cm_sweep_wide_ref(*(v.cpu() if torch.is_tensor(v) else v
                                     for v in warm))
    plain_s = time.perf_counter() - t0
    ab, r = errs([(b1.cpu(), b2), (z1.cpu(), z2)])
    print(f"[kernel cm_sweep_wide float64] full width k={k} epochs=5 from a "
          f"warm beta ({int((beta != 0).sum())} nonzero): rel_err={r:.3e} "
          f"max_abs_err={ab:.3e} tol={tol:.0e} (plain on the host: "
          f"{plain_s:.1f} s)", flush=True)
    if not r <= tol:
        raise RuntimeError("cm_sweep_wide float64 full width disagrees with "
                           "its plain version")
    return ab


def check_cm_wide(X, y, lam, XL, yL, lamL, records):
    """K7 against its plain version on the card in float64 and float32 at
    the cases of ``wide_cases`` (beta and z against their own scale; dead
    slots end at 0), rel 1e-9 / 1e-3; its device time per launch at the
    k = 20,000 case, on 2,000 columns (16 MB in f64, held in L2 from one
    launch to the next) and at the LS design's full width (one epoch from
    0, the shape of dynamic screening's first stage and of the unscreened
    CM), microseconds per step, the plain version's time, the byte
    bound; at full width in float64 also 5 epochs from a warm beta against
    the plain version (:func:`check_cm_wide_warm`)."""
    import torch
    from repro_torch.kernels import ops
    tol = {"float64": 1e-9, "float32": 1e-3}
    worst_abs, rows = 0.0, {}
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        worst, parts = 0.0, []
        for name, args, loss_name in wide_cases(X, y, lam, XL, yL, lamL, dt):
            b1, z1 = ops.cm_sweep_wide(*args, loss_name=loss_name)
            b2, z2 = ops.cm_sweep_wide_ref(*args, loss_name=loss_name)
            a, r = errs([(b1, b2), (z1, z2)])
            dead = bool((b1[~args[5]] == 0).all()) if args[8] else True
            worst = max(worst, r if dead else float("inf"))
            worst_abs = max(worst_abs, a if dtype == "float64" else 0.0)
            parts.append(f"{name}: rel_err={r:.3e} dead_slots_ok={dead};")
        print(f"[kernel cm_sweep_wide {dtype} cases] " + " ".join(parts)
              + f" tol={tol[dtype]:.0e}", flush=True)
        if not worst <= tol[dtype]:
            raise RuntimeError(f"cm_sweep_wide {dtype} disagrees with its "
                               f"plain version")
        n = X.shape[0]
        for label, XT in (("k=2000", X[:, :2000].T.contiguous().to(dt)),
                          ("k=20000", X[:, :20_000].T.contiguous().to(dt)),
                          ("full width", X.T.contiguous().to(dt))):
            k = XT.shape[0]
            a = (XT, y.to(dt), torch.zeros(k, dtype=dt, device=X.device),
                 torch.zeros(n, dtype=dt, device=X.device), (XT * XT).sum(1),
                 torch.ones(k, dtype=torch.bool, device=X.device),
                 torch.arange(k, device=X.device), lam, 1, k)
            ms, call = kernel_ms(lambda: ops.cm_sweep_wide(*a), 3,
                                 "cm_wide_kernel")
            it = XT.element_size()
            bnd, by = bound_ms(k * n * it + 3 * n * it + k * (3 * it + 5),
                               4.0 * n * k, dtype)
            rows[(dtype, label)] = (ms, call, ms * 1e3 / k, bnd, by)
            plain = None
            if label == "k=20000":
                plain = time_ms(lambda: ops.cm_sweep_wide_ref(*a), 1)
                rows[(dtype, label)] += (plain,)
            print(f"[kernel cm_sweep_wide {dtype}] {label} n={n} k={k} "
                  f"epochs=1 ms={ms:.4f} call_ms={call:.4f} us_per_step="
                  f"{ms * 1e3 / k:.4f} bound_ms={bnd:.6f} ({by})"
                  + (f" plain_ms={plain:.4f}" if plain is not None else ""),
                  flush=True)
            if label == "full width" and dtype == "float64":
                warm_err = check_cm_wide_warm(a, tol[dtype])
                worst_abs = max(worst_abs, warm_err)
            del XT, a
    ms, call, us, bnd, by, plain = rows[("float64", "k=20000")]
    full = rows[("float64", "full width")]
    records["cm_sweep_wide"].update(
        max_abs_err=worst_abs, ms=ms, call_ms=call, plain_ms=plain,
        bound_ms=bnd, bound_by=by, library_ms=None, us_per_step=us,
        full_width_ms=full[0], full_width_us_per_step=full[2],
        full_width_bound_ms=full[3])


def group_results_equal(a, b):
    """Two GroupSaifResults bit for bit (every tensor field)."""
    import torch
    return (a.n_outer == b.n_outer
            and a.n_active_groups == b.n_active_groups
            and all(torch.equal(x, y) for x, y in
                    ((a.beta, b.beta), (a.gap, b.gap), (a.gidx, b.gidx),
                     (a.gmask, b.gmask), (a.beta_slots, b.beta_slots))))


def group_certify(tag, loss, X, y, res, lam, eps=GROUP_EPS):
    """A group solve is certified on the card when its gap is <= eps and
    max_g ||X_g^T theta|| <= 1 + 1e-3 at its final dual point
    (:func:`group_kkt`). Returns that KKT value."""
    gap = float(res.gap)
    kkt = group_kkt(loss, X, y, res, lam)
    if not (gap <= eps and kkt <= 1 + 1e-3):
        raise RuntimeError(f"{tag}: group solve not certified (gap "
                           f"{gap:.3e}, max group correlation {kkt:.6f})")
    return kkt


def group_walk(prep, lams, cfg, backend="auto"):
    """The session's group Path: each solve entered from the previous
    one's slots, the first cold."""
    from repro_torch.core.group import group_solve
    cur, out = None, []
    for lam in lams:
        res = group_solve(prep, float(lam), cfg, warm=cur, backend=backend)
        cur = (res.gidx, res.gmask, res.beta_slots)
        out.append(res)
    return out


def group_phase(tag, X, y, loss_name, frac, also=None):
    """``[group-ls]`` / ``[group-logit]``: ``prepare_group`` at gsize 10 on
    the card, then a Scalar at ``frac`` group-lambda_max (and one at
    ``also``, when given) and a 4-point Path (geometric, GROUP_PATH_HI ->
    frac, each point entered from the last) through ``group_solve`` under
    ``auto`` (B-n3 and no other kernel), and the Path's first
    GROUP_PLAIN_POINTS points (from a cold solve, each entered from the
    last) again under
    ``backend="torch"`` (no kernel at all; the plain burst's block step
    takes about 150 times B-n3's, so the solves further down stay on
    ``auto``): every solve certified on the
    card, the two backends' group supports equal, their outer steps and
    live groups side by side. Returns the ``auto`` runs' preparation,
    lambdas, results, launch counts and Scalar wall."""
    import numpy as np
    import repro_torch as rt
    from repro_torch.core.group import group_solve, prepare_group
    from repro_torch.kernels import ops

    loss = rt.get_loss(loss_name)
    cfg = rt.GroupSaifConfig(eps=GROUP_EPS, loss=loss_name)
    prep, t_prep = timed(lambda: prepare_group(X, y, GROUP_SIZE, cfg))
    glm = rt.group_lambda_max(loss, X, y, GROUP_SIZE)
    lam = frac * glm
    lams = (np.geomspace(GROUP_PATH_HI, frac, 4) * glm).tolist()
    print(f"[{tag}] n={X.shape[0]} p={X.shape[1]} gsize={GROUP_SIZE} "
          f"groups={X.shape[1] // GROUP_SIZE} h={prep.h} k_max={prep.k_max} "
          f"prepare_s={t_prep:.4f} group_lambda_max={glm:.6e} "
          f"lam/lam_max={frac}", flush=True)
    expect = {**{k: False for k in ops.KERNELS}, "group_bcd": True}
    ops.reset_launch_counts()
    res, wall = timed(lambda: group_solve(prep, lam, cfg))
    c_s = ops.launch_counts()
    kkt = group_certify(f"{tag}/auto", loss, X, y, res, lam)
    check_launches(f"{tag}/auto", c_s, expect)
    c_a = {k: 0 for k in c_s}
    if also is not None:
        ops.reset_launch_counts()
        res_a, wall_a = timed(lambda: group_solve(prep, also * glm, cfg))
        c_a = ops.launch_counts()
        kkt_a = group_certify(f"{tag}/auto", loss, X, y, res_a, also * glm)
        check_launches(f"{tag}/auto/{also}", c_a, expect)
        print(f"[{tag}/auto] scalar at lam/lam_max={also}: outer="
              f"{res_a.n_outer} active_groups={res_a.n_active_groups} "
              f"support_groups={len(group_support(res_a.beta))} gap="
              f"{float(res_a.gap):.3e} max_group_corr={kkt_a:.6f} wall_s="
              f"{wall_a:.4f} group_bcd_launches={c_a['group_bcd']}",
              flush=True)
    ops.reset_launch_counts()
    path, p_wall = timed(lambda: group_walk(prep, lams, cfg))
    c_p = ops.launch_counts()
    check_launches(f"{tag}/auto/path", c_p, expect)
    kkts = [group_certify(f"{tag}/auto/path", loss, X, y, r, l)
            for r, l in zip(path, lams)]
    print(f"[{tag}/auto] scalar: outer={res.n_outer} active_groups="
          f"{res.n_active_groups} support_groups="
          f"{len(group_support(res.beta))} gap={float(res.gap):.3e} eps="
          f"{GROUP_EPS:.0e} max_group_corr={kkt:.6f} wall_s={wall:.4f} "
          f"group_bcd_launches={c_s['group_bcd']}; path "
          f"{[round(l / glm, 4) for l in lams]}: outer="
          f"{[r.n_outer for r in path]} active_groups="
          f"{[r.n_active_groups for r in path]} gaps="
          f"{[float(f'{float(r.gap):.3e}') for r in path]} max_group_corr="
          f"{max(kkts):.6f} wall_s={p_wall:.4f} group_bcd_launches="
          f"{c_p['group_bcd']}", flush=True)
    head = lams[:GROUP_PLAIN_POINTS[loss_name]]
    ops.reset_launch_counts()
    plain, pl_wall = timed(lambda: group_walk(prep, head, cfg,
                                              backend="torch"))
    check_launches(f"{tag}/torch", ops.launch_counts(),
                   {k: False for k in ops.KERNELS})
    ops.reset_launch_counts()
    _, au_wall = timed(lambda: group_walk(prep, head, cfg))
    for i, (pr, ar, lam_i) in enumerate(zip(plain, path, head)):
        p_kkt = group_certify(f"{tag}/torch", loss, X, y, pr, lam_i)
        same = group_support(pr.beta) == group_support(ar.beta)
        print(f"[{tag}/torch] path point {i} ({'cold' if i == 0 else 'warm'}"
              f", lam/lam_max={lam_i / glm:.4f}): outer={pr.n_outer} (auto "
              f"{ar.n_outer}) active_groups={pr.n_active_groups} (auto "
              f"{ar.n_active_groups}) gap={float(pr.gap):.3e} "
              f"max_group_corr={p_kkt:.6f} same_group_support={same}",
              flush=True)
        if not same:
            raise RuntimeError(f"{tag}: B-n3 and the plain burst find "
                               f"different group supports")
    print(f"[{tag}/torch] {len(head)} points wall_s={pl_wall:.4f} (auto "
          f"{au_wall:.4f})", flush=True)
    DEFERRED_PROFILES.append((f"{tag}/auto", lambda: group_solve(
        prep, lam, cfg), wall, ("group_bcd_reg_kernel",
                                "group_bcd_kernel")))
    return dict(prep=prep, cfg=cfg, glm=glm, lam=lam, lams=lams,
                scalar=res, path=path, c_scalar=c_s, c_path=c_p,
                counts={k: c_s[k] + c_p[k] + c_a[k] for k in c_s},
                wall=wall,
                loss=loss)


def group_oracle_phase(X, y):
    """``[group-oracle]``: the unscreened ``solve_group_lasso_bcd`` (one
    B-n3 launch an epoch over every group, tol GROUP_EPS) on the first
    2,000 columns of the LS design at GROUP_LAM of their group-lambda_max,
    against ``group_solve`` there: the same group support. ``group_solve``
    opens at the default capacity (128 groups), which the support
    outgrows; it has to flag the overflow and grow to all 200 groups (the
    reference's engine fills its slots and runs to max_outer instead).
    Returns the oracle's launch counts."""
    import repro_torch as rt
    from repro_torch.core.group import (group_solve, prepare_group,
                                        solve_group_lasso_bcd)
    from repro_torch.kernels import ops
    Xc = X[:, :2000].contiguous()
    loss = rt.get_loss("least_squares")
    cfg = rt.GroupSaifConfig(eps=GROUP_EPS)
    prep = prepare_group(Xc, y, GROUP_SIZE, cfg)
    lam = GROUP_LAM * rt.group_lambda_max(loss, Xc, y, GROUP_SIZE)
    res, wall_s = timed(lambda: group_solve(prep, lam, cfg))
    group_certify("group-oracle/saif", loss, Xc, y, res, lam)
    k_end = res.gidx.numel()
    print(f"[group-oracle/saif] outer={res.n_outer} active_groups="
          f"{res.n_active_groups} k_max={prep.k_max} -> {k_end} "
          f"overflowed={res.overflowed} wall_s={wall_s:.3f}", flush=True)
    if not (res.n_active_groups > prep.k_max and k_end > prep.k_max):
        raise RuntimeError("group-oracle: the support did not outgrow the "
                           "default capacity, or the capacity did not grow")
    ops.reset_launch_counts()
    beta, wall = timed(lambda: solve_group_lasso_bcd(
        loss, Xc, y, lam, GROUP_SIZE, tol=GROUP_EPS, max_epochs=20_000))
    counts = ops.launch_counts()
    check_launches("group-oracle", counts,
                   {**{k: False for k in ops.KERNELS}, "group_bcd": True})
    same = group_support(beta) == group_support(res.beta)
    dmax = float((beta - res.beta).abs().max())
    print(f"[group-oracle] n={Xc.shape[0]} p={Xc.shape[1]} epochs="
          f"{counts['group_bcd']} wall_s={wall:.3f} support_groups="
          f"{len(group_support(beta))} same_support_as_group_solve={same} "
          f"max_abs_dbeta={dmax:.3e}", flush=True)
    if not same:
        raise RuntimeError("group-oracle: the oracle's group support is not "
                           "group_solve's")
    return counts


def session_group_phase(X, y, grp):
    """``[session-group]``: ``open_session(Problem(X, y,
    penalty=group(10)))`` on the card: a cold Scalar, a warm Scalar and the
    Path of ``[group-ls]``, each certified, the cold requests bit for bit
    and launch for launch their direct ``group_solve`` calls in phase 24,
    the warm Scalar bit for bit ``group_solve`` from the cold one's slots.
    Returns (the requests, results and launch counts, summed counts)."""
    import repro_torch as rt
    from repro_torch.core.group import group_solve
    from repro_torch.kernels import ops
    g = grp
    sess, t_open = timed(lambda: rt.open_session(
        rt.Problem(X=X, y=y, penalty=rt.group(GROUP_SIZE)), g["cfg"]))
    lam_w = 1.25 * g["lam"]
    reqs = [("scalar", rt.Scalar(g["lam"])),
            ("warm", rt.Scalar(lam_w, warm=True)),
            ("path", rt.Path(tuple(g["lams"])))]
    ops.reset_launch_counts()
    ref_warm = group_solve(g["prep"], lam_w, g["cfg"], warm=(
        g["scalar"].gidx, g["scalar"].gmask, g["scalar"].beta_slots))
    warm_counts = ops.launch_counts()
    out, total = [], None
    for name, req in reqs:
        ops.reset_launch_counts()
        res, wall = timed(lambda: sess.solve(req))
        c = ops.launch_counts()
        total = c if total is None else {k: total[k] + c[k] for k in c}
        if name == "path":
            same = all(group_results_equal(r, d) for r, d in
                       zip(res.results, g["path"]))
            for r, l in zip(res.results, res.lams):
                group_certify("session-group/path", g["loss"], X, y, r, l)
            want = g["c_path"]
        else:
            direct = g["scalar"] if name == "scalar" else ref_warm
            same = group_results_equal(res, direct)
            group_certify(f"session-group/{name}", g["loss"], X, y, res,
                          req.lam)
            want = g["c_scalar"] if name == "scalar" else warm_counts
        print(f"[session-group/{name}] wall_s={wall:.4f} "
              f"bitwise_direct={same} group_bcd_launches={c['group_bcd']}",
              flush=True)
        if not same:
            raise RuntimeError(f"session-group/{name}: not bit for bit its "
                               f"direct group_solve")
        if c != want:
            raise RuntimeError(f"session-group/{name}: launches {c} differ "
                               f"from the direct call's {want}")
        out.append((name, req, res, c))
    print(f"[session-group] open_s={t_open:.4f} (prepare_group once) "
          f"compile_stats={tuple(sess.compile_stats())}", flush=True)
    return out, total


def serving_group_phase(X, y, grp, first):
    """``[serving-group]``: the ``[session-group]`` requests once through
    ``open_serving`` on the same problem: every verdict ok, not degraded,
    no rung, gap-certified (gap <= eps) with ``kkt_residual == 0.0`` (no
    scalar KKT), the breaker shut; each value bit for bit and each
    request's launches equal to the session's. Returns the launch
    counts."""
    import repro_torch as rt
    from repro_torch.kernels import ops
    srv, t_open = timed(lambda: rt.open_serving(
        rt.Problem(X=X, y=y, penalty=rt.group(GROUP_SIZE)), grp["cfg"]))
    verdicts, total = [], None
    for name, req, value, c_sess in first:
        ops.reset_launch_counts()
        out, wall = timed(lambda: srv.solve(req))
        c = ops.launch_counts()
        total = c if total is None else {k: total[k] + c[k] for k in c}
        v = out.verdict
        verdicts.append(v)
        if name == "path":
            same = all(group_results_equal(a, b) for a, b in
                       zip(out.value.results, value.results))
        else:
            same = group_results_equal(out.value, value)
        print(f"[serving-group/{name}] ok={v.ok} degraded={v.degraded} "
              f"rungs={len(v.rungs)} gap={v.gap:.3e} kkt_residual="
              f"{v.kkt_residual} wall_s={wall:.4f} bitwise_session={same} "
              f"launches_equal={c == c_sess}", flush=True)
        if not (v.ok and not v.degraded and not v.rungs
                and v.gap <= GROUP_EPS and v.kkt_residual == 0.0):
            raise RuntimeError(f"serving-group/{name}: verdict {v}")
        if not same or c != c_sess:
            raise RuntimeError(f"serving-group/{name}: not the session's "
                               f"result and launches")
    check_no_breaker("serving-group", srv, verdicts)
    st = srv.stats()
    if st.retries:
        raise RuntimeError(f"serving-group: {st.retries} retries")
    print(f"[serving-group] open_s={t_open:.4f} retries=0 breaker_open="
          f"{st.breaker_open}", flush=True)
    return total


def group_block(X, y, res, gfro, lam, loss, dt, n_ep=40):
    """B-n3's inputs on a group solve's final live block, from beta = 0:
    (A, y, slot, beta0, L, lam, n_ep) in ``dt``."""
    import torch
    from repro_torch.kernels.group.ref import group_blocks
    live = torch.nonzero(res.gmask).flatten()
    L = torch.where(res.gmask, torch.clamp(
        loss.smoothness * gfro[res.gidx] ** 2, min=1e-30), 1.0).to(dt)
    return (group_blocks(X, res.gidx[live], GROUP_SIZE).to(dt), y.to(dt),
            live, torch.zeros_like(res.beta_slots, dtype=dt), L, lam, n_ep)


def group_edge_cases(dev, dt):
    """B-n3's edge shapes on gaussian designs: gsize 1, 3 and 17 (more
    than one 8-column chunk of the chunked form, a ragged last one), the
    register form's column bound and one past it (gsize 10 and 11), one
    live slot, every slot masked (z = 0, beta kept from an all-zero start), n
    at the edges of the rows a thread holds (511, 512, 513: one row or
    two; 1,023, 1,024 in the register form, 1,025 past it in the chunked
    form), 40 epochs from a small nonzero beta (a masked slot's is zeroed
    by the first epoch); least squares, and logistic at gsize 3. Then the
    chunked form (gsize 11 or n = 1,025) in each entry: logistic, one live
    slot, every slot masked, gsize 1 and 3, and three bursts of 10 epochs
    at the cells' k_max = 1,024 (815-830 live), whose shared memory passes
    48 KB in both float types. lam is 0.2 of the largest block norm of
    X^T y, a twentieth of that for logistic but at k_max = 1,024 (where
    the float32 plain version itself parts from the float64 one by 1.0e-5
    at a twentieth, the check's limit; 4.0e-6 at 0.2). The cases share one
    seeded generator, so a new one is appended."""
    import torch
    from repro_torch.kernels.group.ref import group_blocks
    g = torch.Generator().manual_seed(29)
    out = []
    for name, n, gs, k, live, loss_name, n_ep, scale in (
            ("gsize=1", 1000, 1, 64, None, "least_squares", 40, 1.0),
            ("gsize=3", 1000, 3, 40, None, "least_squares", 40, 1.0),
            ("gsize=3 logistic", 1000, 3, 40, None, "logistic", 40, 0.05),
            ("gsize=17", 1000, 17, 30, None, "least_squares", 40, 1.0),
            ("one live slot", 1000, 10, 32, 1, "least_squares", 40, 1.0),
            ("every slot masked", 1000, 10, 32, 0, "least_squares", 40,
             1.0),
            ("n=1023", 1023, 10, 32, None, "least_squares", 40, 1.0),
            ("n=1025", 1025, 10, 32, None, "least_squares", 40, 1.0),
            ("gsize=10", 1000, 10, 24, None, "least_squares", 40, 1.0),
            ("gsize=11", 1000, 11, 24, None, "least_squares", 40, 1.0),
            ("n=511", 511, 10, 24, None, "least_squares", 40, 1.0),
            ("n=512", 512, 10, 24, None, "least_squares", 40, 1.0),
            ("n=513", 513, 10, 24, None, "least_squares", 40, 1.0),
            ("n=1024", 1024, 10, 24, None, "least_squares", 40, 1.0),
            ("gsize=11 logistic", 1000, 11, 24, None, "logistic", 40,
             0.05),
            ("n=1025 logistic", 1025, 10, 32, None, "logistic", 40,
             0.05),
            ("n=1025 one live slot", 1025, 10, 32, 1, "least_squares",
             40, 1.0),
            ("n=1025 every slot masked", 1025, 10, 32, 0, "least_squares",
             40, 1.0),
            ("n=1025 gsize=1", 1025, 1, 64, None, "least_squares", 40, 1.0),
            ("n=1025 gsize=3 logistic", 1025, 3, 40, None, "logistic",
             40, 0.05),
            ("n=1025 k=1024", 1025, 10, 1024, None, "least_squares", 10,
             1.0),
            ("gsize=11 k=1024", 1000, 11, 1024, None, "least_squares",
             10, 1.0),
            ("n=1025 k=1024 logistic", 1025, 10, 1024, None, "logistic",
             10, 1.0)):
        ng = k + 7
        Xg = torch.randn(n, ng * gs, generator=g, dtype=torch.float64)
        yy = Xg[:, :5 * gs].sum(1) + torch.randn(n, generator=g,
                                                 dtype=torch.float64)
        if loss_name == "logistic":
            yy = torch.where(yy >= 0, 1.0, -1.0).to(torch.float64)
        gidx = torch.randperm(ng, generator=g)[:k]
        if live is None:
            gmask = torch.rand(k, generator=g) > 0.2
        else:
            gmask = torch.arange(k) < live
        beta = 0.01 * torch.randn(k, gs, generator=g, dtype=torch.float64)
        fro2 = (Xg * Xg).view(n, ng, gs).sum((0, 2))
        alpha = 1.0 if loss_name == "least_squares" else 0.25
        L = torch.where(gmask, alpha * fro2[gidx], 1.0)
        lam = 0.2 * float(torch.linalg.vector_norm(
            (Xg.T @ yy).view(ng, gs), dim=1).max())
        slot = torch.nonzero(gmask).flatten()
        out.append((name, (group_blocks(Xg, gidx[slot], gs).to(dev, dt),
                           yy.to(dev, dt), slot.to(dev), beta.to(dev, dt),
                           L.to(dev, dt), lam * scale, n_ep),
                    loss_name))
    return out


def check_group_bcd(X, XL, grp, records):
    """B-n3 against its plain version on the card: one 40-epoch burst from
    beta = 0 on ``[group-ls]``'s final live block in each entry (the
    logistic one with the labels sign(y) at GROUP_LAM of their group
    lambda_max), on ``[group-logit]``'s final block, and
    :func:`group_edge_cases`: beta and z within 1e-12 (float64) or 1e-5
    (float32) of the plain version's, against their own scale, each
    named with the form that ran it (the timing is
    :func:`time_group_bcd`'s)."""
    import repro_torch as rt
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.group.group import group_form
    tol = {"float64": 1e-12, "float32": 1e-5}
    g, gl = grp["ls"], grp["logit"]
    ys = torch.sign(g["prep"].y)
    lam_s = GROUP_LAM * rt.group_lambda_max(rt.get_loss("logistic"), X, ys,
                                            GROUP_SIZE)
    worst_abs = 0.0
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        parts, worst = [], 0.0
        ls_block = group_block(X, g["prep"].y, g["scalar"], g["prep"].gfro,
                               g["lam"], g["loss"], dt)
        cases = [("ls final block", ls_block, "least_squares"),
                 ("ls final block, logistic entry",
                  (ls_block[0], ys.to(dt), *ls_block[2:4],
                   0.25 * ls_block[4], lam_s, 40), "logistic"),
                 ("logit final block", group_block(
                     XL, gl["prep"].y, gl["scalar"], gl["prep"].gfro,
                     gl["lam"], gl["loss"], dt), "logistic")]
        cases += group_edge_cases(X.device, dt)
        for name, a, loss_name in cases:
            b1, z1 = ops.group_bcd(*a, loss_name=loss_name)
            b2, z2 = ops.group_bcd_ref(*a, loss_name=loss_name)
            ab, r = errs([(b1, b2), (z1, z2)])
            worst = max(worst, r)
            if dtype == "float64":
                worst_abs = max(worst_abs, ab)
            nl, gs, n = a[0].shape
            form = group_form(n, a[3].shape[0], gs, a[0].element_size())
            parts.append(f"{name} ({form}): rel_err={r:.3e};")
        print(f"[kernel group_bcd {dtype}] " + " ".join(parts)
              + f" tol={tol[dtype]:.0e}", flush=True)
        if not worst <= tol[dtype]:
            raise RuntimeError(f"group_bcd {dtype} disagrees with its plain "
                               f"version")
        del cases
    records["group_bcd"]["max_abs_err"] = worst_abs


def group_timing_block(X, y, loss_name, frac, live, n_ep=40):
    """B-n3's inputs for its timing on a group cell's design and response:
    the ``live`` groups of largest c0 (the cell's Scalar ends with as
    many), from beta = 0, at ``frac`` of the group lambda_max:
    (A, y, slot, beta0, L, lam, n_ep)."""
    import torch
    import repro_torch as rt
    from repro_torch.core.group import prepare_group
    from repro_torch.kernels.group.ref import group_blocks
    loss = rt.get_loss(loss_name)
    prep = prepare_group(X, y, GROUP_SIZE, rt.GroupSaifConfig(
        loss=loss_name))
    groups = torch.sort(prep.c0, descending=True, stable=True).indices[
        :live]
    L = torch.clamp(loss.smoothness * prep.gfro[groups] ** 2, min=1e-30)
    lam = frac * rt.group_lambda_max(loss, X, y, GROUP_SIZE)
    return (group_blocks(X, groups, GROUP_SIZE), prep.y,
            torch.arange(live, device=X.device),
            torch.zeros(live, GROUP_SIZE, dtype=X.dtype, device=X.device),
            L, lam, n_ep)


def time_group_bcd(X, XL, records):
    """B-n3's device time per launch, the call's, microseconds per block
    step, the plain version's time and the bound (float64), one 40-epoch
    burst on a block of each group cell's size (:func:`group_timing_block`,
    GROUP_TIMING_LIVE groups), and the call's time of the register form's
    copy of the blocks (``reg_layout``, made by the wrapper each launch).
    Early in the run, beside the other kernels' rows: late in a long run
    the profiler keeps no launch of it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.group.group import reg_layout
    rows = {}
    for name, Xd, y, loss_name, frac in (
            ("ls", X, group_response(X, seed=400), "least_squares",
             GROUP_LAM),
            ("logit", XL, group_response(XL, seed=401, logistic=True),
             "logistic", GROUP_LOGIT_HI)):
        a = group_timing_block(Xd, y, loss_name, frac,
                               GROUP_TIMING_LIVE[loss_name])
        A, beta0, n_ep = a[0], a[3], a[6]
        nl, gs, n = A.shape
        k, it = beta0.shape[0], A.element_size()
        ms, call = kernel_ms(lambda: ops.group_bcd(
            *a, loss_name=loss_name), 5, "group_bcd_")
        plain = time_ms(lambda: ops.group_bcd_ref(
            *a, loss_name=loss_name), 1)
        lay = time_ms(lambda: reg_layout(A), 5)
        steps = n_ep * nl
        # bytes: the live block, y and z, beta in and out, L, the slot
        # ids; operations: per step 2 fmas an element of the block and the
        # gradient of each row (the logistic exp counted as one)
        nbytes = (nl * n * gs + 2 * n + 2 * k * gs + k) * it + 4 * nl
        flops = steps * (4.0 * n * gs
                         + (1 if loss_name == "least_squares" else 5) * n)
        bnd, by = bound_ms(nbytes, flops, "float64")
        rows[name] = (ms, call, ms * 1e3 / steps, bnd, by, plain, lay)
        print(f"[kernel group_bcd float64] {name} block (the {nl} groups of "
              f"largest c0) n={n} gsize={gs} epochs={n_ep} ms={ms:.4f} "
              f"call_ms={call:.4f} us_per_step={ms * 1e3 / steps:.4f} "
              f"bound_ms={bnd:.6f} ({by}) plain_ms={plain:.2f} "
              f"reg_layout_ms={lay:.4f}", flush=True)
    ms, call, us, bnd, by, plain, lay = rows["ls"]
    lg = rows["logit"]
    records["group_bcd"].update(
        ms=ms, call_ms=call, plain_ms=plain, bound_ms=bnd, bound_by=by,
        library_ms=None, us_per_step=us, reg_layout_ms=lay,
        logistic_ms=lg[0], logistic_us_per_step=lg[2])


SHARDED_PATH = (0.8, LS_LAM, 4)      # the sharded Path: first, last, points
SHARDED_TIMEOUT_S = 120              # the two-rank phase's subprocesses


def sharded_ls_phase(X, y, lm, ls_auto, ls_counts, Yf, fl_lams, fl_res,
                     fl_wall, fl_counts, fused_ls, serial_expect,
                     fleet_expect):
    """``[sharded-ls/w1]``: an NCCL group of one rank in this process
    (a ``file://`` store in a temporary directory) and a 1-D mesh. On one
    session over phase 2's problem: a sharded Scalar at LS_LAM, a warm
    sharded Scalar, a sharded Path over SHARDED_PATH and phase 9's Fleet
    sharded; on phase 5's fused session a sharded Scalar. Each is bit for
    bit the session's unsharded answer (phase 2's and 9's results, the
    same session's warm Scalar and Path, phase 5's fused solve) with the
    same outer steps, and certified (gap <= eps, KKT <= 1e-3 lambda over
    all p). Prints each wall against the unsharded one, K1/K2 (K1b/K2b)
    launches against the unsharded run's, collectives per outer step, and
    profiles the fused one (NCCL device time, idle share).
    ``ls_counts`` / ``fl_counts``: phase 2's ``auto`` and phase 9's
    launches. Returns the launch counts of the sharded runs."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    import repro_torch as rt
    from repro_torch.distributed import comm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_group

    ls = rt.get_loss("least_squares")
    cfg = rt.SaifConfig(eps=1e-6)
    lam = LS_LAM * lm
    store = tempfile.mkdtemp(prefix="sharded-w1-")
    init_group(1, 0, store, backend="nccl")
    try:
        mesh = DeviceMesh("cuda", torch.arange(1))
        # NCCL makes its communicator at the first collective: made here,
        # so the cold sharded Scalar's wall is the solve's
        comm.all_reduce_sum(comm.feature_group(mesh),
                            torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        sess = rt.open_session(rt.Problem(X=X, y=y), cfg, mesh=mesh)
        path_lams = tuple(np.geomspace(SHARDED_PATH[0] * lm, lam,
                                       SHARDED_PATH[2]).tolist())

        def run(req):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            comm.reset_calls()
            out, wall = timed(lambda: sess.solve(req))
            return out, wall, ops.launch_counts(), dict(comm.CALLS)

        # the unsharded requests this session serves (phase 2 and 9's
        # direct calls stand for its cold Scalar and its Fleet)
        un = {"scalar": (ls_auto, WALLS["ls/auto"], ls_counts)}
        sess.solve(rt.Scalar(lam))               # its warm state
        un["scalar/warm"] = run(rt.Scalar(lam, warm=True))[:3]
        un["path"] = run(rt.Path(path_lams))[:3]
        un["fleet"] = (fl_res, fl_wall, fl_counts)
        reqs = [("scalar", rt.Scalar(lam, sharded=True), serial_expect),
                ("scalar/warm", rt.Scalar(lam, warm=True, sharded=True),
                 serial_expect),
                ("path", rt.Path(path_lams, sharded=True), serial_expect),
                ("fleet", rt.Fleet(Y=Yf, lams=fl_lams, sharded=True),
                 fleet_expect)]
        total = {k: 0 for k in ops.KERNELS}
        scans = ("screen_fused", "ub_histogram", "screen_fused_batch",
                 "ub_histogram_batch")
        for name, req, expect in reqs:
            res, wall, counts, calls = run(req)
            check_launches(f"sharded-ls/w1/{name}", counts, expect)
            for k in total:
                total[k] += counts[k]
            ref, ref_wall, ref_counts = un[name]
            if name == "path":
                same = all(results_equal(a, b) for a, b in
                           zip(res.results, ref.results))
                cells = list(zip(res.results, res.lams,
                                 [y] * len(res.lams), [None] * len(res.lams)))
                outer = sum(r.n_outer for r in res.results)
            elif name == "fleet":
                same = results_equal(res, ref)
                cells = [(res, fl_lams[i], Yf[i], i)
                         for i in range(Yf.shape[0])]
                outer = int(res.n_outer.max())
            else:
                same = results_equal(res, ref)
                cells = [(res, lam, y, None)]
                outer = res.n_outer
            worst = 0.0
            for r, l, yy, i in cells:
                beta = r.beta if i is None else r.beta[i]
                gap = float(r.gap if i is None else r.gap[i])
                kkt = float(rt.kkt_residual(ls, X, yy, beta, float(l)))
                worst = max(worst, kkt / float(l))
                if not (gap <= cfg.eps and kkt <= 1e-3 * float(l)):
                    raise RuntimeError(f"sharded-ls/w1/{name}: not "
                                       f"certified (gap {gap:.3e}, kkt "
                                       f"{kkt:.3e})")
            k12 = {k: (counts[k], ref_counts[k]) for k in scans
                   if counts[k] or ref_counts[k]}
            n_calls = sum(calls.values())
            print(f"[sharded-ls/w1/{name}] wall_s={wall:.4f} "
                  f"unsharded_wall_s={ref_wall:.4f} wall_over_unsharded="
                  f"{wall / ref_wall:.3f} bitwise_unsharded={same} "
                  f"outer={outer} max_kkt_over_lam={worst:.3e} "
                  f"launches_sharded_vs_unsharded={k12} collectives={calls} "
                  f"collectives_per_outer_step={n_calls / max(outer, 1):.2f}",
                  flush=True)
            if not same:
                raise RuntimeError(f"sharded-ls/w1/{name}: not bit for bit "
                                   f"the unsharded answer")
        total_f = sharded_fused_phase(mesh, fused_ls, serial_expect)
        for k in total:
            total[k] += total_f[k]
    finally:
        dist.destroy_process_group()
    return total


def sharded_fused_phase(mesh, fused_ls, serial_expect):
    """The sharded fused Scalar on a session over phase 5's chain problem:
    bit for bit phase 5's ``saif_fused`` (the session's unsharded
    answer), certified with b's weight 0."""
    import torch
    import repro_torch as rt
    from repro_torch.distributed import comm
    from repro_torch.kernels import ops
    X, y, parent, lam = (fused_ls["X"], fused_ls["y"], fused_ls["parent"],
                         fused_ls["lam"])
    cfg = rt.SaifConfig(eps=1e-6)
    sess = rt.open_session(rt.Problem(X=X, y=y, penalty=rt.fused(parent)),
                           cfg, mesh=mesh)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    comm.reset_calls()
    (_, res), wall = timed(lambda: sess.solve(rt.Scalar(lam, sharded=True)))
    counts = ops.launch_counts()
    check_launches("sharded-ls/w1/fused", counts,
                   {**serial_expect, "chain_suffix_sums": 0})
    Xt = sess._design.Xt
    pen = torch.ones(Xt.shape[1], dtype=Xt.dtype, device=Xt.device)
    pen[sess.config.unpen_idx] = 0.0
    kkt = float(rt.kkt_residual(rt.get_loss("least_squares"), Xt, y,
                                res.beta, lam, pen))
    same = results_equal(res, fused_ls["res"])
    print(f"[sharded-ls/w1/fused] p={X.shape[1]} wall_s={wall:.4f} "
          f"bitwise_unsharded={same} outer={res.n_outer} "
          f"gap={float(res.gap):.3e} kkt={kkt:.3e} collectives="
          f"{dict(comm.CALLS)} launches={counts}", flush=True)
    if not (same and float(res.gap) <= cfg.eps and kkt <= 1e-3 * lam):
        raise RuntimeError("sharded-ls/w1/fused: not certified or not bit "
                           "for bit the unsharded fused solve")
    # profiled here: the LS Scalar's 1e5 device activities would cost the
    # profiler's processing about a minute
    _, hot = timed(lambda: sess.solve(rt.Scalar(lam, sharded=True)))
    profile_solve("sharded-ls/w1/fused",
                  lambda: sess.solve(rt.Scalar(lam, sharded=True)), hot,
                  match=("nccl",), host_ops=True)
    return counts


def sharded_w2_phase(ls_auto, p):
    """``[sharded-ls/w2]``: two ranks under gloo, each a subprocess on
    cuda:0 (this script with ``--sharded-rank``), each with its half of
    phase 2's design, (1000, p/2) on the card, solve one sharded Scalar at
    LS_LAM; each rank's beta and outer steps must be phase 2's ``auto``
    Scalar's bits (so the ranks' replicated states agree), and both ranks
    must have launched K1 and K2 on their shards. A rank that fails or outlives SHARDED_TIMEOUT_S fails the
    phase (both are stopped)."""
    import tempfile
    import torch
    from repro_torch.kernels import ops
    store = tempfile.mkdtemp(prefix="sharded-w2-")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--p", str(p),
         "--sharded-rank", str(r), "--sharded-dir", store])
        for r in range(2)]
    try:
        for proc in procs:
            left = SHARDED_TIMEOUT_S - (time.perf_counter() - t0)
            proc.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"sharded-ls/w2: a rank outlived "
                           f"{SHARDED_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if any(proc.returncode != 0 for proc in procs):
        raise RuntimeError(f"sharded-ls/w2: ranks exited "
                           f"{[proc.returncode for proc in procs]}")
    outs = [torch.load(f"{store}/rank{r}.pt") for r in range(2)]
    beta = ls_auto.beta.cpu()
    each = [torch.equal(o["beta"], beta) and o["n_outer"] == ls_auto.n_outer
            for o in outs]
    agree = torch.equal(outs[1]["beta"], outs[0]["beta"])
    same = all(each) and agree
    for r, o in enumerate(outs):
        k = o["launches"]
        print(f"[sharded-ls/w2/rank{r}] X_local={o['x_local']} "
              f"device={o['device']} wall_s={o['wall']:.4f} "
              f"bitwise_unsharded={each[r]} "
              f"outer={o['n_outer']} screen_fused={k['screen_fused']} "
              f"ub_histogram={k['ub_histogram']} gram_sweep="
              f"{k['gram_sweep']} collectives={o['calls']}", flush=True)
        check_launches(f"sharded-ls/w2/rank{r}", k,
                       {"screen_fused": True, "ub_histogram": True,
                        "gram_sweep": True, "screen_fused_batch": False})
    print(f"[sharded-ls/w2] world=2 backend=gloo bitwise_unsharded={same} "
          f"rank1_beta_equals_rank0={agree} "
          f"outer={[o['n_outer'] for o in outs]} "
          f"unsharded_outer={ls_auto.n_outer} "
          f"unsharded_wall_s={WALLS['ls/auto']:.4f} rank0_wall_s="
          f"{outs[0]['wall']:.4f} phase_s={time.perf_counter() - t0:.1f}",
          flush=True)
    if not same:
        raise RuntimeError("sharded-ls/w2: the ranks' Scalars are not bit "
                           "for bit the unsharded auto Scalar and each "
                           "other")
    total = {k: outs[0]["launches"][k] + outs[1]["launches"][k]
             for k in ops.KERNELS}
    return total


def sharded_rank_main(rank, store, p):
    """One rank of ``[sharded-ls/w2]`` (run by :func:`sharded_w2_phase`):
    gloo over a ``file://`` store, a CPU mesh of two ranks, phase 2's
    problem on cuda:0, one sharded Scalar; saves its answer, launches and
    collectives under ``store``."""
    import torch
    import torch.distributed as dist
    import repro_torch as rt
    from repro_torch.distributed import comm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_group, make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(2, rank, store, backend="gloo")
    try:
        mesh = make_host_mesh()
        Xn, yn = simulation_data(N, p)
        X = torch.from_numpy(Xn).to("cuda")
        y = torch.from_numpy(yn).to("cuda")
        del Xn
        ls = rt.get_loss("least_squares")
        lam = LS_LAM * float(rt.lambda_max(ls, X, y))
        cfg = rt.SaifConfig(eps=1e-6)
        rt.saif(X[:, :5000].contiguous(), y, lam, cfg)   # libraries' loads
        sess = rt.open_session(rt.Problem(X=X, y=y), cfg, mesh=mesh)
        # both ranks start the timed solve together
        comm.all_reduce_sum(comm.feature_group(mesh),
                            torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        comm.reset_calls()
        res, wall = timed(lambda: sess.solve(rt.Scalar(lam, sharded=True)))
        torch.save({"beta": res.beta.cpu(), "n_outer": res.n_outer,
                    "launches": ops.launch_counts(),
                    "calls": dict(comm.CALLS), "wall": wall,
                    "x_local": tuple(sess._sharded.X_local.shape),
                    "device": str(sess._sharded.device)},
                   f"{store}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def lm_numpy_params(cfg, seed):
    """An LM parameter tree of float32 numpy arrays from a seed, by
    ``init``'s rules (N(0, 1) * fan_in^-0.5, ones for 1-D leaves, the fixed
    leaves)."""
    import numpy as np
    from repro_torch.models.lm import fixed_value, leaf_paths, param_shapes
    rng = np.random.default_rng(seed)
    out = {}
    for path, shp in leaf_paths(param_shapes(cfg)):
        a = (rng.standard_normal(shp) * shp[-2] ** -0.5 if len(shp) >= 2
             else np.ones(shp))
        fixed = fixed_value(path[-1])
        if fixed is not None:
            a = np.full(shp, fixed)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32)
    return out


def lm_numpy_batch(cfg, B, S, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "vlm":
        b["img_embed"] = 0.02 * rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        b["frames"] = 0.02 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model))
    return {k: v.astype(np.float32) if k != "tokens" else v
            for k, v in b.items()}


def lm_run(cfg, tree, batch, device):
    """The port's forward logits (B, S, V) and its decode logits (B, S, V)
    (``fill_cross_cache``, then one ``make_serve_step`` step a token) of
    ``tree`` on ``batch``, on ``device``; both returned on the host."""
    import torch
    from repro_torch import convert
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm
    params = convert.lm_params_from_numpy(tree, cfg, device=device)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    B, S = b["tokens"].shape
    serve = make_serve_step(cfg)
    with torch.inference_mode():
        hidden, _ = lm.backbone(params, b["tokens"], cfg,
                                img_embed=b.get("img_embed"),
                                frames=b.get("frames"))
        full = lm.logits_fn(params, hidden, cfg)
        st = lm.fill_cross_cache(params, cfg,
                                 lm.init_decode_state(params, cfg, B, S),
                                 img_embed=b.get("img_embed"),
                                 frames=b.get("frames"))
        dec = []
        for t in range(S):
            lg, st = serve(params, b["tokens"][:, t], st)
            dec.append(lg)
        dec = torch.stack(dec, dim=1)
    return full.cpu(), dec.cpu()


def lm_archs_phase():
    """[lm-archs]: all ten architectures at their SMOKE configs in float32,
    weights from a seed (numpy) carried across by ``lm_params_from_numpy``.
    The card's forward logits and LM_DECODE-step decode against the port's
    own CPU run of the same weights (1e-4 x scale), and the card's decode
    against its forward pass (2e-4 x scale, tests/test_archs.py's bound;
    MoE at capacity_factor 64 there, as that test runs it, and at its
    default capacity against the CPU). scale = max|CPU logits| + 1."""
    import torch
    from repro_torch.configs import ARCH_IDS, smoke_config
    for i, arch in enumerate(ARCH_IDS):
        cfg = smoke_config(arch).scaled(dtype="float32")
        tree = lm_numpy_params(cfg, seed=500 + i)
        batch = lm_numpy_batch(cfg, 2, LM_DECODE, seed=600 + i)
        t0 = time.perf_counter()
        card = lm_run(cfg, tree, batch, "cuda")
        card_s = time.perf_counter() - t0
        host = lm_run(cfg, tree, batch, "cpu")
        scale = float(host[0].abs().max()) + 1.0
        fwd_err = float((card[0] - host[0]).abs().max())
        dec_err = float((card[1] - host[1]).abs().max())
        if cfg.family == "moe":
            cfg64 = cfg.scaled(capacity_factor=64.0)
            full, dec = lm_run(cfg64, tree, batch, "cuda")
        else:
            full, dec = card
        self_scale = float(full.abs().max()) + 1.0
        self_err = float((dec - full).abs().max())
        finite = all(bool(torch.isfinite(t).all()) for t in (*card, full,
                                                            dec))
        print(f"[lm-archs/{arch}] family={cfg.family} "
              f"card_vs_cpu_fwd={fwd_err:.3e} card_vs_cpu_dec={dec_err:.3e} "
              f"(bound {1e-4 * scale:.3e}) decode_vs_forward={self_err:.3e} "
              f"(bound {2e-4 * self_scale:.3e}) scale={scale:.4f} "
              f"card_s={card_s:.2f}", flush=True)
        if not finite:
            raise RuntimeError(f"[lm-archs/{arch}] non-finite logits")
        if max(fwd_err, dec_err) > 1e-4 * scale:
            raise RuntimeError(f"[lm-archs/{arch}] the card's logits differ "
                               f"from the CPU's by {max(fwd_err, dec_err)}")
        if self_err > 2e-4 * self_scale:
            raise RuntimeError(f"[lm-archs/{arch}] decode differs from the "
                               f"forward pass by {self_err}")


def lm_hymba_phase(smi):
    """[lm-hymba/full]: the published hymba-1.5b config (32 layers, d_model
    1,600, 25 heads, GQA kv 5, window 1,024, ssm_state 16, vocab 32,001),
    ``init`` on the card from a CUDA generator. Float32, on its first
    LM_F32_LAYERS layers (views of the full-width stacks): ``backbone``
    logits of LM_BATCH sequences of LM_F32_LEN tokens, and
    ``make_serve_step`` from an empty state (s_max = LM_F32_LEN: the
    1,024-slot ring wraps) held to them at every position within 2e-4 x
    scale. bfloat16 (the config's
    dtype): ``make_prefill`` on LM_BATCH prompts of LM_PROMPT tokens (timed
    on its second call) against the float32 prefill of the same prompts
    (LM_BF16_BOUND), then LM_SERVE_STEPS greedy ``make_serve_step`` steps
    from an empty state (the reference's serving path has no cache-filling
    prefill) with every logit finite; peak memory; one prefill and
    LM_PROFILE_STEPS decode steps under torch.profiler."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.models import lm
    cfg = get_config("hymba_1_5b")
    cfg32 = cfg.scaled(dtype="float32")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in lm.leaf_paths(params))
    want = sum(math.prod(s) for _, s in lm.leaf_paths(lm.param_shapes(cfg)))
    if n_params != want:
        raise RuntimeError(f"[lm-hymba/full] {n_params} parameters, the "
                           f"config has {want}")
    print(f"[lm-hymba/full/init] params={n_params} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} heads={cfg.n_heads} kv={cfg.n_kv_heads} "
          f"window={cfg.window} vocab={cfg.vocab} "
          f"f32_master_gb={4 * n_params / 1e9:.3f} init_s={init_s:.3f}",
          flush=True)

    B, S = LM_BATCH, LM_F32_LEN
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    # the first LM_F32_LAYERS layers: views of the full-width stacks
    cut32 = cfg32.scaled(n_layers=LM_F32_LAYERS)
    p32 = {**params, "blocks": {k: v[:LM_F32_LAYERS]
                                for k, v in params["blocks"].items()}}
    serve32 = make_serve_step(cut32)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden, _ = lm.backbone(p32, toks, cut32)
        full = lm.logits_fn(p32, hidden, cut32)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        del hidden
        if not bool(torch.isfinite(full).all()):
            raise RuntimeError("[lm-hymba/full/f32] non-finite logits")
        scale = float(full.abs().max()) + 1.0
        st = lm.init_decode_state(p32, cut32, B, S)
        if st.caches["kv"].k.shape[2] != cfg.window:
            raise RuntimeError("[lm-hymba/full/f32] the KV cache is not the "
                               "window's ring")
        worst = torch.zeros(S, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(S):
            lg, st = serve32(p32, toks[:, t], st)
            worst[t] = (lg - full[:, t]).abs().max()
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        worst = worst.cpu()
        del full, st, p32
    peak32 = torch.cuda.max_memory_allocated() / 1e9
    w_all = float(worst.max())
    w_ring = float(worst[cfg.window:].max())
    print(f"[lm-hymba/full/f32] B={B} S={S} layers={LM_F32_LAYERS} of "
          f"{cfg.n_layers} forward_s={fwd_s:.4f} "
          f"decode_steps={S} decode_ms_per_step={1e3 * dec_s / S:.3f} "
          f"worst_decode_vs_forward={w_all:.4e} after_wrap={w_ring:.4e} "
          f"at_pos={int(worst.argmax())} scale={scale:.4f} "
          f"rel={w_all / scale:.3e} (bound 2e-4) peak_gb={peak32:.3f} "
          f"card=\"{smi}\"", flush=True)
    if w_all > 2e-4 * scale:
        raise RuntimeError(f"[lm-hymba/full/f32] decode differs from the "
                           f"forward pass by {w_all} (scale {scale})")
    mark(f"lm-hymba/full f32 (init, forward, decode; {LM_F32_LAYERS} "
         f"layers)")

    cfg16 = cfg
    prompts = {"tokens": torch.randint(0, cfg.vocab, (B, LM_PROMPT),
                                       generator=gen, device=dev)}
    prefill16, serve16 = make_prefill(cfg16), make_serve_step(cfg16)
    last32 = make_prefill(cfg32)(params, prompts)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefill16(params, prompts)                      # first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last16 = prefill16(params, prompts)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    WALLS["lm-hymba/prefill"] = pre_s
    d = last16.float() - last32
    rms_rel = float(d.pow(2).mean().sqrt() / last32.pow(2).mean().sqrt())
    max_rel = float(d.abs().max()) / (float(last32.abs().max()) + 1.0)
    finite = bool(torch.isfinite(last16).all())
    st = lm.init_decode_state(params, cfg16, B, LM_PROMPT + LM_SERVE_STEPS)
    tok = last16.argmax(dim=-1)
    all_finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_SERVE_STEPS):
        lg, st = serve16(params, tok, st)
        all_finite &= torch.isfinite(lg).all()
        tok = lg.argmax(dim=-1)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    finite &= bool(all_finite)
    peak16 = torch.cuda.max_memory_allocated() / 1e9
    print(f"[lm-hymba/full/bf16] B={B} prompt={LM_PROMPT} prefill_ms="
          f"{1e3 * pre_s:.3f} prefill_tokens_per_s="
          f"{B * LM_PROMPT / pre_s:.1f} "
          f"decode_steps={LM_SERVE_STEPS} decode_ms_per_step="
          f"{1e3 * serve_s / LM_SERVE_STEPS:.3f} (a step's greedy argmax and "
          f"finiteness check on the card included) last_logits_vs_f32: "
          f"rms_rel={rms_rel:.4f} max_rel={max_rel:.4f} (bound "
          f"{LM_BF16_BOUND}) finite={finite} peak_gb={peak16:.3f} "
          f"card=\"{smi}\"", flush=True)
    if not finite:
        raise RuntimeError("[lm-hymba/full/bf16] non-finite logits")
    if max(rms_rel, max_rel) > LM_BF16_BOUND:
        raise RuntimeError(f"[lm-hymba/full/bf16] prefill logits off the "
                           f"float32 ones: rms {rms_rel}, max {max_rel}")
    mark("lm-hymba/full bf16 (float32 and two bf16 prefills, decode)")

    # one prefill and LM_PROFILE_STEPS decode steps under the profiler,
    # each against its unprofiled wall (the ring cache takes the steps past
    # s_max)
    profile_solve("lm-hymba/prefill", lambda: prefill16(params, prompts),
                  pre_s)

    def steps():
        nonlocal st, tok
        for _ in range(LM_PROFILE_STEPS):
            lg, st = serve16(params, tok, st)
            tok = lg.argmax(dim=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    profile_solve("lm-hymba/decode", steps, steps_s, per=LM_PROFILE_STEPS)
    del params, st
    torch.cuda.empty_cache()


def lm_numpy_train_batch(cfg, B, S, seed):
    """``lm_numpy_batch`` with next-token labels (the tokens rolled by
    one), as the tests' batches are."""
    import numpy as np
    b = lm_numpy_batch(cfg, B, S, seed)
    b["tokens"] = b["tokens"].astype(np.int32)
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    return b


def leaf_rel(got, want):
    """{leaf name: the leaf's largest error of ``got`` against ``want``
    (trees on any devices) over ``want``'s largest entry}, in float64
    where ``want`` lies (the card, at full width)."""
    from repro_torch.tree import leaf_paths
    want = dict(leaf_paths(want))
    out = {}
    for path, g in leaf_paths(got):
        w = want[path].double()
        err = float((g.to(w.device).double() - w).abs().max())
        scale = float(w.abs().max())
        out[".".join(path)] = err / scale if scale > 0 else err
    return out


def grads_close(tag, got, want, loss_got, loss_want, own=None):
    """The loss's relative error of ``got`` against ``want`` and each
    leaf's :func:`leaf_rel`: (loss rel, worst leaf rel among the leaves
    not in ``own``, that leaf, {leaf: rel} of the leaves in ``own``).
    Raises when the loss is off by more than LM_TRAIN_LOSS_REL, or a leaf
    by more than its bound in ``own`` ({leaf name: bound}), else
    LM_TRAIN_GRAD_REL."""
    own = own or {}
    rel = leaf_rel(got, want)
    rest = {k: v for k, v in rel.items() if k not in own}
    where = max(rest, key=rest.get)
    lrel = abs(float(loss_got) - float(loss_want)) / abs(float(loss_want))
    off = [f"{k} off by {v:.3e} of its largest entry (bound "
           f"{own.get(k, LM_TRAIN_GRAD_REL)})" for k, v in rel.items()
           if v > own.get(k, LM_TRAIN_GRAD_REL)]
    if lrel > LM_TRAIN_LOSS_REL or off:
        raise RuntimeError(f"{tag}: loss {float(loss_got)} against "
                           f"{float(loss_want)}; {'; '.join(off)}")
    return lrel, rest[where], where, {k: rel[k] for k in own}


def lm_train_archs_phase():
    """[lm-train/archs]: all ten architectures at their SMOKE configs in
    float32 (TF32 off), weights and a batch (B x S = LM_TRAIN_ARCH_BS;
    vlm's img_embed, whisper's frames) from a seed. One ``make_train_step``
    step on the card and on the CPU from the same weights: the loss and the
    gradients' global norm (the step's third value), the per-leaf
    gradients (``value_and_grad``), against LM_TRAIN_LOSS_REL and
    LM_TRAIN_GRAD_REL; the updated parameters' largest difference printed
    (not gated: Adam's first step divides each gradient entry by its own
    magnitude plus eps, so an entry near zero moves by up to 2 lr on a
    difference in its last bits). On the card, microbatch 2 against 1
    with the same bounds (not for MoE: its capacity and load-balance loss
    are per call, not additive over microbatches)."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import ARCH_IDS, smoke_config
    from repro_torch.launch.steps import (TrainState, make_train_step,
                                          value_and_grad)
    from repro_torch.models.lm import leaf_paths
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    B, S = LM_TRAIN_ARCH_BS
    for i, arch in enumerate(ARCH_IDS):
        cfg = smoke_config(arch).scaled(dtype="float32")
        tree = lm_numpy_params(cfg, seed=700 + i)
        batch = lm_numpy_train_batch(cfg, B, S, seed=800 + i)
        out = {}
        for dev in ("cuda", "cpu"):
            params = convert.lm_params_from_numpy(tree, cfg, device=dev)
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            step = make_train_step(cfg, opt_cfg)
            t0 = time.perf_counter()
            new, loss, gn = step(TrainState(params, adamw.init(params)), b)
            gn = float(gn)
            step_s = time.perf_counter() - t0
            out[dev] = (loss, gn, value_and_grad(params, b, cfg)[1],
                        new.params, step_s, params, b)
        (lc, gc, grc, pc, sc, params, b), (lh, gh, grh, ph, _, _, _) = (
            out["cuda"], out["cpu"])
        lrel, grel, gwhere, _ = grads_close(f"[lm-train/archs/{arch}]",
                                            grc, grh, lc, lh)
        if abs(gc - gh) > LM_TRAIN_LOSS_REL * gh:
            raise RuntimeError(f"[lm-train/archs/{arch}] gradient norm {gc} "
                               f"on the card, {gh} on the CPU")
        pmax = max(float((p.cpu() - dict(leaf_paths(ph))[k]).abs().max())
                   for k, p in leaf_paths(pc))
        mb = ""
        if cfg.family != "moe":
            l1, g1 = value_and_grad(params, b, cfg)
            l2, g2 = value_and_grad(params, b, cfg, microbatch=2)
            mrel, mgrel, mwhere, _ = grads_close(
                f"[lm-train/archs/{arch}/microbatch]", g2, g1, l2, l1)
            mb = (f" microbatch2_vs_1: loss_rel={mrel:.2e} grad_rel="
                  f"{mgrel:.2e} ({mwhere})")
        finite = all(bool(torch.isfinite(t).all()) for _, t in leaf_paths(pc))
        print(f"[lm-train/archs/{arch}] family={cfg.family} "
              f"loss={float(lc):.6f} card_vs_cpu: loss_rel={lrel:.2e} "
              f"grad_rel={grel:.2e} ({gwhere}) grad_norm={gc:.6f} "
              f"(cpu {gh:.6f}) params_after_step_max_abs={pmax:.2e} "
              f"(bounds {LM_TRAIN_LOSS_REL}, {LM_TRAIN_GRAD_REL}){mb} "
              f"step_s={sc:.3f}", flush=True)
        if not (finite and math.isfinite(float(lc))):
            raise RuntimeError(f"[lm-train/archs/{arch}] non-finite step")


def lm_train_hymba_phase(smi):
    """[lm-train/hymba/full]: the published hymba-1.5b config (float32
    masters, bfloat16 compute, remat) from ``init_train_state`` (seed 0,
    on the card) trained by ``train_loop`` with ``make_train_step`` on
    ``TokenPipeline`` (seed 0) at LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens,
    AdamW lr 1e-3, warmup 2, LM_TRAIN_STEPS steps (the schedule's total),
    under ``torch.use_deterministic_algorithms(True)``: a straight run that
    checkpoints (``save_async``, under build/) after step LM_TRAIN_CKPT,
    then a second run resumed from that checkpoint (``train.resume``, the
    data cursor with it) whose losses and gradient norms must equal the
    straight run's bit for bit. Every loss finite, the last below the
    first. Then, from the resumed run's state: one more step under
    torch.profiler with the host's ops, ``ssm.prefix_scan`` wrapped in a
    host range, and the doubling scan's device time (its forward, the
    recomputes' forwards and its backward: :func:`range_device_us`) and
    share of the step's busy time; in float32 at LM_TRAIN_F32_BS,
    microbatch 2 against 1 (``grads_close``: A_log within
    LM_TRAIN_ALOG_REL, every other leaf LM_TRAIN_GRAD_REL), both against a
    float64 ``value_and_grad`` of the same weights and batch (A_log within
    LM_TRAIN_ALOG_REL); at 2 of its layers, remat on against off, bit for
    bit."""
    import shutil
    import statistics
    import torch
    from torch.profiler import record_function
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline, to_device
    from repro_torch.launch import train
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          value_and_grad)
    from repro_torch.models import lm, ssm
    from repro_torch.optim import adamw
    tag = "[lm-train/hymba/full]"
    cfg = get_config("hymba_1_5b")
    B, S, steps, at = (LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS,
                       LM_TRAIN_CKPT)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
    ckdir = str(ROOT / "build" / "lm_train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    step = make_train_step(cfg, opt_cfg)

    def report(label, run, first):
        for i, (loss, gn, s_) in enumerate(zip(run.losses, run.grad_norms,
                                               run.step_s)):
            print(f"{tag[:-1]}/{label}] step={first + i + 1} loss={loss!r} "
                  f"grad_norm={gn!r} ms={1e3 * s_:.1f} "
                  f"tokens_per_s={B * S / s_:.1f}", flush=True)

    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # each state is handed to the loop, not kept here: a third copy
        # of the 20 GB state would not fit beside the step's two. The
        # straight run is two loops over one pipeline, the first one
        # checkpointing at its end, the second going on from its state
        t0 = time.perf_counter()
        data = TokenPipeline(dcfg)
        run = train.train_loop(step, init_train_state(cfg, seed=0), data,
                               start=0, steps=at, ckpt_dir=ckdir,
                               ckpt_every=at, log_every=0)
        hand = [run.state]
        head = run._replace(state=None)
        del run
        run = train.train_loop(step, hand.pop(), data, start=at,
                               steps=steps, log_every=0)
        run = run._replace(losses=head.losses + run.losses,
                           grad_norms=head.grad_norms + run.grad_norms,
                           step_s=head.step_s + run.step_s)
        ckpt.wait_pending()
        straight_s = time.perf_counter() - t0
        report("straight", run, 0)
        losses, norms, step_s = run.losses, run.grad_norms, run.step_s
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_params = sum(t.numel() for _, t in lm.leaf_paths(run.state.params))
        want = sum(math.prod(s)
                   for _, s in lm.leaf_paths(lm.param_shapes(cfg)))
        if n_params != want or not cfg.remat:
            raise RuntimeError(f"{tag} {n_params} parameters (the config "
                               f"has {want}), remat {cfg.remat}")
        del run
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        data = TokenPipeline(dcfg)
        resumed, start = train.resume(ckdir, init_train_state(cfg, seed=1),
                                      data)
        hand = [resumed]
        del resumed
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        shutil.rmtree(ckdir, ignore_errors=True)
        if start != at:
            raise RuntimeError(f"{tag} resumed at step {start}, not {at}")
        rerun = train.train_loop(step, hand.pop(), data, start=start,
                                 steps=steps, log_every=0)
        report("resumed", rerun, at)
        state = rerun.state
        replay = (rerun.losses == losses[at:]
                  and rerun.grad_norms == norms[at:])
        finite = all(math.isfinite(x) for x in losses)
        wall = statistics.median(step_s[1:])
        WALLS["lm-train/hymba/step"] = wall
        print(f"{tag} params={n_params} layers={cfg.n_layers} "
              f"d_model={cfg.d_model} dtype={cfg.dtype} "
              f"param_dtype={cfg.param_dtype} remat={cfg.remat} B={B} S={S} "
              f"steps={steps} first_loss={losses[0]!r} "
              f"last_loss={losses[-1]!r} finite={finite} "
              f"resumed_at={start} replay_bitwise={replay} "
              f"median_step_ms={1e3 * wall:.1f} tokens_per_s="
              f"{B * S / wall:.1f} first_step_ms={1e3 * step_s[0]:.1f} "
              f"straight_run_s={straight_s:.2f} restore_s={restore_s:.2f} "
              f"peak_gb={peak:.3f} state_gb="
              f"{16 * n_params / 1e9:.3f} (masters, grads, m, v) "
              f"card=\"{smi}\"", flush=True)
        if not finite or not losses[-1] < losses[0]:
            raise RuntimeError(f"{tag} losses {losses}")
        if not replay:
            raise RuntimeError(f"{tag} the resumed steps {rerun.losses} "
                               f"{rerun.grad_norms} are not the straight "
                               f"run's {losses[at:]} {norms[at:]}")
        del rerun
        mark("lm-train/hymba/full (train, checkpoint, resume)")

        # one more step under the profiler (its wall: the straight run's
        # median step), the doubling scan in a host range
        batch = to_device(data.next_batch())
        scan = ssm.prefix_scan

        def ranged(*args, **kw):
            with record_function("prefix_scan"):
                return scan(*args, **kw)
        ssm.prefix_scan = ranged
        try:
            profile_solve("lm-train/hymba/step", lambda: step(state, batch),
                          wall, match=("catarraybatchedcopy",),
                          host_ops=True, ranges=("prefix_scan",))
        finally:
            ssm.prefix_scan = scan
        params = state.params
        del batch, state
        mark("lm-train/hymba/full (profiled step)")

        # float32 at full width: microbatch 2 against 1, both against a
        # float64 run
        b32, s32 = LM_TRAIN_F32_BS
        batch = to_device(TokenPipeline(DataConfig(
            vocab=cfg.vocab, seq_len=s32, global_batch=b32,
            seed=0)).next_batch())
        t0 = time.perf_counter()
        l1, g1 = value_and_grad(params, batch, cfg.scaled(dtype="float32"))
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        l2, g2 = value_and_grad(params, batch, cfg.scaled(dtype="float32"),
                                microbatch=2)
        t0 = time.perf_counter()
        l64, g64 = value_and_grad(params, batch,
                                  cfg.scaled(dtype="float64"))
        torch.cuda.synchronize()
        g64_s = time.perf_counter() - t0
        key = "blocks.A_log"
        lrel, grel, gwhere, own = grads_close(
            f"{tag[:-1]}/f32]", g2, g1, l2, l1, {key: LM_TRAIN_ALOG_REL})
        w1, w2 = leaf_rel(g1, g64), leaf_rel(g2, g64)
        del g1, g2, g64
        worst1, worst2 = max(w1, key=w1.get), max(w2, key=w2.get)
        print(f"{tag[:-1]}/f32] B={b32} S={s32} microbatch2_vs_1: "
              f"loss_rel={lrel:.2e} grad_rel={grel:.2e} ({gwhere}) "
              f"A_log={own[key]:.3e} (bounds {LM_TRAIN_LOSS_REL}, "
              f"{LM_TRAIN_GRAD_REL}, A_log {LM_TRAIN_ALOG_REL}); against "
              f"float64: microbatch1 A_log={w1[key]:.3e} worst="
              f"{w1[worst1]:.3e} ({worst1}) loss_rel="
              f"{abs(float(l1) - float(l64)) / abs(float(l64)):.2e}, "
              f"microbatch2 A_log={w2[key]:.3e} worst={w2[worst2]:.3e} "
              f"({worst2}) loss_rel="
              f"{abs(float(l2) - float(l64)) / abs(float(l64)):.2e} "
              f"value_and_grad_s={g_s:.3f} float64_s={g64_s:.3f}",
              flush=True)
        if max(w1[key], w2[key]) > LM_TRAIN_ALOG_REL:
            raise RuntimeError(f"{tag} A_log's float32 gradients part from "
                               f"the float64 one by {w1[key]:.3e} and "
                               f"{w2[key]:.3e} (bound {LM_TRAIN_ALOG_REL})")

        # 2 layers of full width: remat on against off, bit for bit
        cfg2 = cfg.scaled(n_layers=2)
        p2 = {k: ({kk: vv[:2] for kk, vv in v.items()}
                  if isinstance(v, dict) else v)
              for k, v in params.items()}
        batch = to_device(TokenPipeline(dcfg).next_batch())
        on = value_and_grad(p2, batch, cfg2)
        off = value_and_grad(p2, batch, cfg2.scaled(remat=False))
        same = bool(torch.equal(on[0], off[0])) and all(
            torch.equal(a, dict(lm.leaf_paths(off[1]))[k])
            for k, a in lm.leaf_paths(on[1]))
        print(f"{tag[:-1]}/remat] layers=2 B={B} S={S} "
              f"remat_on_vs_off_bitwise={same} loss={float(on[0])!r}",
              flush=True)
        if not same:
            raise RuntimeError(f"{tag} remat on and off differ")
        del params, on, off, p2, batch
    finally:
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()


def lm_train_cli_phase():
    """[lm-train/cli]: the trainer CLI's ``main``
    (``repro_torch.launch.train``) on the card, stablelm_3b SMOKE (B = 4,
    S = 32, lr 1e-3, a loss printed each step): 6 steps checkpointing every
    3, then resumed from that directory to 12, against a straight 12-step
    run: the resumed run restores step 6 and prints the straight run's
    last 3 losses (the reference's
    tests/test_distribution.py::test_train_resume_end_to_end; the CPU tests
    run the first through ``python -m``)."""
    import contextlib
    import io
    import shutil
    from repro_torch.launch import train
    d = ROOT / "build" / "lm_train_cli"
    shutil.rmtree(d, ignore_errors=True)
    base = ["--arch", "stablelm_3b", "--smoke", "--batch", "4", "--seq",
            "32", "--log-every", "1", "--lr", "1e-3"]

    def main(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(base + list(extra))
        if rc != 0:
            raise RuntimeError(f"[lm-train/cli] main exited {rc}")
        return buf.getvalue()

    def losses(out):
        return [ln.split()[-1] for ln in out.splitlines()
                if ln.startswith("step ")]

    t0 = time.perf_counter()
    first = main("--steps", "6", "--ckpt-dir", str(d / "a"),
                 "--ckpt-every", "3")
    resumed = main("--steps", "12", "--ckpt-dir", str(d / "a"),
                   "--ckpt-every", "3")
    straight = main("--steps", "12", "--ckpt-dir", str(d / "b"),
                    "--ckpt-every", "100")
    cli_s = time.perf_counter() - t0
    shutil.rmtree(d, ignore_errors=True)
    ok = (len(losses(first)) == 6
          and "[resume] restored step 6" in resumed
          and losses(resumed)[-3:] == losses(straight)[-3:])
    print(f"[lm-train/cli] first_run_losses={len(losses(first))} "
          f"resumed_last3={losses(resumed)[-3:]} "
          f"straight_last3={losses(straight)[-3:]} equal={ok} "
          f"wall_s={cli_s:.2f}", flush=True)
    if not ok:
        raise RuntimeError(f"[lm-train/cli] resume differs: {resumed} / "
                           f"{straight}")


def dryrun_screen_phase(smi):
    """[dryrun/saif-screen/w256|w512]: the dry-run's screen row
    (``launch/dryrun.py::lower_saif_screen``, n = 4,096, p = 2^26, h =
    64, on the production mesh of 256 and 512 ranks over a fake process
    group) beside K1 (float32) on one rank's block of it, 4,096 x p/W
    with its column norms and no pad, called as ``make_fused_screen``
    calls it: K1's device ms per launch and call ms beside the record's
    memory_s and collective_s, its plain version's time, cuBLAS's
    ``abs(theta @ X)`` and the byte bound; K1 against its plain version on
    the block's first DRYRUN_SLICE columns: tile maxima within 1e-4
    relative, candidate ids equal wherever the plain scores stand apart.
    Run beside the kernel rows, before any profile of a solve (after the
    late profiles the profiler kept none of K1's launches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (destroy_group, init_fake_group,
                                         make_production_mesh)
    n, log2_p, h = DRYRUN_SCREEN
    tol = 1e-4
    for multi in (False, True):
        world = 512 if multi else 256
        init_fake_group(world)
        try:
            rec = dryrun.lower_saif_screen(
                make_production_mesh(multi_pod=multi), n=n, log2_p=log2_p,
                h=h)
        finally:
            destroy_group()
        pl = rec["local_shape"][1]
        gen = torch.Generator(device="cuda").manual_seed(31 + world)
        X = torch.randn((n, pl), generator=gen, device="cuda")
        cn = torch.linalg.vector_norm(X, dim=0)
        pad = torch.zeros(pl, dtype=torch.bool, device="cuda")
        theta = torch.randn(n, generator=gen, device="cuda") / n
        r = 0.05
        ms, call = kernel_ms(lambda: ops.screen_fused(X, theta, cn, pad, r,
                                                      h=h),
                             20, "screen_fused_kernel")
        plain = time_ms(lambda: ops.screen_fused_ref(X, theta, cn, pad, r,
                                                     h=h), 3)
        lib = time_ms(lambda: torch.abs(theta @ X), 20)
        pb = -(-pl // 256)
        bound, by = bound_ms(4 * (n * pl + n + pl + 3 * pl)
                             + pl + pb * min(h, 256) * 8 + 4 * pb,
                             2 * n * pl, "float32")
        # against the plain version on a column slice
        S = DRYRUN_SLICE
        Xs = X[:, :S].contiguous()
        del X
        k1 = ops.screen_fused(Xs, theta, cn[:S], pad[:S], r, h=h)
        ref = ops.screen_fused_ref(Xs, theta, cn[:S], pad[:S], r, h=h)
        tmax_err = errs([(k1[5], ref[5])])[1]
        fin = torch.isfinite(ref[3])
        ids_k, ids_p = k1[4][fin].long(), ref[4][fin].long()
        swapped = ids_k != ids_p
        scale = float(ref[3][fin].abs().max())
        ids_ok = bool(((ref[0][ids_k[swapped]] - ref[0][ids_p[swapped]])
                       .abs() <= tol * scale).all())
        del Xs
        torch.cuda.empty_cache()
        mem_ms, coll_us = 1e3 * rec["memory_s"], 1e6 * rec["collective_s"]
        print(f"[dryrun/saif-screen/w{world}] mesh={rec['mesh']} "
              f"block=({n}, {pl}) float32 h={h} k1_ms={ms:.4f} "
              f"call_ms={call:.4f} record_memory_ms={mem_ms:.4f} "
              f"record_compute_ms={1e3 * rec['compute_s']:.4f} "
              f"record_collective_us={coll_us:.4f} "
              f"(gather_bytes={rec['collective_bytes']:.0f} at 450 GB/s) "
              f"k1_over_memory={ms / mem_ms:.3f} "
              f"collective_over_memory="
              f"{rec['collective_s'] / rec['memory_s']:.2e} "
              f"plain_ms={plain:.4f} library_ms(abs(theta@X))={lib:.4f} "
              f"bound_ms={bound:.4f} ({by}) slice_cols={S} "
              f"tile_max_rel_err={tmax_err:.3e} tol={tol:.0e} "
              f"ids_ok={ids_ok} (ids differing at near-ties: "
              f"{int(swapped.sum())} of {int(fin.sum())}) card=\"{smi}\"",
              flush=True)
        if not (tmax_err <= tol and ids_ok):
            raise RuntimeError(f"[dryrun/saif-screen/w{world}] K1 disagrees "
                               f"with its plain version")
        if not rec["collective_s"] < 0.01 * rec["memory_s"]:
            raise RuntimeError(f"[dryrun/saif-screen/w{world}] the gather "
                               f"is not small against the scan: {rec}")


def dryrun_hymba_main(out):
    """The [dryrun/hymba] subprocess: hymba-1.5b's records on a 1 x 1
    mesh (a fake group of one rank), host work only, on one thread;
    writes them and the wall to ``out``."""
    import torch
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (destroy_group, init_fake_group,
                                         make_host_mesh)
    # [lm-hymba/full]'s bf16 prefill and [lm-train/hymba/full]'s step
    shapes = (ShapeCfg(f"prefill_{LM_BATCH}x{LM_PROMPT}", LM_PROMPT,
                       LM_BATCH, "prefill"),
              ShapeCfg(f"train_{LM_TRAIN_BATCH}x{LM_TRAIN_SEQ}",
                       LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"))
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    init_fake_group(1)
    try:
        mesh = make_host_mesh()
        recs = [dryrun.lower_cell("hymba_1_5b", shape, mesh)
                for shape in shapes]
    finally:
        destroy_group()
    with open(out, "w") as f:
        json.dump({"records": recs, "wall_s": time.perf_counter() - t0}, f)
    return 0


def start_dryrun_hymba():
    """Start the [dryrun/hymba] subprocess (this script with
    ``--dryrun-hymba``)."""
    import atexit
    import tempfile
    out = os.path.join(tempfile.mkdtemp(prefix="dryrun-hymba-"), "r.json")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryrun-hymba", out])
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, time.perf_counter()


def dryrun_hymba_phase(started, smi):
    """[dryrun/hymba]: the dry-run records of hymba-1.5b's served prefill
    and train step at the LM phases' shapes on a 1 x 1 mesh, beside the
    prefill and the median step that [lm-hymba/full] and
    [lm-train/hymba/full] measured in this run, and the measured time over
    max(compute_s, memory_s)."""
    proc, out, t0 = started
    try:
        proc.wait(timeout=max(DRYRUN_TIMEOUT_S - (time.perf_counter() - t0),
                              1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"[dryrun/hymba] outlived {DRYRUN_TIMEOUT_S} s")
    if proc.returncode != 0:
        raise RuntimeError(f"[dryrun/hymba] exited {proc.returncode}")
    with open(out) as f:
        got = json.load(f)
    measured = {"prefill": WALLS["lm-hymba/prefill"],
                "train": WALLS["lm-train/hymba/step"]}
    for rec in got["records"]:
        kind = rec["shape"].split("_")[0]
        floor = max(rec["compute_s"], rec["memory_s"])
        print(f"[dryrun/hymba/{kind}] {json.dumps(rec)}", flush=True)
        print(f"[dryrun/hymba/{kind}] shape={rec['shape']} "
              f"flops={rec['flops']:.4e} bytes={rec['bytes']:.4e} "
              f"compute_ms={1e3 * rec['compute_s']:.3f} "
              f"memory_ms={1e3 * rec['memory_s']:.3f} "
              f"dominant={rec['dominant']} "
              f"temp_gb={rec['temp_bytes'] / 1e9:.3f} "
              f"argument_gb={rec['argument_bytes'] / 1e9:.3f} "
              f"measured_ms={1e3 * measured[kind]:.3f} "
              f"measured_over_roofline={measured[kind] / floor:.2f} "
              f"count_s={rec['compile_s']} card=\"{smi}\"", flush=True)
        if not (rec["flops"] > 0 and rec["bytes"] > 0
                and math.isfinite(floor)):
            raise RuntimeError(f"[dryrun/hymba/{kind}] record {rec}")
    print(f"[dryrun/hymba] host_wall_s={got['wall_s']:.1f} (a subprocess "
          f"on one thread beside [lm-train/hymba/full]) waited_s="
          f"{time.perf_counter() - t0:.1f} since its start", flush=True)


def dp_rank_main(rank, store):
    """One rank of [lm-train/dp2] (run by :func:`lm_train_dp_phase`): gloo
    over a ``file://`` store, stablelm_3b SMOKE in float32 on cuda:0,
    ``DataParallel`` over the (data=2, model=1) host mesh, DP_STEPS steps
    of ``train_loop``; saves the losses, the step seconds, the gathered
    parameters and its moment slices' bytes under ``store``."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import (destroy_group, init_group,
                                         make_host_mesh)
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import adamw
    from repro_torch.tree import leaf_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(2, rank, store, backend="gloo")
    try:
        cfg = smoke_config("stablelm_3b").scaled(dtype="float32")
        B, S = DP_BATCH
        dp = train.DataParallel(make_host_mesh(), cfg)
        state = dp.shard_state(init_train_state(cfg, seed=0,
                                                device="cuda"))
        data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                        global_batch=B, seed=0))
        opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                total_steps=DP_STEPS)
        run = train.train_loop(make_train_step(cfg, opt, dp=dp),
                               state, data, start=0, steps=DP_STEPS,
                               log_every=0, dp=dp)
        torch.save({"losses": run.losses, "step_s": run.step_s,
                    "params": {k: t.cpu() for k, t in
                               leaf_paths(run.state.params)},
                    "moment_bytes": moment_bytes(run.state.opt)},
                   f"{store}/dp{rank}.pt")
    finally:
        destroy_group()
    return 0


def moment_bytes(opt):
    """The bytes of an AdamW state's m and v (one rank's slices)."""
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size()
               for t in leaves(opt.m) + leaves(opt.v))


def lm_train_dp_phase():
    """[lm-train/dp2]: the trainer's data parallelism with ZeRO-1 on two
    gloo ranks, subprocesses of this script on cuda:0 (``--dp-rank``),
    against one rank's ``make_train_step`` run on the card at the same
    global batch (DP_BATCH, DP_STEPS steps, the same seeded weights and
    pipeline): losses within DP_REL relative, each parameter leaf within
    DP_REL by its norm (its largest entry's difference printed); step ms
    and each rank's ZeRO-1 moment bytes beside the one rank's."""
    import tempfile
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import adamw
    from repro_torch.tree import leaf_paths
    store = tempfile.mkdtemp(prefix="dp2-")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--dp-rank", str(r), "--dp-dir", store])
             for r in range(2)]
    try:
        # the one-rank run meanwhile
        cfg = smoke_config("stablelm_3b").scaled(dtype="float32")
        B, S = DP_BATCH
        one = train.train_loop(
            make_train_step(cfg, adamw.AdamWConfig(
                lr=1e-3, warmup_steps=1, total_steps=DP_STEPS)),
            init_train_state(cfg, seed=0, device="cuda"),
            TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                     global_batch=B, seed=0)),
            start=0, steps=DP_STEPS, log_every=0)
        for proc in procs:
            left = DP_TIMEOUT_S - (time.perf_counter() - t0)
            proc.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"[lm-train/dp2] a rank outlived {DP_TIMEOUT_S} "
                           f"s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if any(proc.returncode != 0 for proc in procs):
        raise RuntimeError(f"[lm-train/dp2] ranks exited "
                           f"{[proc.returncode for proc in procs]}")
    outs = [torch.load(f"{store}/dp{r}.pt") for r in range(2)]
    want = dict(leaf_paths(one.state.params))
    one_moments = moment_bytes(one.state.opt)
    ok = True
    for r, o in enumerate(outs):
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(o["losses"], one.losses))
        norm_rel = ent_rel = 0.0
        for k, t in o["params"].items():
            w = want[k].cpu().double()
            d = t.double() - w
            norm_rel = max(norm_rel, float(d.norm() / w.norm()))
            ent_rel = max(ent_rel, float(d.abs().max() / w.abs().max()))
        ok &= loss_rel <= DP_REL and norm_rel <= DP_REL
        print(f"[lm-train/dp2/rank{r}] losses={o['losses']} "
              f"loss_rel={loss_rel:.2e} param_norm_rel={norm_rel:.2e} "
              f"param_entry_rel={ent_rel:.2e} (bound {DP_REL:.0e}) "
              f"step_ms={[round(1e3 * x, 2) for x in o['step_s']]} "
              f"zero1_moment_bytes={o['moment_bytes']}", flush=True)
    print(f"[lm-train/dp2] world=2 backend=gloo device=cuda:0 B={B} S={S} "
          f"steps={DP_STEPS} one_rank_losses={one.losses} "
          f"one_rank_step_ms={[round(1e3 * x, 2) for x in one.step_s]} "
          f"one_rank_moment_bytes={one_moments} equal_within_bound={ok} "
          f"phase_s={time.perf_counter() - t0:.1f}", flush=True)
    if not ok:
        raise RuntimeError("[lm-train/dp2] the ranks' run parts from one "
                           "rank's")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=100_000,
                    help="features of phases 2-4; cut it for a quick "
                         "shakedown")
    # one rank of [sharded-ls/w2], started by sharded_w2_phase
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-dir", default=None, help=argparse.SUPPRESS)
    # [dryrun/hymba]'s subprocess and the ranks of [lm-train/dp2]
    ap.add_argument("--dryrun-hymba", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch as rt
        from repro_torch.kernels import _build, ops
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sharded_rank is not None:
        return sharded_rank_main(args.sharded_rank, args.sharded_dir, args.p)
    if args.dryrun_hymba is not None:
        return dryrun_hymba_main(args.dryrun_hymba)
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, args.dp_dir)
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t_start = time.perf_counter()
    MARKS[:] = [t_start, t_start]
    secs = _build.build()
    print(f"[build] nvcc, {len(_build.SOURCES)} sources in parallel: "
          f"{secs:.1f} s", flush=True)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    Xn, yn, beta_true = simulation_data(N, args.p, with_beta=True)
    X = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn).to(dev)
    Ln, yl = logistic_data(N, args.p)
    XL = torch.from_numpy(Ln).to(dev)
    yL = torch.from_numpy(yl).to(dev)
    del Xn, Ln
    print(f"[data] LS and logistic X ({N}, {args.p}) float64 on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    mark("build and data")

    plain_lasso = {"cm_burst_pen": False, "chain_suffix_sums": False,
                   "screen_fused_batch": False, "ub_histogram_batch": False,
                   "cm_burst_batch": False, "cm_epochs": False,
                   "gram_sweep_batch": False, "screen_fused_mixed": False,
                   "screen_fused_batch_mixed": False}
    on = {"screen_fused": True, "ub_histogram": True, **plain_lasso}
    ls = rt.get_loss("least_squares")
    lm = float(rt.lambda_max(ls, X, y))
    lam = LS_LAM * lm
    cfg = rt.SaifConfig(eps=1e-6)
    # least squares under auto takes the Gram engine (K6), as the
    # reference does; the explicit cuda run keeps K3 measured. One small
    # solve each first (uncounted): a process's first solve on a path pays
    # the libraries' loads and the handles' set-up, which would bias the
    # walls of whichever run came first
    for inner in ("auto", "cuda"):
        rt.saif(X[:, :5000].contiguous(), y, lam, rt.SaifConfig(
            eps=1e-6, inner_backend=inner))
    torch.cuda.synchronize()
    ls_res, ls_counts = solve_phase(
        "ls", lam, cfg,
        {"auto": {},
         "cuda": {"inner_backend": "cuda"},
         "plain": {"screen_backend": "torch", "inner_backend": "torch"}},
        {"auto": {**on, "cm_burst": False, "gram_sweep": True},
         "cuda": {**on, "cm_burst": True, "gram_sweep": False},
         "plain": {k: False for k in ops.KERNELS}},
        lambda c: rt.saif(X, y, lam, c),
        lambda r: rt.kkt_residual(ls, X, y, r.beta, lam),
        profiled=("auto",))

    lg = rt.get_loss("logistic")
    lmL = float(rt.lambda_max(lg, XL, yL))
    lamL = LOGIT_LAM * lmL
    cfgL = rt.SaifConfig(eps=1e-6, loss="logistic")
    lg_res, lg_counts = solve_phase(
        "logistic", lamL, cfgL, {"auto": {}},
        {"auto": {**on, "cm_burst": True, "gram_sweep": False}},
        lambda c: rt.saif(XL, yL, lamL, c),
        lambda r: rt.kkt_residual(lg, XL, yL, r.beta, lamL),
        profiled=("auto",))

    records = {
        "screen_fused": {"name": "screen_fused", "route": "cuda",
                         "source": "src/repro_torch/csrc/screen.cu",
                         "replaces": "src/repro/kernels/screen/screen.py:271"},
        "ub_histogram": {"name": "ub_histogram", "route": "cuda",
                         "source": "src/repro_torch/csrc/screen.cu",
                         "replaces": "src/repro/kernels/screen/screen.py:512"},
        "cm_burst": {"name": "cm_burst", "route": "cuda",
                     "source": "src/repro_torch/csrc/cm_burst.cu",
                     "replaces": "src/repro/kernels/cm/cm.py:355"},
        "cm_burst_pen": {"name": "cm_burst_pen", "route": "cuda",
                         "source": "src/repro_torch/csrc/cm_burst.cu",
                         "replaces": "src/repro/kernels/cm/cm.py:184"},
        "chain_suffix_sums": {"name": "chain_suffix_sums", "route": "cuda",
                              "source": "src/repro_torch/csrc/chain_suffix.cu",
                              "replaces": "src/repro/kernels/fused/fused.py:76"},
        "screen_fused_batch": {
            "name": "screen_fused_batch", "route": "cuda",
            "source": "src/repro_torch/csrc/screen.cu",
            "replaces": "src/repro/kernels/screen/screen.py:394"},
        "ub_histogram_batch": {
            "name": "ub_histogram_batch", "route": "cuda",
            "source": "src/repro_torch/csrc/screen.cu",
            "replaces": "src/repro/kernels/screen/screen.py:562"},
        "cm_burst_batch": {
            "name": "cm_burst_batch", "route": "cuda",
            "source": "src/repro_torch/csrc/cm_burst.cu",
            "replaces": "src/repro/kernels/cm/cm.py:296"},
        "cm_epochs": {"name": "cm_epochs", "route": "cuda",
                      "source": "src/repro_torch/csrc/cm_epochs.cu",
                      "replaces": "src/repro/kernels/cm/cm.py:106"},
        "gram_sweep": {"name": "gram_sweep", "route": "cuda",
                       "source": "src/repro_torch/csrc/gram_sweep.cu",
                       "replaces": "src/repro/core/cm.py:126"},
        "gram_sweep_batch": {
            "name": "gram_sweep_batch", "route": "cuda",
            "source": "src/repro_torch/csrc/gram_sweep.cu",
            "replaces": "src/repro/core/cm.py:126"},
        "cm_sweep_wide": {"name": "cm_sweep_wide", "route": "cuda",
                          "source": "src/repro_torch/csrc/cm_wide.cu",
                          "replaces": "src/repro/core/cm.py:66"},
        # K1b's mixed mode (the certified screen of parity="fast"), and K6b
        # sweeping the fast fleet's slot range in slot order
        **{f"screen_fused_batch_{short}": {
            "name": f"screen_fused_batch ({mode} in, float32 sums; "
                    f"{'wgmma' if short == 'bf16' else 'fma'})",
            "route": "cuda", "source": "src/repro_torch/csrc/screen.cu",
            "replaces": "src/repro/kernels/screen/screen.py:394 "
                        "(in_dtype/acc_dtype)"} for mode, short in MIXED},
        "gram_sweep_batch_lockstep": {
            "name": "gram_sweep_batch (lockstep, identity order)",
            "route": "cuda", "source": "src/repro_torch/csrc/gram_sweep.cu",
            "replaces": "src/repro/core/batch.py:586"},
        "group_bcd": {"name": "group_bcd", "route": "cuda",
                      "source": "src/repro_torch/csrc/group_bcd.cu",
                      "replaces": "src/repro/core/group.py:165"},
    }

    mark("serial solves (phases 1-2)")
    k4_launches = transform_phase(X, records)
    fused, fused_counts, fused_ls = fused_phases()
    mark("fused (phases 3-5)")

    import numpy as np
    # serial solves: K1 + K2 + K6 for least squares (auto), K3 for logistic
    serial_k3 = {"screen_fused": True, "ub_histogram": True,
                 "cm_burst": True, "screen_fused_batch": False,
                 "ub_histogram_batch": False, "cm_burst_batch": False,
                 "gram_sweep": False, "gram_sweep_batch": False,
                 "screen_fused_mixed": False,
                 "screen_fused_batch_mixed": False}
    serial_ls = {**serial_k3, "cm_burst": False, "gram_sweep": True}
    fleet_k3 = {"screen_fused": False, "ub_histogram": False,
                "cm_burst": False, "cm_burst_pen": False,
                "chain_suffix_sums": False, "screen_fused_batch": True,
                "ub_histogram_batch": True, "cm_burst_batch": True,
                "cm_epochs": False, "gram_sweep": False,
                "gram_sweep_batch": False, "screen_fused_mixed": False,
                "screen_fused_batch_mixed": False}
    # least-squares fleets (weighted or not): K1b + K2b + the Gram sweep K6b
    fleet_ls = {**fleet_k3, "cm_burst_batch": False,
                "gram_sweep_batch": True}
    Yf = fleet_responses(X, FLEET_LS[2], seed=100)
    fracs = np.geomspace(FLEET_LS[0], FLEET_LS[1], FLEET_LS[2]).tolist()
    fl_res, fl_lams, fl_counts, fl_h, fl_wall = fleet_phase(
        "fleet-ls", X, Yf, fracs, "least_squares", serial_ls, fleet_ls)
    # the explicit cuda fleet keeps K3b measured, bitwise its K3 serials;
    # its final active blocks are the K1b/K2b/K3b checks' inputs
    flc_res, flc_lams, flc_counts, flc_h, _ = fleet_phase(
        "fleet-ls/cuda", X, Yf, fracs, "least_squares", serial_k3, fleet_k3,
        inner_backend="cuda")
    YL = fleet_responses(XL, FLEET_LOGIT[2], seed=200, logistic=True, k=40)
    fracsL = np.geomspace(FLEET_LOGIT[0], FLEET_LOGIT[1],
                          FLEET_LOGIT[2]).tolist()
    _, _, flg_counts, _, _ = fleet_phase(
        "fleet-logistic", XL, YL, fracsL, "logistic", serial_k3, fleet_k3)
    pick = [0, FLEET_LS[2] - 1]
    plain_fleet_phase(X, Yf[pick], [fl_lams[i] for i in pick],
                      fl_res.beta[pick])
    mark("fleets")

    # the fast-parity fleet in each screen dtype (TF32 would break the
    # float32 sums' rounding bound of the plain products)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the certified f32 bound needs it off")
    fast_k1b = {**fleet_ls, "screen_fused_batch": True,
                "screen_fused_batch_mixed": False}
    fast_mixed = {**fleet_ls, "screen_fused_batch_mixed": True}
    del fast_mixed["screen_fused_batch"]        # escalations run K1b
    fast = {}
    for mode in ("working", "float32", "bfloat16"):
        fast[mode] = fast_fleet_phase(
            X, Yf, fl_lams, mode, fl_res, fl_wall,
            fast_k1b if mode == "working" else fast_mixed)

    mark("fast fleets")
    ycv = fleet_responses(X, 1, seed=300)[0]
    cv, cv_lams, cv_counts, cv_lm = cv_phase(X, ycv, fleet_ls, serial_ls)
    # select_solve's refit is the serial solve (K1/K2/K6)
    sel_expect = {**fleet_ls, "screen_fused": True, "ub_histogram": True,
                  "gram_sweep": True}
    sel_counts, W_sel, sel_rep = select_phase(
        X, ycv, cv_lams, cv_lm, true_features(args.p, 300), sel_expect)
    # fast parity: the CV fleets (fast preparation, bitwise engine) run
    # K1b; the subsample fleet the lockstep engine with K1b's bf16 mode
    self_counts, _, _ = select_phase(
        X, ycv, cv_lams, cv_lm, true_features(args.p, 300),
        {**sel_expect, "screen_fused_batch_mixed": True}, tag="select/fast",
        bit=sel_rep, parity="fast", screen_dtype="bfloat16")
    mark("cv and select")
    weighted_logistic_phase(XL, yL)
    k5_counts = cm_epochs_phase(X, y, lam, ls_res["auto"])
    mark("weighted logistic and cm-epochs")

    from repro_torch.core.saif import add_batch_size_static, prepare_path
    prep = prepare_path(X, y, cfg)
    h = add_batch_size_static(cfg.c, lam, prep.c0_max, prep.c0_median,
                              args.p)
    del prep
    h_cv = cv_screen_h(X, ycv, cv_lams)
    from repro_torch.kernels.screen.screen import empty_launch
    floor, floor_call = kernel_ms(empty_launch, 200, "empty_kernel")
    print(f"[launch-floor] an empty kernel (one CTA of 32 threads): "
          f"device_ms={floor:.5f} call_ms={floor_call:.5f}", flush=True)
    for dtype in ("float64", "float32"):
        check_kernels(dtype, X, y, lam, h, ls_res["cuda"], (XL, yL, lamL),
                      lg_res["auto"], fused, records)
        check_fleet_kernels(dtype, X, Yf, flc_lams, flc_h, flc_res,
                            "least_squares", records, Wn=W_sel)
        check_screen_cv_shape(dtype, X, cv, h_cv)
        tie_probe(dtype)
        check_gram_sweep(dtype, X, y, lam, ls_res["auto"], cv, records)
        mark(f"kernel checks {dtype}")
    check_mixed_scans(X, records)
    check_gram_lockstep(fast["working"][0], fl_lams, records)
    check_cm_epochs(X, y, lam, ls_res["auto"], records)
    check_cm_wide(X, y, lam, XL, yL, lamL, records)
    time_group_bcd(X, XL, records)
    mark("mixed, lockstep, cm-epochs, wide checks and B-n3's timing")
    # the dry-run's screen row (phase 31): K1 beside the kernel rows,
    # before any profile of a solve (after them the profiler has kept
    # none of K1's launches)
    dryrun_screen_phase(smi)
    mark("dryrun/saif-screen")
    run_deferred_profiles()
    mark("profiles")

    base_counts = baselines_phase(X, y, lam, lm, ls_res["auto"].beta,
                                  WALLS["ls/auto"])
    mark("baselines")
    # the Session front door at full width, on the engines above; last, so
    # that the kernel rows' short profiler sessions run in a younger
    # process (the profiler misses launches late in a run)
    _, sess_counts, sess_first = session_ls_phase(
        X, y, lm, ls_res["auto"], Yf, fl_lams, fl_res, fl_wall, serial_ls,
        fleet_ls)
    sess_counts = [sess_counts,
                   session_pad_phase(X, y, lm, ls_res["auto"], Yf, fl_lams,
                                     fl_res, serial_ls, fleet_ls),
                   session_cache_phase(X, y, lm, ls_res["auto"], serial_ls),
                   session_fused_phase(fused_ls),
                   # the fault-tolerant serving runtime (phase 21)
                   serving_ls_phase(X, y, sess_first, serial_ls, fleet_ls),
                   serving_drill_phase(X, y, lm, ls_res["auto"], serial_ls),
                   # online row updates and the async front end (22, 23)
                   online_ls_phase(X, y, lm, beta_true, serial_ls),
                   server_ls_phase(X, Yf, fl_lams, fl_res, fl_wall,
                                   fleet_ls)]
    mark("session, serving, online, server")
    # feature-sharded SAIF: one NCCL rank in this process, then two gloo
    # ranks sharing the card
    sess_counts += [
        sharded_ls_phase(X, y, lm, ls_res["auto"], ls_counts["auto"], Yf,
                         fl_lams, fl_res, fl_wall, fl_counts, fused_ls,
                         serial_ls, fleet_ls),
        sharded_w2_phase(ls_res["auto"], args.p)]
    mark("sharded (w1 nccl, w2 gloo)")
    # the group LASSO (phases 24-27): B-n3 on both designs, the oracle,
    # the session and serving, then B-n3 against its plain version
    grp = {"ls": group_phase("group-ls", X, group_response(X, seed=400),
                             "least_squares", GROUP_LAM),
           "logit": group_phase("group-logit", XL,
                                group_response(XL, seed=401, logistic=True),
                                "logistic", GROUP_LOGIT_LAM,
                                also=GROUP_LOGIT_HI)}
    mark("group-ls and group-logit")
    yg = grp["ls"]["prep"].y
    sg_first, sg_counts = session_group_phase(X, yg, grp["ls"])
    sess_counts += [grp["ls"]["counts"], grp["logit"]["counts"],
                    group_oracle_phase(X, yg), sg_counts,
                    serving_group_phase(X, yg, grp["ls"], sg_first)]
    mark("group oracle, session and serving")
    check_group_bcd(X, XL, grp, records)
    mark("group_bcd checks")
    fast_counts = [c for _, c, _ in fast.values()]
    runs = [ls_counts["auto"], ls_counts["cuda"], lg_counts["auto"],
            *fused_counts, fl_counts, flc_counts, flg_counts, *fast_counts,
            cv_counts, sel_counts, self_counts, k5_counts, base_counts,
            *sess_counts]
    for k, rec in records.items():
        if k in ops.KERNELS:
            rec["launches"] = sum(c[k] for c in runs) + (
                k4_launches if k == "chain_suffix_sums" else 0)
    records["screen_fused_batch_bf16"]["launches"] = (
        fast["bfloat16"][1]["screen_fused_batch_mixed"]
        + self_counts["screen_fused_batch_mixed"])
    records["screen_fused_batch_f32"]["launches"] = (
        fast["float32"][1]["screen_fused_batch_mixed"])
    records["gram_sweep_batch_lockstep"]["launches"] = sum(
        c["gram_sweep_batch"] for c in fast_counts)

    run_deferred_profiles()
    mark("late profiles")
    # the LM scaffold last: it launches none of the kernels above, and
    # after its profiles the profiler kept none of K1's launches in the
    # kernel rows' sessions
    lm_archs_phase()
    mark("lm-archs")
    lm_hymba_phase(smi)
    mark("lm-hymba/full")
    lm_train_archs_phase()
    mark("lm-train/archs")
    # hymba's records are host work on one core, counted beside the
    # training's device-bound steps (busy 0.97 of their wall) and read
    # before the next phase, so that nothing host-bound is timed beside it
    counting = start_dryrun_hymba()
    lm_train_hymba_phase(smi)
    mark("lm-train/hymba/full")
    dryrun_hymba_phase(counting, smi)
    mark("dryrun/hymba")
    lm_train_cli_phase()
    mark("lm-train/cli")
    lm_train_dp_phase()
    mark("lm-train/dp2")

    print(f"[smoke] total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
