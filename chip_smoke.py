"""Drive the PyTorch/CUDA port (varanneal_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; nothing is installed first. Phases, each
timed on its own line:

1. device: the card's name, count, power limit, the torch and nvcc
   versions; no CUDA device -> exit 1 before any result is printed;
2. build: K1 and K4 (kernels/csrc/ag_kernel.cu), K2/K3
   (kernels/csrc/solve_kernel.cu), K7a/K7b (kernels/csrc/dir_kernel.cu),
   K6 (kernels/csrc/fe_kernel.cu), K5 (kernels/csrc/agt_kernel.cu) and
   K8 (kernels/csrc/pack_kernel.cu), one nvcc each, started together,
   into plain-C shared libraries, with nvcc's -Xptxas -v report
   (registers, spills, shared memory); with them a measuring build of
   solve_kernel.cu that counts the group barriers its kernels pass
   (-DVA_COUNT_BARRIERS; phase 9);
3. K1 against its plain PyTorch version on the card at the main path's
   shape (Lorenz-96 D=20, N=161, L=8, B=4; data-informed draws from numpy
   seed 0; rf at β = 0, 50, 100) and at BASELINE config #5's width (D=400,
   160 observed, B=4, β 0, 25, 50): f64 to 1e-12 and f32 to 2e-5
   relative; then 1000 launches each of the kernel, the plain version and
   the autograd action's value+grad, timed with CUDA events, and the
   kernel at D=400;
4. an f64 5-rung ladder (F64_RUNGS; B=2, from near the twin's truth,
   rf0 = RM, every rung solved to pgtol 1e-8) through the kernel and
   through the plain version: the action at every mutually converged
   rung must agree to 1e-8 relative;
5. the main path, as bench.py runs BASELINE config #1 with
   BENCH_SOLVER=xla BENCH_ENGINE=ag: 101 f32 rungs (α=1.5, rf0=4e-6·RM,
   m=5, maxiter 500, maxls 20, pgtol 1e-4, ftol 1e-6) over 4 members
   from random_ensemble_inits(seed=3), ``direction`` left at ``auto``,
   which on the card resolves to the fused loop (K1 an evaluation, K7b
   an iteration; phase 11 holds its counts and runs its 20-rung f64
   tail). The kernels' launch counts are zeroed just before and read
   just after the f32 ladder: every evaluation of every rung rides one
   K1 launch, so its count must reach, per rung, the most evaluations
   any member made;
6. K1 against its plain version on the main path's own minimizers (rungs
   0, 60, 100), where the gradient is a small difference of large terms
   and the top rungs' residuals are f32 round-off: the kernel's error
   against f64 at the minimizer, for A and for the gradient, within 4x
   the plain f32 version's, whose error is taken as its median over 24
   f32 neighbours of the minimizer (every entry moved by up to 2 ulps:
   at the top rungs one point's error is one draw of f32 round-off; the
   plain version's at the point and the kernel's median are printed)
   (the max abs kernel-vs-plain error goes into the kernel line),
   and the first 50 iterations of rung 60 again under torch.profiler
   through the compact loop (``direction='compact'``, the plain
   direction): device busy share, K1's share of the wall time, the
   costliest device kernels;
7. K2 and K3 against their plain versions in f64 at the main shape
   (phase 3's draws): short solves (maxiter 30, m=5, pgtol 1e-4, ftol
   1e-6, rf at β = 0, 50, 100) through K2, through K3 with one rung and
   through the plain version: identical niter, nfev and status per
   member, x within 1e-8 relative; then phase 4's f64 5-rung ladder
   (4 members) through K3, through K2 via the ladder's rung_solver hook
   and through the plain ladder: A within 1e-8 relative at every
   mutually converged rung; K2 and K3 launched twice give the same bits;
8. the same short solves in f32: identical niter, nfev and status per
   member, and every member's f within 1e-4 relative of the plain
   version's, or, where the plain version itself moves further under
   another summation order (the top rungs, whose action is f32
   round-off), within twice what it moves: the plain version on the CPU
   is that witness (f32 iterates are not compared); K2, K3 (the three
   rungs warm-started in one launch) and their plain versions timed on
   them; the layouts kernels/solve.plan_layout gives at the main shape
   (f32 and f64, with and without the box), each held to the shared
   memory the kernel computes for it, and the built K2/K3 kernels'
   registers and local memory (cudaFuncGetAttributes); K2 on these
   solves at B=4 and at B=264 (two members an SM) in the planner's, the
   global and the on-chip layout, printed and not held; then K2 and K3
   short solves at config #5's width (D=400, B=4, maxiter 30, β 0, 25,
   50) against the plain version on the card: identical niter, nfev and
   status, f64 x within 1e-8, f32 f within the gate above;
9. the new path, bench.py's default as the port runs it
   (varanneal_tpu_torch.bench.main, BENCH_SOLVER=ladder, B=4 from
   random_ensemble_inits(seed=3), member 0 being bench.py's single
   init): launch counts zeroed before, then exactly one K3 launch per
   ladder call and no K1 launch during the f32 ladders; records (4, 101)
   and finite; final_A_tail64 of member 0 within 1e-2 relative of
   16.284792 (JAX on a TPU v5e, an accuracy anchor); then the same with
   BENCH_SOLVER=fused (101 K2 launches per call), whose f32 ladder must
   equal K3's bit for bit, so it runs no f64 tail of its own (the tail
   would repeat K3's); each K2 launch of the fused run is timed by CUDA
   events around it (K2's time a launch on its path, and over the
   slowest member's nfev of each rung, its time an evaluation). Before
   both, one K3
   ladder call of that path (the same inputs, outside the counted runs)
   is timed by CUDA events and run under torch.profiler, in a child
   process (``chip_smoke.py --profile-k3``): the device's busy share and
   K3's device time. After both, K3's 101-rung ladder and the fused
   path's 101 warm-started K2 launches run again on the bench's inputs
   through the barrier-counting build, which must give the shipped
   build's bits: its count of group barriers over the members'
   iterations is each kernel's barriers_per_iteration (measured); and K2
   at maxiter 0 (one evaluation and one reduction a member) must count
   2 group barriers for the evaluation;
10. K7a and K7b (one cluster of blocks a member, kernels/dir.py's
   cluster_plan) against their plain versions in f32 at the main path's
   n_dof (3,221; 7 blocks a member) and at n = 32,768 (8 blocks, every
   fifth pair), m=5 and m=7, four members a launch, every (head, hlen)
   of the circular history: the direction within 2e-5 of its max|d|
   (tests/test_dir_pallas.py's bound for the Pallas step kernel) or, where
   larger, twice the plain f32 version's own error against f64 on the same
   inputs, but never more than 7.2e-5 (at n = 3,221 and m = 7 that error
   reaches 3.5e-5 of max|d|, 4x the elementwise 2e-6 + 2e-5·|d| the
   Pallas direction test uses at n = 37; tests/test_torch_dir.py holds it
   under 3.6e-5; how many directions pass that elementwise bound is
   printed),
   history rows and max|g| within 1e-6 relative, Σ|g| within 1e-5,
   good/head/hlen exact, a
   member with run = 0 left bit-identical, repeats bit-identical; each
   shape's cluster plan and the built kernels' registers printed; both
   kernels and their plain versions timed with CUDA events and
   torch.profiler at m=5 with a full history at both n;
11. the fused generic loop on the main path: phase 5's ladder (B=4, 101
   f32 rungs, K1's action, ``direction`` auto): K7b's launches equal the
   loop's iterations (per rung the most any member made), K7a's are 0
   and K1's at least the slowest member's evaluations per rung; then the
   20-rung f64 tail through K1 in f64 (maxiter 2000, pgtol 1e-8, ftol
   2.22e-9), whose final_A_tail64 of member 0 must lie within 1e-2
   relative of 16.284792. The first 50 iterations of rung 60 from phase
   5's rung-59 minimizer run again in a child process
   (``chip_smoke.py --profile-loops``) under torch.profiler through the
   fused loop (phase 6 profiles the compact loop): wall, device busy
   share and K7b's device time per iteration beside the wall's;
12. K2's bounded branch against its plain version: short solves (maxiter
   30) at β 0/50/100 from phase 3's draws in the box states (-6, 6),
   F (3, 6): in f64 identical niter/nfev/status and x within 1e-8
   relative; in f32 identical counts and f within 2e-3 relative
   (F32_BOUNDED_F_TOL), with the readings that limit rests on printed:
   over six draws and β 0/25/50/75/100, the plain version's card-vs-CPU
   spread, the kernel's distance from it, and each one's distance from
   the f64 solve (the kernel's at most twice the plain version's); every
   x feasible, some component at a bound, repeats bit-identical; then
   phase 4's f64 5-rung ladder (4 members from near the truth, rf0 = RM,
   pgtol 1e-8, ftol off)
   in that box through K2's hook, through the plain version and through
   the generic projection loop: A within 1e-8 relative at every mutually
   converged rung;
13. the facade on the card: varanneal_tpu_torch.Annealer runs the README's
   Quick start (the twin's data, D=20, L=8, N=161, β 0..100, α=1.5,
   RF0 = 4e-6·RM, Pidx=[0], the bench's opt_args, float32) with bounds
   states (-10, 10), F (2, 12): solver='auto' must take K2, 101 launches
   and no generic loop; then solver='generic' on the first 20 rungs runs
   the projection loop, with K7a launches and no K7b launch; records of
   the right shapes, exit flags in {0, 1, 2}, every path feasible, some
   component at a bound, and save_paths / save_params /
   save_action_errors into a temporary directory (paths (101, 161, 21));
   each K2 launch of the solver='auto' run timed by CUDA events around
   it (K2 bounded's time a launch on its path);
14. K4 (the compensated entry of ag_kernel.cu) against its plain version
   at the main path's shape (phase 3's draws, f32), at rf of β 0, 50, 100
   and at rf = 4e6, with torch's default dtype float64 (the f64 combine):
   the combined value within 2e-6 relative of the plain version's, the
   gradient within K1's 2e-5 and bit-equal to K1's (and K4's plain value
   to K1's) on the same input, repeats bit-identical; at rf = 4e6 every
   member's combined value no farther from the f64 action of the same
   point than K1's f32 value, and within 1e-5 of it; K4 and its plain
   version timed with CUDA events, K4's device time by torch.profiler,
   its bound (K1's plus a TwoSum per term and the (B, 6) row); at
   config #5's width (D=400, B=4, f32 and f64) the combined value within
   2e-6 (f64 1e-12) and value and gradient bit-equal to K1's;
15. the runner in process: ``varanneal_tpu_torch.__main__.main([cfg,
   "--f32"])`` on the Quick start problem (the twin's data written with
   time in column 0, X0 member 0 of the bench's init, 101 rungs, α 1.5,
   RF0 = 4e-6·RM, F estimated, the bench's opt_args, ``compensated:
   true, engine: "ag"``, a checkpoint every 10 rungs and a snapshot at
   rung 60), all files in a temporary directory: the three files of the
   right shapes and finite, K4's launches equal to the ladder's total
   nfev (one member, one evaluation a launch), no launch of K1, K2 or K3
   (the records come from the compensated autograd action), the snapshot
   bit-equal to the rung-59 minimizer; then the checkpoint cut back to
   dispatch 90 and the runner run again: it resumes there, and rungs
   90..100 and the final state are bit-identical to the uninterrupted
   run's; its wall time per loop iteration beside phase 11's;
16. the facade with torch's default dtype float64 and dtype float32,
   ``compensated=True`` through ``engine='ag'`` (K4) and ``'auto'`` (the
   compensated autograd action): β 0..4 at maxiter 20 and β 60..61 at
   maxiter 5 from the Quick start's init, A within 1e-4 relative between
   the two engines and float64 records;
17. the subspace L-BFGS-B (``bounded_algo='subspace'``): phase 12's f64
   short solves in its box through K1 f64 on the card and the plain
   version on the CPU: identical niter, nfev and status, x within 1e-8
   relative, feasible; its time per iteration;
18. K6's kernels (kernels/csrc/fe_kernel.cu: the one-step pair, and
   Hermite–Simpson's forward and fused value-and-gradient launch, which
   also serves autograd's backward) against their plain versions on the card, at data-informed
   draws (phase 3's pattern, numpy seed 0) and the rf of beta 0, 30, 60,
   scalar and (N_f-1, D): config #1's shape (D=20, N=161, B=4) under
   euler, trapezoid and forwardmap, config #2's (D=100, N_f=241,
   Hermite–Simpson, B=8) and config #5's width (D=400, trapezoid, B=4),
   each in f64 (value 1e-12 relative, gradient 1e-12 of max|g|) and f32
   (2e-5, K1's limits), repeats bit-identical; each kernel at its path's
   shape (one member, f32) timed by CUDA events and by torch.profiler,
   beside its plain version, its bound, and the autograd action's
   value+grad (the yardstick); the Hermite–Simpson kernels also at B=8 in
   f64 (K6d, the ensemble's path); then K6 on NaKL with its stimulus
   (BASELINE config #3's twin): the hand-written f, Jᵀv and parameter
   adjoint of csrc/nakl.cuh against the plain versions (the torch model
   and torch.func.vjp) under Hermite–Simpson at N_f = 6,001 (B=1, and B=4,
   8 and 64: phase 27b's polish and screen batches) and the one-step discs
   at N_f = 3,001, with Pidx [1..5], all 18 parameters and the 18 in the
   log model, f64 (1e-12) and f32 (2e-5), scalar and (N_f-1, 4) rf,
   repeats bit-identical; timed at phase 27's shapes (27b's polish, f64
   B=4, too); each Hermite–Simpson launch's grid (blocks, intervals and
   threads a block) and device time printed beside the per-(interval,
   component) design's it replaced (PAIR_DESIGN_US);
19. an f64 5-rung ladder at config #2 (B=2, from near the twin's truth,
   rf0 = RM, pgtol 1e-8) through K6's value_and_grad (the fused launch)
   and through the autograd action: K6's A within 1e-8 relative of the
   autograd action's at every mutually converged rung;
20. the facade at BASELINE config #2 as examples/lorenz96_d100_sh.py runs
   it (engine='pallas', f32, 61 rungs, maxiter 800, one init): one fused
   launch an evaluation, K6's Hermite–Simpson forward once a rung for the
   records and its backward never, no other kernel but K7b (whose launches
   equal the iterations where the loop is the fused one; the example's m =
   10 lies outside K7b's 2m + 1 <= 16, so the compact loop runs and K7b
   stays at 0), records (61,) finite, exit flags in {0, 1, 2}; its wall
   time, ms an iteration, F and the interior RMSE printed, not held (one
   init sits at the observability boundary); then the example's ensemble,
   B=8 members in f64 for rungs 0..9 through run_ladder_checkpointed with
   a checkpoint every 2 rungs: the fused launch at least once per
   evaluation of the slowest member per rung, the forward once a rung;
21. the bench with BENCH_ENGINE=pallas: BENCH_SOLVER=xla (B=1, 101
   rungs, the fused loop, then the 20-rung f64 tail through K1 f64):
   final_A_tail64 within 1e-2 relative of 16.284792, K6's one-step
   kernels launched and K1 not during the f32 ladders; then
   BENCH_SOLVER=fused: 101 K2 launches a call and K6's forward only for
   the records;
22. K5 (kernels/csrc/agt_kernel.cu) against its plain version at config
   #1's shape (B=4, phase 3's draws) under the trapezoid rule, Euler and
   a forward map, at observation stride 2 and at D=64 (trapezoid), each
   with a scalar and an (N_f-1, D) rf at the rf of beta 0, 50, 100, in
   f64 (1e-12) and f32 (2e-5), value and gradient over max|g|, repeats
   bit-identical; its times by CUDA events and torch.profiler beside its
   bound, its plain version, K1 and the autograd action on the same input;
23. the K5 ladder: config #1, one member (member 0 of phase 5's inits),
   101 f32 rungs through the fused loop over make_action_ag_t (K5 and
   K7b), then the 20-rung f64 tail through K5 in f64: final_A_tail64
   within 1e-2 relative of 16.284792, K5 launched at least once an
   evaluation, K7b once an iteration, no K1-K4 or K8 launch; K5 at the
   ladder's minimizers of rungs 0, 60 and 100 within 4x the plain f32
   version's error against f64 (phase 6's rule);
24. K8 (kernels/csrc/pack_kernel.cu) against K2 and its plain version:
   the built kernels (G = 256, 64, 32; at G = 256 the global and on-chip
   layouts' instantiations) within 255 registers, in f32 with no more
   local memory than K2's kernel of the same chunk (the call frame of
   solve_one's by-reference arguments) and no spill in ptxas's report;
   phase 8's short solves at (B, pack) = (4, 2), (5, 2), (6, 3), (4, 4),
   (8, 8) in f64 (identical counts, x within 1e-8) and f32 (identical
   counts, f within 1e-4 or twice the plain version's card-vs-CPU
   spread), bit for bit equal to K2 where the group is K2's 256 threads
   (packs of 2, on K2's layout plan); in phase 12's box at pack 2 (f32 f
   within 2e-3), bit for bit K2 bounded's; one launch a call; at config
   #5's width (D=400, B=4, pack 2, f32 and f64) bit for bit K2's; its
   time at packs 2 and 4 beside K2's, its plain version and its bound;
   then, printed and not held, K2 against K8 at packs 2, 4 and 8, a
   launch each, on these short solves (f32, the rf of beta 50) at B = 1,
   2 and 4 times the SM count and at config #5's shape (D=400, B=1024),
   each beside its bound;
25. the bench with BENCH_PACK: BENCH_PACK=2 BENCH_NINIT=4 (ladder, 101 K8
   launches a call, no K1-K3 launch; at G = 256 its f32 ladder must equal
   phase 9's K2 ladder bit for bit, so no tail), BENCH_PACK=4 with the
   tail (final_A_tail64 within 1e-2 of 16.284792), each K8 launch of the
   BENCH_PACK=2 run timed by CUDA events around it (phase 24 compares
   packing with K2 a launch at the batches where it can pay);
26. BASELINE config #5 as examples/ensemble_sweep.py runs it in full
   (CONF5: 1024 members from random_ensemble_inits(seed=12), Lorenz-96
   D=400, N_data=161, 160 observed, trapezoid, F estimated, f32, rf0 =
   4e-6·RM, α 1.5, m 5, maxiter 300, pgtol 1e-4, ftol 1e-6, 51 rungs in
   calls of 17, warm-started): fe.select_action(engine='auto') must take
   K1's engine 'ag', solve.pick_rung_solver(solver='auto') K2's rung
   solver, and parallel.make_ensemble_ladder runs the ladder with one K2
   launch a rung (each timed by CUDA events around it); every record
   finite, every status in {0, 1, 2}; its wall time, ms an init, total
   nfev and the final action's percentiles printed;
27. BASELINE config #3 (CONF3): (a) examples/nakl.py's problem (NaKL,
   N=3001, N_f = 6,001, the stimulus, Pidx [1..5], the boxes, RF0 1e-5,
   alpha 1.6, maxiter 5000, f64) through the facade with
   engine='pallas' (K6c) over its first 24 of 81 rungs and with
   engine='xla' over the first 10: one fused launch an evaluation and
   K6c's forward once a rung (the records), no other kernel, A within
   1e-8 at the first 10 rungs
   where both converged; walls, nfev and the estimates printed; (b)
   workflow.estimate on examples/nakl_ensemble.py's default campaign
   (B=64 from nakl_ensemble_inits(seed 3), rf0 1e-5·[1, 1e3, 1e3, 1e3],
   the f32 projection screen cut to 12 of 61 rungs with the snapshot at
   rung 8, the f64 polish of the top 4 up 2 extra rungs at the
   example's maxiter 2000), its action from
   fe.select_action(engine='pallas'): K6d's fused launch and K7a
   launched, K6d's backward never alone, its launches counted by dtype
   and batch (the f32 screen, the f64 polish), a checkpoint after every
   chunk, phase 1 resumed from its checkpoint after rung 4
   bit-identical, the best member's parameters printed.

The last two lines are one JSON object per kernel (name, route, source,
the TPU kernel it replaces, launches on its path, max abs error, max
relative error on the scale its phase checks (value relative, gradient
over max|g|, solve x or f relative, direction over max|d|; for K1 and
K5 their draws' in phases 3 and 22, and beside it minimizer_err_ratio,
phase 6's and 23's scale at the ladder's minimizers: the kernel's error
against f64 there over the plain f32 version's median over the
neighbours, bound 4), times,
bound; K4's launches are phase 15's first run's, its ms, device_ms,
plain_ms and bound phase 14's; K3's ms and bound are those of phase 8's
three-rung launch, and
main_ms / main_bound_ms those of its 101-rung launch on the new path;
K2's bounded_* those of phase 12's f32 bounded short solves; K2's, K3's
and K8's main_ms a launch's time on the path whose launches they count
(phases 9, 13 and 25; K2's bounded_main_ms the facade's) and
us_per_eval that over the slowest member's evaluations; K2's and K3's
layout and smem_bytes the planner's at the main shape in f32, registers
[registers, local bytes] per build, barriers_per_iteration phase 9's
measured count, and K2's short_b4_ms / short_b264_ms phase 8's
times in the three layouts; K6's
launches those of its path, phase 21's xla bench for the one-step kernels,
phase 20's facade for fe_sh_fwd (the records) and fe_sh_vag (the fused
launch, every evaluation), its times phase 18's, with K6d's batched_* at
B=8 in f64 and the ensemble's launches, and the one-step kernels'
nakl_* their NaKL errors and times (phase 18);
fe_sh_fwd_nakl / fe_sh_vag_nakl are K6c/K6d on NaKL, their launches
phase 27a's (batched_launches 27b's, launches_by_shape its split by
dtype and batch), their errors phase 18's NaKL checks and their times
phase 18's at 27a's shape (f64, B=1; batched_* the screen's f32, B=64;
polish_* the polish's f64, B=4);
K5's launches phase 23's, its times phase 22's; K8's launches phase 25's
BENCH_PACK=2 run's, its times phase 24's; K1's, K2's, K3's and K4's
d400_max_rel_err their phase's check at D=400, K1's d400_ms and K2's
d400_short_ms phases 3's and 8's times there, K2's
barriers_per_evaluation phase 9's and its config5 phase 26's numbers)
and the
result line {"ok": true, "device": {...}}. Any failure raises, and the
script exits non-zero before that line.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# The card's rates, from NVIDIA's H100 SXM data sheet: HBM bytes/s and
# f32 and f64 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# final_A_tail64 of bench.py's single init: JAX on a TPU v5e
# (BENCH_r05.json), an accuracy anchor and not a time
JAX_FINAL_A_TAIL64 = 16.284792
# phase 12's limit on K2 bounded f32 f against the plain version: 3x the
# largest reading of the kernel (6.9e-4) and of the plain version's
# card-vs-CPU spread over six draws and five rungs (6.7e-4) on the H100
F32_BOUNDED_F_TOL = 2e-3
# rungs of the f64 ladders that hold a kernel's ladder against the plain
# one's to 1e-8 (phases 4, 7, 12 and 19), solved to pgtol from near the
# truth: every rung of them converges, and the plain ladders are
# host-bound (tens of seconds for ten rungs), so five rungs keep the
# check and the script inside its time limit on a slow host
F64_RUNGS = 5

MAIN = dict(D=20, N_data=161, n_obs=8, B=4, n_beta=101, alpha=1.5,
            tail=20)
# BASELINE config #2 as examples/lorenz96_d100_sh.py runs it: Lorenz-96
# D=100, 40 observed, sigma 1, N_data=121 under Hermite–Simpson, 61 rungs
# at alpha 1.6 from RF0 = 1e-4, maxiter 800 (m stays the default 10)
CONF2 = dict(D=100, N_data=121, n_obs=40, sigma=1.0, n_beta=61, alpha=1.6,
             rf0=1e-4, maxiter=800, B=8)
# BASELINE config #5 as examples/ensemble_sweep.py runs it in full: 1024
# members (random_ensemble_inits, seed 12) of Lorenz-96 D=400, N_data=161,
# 160 observed, trapezoid, F estimated from 4.0, f32, rf0 = 4e-6·RM,
# alpha 1.5, 51 rungs in calls of 17 warm-started rungs, m=5, maxiter 300,
# pgtol 1e-4, ftol 1e-6
CONF5 = dict(D=400, N_data=161, n_obs=160, B=1024, seed=12, n_beta=51,
             chunk=17, alpha=1.5, maxiter=300)
# BASELINE config #3 as examples/nakl.py runs it: NaKL (D=4, 19
# parameters), V observed, nakl_twin(N=3001, dt=0.04, sigma=1, seed=7),
# Hermite–Simpson (N_f = 6,001), Pidx [1..5] from the example's wrong
# guesses, its boxes, RM = 1/sigma^2, RF0 = 1e-5, alpha 1.6, 81 rungs,
# maxiter 5000, f64 (phase 27a runs the first rungs_a through K6c and
# holds the autograd action's first rungs_held to them); and
# examples/nakl_ensemble.py's default campaign (phase 27b): its bipolar
# twin (seed 7, seg 75, -25..60), the nakl_param_boxes boxes of Pidx
# [1..5], B = 64 members from nakl_ensemble_inits(default_rng(3)), rf0 =
# 1e-5·[1, 1e3, 1e3, 1e3] over (N_f-1, 4), alpha 1.6, an f32 screen on
# the projection algorithm (m 5, maxiter 400, pgtol 1e-4, ftol 1e-6,
# chunks of 2 rungs; 61 rungs, snapshot at rung 40, cut to rungs_b and
# snap_b) and the f64 polish of the top 4 (maxiter 2000, not cut;
# pgtol 1e-10, ftol 1e-14) from the snapshot up 10 extra
# rungs (cut to extra_b)
CONF3 = dict(N=3001, dt=0.04, sigma=1.0, seed=7, alpha=1.6, rf0=1e-5,
             n_beta=81, rungs_a=24, rungs_held=10, maxiter_a=5000,
             P0=[80.0, 40.0, 30.0, -60.0, 0.5],
             bounds=[(-150.0, 70.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0),
                     (50.0, 200.0), (20.0, 80.0), (5.0, 60.0),
                     (-100.0, -50.0), (0.05, 1.0)],
             B=64, ens_seed=3, n_beta_b=61, rungs_b=12, snap_b=8,
             extra_b=2, maxiter_b=400, polish_maxiter=2000, polish_top=4,
             gate_rf_scale=1000.0)
PIDX3 = [1, 2, 3, 4, 5]
# Device µs a launch of the per-(interval, component) design that the
# Hermite–Simpson kernels replaced (sh_vag: its backward, fe_sh_bwd),
# keyed (model, kernel, dtype, B), at the shapes phase 18 times: an
# NVIDIA H100 80GB HBM3 at 700 W, the torch.profiler readings PERF.md §6
# records
PAIR_DESIGN_US = {("l96", "sh_fwd", "float32", 1): 6.41,
                  ("l96", "sh_vag", "float32", 1): 6.43,
                  ("l96", "sh_fwd", "float64", 8): 5.26,
                  ("l96", "sh_vag", "float64", 8): 4.60,
                  ("nakl", "sh_fwd", "float64", 1): 4.55,
                  ("nakl", "sh_vag", "float64", 1): 23.21,
                  ("nakl", "sh_fwd", "float32", 64): 14.89,
                  ("nakl", "sh_vag", "float32", 64): 115.78}
# the box of phase 12 (tests/test_solve_pallas.py's) and of the facade
BOX_TEST = [(-6.0, 6.0)] * 20 + [(3.0, 6.0)]
BOX_FACADE = [(-10.0, 10.0)] * 20 + [(2.0, 12.0)]


def device_us(evt):
    """Self device time of a profiler row in µs, across torch versions."""
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, k):
            return float(getattr(evt, k))
    return 0.0


def events_ms(fn, n=1000, warm=20):
    """Mean time of ``fn`` on the card in ms, by CUDA events around ``n``
    calls after ``warm`` calls."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


@contextlib.contextmanager
def launch_events(mod, attr):
    """While in the block, every call of ``mod.attr`` (a kernel's wrapper,
    which launches once a call) is timed on the card by CUDA events
    recorded around it; yields the list of (start, stop) pairs."""
    fn = getattr(mod, attr)
    pairs = []

    def timed(*a, **k):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        r = fn(*a, **k)
        stop.record()
        pairs.append((start, stop))
        return r

    setattr(mod, attr, timed)
    try:
        yield pairs
    finally:
        setattr(mod, attr, fn)


def events_total_ms(pairs):
    """The summed time of launch_events' pairs, in ms."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


def per_launch(pairs, nfev, calls):
    """(ms a launch, µs an evaluation) of a kernel launched once a rung on
    a ladder path, from launch_events' pairs over ``calls`` identical
    ladder calls: the evaluations are the slowest member's of each rung
    (``nfev``, (B, rungs) or (rungs,)), which the launch waits for."""
    total = events_total_ms(pairs)
    worst = torch.as_tensor(nfev).reshape(-1, np.shape(nfev)[-1]).amax(
        dim=0).sum().item()
    return total / len(pairs), 1e3 * total / (calls * worst)


def count_barriers(lib, fn):
    """(``fn()``, the group barriers its launches passed): ``fn`` runs with
    the solve wrappers on ``lib``, the measuring build of solve_kernel.cu
    (-DVA_COUNT_BARRIERS, phase 2), whose count is reset before and read
    after."""
    import ctypes
    from varanneal_tpu_torch.kernels import solve
    n = ctypes.c_ulonglong(0)
    check(lib.va_barriers_read(ctypes.byref(n), 1) == 0,
          "resetting the barrier count failed")
    old = solve._lib
    solve._lib = lambda: lib
    try:
        out = fn()
    finally:
        solve._lib = old
    check(lib.va_barriers_read(ctypes.byref(n), 0) == 0,
          "reading the barrier count failed")
    return out, n.value


def k1_ops(spec):
    """Operations of one member's action+gradient in K1's arithmetic: 15
    per residual entry forward, 4 per observation for ME, 15 per state
    entry for the adjoint, 5 per observation for ME's gradient."""
    n_obs = spec.N_data * spec.L
    return (15 * (spec.N_f - 1) * spec.D + 4 * n_obs + 15 * spec.N_f * spec.D
            + 5 * n_obs)


def solve_bound(spec, dtype, B, launches, nfev, niter, m, rungs):
    """Least time of one solve-kernel launch, from the work this run's
    data needed: each input read and each output written once over HBM;
    the operations of ``nfev`` evaluations (K1's arithmetic plus the trial
    point and the directional derivative, 4 per entry) and ``niter``
    iterations (the two-loop direction over a full m-history, 12 per
    entry and pair, and 15 per entry for the step, the curvature gate,
    the history write and the norms) over the card's rate for ``dtype``,
    divided over ``launches``. Returns (ms, bound_by, bytes, operations)
    per launch."""
    s = torch.finfo(dtype).bits // 8
    n, n_obs = spec.n_dof, spec.N_data * spec.L
    inputs = B * n * s + 2 * n_obs * s + 4 * (spec.L + spec.D) + rungs * s
    if rungs == 1:      # K2: x, g, [f, pgnorm], [niter, nfev, status]
        outputs = 2 * B * n * s + B * (2 * s + 12)
    else:               # K3: x and the (rungs, 3) + (rungs, 3) records
        outputs = B * n * s + B * rungs * (3 * s + 12)
    nbytes = inputs + outputs
    nops = (nfev * (k1_ops(spec) + 4 * n)
            + niter * n * (12 * m + 15)) // launches
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, nops
    return t_ops, "operations", nbytes, nops


def _scalar_rf(v, dtype):
    """A Python float rounded to ``dtype``."""
    return float(torch.tensor(float(v), dtype=dtype))


def err_ratio(errs):
    """Phase 6's scale: the f32 kernel's error against the f64 value over
    the plain f32 version's, for A and for the gradient (errs = [kernel
    A, plain A, kernel g, plain g], each against f64); the bound is 4."""
    return max(errs[0] / max(errs[1], 1e-300), errs[2] / max(errs[3], 1e-300))


def minimizer_errs(kernel, plain, XP, rf, c32, c64, n_near=24, seed=0):
    """Phase 6's errors at a ladder's minimizers ``XP`` (B, n_dof), each
    the largest deviation over the members from the f64 plain version:
    the f32 kernel's at the minimizers themselves, and the plain f32
    version's as its median over ``n_near`` f32 neighbours of them (every
    entry moved by up to 2 ulps, a seeded draw). At the top rungs these
    errors are f32 round-off of the residuals, and the plain version's at
    one point is one draw of it: over a minimizer's neighbours it spreads
    over one to two orders of magnitude. The median gives the plain
    version's scale; the kernel stays held at the points the ladder made.
    Returns ([kernel A, plain A, kernel g, plain g] as held, [plain A,
    plain g] at the minimizers, [kernel A, kernel g] medians over the
    neighbours, and the kernel's and the plain version's (A, g, A, g) at
    the minimizers)."""
    gen = torch.Generator().manual_seed(seed)
    eps = torch.finfo(torch.float32).eps
    pts = torch.cat([XP] + [
        XP * (1 + eps * torch.randint(-2, 3, tuple(XP.shape),
                                      generator=gen).to(XP))
        for _ in range(n_near)])
    A, G = kernel(pts, rf, c32)
    A_r, G_r = plain(pts, rf, c32)
    A_x, G_x = plain(pts.double(), rf, c64)

    def e(u, ex):           # (n_near + 1,) largest deviation per point
        return torch.amax(torch.abs(u.double() - ex).reshape(n_near + 1, -1),
                          dim=1).cpu().numpy()
    ka, pa, kg, pg = e(A, A_x), e(A_r, A_x), e(G, G_x), e(G_r, G_x)
    B = XP.shape[0]
    held = [float(ka[0]), float(np.median(pa[1:])), float(kg[0]),
            float(np.median(pg[1:]))]
    return (held, [float(pa[0]), float(pg[0])],
            [float(np.median(ka[1:])), float(np.median(kg[1:]))],
            (A[:B], G[:B], A_r[:B], G_r[:B]))


def bound_of(nbytes, nops, dtype=torch.float32):
    """(ms, bound_by): the larger of bytes over HBM's rate and operations
    over the card's rate for ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dir_work(B, n, m):
    """Bytes and operations of one K7a launch: the 2m history rows and g
    read once, d written once (f32), head/hlen read; the Gram's m² +
    m(m+1)/2 + 2m dot products (2 operations an entry each) and the
    contraction over 2m rows plus γg (2 per row and entry, and 2)."""
    nbytes = B * ((2 * m + 1) * n * 4 + n * 4 + 8)
    gram = m * m + m * (m + 1) // 2 + 2 * m
    nops = B * (2 * gram * n + (4 * m + 2) * n)
    return nbytes, nops


def step_work(B, n, m, n_good):
    """Bytes and operations of one K7b launch: x and g old and new read, s
    and y written into the history of the ``n_good`` members whose pair
    passes the gate, d and the scalar row written, plus the direction (see
    dir_work, whose g read is g_new's, and whose two history rows at head
    are not read for those ``n_good`` members: the kernel overwrites them
    with s and y, which it already holds); the gate pass costs 13
    operations an entry (s, y, sᵀy, sᵀs, yᵀy, Σ|g|, Σg², max|g|)."""
    nbytes_d, nops_d = dir_work(B, n, m)
    nbytes = (B * 4 * n * 4 + n_good * 2 * n * 4 + nbytes_d - B * n * 4
              - n_good * 2 * n * 4 + B * (7 * 4 + 4 * 2 + 4 * 2))
    return nbytes, nops_d + B * 13 * n


def member_draws(spec, tw, seed, B=None):
    """B (default MAIN["B"]) data-informed points (numpy ``seed``): states
    N(2, 2) with the observed components at the data plus N(0, 0.3)
    noise, F N(4, 1); (B, n_dof)."""
    from varanneal_tpu_torch.ops import pack
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(MAIN["B"] if B is None else B):
        X = rng.normal(2.0, 2.0, (spec.N_f, spec.D))
        rows = np.arange(spec.N_data) * spec.obs_stride
        X[np.ix_(rows, np.asarray(spec.Lidx))] = tw["Y"] + rng.normal(
            0, 0.3, tw["Y"].shape)
        draws.append(pack(spec, X, np.array([4.0 + rng.normal()])))
    return np.stack(draws)


def main_problem():
    """The main path's twin, spec and rf0 (BASELINE config #1)."""
    from varanneal_tpu_torch.models import lorenz96
    from varanneal_tpu_torch.ops import build_spec
    from varanneal_tpu_torch.twin import lorenz96_twin
    tw = lorenz96_twin(D=MAIN["D"], N_data=MAIN["N_data"],
                       n_obs=MAIN["n_obs"])
    spec = build_spec(lorenz96, MAIN["D"], tw["Y"], tw["t"], tw["Lidx"],
                      tw["RM"], disc="trapezoid", P=np.array([4.0]),
                      pidx=[0])
    return tw, spec, 4e-6 * tw["RM"]


def config2_problem():
    """BASELINE config #2 as examples/lorenz96_d100_sh.py builds it: the
    twin (D=100, N_data=121, 40 observed, sigma 1) and its
    Hermite–Simpson spec (N_f = 241, F estimated from 4.0)."""
    from varanneal_tpu_torch.models import lorenz96
    from varanneal_tpu_torch.ops import build_spec
    from varanneal_tpu_torch.twin import lorenz96_twin
    tw = lorenz96_twin(D=CONF2["D"], N_data=CONF2["N_data"],
                       n_obs=CONF2["n_obs"], sigma=CONF2["sigma"])
    spec = build_spec(lorenz96, CONF2["D"], tw["Y"], tw["t"], tw["Lidx"],
                      tw["RM"], disc="SimpsonHermite", P=np.array([4.0]),
                      pidx=[0])
    return tw, spec


def config5_problem():
    """BASELINE config #5's twin and spec (examples/ensemble_sweep.py's
    full configuration: D=400, N_data=161, 160 observed, trapezoid, F
    estimated from 4.0)."""
    from varanneal_tpu_torch.models import lorenz96
    from varanneal_tpu_torch.ops import build_spec
    from varanneal_tpu_torch.twin import lorenz96_twin
    tw = lorenz96_twin(D=CONF5["D"], N_data=CONF5["N_data"],
                       n_obs=CONF5["n_obs"])
    spec = build_spec(lorenz96, CONF5["D"], tw["Y"], tw["t"], tw["Lidx"],
                      tw["RM"], disc="trapezoid", P=np.array([4.0]),
                      pidx=[0])
    return tw, spec


def config3_problem(disc="SimpsonHermite", pidx=PIDX3, log=False, tw=None):
    """BASELINE config #3's twin and a spec of it as examples/nakl.py
    builds them (V observed, RM = 1/sigma^2, the stimulus), under ``disc``
    with ``pidx`` estimated; ``log``: the model of
    nakl_log_model(NAKL_TAU_IDX + NAKL_G_IDX). ``tw`` reuses a twin."""
    from varanneal_tpu_torch.models import (NAKL_G_IDX, NAKL_TAU_IDX,
                                            nakl_log_model)
    from varanneal_tpu_torch.ops import build_spec
    from varanneal_tpu_torch.twin import nakl_twin
    if tw is None:
        tw = nakl_twin(N=CONF3["N"], dt=CONF3["dt"], sigma=CONF3["sigma"],
                       seed=CONF3["seed"])
    f, P = nakl_log_model(NAKL_TAU_IDX + NAKL_G_IDX if log else ())
    spec = build_spec(f, 4, tw["V"], tw["t"], [0], 1.0 / tw["sigma"] ** 2,
                      disc=disc, P=P, pidx=list(pidx), stim=tw["stim"])
    return tw, spec


def model_grid_v(spec, tw):
    """The data voltage on the model grid (linear in between), as
    examples/nakl_ensemble.py slaves its initial paths to it."""
    n = tw["V"].shape[0]
    return np.interp(np.arange(spec.N_f) * (n - 1) / (spec.N_f - 1),
                     np.arange(n), tw["V"][:, 0])


def nakl_draws(spec, tw, B, seed, log=False, dtype=np.float64):
    """B campaign-style points (nakl_ensemble_inits from
    default_rng(seed)): the data voltage, steady-state gates with jitter,
    parameters uniform in the nakl_param_boxes boxes of spec.pidx (on the
    log scale for ``log``); (B, n_dof)."""
    from varanneal_tpu_torch.models import (nakl_ensemble_inits,
                                            nakl_param_boxes)
    pb, _ = nakl_param_boxes(spec.pidx, log_tau=log, log_g=log)
    return nakl_ensemble_inits(np.random.default_rng(seed), B, pb,
                               [model_grid_v(spec, tw)], pidx=spec.pidx,
                               dtype=dtype)


def plain_k6(X, pest, rf, c):
    """K6's plain versions on the same (card) tensors: the forward's
    partials, the gradient rows and the full parameter gradient (B, NP),
    as fe.fe_partials and fe.fe_adjoint return them."""
    from varanneal_tpu_torch.kernels import fe
    P = fe.full_params(pest, c)
    if c.sh:
        out = fe.sh_vag_reference(X, pest, rf, c)
        return (fe.sh_fwd_reference(X, pest, rf, c),
                fe.sh_join(*out[1:4], c), fe.param_grad(out[4], P, c))
    g, gp = fe.onestep_bwd_reference(X, pest, rf, c)
    return (fe.onestep_fwd_reference(X, pest, rf, c), g,
            fe.param_grad(gp, P, c))


def k6_kernels(c):
    """(name, kernel wrapper, plain version) of each K6 kernel of c's
    disc: the one-step pair, or Hermite–Simpson's forward and fused
    value-and-gradient launch."""
    from varanneal_tpu_torch.kernels import fe
    if c.sh:
        return (("sh_fwd", fe.sh_fwd_kernel, fe.sh_fwd_reference),
                ("sh_vag", fe.sh_vag_kernel, fe.sh_vag_reference))
    return (("onestep_fwd", fe.onestep_fwd_kernel, fe.onestep_fwd_reference),
            ("onestep_bwd", fe.onestep_bwd_kernel,
             fe.onestep_bwd_reference))


def k6_times(X, pest, rf, c):
    """Each K6 kernel of c's disc (k6_kernels) at one shape: ms a launch
    by CUDA events (1000 launches), device ms by torch.profiler (200), the
    plain version's ms (200), and the bound (fe_work)."""
    kerns = k6_kernels(c)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            for _, fn_k, _ in kerns:
                fn_k(X, pest, rf, c)
        torch.cuda.synchronize()
    out = {}
    for kern, fn_k, fn_p in kerns:
        rows = [(device_us(e), e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and f"fe_{kern}" in e.key]
        w = fe_work(kern, c, X.shape[0], isinstance(rf, torch.Tensor))
        out[kern] = dict(
            ms=events_ms(lambda: fn_k(X, pest, rf, c)),
            plain_ms=events_ms(lambda: fn_p(X, pest, rf, c), n=200),
            device_ms=(rows[0][0] / rows[0][1] / 1e3
                       if rows and rows[0][0] > 0 else None),
            bound=bound_of(*w, dtype=c.dtype), work=w)
    return out


def print_k6_times(label, t, c, B):
    """One line a kernel of k6_times' result, with its grid (sh_grid)."""
    for kern, r in t.items():
        w = r["work"]
        kind = "fwd" if kern.endswith("fwd") else "bwd"
        print(f"{label} {kern} {str(c.dtype)[6:]} ({c.disc}, D={c.D}, "
              f"N_f={c.N_f}, B={B}; {sh_grid(c, B, kind)}): "
              f"{r['ms']:.5f} ms a launch (CUDA events), device time "
              + (f"{r['device_ms']:.5f} ms (torch.profiler)"
                 if r["device_ms"] is not None
                 else "not measured (no device events)")
              + f"; plain {r['plain_ms']:.5f} ms; bound "
              f"{r['bound'][0]:.3e} ms ({r['bound'][1]}: {w[0]} bytes, "
              f"{w[1]} operations)"
              + (f"; the per-pair design's device time "
                 + ("(its backward) " if kern == "sh_vag" else "")
                 + f"{PAIR_DESIGN_US[(c.model, kern, str(c.dtype)[6:], B)]}"
                 " µs (PERF.md §6)"
                 if (c.model, kern, str(c.dtype)[6:], B) in PAIR_DESIGN_US
                 else ""))


def _previous_sh_rows(c, kind, block_n):
    """Intervals a block under the per-(interval, component) design that
    fe_sh_fwd and fe_sh_vag replaced (its fe_sh_fwd and fe_sh_bwd):
    block_n cut to the intervals there are (rounded up to 8), then by 8
    until the staged rows (2bn + 1 forward, 5bn + 1 backward, of D values)
    and its extras fit in 48 KB, for every B; 256 threads looped over the
    block's pairs."""
    def smem(bn):
        rows = 2 * bn + 1 if kind == "fwd" else 5 * bn + 1
        extra = 8 * c.NP + (c.NP + 2 * bn + 1 if c.model == "nakl" else 0)
        return (rows * c.D + extra) * (torch.finfo(c.dtype).bits // 8)
    bn = max(1, min(block_n, max(8, -(-c.M // 8) * 8)))
    while bn > 8 and smem(bn) > 48 * 1024:
        bn = max(8, bn - 8)
    return bn


def sh_grid(c, B, kind):
    """The launch's grid at batch size B: blocks a member, intervals and
    threads a block, intervals (pairs) a thread; under Hermite–Simpson
    also at block_n 512 (make_action_pallas's default; the paths pass
    select_action's 64), and the per-pair design's blocks a member at
    both (_previous_sh_rows)."""
    from varanneal_tpu_torch.kernels import fe
    nb, bk = c.n_blocks(kind, B), c.rows(kind, B)
    if not c.sh:
        return f"{nb} blocks a member, {bk} rows a block"
    thr = fe.sh_threads(c.model, bk, c.D)
    per = 1 if fe._SH_ROW[c.model] else c.D
    c512 = dataclasses.replace(c, block_n=512)
    old = {n: _previous_sh_rows(c, kind, n) for n in (c.block_n, 512)}
    return (f"{nb} blocks a member of {bk} intervals and {thr} threads, "
            f"{-(-bk * per // thr)} {'interval' if per == 1 else 'pair'}"
            f"(s) a thread ({c512.n_blocks(kind, B)} blocks at block_n "
            f"512); the per-pair design: "
            + ", ".join(f"{-(-c.M // r)} blocks of {r} intervals "
                        f"({-(-r * c.D // 256)} pairs a thread) at block_n "
                        f"{n}" for n, r in old.items()))


def check_vag(X, pest, rf, c, tol, label):
    """The fused launch (fe.sh_vag_kernel) against its plain version on
    the same card tensors: value (partials summed) relative, the joined
    gradient rows and the full parameter gradient over max|g|, each
    within tol; a repeat bit-identical. Returns (max abs error, value rel
    error, gradient rel error)."""
    from varanneal_tpu_torch.kernels import fe
    out = fe.sh_vag_kernel(X, pest, rf, c)
    torch.cuda.synchronize()
    ref = fe.sh_vag_reference(X, pest, rf, c)
    P = fe.full_params(pest, c)
    g_k, g_r = fe.sh_join(*out[1:4], c), fe.sh_join(*ref[1:4], c)
    gp_k, gp_r = fe.param_grad(out[4], P, c), fe.param_grad(ref[4], P, c)
    v_k, v_r = out[0].sum(1), ref[0].sum(1)
    rel_v = float(torch.max(torch.abs(v_k - v_r) / torch.abs(v_r)))
    scale = torch.maximum(torch.amax(torch.abs(g_r), dim=(1, 2)),
                          torch.amax(torch.abs(gp_r), dim=1))
    rel_g = float(torch.max(torch.maximum(
        torch.amax(torch.abs(g_k - g_r), dim=(1, 2)),
        torch.amax(torch.abs(gp_k - gp_r), dim=1)) / scale))
    err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(out, ref))
    check(rel_v <= tol and rel_g <= tol,
          f"the fused launch {label} disagrees with its plain version: "
          f"value {rel_v:.3e}, gradient {rel_g:.3e}")
    again = fe.sh_vag_kernel(X, pest, rf, c)
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"the fused launch {label}: a repeat is not bit-identical")
    return err, rel_v, rel_g


def k6_nakl(dev, tw3):
    """Phase 18's NaKL part: K6 on config #3's twin against its plain
    versions on the card: Hermite–Simpson at N_f = 6,001 (K6c, B=1; K6d,
    B=4, 8 and CONF3['B']: phase 27b's polish and screen batches), the
    one-step discs at N_f = 3,001 (B=2), each with Pidx [1..5],
    all 18 estimated and the 18 in the log model, f64 (1e-12) and f32
    (2e-5) on the value and on the gradient over max|g| (states and
    parameters), scalar and (N_f-1, 4) rf (the campaign's 1e-5·[1, 1e3,
    1e3, 1e3]) at beta 0 and 30, repeats bit-identical; then the kernels
    timed at their paths' shapes. Under Hermite–Simpson the fused launch
    (sh_vag) is held to its plain version at every shape too. Returns
    (max abs errors, max relative errors, times), keyed by kernel."""
    from varanneal_tpu_torch.kernels import fe
    err = dict(onestep_fwd=0.0, onestep_bwd=0.0, sh_fwd=0.0, sh_vag=0.0)
    rel = dict(err)
    rf_dir = np.array([1.0, 1e3, 1e3, 1e3])
    variants = ((PIDX3, False), (list(range(1, 19)), False),
                (list(range(1, 19)), True))
    for disc, B in (("SimpsonHermite", 1), ("SimpsonHermite", 4),
                    ("SimpsonHermite", 8), ("SimpsonHermite", CONF3["B"]),
                    ("trapezoid", 2), ("euler", 2), ("forwardmap", 2)):
        kf, kb = (("sh_fwd", "sh_vag") if disc == "SimpsonHermite"
                  else ("onestep_fwd", "onestep_bwd"))
        for pidx, log in variants:
            _, sp = config3_problem(disc, pidx, log, tw=tw3)
            draws = nakl_draws(sp, tw3, B, 18, log)
            for dtype in (torch.float64, torch.float32):
                tol = 1e-12 if dtype == torch.float64 else 2e-5
                c = fe.fe_consts(sp, dtype, dev, block_n=64)
                Z = torch.tensor(draws, dtype=dtype, device=dev)
                X = Z[:, : sp.n_state].reshape(B, sp.N_f, sp.D)
                pest = Z[:, sp.n_state:]
                worst = [0.0, 0.0]
                for beta in (0, 30):
                    rf_b = _scalar_rf(CONF3["rf0"] * CONF3["alpha"] ** beta,
                                      dtype)
                    for rf in (rf_b, torch.tensor(np.broadcast_to(
                            rf_dir * rf_b, (sp.N_f - 1, 4)).copy(),
                            dtype=dtype, device=dev)):
                        p_k = fe.fe_partials(X, pest, rf, c)
                        g_k, gp_k = fe.fe_adjoint(X, pest, rf, c)
                        torch.cuda.synchronize()
                        p_r, g_r, gp_r = plain_k6(X, pest, rf, c)
                        v_k, v_r = p_k.sum(1), p_r.sum(1)
                        rel_v = float(torch.max(torch.abs(v_k - v_r)
                                                / torch.abs(v_r)))
                        scale = torch.maximum(
                            torch.amax(torch.abs(g_r), dim=(1, 2)),
                            torch.amax(torch.abs(gp_r), dim=1))
                        rel_g = float(torch.max(torch.maximum(
                            torch.amax(torch.abs(g_k - g_r), dim=(1, 2)),
                            torch.amax(torch.abs(gp_k - gp_r), dim=1))
                            / scale))
                        worst = [max(worst[0], rel_v), max(worst[1], rel_g)]
                        rel[kf] = max(rel[kf], rel_v)
                        rel[kb] = max(rel[kb], rel_g)
                        err[kf] = max(err[kf],
                                      float(torch.max(torch.abs(p_k - p_r))))
                        err[kb] = max(
                            err[kb], float(torch.max(torch.abs(g_k - g_r))),
                            float(torch.max(torch.abs(gp_k - gp_r))))
                        check(rel_v <= tol and rel_g <= tol,
                              f"K6 NaKL {disc} B={B} {len(pidx)} estimated"
                              f"{' (log)' if log else ''} {dtype} disagrees "
                              f"with its plain version at beta={beta}: "
                              f"value {rel_v:.3e}, gradient {rel_g:.3e}")
                        again = fe.fe_adjoint(X, pest, rf, c)
                        check(torch.equal(p_k, fe.fe_partials(X, pest, rf, c))
                              and torch.equal(g_k, again[0])
                              and torch.equal(gp_k, again[1]),
                              f"K6 NaKL {disc} {dtype}: a repeat is not "
                              "bit-identical")
                        if c.sh:
                            e_v, r_v, r_g = check_vag(
                                X, pest, rf, c, tol,
                                f"NaKL B={B} {dtype} beta={beta}")
                            err["sh_vag"] = max(err["sh_vag"], e_v)
                            rel["sh_vag"] = max(rel["sh_vag"], r_v, r_g)
                            worst = [max(worst[0], r_v), max(worst[1], r_g)]
                print(f"K6 NaKL {disc} N_f={sp.N_f} B={B}, {len(pidx)} "
                      f"estimated{' in the log model' if log else ''}, "
                      f"{str(dtype)[6:]}, {sh_grid(c, B, 'bwd')}, scalar "
                      f"and (N_f-1, 4) rf at beta 0, 30: value rel err "
                      f"{worst[0]:.3e}, gradient rel err {worst[1]:.3e} of "
                      f"max|g| (bound {tol:g})"
                      + (", the fused launch included" if c.sh else "")
                      + "; repeats bit-identical")
    # times at the paths' shapes: phase 27a's K6c (f64, B=1), phase 27b's
    # screen (f32, B=64) and polish (f64, B=4) through K6d and a one-step
    # disc (trapezoid, f32, B=1), Pidx [1..5], scalar rf of beta 30
    times = {}
    for tag, disc, dtype, B in (("path", "SimpsonHermite", torch.float64, 1),
                                ("batched", "SimpsonHermite", torch.float32,
                                 CONF3["B"]),
                                ("polish", "SimpsonHermite", torch.float64,
                                 CONF3["polish_top"]),
                                ("onestep", "trapezoid", torch.float32, 1)):
        _, sp = config3_problem(disc, tw=tw3)
        c = fe.fe_consts(sp, dtype, dev, block_n=64)
        Z = torch.tensor(nakl_draws(sp, tw3, B, 27), dtype=dtype, device=dev)
        X = Z[:, : sp.n_state].reshape(B, sp.N_f, sp.D)
        pest = Z[:, sp.n_state:]
        rf = _scalar_rf(CONF3["rf0"] * CONF3["alpha"] ** 30, dtype)
        times[tag] = k6_times(X, pest, rf, c)
        print_k6_times("K6 NaKL", times[tag], c, B)
    return err, rel, times


def config3_facade(dev, tw3, zero_counts, run_counts):
    """Phase 27a: examples/nakl.py's problem through the facade in f64,
    Annealer(device) with engine='pallas' (K6c) over its first
    CONF3['rungs_a'] rungs and engine='xla' (the autograd action) over its
    first CONF3['rungs_held']: records finite, exit flags in {0, 1, 2},
    K6c launched at least once an evaluation on the K6 run and never on
    the autograd run, no other kernel of the port (the f64 projection
    loop launches no K7a), and A within 1e-8 relative at every rung of the
    first CONF3['rungs_held'] where both runs converged (at least 80 % of
    them). Later rungs are not held: from rung 11 the two f64 runs part at
    round-off (25 iterations a rung of a stiff problem) and stop, at the
    example's pgtol (the facade's floor, 1e-4), at other points of a flat
    valley. Returns the phase's numbers."""
    from varanneal_tpu_torch.api import Annealer
    from varanneal_tpu_torch.models import NAKL_P_TRUE, NAKL_PNAMES, nakl
    n_held = CONF3["rungs_held"]
    print(f"config #3 cut (phase 27a): rungs 0..{CONF3['rungs_a'] - 1} of "
          f"{CONF3['n_beta']} through K6c, 0..{n_held - 1} through the "
          f"autograd action; maxiter {CONF3['maxiter_a']} (not cut); "
          f"N={CONF3['N']}, D=4, Pidx {PIDX3}, the stimulus and the boxes "
          "as the example's")
    N = CONF3["N"]
    P0 = np.asarray(NAKL_P_TRUE, float).copy()
    P0[PIDX3] = CONF3["P0"]
    X0 = np.column_stack([tw3["V"][:, 0], np.full(N, 0.5), np.full(N, 0.5),
                          np.full(N, 0.5)])
    runs = {}
    for engine, n_rung in (("pallas", CONF3["rungs_a"]), ("xla", n_held)):
        ann = Annealer(device=dev)
        ann.set_model(nakl, 4)
        ann.set_data(tw3["V"], stim=tw3["stim"], t=tw3["t"])
        zero_counts()
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        ann.anneal(X0, P0, alpha=CONF3["alpha"],
                   beta_array=np.arange(n_rung), RM=1.0 / tw3["sigma"] ** 2,
                   RF0=CONF3["rf0"], Lidx=[0], Pidx=PIDX3,
                   disc="SimpsonHermite", bounds=CONF3["bounds"],
                   opt_args=dict(maxiter=CONF3["maxiter_a"]),
                   dtype=torch.float64, engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_a
        cnt = run_counts()
        nfev = int(ann.nfev_array.sum())
        niter = int(ann.niter_array.sum())
        p_est = ann.minpaths_P[-1]
        runs[engine] = dict(ann=ann, wall=wall, cnt=cnt, nfev=nfev,
                            niter=niter)
        print(f"config #3 facade, engine={engine!r} (f64, {n_rung} rungs): "
              f"wall {wall:.2f} s; niter {niter}, nfev {nfev}, "
              f"{1e3 * wall / max(niter, 1):.3f} ms a loop iteration; exit "
              "flags per code 0..2 "
              f"{np.bincount(ann.exitflags, minlength=3).tolist()}; niter "
              f"per rung {ann.niter_array.tolist()}; final A "
              f"{float(ann.A_array[-1]):.6g}; launches {cnt}; estimates "
              + ", ".join(f"{NAKL_PNAMES[pi]} {p_est[j]:.4f} (truth "
                          f"{NAKL_P_TRUE[pi]})"
                          for j, pi in enumerate(PIDX3)))
        check(ann.A_array.shape == (n_rung,)
              and bool(np.isfinite(ann.A_array).all())
              and set(np.unique(ann.exitflags)) <= {0, 1, 2},
              f"config #3 facade ({engine}): records or exit flags")
        others = [k for k in cnt if k not in ("k6_sh_fwd", "k6_sh_vag")]
        check(all(cnt[k] == 0 for k in others),
              f"config #3 facade ({engine}) launched another kernel: {cnt}")
    ck, cx = runs["pallas"]["cnt"], runs["xla"]["cnt"]
    check(ck["k6_sh_vag"] == runs["pallas"]["nfev"] > 0
          and ck["k6_sh_fwd"] == CONF3["rungs_a"],
          f"config #3 facade: one fused launch an evaluation and K6c's "
          f"forward once a rung for the records, got {ck}")
    check(cx["k6_sh_fwd"] == cx["k6_sh_vag"] == 0,
          f"config #3 facade (xla) launched K6: {cx}")
    ax, ak = runs["xla"]["ann"], runs["pallas"]["ann"]
    ek, Ak = ak.exitflags[:n_held], ak.A_array[:n_held]
    conv = (ax.exitflags == 0) & (ek == 0)
    rel = np.where(conv, np.abs(Ak - ax.A_array) / np.abs(ax.A_array), 0.0)
    print(f"config #3 facade, K6c vs the autograd action over rungs "
          f"0..{n_held - 1}: mutually converged rungs {int(conv.sum())}/"
          f"{n_held}; max rel A difference there {rel.max():.3e} (bound "
          "1e-8)")
    check(conv.mean() >= 0.8, f"config #3 facade: too few converged rungs "
          f"{ax.exitflags} {ek}")
    check(np.all(rel <= 1e-8), f"config #3 facade: K6c and the autograd "
          f"action disagree: {rel}")
    return dict(
        {f"{e}_{k}": runs[e][k] for e in runs
         for k in ("wall", "nfev", "niter")},
        launches=ck, rungs=CONF3["rungs_a"], rungs_held=n_held,
        max_rel_A=float(rel.max()), converged=int(conv.sum()))


def config3_campaign(dev, zero_counts, run_counts):
    """Phase 27b: workflow.estimate on examples/nakl_ensemble.py's default
    problem, built as the example builds it, with its action from
    fe.select_action(engine='pallas'): the f32 screen of B=64 members
    (K6d and, through the projection loop, K7a), the snapshot, and the f64
    polish of the top 4 (K6d in f64). Checks the launches, a checkpoint
    after every chunk, phase 1 resumed from its checkpoint after rung 4
    giving the same bits, finite records; prints the best member's
    parameters against the truth. Returns the phase's numbers."""
    from varanneal_tpu_torch import workflow
    from varanneal_tpu_torch.anneal import checkpoint as ckmod
    from varanneal_tpu_torch.api import build_bounds
    from varanneal_tpu_torch.kernels import fe
    from varanneal_tpu_torch.models import (NAKL_P_TRUE, NAKL_PNAMES,
                                            NAKL_STATE_BOUNDS,
                                            nakl_ensemble_inits,
                                            nakl_log_model,
                                            nakl_param_boxes)
    from varanneal_tpu_torch.ops import build_spec
    from varanneal_tpu_torch.opt import LBFGSOptions
    from varanneal_tpu_torch.twin import nakl_twin
    n_beta, snap, extra = CONF3["rungs_b"], CONF3["snap_b"], CONF3["extra_b"]
    print(f"config #3 cut (phase 27b): screen rungs 0..{n_beta - 1} of "
          f"{CONF3['n_beta_b']}, snapshot at rung {snap} (the example's "
          f"{CONF3['n_beta_b'] - 21}), polish {extra} extra rungs (10); "
          f"the polish's maxiter {CONF3['polish_maxiter']}, the screen's "
          f"maxiter {CONF3['maxiter_b']} and B={CONF3['B']} not cut")
    tw = nakl_twin(N=CONF3["N"], dt=CONF3["dt"], sigma=CONF3["sigma"],
                   seed=CONF3["seed"], seg=75, i_min=-25.0, i_max=60.0)
    pbounds, log_idx = nakl_param_boxes(PIDX3)
    model_f, P_base = nakl_log_model(log_idx)
    bounds = list(NAKL_STATE_BOUNDS) + list(pbounds)
    rf_dir = np.array([1.0, CONF3["gate_rf_scale"], CONF3["gate_rf_scale"],
                       CONF3["gate_rf_scale"]])

    def make_problem(dtype):
        spec = build_spec(model_f, 4, tw["V"].astype(dtype), tw["t"], [0],
                          1.0, disc="SimpsonHermite", P=P_base, pidx=PIDX3,
                          stim=tw["stim"])
        rf0 = np.broadcast_to(CONF3["rf0"] * rf_dir, (spec.N_f - 1, 4))
        act, parts = fe.select_action(
            spec, rf0, engine="pallas",
            dtype=torch.float32 if dtype == np.float32 else torch.float64,
            device=dev)
        lo, hi = build_bounds(spec, bounds, dtype)
        return act, parts, lo, hi, spec

    act32, parts32, lo32, hi32, spec = make_problem(np.float32)
    check(act32.engine == "pallas", "config #3 campaign: not K6's engine")
    xp0 = nakl_ensemble_inits(np.random.default_rng(CONF3["ens_seed"]),
                              CONF3["B"], pbounds,
                              [model_grid_v(spec, tw)], pidx=PIDX3,
                              dtype=np.float32)
    rf0 = np.ascontiguousarray(np.broadcast_to(
        CONF3["rf0"] * rf_dir, (spec.N_f - 1, 4))).astype(np.float32)
    betas = np.arange(n_beta, dtype=np.float32)
    opts = LBFGSOptions(maxiter=CONF3["maxiter_b"], m=5, pgtol=1e-4,
                        ftol=1e-6, bounded_algo="projection")
    opts64 = LBFGSOptions(maxiter=CONF3["polish_maxiter"], pgtol=1e-10,
                          ftol=1e-14, bounded_algo="projection")
    meta = dict(N=CONF3["N"], n_beta=n_beta, seed=CONF3["ens_seed"],
                ninit=CONF3["B"], gate_rf_scale=CONF3["gate_rf_scale"])
    writes, kept = [], {}
    real_save = ckmod._atomic_savez

    def spy(path, **arrays):
        name = os.path.basename(path)
        writes.append((name, int(arrays["next_idx"])))
        if name.endswith("_p1_ckpt.npz") and int(arrays["next_idx"]) == 4:
            kept.update(arrays)
        real_save(path, **arrays)

    ckmod._atomic_savez = spy
    # the K6d launches by (dtype, B): the f32 screen's and the f64
    # polish's, each wrapper call one launch
    by_shape = {}
    real = {k: getattr(fe, k) for k in ("sh_vag_kernel", "sh_fwd_kernel")}

    def tallied(name):
        def fn(X, *a):
            key = f"{name[:6]} {str(X.dtype)[6:]} B={X.shape[0]}"
            by_shape[key] = by_shape.get(key, 0) + 1
            return real[name](X, *a)
        return fn

    try:
        with tempfile.TemporaryDirectory() as tmp:
            stem = os.path.join(tmp, "c3")
            zero_counts()
            for k in real:
                setattr(fe, k, tallied(k))
            torch.cuda.synchronize()
            t_e = time.perf_counter()
            res = workflow.estimate(
                make_problem, xp0, betas, rf0, CONF3["alpha"], n_params=5,
                opts=opts, snapshot_beta=snap, polish_top=CONF3["polish_top"],
                polish_batch=CONF3["polish_top"], polish_opts=opts64,
                polish_extra_betas=extra, checkpoint_stem=stem, save_every=2,
                meta=meta, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_e
            for k, fn in real.items():
                setattr(fe, k, fn)
            cnt = run_counts()
            p1_writes = [i for nm, i in writes if nm == "c3_p1_ckpt.npz"]
            pol_writes = [i for nm, i in writes if nm == "c3_pol_ckpt.npz"]
            # phase 1 again from its checkpoint after rung 4
            np.savez(stem + "_p1_ckpt.npz", **kept)
            t_r = time.perf_counter()
            r1b = workflow.phase1(
                act32, parts32, xp0, betas, rf0, CONF3["alpha"], lower=lo32,
                upper=hi32, opts=opts, snapshot_beta=snap,
                checkpoint_stem=stem, save_every=2, meta=meta, spec=spec,
                device=dev)
            torch.cuda.synchronize()
            wall_r = time.perf_counter() - t_r
    finally:
        ckmod._atomic_savez = real_save
        for k, fn in real.items():
            setattr(fe, k, fn)
    r1, r2 = res.phase1, res.polish
    p_best = res.best[spec.n_state:spec.n_state + 5]
    codes = np.bincount(r1.status.ravel(), minlength=4)
    print(f"config #3 campaign (workflow.estimate, B={CONF3['B']} f32 "
          f"screen of {n_beta} rungs, snapshot at {snap}, f64 polish of the "
          f"top {CONF3['polish_top']} over {r2.A.shape[1]} rungs): wall "
          f"{wall:.2f} s; screen nfev {int(r1.nfev.sum())} (statuses per "
          f"code 0..3 {codes.tolist()}); launches {cnt}; checkpoints after "
          f"each chunk: phase 1 at dispatches {p1_writes}, polish at "
          f"{pol_writes}; best member {res.best_member}, polished A "
          f"{res.best_A:.6g}; estimates "
          + ", ".join(f"{NAKL_PNAMES[pi]} {p_best[j]:.4f} (truth "
                      f"{NAKL_P_TRUE[pi]})" for j, pi in enumerate(PIDX3))
          + f"; phase 1 resumed from rung 4 in {wall_r:.2f} s; K6d "
          f"launches by wrapper, dtype and batch {by_shape}")
    check(cnt["k6_sh_fwd"] > 0 and cnt["k6_sh_vag"] > 0 and cnt["k7a"] > 0,
          f"config #3 campaign: K6d's fused launch or K7a not launched: "
          f"{cnt}")
    check(all(cnt[k] == 0 for k in ("k1", "k2", "k3", "k4", "k5", "k8",
                                    "k6_fwd", "k6_bwd")),
          f"config #3 campaign launched another kernel: {cnt}")
    n_chunks = len(range(0, snap, 2)) + len(range(snap, n_beta, 2))
    check(len(p1_writes) == n_chunks and p1_writes[-1] == n_beta
          and pol_writes[-1] == r2.A.shape[1],
          f"config #3 campaign: checkpoints {writes}")
    check(np.array_equal(r1b.A, r1.A) and np.array_equal(r1b.XP, r1.XP)
          and np.array_equal(r1b.snapshot, r1.snapshot),
          "config #3 campaign: phase 1 resumed from its checkpoint differs")
    check(np.all(np.isfinite(r1.A)) and np.all(np.isfinite(r2.A))
          and np.isfinite(res.best_A),
          "config #3 campaign: records not finite")
    check(sum(by_shape.values()) == cnt["k6_sh_vag"] + cnt["k6_sh_fwd"],
          f"config #3 campaign: launches by shape {by_shape}, {cnt}")
    return dict(wall=wall, wall_resume=wall_r, nfev=int(r1.nfev.sum()),
                launches=cnt, launches_by_shape=by_shape, best_A=res.best_A,
                p_best=[float(v) for v in p_best])


def fe_work(kernel, c, B, diag):
    """Bytes and operations of one launch of K6's ``kernel`` on B members
    (``c``: the kernels' constants): X and the parameter rows read once,
    the stimulus (NaKL) and an (N_f-1, D) rf read once when present, the
    outputs written once; the kernel's arithmetic, counted per entry from
    the model's f, Jᵀv and parameter adjoint a component (Lorenz-96 4, 7
    and 1; NaKL about 12, 28 and 23, a tanh counted as one operation, so
    that the bound stays a lower one). One-step forward, per residual
    entry: the residual (trapezoid 2f + 4, euler f + 3, forwardmap f + 1),
    then 2 to square and sum (3 with a weight row); backward, per gradient
    entry: the residual, 1 to weight it, 3 for v, the adjoint, Jᵀv and 3
    for the row. Hermite–Simpson, per interval entry: forward three f, 6
    each for S and H, 6 to weight and sum (3f + 18); backward three f and
    12 for S and H, 9 for v0, vm, v1 and their weights, three adjoints,
    three Jᵀv and 9 for the triplet; the fused launch (``sh_vag``) the
    backward and 6 for the value's terms. The work is counted once per
    node, whatever a design evaluates again."""
    s = torch.finfo(c.dtype).bits // 8
    f, jtv, ptv = (4, 7, 1) if c.model == "l96" else (12, 28, 23)
    n_x = B * c.N_f * c.D
    nbytes = (n_x * s + B * c.NP * s + int(diag) * (c.N_f - 1) * c.D * s
              + int(c.stim is not None) * c.N_f * s)
    res = {"trapezoid": 2 * f + 4, "euler": f + 3,
           "forwardmap": f + 1}.get(c.disc, 0)
    if kernel == "onestep_fwd":
        nbytes += B * c.n_blocks("fwd") * s
        nops = B * (c.N_f - 1) * c.D * (res + 2 + int(diag))
    elif kernel == "onestep_bwd":
        nbytes += n_x * s + B * c.NP * c.n_blocks("bwd") * s
        nops = B * c.N_f * c.D * (res + 7 + ptv + jtv)
    elif kernel == "sh_fwd":
        nbytes += B * c.n_blocks("fwd", B) * s
        nops = B * c.M * c.D * (3 * f + 18)
    else:
        nbytes += (3 * B * c.M * c.D * s
                   + B * c.NP * c.n_blocks("bwd", B) * s)
        nops = B * c.M * c.D * (3 * f + 12 + 18 + 3 * (ptv + jtv))
        if kernel == "sh_vag":
            nbytes += B * c.n_blocks("bwd", B) * s
            nops += B * c.M * c.D * 6
    return nbytes, nops


def agt_work(spec, disc, B, diag):
    """Bytes and operations of one K5 launch on B members: X read once, Y
    and W, lidx and lpos read once, an (N_f-1, D) rf read once when
    ``diag``, A and the gradient written once; per residual entry the
    residual (trapezoid 12, euler 7, forwardmap 5: fe_work's counts), 1 to
    weight it with a diagonal rf and 3 for the two sums, 4 per observation
    for ME; per state entry Jᵀv (7), 1 to sum v's two rows (trapezoid)
    and 4 for the row's combination, 5 per observation for ME's
    gradient."""
    s = 4
    n_obs = spec.N_data * spec.L
    nbytes = (2 * B * spec.n_dof * s + 2 * n_obs * s + 4 * (spec.L + spec.D)
              + B * s + int(diag) * (spec.N_f - 1) * spec.D * s)
    res = {"trapezoid": 12, "euler": 7, "forwardmap": 5}[disc]
    nops = B * ((spec.N_f - 1) * spec.D * (res + 3 + int(diag))
                + spec.N_f * spec.D * (11 + int(disc == "trapezoid"))
                + 9 * n_obs)
    return nbytes, nops


def config5_ladder(dev, tw, spec):
    """Phase 26: BASELINE config #5 through the entries a user calls, as
    examples/ensemble_sweep.py runs it: ``fe.select_action(engine='auto')``
    must take K1's engine and ``solve.pick_rung_solver(solver='auto')``
    K2's rung solver; ``parallel.make_ensemble_ladder`` then runs the 51
    rungs over the 1024 members in calls of 17 warm-started rungs, one K2
    launch a rung (each timed by CUDA events around it). Every record
    finite, every status in {0, 1, 2}. Returns the phase's numbers."""
    from varanneal_tpu_torch.kernels import ag, fe, solve
    from varanneal_tpu_torch.opt import LBFGSOptions
    from varanneal_tpu_torch.parallel import (make_ensemble_ladder,
                                              random_ensemble_inits)
    check((spec.D, spec.N_data, spec.L) == (CONF5["D"], CONF5["N_data"],
                                            CONF5["n_obs"]),
          f"config #5: the problem is not config #5's: D {spec.D}, "
          f"N_data {spec.N_data}, {spec.L} observed")
    opts = LBFGSOptions(m=5, maxiter=CONF5["maxiter"], pgtol=1e-4,
                        ftol=1e-6)
    rf0 = np.float32(4e-6 * tw["RM"])
    act, parts = fe.select_action(spec, rf0, engine="auto",
                                  dtype=torch.float32, device=dev)
    check(act.engine == "ag", f"config #5: engine='auto' took "
          f"{act.engine!r}, not K1's 'ag'")
    rung = solve.pick_rung_solver(spec, rf0, opts, solver="auto",
                                  dtype=torch.float32, device=dev)
    check(rung is not None, "config #5: solver='auto' took the generic "
          "loop, not K2")
    xp = torch.tensor(random_ensemble_inits(spec, CONF5["B"],
                                            seed=CONF5["seed"],
                                            dtype=np.float32), device=dev)
    betas = np.arange(CONF5["n_beta"])
    ag.LAUNCHES = solve.RUNG_LAUNCHES = solve.LADDER_LAUNCHES = 0
    recs = []
    with launch_events(solve, "solve_kernel") as ev:
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        for lo in range(0, CONF5["n_beta"], CONF5["chunk"]):
            r = make_ensemble_ladder(
                act, parts, betas[lo:lo + CONF5["chunk"]], rf0,
                CONF5["alpha"], opts=opts, rung_solver=rung,
                device=dev)(xp)
            xp = r.XP
            recs.append(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
    launches = dict(rung=solve.RUNG_LAUNCHES, ladder=solve.LADDER_LAUNCHES,
                    ag=ag.LAUNCHES)
    A, nfev, status = (torch.cat([getattr(r, k) for r in recs], dim=1)
                       for k in ("A", "nfev", "status"))
    ms_launch, us_eval = per_launch(ev, nfev, 1)
    final = A[:, -1].cpu().numpy()
    qs = np.percentile(final, [0, 25, 50, 75, 100])
    n_best = int(np.sum(final <= qs[0] * 1.01 + 1e-12))
    codes = np.bincount(status.cpu().numpy().ravel(), minlength=4)
    out = dict(wall_s=wall, ms_per_init=1e3 * wall / CONF5["B"],
               nfev=int(nfev.sum()), launches=launches, ms=ms_launch,
               us_per_eval=us_eval, percentiles=qs.tolist(), n_best=n_best,
               maxiter=CONF5["maxiter"])
    print(f"config #5 (D={spec.D}, N={spec.N_f}, {CONF5['B']} members, "
          f"{CONF5['n_beta']} rungs in calls of {CONF5['chunk']}, maxiter "
          f"{CONF5['maxiter']}; engine {act.engine}, K2): wall {wall:.2f} s,"
          f" {out['ms_per_init']:.3f} ms/init/ladder, total nfev "
          f"{out['nfev']}; K2 {ms_launch:.3f} ms a launch, {us_eval:.3f} us "
          f"an evaluation of the slowest member; launches {launches}; "
          f"statuses per code 0..3 {codes.tolist()}; final action "
          f"percentiles [min/25/50/75/max] "
          + ", ".join(f"{q:.4f}" for q in qs)
          + f"; {n_best}/{CONF5['B']} members at the lowest level")
    check(launches["rung"] == CONF5["n_beta"] and launches["ladder"] == 0,
          f"config #5: not one K2 launch a rung: {launches}")
    check(tuple(A.shape) == (CONF5["B"], CONF5["n_beta"])
          and bool(torch.isfinite(A).all())
          and bool(torch.isfinite(xp).all()),
          "config #5: records or endpoints not finite")
    check(codes[3] == 0, f"config #5: line-search failures {codes.tolist()}")
    return out


def profile_k3():
    """One K3 call of the new path (f32, every rung, B members from
    random_ensemble_inits(seed=3)), timed by CUDA events and run again
    under torch.profiler; prints one JSON line. Runs in a process of its
    own: in the long main process the profiler stopped recording device
    activity by this point (runtime calls only), which a fresh process
    does not show."""
    from varanneal_tpu_torch.anneal.ladder import rung_rf
    from varanneal_tpu_torch.kernels import solve
    from varanneal_tpu_torch.opt import LBFGSOptions
    from varanneal_tpu_torch.parallel import random_ensemble_inits
    dev = torch.device("cuda", torch.cuda.current_device())
    tw, spec, rf0 = main_problem()
    opts = LBFGSOptions(m=5, maxiter=500, maxls=20, pgtol=1e-4, ftol=1e-6)
    lad = solve.make_ladder_solver(spec, opts, MAIN["n_beta"], device=dev)
    rfs = np.array([rung_rf(np.float32(rf0), MAIN["alpha"], b,
                            torch.float32) for b in range(MAIN["n_beta"])])
    xp0 = torch.tensor(random_ensemble_inits(spec, MAIN["B"], seed=3,
                                             dtype=np.float32), device=dev)
    ms = events_ms(lambda: lad(xp0, rfs), n=1, warm=1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        _, rec = lad(xp0, rfs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t_p) * 1e6
    dev_rows = [(device_us(e), e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    print(json.dumps(dict(
        ms=ms, wall_us=wall_us, busy_us=sum(r[0] for r in dev_rows),
        k3_us=sum(r[0] for r in dev_rows if "l96_ladder" in r[1]),
        nfev=rec["nfev"].sum(dim=1).tolist(),
        niter=rec["niter"].sum(dim=1).tolist())))
    return 0


def profile_loops(path):
    """The first 50 iterations of rung 60 from the rung-59 minimizers in
    ``path`` (4 members, f32, K1's action) through the fused loop
    (direction auto, which takes K7b on the card; phase 6 profiles the
    compact loop at the same rung) under torch.profiler after one warm
    run; prints one JSON line. A process of its own, as profile_k3."""
    from varanneal_tpu_torch.anneal.ladder import rung_rf
    from varanneal_tpu_torch.kernels import ag
    from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize
    dev = torch.device("cuda", torch.cuda.current_device())
    tw, spec, rf0 = main_problem()
    xp = torch.load(path).to(dev)
    action, _ = ag.make_action_ag(spec, device=dev, dtype=torch.float32)
    vag = action.value_and_grad
    rf = rung_rf(np.float32(rf0), MAIN["alpha"], 60, torch.float32)
    out = {}
    for direction in ("auto",):
        opts = LBFGSOptions(m=5, maxiter=50, maxls=20, pgtol=1e-4,
                            ftol=1e-6, direction=direction)
        lbfgs_minimize(lambda z: vag(z, rf), xp, opts=opts, device=dev)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t_p = time.perf_counter()
            r = lbfgs_minimize(lambda z: vag(z, rf), xp, opts=opts,
                               device=dev)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t_p) * 1e6
        rows = [(device_us(e), e.count, e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        out[direction] = dict(
            wall_us=wall_us, busy_us=sum(x[0] for x in rows),
            k1_us=sum(x[0] for x in rows if "l96_ag_trap" in x[2]),
            k7b_us=sum(x[0] for x in rows if "step_kernel" in x[2]),
            kernels=sum(x[1] for x in rows),
            niter=int(r.niter.max()), nfev=int(r.nfev.max()))
    print(json.dumps(out))
    return 0


def _ptxas_lines(log):
    """The -Xptxas -v report's lines that describe code (registers,
    barriers, spills, stack), each with the function's name dropped, in
    order; and the names."""
    lines, names = [], []
    for ln in log.splitlines():
        body = ln.split(":", 1)[-1].strip()
        if "Compiling entry function" in ln or "Function properties" in ln:
            names.append(body)
        elif "Used" in ln or "bytes stack frame" in ln:
            lines.append(body)
    return lines, names


def _nvcc(src, out, defines=()):
    """One nvcc of ``src`` into the library ``out`` with the port's flags
    (-Xptxas -v included) and ``defines``, started (a Popen)."""
    from varanneal_tpu_torch.kernels import _build
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, *defines,
                             "-o", out, src], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def ptxas_diff(other):
    """Build ag_kernel.cu (K1, K4) and solve_kernel.cu (K2, K3) of this
    checkout and of the checkout at ``other`` with the port's nvcc flags,
    and compare their -Xptxas -v reports: per source, the lines of
    registers, barriers, spills and stack frames, in order, names dropped
    (a template argument added to a __device__ function changes its
    mangled name, not its code). Prints both and one JSON line; returns 0
    when every source's lines are identical. Against a checkout from
    before K2/K3's redesign for the card (the layout argument, one barrier
    a reduction, fewer reductions), solve_kernel.cu is expected to differ;
    ag_kernel.cu is not."""
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in ("ag_kernel", "solve_kernel"):
            for tag, root in (("this", ROOT), ("other", other)):
                src = os.path.join(root, "varanneal_tpu_torch", "kernels",
                                   "csrc", name + ".cu")
                procs[(name, tag)] = _nvcc(
                    src, os.path.join(tmp, f"{name}-{tag}.so"))
        logs = {}
        for key, proc in procs.items():
            so, se = proc.communicate()
            check(proc.returncode == 0, f"nvcc failed for {key}:\n{se}")
            logs[key] = _ptxas_lines(so + se)
    for name in ("ag_kernel", "solve_kernel"):
        (a, na), (b, nb) = logs[(name, "this")], logs[(name, "other")]
        for tag, lines, names in (("this", a, na), ("other", b, nb)):
            print(f"ptxas {name} ({tag}): {len(names)} functions")
            for ln in lines:
                print(f"  {ln}")
        result[name] = dict(identical=a == b,
                            same_multiset=sorted(a) == sorted(b),
                            lines=len(a))
    print(json.dumps(result))
    return 0 if all(r["identical"] for r in result.values()) else 1


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main():
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from varanneal_tpu_torch.kernels import _build, ag, fe, solve, solve_pack
    from varanneal_tpu_torch.kernels import dir as kdir
    from varanneal_tpu_torch.api import (Annealer, build_bounds,
                                         make_lbfgs_options)
    from varanneal_tpu_torch.anneal import run_ladder_checkpointed
    from varanneal_tpu_torch.ops import build_spec, make_action, pack
    from varanneal_tpu_torch.ops.spec import _insert_midpoints
    from varanneal_tpu_torch.twin import lorenz96_twin
    from varanneal_tpu_torch.ops import value_and_grad
    from varanneal_tpu_torch.opt import LBFGSOptions, lbfgs_minimize
    from varanneal_tpu_torch.anneal import run_ladder
    from varanneal_tpu_torch.anneal.ladder import rung_rf
    from varanneal_tpu_torch.parallel import (make_ensemble_ladder,
                                              random_ensemble_inits)

    # ---- 1. device -------------------------------------------------------
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    nvcc_v = subprocess.run([_build.nvcc(), "--version"],
                            capture_output=True, text=True, timeout=60,
                            check=True).stdout.strip().splitlines()[-1]
    print(f"device: {name}; count {torch.cuda.device_count()}")
    print(smi)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc_v}")
    phase("1 device", t0)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    # the measuring build of K2/K3 (group barriers counted; phase 9),
    # started with the six
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    bar_path = str(_build.BUILD_DIR / "libsolve_kernel-barriers.so")
    bar_proc = _nvcc(str(_build.CSRC / "solve_kernel.cu"), bar_path,
                     ("-DVA_COUNT_BARRIERS",))
    built = _build.build(["ag_kernel", "solve_kernel", "dir_kernel",
                          "fe_kernel", "agt_kernel", "pack_kernel"])
    for b in built.values():
        print(f"nvcc build of {b.path.name}: {b.seconds:.2f} s "
              "(the six builds run in parallel)")
        for line in b.log.splitlines():
            if ("Compiling entry" in line or "Function properties" in line
                    or "Used" in line or "bytes stack frame" in line):
                print(f"ptxas {b.name}:", line.strip())
    bar_err = bar_proc.communicate()[1]
    check(bar_proc.returncode == 0,
          f"nvcc failed for the barrier-counting build:\n{bar_err}")
    import ctypes
    bar_lib = solve.typed(ctypes.CDLL(bar_path))
    bar_lib.va_barriers_read.restype = ctypes.c_int
    bar_lib.va_barriers_read.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    print(f"nvcc build of {os.path.basename(bar_path)} (K2/K3 counting "
          f"group barriers): {time.perf_counter() - t0:.2f} s")
    phase("2 build", t0)

    tw, spec, rf0 = main_problem()

    # ---- 3. kernel vs plain at the main path's shape -----------------------
    t0 = time.perf_counter()
    draws = member_draws(spec, tw, 0)
    rel_k1 = 0.0        # the kernels line's max_rel_err of K1
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 2e-5)):
        c = ag.ag_consts(spec, dev, dtype)
        Z = torch.tensor(draws, dtype=dtype, device=dev)
        for beta in (0, 50, 100):
            rf = float(rf0 * MAIN["alpha"] ** beta)
            A, G = ag.ag_kernel(Z, rf, c)
            torch.cuda.synchronize()
            A_r, G_r = ag.ag_reference(Z, rf, c)
            rel_a = float(torch.max(torch.abs(A - A_r) / torch.abs(A_r)))
            scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
            rel_g = float(torch.max(torch.abs(G - G_r) / scale))
            rel_k1 = max(rel_k1, rel_a, rel_g)
            print(f"K1 {str(dtype)[6:]} beta={beta}: A rel err {rel_a:.3e},"
                  f" gradient rel err {rel_g:.3e} (bound {tol:g})")
            check(rel_a <= tol and rel_g <= tol,
                  f"K1 {dtype} disagrees with its plain version at "
                  f"beta={beta}")
    # config #5's width (the wide walk), B=4, rf of beta 0, 25, 50
    tw5, spec5 = config5_problem()
    draws5 = member_draws(spec5, tw5, 0)
    rel_k1_d400 = 0.0
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 2e-5)):
        c = ag.ag_consts(spec5, dev, dtype)
        Z = torch.tensor(draws5, dtype=dtype, device=dev)
        for beta in (0, 25, 50):
            rf = float(4e-6 * tw5["RM"] * MAIN["alpha"] ** beta)
            A, G = ag.ag_kernel(Z, rf, c)
            torch.cuda.synchronize()
            A_r, G_r = ag.ag_reference(Z, rf, c)
            rel_a = float(torch.max(torch.abs(A - A_r) / torch.abs(A_r)))
            scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
            rel_g = float(torch.max(torch.abs(G - G_r) / scale))
            rel_k1_d400 = max(rel_k1_d400, rel_a, rel_g)
            print(f"K1 D=400 {str(dtype)[6:]} beta={beta}: A rel err "
                  f"{rel_a:.3e}, gradient rel err {rel_g:.3e} (bound "
                  f"{tol:g})")
            check(rel_a <= tol and rel_g <= tol,
                  f"K1 D=400 {dtype} disagrees with its plain version at "
                  f"beta={beta}")
    c5_32 = ag.ag_consts(spec5, dev, torch.float32)
    Z5_32 = torch.tensor(draws5, dtype=torch.float32, device=dev)
    rf5 = float(np.float32(4e-6 * tw5["RM"] * MAIN["alpha"] ** 25))
    ms_k1_d400 = events_ms(lambda: ag.ag_kernel(Z5_32, rf5, c5_32), n=200)
    print(f"K1 D=400 f32 B={MAIN['B']}: kernel {ms_k1_d400:.5f} ms/launch "
          "(CUDA events, 200 calls)")

    c32 = ag.ag_consts(spec, dev, torch.float32)
    Z32 = torch.tensor(draws, dtype=torch.float32, device=dev)
    rf_t = float(np.float32(rf0 * MAIN["alpha"] ** 50))
    act32, _ = make_action(spec, device=dev)
    vag32 = value_and_grad(act32)

    ms_kernel = events_ms(lambda: ag.ag_kernel(Z32, rf_t, c32))
    ms_plain = events_ms(lambda: ag.ag_reference(Z32, rf_t, c32))
    ms_autograd = events_ms(lambda: vag32(Z32, rf_t))
    print(f"K1 f32 B={MAIN['B']}: kernel {ms_kernel:.5f} ms/launch, plain "
          f"{ms_plain:.5f} ms, autograd action value+grad "
          f"{ms_autograd:.5f} ms (CUDA events, 1000 calls each)")

    # the kernel's own device time (CUPTI, through torch.profiler): the
    # event timing above also counts the host's time to enqueue a launch
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            ag.ag_kernel(Z32, rf_t, c32)
        torch.cuda.synchronize()
    k1_dev = [(device_us(e), e.count) for e in prof.key_averages()
              if "l96_ag_trap" in e.key]
    if k1_dev and k1_dev[0][0] > 0:
        print(f"K1 f32 device time per launch (torch.profiler): "
              f"{k1_dev[0][0] / k1_dev[0][1] / 1e3:.5f} ms over "
              f"{k1_dev[0][1]} launches")
    else:
        print("K1 f32 device time per launch (torch.profiler): "
              "not measured (no device events)")

    # least time for the same work: each input read once, each output
    # written once, over HBM; the operations the kernel's arithmetic needs
    # (15 per residual entry forward, 4 per observation for ME, 15 per
    # state entry for the adjoint, 5 per observation for ME's gradient)
    # over the f32 rate
    B, n_dof, N, D = MAIN["B"], spec.n_dof, spec.N_f, spec.D
    s = 4
    n_obs = spec.N_data * spec.L
    nbytes = (B * n_dof * s + 2 * n_obs * s + 4 * (spec.L + D)
              + B * s + B * n_dof * s)
    nops = B * (15 * (N - 1) * D + 4 * n_obs + 15 * N * D + 5 * n_obs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[torch.float32] * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    print(f"K1 bound: {nbytes} bytes, {nops} operations -> "
          f"{bound_ms:.3e} ms ({bound_by})")
    phase("3 kernel vs plain", t0)

    # ---- 4. f64 short ladder: kernel vs plain ------------------------------
    # Both ladders must reach the same minima to 1e-8, so every rung is
    # solved to pgtol (ftol off) from near the truth with the model error
    # weighted like the data (rf0 = RM). An ftol stop, or a rung at low rf
    # (flat, data-dominated), ends at a point that moves far more than
    # 1e-8 under rounding alone; two correct f64 implementations could not
    # pass there.
    t0 = time.perf_counter()
    act64k, parts64 = ag.make_action_ag(spec, device=dev,
                                        dtype=torch.float64)
    c64 = act64k.consts

    def plain64(XP, rf):
        return ag.ag_reference(XP, rf, c64)[0]

    plain64.value_and_grad = lambda XP, rf: ag.ag_reference(XP, rf, c64)
    opts_t = LBFGSOptions(m=5, maxiter=3000, maxls=20, pgtol=1e-8, ftol=0.0)
    rng = np.random.default_rng(1)
    xp2 = torch.tensor(np.stack([
        pack(spec, tw["traj"] + 0.3 * rng.normal(size=tw["traj"].shape),
             np.array([tw["F"] + 0.5 * rng.normal()])) for _ in range(2)]),
        device=dev)
    runs = []
    for a in (act64k, plain64):
        runs.append(make_ensemble_ladder(a, parts64, np.arange(F64_RUNGS),
                                         float(tw["RM"]), MAIN["alpha"],
                                         opts=opts_t, device=dev)(xp2))
    stat_k = runs[0].status.cpu().numpy()
    stat_p = runs[1].status.cpu().numpy()
    A_k, A_p = runs[0].A.cpu().numpy(), runs[1].A.cpu().numpy()
    both = (stat_k <= 1) & (stat_p <= 1)
    rel = np.abs(A_k - A_p) / np.abs(A_p)
    print(f"f64 ladder: mutually converged rungs {int(both.sum())}/"
          f"{both.size}; max rel A difference {rel[both].max():.3e}; "
          f"niter kernel {runs[0].niter.sum().item()}, plain "
          f"{runs[1].niter.sum().item()}")
    check(both.mean() >= 0.8, f"too few converged rungs: {stat_k} {stat_p}")
    check(np.all(rel[both] <= 1e-8),
          f"f64 ladder through the kernel disagrees: {rel}")
    phase("4 f64 ladder kernel vs plain", t0)

    # ---- 5. the main path ---------------------------------------------------
    t0 = time.perf_counter()
    action, parts = ag.make_action_ag(spec, device=dev, dtype=torch.float32)
    # direction left at auto: on the card the fused loop (K7b, phase 11)
    opts_f = LBFGSOptions(m=5, maxiter=500, maxls=20, pgtol=1e-4, ftol=1e-6)
    ladder = make_ensemble_ladder(action, parts, np.arange(MAIN["n_beta"]),
                                  np.float32(rf0), MAIN["alpha"],
                                  opts=opts_f, store_paths=True, device=dev)
    xp0 = torch.tensor(random_ensemble_inits(spec, MAIN["B"], seed=3,
                                             dtype=np.float32), device=dev)
    check(kdir.dir_supported(xp0, opts_f.m),
          "direction='auto' would not take the kernels on the main path")
    ag.LAUNCHES = kdir.STEP_LAUNCHES = kdir.DIR_LAUNCHES = 0
    t_lad = time.perf_counter()
    res = ladder(xp0)
    torch.cuda.synchronize()
    wall_f32 = time.perf_counter() - t_lad
    launches = ag.LAUNCHES
    launch_f = dict(k1=ag.LAUNCHES, k7b=kdir.STEP_LAUNCHES,
                    k7a=kdir.DIR_LAUNCHES)

    # the f64 tail's action and options (phases 11 and 23 run tails): K1 in
    # f64, the same function as the autograd action (phase 3 holds the
    # two to 1e-12), ~70x cheaper an evaluation
    act64, parts64a = ag.make_action_ag(spec, device=dev,
                                        dtype=torch.float64)
    opts64 = LBFGSOptions(maxiter=2000, pgtol=1e-8, ftol=2.22e-9,
                          direction="compact")

    nfev = res.nfev.cpu().numpy()                  # (B, n_beta)
    total_nfev = int(nfev.sum())
    lockstep_nfev = int(nfev.max(axis=0).sum())
    print(f"main path f32 ladder (the fused loop): {MAIN['n_beta']} rungs "
          f"x {MAIN['B']} members in {wall_f32:.2f} s; total nfev "
          f"{total_nfev} (sum over members), per-rung max over members "
          f"summed {lockstep_nfev}; launches {launch_f}")
    print(f"f32 ladder statuses (count per code 0..3): "
          f"{np.bincount(res.status.cpu().numpy().ravel(), minlength=4)}")
    check(launches >= lockstep_nfev > 0,
          f"main path did not go through K1: {launches} launches for "
          f"{lockstep_nfev} evaluations")
    for nm, t in (("XP", res.XP), ("A", res.A)):
        check(bool(torch.isfinite(t).all()), f"non-finite {nm}")
    check(tuple(res.A.shape) == (MAIN["B"], MAIN["n_beta"]),
          "unexpected record shapes")
    phase("5 main path", t0)

    # ---- 6. K1 on the main path's own inputs; one rung under the profiler
    t0 = time.perf_counter()
    # At a minimizer the gradient is a small difference of large terms,
    # and at the top rungs the residuals are f32 round-off themselves, so
    # the kernel's f32 error is judged against the exact (f64) value on
    # the same inputs: within 4x the plain f32 version's own error.
    c64m = ag.ag_consts(spec, dev, torch.float64)
    max_abs = ratio_k1 = 0.0
    for k in (0, 60, MAIN["n_beta"] - 1):
        rf_k = rung_rf(np.float32(rf0), MAIN["alpha"], k, torch.float32)
        XP_k = res.paths[:, k].contiguous()
        errs, at, med, (A, G, A_r, G_r) = minimizer_errs(
            ag.ag_kernel, ag.ag_reference, XP_k, rf_k, c32, c64m)
        err = max(float(torch.max(torch.abs(A - A_r))),
                  float(torch.max(torch.abs(G - G_r))))
        max_abs = max(max_abs, err)
        ratio_k1 = max(ratio_k1, err_ratio(errs))
        print(f"K1 f32 at the main path's minimizer of rung {k}: max abs "
              f"err vs plain {err:.3e}; error vs f64, the kernel's at the "
              f"minimizer / the plain f32 version's median over 24 f32 "
              f"neighbours: A {errs[0]:.3e} / {errs[1]:.3e}, gradient "
              f"{errs[2]:.3e} / {errs[3]:.3e} (bound 4x plain; the plain "
              f"version's at the minimizer A {at[0]:.3e}, gradient "
              f"{at[1]:.3e}; the kernel's median A {med[0]:.3e}, gradient "
              f"{med[1]:.3e})")
        check(errs[0] <= 4.0 * errs[1] and errs[2] <= 4.0 * errs[3],
              f"K1 disagrees with its plain version at rung {k}")

    k_prof = 60
    rf_p = rung_rf(np.float32(rf0), MAIN["alpha"], k_prof, torch.float32)
    xp_p = res.paths[:, k_prof - 1].contiguous()
    vag = action.value_and_grad
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_p = time.perf_counter()
        rp = lbfgs_minimize(lambda z: vag(z, rf_p), xp_p,
                            opts=dataclasses.replace(opts_f, maxiter=50,
                                                     direction="compact"),
                            device=dev)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t_p) * 1e6
    # device-side rows only (kernels, copies); a CPU op's row repeats the
    # time of the kernels it launched
    dev_rows = sorted(((device_us(e), e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
    busy = sum(r[0] for r in dev_rows)
    k1_us = sum(r[0] for r in dev_rows if "l96_ag_trap" in r[2])
    print(f"profiled: the first {int(rp.niter.max())} iterations of rung "
          f"{k_prof} (4 members, {int(rp.nfev.max())} evaluations of the "
          f"slowest member): wall {wall_p / 1e3:.1f} ms under the profiler; "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_p:.1f} %), "
          f"K1 {k1_us / 1e3:.2f} ms ({100 * k1_us / wall_p:.1f} %); "
          f"{sum(r[1] for r in dev_rows)} device kernels in "
          f"{len(dev_rows)} kinds")
    for us, cnt, key in dev_rows[:6]:
        print(f"  device {us / 1e3:8.3f} ms  {cnt:6d}x  {key[:70]}")
    phase("6 main-path inputs and profile", t0)

    # ---- 7. K2 and K3 vs their plain versions in f64 ------------------------
    t0 = time.perf_counter()
    opts_s = LBFGSOptions(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6)
    betas_s = (0, 50, 100)
    Z64 = torch.tensor(draws, dtype=torch.float64, device=dev)
    err_k2 = 0.0
    rel_k2 = rel_k3 = 0.0   # the kernels line's max_rel_err of K2, K3
    for beta in betas_s:
        rf = rung_rf(rf0, MAIN["alpha"], beta, torch.float64)
        rk = solve.solve_kernel(Z64, rf, c64m, opts_s)
        x3, rec3 = solve.ladder_kernel(
            Z64, torch.tensor([rf], dtype=torch.float64, device=dev), c64m,
            opts_s)
        torch.cuda.synchronize()
        rp = solve.solve_reference(Z64, rf, c64m, opts_s)
        scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
        rel2 = float(torch.max(torch.abs(rk.x - rp.x) / scale))
        rel3 = float(torch.max(torch.abs(x3 - rp.x) / scale))
        rel_k2, rel_k3 = max(rel_k2, rel2), max(rel_k3, rel3)
        err_k2 = max(err_k2, float(torch.max(torch.abs(rk.x - rp.x))))
        print(f"K2/K3 f64 short solve beta={beta}: niter {rk.niter.tolist()}"
              f" / {rec3['niter'][:, 0].tolist()} / plain "
              f"{rp.niter.tolist()}; nfev {rk.nfev.tolist()} / "
              f"{rec3['nfev'][:, 0].tolist()} / {rp.nfev.tolist()}; status "
              f"{rk.status.tolist()} / {rec3['status'][:, 0].tolist()} / "
              f"{rp.status.tolist()}; x rel err K2 {rel2:.3e}, K3 "
              f"{rel3:.3e} (bound 1e-8); K3 bit-identical to K2: "
              f"{torch.equal(x3, rk.x)}")
        for nm, got in (("K2", (rk.niter, rk.nfev, rk.status)),
                        ("K3", (rec3["niter"][:, 0], rec3["nfev"][:, 0],
                                rec3["status"][:, 0]))):
            check(all(torch.equal(u, v) for u, v in
                      zip(got, (rp.niter, rp.nfev, rp.status))),
                  f"{nm} f64 counts differ from the plain version at "
                  f"beta={beta}")
        check(rel2 <= 1e-8 and rel3 <= 1e-8,
              f"K2/K3 f64 x differs from the plain version at beta={beta}")
        rk2 = solve.solve_kernel(Z64, rf, c64m, opts_s)
        check(all(torch.equal(u, v) for u, v in zip(rk, rk2)),
              "K2 repeated launch is not bit-identical")

    # phase 4's f64 ladder, 4 members: K3, K2 through the hook, plain
    opts_t = LBFGSOptions(m=5, maxiter=3000, maxls=20, pgtol=1e-8, ftol=0.0)
    rng = np.random.default_rng(1)
    xp4 = torch.tensor(np.stack([
        pack(spec, tw["traj"] + 0.3 * rng.normal(size=tw["traj"].shape),
             np.array([tw["F"] + 0.5 * rng.normal()]))
        for _ in range(MAIN["B"])]), device=dev)
    rfs_t = np.array([rung_rf(float(tw["RM"]), MAIN["alpha"], b,
                              torch.float64) for b in range(F64_RUNGS)])
    lad_t = solve.make_ladder_solver(spec, opts_t, F64_RUNGS, device=dev)
    x_k3, r_k3 = lad_t(xp4, rfs_t)
    torch.cuda.synchronize()
    x_k3b, r_k3b = lad_t(xp4, rfs_t)
    torch.cuda.synchronize()
    check(torch.equal(x_k3, x_k3b)
          and all(torch.equal(r_k3[k], r_k3b[k]) for k in r_k3),
          "K3 repeated launch is not bit-identical")
    hook = make_ensemble_ladder(
        act64k, parts64, np.arange(F64_RUNGS), float(tw["RM"]),
        MAIN["alpha"], opts=opts_t,
        rung_solver=solve.make_rung_solver(spec, opts_t, device=dev),
        device=dev)(xp4)
    t_pl = time.perf_counter()
    x_pl, r_pl = solve.ladder_reference(xp4, rfs_t, c64m, opts_t)
    torch.cuda.synchronize()
    print(f"f64 plain ladder ({F64_RUNGS} rungs, 4 members): "
          f"{time.perf_counter() - t_pl:.2f} s")
    ok_pl = r_pl["status"].cpu().numpy() <= 1
    A_pl = r_pl["A"].cpu().numpy()
    err_k3 = 0.0
    for nm, A_x, st_x in (("K3", r_k3["A"], r_k3["status"]),
                          ("K2 via the hook", hook.A, hook.status)):
        both = ok_pl & (st_x.cpu().numpy() <= 1)
        d = np.abs(A_x.cpu().numpy() - A_pl)
        rel = d / np.abs(A_pl)
        if nm == "K3":
            err_k3 = float(d[both].max())
            rel_k3 = max(rel_k3, float(rel[both].max()))
        print(f"f64 {F64_RUNGS}-rung ladder {nm} vs plain: mutually "
              f"converged rungs "
              f"{int(both.sum())}/{both.size}; max rel A difference "
              f"{rel[both].max():.3e} (bound 1e-8)")
        check(both.mean() >= 0.8, f"{nm}: too few converged rungs")
        check(np.all(rel[both] <= 1e-8),
              f"f64 ladder through {nm} disagrees: {rel}")
    phase("7 K2/K3 vs plain f64", t0)

    # ---- 8. K2 and K3 vs plain in f32; their times on these solves -------
    t0 = time.perf_counter()
    # Witness: the plain version on the CPU, the same arithmetic summed in
    # another order. At the top rungs the action is f32 round-off, and two
    # correct f32 solves part there after a few iterations; the kernels'
    # f may differ from the plain version's by up to twice what the plain
    # version differs from itself across summation orders, and never by
    # less than 1e-4 is asked. Counts and statuses must be identical.
    c32_cpu = ag.ag_consts(spec, "cpu", torch.float32)
    rfs_s = [rung_rf(np.float32(rf0), MAIN["alpha"], b, torch.float32)
             for b in betas_s]
    ms_k2, ms_p2, work_k2 = [], [], [0, 0]
    for beta, rf in zip(betas_s, rfs_s):
        rk = solve.solve_kernel(Z32, rf, c32, opts_s)
        x3, rec3 = solve.ladder_kernel(
            Z32, torch.tensor([rf], device=dev), c32, opts_s)
        torch.cuda.synchronize()
        t_p = time.perf_counter()
        rp = solve.solve_reference(Z32, rf, c32, opts_s)
        torch.cuda.synchronize()
        ms_p2.append((time.perf_counter() - t_p) * 1e3)
        rc = solve.solve_reference(Z32.cpu(), rf, c32_cpu, opts_s)
        wit = float(torch.max(torch.abs(rp.f.cpu() - rc.f) / torch.abs(rc.f)))
        f_bound = max(1e-4, 2.0 * wit)
        check(all(torch.equal(u.cpu(), v) for u, v in
                  zip((rp.niter, rp.nfev, rp.status),
                      (rc.niter, rc.nfev, rc.status))),
              f"f32 plain solve on the card and on the CPU differ in counts "
              f"at beta={beta}")
        ms_k2.append(events_ms(lambda: solve.solve_kernel(Z32, rf, c32,
                                                          opts_s), n=5))
        work_k2[0] += int(rk.nfev.sum())
        work_k2[1] += int(rk.niter.sum())
        for nm, f_x, cnt in (("K2", rk.f, (rk.niter, rk.nfev, rk.status)),
                             ("K3", rec3["A"][:, 0],
                              (rec3["niter"][:, 0], rec3["nfev"][:, 0],
                               rec3["status"][:, 0]))):
            rel = float(torch.max(torch.abs(f_x - rp.f) / torch.abs(rp.f)))
            if nm == "K2":
                rel_k2 = max(rel_k2, rel)
            else:
                rel_k3 = max(rel_k3, rel)
            print(f"{nm} f32 short solve beta={beta}: f rel err {rel:.3e}, "
                  f"plain on the card vs on the CPU {wit:.3e} (bound "
                  f"{f_bound:.3e}); niter {cnt[0].tolist()} / plain "
                  f"{rp.niter.tolist()}; nfev {cnt[1].tolist()} / "
                  f"{rp.nfev.tolist()}; status {cnt[2].tolist()} / "
                  f"{rp.status.tolist()}")
            check(rel <= f_bound and all(
                torch.equal(u, v) for u, v in
                zip(cnt, (rp.niter, rp.nfev, rp.status))),
                f"{nm} f32 disagrees with its plain version at beta={beta}")
    ms_k2 = float(np.mean(ms_k2))
    ms_p2 = float(np.mean(ms_p2))
    rfs3 = torch.tensor(rfs_s, device=dev)
    _, rec3 = solve.ladder_kernel(Z32, rfs3, c32, opts_s)
    ms_k3 = events_ms(lambda: solve.ladder_kernel(Z32, rfs3, c32, opts_s),
                      n=5)
    t_p = time.perf_counter()
    solve.ladder_reference(Z32, rfs_s, c32, opts_s)
    torch.cuda.synchronize()
    ms_p3 = (time.perf_counter() - t_p) * 1e3
    bound_k2 = solve_bound(spec, torch.float32, MAIN["B"], len(betas_s),
                           work_k2[0], work_k2[1], opts_s.m, rungs=1)
    bound_k3 = solve_bound(spec, torch.float32, MAIN["B"], 1,
                           int(rec3["nfev"].sum()), int(rec3["niter"].sum()),
                           opts_s.m, rungs=len(betas_s))
    print(f"K2 f32 (B=4, maxiter 30, one rung a launch): {ms_k2:.4f} ms a "
          f"launch (CUDA events), plain {ms_p2:.4f} ms; bound "
          f"{bound_k2[0]:.3e} ms ({bound_k2[1]}: {bound_k2[2]} bytes, "
          f"{bound_k2[3]} operations per launch)")
    print(f"K3 f32 (B=4, the 3 rungs warm-started in one launch): "
          f"{ms_k3:.4f} ms a launch, plain {ms_p3:.4f} ms; bound "
          f"{bound_k3[0]:.3e} ms ({bound_k3[1]}: {bound_k3[2]} bytes, "
          f"{bound_k3[3]} operations)")
    # the layouts the planner gives at the main shape, as the kernels
    # compute their shared memory, and the built kernels' attributes
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slib = solve._lib()
    layouts = {}
    for dt in (torch.float32, torch.float64):
        for bd in (False, True):
            lay = solve.plan_layout(spec.D, spec.n_dof, 5, dt, bd,
                                    MAIN["B"], sms)
            smem_c = slib.va_l96_solve_smem(spec.D, spec.n_dof, 5,
                                            lay.flags,
                                            int(dt == torch.float64))
            check(smem_c == lay.smem_bytes,
                  f"the planner's shared memory {lay.smem_bytes} differs "
                  f"from the kernel's {smem_c} ({dt}, bounded {bd})")
            layouts[(str(dt)[6:], bd)] = lay
    k23_attrs = {f"{nm}_{str(dt)[6:]}{'_bounded' if bd else ''}":
                 solve.kernel_attrs(nm == "K3", dt, bd,
                                    layouts[(str(dt)[6:], bd)].flags)
                 for nm, bds in (("K2", (False, True)), ("K3", (False,)))
                 for dt in (torch.float32, torch.float64) for bd in bds}
    k23_attrs["K2_float32_global"] = solve.kernel_attrs(False, torch.float32,
                                                        False, 0)
    print("K2/K3 layouts at the main shape (m=5; flags 1 vectors, 2 "
          "history, 4 box on chip, 8 the rings off chip): " + "; ".join(
              f"{d}{' bounded' if bd else ''} flags {lay.flags}, "
              f"{lay.smem_bytes} B of shared memory, workspace "
              f"{lay.work_elems} values a member"
              for (d, bd), lay in layouts.items()))
    print("K2/K3 kernels (cudaFuncGetAttributes): " + "; ".join(
        f"{k} {a['regs']} registers, {a['local_bytes']} B local memory"
        for k, a in k23_attrs.items()))
    # K2 on phase 8's short solves at B=4 and at B=264 (two members an
    # SM), in both layouts: printed, not held
    rf50 = rfs_s[1]
    k2_wide = {}
    for B_ in (MAIN["B"], 264):
        Zw = Z32 if B_ == MAIN["B"] else torch.tensor(
            member_draws(spec, tw, 0, B_), dtype=torch.float32, device=dev)
        plan = solve.plan_layout(spec.D, spec.n_dof, 5, torch.float32,
                                 False, B_, sms).flags
        for nm, lay in (("planner", None), ("global", 0),
                        ("on chip", solve.VECTORS | solve.HISTORY)):
            k2_wide[(B_, nm)] = events_ms(lambda: solve.solve_kernel(
                Zw, rf50, c32, opts_s, _layout=lay), n=5, warm=2)
        print(f"K2 f32 short solves (maxiter 30, the rf of beta 50) at "
              f"B={B_}: planner's layout (flags {plan}) "
              f"{k2_wide[(B_, 'planner')]:.4f} ms, global "
              f"{k2_wide[(B_, 'global')]:.4f} ms, on chip "
              f"{k2_wide[(B_, 'on chip')]:.4f} ms a launch (CUDA events; "
              "printed, not held)")
    # config #5's width: K2 and K3 (one rung) short solves at D=400, B=4,
    # rf of beta 0, 25, 50, against the plain version on the card:
    # identical counts; f64 x within 1e-8, f32 f within the gate above
    # (1e-4, or twice the plain version's card-vs-CPU spread)
    rel_d400 = {"K2": 0.0, "K3": 0.0}
    for dtype in (torch.float64, torch.float32):
        c = ag.ag_consts(spec5, dev, dtype)
        c_cpu = ag.ag_consts(spec5, "cpu", dtype)
        Z = torch.tensor(draws5, dtype=dtype, device=dev)
        for beta in (0, 25, 50):
            rf = rung_rf(4e-6 * tw5["RM"] if dtype == torch.float64
                         else np.float32(4e-6 * tw5["RM"]), MAIN["alpha"],
                         beta, dtype)
            rk = solve.solve_kernel(Z, rf, c, opts_s)
            x3, rec3_5 = solve.ladder_kernel(
                Z, torch.tensor([rf], dtype=dtype, device=dev), c, opts_s)
            rp = solve.solve_reference(Z, rf, c, opts_s)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                rc = solve.solve_reference(Z.cpu(), rf, c_cpu, opts_s)
                wit = float(torch.max(torch.abs(rp.f.cpu() - rc.f)
                                      / torch.abs(rc.f)))
                bound5, what = max(1e-4, 2.0 * wit), "f"
            else:
                bound5, what = 1e-8, "x"
            for nm, x_, f_x, cnt in (
                    ("K2", rk.x, rk.f, (rk.niter, rk.nfev, rk.status)),
                    ("K3", x3, rec3_5["A"][:, 0],
                     (rec3_5["niter"][:, 0], rec3_5["nfev"][:, 0],
                      rec3_5["status"][:, 0]))):
                if dtype == torch.float32:
                    rel = float(torch.max(torch.abs(f_x - rp.f)
                                          / torch.abs(rp.f)))
                else:
                    scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
                    rel = float(torch.max(torch.abs(x_ - rp.x) / scale))
                rel_d400[nm] = max(rel_d400[nm], rel)
                same = all(torch.equal(u, v) for u, v in
                           zip(cnt, (rp.niter, rp.nfev, rp.status)))
                print(f"{nm} D=400 {str(dtype)[6:]} short solve beta={beta}"
                      f": {what} rel err {rel:.3e} (bound {bound5:.3e}); "
                      f"counts as plain {same}; niter {cnt[0].tolist()}, "
                      f"nfev {cnt[1].tolist()}, status {cnt[2].tolist()}")
                check(same and rel <= bound5,
                      f"{nm} D=400 {dtype} disagrees with its plain version "
                      f"at beta={beta}")
    rf5_25 = rung_rf(np.float32(4e-6 * tw5["RM"]), MAIN["alpha"], 25,
                     torch.float32)
    ms_k2_d400 = events_ms(lambda: solve.solve_kernel(Z5_32, rf5_25, c5_32,
                                                      opts_s), n=4, warm=1)
    print(f"K2 D=400 f32 short solves (B=4, maxiter 30, the rf of beta 25):"
          f" {ms_k2_d400:.4f} ms a launch (CUDA events); layout flags "
          + str(solve.launch_layout(Z5_32, c5_32, opts_s).flags))
    phase("8 K2/K3 vs plain f32 and times", t0)

    # ---- 9. the new path: the port's bench, K3 then K2 ----------------------
    t0 = time.perf_counter()
    # one K3 ladder call of the new path, timed and profiled in a child
    # process (see profile_k3)
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--profile-k3"], capture_output=True, text=True,
                           timeout=600, cwd=ROOT)
    check(child.returncode == 0, "the K3 profile failed:\n" + child.stdout
          + child.stderr)
    pk = json.loads(child.stdout.strip().splitlines()[-1])
    check(pk["k3_us"] > 0, "torch.profiler recorded no K3 device time")
    bound_main = solve_bound(spec, torch.float32, MAIN["B"], 1,
                             int(sum(pk["nfev"])), int(sum(pk["niter"])), 5,
                             rungs=MAIN["n_beta"])
    print(f"K3 main path (f32, {MAIN['n_beta']} rungs, B={MAIN['B']}, in a "
          f"child process): {pk['ms']:.3f} ms a launch (CUDA events); "
          f"profiled call wall {pk['wall_us'] / 1e3:.3f} ms, device busy "
          f"{pk['busy_us'] / 1e3:.3f} ms "
          f"({100 * pk['busy_us'] / pk['wall_us']:.1f} %), K3 device time "
          f"{pk['k3_us'] / 1e3:.3f} ms; nfev per member {pk['nfev']}, "
          f"niter per member {pk['niter']}; bound {bound_main[0]:.3e} ms "
          f"({bound_main[1]}: {bound_main[2]} bytes, {bound_main[3]} "
          f"operations)")
    from varanneal_tpu_torch import bench
    paths = {}
    # the fused path's f32 ladder must be K3's bit for bit (one solve_one
    # in both kernels), so its f64 tail would be K3's: it runs no tail
    for solver_name, want, tail64 in (
            ("ladder", dict(ladder=1, rung=0), str(MAIN["tail"])),
            ("fused", dict(ladder=0, rung=MAIN["n_beta"]), "0")):
        ag.LAUNCHES = 0
        solve.LADDER_LAUNCHES = 0
        solve.RUNG_LAUNCHES = 0
        buf_out, buf_err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf_out), \
                contextlib.redirect_stderr(buf_err), \
                launch_events(solve, "solve_kernel") as ev_k2:
            run = bench.main(device=dev, env=dict(
                BENCH_SOLVER=solver_name, BENCH_NINIT=str(MAIN["B"]),
                BENCH_TAIL64=tail64))
        if solver_name == "fused":      # K2's time a launch on its path
            k2_main = per_launch(ev_k2, run.res.nfev, run.calls)
        counts = dict(ag=ag.LAUNCHES, ladder=solve.LADDER_LAUNCHES,
                      rung=solve.RUNG_LAUNCHES)
        print(f"bench {solver_name}: " + buf_out.getvalue().strip())
        print(f"bench {solver_name}: " + buf_err.getvalue().strip())
        if run.tail is not None:
            A_t = run.tail.A.cpu().numpy()
            fa0 = float(A_t[0, -1])
            rel = abs(fa0 - JAX_FINAL_A_TAIL64) / JAX_FINAL_A_TAIL64
            tail_msg = (f"final_A_tail64 member 0 {fa0:.6f} vs JAX "
                        f"{JAX_FINAL_A_TAIL64:.6f} (rel {rel:.3e}, bound "
                        "1e-2); members "
                        + ", ".join(f"{a:.6f}" for a in A_t[:, -1]))
        else:
            same = torch.equal(run.res.XP, paths["ladder"][0].res.XP)
            tail_msg = (f"f32 ladder bit-identical to the ladder kernel's "
                        f"(whose tail is checked above): {same}")
            check(same, f"bench {solver_name}: its f32 ladder differs from "
                  "the ladder kernel's")
        stat = np.bincount(run.res.status.cpu().numpy().ravel(), minlength=4)
        print(f"new path {solver_name}: timed f32 ladder call "
              f"{run.wall:.4f} s for {MAIN['B']} members; total nfev "
              f"{run.total_nfev}; statuses per code 0..3 {stat.tolist()}; "
              f"launches in the {run.calls} ladder calls: "
              f"{run.launches}, after the tail: {counts}; " + tail_msg)
        check(run.launches["ladder"] == want["ladder"] * run.calls
              and run.launches["rung"] == want["rung"] * run.calls
              and run.launches["ag"] == 0,
              f"bench {solver_name} did not run through its kernel alone: "
              f"{run.launches}")
        check(tuple(run.res.A.shape) == (MAIN["B"], MAIN["n_beta"]),
              f"bench {solver_name}: record shape {tuple(run.res.A.shape)}")
        for nm in ("A", "nfev", "status"):
            check(bool(torch.isfinite(getattr(run.res, nm).double()).all()),
                  f"bench {solver_name}: non-finite {nm}")
        check(bool(torch.isfinite(run.res.XP).all())
              and (run.tail is None or bool(np.isfinite(A_t).all())),
              f"bench {solver_name}: non-finite XP or tail")
        check(run.tail is None or rel <= 1e-2,
              f"bench {solver_name}: final_A_tail64 vs "
              f"{JAX_FINAL_A_TAIL64}")
        paths[solver_name] = (run, counts)
    k3_us_eval = 1e3 * pk["ms"] / max(pk["nfev"])
    print(f"K3 on its path: {pk['ms']:.3f} ms a launch, "
          f"{k3_us_eval:.3f} us an evaluation and its iteration (the "
          f"slowest member's nfev, {max(pk['nfev'])}); K2 on the fused "
          f"path: {k2_main[0]:.4f} ms a launch, {k2_main[1]:.3f} us an "
          f"evaluation (CUDA events around each of its "
          f"{paths['fused'][0].launches['rung']} launches, the slowest "
          f"member's nfev of each rung)")

    # group barriers an iteration, measured: K3's 101-rung ladder and the
    # fused path's 101 warm-started K2 launches on the bench's inputs,
    # through the barrier-counting build (phase 2), whose X and records
    # must be the shipped build's bits; the count over the members'
    # iterations, each rung's first evaluation and extra line-search
    # trials included
    opts_b = LBFGSOptions(m=5, maxiter=500, maxls=20, pgtol=1e-4,
                          ftol=1e-6)
    xp_b = torch.tensor(random_ensemble_inits(spec, MAIN["B"], seed=3,
                                              dtype=np.float32), device=dev)
    rfs_b = torch.tensor([rung_rf(np.float32(rf0), MAIN["alpha"], b,
                                  torch.float32)
                          for b in range(MAIN["n_beta"])], device=dev)

    def k3_run():
        X, r = solve.ladder_kernel(xp_b, rfs_b, c32, opts_b)
        return [X] + [r[k] for k in sorted(r)]

    def k2_run():
        x, out = xp_b, []
        for rf in rfs_b.tolist():
            r = solve.solve_kernel(x, rf, c32, opts_b)
            x = r.x
            out += [r.f, r.niter, r.nfev, r.status]
        return [x] + out

    barriers = {}
    for nm, run_fn in (("K3", k3_run), ("K2", k2_run)):
        ref_b = run_fn()
        got_b, n_bar = count_barriers(bar_lib, run_fn)
        check(all(torch.equal(u, v) for u, v in zip(got_b, ref_b)),
              f"{nm}: the barrier-counting build's results differ from "
              "the shipped build's")
        iters = int(sum(int(t.sum()) for t in (
            [ref_b[5]] if nm == "K3" else ref_b[2::4])))
        barriers[nm] = n_bar / iters
        print(f"{nm} group barriers on the main path (measured, f32, "
              f"m=5): {n_bar} over {iters} iterations of {MAIN['B']} "
              f"members, {barriers[nm]:.4f} an iteration")
    # one evaluation's barriers: K2 at maxiter 0 runs the start's
    # evaluation and one reduction (the gradient's norms) a member
    opts_0 = dataclasses.replace(opts_b, maxiter=0)
    _, n_bar0 = count_barriers(bar_lib, lambda: solve.solve_kernel(
        xp_b, float(rfs_b[0]), c32, opts_0))
    eval_barriers = n_bar0 / MAIN["B"] - 1
    print(f"group barriers of one evaluation (K2 at maxiter 0: "
          f"{n_bar0} over {MAIN['B']} members, less the one reduction): "
          f"{eval_barriers:g}")
    check(eval_barriers == 2, f"an evaluation passed {eval_barriers} group "
          "barriers, not 2")
    phase("9 new path (bench ladder, fused) and profile", t0)

    # ---- 10. K7a and K7b vs their plain versions ------------------------
    t0 = time.perf_counter()
    n = spec.n_dof
    N_WIDE = 32768          # dir_predicate's widest n: 8 blocks a member
    rng = np.random.default_rng(10)

    def histories(m, pairs, n):
        H = np.zeros((len(pairs), 2 * m, n), np.float32)
        for b, (head, hlen) in enumerate(pairs):
            for j in range(hlen):
                slot = (head - hlen + j) % m
                sv = rng.normal(size=n)
                H[b, slot], H[b, m + slot] = sv, rng.normal(size=n) * 0.3 + sv
        return torch.tensor(H, device=dev)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=dev)

    def dir_err(d_k, d_p, d_64):
        """(kernel's error, its bound), each relative to the member's
        max|d|: the bound is 2e-5 (tests/test_dir_pallas.py's for K7b) or
        twice the plain f32 version's own error against f64 on the same
        inputs, whichever is larger, and never more than 7.2e-5 (twice
        the 3.6e-5 that tests/test_torch_dir.py holds that error under at
        this n and m = 7 on the CPU)."""
        s_p = torch.amax(torch.abs(d_p), dim=1).double()
        e_k = torch.amax(torch.abs(d_k - d_p), dim=1).double() / s_p
        w = torch.amax(torch.abs(d_p.double() - d_64), dim=1) / torch.amax(
            torch.abs(d_64), dim=1)
        return e_k, torch.clamp(2.0 * w, min=2e-5, max=7.2e-5)

    err_k7a = err_k7b = 0.0
    rel_k7 = [0.0, 0.0]     # worst error / bound of K7a, K7b
    e_k7 = [0.0, 0.0]       # worst error relative to max|d| of K7a, K7b
    n_el = 0                # members past the elementwise 2e-6 + 2e-5|d|
    n_pairs = 0
    plans10 = {}
    for m in (5, 7):
        every = [(h, l) for h in range(m) for l in range(m + 1)]
        for n_ in (n, N_WIDE):          # at N_WIDE every fifth pair
            pairs = every if n_ == n else every[::5]
            for i in range(0, len(pairs), MAIN["B"]):
                batch = pairs[i:i + MAIN["B"]]
                B = len(batch)
                H = histories(m, batch, n_)
                plans10[(m, n_)] = (kdir.launch_plan(H, False),
                                    kdir.launch_plan(H, True))
                hd = i32([p[0] for p in batch])
                hl = i32([p[1] for p in batch])
                g = f32(rng.normal(size=(B, n_)))
                d_k = kdir.compact_dir_kernel(g, H, hd, hl)
                torch.cuda.synchronize()
                d_p = kdir.compact_dir_reference(g, H, hd, hl)
                d_64 = kdir.compact_dir_reference(g.double(), H.double(), hd,
                                                  hl)
                err = torch.abs(d_k - d_p)
                err_k7a = max(err_k7a, float(err.max()))
                n_el += int((err > 2e-6 + 2e-5 * torch.abs(d_p)).any(
                    dim=1).sum())
                e_k, bnd = dir_err(d_k, d_p, d_64)
                rel_k7[0] = max(rel_k7[0], float((e_k / bnd).max()))
                e_k7[0] = max(e_k7[0], float(e_k.max()))
                check(bool(torch.all(e_k <= bnd)),
                      f"K7a disagrees with its plain version at m={m}, "
                      f"n={n_}, (head, hlen) in {batch}: {e_k.tolist()} vs "
                      f"{bnd.tolist()}")
                check(torch.equal(d_k, kdir.compact_dir_kernel(g, H, hd, hl)),
                      "K7a repeated launch is not bit-identical")

                x_old, g_old = f32(rng.normal(size=(B, n_))), g
                x_new = x_old + f32(0.1 * rng.normal(size=(B, n_)))
                g_new = g_old + f32(0.1 * rng.normal(size=(B, n_)))
                if B > 3:           # a flat pair: the gate must refuse it
                    x_new[3] = x_old[3] + 1e-12
                    g_new[3] = g_old[3]
                ls_ok = torch.tensor([True, False, True, True][:B],
                                     device=dev)
                run = torch.tensor([True, True, False, True][:B], device=dev)
                vecs = (x_old, x_new, g_old, g_new)
                Hk, hk, lk = H.clone(), hd.clone(), hl.clone()
                Hp, hp, lp = H.clone(), hd.clone(), hl.clone()
                d_k, sc_k = kdir.fused_step_kernel(Hk, *vecs, hk, lk, ls_ok,
                                                   run)
                torch.cuda.synchronize()
                d_p, sc_p = kdir.fused_step_reference(Hp, *vecs, hp, lp,
                                                      ls_ok, run)
                d_64, _ = kdir.fused_step_reference(
                    H.double(), *(v.double() for v in vecs), hd.clone(),
                    hl.clone(), ls_ok, run)
                err = torch.abs(d_k - d_p)
                err_k7b = max(err_k7b, float(err.max()),
                              float(torch.abs(Hk - Hp).max()))
                n_el += int((err > 2e-6 + 2e-5 * torch.abs(d_p)).any(
                    dim=1).sum())
                e_k, bnd = dir_err(d_k[run], d_p[run], d_64[run])
                rel_k7[1] = max(rel_k7[1], float((e_k / bnd).max()))
                e_k7[1] = max(e_k7[1], float(e_k.max()))
                ok = (torch.equal(hk, hp) and torch.equal(lk, lp)
                      and torch.equal(sc_k[:, [0, 3, 4]], sc_p[:, [0, 3, 4]])
                      and bool(torch.all(torch.abs(Hk - Hp)
                                         <= 1e-6 * torch.abs(Hp)))
                      and bool(torch.all(torch.abs(sc_k[:, 1] - sc_p[:, 1])
                                         <= 1e-6 * torch.abs(sc_p[:, 1])))
                      and bool(torch.all(torch.abs(sc_k[:, 2] - sc_p[:, 2])
                                         <= 1e-5 * torch.abs(sc_p[:, 2])))
                      and bool(torch.all(e_k <= bnd))
                      and torch.equal(d_k[~run], d_p[~run]))
                check(ok, f"K7b disagrees with its plain version at m={m}, "
                      f"n={n_}, (head, hlen) in {batch}: good/head/hlen "
                      f"{sc_k[:, [0, 3, 4]].tolist()} vs "
                      f"{sc_p[:, [0, 3, 4]].tolist()}")
                if B > 2:
                    check(torch.equal(Hk[2], H[2]) and int(hk[2]) == int(hd[2])
                          and int(lk[2]) == int(hl[2]),
                          "K7b touched a member whose loop had ended")
                if B > 3:
                    check(float(sc_k[3, 0]) == 0.0, "K7b took a flat pair")
                Hk2, hk2, lk2 = H.clone(), hd.clone(), hl.clone()
                d_k2, sc_k2 = kdir.fused_step_kernel(Hk2, *vecs, hk2, lk2,
                                                     ls_ok, run)
                check(torch.equal(d_k, d_k2) and torch.equal(sc_k, sc_k2)
                      and torch.equal(Hk, Hk2),
                      "K7b repeated launch is not bit-identical")
                n_pairs += B
    print(f"K7a/K7b f32 vs plain at n={n} and {N_WIDE}, m=5 and 7, {n_pairs}"
          f" (head, hlen) cases: max abs err K7a {err_k7a:.3e}, K7b "
          f"{err_k7b:.3e}; error / bound, relative to max|d|, K7a "
          f"{rel_k7[0]:.3f}, K7b {rel_k7[1]:.3f} (bound: 2e-5, or twice the "
          f"plain f32 version's own error against f64, at most 7.2e-5); "
          f"{n_el} of the {2 * n_pairs} directions past the elementwise "
          f"2e-6 + 2e-5|d|; good/head/hlen exact, ended member untouched, "
          f"repeats bit-identical")
    for (m, n_), (pa, pb) in sorted(plans10.items()):
        print(f"K7 cluster plan, m={m}, n={n_}, B={MAIN['B']}: K7a {pa.size} "
              f"blocks of {pa.width} columns, {pa.rows} rows on chip, "
              f"{pa.smem_bytes} B; K7b {pb.size} blocks, {pb.rows} rows, "
              f"{pb.smem_bytes} B")
    k7_attrs = {(m, st): kdir.kernel_attrs(m, st) for m in (5, 7)
                for st in (False, True)}
    print("K7 built kernels (registers, local bytes): " + "; ".join(
        f"{'K7b' if st else 'K7a'} m={m} {a['regs']}, {a['local_bytes']}"
        for (m, st), a in k7_attrs.items()))

    def k7_device_ms(fn, key):
        """A kernel's device time a launch by torch.profiler over 200
        calls of ``fn``, or None without device events."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
        rows = [(device_us(e), e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and key in e.key]
        return (rows[0][0] / rows[0][1] / 1e3 if rows and rows[0][0] > 0
                else None)

    m = 5
    k7t = {}                # n -> the times of phase 10's table
    for n_ in (n, N_WIDE):
        H = histories(m, [(2, m)] * MAIN["B"], n_)
        hd, hl = i32([2] * MAIN["B"]), i32([m] * MAIN["B"])
        g = f32(rng.normal(size=(MAIN["B"], n_)))
        x_old = f32(rng.normal(size=(MAIN["B"], n_)))
        x_new = x_old + f32(0.1 * rng.normal(size=(MAIN["B"], n_)))
        g_new = g + f32(0.1 * rng.normal(size=(MAIN["B"], n_)))
        ones = torch.ones(MAIN["B"], dtype=torch.bool, device=dev)
        t = dict(plan=plans10[(m, n_)])
        t["k7a"] = events_ms(lambda: kdir.compact_dir_kernel(g, H, hd, hl))
        t["k7a_dev"] = k7_device_ms(
            lambda: kdir.compact_dir_kernel(g, H, hd, hl), "dir_kernel")
        t["p7a"] = events_ms(
            lambda: kdir.compact_dir_reference(g, H, hd, hl), n=200)
        Hs, hs, ls_ = H.clone(), hd.clone(), hl.clone()
        t["k7b"] = events_ms(lambda: kdir.fused_step_kernel(
            Hs, x_old, x_new, g, g_new, hs, ls_, ones, ones))
        Hs, hs, ls_ = H.clone(), hd.clone(), hl.clone()
        t["k7b_dev"] = k7_device_ms(lambda: kdir.fused_step_kernel(
            Hs, x_old, x_new, g, g_new, hs, ls_, ones, ones), "step_kernel")
        Hs, hs, ls_ = H.clone(), hd.clone(), hl.clone()
        t["p7b"] = events_ms(lambda: kdir.fused_step_reference(
            Hs, x_old, x_new, g, g_new, hs, ls_, ones, ones), n=200)
        t["w7a"] = dir_work(MAIN["B"], n_, m)
        t["w7b"] = step_work(MAIN["B"], n_, m, MAIN["B"])
        t["b7a"], t["b7b"] = bound_of(*t["w7a"]), bound_of(*t["w7b"])
        k7t[n_] = t
        for kk, nm in (("7a", "K7a"), ("7b", "K7b (every pair taken)")):
            dv = t[f"k{kk}_dev"]
            plan_ = t["plan"][kk == "7b"]
            print(f"{nm} f32 (B=4, n={n_}, m=5, full history; "
                  f"{plan_.size} blocks a member): {t[f'k{kk}']:.5f} ms a "
                  f"launch, plain {t[f'p{kk}']:.5f} ms (CUDA events), device "
                  "time " + (f"{dv:.5f} ms (torch.profiler)" if dv is not None
                             else "not measured (no device events)")
                  + f"; bound {t[f'b{kk}'][0]:.3e} ms ({t[f'b{kk}'][1]}: "
                  f"{t[f'w{kk}'][0]} bytes, {t[f'w{kk}'][1]} operations)")
    ms_k7a, dev_k7a, ms_p7a = (k7t[n][k] for k in ("k7a", "k7a_dev", "p7a"))
    ms_k7b, dev_k7b, ms_p7b = (k7t[n][k] for k in ("k7b", "k7b_dev", "p7b"))
    bound_k7a, bound_k7b = k7t[n]["b7a"], k7t[n]["b7b"]
    phase("10 K7a/K7b vs plain", t0)

    # ---- 11. the fused generic loop on the main path --------------------
    t0 = time.perf_counter()
    # phase 5's ladder ran it: its launches, then its f64 tail
    res_f, wall_fused = res, wall_f32
    niter_f = res_f.niter.cpu().numpy()
    nfev_f = res_f.nfev.cpu().numpy()
    loop_iters = int(niter_f.max(axis=0).sum())
    lockstep_f = int(nfev_f.max(axis=0).sum())
    t_tail = time.perf_counter()
    tail_f = run_ladder(act64, parts64a, res_f.XP.double(),
                        np.arange(MAIN["n_beta"] - MAIN["tail"],
                                  MAIN["n_beta"]), rf0, MAIN["alpha"],
                        opts=opts64, store_paths=False, device=dev)
    torch.cuda.synchronize()
    wall_tail_f = time.perf_counter() - t_tail
    A_tf = tail_f.A.cpu().numpy()
    fa_f = float(A_tf[0, -1])
    rel_f = abs(fa_f - JAX_FINAL_A_TAIL64) / JAX_FINAL_A_TAIL64
    print(f"fused loop f32 ladder: {MAIN['n_beta']} rungs x {MAIN['B']} "
          f"members in {wall_fused:.2f} s; loop iterations {loop_iters}; "
          f"total nfev {int(nfev_f.sum())}, per-rung max over members "
          f"summed {lockstep_f}; launches {launch_f}; statuses per code "
          f"0..3 {np.bincount(res_f.status.cpu().numpy().ravel(), minlength=4).tolist()}")
    ms_iter_fused = 1e3 * wall_fused / loop_iters
    print(f"fused loop: {ms_iter_fused:.3f} ms a loop iteration, "
          f"{1e3 * wall_fused / lockstep_f:.3f} ms a K1 launch of the "
          f"slowest member (phase 6 profiles the compact loop)")
    print(f"fused loop f64 tail: {MAIN['tail']} rungs in {wall_tail_f:.2f} "
          f"s; final_A_tail64 member 0 {fa_f:.6f} vs JAX "
          f"{JAX_FINAL_A_TAIL64:.6f} (rel {rel_f:.3e}, bound 1e-2); "
          "members " + ", ".join(f"{a:.6f}" for a in A_tf[:, -1]))
    check(launch_f["k7b"] == loop_iters > 0,
          f"K7b launches {launch_f['k7b']} != loop iterations {loop_iters}")
    check(launch_f["k7a"] == 0, "the fused loop launched K7a")
    check(launch_f["k1"] >= lockstep_f, "the fused loop skipped K1")
    check(bool(torch.isfinite(res_f.A).all())
          and bool(np.isfinite(A_tf).all()), "fused loop: non-finite A")
    check(rel_f <= 1e-2, f"fused loop: final_A_tail64 {fa_f}")
    with tempfile.TemporaryDirectory() as tmp:
        start = os.path.join(tmp, "rung59.pt")
        torch.save(res.paths[:, 59].contiguous().cpu(), start)
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--profile-loops", start],
                               capture_output=True, text=True, timeout=600,
                               cwd=ROOT)
    check(child.returncode == 0, "the loop profile failed:\n" + child.stdout
          + child.stderr)
    pl = json.loads(child.stdout.strip().splitlines()[-1])
    for nm, r in pl.items():
        print(f"profiled (child process), rung 60, 50 iterations, "
              f"direction={nm}: {r['niter']} iterations, {r['nfev']} "
              f"evaluations of the slowest member; wall "
              f"{r['wall_us'] / 1e3:.1f} ms ({r['wall_us'] / 1e3 / r['niter']:.3f} "
              f"ms an iteration), device busy {r['busy_us'] / 1e3:.2f} ms "
              f"({100 * r['busy_us'] / r['wall_us']:.1f} %), K1 "
              f"{r['k1_us'] / 1e3:.2f} ms, K7b {r['k7b_us'] / 1e3:.3f} ms "
              f"({r['k7b_us'] / r['niter']:.2f} us of device time an "
              f"iteration, beside the wall's "
              f"{r['wall_us'] / r['niter']:.1f} us); "
              f"{r['kernels']} device kernels")
    check(pl["auto"]["k7b_us"] > 0, "torch.profiler recorded no K7b time")
    phase("11 fused generic loop", t0)

    # ---- 12. K2's bounded branch vs its plain version --------------------
    t0 = time.perf_counter()
    lo64, hi64 = (torch.tensor(b, device=dev)
                  for b in build_bounds(spec, BOX_TEST, np.float64))
    lo32, hi32 = lo64.float(), hi64.float()
    err_k2b = 0.0
    rel_k2b = 0.0           # the kernels line's bounded_max_rel_err
    at_bound = 0
    for beta in betas_s:
        rf = rung_rf(rf0, MAIN["alpha"], beta, torch.float64)
        rk = solve.solve_kernel(Z64, rf, c64m, opts_s, lo64, hi64)
        torch.cuda.synchronize()
        rp = solve.solve_reference(Z64, rf, c64m, opts_s, lo64, hi64)
        scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
        rel = float(torch.max(torch.abs(rk.x - rp.x) / scale))
        err_k2b = max(err_k2b, float(torch.max(torch.abs(rk.x - rp.x))))
        rel_k2b = max(rel_k2b, rel)
        feas = bool(((rk.x >= lo64) & (rk.x <= hi64)).all())
        n_at = int(((rk.x == lo64) | (rk.x == hi64)).sum())
        print(f"K2 bounded f64 short solve beta={beta}: niter "
              f"{rk.niter.tolist()} / plain {rp.niter.tolist()}; nfev "
              f"{rk.nfev.tolist()} / {rp.nfev.tolist()}; status "
              f"{rk.status.tolist()} / {rp.status.tolist()}; x rel err "
              f"{rel:.3e} (bound 1e-8); feasible {feas}, {n_at} components "
              f"at a bound")
        check(all(torch.equal(u, v) for u, v in
                  zip((rk.niter, rk.nfev, rk.status),
                      (rp.niter, rp.nfev, rp.status))),
              f"K2 bounded f64 counts differ at beta={beta}")
        at_bound += n_at
        check(rel <= 1e-8 and feas,
              f"K2 bounded f64 disagrees or is infeasible at beta={beta}")
        rk2 = solve.solve_kernel(Z64, rf, c64m, opts_s, lo64, hi64)
        check(all(torch.equal(u, v) for u, v in zip(rk, rk2)),
              "K2 bounded repeated launch is not bit-identical")
    check(at_bound > 0, "no bounded solve ended with a component at a bound")
    # The f32 bounded short solve is decided by rounding: a component at a
    # bound is frozen or free on the sign of its gradient, so two correct
    # f32 solves part after a few iterations (both lie up to ~4e-2 from
    # the f64 solve of the same problem), and more so than unbounded ones.
    # The kernel is held on phase 3's draws at β 0/50/100 to identical
    # counts and f within F32_BOUNDED_F_TOL, a fixed limit set from
    # readings printed here: the plain version's card-vs-CPU spread (the
    # same arithmetic summed in another order) over six draws and five
    # rungs, and the kernel's distance from the plain version. On the
    # other draws the kernel is read, not held to that limit, and held
    # to be no farther from the f64 solve than twice the plain version.
    lo_c, hi_c = lo32.cpu(), hi32.cpu()
    ms_k2b, ms_p2b, work_k2b = [], [], [0, 0]
    rd = dict(cc=0.0, kp=0.0, kp_main=0.0, k64=0.0, p64=0.0, n=0,
              counts_differ=0)
    for seed in range(6):
        Zs = Z32 if seed == 0 else torch.tensor(
            member_draws(spec, tw, seed), dtype=torch.float32, device=dev)
        for beta in (0, 25, 50, 75, 100):
            rf = rung_rf(np.float32(rf0), MAIN["alpha"], beta, torch.float32)
            rk = solve.solve_kernel(Zs, rf, c32, opts_s, lo32, hi32)
            torch.cuda.synchronize()
            t_p = time.perf_counter()
            rp = solve.solve_reference(Zs, rf, c32, opts_s, lo32, hi32)
            torch.cuda.synchronize()
            t_p = (time.perf_counter() - t_p) * 1e3
            rc = solve.solve_reference(Zs.cpu(), rf, c32_cpu, opts_s, lo_c,
                                       hi_c)
            r64 = solve.solve_reference(
                Zs.double(), rung_rf(rf0, MAIN["alpha"], beta,
                                     torch.float64), c64m, opts_s, lo64,
                hi64)
            cc = float(torch.max(torch.abs(rp.f.cpu() - rc.f)
                                 / torch.abs(rc.f)))
            rel = float(torch.max(torch.abs(rk.f - rp.f) / torch.abs(rp.f)))
            same = all(torch.equal(u, v) for u, v in
                       zip((rk.niter, rk.nfev, rk.status),
                           (rp.niter, rp.nfev, rp.status)))
            check(all(torch.equal(u.cpu(), v) for u, v in
                      zip((rp.niter, rp.nfev, rp.status),
                          (rc.niter, rc.nfev, rc.status))),
                  f"f32 bounded plain solve on the card and on the CPU "
                  f"differ in counts at seed {seed}, beta={beta}")
            check(bool(((rk.x >= lo32) & (rk.x <= hi32)).all()),
                  f"K2 bounded f32 infeasible at seed {seed}, beta={beta}")
            rd["cc"], rd["kp"] = max(rd["cc"], cc), max(rd["kp"], rel)
            rd["k64"] = max(rd["k64"], float(torch.max(
                torch.abs(rk.f.double() - r64.f) / torch.abs(r64.f))))
            rd["p64"] = max(rd["p64"], float(torch.max(
                torch.abs(rp.f.double() - r64.f) / torch.abs(r64.f))))
            rd["n"] += 1
            rd["counts_differ"] += int(not same)
            if seed > 0 or beta not in betas_s:
                continue
            rd["kp_main"] = max(rd["kp_main"], rel)
            rel_k2b = max(rel_k2b, rel)
            print(f"K2 bounded f32 short solve beta={beta}: f rel err "
                  f"{rel:.3e} (bound {F32_BOUNDED_F_TOL:g}), plain on the "
                  f"card vs on the CPU {cc:.3e}; niter {rk.niter.tolist()} "
                  f"/ plain {rp.niter.tolist()}; nfev {rk.nfev.tolist()} / "
                  f"{rp.nfev.tolist()}; status {rk.status.tolist()} / "
                  f"{rp.status.tolist()}")
            check(rel <= F32_BOUNDED_F_TOL and same,
                  f"K2 bounded f32 disagrees with its plain version at "
                  f"beta={beta}")
            ms_p2b.append(t_p)
            ms_k2b.append(events_ms(lambda: solve.solve_kernel(
                Zs, rf, c32, opts_s, lo32, hi32), n=5))
            work_k2b[0] += int(rk.nfev.sum())
            work_k2b[1] += int(rk.niter.sum())
    print(f"K2 bounded f32 readings over 6 draws x 5 rungs (β 0/25/50/75/"
          f"100): plain card vs CPU f up to {rd['cc']:.3e}; kernel vs plain "
          f"f up to {rd['kp']:.3e} (phase 3's draws at β 0/50/100: "
          f"{rd['kp_main']:.3e}); counts differ in {rd['counts_differ']} of "
          f"{rd['n']} batches; f from the f64 solve up to {rd['k64']:.3e} "
          f"(kernel) and {rd['p64']:.3e} (plain)")
    check(rd["k64"] <= 2.0 * rd["p64"],
          "K2 bounded f32 lies farther from the f64 solve than twice the "
          "plain version")
    ms_k2b = float(np.mean(ms_k2b))
    ms_p2b = float(np.mean(ms_p2b))
    bound_k2b = solve_bound(spec, torch.float32, MAIN["B"], len(betas_s),
                            work_k2b[0], work_k2b[1], opts_s.m, rungs=1)
    print(f"K2 bounded f32 (B=4, maxiter 30, one rung a launch): "
          f"{ms_k2b:.4f} ms a launch (CUDA events), plain {ms_p2b:.4f} ms; "
          f"bound {bound_k2b[0]:.3e} ms ({bound_k2b[1]}: {bound_k2b[2]} "
          f"bytes, {bound_k2b[3]} operations per launch)")

    def plain_bounded(XP, rf):
        return solve.solve_reference(XP, rf, c64m, opts_t, lo64, hi64)

    lo_np, hi_np = (b.cpu().numpy() for b in (lo64, hi64))
    runs = {}
    for nm, kw in (
            ("K2 via the hook", dict(rung_solver=solve.make_rung_solver(
                spec, opts_t, lower=lo_np, upper=hi_np, device=dev))),
            ("plain", dict(rung_solver=plain_bounded)),
            ("generic projection loop", dict(lower=lo_np, upper=hi_np))):
        t_l = time.perf_counter()
        runs[nm] = make_ensemble_ladder(
            act64k, parts64, np.arange(F64_RUNGS), float(tw["RM"]),
            MAIN["alpha"], opts=opts_t, store_paths=True, device=dev,
            **kw)(xp4)
        torch.cuda.synchronize()
        r = runs[nm]
        print(f"f64 bounded {F64_RUNGS}-rung ladder ({MAIN['B']} members) "
              f"through "
              f"{nm}: {time.perf_counter() - t_l:.2f} s, statuses per code "
              f"0..3 {np.bincount(r.status.cpu().numpy().ravel(), minlength=4).tolist()}, "
              f"niter {int(r.niter.sum())}")
        check(bool(((r.paths >= lo64) & (r.paths <= hi64)).all()),
              f"bounded ladder through {nm}: infeasible path")
    ok_pl = runs["plain"].status.cpu().numpy() <= 1
    A_pl = runs["plain"].A.cpu().numpy()
    for nm in ("K2 via the hook", "generic projection loop"):
        both = ok_pl & (runs[nm].status.cpu().numpy() <= 1)
        rel = np.abs(runs[nm].A.cpu().numpy() - A_pl) / np.abs(A_pl)
        print(f"f64 bounded {F64_RUNGS}-rung ladder {nm} vs plain: "
              f"mutually converged rungs {int(both.sum())}/{both.size}; "
              f"max rel A difference {rel[both].max():.3e} (bound 1e-8)")
        check(both.mean() >= 0.8, f"{nm}: too few converged rungs")
        check(np.all(rel[both] <= 1e-8),
              f"f64 bounded ladder through {nm} disagrees: {rel}")
    phase("12 K2 bounded vs plain", t0)

    # ---- 13. the facade on the card ---------------------------------------
    t0 = time.perf_counter()
    from varanneal_tpu_torch.models import lorenz96
    X0q = random_ensemble_inits(spec, 1, seed=3)[0, : spec.n_state].reshape(
        spec.N_f, spec.D)
    quick = dict(P0=np.array([4.0]), alpha=MAIN["alpha"], RM=tw["RM"],
                 RF0=4e-6 * tw["RM"], Lidx=list(tw["Lidx"]), Pidx=[0],
                 disc="trapezoid", bounds=BOX_FACADE,
                 opt_args=dict(maxiter=500, maxcor=5, maxls=20, gtol=1e-4,
                               ftol=1e-6), dtype=torch.float32)
    lo_f, hi_f = build_bounds(spec, BOX_FACADE, np.float32)

    def counts():
        return dict(k1=ag.LAUNCHES, k2=solve.RUNG_LAUNCHES,
                    k3=solve.LADDER_LAUNCHES, k7a=kdir.DIR_LAUNCHES,
                    k7b=kdir.STEP_LAUNCHES)

    facade = {}
    for label, solver_name, betas_q in (
            ("auto", "auto", np.arange(MAIN["n_beta"])),
            ("generic", "generic", np.arange(20)),
            ("auto, 20 rungs", "auto", np.arange(20))):
        ann = Annealer(device=dev)
        ann.set_model(lorenz96, MAIN["D"])
        ann.set_data(tw["Y"], t=tw["t"])
        ag.LAUNCHES = solve.RUNG_LAUNCHES = solve.LADDER_LAUNCHES = 0
        kdir.DIR_LAUNCHES = kdir.STEP_LAUNCHES = 0
        t_a = time.perf_counter()
        with launch_events(solve, "solve_kernel") as ev_q:
            ann.anneal(X0q, beta_array=betas_q, solver=solver_name, **quick)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t_a
        if label == "auto":     # K2 bounded's time a launch on its path
            k2b_main = per_launch(ev_q, ann.nfev_array, 1)
        cnt = counts()
        paths_q = ann.minpaths
        n_at = int(((paths_q == lo_f) | (paths_q == hi_f)).sum())
        print(f"facade {label}: {len(betas_q)} rungs in "
              f"{wall_a:.2f} s; launches {cnt}; total nfev "
              f"{int(ann.nfev_array.sum())}, niter "
              f"{int(ann.niter_array.sum())}; exit flags per code 0..2 "
              f"{np.bincount(ann.exitflags, minlength=3).tolist()}; "
              f"{n_at} path entries at a bound; final A "
              f"{float(ann.A_array[-1]):.6f}, F {float(ann.minpaths_P[-1, 0]):.4f}")
        check(ann.A_array.shape == (len(betas_q),)
              and ann.minpaths.shape == (len(betas_q), spec.n_dof)
              and ann.A_array.dtype == np.float32,
              f"facade {label}: record shapes")
        check(set(np.unique(ann.exitflags).tolist()) <= {0, 1, 2},
              f"facade {label}: exit flags {ann.exitflags}")
        check(bool(np.all((paths_q >= lo_f) & (paths_q <= hi_f))),
              f"facade {label}: infeasible path")
        check(n_at > 0, f"facade {label}: no component at a bound")
        check(bool(np.isfinite(ann.A_array).all()),
              f"facade {label}: non-finite A")
        facade[label] = (ann, cnt, wall_a)
    cnt = facade["auto"][1]
    check(cnt["k2"] == MAIN["n_beta"] and cnt["k7a"] == 0
          and cnt["k7b"] == 0 and cnt["k1"] == 0 and cnt["k3"] == 0,
          f"solver='auto' did not run through K2 alone: {cnt}")
    cnt = facade["generic"][1]
    check(cnt["k7a"] > 0 and cnt["k7b"] == 0 and cnt["k2"] == 0,
          f"solver='generic' did not run the projection loop through K7a: "
          f"{cnt}")
    check(facade["auto, 20 rungs"][1]["k2"] == 20,
          "solver='auto' on 20 rungs did not take K2")
    print(f"K2 bounded on the facade's path: {k2b_main[0]:.4f} ms a launch, "
          f"{k2b_main[1]:.3f} us an evaluation (CUDA events around each of "
          f"its {MAIN['n_beta']} launches)")
    w_k2, w_gen = facade["auto, 20 rungs"][2], facade["generic"][2]
    print(f"facade, the first 20 rungs, bounded, f32, one init: K2 "
          f"{w_k2:.3f} s, generic projection loop {w_gen:.3f} s "
          f"({w_gen / w_k2:.1f}x)")
    # the low rungs barely move; rungs 60..69 from the facade's rung-59
    # minimizer are where the solves work: the facade's two paths there,
    # as anneal runs them (its action, options, bounds and rung values)
    from varanneal_tpu_torch.kernels.fe import select_action
    from varanneal_tpu_torch.api import make_lbfgs_options
    act_q, parts_q = select_action(spec, 0.0, dtype=torch.float32,
                                   device=dev)
    opts_q = make_lbfgs_options(quick["opt_args"], np.float32)
    xp59 = torch.tensor(facade["auto"][0].minpaths[59], device=dev)
    mid = {}
    for nm, kw in (("K2", dict(rung_solver=solve.make_rung_solver(
            spec, opts_q, lower=lo_f, upper=hi_f, device=dev))),
                   ("generic projection loop", {})):
        kdir.DIR_LAUNCHES = solve.RUNG_LAUNCHES = 0
        t_m = time.perf_counter()
        r = run_ladder(act_q, parts_q, xp59, np.arange(60, 70),
                       np.float32(4e-6 * tw["RM"]), MAIN["alpha"],
                       lower=lo_f, upper=hi_f, opts=opts_q,
                       store_paths=False, device=dev, **kw)
        torch.cuda.synchronize()
        mid[nm] = (time.perf_counter() - t_m, r)
        print(f"rungs 60..69 from the facade's rung-59 minimizer through "
              f"{nm}: {mid[nm][0]:.3f} s, niter {int(r.niter.sum())}, nfev "
              f"{int(r.nfev.sum())}, K2 launches {solve.RUNG_LAUNCHES}, "
              f"K7a launches {kdir.DIR_LAUNCHES}; A at rung 69 "
              f"{float(r.A[-1]):.6f}")
    print(f"K2 against the generic loop, rungs 60..69: "
          f"{mid['generic projection loop'][0] / mid['K2'][0]:.1f}x")
    ann = facade["auto"][0]
    with tempfile.TemporaryDirectory() as tmp:
        shapes = {}
        for nm in ("paths", "params", "action_errors"):
            for ext in (".npy", ".dat"):
                f = os.path.join(tmp, nm + ext)
                getattr(ann, "save_" + nm)(f)
                shapes[nm + ext] = (np.load(f) if ext == ".npy"
                                    else np.loadtxt(f)).shape
    print(f"facade files: {shapes}")
    check(shapes["paths.npy"] == (MAIN["n_beta"], spec.N_f, spec.D + 1)
          and shapes["params.npy"] == (MAIN["n_beta"], 1)
          and shapes["action_errors.dat"] == (MAIN["n_beta"], 4),
          f"facade file shapes {shapes}")
    phase("13 facade", t0)
    # ---- 14. K4 against its plain version ---------------------------------
    t0 = time.perf_counter()
    c4 = ag.ag_consts(spec, dev, torch.float32, compensated=True)
    c64a = ag.ag_consts(spec, dev, torch.float64)
    rfs14 = [float(np.float32(rf0 * MAIN["alpha"] ** b)) for b in (0, 50, 100)]
    rfs14.append(float(np.float32(4e6)))
    err_k4 = rel_k4 = rel_k4_d400 = 0.0
    old_dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)      # the f64 combine
    try:
        for rf in rfs14:
            A4, G4, C4 = ag.ag_kernel(Z32, rf, c4, compensated=True)
            A1, G1 = ag.ag_kernel(Z32, rf, c32)
            torch.cuda.synchronize()
            _, G_r, C_r = ag.ag_reference(Z32, rf, c4, compensated=True)
            v4, v_r = ag.combine(C4, rf, c4), ag.combine(C_r, rf, c4)
            rel_v = float(torch.max(torch.abs(v4 - v_r) / torch.abs(v_r)))
            scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
            rel_g = float(torch.max(torch.abs(G4 - G_r) / scale))
            err_k4 = max(err_k4, float(torch.max(torch.abs(v4 - v_r))),
                         float(torch.max(torch.abs(G4 - G_r))))
            rel_k4 = max(rel_k4, rel_v, rel_g)
            same_k1 = torch.equal(G4, G1) and torch.equal(A4, A1)
            rep4 = ag.ag_kernel(Z32, rf, c4, compensated=True)
            again = all(torch.equal(u, w) for u, w in zip(rep4,
                                                          (A4, G4, C4)))
            ref64 = ag.ag_reference(Z32.double(), rf, c64a)[0]
            e4 = torch.abs(v4 - ref64)
            e1 = torch.abs(A1.double() - ref64)
            print(f"K4 f32 rf={rf:.6g}: combined value rel err vs plain "
                  f"{rel_v:.3e} (bound 2e-6), gradient rel err {rel_g:.3e} "
                  f"(bound 2e-5), value and gradient bit-equal to K1's "
                  f"{same_k1}, repeat bit-identical {again}; distance from "
                  f"the f64 action, relative, K4 "
                  + ", ".join(f"{x:.3e}" for x in (e4 / ref64).tolist())
                  + " vs K1 " + ", ".join(f"{x:.3e}" for x in
                                          (e1 / ref64).tolist()))
            check(rel_v <= 2e-6 and rel_g <= 2e-5,
                  f"K4 disagrees with its plain version at rf={rf}")
            check(same_k1, f"K4's value or gradient differs from K1's at "
                           f"rf={rf}")
            check(again, "K4 repeated launch is not bit-identical")
            check(v4.dtype == torch.float64, "K4's combine is not float64")
            if rf == rfs14[-1]:
                check(bool(torch.all(e4 <= e1))
                      and bool(torch.all(e4 <= 1e-5 * torch.abs(ref64))),
                      "K4 is not closer to the f64 action than K1 at "
                      "rf=4e6")
        # config #5's width: K4's combined value against its plain
        # version's, its value and gradient K1's bits
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 2e-6)):
            c5k4 = ag.ag_consts(spec5, dev, dtype, compensated=True)
            Z = torch.tensor(draws5, dtype=dtype, device=dev)
            for beta in (0, 25, 50):
                rf = float(np.float32(4e-6 * tw5["RM"] * MAIN["alpha"]
                                      ** beta))
                A4, G4, C4 = ag.ag_kernel(Z, rf, c5k4, compensated=True)
                A1, G1 = ag.ag_kernel(Z, rf, c5k4)
                _, _, C_r = ag.ag_reference(Z, rf, c5k4, compensated=True)
                v4 = ag.combine(C4, rf, c5k4)
                v_r = ag.combine(C_r, rf, c5k4)
                rel_v = float(torch.max(torch.abs(v4 - v_r)
                                        / torch.abs(v_r)))
                same_k1 = torch.equal(G4, G1) and torch.equal(A4, A1)
                rel_k4_d400 = max(rel_k4_d400, rel_v)
                print(f"K4 D=400 {str(dtype)[6:]} beta={beta}: combined "
                      f"value rel err vs plain {rel_v:.3e} (bound {tol:g}); "
                      f"value and gradient bit-equal to K1's {same_k1}")
                check(rel_v <= tol and same_k1,
                      f"K4 D=400 {dtype} disagrees at beta={beta}")
        rf_t4 = rfs14[1]
        ms_k4 = events_ms(lambda: ag.ag_kernel(Z32, rf_t4, c4,
                                               compensated=True))
        ms_p4 = events_ms(lambda: ag.ag_reference(Z32, rf_t4, c4,
                                                  compensated=True), n=200)
    finally:
        torch.set_default_dtype(old_dt)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            ag.ag_kernel(Z32, rf_t4, c4, compensated=True)
        torch.cuda.synchronize()
    k4_dev = [(device_us(e), e.count) for e in prof.key_averages()
              if "l96_ag_trap_comp" in e.key]
    dev_k4 = (k4_dev[0][0] / k4_dev[0][1] / 1e3
              if k4_dev and k4_dev[0][0] > 0 else None)
    # K1's bytes plus the (B, 6) row out; K1's operations plus a TwoSum
    # per term (6 rounded adds) and its product: 7 per FE term (r·r), 8
    # per ME term ((W·diff)·diff)
    nbytes_k4 = nbytes + B * 6 * 4
    nops_k4 = nops + B * (7 * (N - 1) * D + 8 * n_obs)
    bound_k4 = bound_of(nbytes_k4, nops_k4)
    print(f"K4 f32 B={MAIN['B']}: kernel {ms_k4:.5f} ms/launch, plain "
          f"{ms_p4:.5f} ms (CUDA events), device time per launch "
          + (f"{dev_k4:.5f} ms (torch.profiler)" if dev_k4 is not None
             else "not measured (no device events)")
          + f"; K1 {ms_kernel:.5f} ms/launch in phase 3; bound {nbytes_k4} "
          f"bytes, {nops_k4} operations -> {bound_k4[0]:.3e} ms "
          f"({bound_k4[1]})")
    phase("14 K4 vs plain", t0)

    # ---- 15. the runner, in process --------------------------------------
    t0 = time.perf_counter()
    from varanneal_tpu_torch import __main__ as runner

    def zero_counts():
        ag.LAUNCHES = ag.COMP_LAUNCHES = ag.AGT_LAUNCHES = 0
        solve_pack.PACK_LAUNCHES = 0
        solve.RUNG_LAUNCHES = solve.LADDER_LAUNCHES = 0
        kdir.DIR_LAUNCHES = kdir.STEP_LAUNCHES = 0
        fe.FWD_LAUNCHES = fe.BWD_LAUNCHES = 0
        fe.SH_FWD_LAUNCHES = fe.SH_VAG_LAUNCHES = 0

    def run_counts():
        return dict(k1=ag.LAUNCHES, k4=ag.COMP_LAUNCHES, k5=ag.AGT_LAUNCHES,
                    k2=solve.RUNG_LAUNCHES, k3=solve.LADDER_LAUNCHES,
                    k8=solve_pack.PACK_LAUNCHES,
                    k7a=kdir.DIR_LAUNCHES, k7b=kdir.STEP_LAUNCHES,
                    k6_fwd=fe.FWD_LAUNCHES, k6_bwd=fe.BWD_LAUNCHES,
                    k6_sh_fwd=fe.SH_FWD_LAUNCHES,
                    k6_sh_vag=fe.SH_VAG_LAUNCHES)

    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "data.npy"),
                np.column_stack([tw["t"], tw["Y"]]))
        np.save(os.path.join(tmp, "x0.npy"), X0q)
        ck = os.path.join(tmp, "ladder.npz")
        out = os.path.join(tmp, "run")
        cfg = dict(
            model={"name": "lorenz96", "D": MAIN["D"]},
            data={"file": os.path.join(tmp, "data.npy")},
            X0=os.path.join(tmp, "x0.npy"), P0=[4.0], out=out,
            alpha=MAIN["alpha"], beta_array={"stop": MAIN["n_beta"]},
            RM=float(tw["RM"]), RF0=float(4e-6 * tw["RM"]),
            Lidx=[int(i) for i in tw["Lidx"]], Pidx=[0],
            compensated=True, engine="ag", checkpoint_path=ck,
            checkpoint_every=10, snapshot_beta=60,
            opt_args=dict(maxiter=500, m=5, maxls=20, gtol=1e-4,
                          ftol=1e-6))
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh)

        def run_main():
            zero_counts()
            buf = io.StringIO()
            t_r = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = runner.main([cfg_path, "--f32"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_r
            check(rc == 0, f"the runner returned {rc}")
            files = (np.load(out + "_paths.npy"),
                     np.load(out + "_params.npy"),
                     np.loadtxt(out + "_action_errors.dat"))
            with np.load(ck) as z:
                ckp = {k: z[k] for k in z.files}
            return wall, run_counts(), files, ckp, buf.getvalue()

        wall_r, cnt_r, files_r, ck_r, log_r = run_main()
        paths_r, params_r, ae_r = files_r
        nfev_r = int(ck_r["nfev"].sum())
        niter_r = int(ck_r["niter"].sum())
        check(niter_r > 0, "runner: no rung took an iteration")
        print(f"runner: {MAIN['n_beta']} rungs, one member, f32, "
              f"compensated, engine ag, in {wall_r:.2f} s; total niter "
              f"{niter_r}, nfev {nfev_r}; launches {cnt_r}; "
              f"{1e3 * wall_r / niter_r:.3f} ms a loop iteration (phase "
              f"11's fused loop, 4 members: {ms_iter_fused:.3f} ms); "
              f"statuses per code 0..3 "
              f"{np.bincount(ck_r['status'], minlength=4).tolist()}; "
              f"final A {ae_r[-1, 1]:.6f}, F {params_r[-1, -1]:.4f}")
        print("runner log, last lines: "
              + " | ".join(log_r.strip().splitlines()[-3:]))
        check(paths_r.shape == (MAIN["n_beta"], spec.N_f, spec.D + 1)
              and params_r.shape[0] == MAIN["n_beta"]
              and ae_r.shape == (MAIN["n_beta"], 4),
              f"runner file shapes {paths_r.shape} {params_r.shape} "
              f"{ae_r.shape}")
        check(all(np.isfinite(a).all() for a in files_r),
              "runner: non-finite values in its files")
        check(cnt_r["k4"] == nfev_r > 0,
              f"K4 launches {cnt_r['k4']} != the ladder's nfev {nfev_r}")
        check(cnt_r["k1"] == 0 and cnt_r["k2"] == 0 and cnt_r["k3"] == 0,
              f"the runner launched K1, K2 or K3: {cnt_r}")
        check(np.array_equal(ck_r["snap0"], ck_r["path0"][59]),
              "runner: the snapshot is not the rung-59 minimizer")
        check(int(ck_r["next_idx"]) == MAIN["n_beta"],
              "runner: the checkpoint did not reach the last rung")
        # cut the checkpoint back to dispatch 90 and resume
        cut = dict(ck_r)
        for k in ("A", "ME", "FE", "status", "niter", "nfev", "pgnorm"):
            cut[k] = ck_r[k][:90]
        cut["path0"] = ck_r["path0"][:90]
        cut["xp0"] = ck_r["path0"][89]
        cut["next_idx"] = np.asarray(90)
        np.savez(ck, **cut)
        wall_s, cnt_s, files_s, ck_s, log_s = run_main()
        nfev_s = int(ck_s["nfev"][90:].sum())
        same = (all(np.array_equal(a[90:], b[90:])
                    for a, b in zip(files_s, files_r))
                and np.array_equal(ck_s["xp0"], ck_r["xp0"])
                and all(np.array_equal(ck_s[k], ck_r[k]) for k in
                        ("A", "nfev", "niter", "status", "path0", "snap0")))
        print(f"runner resumed at dispatch 90: rungs 90..100 in "
              f"{wall_s:.2f} s, nfev {nfev_s}, launches {cnt_s}; rungs "
              f"90..100 and XP_final bit-identical to the uninterrupted "
              f"run: {same}")
        check("resuming at dispatch index 90" in log_s,
              "the runner did not resume from the checkpoint")
        check(same, "the resumed run differs from the uninterrupted one")
        check(cnt_s["k4"] == nfev_s, "resume: K4 launches != its nfev")
    phase("15 runner", t0)

    # ---- 16. the facade, f64 combine --------------------------------------
    t0 = time.perf_counter()
    # β 0..4 at maxiter 20 (tests/test_ag_pallas.py's facade check): from
    # the Quick start's init every rung there stops at its first gradient
    # test, so the two engines' values are compared where they start;
    # rungs 60..61 at maxiter 5 compare them along the first iterations of
    # working solves, before the f32 iterates of the two engines part
    old_dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for betas16, it16 in ((np.arange(5), 20), (np.arange(60, 62), 5)):
            facade16 = {}
            for eng in ("ag", "auto"):
                ann = Annealer(device=dev)
                ann.set_model(lorenz96, MAIN["D"])
                ann.set_data(tw["Y"], t=tw["t"])
                zero_counts()
                ann.anneal(X0q, np.array([4.0]), MAIN["alpha"], betas16,
                           tw["RM"], 4e-6 * tw["RM"], list(tw["Lidx"]), [0],
                           opt_args=dict(maxiter=it16, m=5),
                           compensated=True, dtype=torch.float32,
                           engine=eng)
                torch.cuda.synchronize()
                facade16[eng] = (ann.A_array, ann.nfev_array, run_counts())
            A_ag, A_auto = facade16["ag"][0], facade16["auto"][0]
            rel16 = float(np.max(np.abs(A_ag - A_auto) / np.abs(A_auto)))
            print(f"facade compensated, f32, f64 combine, beta "
                  f"{betas16[0]}..{betas16[-1]}, maxiter {it16}: A "
                  f"engine='ag' " + ", ".join(f"{a:.8g}" for a in A_ag)
                  + " (nfev " + ", ".join(map(str, facade16["ag"][1]))
                  + "); engine='auto' "
                  + ", ".join(f"{a:.8g}" for a in A_auto)
                  + " (nfev " + ", ".join(map(str, facade16["auto"][1]))
                  + f"); max rel diff {rel16:.3e} (bound 1e-4); launches "
                  f"ag {facade16['ag'][2]}, auto {facade16['auto'][2]}")
            check(A_ag.dtype == np.float64 and A_auto.dtype == np.float64,
                  "facade: the compensated records are not float64")
            check(rel16 <= 1e-4, "facade: engine='ag' and 'auto' disagree")
            check(facade16["ag"][2]["k4"] > 0
                  and facade16["auto"][2]["k4"] == 0,
                  "facade: K4 launched on the wrong engine")
    finally:
        torch.set_default_dtype(old_dt)
    phase("16 facade f64 combine", t0)

    # ---- 17. the subspace L-BFGS-B on the card and on the CPU -------------
    t0 = time.perf_counter()
    opts17 = LBFGSOptions(maxiter=30, m=5, pgtol=1e-4, ftol=1e-6,
                          bounded_algo="subspace")
    cpu = torch.device("cpu")
    c64c = ag.ag_consts(spec, cpu, torch.float64)
    lo_c, hi_c = lo64.cpu(), hi64.cpu()
    t17 = 0.0
    it17 = 0
    for beta in betas_s:
        rf = rung_rf(rf0, MAIN["alpha"], beta, torch.float64)
        t_s = time.perf_counter()
        rg = lbfgs_minimize(lambda z: ag.action_and_grad(z, rf, c64a), Z64,
                            lower=lo64, upper=hi64, opts=opts17, device=dev)
        torch.cuda.synchronize()
        t17 += time.perf_counter() - t_s
        it17 += int(rg.niter.max())
        rc_ = lbfgs_minimize(lambda z: ag.action_and_grad(z, rf, c64c),
                             Z64.cpu(), lower=lo_c, upper=hi_c, opts=opts17,
                             device=cpu)
        scale = torch.amax(torch.abs(rc_.x), dim=1, keepdim=True)
        rel = float(torch.max(torch.abs(rg.x.cpu() - rc_.x) / scale))
        feas = bool(((rg.x >= lo64) & (rg.x <= hi64)).all())
        n_at = int(((rg.x == lo64) | (rg.x == hi64)).sum())
        print(f"subspace L-BFGS-B f64 short solve beta={beta}: niter "
              f"{rg.niter.tolist()} / CPU {rc_.niter.tolist()}; nfev "
              f"{rg.nfev.tolist()} / {rc_.nfev.tolist()}; status "
              f"{rg.status.tolist()} / {rc_.status.tolist()}; x rel err "
              f"{rel:.3e} (bound 1e-8); feasible {feas}, {n_at} components "
              f"at a bound")
        check(all(torch.equal(u.cpu(), v) for u, v in
                  zip((rg.niter, rg.nfev, rg.status),
                      (rc_.niter, rc_.nfev, rc_.status))),
              f"subspace L-BFGS-B counts differ card vs CPU at beta={beta}")
        check(rel <= 1e-8 and feas,
              f"subspace L-BFGS-B card vs CPU disagree at beta={beta}")
    print(f"subspace L-BFGS-B on the card, {MAIN['B']} members through K1 "
          f"f64: {1e3 * t17 / it17:.3f} ms an iteration ({it17} "
          f"iterations of the slowest member over three solves)")
    phase("17 subspace L-BFGS-B", t0)

    # ---- 18. K6 against its plain version ---------------------------------
    t0 = time.perf_counter()
    tw2, spec2 = config2_problem()
    # config #5's width with 100 observed (phase 18's own problem: the
    # names tw5/spec5 keep config #5 itself for phases 24 and 26)
    tw18 = lorenz96_twin(D=400, N_data=MAIN["N_data"], n_obs=100)
    spec18 = build_spec(lorenz96, 400, tw18["Y"], tw18["t"], tw18["Lidx"],
                        tw18["RM"], disc="trapezoid", P=np.array([4.0]),
                        pidx=[0])
    both = (torch.float64, torch.float32)
    # (spec, twin, rf0, alpha, B, dtypes): config #1's data under the three
    # one-step discs, config #2's shape, config #5's width
    cases18 = [(dataclasses.replace(spec, disc=d), tw, float(rf0),
                MAIN["alpha"], MAIN["B"], both)
               for d in ("euler", "trapezoid", "forwardmap")]
    cases18 += [(spec2, tw2, CONF2["rf0"], CONF2["alpha"], CONF2["B"], both),
                (spec18, tw18, 4e-6 * tw18["RM"], MAIN["alpha"], 4, both)]
    err18 = dict(onestep_fwd=0.0, onestep_bwd=0.0, sh_fwd=0.0, sh_vag=0.0)
    rel18 = dict(err18)     # value (forward) and gradient (backward) rel
    rng18 = np.random.default_rng(18)

    for sp, tw_, rf0_, alpha_, B_, dtypes in cases18:
        draws18 = member_draws(sp, tw_, 0, B_)
        W18 = rng18.uniform(0.5, 2.0, (sp.N_f - 1, sp.D))
        kf, kb = (("sh_fwd", "sh_vag") if sp.disc == "SimpsonHermite"
                  else ("onestep_fwd", "onestep_bwd"))
        for dtype in dtypes:
            tol = 1e-12 if dtype == torch.float64 else 2e-5
            c = fe.fe_consts(sp, dtype, dev, block_n=64)
            Z = torch.tensor(draws18, dtype=dtype, device=dev)
            X = Z[:, : sp.n_state].reshape(B_, sp.N_f, sp.D)
            pest = Z[:, sp.n_state:]
            worst = [0.0, 0.0]
            for beta in (0, 30, 60):
                rf_b = _scalar_rf(rf0_ * alpha_ ** beta, dtype)
                for rf in (rf_b, torch.tensor(W18 * rf_b, dtype=dtype,
                                              device=dev)):
                    p_k = fe.fe_partials(X, pest, rf, c)
                    g_k, gp_k = fe.fe_adjoint(X, pest, rf, c)
                    torch.cuda.synchronize()
                    p_r, g_r, gp_r = plain_k6(X, pest, rf, c)
                    v_k, v_r = p_k.sum(1), p_r.sum(1)
                    gF_k, gF_r = gp_k.sum(1), gp_r.sum(1)
                    scale = torch.maximum(
                        torch.amax(torch.abs(g_r), dim=(1, 2)),
                        torch.abs(gF_r))
                    rel_v = float(torch.max(torch.abs(v_k - v_r)
                                            / torch.abs(v_r)))
                    rel_g = float(torch.max(torch.maximum(
                        torch.amax(torch.abs(g_k - g_r), dim=(1, 2)),
                        torch.abs(gF_k - gF_r)) / scale))
                    worst = [max(worst[0], rel_v), max(worst[1], rel_g)]
                    rel18[kf] = max(rel18[kf], rel_v)
                    rel18[kb] = max(rel18[kb], rel_g)
                    err18[kf] = max(err18[kf],
                                    float(torch.max(torch.abs(p_k - p_r))))
                    err18[kb] = max(err18[kb],
                                    float(torch.max(torch.abs(g_k - g_r))),
                                    float(torch.max(torch.abs(gp_k - gp_r))))
                    check(rel_v <= tol and rel_g <= tol,
                          f"K6 {sp.disc} D={sp.D} {dtype} disagrees with "
                          f"its plain version at beta={beta}: value "
                          f"{rel_v:.3e}, gradient {rel_g:.3e}")
                    check(torch.equal(p_k, fe.fe_partials(X, pest, rf, c))
                          and torch.equal(g_k,
                                          fe.fe_adjoint(X, pest, rf, c)[0]),
                          f"K6 {sp.disc} {dtype}: a repeat is not "
                          "bit-identical")
                    if c.sh:
                        e_v, r_v, r_g = check_vag(
                            X, pest, rf, c, tol,
                            f"D={sp.D} B={B_} {dtype} beta={beta}")
                        err18["sh_vag"] = max(err18["sh_vag"], e_v)
                        rel18["sh_vag"] = max(rel18["sh_vag"], r_v, r_g)
                        worst = [max(worst[0], r_v), max(worst[1], r_g)]
            print(f"K6 {sp.disc} D={sp.D} N_f={sp.N_f} B={B_} "
                  f"{str(dtype)[6:]}, {sh_grid(c, B_, 'bwd')}, scalar and "
                  f"(N_f-1, D) rf at beta 0, 30, 60: value rel err "
                  f"{worst[0]:.3e}, gradient rel err {worst[1]:.3e} of "
                  f"max|g| (bound {tol:g})"
                  + (", the fused launch included" if c.sh else "")
                  + "; repeats bit-identical")

    # times at the paths' shape (one member, f32, scalar rf of beta 30,
    # rows a block as select_action builds them), against the bound, the
    # plain versions and the autograd action's value+grad (the yardstick;
    # no one PyTorch call computes K6's function)
    k6 = {}
    for sp, tw_, rf0_, alpha_ in ((spec, tw, float(rf0), MAIN["alpha"]),
                                  (spec2, tw2, CONF2["rf0"],
                                   CONF2["alpha"])):
        c = fe.fe_consts(sp, torch.float32, dev, block_n=64)
        Z1 = torch.tensor(member_draws(sp, tw_, 0, 1), dtype=torch.float32,
                          device=dev)
        X1 = Z1[:, : sp.n_state].reshape(1, sp.N_f, sp.D)
        p1 = Z1[:, sp.n_state:]
        rf1 = _scalar_rf(rf0_ * alpha_ ** 30, torch.float32)
        vag_x = value_and_grad(make_action(sp, device=dev)[0])
        vag_k6 = value_and_grad(fe.make_action_pallas(sp, block_n=64,
                                                      device=dev)[0])
        ms_ag = events_ms(lambda: vag_x(Z1, rf1), n=200)
        ms_k6a = events_ms(lambda: vag_k6(Z1, rf1), n=200)
        t = k6_times(X1, p1, rf1, c)
        for kern, r in t.items():
            r.update(autograd_ms=ms_ag, action_ms=ms_k6a)
            k6[kern] = r
        print_k6_times("K6", t, c, 1)
        print(f"K6 action value+grad ({sp.disc}, one member, f32, "
              f"action.value_and_grad): {ms_k6a:.5f} ms; the autograd "
              f"action's {ms_ag:.5f} ms (CUDA events, 200 calls each)")
    # K6d: the Hermite–Simpson kernels on a batch (the ensemble's path,
    # phase 20's B=8 in f64), at the shape phase 18 checks them
    c8 = fe.fe_consts(spec2, torch.float64, dev, block_n=64)
    Z8 = torch.tensor(member_draws(spec2, tw2, 0, CONF2["B"]),
                      dtype=torch.float64, device=dev)
    X8 = Z8[:, : spec2.n_state].reshape(CONF2["B"], spec2.N_f, spec2.D)
    p8 = Z8[:, spec2.n_state:]
    rf8 = _scalar_rf(CONF2["rf0"] * CONF2["alpha"] ** 30, torch.float64)
    k6d = k6_times(X8, p8, rf8, c8)
    print_k6_times("K6d", k6d, c8, CONF2["B"])
    # NaKL on config #3's twin (the example's; phase 27a runs it too)
    tw3, _ = config3_problem()
    err18n, rel18n, k6n = k6_nakl(dev, tw3)
    phase("18 K6 vs plain", t0)

    # ---- 19. f64 ladder at config #2: K6 vs the autograd action ------------
    t0 = time.perf_counter()
    rng19 = np.random.default_rng(1)
    xp19 = torch.tensor(np.stack([pack(
        spec2, _insert_midpoints(tw2["traj"] + 0.3 * rng19.normal(
            size=tw2["traj"].shape)),
        np.array([tw2["F"] + 0.5 * rng19.normal()])) for _ in range(2)]),
        device=dev)
    # K6's action through its value_and_grad (the fused launch) and the
    # autograd action, F64_RUNGS rungs each
    runs19, walls19, cnt19 = {}, {}, {}
    for name19, (a19, p19) in (
            ("fused", fe.make_action_pallas(spec2, device=dev)),
            ("autograd", make_action(spec2, device=dev))):
        zero_counts()
        t_19 = time.perf_counter()
        runs19[name19] = make_ensemble_ladder(
            a19, p19, np.arange(F64_RUNGS), float(tw2["RM"]),
            CONF2["alpha"], opts=opts_t, device=dev)(xp19)
        torch.cuda.synchronize()
        walls19[name19] = time.perf_counter() - t_19
        cnt19[name19] = run_counts()
    st_k = runs19["fused"].status.cpu().numpy()
    A_k19 = runs19["fused"].A.cpu().numpy()
    st_p = runs19["autograd"].status.cpu().numpy()
    A_p19 = runs19["autograd"].A.cpu().numpy()
    both19 = (st_k <= 1) & (st_p <= 1)
    rel19 = np.where(both19, np.abs(A_k19 - A_p19) / np.abs(A_p19), 0.0)
    c19 = cnt19["fused"]
    print(f"f64 ladder at config #2 ({F64_RUNGS} rungs, 2 members from "
          f"near the "
          f"truth, rf0 = RM, pgtol 1e-8), K6's fused launch against the "
          f"autograd action: mutually converged rungs "
          f"{int(both19.sum())}/{both19.size}; max rel A difference "
          f"{rel19.max():.3e} (bound 1e-8); niter "
          f"{runs19['fused'].niter.sum().item()} vs "
          f"{runs19['autograd'].niter.sum().item()}; wall "
          f"{walls19['fused']:.2f} s vs {walls19['autograd']:.2f} s; "
          f"launches {c19}")
    check(both19.mean() >= 0.8, f"too few converged rungs: {st_k} {st_p}")
    check(np.all(rel19 <= 1e-8), f"f64 ladder through K6 disagrees: {rel19}")
    check(c19["k6_sh_vag"] > 0,
          f"the f64 ladder through K6: no fused launch, {c19}")
    phase("19 f64 ladder K6 vs autograd", t0)

    # ---- 20. the facade at config #2 (path a), then the ensemble (path b) --
    t0 = time.perf_counter()
    ann20 = Annealer(device=dev)
    ann20.set_model(lorenz96, CONF2["D"])
    ann20.set_data(tw2["Y"], t=tw2["t"])
    X0_20 = np.random.default_rng(1).uniform(-10, 10, size=(
        CONF2["N_data"], CONF2["D"]))
    zero_counts()
    t_20 = time.perf_counter()
    ann20.anneal(X0_20, np.array([4.0]), alpha=CONF2["alpha"],
                 beta_array=np.arange(CONF2["n_beta"]), RM=tw2["RM"],
                 RF0=CONF2["rf0"], Lidx=tw2["Lidx"], Pidx=[0],
                 disc="SimpsonHermite",
                 opt_args=dict(maxiter=CONF2["maxiter"]),
                 dtype=torch.float32, engine="pallas")
    torch.cuda.synchronize()
    wall20 = time.perf_counter() - t_20
    cnt20 = run_counts()
    nfev20 = int(ann20.nfev_array.sum())
    niter20 = int(ann20.niter_array.sum())
    F20 = float(ann20.minpaths_P[-1, 0])
    err20 = ann20.minpaths_X[-1][::2] - tw2["traj"]
    n0, n1 = CONF2["N_data"] // 5, CONF2["N_data"] - CONF2["N_data"] // 5
    unobs = np.setdiff1d(np.arange(CONF2["D"]), np.asarray(tw2["Lidx"]))
    rmse_obs = float(np.sqrt(np.mean(err20[n0:n1][:, tw2["Lidx"]] ** 2)))
    rmse_unobs = float(np.sqrt(np.mean(err20[n0:n1][:, unobs] ** 2)))
    # the example's opt_args leave m at 10, outside K7b's envelope
    # (2m + 1 <= 16, the reference's policy): the compact loop runs
    fused20 = kdir.dir_predicate(spec2.n_dof, 10, torch.float32)
    print(f"facade at config #2 (engine='pallas', f32, {CONF2['n_beta']} "
          f"rungs, maxiter {CONF2['maxiter']}, one init): wall "
          f"{wall20:.2f} s; niter {niter20}, nfev {nfev20}; "
          f"{1e3 * wall20 / max(niter20, 1):.3f} ms a loop iteration "
          f"({'fused' if fused20 else 'compact'} loop); F = {F20:.4f} "
          f"(truth {tw2['F']}); interior RMSE obs {rmse_obs:.3f} / unobs "
          f"{rmse_unobs:.3f} (noise {tw2['sigma']}); final A "
          f"{float(ann20.A_array[-1]):.6g}; exit flags per code 0..2 "
          f"{np.bincount(ann20.exitflags, minlength=3).tolist()}; "
          f"launches {cnt20}")
    check(ann20.A_array.shape == (CONF2["n_beta"],)
          and bool(np.isfinite(ann20.A_array).all()),
          "facade at config #2: records not (61,) and finite")
    check(set(np.unique(ann20.exitflags)) <= {0, 1, 2},
          f"facade at config #2: exit flags {ann20.exitflags}")
    check(cnt20["k6_sh_vag"] == nfev20 > 0
          and cnt20["k6_sh_fwd"] == CONF2["n_beta"],
          f"facade at config #2: one fused launch an evaluation and K6's "
          f"forward once a rung for the records, got {cnt20}, nfev "
          f"{nfev20}")
    check(cnt20["k7b"] == (niter20 if fused20 else 0)
          and cnt20["k7a"] == 0,
          f"facade at config #2: K7 launches {cnt20}, niter {niter20}")
    check(all(cnt20[k] == 0 for k in ("k1", "k2", "k3", "k4", "k6_fwd",
                                      "k6_bwd")),
          f"facade at config #2 launched another kernel: {cnt20}")
    # path (b): the example's run_ensemble, B=8 members, first 10 rungs, a
    # checkpoint every 2 (float64, as the example's x64 run)
    act_b, parts_b = fe.select_action(spec2, CONF2["rf0"], engine="pallas",
                                      dtype=torch.float64, device=dev)
    xp_b = torch.tensor(random_ensemble_inits(spec2, CONF2["B"], seed=1),
                        device=dev)
    zero_counts()
    t_b = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck_b = os.path.join(tmp, "ensemble.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            res_b = run_ladder_checkpointed(
                act_b, parts_b, xp_b, np.arange(10),
                np.float64(CONF2["rf0"]), CONF2["alpha"],
                opts=LBFGSOptions(maxiter=CONF2["maxiter"]),
                store_paths=False, batched=True, ckpt_path=ck_b,
                save_every=2, meta=dict(ninit=CONF2["B"], seed=1),
                verbose=True, device=dev)
        torch.cuda.synchronize()
        with np.load(ck_b) as z:
            ck_next = int(z["next_idx"])
    wall_b = time.perf_counter() - t_b
    cnt_b = run_counts()
    lock_b = int(res_b.nfev.max(dim=0).values.sum())
    print(f"ensemble at config #2 (B={CONF2['B']}, rungs 0..9, f64, "
          f"checkpointed every 2): wall {wall_b:.2f} s; nfev per member "
          f"{res_b.nfev.sum(dim=1).tolist()}, per-rung max over members "
          f"summed {lock_b}; final A per member "
          + ", ".join(f"{a:.6g}" for a in res_b.A[:, -1].tolist())
          + f"; launches {cnt_b}")
    check(tuple(res_b.A.shape) == (CONF2["B"], 10)
          and bool(torch.isfinite(res_b.A).all()) and ck_next == 10,
          "ensemble at config #2: records or checkpoint wrong")
    check(cnt_b["k6_sh_vag"] >= lock_b > 0 and cnt_b["k6_sh_fwd"] == 10,
          f"ensemble at config #2: K6 launches {cnt_b} for {lock_b} "
          "evaluations of the slowest members and 10 rungs' records")
    phase("20 facade and ensemble at config #2", t0)

    # ---- 21. the bench with BENCH_ENGINE=pallas ----------------------------
    t0 = time.perf_counter()
    bench21 = {}
    for solver_name, tail in (("xla", "20"), ("fused", "0")):
        buf_out, buf_err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf_out), \
                contextlib.redirect_stderr(buf_err):
            run = bench.main(device=dev, env=dict(
                BENCH_SOLVER=solver_name, BENCH_ENGINE="pallas",
                BENCH_TAIL64=tail))
        print(f"bench pallas {solver_name}: " + buf_out.getvalue().strip())
        print(f"bench pallas {solver_name}: " + buf_err.getvalue().strip())
        L = run.launches
        niter21 = int(run.res.niter.sum())
        print(f"bench pallas {solver_name}: timed f32 ladder {run.wall:.3f} "
              f"s, one member, {niter21} iterations "
              f"({1e3 * run.wall / max(niter21, 1):.3f} ms an iteration), "
              f"total nfev {run.total_nfev}; launches in the {run.calls} "
              f"ladder calls {L}")
        check(tuple(run.res.A.shape) == (1, MAIN["n_beta"])
              and bool(torch.isfinite(run.res.A).all()),
              f"bench pallas {solver_name}: records")
        check(L["ag"] == 0 and L["ladder"] == 0,
              f"bench pallas {solver_name} launched K1 or K3: {L}")
        if solver_name == "xla":
            fa = run.out["final_A_tail64"]
            rel21 = abs(fa - JAX_FINAL_A_TAIL64) / JAX_FINAL_A_TAIL64
            print(f"bench pallas xla: final_A_tail64 {fa:.6f} vs JAX "
                  f"{JAX_FINAL_A_TAIL64:.6f} (rel {rel21:.3e}, bound 1e-2)")
            check(L["fe_fwd"] > 0 and L["fe_bwd"] > 0 and L["rung"] == 0,
                  f"bench pallas xla did not run through K6: {L}")
            check(rel21 <= 1e-2, f"bench pallas xla: final_A_tail64 {fa}")
        else:
            check(L["rung"] == MAIN["n_beta"] * run.calls
                  and L["fe_fwd"] == MAIN["n_beta"] * run.calls
                  and L["fe_bwd"] == 0,
                  f"bench pallas fused: K2 a rung and K6 for the records "
                  f"only, got {L}")
        bench21[solver_name] = run
    phase("21 bench pallas", t0)

    # ---- 22. K5 against its plain version ---------------------------------
    t0 = time.perf_counter()
    # (spec, twin, label): config #1's data under the three one-step rules,
    # observations every second model row, and the envelope's D = 64
    dt1 = float(tw["t"][1] - tw["t"][0])
    tw64 = lorenz96_twin(D=64, N_data=MAIN["N_data"], n_obs=16)
    cases22 = [(dataclasses.replace(spec, disc=d), tw, d)
               for d in ("trapezoid", "euler", "forwardmap")]
    cases22 += [(build_spec(lorenz96, MAIN["D"], tw["Y"], tw["t"],
                            tw["Lidx"], tw["RM"], disc="trapezoid",
                            P=np.array([4.0]), pidx=[0], dt_model=dt1 / 2),
                 tw, "trapezoid, obs_stride 2"),
                (build_spec(lorenz96, 64, tw64["Y"], tw64["t"],
                            tw64["Lidx"], tw64["RM"], disc="trapezoid",
                            P=np.array([4.0]), pidx=[0]),
                 tw64, "trapezoid, D=64")]
    check(cases22[3][0].obs_stride == 2, "phase 22: stride-2 spec")
    err_k5 = rel_k5 = 0.0
    rng22 = np.random.default_rng(22)
    for sp, tw_, label in cases22:
        check(ag.agt_supported(sp, 1.0, torch.float32)
              and ag.agt_supported(sp, 1.0, torch.float64),
              f"phase 22: {label} outside K5's envelope")
        Zs = member_draws(sp, tw_, 0)
        W22 = rng22.uniform(0.5, 2.0, (sp.N_f - 1, sp.D))
        for dtype in (torch.float64, torch.float32):
            tol = 1e-12 if dtype == torch.float64 else 2e-5
            c = ag.agt_consts(sp, dev, dtype)
            Z = torch.tensor(Zs, dtype=dtype, device=dev)
            worst = 0.0
            for beta in (0, 50, 100):
                rf_b = float(rf0 * MAIN["alpha"] ** beta)
                for rf in (rf_b, torch.tensor(W22 * rf_b, dtype=dtype,
                                              device=dev)):
                    A, G = ag.agt_kernel(Z, rf, c)
                    torch.cuda.synchronize()
                    A_r, G_r = ag.agt_reference(Z, rf, c)
                    scale = torch.amax(torch.abs(G_r), dim=1, keepdim=True)
                    rel = max(float(torch.max(torch.abs(A - A_r)
                                              / torch.abs(A_r))),
                              float(torch.max(torch.abs(G - G_r) / scale)))
                    worst = max(worst, rel)
                    err_k5 = max(err_k5, float(torch.max(torch.abs(A - A_r))),
                                 float(torch.max(torch.abs(G - G_r))))
                    check(rel <= tol, f"K5 {label} {dtype} disagrees with "
                          f"its plain version at beta={beta}: {rel:.3e}")
                    A2, G2 = ag.agt_kernel(Z, rf, c)
                    check(torch.equal(A, A2) and torch.equal(G, G2),
                          f"K5 {label} {dtype}: a repeat is not "
                          "bit-identical")
            rel_k5 = max(rel_k5, worst)
            print(f"K5 {label} D={sp.D} N_f={sp.N_f} B={MAIN['B']} "
                  f"{str(dtype)[6:]}, scalar and (N_f-1, D) rf at beta 0, "
                  f"50, 100: worst rel err {worst:.3e} (value, and gradient "
                  f"of max|g|; bound {tol:g}); repeats bit-identical")
    # times at the main path's shape (trapezoid, f32, B=4, phase 3's draws,
    # the rf of beta 50), against K1 and the autograd action on the same
    # input, and the (N_f-1, D) rf's
    c5 = ag.agt_consts(spec, dev, torch.float32)
    W5 = torch.tensor(rng22.uniform(0.5, 2.0, (spec.N_f - 1, spec.D)) * rf_t,
                      dtype=torch.float32, device=dev)
    k5 = {}
    for kind, rf in (("scalar", rf_t), ("diag", W5)):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                ag.agt_kernel(Z32, rf, c5)
            torch.cuda.synchronize()
        rows = [(device_us(e), e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "l96_agt" in e.key]
        w = agt_work(spec, "trapezoid", MAIN["B"], kind == "diag")
        k5[kind] = dict(
            ms=events_ms(lambda: ag.agt_kernel(Z32, rf, c5)),
            plain_ms=events_ms(lambda: ag.agt_reference(Z32, rf, c5), n=200),
            device_ms=(rows[0][0] / rows[0][1] / 1e3
                       if rows and rows[0][0] > 0 else None),
            bound=bound_of(*w), work=w)
    ms_k1_22 = events_ms(lambda: ag.ag_kernel(Z32, rf_t, c32))
    ms_ag_22 = events_ms(lambda: vag32(Z32, rf_t), n=200)
    for kind, r in k5.items():
        print(f"K5 f32 trapezoid, {kind} rf, B={MAIN['B']}: {r['ms']:.5f} ms "
              "a launch (CUDA events), device time "
              + (f"{r['device_ms']:.5f} ms (torch.profiler)"
                 if r["device_ms"] is not None
                 else "not measured (no device events)")
              + f"; plain {r['plain_ms']:.5f} ms; bound {r['bound'][0]:.3e} "
              f"ms ({r['bound'][1]}: {r['work'][0]} bytes, {r['work'][1]} "
              f"operations)")
    print(f"yardsticks on the same input: K1 {ms_k1_22:.5f} ms a launch, the "
          f"autograd action's value+grad {ms_ag_22:.5f} ms (CUDA events)")
    phase("22 K5 vs plain", t0)

    # ---- 23. the K5 ladder -------------------------------------------------
    t0 = time.perf_counter()
    act5, parts5 = ag.make_action_ag_t(spec, device=dev, dtype=torch.float32)
    act5d, parts5d = ag.make_action_ag_t(spec, device=dev,
                                         dtype=torch.float64)
    xp23 = xp0[:1].contiguous()        # member 0: bench.py's single init
    check(kdir.dir_supported(xp23, opts_f.m),
          "phase 23: direction='auto' would not take the fused loop")
    ladder23 = make_ensemble_ladder(
        act5, parts5, np.arange(MAIN["n_beta"]), np.float32(rf0),
        MAIN["alpha"], opts=opts_f, store_paths=True, device=dev)
    zero_counts()
    t_23 = time.perf_counter()
    res23 = ladder23(xp23)
    torch.cuda.synchronize()
    wall23 = time.perf_counter() - t_23
    cnt23 = run_counts()
    nfev23 = int(res23.nfev.sum())
    niter23 = int(res23.niter.sum())
    t_tail = time.perf_counter()
    tail23 = run_ladder(act5d, parts5d, res23.XP.double(),
                        np.arange(MAIN["n_beta"] - MAIN["tail"],
                                  MAIN["n_beta"]), rf0, MAIN["alpha"],
                        opts=opts64, store_paths=False, device=dev)
    torch.cuda.synchronize()
    wall23t = time.perf_counter() - t_tail
    fa23 = float(tail23.A[0, -1])
    rel23 = abs(fa23 - JAX_FINAL_A_TAIL64) / JAX_FINAL_A_TAIL64
    print(f"K5 ladder: {MAIN['n_beta']} f32 rungs, one member, the fused "
          f"loop over make_action_ag_t: {wall23:.2f} s, niter {niter23}, "
          f"nfev {nfev23}, {1e3 * wall23 / niter23:.3f} ms a loop iteration "
          f"(phase 11's fused loop over K1, 4 members: {ms_iter_fused:.3f} "
          f"ms; phase 15's runner over K4, one member: "
          f"{1e3 * wall_r / niter_r:.3f} ms); launches {cnt23}; f64 tail "
          f"through K5 in f64: {MAIN['tail']} rungs in {wall23t:.2f} s, "
          f"final_A_tail64 {fa23:.6f} vs JAX {JAX_FINAL_A_TAIL64:.6f} (rel "
          f"{rel23:.3e}, bound 1e-2)")
    check(cnt23["k5"] >= nfev23 > 0,
          f"the K5 ladder did not evaluate through K5: {cnt23}, nfev {nfev23}")
    check(cnt23["k7b"] == niter23,
          f"the K5 ladder's loop is not the fused one: {cnt23}, niter "
          f"{niter23}")
    check(all(cnt23[k] == 0 for k in ("k1", "k2", "k3", "k4", "k8")),
          f"the K5 ladder launched another kernel: {cnt23}")
    check(bool(torch.isfinite(res23.A).all())
          and bool(torch.isfinite(tail23.A).all()), "K5 ladder: non-finite A")
    check(rel23 <= 1e-2, f"K5 ladder: final_A_tail64 {fa23}")
    c5d = ag.agt_consts(spec, dev, torch.float64)
    ratio_k5 = 0.0
    for k in (0, 60, MAIN["n_beta"] - 1):
        rf_k = rung_rf(np.float32(rf0), MAIN["alpha"], k, torch.float32)
        XP_k = res23.paths[:, k].contiguous()
        errs, at, med, (A, G, A_r, G_r) = minimizer_errs(
            ag.agt_kernel, ag.agt_reference, XP_k, rf_k, c5, c5d)
        err_k5 = max(err_k5, float(torch.max(torch.abs(A - A_r))),
                     float(torch.max(torch.abs(G - G_r))))
        ratio_k5 = max(ratio_k5, err_ratio(errs))
        print(f"K5 f32 at the K5 ladder's minimizer of rung {k}: error vs "
              f"f64, the kernel's at the minimizer / the plain f32 "
              f"version's median over 24 f32 neighbours: A {errs[0]:.3e} / "
              f"{errs[1]:.3e}, gradient {errs[2]:.3e} / {errs[3]:.3e} "
              f"(bound 4x plain; the plain version's at the minimizer A "
              f"{at[0]:.3e}, gradient {at[1]:.3e}; the kernel's median A "
              f"{med[0]:.3e}, gradient {med[1]:.3e})")
        check(errs[0] <= 4.0 * errs[1] and errs[2] <= 4.0 * errs[3],
              f"K5 disagrees with its plain version at rung {k}")
    phase("23 K5 ladder", t0)

    # ---- 24. K8 against K2 and against its plain version ------------------
    t0 = time.perf_counter()
    pack_attrs = {}
    for G_ in solve_pack.GROUPS:
        for dtype in (torch.float32, torch.float64):
            for bd in (False, True):
                # G = 256 takes K2's layouts: the global one's chunk and the
                # on-chip one's
                for lay in ((0, solve.VECTORS | solve.HISTORY) if G_ == 256
                            else (0,)):
                    a = solve_pack.kernel_attrs(G_, dtype, bd, lay)
                    k2a = solve.kernel_attrs(False, dtype, bd, lay)
                    pack_attrs[(G_, str(dtype)[6:], bd, lay)] = a
                    print(f"K8 kernel G={G_} {str(dtype)[6:]} "
                          f"{'bounded' if bd else 'unbounded'} layout {lay}: "
                          f"{a['regs']} registers, {a['local_bytes']} bytes "
                          f"of local memory (spills and stack; K2's kernel "
                          f"of the same chunk {k2a['local_bytes']}), at most "
                          f"{a['max_threads']} threads a block")
                    check(a["regs"] <= 255 and a["max_threads"] >= 256,
                          f"K8 G={G_}: {a}")
                    check(dtype != torch.float32
                          or a["local_bytes"] <= k2a["local_bytes"],
                          f"K8 G={G_} f32 takes more local memory than K2's "
                          f"call frame: {a} vs {k2a}")
    # no f32 K8 kernel spills: ptxas's report of phase 2's build, each
    # entry's spill stores and loads and those of the functions it calls
    spills, entry = {}, None
    for ln in built["pack_kernel"].log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif entry and "bytes spill stores" in ln:
            st, ld = (int(x.split()[0]) for x in ln.split(",")[1:3])
            spills[entry] = spills.get(entry, 0) + st + ld
    f32_spills = {k: v for k, v in spills.items()
                  if "l96_pack_kernelIf" in k}
    if built["pack_kernel"].log:        # built here, not loaded from disk
        print(f"K8 f32 kernels (ptxas): {len(f32_spills)} entries, spill "
              f"bytes {sorted(set(f32_spills.values()))}; f64: "
              + str(sorted(v for k, v in spills.items()
                           if "l96_pack_kernelId" in k)))
        check(len(f32_spills) == 8 and not any(f32_spills.values()),
              f"K8 f32 kernels spill: {f32_spills}")
    else:
        print("K8 spills: not read (the library was loaded from disk)")
    err_k8 = rel_k8 = 0.0
    n8 = 0                  # K8 launches of this phase
    for dtype in (torch.float64, torch.float32):
        c = ag.ag_consts(spec, dev, dtype)
        c_cpu = ag.ag_consts(spec, "cpu", dtype)
        for B_, kp in ((4, 2), (5, 2), (6, 3), (4, 4), (8, 8)):
            G_ = solve_pack.pack_group(kp)
            check(solve_pack.pack_supported(spec, 1.0, opts_s, kp, dtype,
                                            device=dev),
                  f"pack {kp} outside K8's envelope")
            Z = torch.tensor(member_draws(spec, tw, 0, B_), dtype=dtype,
                             device=dev)
            for beta in betas_s:
                rf = rung_rf(rf0 if dtype == torch.float64
                             else np.float32(rf0), MAIN["alpha"], beta, dtype)
                before = solve_pack.PACK_LAUNCHES
                r8 = solve_pack.pack_kernel(Z, rf, c, opts_s, kp)
                torch.cuda.synchronize()
                check(solve_pack.PACK_LAUNCHES == before + 1,
                      "K8 took more than one launch a call")
                n8 += 1
                r2 = solve.solve_kernel(Z, rf, c, opts_s)
                rp = solve_pack.pack_reference(Z, rf, c, opts_s, kp)
                same = all(torch.equal(u, v) for u, v in
                           zip((r8.niter, r8.nfev, r8.status),
                               (rp.niter, rp.nfev, rp.status)))
                bit2 = all(torch.equal(u, v) for u, v in zip(r8, r2))
                err_k8 = max(err_k8, float(torch.max(torch.abs(r8.x - rp.x))))
                if dtype == torch.float64:
                    scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
                    rel = float(torch.max(torch.abs(r8.x - rp.x) / scale))
                    bound8, what = 1e-8, "x"
                else:
                    rel = float(torch.max(torch.abs(r8.f - rp.f)
                                          / torch.abs(rp.f)))
                    rc = solve.solve_reference(Z.cpu(), rf, c_cpu, opts_s)
                    wit = float(torch.max(torch.abs(rp.f.cpu() - rc.f)
                                          / torch.abs(rc.f)))
                    bound8, what = max(1e-4, 2.0 * wit), "f"
                rel_k8 = max(rel_k8, rel)
                print(f"K8 {str(dtype)[6:]} B={B_} pack={kp} G={G_} "
                      f"beta={beta}: {what} rel err vs plain {rel:.3e} "
                      f"(bound {bound8:.3e}); counts as plain {same}; "
                      f"bit-identical to K2 {bit2}; niter "
                      f"{r8.niter.tolist()}")
                check(same and rel <= bound8,
                      f"K8 {dtype} B={B_} pack={kp} disagrees with its "
                      f"plain version at beta={beta}")
                check(bit2 or G_ != 256,
                      f"K8 at G=256 differs from K2 at B={B_} pack={kp}")
    # bounded, phase 12's box, pack 2
    for dtype, lo_, hi_, c in ((torch.float64, lo64, hi64, c64m),
                               (torch.float32, lo32, hi32, c32)):
        Z = Z64 if dtype == torch.float64 else Z32
        for beta in betas_s:
            rf = rung_rf(rf0 if dtype == torch.float64 else np.float32(rf0),
                         MAIN["alpha"], beta, dtype)
            r8 = solve_pack.pack_kernel(Z, rf, c, opts_s, 2, lo_, hi_)
            torch.cuda.synchronize()
            n8 += 1
            r2 = solve.solve_kernel(Z, rf, c, opts_s, lo_, hi_)
            rp = solve_pack.pack_reference(Z, rf, c, opts_s, 2, lo_, hi_)
            same = all(torch.equal(u, v) for u, v in
                       zip((r8.niter, r8.nfev, r8.status),
                           (rp.niter, rp.nfev, rp.status)))
            bit2 = all(torch.equal(u, v) for u, v in zip(r8, r2))
            feas = bool(((r8.x >= lo_) & (r8.x <= hi_)).all())
            if dtype == torch.float64:
                scale = torch.amax(torch.abs(rp.x), dim=1, keepdim=True)
                rel = float(torch.max(torch.abs(r8.x - rp.x) / scale))
                bound8, what = 1e-8, "x"
            else:
                rel = float(torch.max(torch.abs(r8.f - rp.f)
                                      / torch.abs(rp.f)))
                bound8, what = F32_BOUNDED_F_TOL, "f"
            rel_k8 = max(rel_k8, rel)
            print(f"K8 bounded {str(dtype)[6:]} B={MAIN['B']} pack=2 "
                  f"beta={beta}: {what} rel err vs plain {rel:.3e} (bound "
                  f"{bound8:g}); counts as plain {same}; bit-identical to K2 "
                  f"bounded {bit2}; feasible {feas}")
            check(same and rel <= bound8 and feas and bit2,
                  f"K8 bounded {dtype} disagrees at beta={beta}")
    # config #5's width, pack 2 (G = 256): K2's bits and the plain
    # version's counts
    for dtype in (torch.float64, torch.float32):
        c = ag.ag_consts(spec5, dev, dtype)
        Z = torch.tensor(draws5, dtype=dtype, device=dev)
        rf = rung_rf(np.float32(4e-6 * tw5["RM"]), MAIN["alpha"], 25, dtype)
        r8 = solve_pack.pack_kernel(Z, rf, c, opts_s, 2)
        r2 = solve.solve_kernel(Z, rf, c, opts_s)
        rp = solve_pack.pack_reference(Z, rf, c, opts_s, 2)
        torch.cuda.synchronize()
        n8 += 1
        bit2 = all(torch.equal(u, v) for u, v in zip(r8, r2))
        same = all(torch.equal(u, v) for u, v in
                   zip((r8.niter, r8.nfev, r8.status),
                       (rp.niter, rp.nfev, rp.status)))
        print(f"K8 D=400 {str(dtype)[6:]} B={MAIN['B']} pack=2 beta=25: "
              f"bit-identical to K2 {bit2}; counts as plain {same}; niter "
              f"{r8.niter.tolist()}")
        check(bit2 and same, f"K8 D=400 {dtype} differs from K2 or from "
              "its plain version's counts")
    # times: the short solves at the rf of beta 50, f32, B=4
    rf24 = rung_rf(np.float32(rf0), MAIN["alpha"], 50, torch.float32)
    ms8 = {kp: events_ms(lambda: solve_pack.pack_kernel(
        Z32, rf24, c32, opts_s, kp), n=5, warm=2) for kp in (2, 4)}
    ms_k2_24 = events_ms(lambda: solve.solve_kernel(Z32, rf24, c32, opts_s),
                         n=5, warm=2)
    t_p = time.perf_counter()
    r24 = solve_pack.pack_reference(Z32, rf24, c32, opts_s, 2)
    torch.cuda.synchronize()
    ms_p8 = (time.perf_counter() - t_p) * 1e3
    bound_k8 = solve_bound(spec, torch.float32, MAIN["B"], 1,
                           int(r24.nfev.sum()), int(r24.niter.sum()),
                           opts_s.m, rungs=1)
    print(f"K8 f32 short solves (B=4, maxiter 30, the rf of beta 50): pack 2 "
          f"{ms8[2]:.4f} ms, pack 4 {ms8[4]:.4f} ms a launch, K2 "
          f"{ms_k2_24:.4f} ms (CUDA events); plain {ms_p8:.4f} ms; bound "
          f"{bound_k8[0]:.3e} ms ({bound_k8[1]}: {bound_k8[2]} bytes, "
          f"{bound_k8[3]} operations)")
    # where packing can pay: K2 against K8 at packs 2, 4 and 8, a launch
    # each, on these short solves at B = 1, 2 and 4 times the SM count and
    # at config #5's shape (D=400, B=1024): printed, not held
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ab24 = {}
    for label, sp, tw_, c_, Bs in (
            ("config #1", spec, tw, c32, (sms, 2 * sms, 4 * sms)),
            ("config #5", spec5, tw5, ag.ag_consts(spec5, dev, torch.float32),
             (1024,))):
        rf_ab = rung_rf(np.float32(4e-6 * tw_["RM"]), MAIN["alpha"], 50,
                        torch.float32)
        for B_ in Bs:
            Z = torch.tensor(member_draws(sp, tw_, 24, B_),
                             dtype=torch.float32, device=dev)
            reps = 1 if B_ >= 1024 else 3
            row = {}
            for kp in (1, 2, 4, 8):
                def one(kp=kp):
                    if kp == 1:
                        return solve.solve_kernel(Z, rf_ab, c_, opts_s)
                    return solve_pack.pack_kernel(Z, rf_ab, c_, opts_s, kp)
                r_ab = one()            # the warm-up too
                ms_ab = events_ms(one, n=reps, warm=0)
                bnd_ab = solve_bound(sp, torch.float32, B_, 1,
                                     int(r_ab.nfev.sum()),
                                     int(r_ab.niter.sum()), opts_s.m,
                                     rungs=1)
                row[kp] = (ms_ab, bnd_ab, int(r_ab.nfev.sum()))
            ab24[(label, B_)] = row
            print(f"pack A/B ({label}, B={B_}, f32, maxiter 30, the rf of "
                  f"beta 50, one launch): " + "; ".join(
                      f"{'K2' if kp == 1 else f'K8 pack {kp} (G={solve_pack.pack_group(kp)})'}"
                      f" {v[0]:.4f} ms (bound {v[1][0]:.3e} ms, {v[1][1]}; "
                      f"nfev {v[2]})" for kp, v in row.items())
                  + "; K2 / K8: " + ", ".join(
                      f"pack {kp} {row[1][0] / row[kp][0]:.3f}x"
                      for kp in (2, 4, 8)))
            del Z
    phase("24 K8 vs K2 and plain", t0)

    # ---- 25. the bench with BENCH_PACK -------------------------------------
    t0 = time.perf_counter()
    bench25 = {}
    for kp, tail in ((2, "0"), (4, str(MAIN["tail"]))):
        buf_out, buf_err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf_out), \
                contextlib.redirect_stderr(buf_err), \
                launch_events(solve_pack, "pack_kernel") as ev_k8:
            run = bench.main(device=dev, env=dict(
                BENCH_SOLVER="ladder", BENCH_PACK=str(kp),
                BENCH_NINIT=str(MAIN["B"]), BENCH_TAIL64=tail))
        if kp == 2:             # K8's time a launch on its path
            k8_main = per_launch(ev_k8, run.res.nfev, run.calls)
        L = run.launches
        print(f"bench BENCH_PACK={kp}: " + buf_out.getvalue().strip())
        print(f"bench BENCH_PACK={kp}: " + buf_err.getvalue().strip())
        print(f"bench BENCH_PACK={kp}: timed f32 ladder {run.wall:.4f} s for "
              f"{MAIN['B']} members, total nfev {run.total_nfev}; launches "
              f"in the {run.calls} ladder calls {L}")
        check(L["pack"] == MAIN["n_beta"] * run.calls and L["rung"] == 0
              and L["ladder"] == 0 and L["ag"] == 0,
              f"bench BENCH_PACK={kp} did not run through K8 alone: {L}")
        check(tuple(run.res.A.shape) == (MAIN["B"], MAIN["n_beta"])
              and bool(torch.isfinite(run.res.A).all())
              and bool(torch.isfinite(run.res.XP).all()),
              f"bench BENCH_PACK={kp}: records")
        if solve_pack.pack_group(kp) == 256:
            ref = paths["fused"][0].res
            same = all(torch.equal(getattr(run.res, k), getattr(ref, k))
                       for k in ("XP", "A", "niter", "nfev", "status"))
            print(f"bench BENCH_PACK={kp} (G=256): f32 ladder bit-identical "
                  f"to phase 9's K2 fused ladder: {same}")
            check(same, f"bench BENCH_PACK={kp}: its f32 ladder differs from "
                  "K2's")
        else:
            fa = float(run.tail.A[0, -1])
            rel25 = abs(fa - JAX_FINAL_A_TAIL64) / JAX_FINAL_A_TAIL64
            print(f"bench BENCH_PACK={kp}: final_A_tail64 member 0 {fa:.6f} "
                  f"vs JAX {JAX_FINAL_A_TAIL64:.6f} (rel {rel25:.3e}, bound "
                  "1e-2)")
            check(rel25 <= 1e-2, f"bench BENCH_PACK={kp}: final_A_tail64 {fa}")
        bench25[kp] = run
    print(f"K8 on its path (BENCH_PACK=2): {k8_main[0]:.4f} ms a launch, "
          f"{k8_main[1]:.3f} us an evaluation (CUDA events around each "
          "launch)")
    phase("25 bench BENCH_PACK", t0)

    # ---- 26. BASELINE config #5 through K1's engine and K2 -----------------
    t0 = time.perf_counter()
    out26 = config5_ladder(dev, tw5, spec5)
    phase("26 config #5", t0)

    # ---- 27. BASELINE config #3: the facade, then the staged workflow -----
    t0 = time.perf_counter()
    out27a = config3_facade(dev, tw3, zero_counts, run_counts)
    phase("27a config #3 facade", t0)
    t0 = time.perf_counter()
    out27b = config3_campaign(dev, zero_counts, run_counts)
    phase("27 config #3", t0)
    print(f"total: {time.perf_counter() - t_all:.2f} s")

    line = dict(route="cuda", library_ms=None)
    src_solve = "varanneal_tpu_torch/kernels/csrc/solve_kernel.cu"
    src_dir = "varanneal_tpu_torch/kernels/csrc/dir_kernel.cu"
    kernels = [
        dict(name="l96_ag_trap",
             source="varanneal_tpu_torch/kernels/csrc/ag_kernel.cu",
             replaces="varanneal_tpu/kernels/ag_pallas.py:279",
             launches=launches, max_abs_err=max_abs, max_rel_err=rel_k1,
             minimizer_err_ratio=ratio_k1, ms=ms_kernel, plain_ms=ms_plain,
             bound_ms=bound_ms, bound_by=bound_by,
             d400_max_rel_err=rel_k1_d400, d400_ms=ms_k1_d400, **line),
        dict(name="l96_solve", source=src_solve,
             replaces="varanneal_tpu/kernels/solve_pallas.py:676",
             launches=paths["fused"][1]["rung"], max_abs_err=err_k2,
             max_rel_err=rel_k2, ms=ms_k2, plain_ms=ms_p2,
             bound_ms=bound_k2[0], bound_by=bound_k2[1],
             main_ms=k2_main[0], us_per_eval=k2_main[1],
             bounded_launches=facade["auto"][1]["k2"],
             bounded_max_abs_err=err_k2b, bounded_max_rel_err=rel_k2b,
             bounded_ms=ms_k2b, bounded_plain_ms=ms_p2b,
             bounded_bound_ms=bound_k2b[0], bounded_bound_by=bound_k2b[1],
             bounded_main_ms=k2b_main[0], bounded_us_per_eval=k2b_main[1],
             layout=layouts[("float32", False)].flags,
             smem_bytes=layouts[("float32", False)].smem_bytes,
             bounded_layout=layouts[("float32", True)].flags,
             bounded_smem_bytes=layouts[("float32", True)].smem_bytes,
             registers={k: [a["regs"], a["local_bytes"]]
                        for k, a in k23_attrs.items() if k[:2] == "K2"},
             barriers_per_iteration=barriers["K2"],
             barriers_per_evaluation=eval_barriers,
             d400_max_rel_err=rel_d400["K2"], d400_short_ms=ms_k2_d400,
             config5=out26,
             short_b264_ms={nm: k2_wide[(264, nm)]
                            for nm in ("planner", "global", "on chip")},
             short_b4_ms={nm: k2_wide[(MAIN["B"], nm)]
                          for nm in ("planner", "global", "on chip")},
             **line),
        dict(name="l96_ladder", source=src_solve,
             replaces="varanneal_tpu/kernels/solve_pallas.py:951",
             launches=paths["ladder"][1]["ladder"], max_abs_err=err_k3,
             max_rel_err=rel_k3, ms=ms_k3, plain_ms=ms_p3,
             bound_ms=bound_k3[0], bound_by=bound_k3[1], main_ms=pk["ms"],
             main_bound_ms=bound_main[0], us_per_eval=k3_us_eval,
             layout=layouts[("float32", False)].flags,
             smem_bytes=layouts[("float32", False)].smem_bytes,
             registers={k: [a["regs"], a["local_bytes"]]
                        for k, a in k23_attrs.items() if k[:2] == "K3"},
             barriers_per_iteration=barriers["K3"],
             d400_max_rel_err=rel_d400["K3"], **line),
        dict(name="compact_dir", source=src_dir,
             replaces="varanneal_tpu/kernels/dir_pallas.py:172",
             launches=facade["generic"][1]["k7a"], max_abs_err=err_k7a,
             max_rel_err=e_k7[0], ms=ms_k7a, device_ms=dev_k7a,
             plain_ms=ms_p7a, bound_ms=bound_k7a[0], bound_by=bound_k7a[1],
             cluster=k7t[n]["plan"][0].size,
             wide_n=N_WIDE, wide_cluster=k7t[N_WIDE]["plan"][0].size,
             wide_ms=k7t[N_WIDE]["k7a"], wide_device_ms=k7t[N_WIDE]["k7a_dev"],
             wide_plain_ms=k7t[N_WIDE]["p7a"],
             wide_bound_ms=k7t[N_WIDE]["b7a"][0],
             registers={f"m{m_}": [a["regs"], a["local_bytes"]]
                        for (m_, st), a in k7_attrs.items() if not st},
             **line),
        dict(name="fused_step", source=src_dir,
             replaces="varanneal_tpu/kernels/dir_pallas.py:184",
             launches=launch_f["k7b"], max_abs_err=err_k7b,
             max_rel_err=e_k7[1], ms=ms_k7b, device_ms=dev_k7b,
             plain_ms=ms_p7b, bound_ms=bound_k7b[0], bound_by=bound_k7b[1],
             cluster=k7t[n]["plan"][1].size,
             loop_device_us_per_iter=pl["auto"]["k7b_us"]
             / pl["auto"]["niter"],
             wide_n=N_WIDE, wide_cluster=k7t[N_WIDE]["plan"][1].size,
             wide_ms=k7t[N_WIDE]["k7b"], wide_device_ms=k7t[N_WIDE]["k7b_dev"],
             wide_plain_ms=k7t[N_WIDE]["p7b"],
             wide_bound_ms=k7t[N_WIDE]["b7b"][0],
             registers={f"m{m_}": [a["regs"], a["local_bytes"]]
                        for (m_, st), a in k7_attrs.items() if st},
             **line),
        dict(name="l96_ag_trap_comp",
             source="varanneal_tpu_torch/kernels/csrc/ag_kernel.cu",
             replaces="varanneal_tpu/kernels/ag_pallas.py:336",
             launches=cnt_r["k4"], max_abs_err=err_k4, max_rel_err=rel_k4,
             ms=ms_k4, device_ms=dev_k4, plain_ms=ms_p4,
             bound_ms=bound_k4[0], bound_by=bound_k4[1],
             d400_max_rel_err=rel_k4_d400, **line)]
    # the Hermite–Simpson kernels' launches: fe_sh_fwd's and fe_sh_vag's
    # on phase 20's facade (the records; every evaluation)
    for kern, rep, also, n in (
            ("onestep_fwd", 138, (156,), bench21["xla"].launches["fe_fwd"]),
            ("onestep_bwd", 187, (), bench21["xla"].launches["fe_bwd"]),
            ("sh_fwd", 238, (472,), cnt20["k6_sh_fwd"]),
            ("sh_vag", 260, (502,), cnt20["k6_sh_vag"])):
        e = dict(
            name=f"fe_{kern}",
            source="varanneal_tpu_torch/kernels/csrc/fe_kernel.cu",
            replaces=f"varanneal_tpu/kernels/fe_pallas.py:{rep}",
            replaces_also=[f"varanneal_tpu/kernels/fe_pallas.py:{r}"
                           for r in also],
            launches=n, max_abs_err=err18[kern], max_rel_err=rel18[kern],
            ms=k6[kern]["ms"], device_ms=k6[kern]["device_ms"],
            plain_ms=k6[kern]["plain_ms"], bound_ms=k6[kern]["bound"][0],
            bound_by=k6[kern]["bound"][1],
            autograd_ms=k6[kern]["autograd_ms"], **line)
        if kern in k6d:         # K6d: B=8, f64, the ensemble's launches
            e.update(batched_launches=cnt_b[f"k6_{kern}"],
                     batched_ms=k6d[kern]["ms"],
                     batched_device_ms=k6d[kern]["device_ms"],
                     batched_plain_ms=k6d[kern]["plain_ms"],
                     batched_bound_ms=k6d[kern]["bound"][0],
                     batched_bound_by=k6d[kern]["bound"][1])
        else:
            # NaKL: the one-step kernels at N_f = 3,001 (phase 18)
            t = k6n["onestep"][kern]
            e.update(nakl_max_abs_err=err18n[kern],
                     nakl_max_rel_err=rel18n[kern], nakl_ms=t["ms"],
                     nakl_device_ms=t["device_ms"],
                     nakl_plain_ms=t["plain_ms"],
                     nakl_bound_ms=t["bound"][0],
                     nakl_bound_by=t["bound"][1])
        kernels.append(e)
    # K6c/K6d on NaKL with the stimulus (config #3): launches of phase
    # 27a's facade (K6c, f64, B=1) and 27b's campaign (K6d), times phase
    # 18's at those shapes (batched_*: the screen's f32 B=64)
    # K6c/K6d on NaKL, the kernels config #3's paths launch: fe_sh_fwd for
    # the records and the fused launch for every evaluation
    for kern, rep, also in (("sh_fwd", 238, (472,)),
                            ("sh_vag", 260, (502,))):
        t, tb, tp = (k6n[k][kern] for k in ("path", "batched", "polish"))
        kernels.append(dict(
            name=f"fe_{kern}_nakl", model="nakl",
            source="varanneal_tpu_torch/kernels/csrc/fe_kernel.cu",
            replaces=f"varanneal_tpu/kernels/fe_pallas.py:{rep}",
            replaces_also=[f"varanneal_tpu/kernels/fe_pallas.py:{a}"
                           for a in also],
            launches=out27a["launches"][f"k6_{kern}"],
            max_abs_err=err18n[kern], max_rel_err=rel18n[kern],
            ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound"][0], bound_by=t["bound"][1],
            batched_launches=out27b["launches"][f"k6_{kern}"],
            batched_ms=tb["ms"], batched_device_ms=tb["device_ms"],
            batched_plain_ms=tb["plain_ms"], batched_bound_ms=tb["bound"][0],
            batched_bound_by=tb["bound"][1],
            polish_ms=tp["ms"], polish_device_ms=tp["device_ms"],
            polish_plain_ms=tp["plain_ms"], polish_bound_ms=tp["bound"][0],
            polish_bound_by=tp["bound"][1],
            launches_by_shape=out27b["launches_by_shape"], **line))
    kernels.append(dict(
        name="l96_agt",
        source="varanneal_tpu_torch/kernels/csrc/agt_kernel.cu",
        replaces="varanneal_tpu/kernels/ag_pallas.py:643",
        replaces_also=["varanneal_tpu/kernels/ag_pallas.py:743"],
        launches=cnt23["k5"], max_abs_err=err_k5, max_rel_err=rel_k5,
        minimizer_err_ratio=ratio_k5, ms=k5["scalar"]["ms"],
        device_ms=k5["scalar"]["device_ms"],
        plain_ms=k5["scalar"]["plain_ms"], bound_ms=k5["scalar"]["bound"][0],
        bound_by=k5["scalar"]["bound"][1], diag_ms=k5["diag"]["ms"],
        diag_device_ms=k5["diag"]["device_ms"],
        diag_bound_ms=k5["diag"]["bound"][0], k1_ms=ms_k1_22,
        autograd_ms=ms_ag_22, **line))
    kernels.append(dict(
        name="l96_pack_solve",
        source="varanneal_tpu_torch/kernels/csrc/pack_kernel.cu",
        replaces="varanneal_tpu/kernels/solve_pack_pallas.py:126",
        replaces_also=["varanneal_tpu/kernels/solve_pack_pallas.py:682"],
        launches=bench25[2].launches["pack"], max_abs_err=err_k8,
        max_rel_err=rel_k8, ms=ms8[2], plain_ms=ms_p8,
        main_ms=k8_main[0], us_per_eval=k8_main[1],
        bound_ms=bound_k8[0], bound_by=bound_k8[1], pack4_ms=ms8[4],
        k2_ms=ms_k2_24, registers={
            f"G{g}_{d}{'_bounded' if bd else ''}_layout{lay}":
            [a["regs"], a["local_bytes"]]
            for (g, d, bd, lay), a in pack_attrs.items()},
        pack_ab={f"{lab} B={b_}": {f"pack{kp}": v[0]
                                   for kp, v in row.items()}
                 for (lab, b_), row in ab24.items()},
        **line))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-k3"]:
        sys.path.insert(0, ROOT)
        sys.exit(profile_k3())
    if sys.argv[1:2] == ["--profile-loops"] and len(sys.argv) == 3:
        sys.path.insert(0, ROOT)
        sys.exit(profile_loops(sys.argv[2]))
    if sys.argv[1:2] == ["--ptxas-diff"] and len(sys.argv) == 3:
        sys.path.insert(0, ROOT)
        sys.exit(ptxas_diff(sys.argv[2]))
    sys.exit(main())
