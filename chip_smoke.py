#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving and training paths at the width of the
repository's flagship online NCDE (C=21 with time in channel 0, H=HH=128,
two trunk layers, static_dim=10, rectilinear, RK4 one step per knot,
return_sequences) with random weights from a seed, the interval-chain
experiments at the same field width, and the flagship under Hermite
controls, and prints one JSON line per phase:

1. env       -- torch, CUDA, nvcc, triton, CUTLASS headers, the card.
2. build     -- builds every kernel from ``online_neural_cdes_tpu_torch/csrc``,
                one ``nvcc`` per source, and the native preprocessing
                library (``csrc/preprocess.cpp``, ``g++``), all started
                together; the backward and interval libraries finish while
                the forward kernel's phase runs (joined before the first
                phase that launches them).
3. kernel    -- the fused field's forward kernel against its plain PyTorch
                version on the card over the sweep and a width above 256
                (its CUDA-core path), identical bits on a repeat call, and
                its time (CUDA events) beside its bounds and the plain
                version's time, with each of its launches' device time at
                the serving and training shapes (at those alone, for the
                run's time).
4. kernel_bwd -- the same for the backward kernel: all six cotangent
                groups over the sweep, identical bits on a repeat call, a
                width its tiles cannot hold refused without a launch, and
                each of its launches' device time at the training shapes.
                Both field kernels also run the sweep in bf16 storage and
                under precision "bfloat16" (each held to one bf16 ulp of
                the plain version in the same mode, and in the rounded
                modes that gate shown to refuse the kernel's "float32"
                instantiation; a row past it is held against the plain
                version with one relu decision of the backward, or one
                bf16 rounding of the forward's activations, taken the
                other way), are timed in bf16, and print a sha256
                digest of their f32 outputs at a fixed seed.
5. kernel_rk4 -- the whole-interval RK4 kernel against its plain version
                over the sweep, its K-replica form (K = 1..4) bit for bit
                against K single launches, a width beyond its limit refused
                without a launch, and its times.
6. predictor -- ``Predictor`` serving 64 ragged, NaN-holding requests: the
                kernels' launch counts for one forward, the outputs against
                the same predictor on the CPU, and request latencies.
   profile   -- one ``predict`` under torch.profiler: device time by kernel
                and the device's busy share of the call.
7. stepper   -- ``OnlineNCDEStepper`` over 64 streams x 99 ticks against
                the predictor's rows, and tick latencies; a stepper keeps
                serving its construction weights, to the bit, after the
                model is updated in place, and serves the new ones once its
                ``params`` are assigned.
8. train     -- ``make_train_step`` (Adam, BCE, lr 5e-4, interval adjoint)
                on a B=512 flagship batch: the kernels' launch counts for
                one step, the card's gradients against the CPU port's on a
                16-row slice, falling losses, step times, the profile of a
                step and the peak device memory.
9. chains    -- the ``pair_probe`` and ``interleave_experiment`` modules'
                chains (per-stage path against the interval kernel; K
                replicas in one launch against one launch each) with their
                launch counts, and the interval kernel chained over the
                flagship batch against ``cdeint``'s per-stage solve.
10. splines  -- every spline coefficient builder on the card against the
                CPU, a Hermite flagship ``Predictor`` and one Hermite
                training step: launch counts, card against CPU, times.
11. toy      -- the Brownian-motion toy under the rectilinear, Hermite and
                natural cubic schemes, trained on the card and on the CPU
                from the same weights and data: the loss curves agree and
                the last-time train accuracy rises.
12. train_bf16 -- one flagship step with ``compute_dtype="bfloat16"``: launch
                counts, the card's bf16 gradients against the CPU's on 16
                rows (on their first 10 observations, each parameter's
                held to half the CPU's own bf16-vs-f32 distance), the
                first loss against the f32 one, 5 more
                steps with a falling loss, step times, the device profile
                and peak memory beside the f32 step's.
13. predict_bf16 -- one ``predict`` of a bf16 flagship model: launch counts,
                and the card's outputs against the CPU's, held to the CPU's
                own bf16-vs-f32 distance.
14. bench_bf16_leg -- the JAX package's bf16 parity leg (bench.py): the
                flagship field in bf16 storage under precision "bfloat16",
                forward and gradient, the card against the CPU.
15. adaptive -- dopri5 with the paper's bounded step: the JAX bench's
                config 3 (Hermite, B=512, L=24, C=9, H=HH=32, adjoint=False,
                MSE) trained a few steps, config 3 with the adjoint taking
                one step through odeint_adjoint's reverse dopri5 solve, and
                the flagship with the adjoint serving one predict (its
                training step was cut for the run's time, PERF.md); gradients
                and outputs against the CPU port, kernel launches against the
                solvers' own evaluation counts, NFE, host reads, times and
                profiles.  The kernel phases also hold and time both field
                kernels at config 3's shape (512, 32, 32, 9, 2).
16. zoo      -- every model string of the JAX harness's registry and every
                vector field: the stacked and attention NCDEs at the
                flagship widths, the JAX bench's config 4 ODE-RNN and GRU-dt,
                GRU-D and the other GRU variants, the flagship with each
                plain field; each serves one request batch and takes Adam
                steps against a CPU copy (outputs, 8-row gradients), with
                its kernel launches, host waits, step times and profile
                (the plain-field flagships on 20 observations of the
                flagship batch's 100, the stacked and attention NCDEs on
                30; the CPU copy serves 8 of the 64
                requests and 1 timed step follows the counted one: cut for
                the run's time).  The kernel phases also hold both field
                kernels at the zoo's (512 | 64, 128, 128, 128, 3).

17. logode   -- the JAX bench's config 6, the log-ODE NCDE at full size: a
                B=256, L=4096, C=4 batch, ``apply_logsig_transform``
                ("logsig-2-8") on the card against the CPU port, to
                (256, 513, 10); H=HH=32, two trunk layers, linear, RK4, the
                interval adjoint, BCE, Adam lr 1e-3: gradients against the
                CPU port on 16 rows, a step's launches (4,096 / 2,048), step
                times, profile and peak memory, then one step of the same
                NCDE on the raw series' first 513 observations (4,096 /
                2,048 launches; cut for the run's time) and the
                trained model's auc, auprc, precision, f1 and accuracy.  The
                kernel phases also hold both field kernels at its
                (256, 32, 32, 10 | 4, 2).
18. solver_extras -- on config 3: each Adams method's forward and training
                step against the CPU (launches equal to its nfe, no host read
                for implicit_adams), ``scipy_solver`` on 8 rows, one
                differentiable ``odeint_event`` whose field is the forward
                kernel, and a bf16 dopri5 ``NeuralCDE`` forward and step
                against the CPU's bf16.
19. data     -- the MIMIC Sepsis task through the data pipeline: a
                synthetic corpus of 4,096 patients in the reduced schema
                (C=21 with time in channel 0, 40% NaN, 7 statics) prepared
                with all five interpolations (the ragged ones through the
                native C++ library, built into build/native by the build
                phase), loaded rectilinear with statics, batched (512 rows)
                and prefetched to the card; the flagship with static_dim=7
                trains one epoch (its launches against the padded lengths),
                bit for bit equal to the same epoch from plain copies; 3
                steps, a checkpoint, 2 more, bit for bit equal to a fresh
                model and Adam resumed from the checkpoint; the corpus's
                stratified split without scikit-learn against its pinned
                digest; card against CPU gradients on 16 rows; one step
                traced, the trace naming the kernels; seconds of each
                stage, step times with and without prefetch, busy share and
                peak memory.  The kernel phases hold both field kernels at
                the epoch's tail batch (130, 128, 128, 21 | 1, 2).
20. harness  -- a configuration suite from the command line: the
                medical-sota suite's ncde leg on the data phase's Sepsis
                corpus (rectilinear, adjoint off, RK4, lr 5e-4, batches of
                1,024, the flagship's widths, seeds 111 and 222, 2 epochs)
                through ``run.main``, its kernel launches against the
                batches' intervals (the suite, each epoch and each
                evaluation), each seed's metrics, times and peak memory,
                each step's time and the traced second epoch's device
                share, all from the suite's own run; a re-run that
                completes and launches nothing; seed 222 again in a spawned
                child on the card, its test metrics equal to the in-process
                run's to the bit; the best weights from the checkpoint
                served to 64 test-split requests through
                ``predictor_from_bundle``, 16 of them against the CPU, and
                one training step's gradients at them on 16 rows against
                the CPU port.  The kernel phases hold
                both field kernels at its (1024, 128, 128, 21 | 1,
                2) and the forward at (467, 128, 128, 21 | 1, 2).
21. raw_data -- the raw-archive builders on synthetic archives at the
                published shapes of the paper's benchmark datasets
                (CharacterTrajectories' .ts files and a timestamped one,
                BeijingPM2pt5's TSER file, SpeechCommands' wavs with short
                clips to drop, a MIMIC-IV BigQuery export), their counts cut
                for the run's time; the MFCCs on the card against the CPU's;
                the export through mimic_raw into the MIMIC task
                preparation; one configuration of the interpolation suite's
                rk4-schemes-benchmarks leg (SpeechCommands, linear) trained
                one epoch from the built root through ``run.main``, its
                launches against its batches' reckoning, and its best
                weights served against the CPU.  The kernel phases hold
                both field kernels at its shapes.
22. wave     -- the same leg's three seeds (111, 222, 333) as one wave of
                K=3 through ``run.main``: its launches only on the field
                kernels' multi entries, as many as one config's serial run
                (each epoch and evaluation too), lanes 111 and 222 against
                the harness phase's serial runs, a wave step's and a serial
                step's host and event ms, busy share and peak memory on the
                first batch; a 4-trial ``trainer__lr`` search as one wave
                of K=4 with no failed trial and its best parameters in the
                ledger; ``run.main --analyse --tables-out`` on both
                ledgers, every table cell mean +- std.  The kernel phases
                end with a ``kernel_multi`` line each: the multi entries at
                K=1 equal to the single entry to the bit, at K=3 and 4 on
                the harness shapes against the plain K versions in f32 and
                bf16 storage, timed beside K single calls.  Then the
                waves over the solvers (item 17c): five K=3 seed waves
                through ``run_trials_vmapped`` for one epoch each on the
                raw_data phase's BeijingPM2pt5 archive (the interval
                adjoint rectilinear and linear, hermite-dopri5 with and
                without the adjoint, an ODE-RNN on dopri5), their launches
                only on the multi entries as the K-lane counts reckon them;
                and one wave gradient step beside its lanes' serial steps
                for the harness leg with the adjoint (496 / 248 multi
                launches), hermite-dopri5 on the first Beijing batch and
                config 3 through ``odeint_adjoint``: launches as reckoned,
                each lane's nfe / accepted / rejected against its serial
                solve's, its gradients on 16 rows at the gradient gate
                (the zoo's relu-row rules; a serial adaptive solve follows
                the lane's steps), wall and busy ms, device reads an
                attempt and masked lane-attempts.  Then the wave's corners
                (item 17d): hermite-dopri5 with ``compute_dtype``
                bfloat16 as one wave (its steps' multi launches in bf16
                storage, lane 0's first search the serial bf16 step's,
                test losses beside the float32 wave's), and K=3 flagship
                fields under ``torch.func.vmap`` on the flagship batch's
                spline with each lane's own output times through the
                differentiable dopri5 ``odeint`` and ``odeint_adjoint``
                (forward and the gradients with respect to the times and
                the weights, each lane against its serial solve) and an
                rk4 ``grid_constructor`` solve.
23. export   -- the exported serving artifact: the flagship predictor's
                grid at length multiple 64 (4 keys: one program a length,
                2, each serving both buckets) exported and loaded with no
                model object, the 64 requests served to the bit of the live
                ``Predictor`` with its 1,016 launches, both timed; the stepper (64 streams,
                a catch-up block of 8) over 12 ticks and a 16-row backlog to
                the bit of the live stepper; ``deploy --verify`` from the
                harness phase's checkpoint, ``--update-params-only`` to its
                other seed's weights (served to the bit of a live
                ``predictor_from_bundle`` at them) and a bfloat16 export
                through the task-metric gate, each with one length bucket;
                and the field op's host dispatch time a call beside its
                ctypes wrapper's.
24. parallel -- (its two ranks start before the wave phase and run their
                checks beside it and the export phase) data parallelism and
                seed ensembles: a world of one rank
                over NCCL whose flagship step with ``mesh=`` equals the step
                without it to the bit; then one spawn of two ranks on the
                card over gloo, each launching the kernels in its own
                process: the flagship step at B=512 (256 rows a rank),
                gradient accumulation, an epoch step, a padded
                cross-entropy tail, prefetched shards, ``Predictor(mesh=)``
                and ``OnlineNCDEStepper(mesh=)``, a (2 ensemble x 1 data)
                seed ensemble and one epoch of ``run --data-parallel 2`` on
                the toy suite, each against rank 0's single-process run,
                each rank's launches against the reckoning; and the flagship's
                exported predictor and stepper loaded over the mesh
                (``load_predictor(path, mesh=)``, ``load_stepper(path,
                mesh=)``) against the same artifacts in one process; and
                the time-pipelined solve over a two-rank ``seq`` mesh
                (``seq_checks``): the flagship at B=512 over 101
                observations, 100 pieces a rank, M=4, through
                ``ncde_apply_pipelined`` against rank 0's forward, one step
                through the pipelined adjoint and one through autograd
                (against rank 0's step), the adjoint's gradients on 8 rows
                against the same pipeline on the CPU in float32 and
                float64, the ranks equal to the bit, each rank's launches
                of both field kernels by I against the reckoning, and the
                peak memory of both steps at two lengths; config 3's
                sharded adaptive and Adams solves (C3) and adjoint steps
                (item 18c: each rank's forward and reverse counts one
                process's).  A rank's failure fails the phase.

Each phase's seconds are printed as it ends.  Then a line with every
kernel's numbers, a line with the run's seconds by phase, a line with the
card's name and power limit as ``nvidia-smi`` gives them,
and, as the last line, ``{"ok": true, "device": {...}}``.  Any failure
raises: the run then exits non-zero without that last line.  It needs a
CUDA card, and it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import atexit
import ctypes
import gc
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from online_neural_cdes_tpu_torch.utils.timing import device_us

# Flagship online NCDE (the repository's MIMIC-scale configuration).
C, H, HH, N_LAYERS, STATIC = 21, 128, 128, 2, 10
N_REQUESTS, MIN_LEN, MAX_LEN = 64, 60, 100
LENGTH_MULTIPLE = 16
# (B, H, HH, I, n_trunk): the serving shapes (I=21 value pieces, I=1 time
# pieces, B=1 and 64 buckets), the flagship training batch's two shapes,
# and odd widths (H = HH = 256 with four layers fills the backward kernel's
# shared memory; the last one's H and HH are not multiples of 8, the
# tensor-core tiles' edge).
SWEEP = [(64, 128, 128, 21, 2), (64, 128, 128, 1, 2), (1, 128, 128, 21, 2),
         (512, 128, 128, 21, 2), (512, 128, 128, 1, 2), (5, 96, 196, 21, 3),
         (33, 256, 64, 21, 4), (9, 256, 256, 3, 4), (17, 42, 37, 5, 1)]
# The training step's dominant shape: the kernels line reports each
# kernel's times here, where most of its counted launches run.
TRAIN_SHAPE = (512, 128, 128, 21, 2)
TIMED = [(64, 128, 128, 21, 2), (64, 128, 128, 1, 2),
         (512, 128, 128, 21, 2), (512, 128, 128, 1, 2)]
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5   # the sums run in another order
# Forward-only: a width above the tensor-core tiles' 256, which takes the
# forward kernel's CUDA-core path for wide models (the backward and the
# interval kernel refuse it).
FWD_WIDE = [(3, 320, 264, 2, 1)]
# The whole-interval RK4 kernel: the forward sweep plus bench.py's parity
# shape (all on the tensor-core route) and widths above 256, where the
# library takes the CUDA-core route (the forward's wide shape; a ragged
# one with I=1, H and HH not multiples of 4); timed at the training step's
# two shapes, the serving batch and a wide training batch; its K-replica
# form at K = 1..4 on the training shape, K = 3 on a ragged shape of each
# route, and timed at K = 2 and 4.
RK4_WIDE = FWD_WIDE + [(7, 290, 263, 1, 2)]
RK4_SWEEP = SWEEP + [(256, 128, 64, 21, 2)] + RK4_WIDE
RK4_TIMED = [(512, 128, 128, 21, 2), (512, 128, 128, 1, 2), (64, 128, 128, 21, 2),
             (512, 320, 264, 21, 2)]
RK4_MULTI = [(TRAIN_SHAPE, (1, 2, 3, 4)), ((5, 96, 196, 21, 3), (3,)),
             ((5, 290, 263, 5, 2), (3,))]
RK4_MULTI_TIMED = (2, 4)
# Backward kernel vs its plain version, each of the six groups: |err| <=
# BWD_RTOL |want| + BWD_ATOL_REL max|want|.  Weight grads sum B rows (and
# dz, ddx sum I*H columns) in another order than cuBLAS; f32 round-off of
# such a sum grows with its largest terms, so the absolute part scales with
# the group's largest magnitude.
BWD_RTOL, BWD_ATOL_REL = 1e-4, 1e-5
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4     # card vs CPU over 222 RK intervals
# Stepper vs predictor on one card: the same kernel arithmetic, but the
# readout sums over H=128 in other orders (a 64x128 product per tick
# against one (64*223)x128 product), and f32 round-off grows over 198 RK
# intervals.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# The interval kernel chained over the flagship batch's 198 intervals
# against cdeint's per-stage solve: the same field arithmetic, the RK
# updates rounded in another order.  Hidden states reach |z| ~ 100, where
# f32's spacing is ~8e-6, and the trunk mixes every hidden unit into every
# other, so a round-off at the largest unit reaches units near zero: per
# tensor |err| <= CHAIN_RTOL |want| + CHAIN_ATOL_REL max|want|.  Two runs
# on the same inputs read 3.8e-6 and 5.3e-6 of max|want|, so the bound
# leaves a margin of about 5 over the larger.
CHAIN_RTOL, CHAIN_ATOL_REL = 1e-4, 3e-5
# Training: B=512 flagship batch, 100 observations -> 199 knots.
# TRAIN_STEPS timed steps follow the counted one (cut from 10 for the run's time).
TRAIN_B, TRAIN_L, TRAIN_LR, TRAIN_STEPS = 512, 100, 5e-4, 5
GRAD_ROWS = 16
# Card vs CPU parameter gradients over 198 RK4 intervals forward and 198
# reverse (adjoint) in f32, summed in other orders on the two devices: per
# tensor, |err| <= GRAD_RTOL |want| + GRAD_ATOL_REL max|want|.
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-3
# Spline coefficients of the padded serving batch, card vs CPU: the same
# f32 formulas, but the natural cubic's tridiagonal solve carries round-off
# through 112 knots, so per tensor |err| <= SPLINE_RTOL |want| +
# SPLINE_ATOL_REL max|want|.
SPLINE_RTOL, SPLINE_ATOL_REL = 1e-4, 1e-5
SMOOTH_EPS = 0.5
# Toy: 4096 paths of 3 points, batches of 1024, 10 epochs (cut from 20 for
# the run's time); card vs CPU loss curves after 40 Adam steps in f32 (Adam
# divides by the root of the second moment, which amplifies round-off where
# gradients are small).
TOY_PATHS, TOY_BATCH, TOY_EPOCHS = 4096, 1024, 5   # 20, then 10, cut for the run's time
TOY_RTOL, TOY_ATOL = 1e-3, 1e-4
TOY_SCHEMES = ("rectilinear", "cubic_hermite", "cubic")
# bf16 operands, each (storage dtype, precision) held against the plain
# version run on the card in the same mode: bf16 storage with products of
# the operands as stored (the compute_dtype="bfloat16" path) or rounded to
# bf16 (the JAX op's precision="bfloat16"), and f32 storage rounded.  The
# first two are timed.
BF16_MODES = ((torch.bfloat16, "float32"), (torch.bfloat16, "bfloat16"),
              (torch.float32, "bfloat16"))
BF16_TIMED = BF16_MODES[:2]
# One bf16 ulp: the card and the plain version sum in other orders, so a
# result near a rounding boundary may land on the neighbouring bf16 value;
# |err| <= 2^-7 |want| + 1e-5 max|want| admits that and nothing larger.
# Under precision "bfloat16" every product's operands are rounded too, and
# an operand that lands on its neighbour moves every sum downstream by an
# ulp of its terms, which cancellation can leave large against the sum: the
# absolute part is then one ulp of the group's largest value, 2^-8
# max|want|.  In f32 storage under "bfloat16" the forward's output is not
# rounded at all: it is an f32 sum of products of rounded operands, and its
# gate is 8x tighter, 2^-10 |want| + 2^-11 max|want|.  In that mode the
# backward's dz and weight grads are cotangents of rounded operands, bf16
# values stored in f32, and must be bf16 values to the bit.  In bf16
# storage, of every group of at least 1,000 elements, 99% are equal to the
# bit; under "bfloat16", where such neighbours reach every sum downstream
# (a weight grad sums 512 rows, most columns hold one), 80% of every group
# of at least 100.  Each rounded mode's gate must refuse the kernel's
# "float32" instantiation (the operands left unrounded) at every sweep
# shape; the tight gate and the 80% lie between that control's readings and
# the kernel's (PERF.md).
BF16_RTOL, BF16_ATOL_REL, BF16_ROUNDED_ATOL_REL = 2.0 ** -7, 1e-5, 2.0 ** -8
BF16_F32_OUT_RTOL, BF16_F32_OUT_ATOL_REL = 2.0 ** -10, 2.0 ** -11
BF16_MIN_EQUAL, BF16_EQUAL_MIN_SIZE = 0.99, 1000
BF16_MIN_EQUAL_ROUNDED, BF16_EQUAL_MIN_SIZE_ROUNDED = 0.80, 100
# A relu input near 0 falls on either side under two summation orders, and
# under "bfloat16" an operand rounded to its neighbour moves it by an ulp of
# its terms; the backward then differs by the whole gradient through that
# unit in that row.  A backward row (dz, ddx) past its gate is held against
# the plain version with one relu decision of that row taken the other way:
# one of its BF16_FLIP_TRIES inputs nearest 0, each within BF16_FLIP_MARGIN
# of its layer's largest in the row, the first that brings the row within
# its gate.  At most BF16_MAX_FLIPS a shape; every group is then gated as
# before against the plain version with those decisions taken, and each is
# printed (``kernel_bwd`` line, ``bf16.relu_flips``).  The forward is
# continuous in a relu input, but not in a bf16 rounding: under
# "bfloat16" an activation within f32 round-off of the midpoint of its two
# bf16 neighbours is rounded to either, and the row's output moves by an
# ulp of that operand's terms, which the f32-storage output's tight gate
# may not admit.  A forward row past its gate is held, by the same rule,
# against the plain version with one such rounding of that row taken to
# the other neighbour: one of the BF16_FLIP_TRIES activations nearest
# their midpoint, within BF16_ROUND_MARGIN of their layer's largest in the
# row (``kernel`` line, ``bf16.rounding_flips``).
BF16_FLIP_MARGIN, BF16_FLIP_TRIES, BF16_MAX_FLIPS = 2.0 ** -8, 8, 4
BF16_ROUND_MARGIN = 2.0 ** -16
BF16_TOLERANCE = {"rtol": BF16_RTOL, "atol_per_max": BF16_ATOL_REL,
                  "atol_per_max_rounded": BF16_ROUNDED_ATOL_REL,
                  "f32_storage_rounded_output": {"rtol": BF16_F32_OUT_RTOL,
                                                 "atol_per_max": BF16_F32_OUT_ATOL_REL},
                  "min_bit_equal": BF16_MIN_EQUAL, "min_size": BF16_EQUAL_MIN_SIZE,
                  "min_bit_equal_rounded": BF16_MIN_EQUAL_ROUNDED,
                  "min_size_rounded": BF16_EQUAL_MIN_SIZE_ROUNDED}
# The training step's two shapes: the bf16 times and the f32 digests.
TRAIN_SHAPES = [(512, 128, 128, 21, 2), (512, 128, 128, 1, 2)]
# bench.py's bf16 parity leg: B=512, H=128, I=21, two trunk layers, bf16
# storage under precision "bfloat16"; max|card - cpu| <= tol max|cpu| + 1e-5.
LEG_B, LEG_H, LEG_I, LEG_TOL = 512, 128, 21, 3e-2
# A bf16 step, card against CPU on GRAD_ROWS rows.  A bf16 rounding that
# the card and the CPU settle the other way (their f32 sums differ in the
# last bits) changes one element by a whole bf16 ulp, and the solve carries
# it on, so a kernel that is right moves single gradient entries by a large
# share of the CPU's own bf16-vs-f32 distance, more the longer the series.
# So the gate is on the first GRAD_BF16_L observations and, for each
# parameter tensor, on ||card - cpu_bf16|| / ||cpu_bf16 - cpu_f32||
# (Frobenius): a kernel that rounds where the plain version does not moves
# every entry of the tensors it reaches and reads near 1.  Beside it, the
# same shares of the CPU's plain version with every product jittered by
# BF16_JITTER (relative; about the f32 round-off that separates the card's
# products from the CPU's) in place of the card: the yardstick the limit
# was set against (PERF.md).
GRAD_BF16_RATIO, GRAD_BF16_L, BF16_JITTER = 0.5, 10, 1e-7
# The first bf16 loss against the f32 one (the JAX package's bound,
# tests/test_cdeint.py).
LOSS_BF16_TOL = 0.06
# A bf16 predict, card against CPU over 222 intervals: at most this share of
# the CPU's own bf16-vs-f32 distance (same weights), for the same reason.
PREDICT_BF16_RATIO = 1.0
# Adaptive solves.  The JAX bench's config 3 (bench.py:368-405, Beijing TSR
# shapes): B=512 series of L=24 hourly observations, C=9 channels with time
# in channel 0, H=HH=32, two trunk layers, Hermite cubic, dopri5 with the
# paper's bounded step (min_step=0.5, atol 1e-5, rtol 1e-3), adjoint=False,
# MSE on one target per series; its field kernels run at CFG3_SHAPE.  Then
# the flagship under dopri5 with the adjoint: one predict and one B=512
# training step.
CFG3_B, CFG3_L, CFG3_C, CFG3_H = 512, 24, 9, 32
# The exported dopri5 flagship serves the 64 requests' first
# EXPORT_ADAPTIVE_L observations (cut for the run's time: the whole requests' loaded
# call took 9-15 s; 62 rectilinear intervals against 222).
EXPORT_ADAPTIVE_L = 32
CFG3_SHAPE = (CFG3_B, CFG3_H, CFG3_H, CFG3_C, 2)
CFG3_STEPS = 1      # timed steps (cut from 5, then 2, for the run's time)
# The model zoo.  Kernels 1-2 at every shape the zoo's NCDEs give them
# (three trunk layers): the stacked NCDE's (HH=128; I=21 for layer 0,
# I = H = 128 for layer 1) and the attention NCDE's (HH=15, the JAX
# model's fixed trunk width; I=21 for the encoder, 128 for the attention
# and final NCDEs), each at the training batch and the serving bucket, in
# the f32 sweep and timed.  The JAX bench's config 4 (bench.py:409-448,
# SpeechCommands shapes): B=1024 series of L=89 observations, C=21
# channels, 10 classes, cross-entropy.  The flagship with each field other
# than original/matmul (plain PyTorch on the card, as the JAX package's
# non-fused branch), fewer timed steps since each step runs ~50,000 small
# launches; the fourth entry marks a model that is chaotic under random
# weights (the low-rank field: the CPU's own f32 and f64 predictions part
# by up to 2.8 late in a series, tenfold every ten observations), held
# only where the CPU's f32 resolves its result against f64: a request's
# rows, and the gradient loss's observations, before the first where that
# distance passes ZOO_RESOLVED of the gate.  The attention model's keep
# mask (weight > 1/L) may differ between the card's 3xTF32 field and the
# CPU's f32 at a weight within ATTN_FLIP_RTOL of 1/L; its rows are left out
# of the comparison and every such weight is printed.  A relu input within
# ~1e-7 of its row's scale of 0 may take the other side on the card and on
# the CPU (products in 3xTF32 against f32, or summed in another order), and
# one such decision moves the gradients it reaches by up to ~1e-2 of their
# max (PERF.md); a row whose input cotangents show it leaves the gradient
# comparison, at most ZOO_MAX_DROPPED of ZOO_GRAD_ROWS rows.
# The JAX bench's config 6 (bench.py:800-856): the log-ODE length-for-width
# trade at full size.  B=256 series of L=4096 steps, C=4 channels (time in
# channel 0), depth-2 log-signatures over 8-step windows -> 513 knots of 10
# channels; H=HH=32, two trunk layers, linear, RK4, the interval adjoint,
# BCE, Adam lr 1e-3.  Its field kernels run at LOGODE_SHAPES (the logsig
# and the raw series).  The transform on the card against the CPU port's:
# the same f32 formulas, the window cumsum over 512 windows summed in
# another order, so |err| <= LOGSIG_RTOL |want| + LOGSIG_ATOL_REL max|want|.
LOGODE_B, LOGODE_L, LOGODE_C, LOGODE_H, LOGODE_DEPTH, LOGODE_WINDOW = 256, 4096, 4, 32, 2, 8
# The raw-series step trains on the first LOGODE_RAW_L observations (all
# 4,096, then 1,025; cut for the run's time).
LOGODE_RAW_L = 513
LOGODE_SHAPES = [(LOGODE_B, LOGODE_H, LOGODE_H, 10, 2),
                 (LOGODE_B, LOGODE_H, LOGODE_H, LOGODE_C, 2)]
LOGODE_LR, LOGODE_STEPS = 1e-3, 1      # timed steps (cut from 5, then 2)
LOGSIG_RTOL, LOGSIG_ATOL_REL = 1e-5, 1e-5
# The rest of the solvers on config 3: scipy on SCIPY_ROWS rows (a host
# solve of a SCIPY_ROWS x 32 state through solve_ivp, one card read per
# right-hand side); the differentiable event's field is the forward kernel
# at config 3's widths with a fixed dX; a bf16 dopri5 config 3 held to the
# CPU's bf16 on the card's step grid, outputs within PREDICT_BF16_RATIO and
# each gradient tensor within GRAD_BF16_RATIO of the CPU's own
# bf16-vs-f32 distance.
SCIPY_ROWS, EVENT_BISECTIONS = 8, 40
# The data phase: the MIMIC task preparation's synthetic corpus (the
# reduced schema: ragged hourly series with time in channel 0 and 40% NaN,
# 7 statics) of DATA_PATIENTS patients, prepared for Sepsis and loaded
# rectilinear with statics; the flagship (C=21, H=HH=128, 2 trunk layers)
# with static_dim=7 trains one epoch of DATA_B-row batches (the train
# split's 2,178 series: four of 512 and a tail of DATA_TAIL_B, whose
# field shapes DATA_SHAPES the kernel phases hold), resumes from a
# checkpoint after DATA_RESUME_AT steps, and splits the corpus on its
# per-series max label to SEPSIS_SPLIT_SHA256 (scikit-learn's indices,
# pinned by tests/test_torch_port_data.py).
DATA_PATIENTS, DATA_FEATURES, DATA_SEED, DATA_STATIC = 4096, 20, 0, 7
DATA_B, DATA_TAIL_B, DATA_PREFETCH, DATA_RESUME_AT = 512, 130, 2, 3
DATA_SHAPES = [(DATA_TAIL_B, H, HH, C, 2), (DATA_TAIL_B, H, HH, 1, 2)]
SEPSIS_SPLIT_SHA256 = "051457a6a3bc89a068cd5a0adcfd190844d9daec5d623052466185fbef8f58eb"
# The harness phase: the medical-sota suite's ncde leg on Sepsis (the
# data phase's corpus), rectilinear, adjoint off (autograd
# through the RK4 solve), lr 5e-4, the default batch of HARNESS_B rows, at
# the flagship's widths, seeds HARNESS_SEEDS, HARNESS_EPOCHS epochs (the
# suite's 1,000 cut for the run's time).  Its batches give kernels 1-2 the
# shapes HARNESS_SHAPES: training at B=1,024 (and the data phase's tail of
# 130), the validation and test splits' 467 rows in the forward alone.
# The kernel phases draw them from a generator of their own, so the other
# shapes' draws do not move.
HARNESS_B, HARNESS_EVAL_B, HARNESS_EPOCHS, HARNESS_SEEDS = 1024, 467, 2, (111, 222)
HARNESS_LR, HARNESS_REQUESTS, HARNESS_CPU_REQUESTS = 5e-4, 64, 16
HARNESS_SHAPES_BWD = [(HARNESS_B, H, HH, C, 2), (HARNESS_B, H, HH, 1, 2)]
HARNESS_SHAPES = HARNESS_SHAPES_BWD + [(HARNESS_EVAL_B, H, HH, C, 2),
                                       (HARNESS_EVAL_B, H, HH, 1, 2)]
HARNESS_SUITE = "sepsis-ncde"
# The K-replica entries of kernels 1-2 (the wave's step and evaluations):
# K = 3 and 4 at the harness's training shapes, and K = 3 at its
# evaluation shapes for the forward, with one dX shared by the replicas at
# stride 0 as the wave's vmap rule passes it; held against the plain K
# versions in f32 and in MULTI_MODE.  K = 1 against the single entry, to
# the bit, at the training shapes and a ragged one (the scalar loads).
MULTI_BWD = [(k, shape) for k in (3, 4) for shape in HARNESS_SHAPES_BWD]
MULTI_FWD = MULTI_BWD + [(3, shape) for shape in HARNESS_SHAPES[2:]]
MULTI_K1 = HARNESS_SHAPES_BWD + [(17, 42, 37, 5, 1)]
MULTI_MODE = (torch.bfloat16, "float32")
MULTI_MAIN = (3, HARNESS_SHAPES_BWD[0])      # the kernels line's timed multi shape
# The bf16 adaptive wave's shape (the wave phase's BF16_WAVE: K=3,
# Beijing's 700 training rows, I=10; its training steps run the multi
# entries in bf16 storage): held against the plain K version in MULTI_MODE
# alone, as the sweep holds its MULTI_MODE shapes, and timed.
MULTI_BF16_TIMED = [(3, (700, H, HH, 10, 2))]
# The wave phase: the harness's suite with medical-sota's three seeds as
# one wave of K=3 (without the checkpoint and profile keys, which a wave
# does not take), HARNESS_EPOCHS epochs; its lanes against the harness
# phase's serial runs within WAVE_RTOL (losses) and WAVE_AUC_ATOL (AUC, a
# rank statistic), the train phase's gradient gate; WAVE_STEPS wave and
# serial steps timed on the first training batch; then a search of
# WAVE_TRIALS trials over trainer__lr as one wave of WAVE_TRIALS lanes,
# one epoch each, and the analysis tables of both ledgers.
WAVE_SEEDS, WAVE_SUITE, WAVE_SEARCH = (111, 222, 333), "sepsis-ncde-wave", "sepsis-ncde-lr"
WAVE_TRIALS, WAVE_STEPS = 4, 1      # timed steps (cut from 5, then 2)
WAVE_RTOL, WAVE_AUC_ATOL = 1e-3, 1e-3
# The raw_data phase: synthetic raw archives at the published shapes of the
# paper's benchmark datasets (dataset.json5), each builder run on them, and
# one configuration of the interpolation suite's rk4-schemes-benchmarks leg
# trained from the built root.  Cut for the run's time: RAW_CT_CASES of
# CharacterTrajectories' 1,422 / 1,436 cases; RAW_TSR_CASES of
# BeijingPM2pt5's training cases; RAW_SC_PER_CLASS clips a class of
# SpeechCommands' ten (~3,800 a class in v0.02), with RAW_SC_SHORT shorter
# clips a class for the builder to drop; RAW_MIMIC_PATIENTS patients of a
# MIMIC-IV export (tens of thousands).  The MFCCs on the card are held
# against the port's CPU result on RAW_MFCC_CLIPS clips: both run in
# float64 and return float32, so |err| <= MFCC_RTOL |want| + MFCC_ATOL.
# The leg's config: SpeechCommands, linear, batches of 512, the flagship's
# widths, one epoch; its kernel shapes RAW_SHAPES (the 700-clip train
# split's batches of 512 and 188, the 150-clip evaluation splits) are held
# in the kernel phases.
RAW_CT_CASES, RAW_TSR_CASES, RAW_TSR_NAME = (200, 200), 1000, "BeijingPM2pt5"
RAW_SC_PER_CLASS, RAW_SC_SHORT, RAW_MFCC_CLIPS, RAW_MIMIC_PATIENTS = 100, 2, 64, 512
RAW_SC_FRAMES, RAW_SC_CHANNELS = 89, 11        # 10 MFCCs and time
MFCC_RTOL, MFCC_ATOL = 1e-6, 1e-6
RAW_SUITE, RAW_SEED, RAW_B = "rk4-schemes-benchmarks-speech", 111, 512
RAW_SHAPES = [(RAW_B, H, HH, RAW_SC_CHANNELS, 2), (188, H, HH, RAW_SC_CHANNELS, 2),
              (150, H, HH, RAW_SC_CHANNELS, 2)]
RAW_REQUESTS, RAW_CPU_REQUESTS = 64, 16
# The parallel phase: two ranks on the card over gloo at the
# flagship's widths.  The training checks use the flagship batch (B=512,
# 100 observations: 256 rows a rank); the cross-entropy check its first
# 511 rows with PAR_CLASSES classes, padded to 512; the served requests
# are the predictor phase's count at PAR_LENGTH observations at most, the
# streams PAR_STREAMS for PAR_TICKS ticks (cut for the run's time); the
# toy suite one epoch of the package's toy dataset.  Gates: the ranks'
# losses, gradients and weights equal each other to the bit (the replicas
# stay in step); a sharded step against the single-process step: the loss
# at PAR_LOSS_RTOL, the gradients at the train phase's card-vs-CPU gate,
# the weights after one update twice (``adam_gate``): against Adam's
# update from the step's own gradients at PAR_PARAM_RTOL / PAR_PARAM_ATOL,
# and against one process's weights at those plus what Adam's first
# update moves across the gradient gate; an epoch's first step is gated
# so, its later losses at GRAD_RTOL, and its final weights and gradients
# are read, not gated; rows forwarded, served or streamed per shard against one
# process at the serving gate, since they are not equal to the bit: the
# forward kernel splits the I channels of its head into cluster groups
# sized from the rows (``head_forward_grid``), so a row's sums run in
# another order at 256 rows than at 512, and the solve carries that
# round-off through its intervals (the phase prints how many forwarded
# rows differ and by how much of their row's largest output); the toy
# suite against its serial run at PAR_RUN_RTOL.
PAR_CLASSES, PAR_STREAMS, PAR_TICKS, PAR_LENGTH = 10, 64, 12, TRAIN_L
PAR_LOSS_RTOL, PAR_PARAM_RTOL, PAR_PARAM_ATOL = 1e-6, 1e-5, 1e-7
# 18c's step-deciding quantities on a rank (its rows and parts of sums,
# reduced over the data axis) against one process's on the whole batch and
# the totals: the same formulas, the sums split by rank (float32 on the
# card: a few ulps).
SUMMED_NORM_RTOL = 1e-5
# The weights after a sharded step: see ``adam_gate`` (Adam's eps is
# ADAM_EPS, ``training.loop.make_optimizer``'s).
ADAM_EPS = 1e-8
PAR_RUN_RTOL, PAR_TIMEOUT_S = 1e-4, 300
# The time-pipelined solve (item 18b) in the parallel phase's spawn: the
# flagship at B=512 over 101 observations (200 rectilinear pieces, 100 a
# rank, in (time, value) pairs), M=4 microbatches of 128 rows; the
# adjoint's gradients on SEQ_ROWS rows at SEQ_ROWS_M microbatches (cut from 4
# for the run's time: half the CPU references' solves), and the
# peak memory of a step at B=64 over two lengths (4x the pieces) at SEQ_AUX_M
# microbatches.
# The pipelined adjoint reverse-integrates the state through a rank's 100
# intervals, which magnifies round-off (the CPU's float32 pipeline lands
# 0.6-1% of a tensor's largest gradient from its float64 one), so its
# gradients are held to the CPU's float64 pipeline at SEQ_ROWS_RATIO times
# the CPU float32's own distance, per tensor, plus GRAD_RTOL of the tensor.
# The peak memory is read on terminal outputs (the JAX test's check).
SEQ_B, SEQ_L, SEQ_M = TRAIN_B, TRAIN_L + 1, 4
SEQ_MEM_B, SEQ_MEM_LENGTHS = 64, (TRAIN_L // 2 + 1, 2 * TRAIN_L + 1)
SEQ_ROWS, SEQ_AUX_M = GRAD_ROWS // 2, 2    # the memory check's microbatches
SEQ_ROWS_M = 2
SEQ_ROWS_RATIO = 4.0
# The field kernels' shapes on the pipeline (a microbatch of the main path,
# of the memory check and of the rows check, at I=21 and I=1), held against
# their plain versions in the kernel phases (head_forward_grid sizes the
# head's channel groups from the rows).
SEQ_SHAPES = [(b, H, HH, i, 2) for b in (SEQ_B // SEQ_M, SEQ_MEM_B // SEQ_AUX_M,
                                         SEQ_ROWS // SEQ_ROWS_M) for i in (C, 1)]
SEQ_MEM_DIRECT_GROWTH, SEQ_MEM_ADJOINT_GROWTH = 2.0, 1.5
PAR_TOY_SUITE = "toy-data-parallel"
# The export phase's stepper: ticks, then a backlog through blocks of K.
EXPORT_TICKS, EXPORT_BACKLOG, EXPORT_BLOCK = 12, 16, 8
EXPORT_REPS, OP_CALLS = 4, 200     # timed predicts: 10 before PR 18
# The exported flagship grid's length multiple: 64 (lengths 64 and 128: 4
# keys, 2 programs) since PR 18, 16 before (lengths 16..112: 14 keys, 7
# programs, ~7 s of torch.export each), cut for the run's time.  A
# request's rows do not depend on how far it is padded (the pad freezes
# the state and the kernels' grids follow the rows), so the served rows
# still equal the predictor phase's to the bit.
EXPORT_LENGTH_MULTIPLE = 64
ZOO_HH_ATTN = 15
ZOO_SHAPES = [(b, H, hh, i, 3) for hh in (HH, ZOO_HH_ATTN) for i in (C, H)
              for b in (TRAIN_B, N_REQUESTS)]
CFG4_B, CFG4_L, CFG4_CLASSES = 1024, 89, 10
# Timed Adam steps after the counted one (cut from 5 and 3 to 2 and 1, then
# to 1 and 1, for the run's time).
ZOO_STEPS, ZOO_FIELD_STEPS = 1, 1
# The requests each zoo model's CPU copy serves, against the card's first
# ones (cut from all 64 to 16, then 8, for the run's time).
ZOO_CPU_REQUESTS = 8
# The six plain-field flagships train on ZOO_FIELD_L observations (the
# flagship batch's 100 cut to 50, then 30, then 20, for the run's time).
ZOO_FIELD_L = 20
# The stacked and attention NCDEs train on the flagship batch's first
# ZOO_NCDE_L observations (its 100, then 50, cut for the run's time).
ZOO_NCDE_L = 30
ZOO_FIELDS = [("gru", "matmul", None, False), ("minimal", "matmul", None, False),
              ("sparse", "matmul", 0.5, False), ("low-rank", "matmul", 0.5, True),
              ("original", "evaluate", None, False), ("original", "derivative", None, False)]
ATTN_FLIP_RTOL = 1e-5
# The rows of the zoo's card-vs-CPU gradients (cut from GRAD_ROWS for the
# run's time: the CPU's backward over 99 intervals dominates the zoo).
ZOO_GRAD_ROWS = GRAD_ROWS // 2
ZOO_RESOLVED, ZOO_MAX_DROPPED = 0.1, ZOO_GRAD_ROWS // 4


# What shares the card with this process while the parallel phase's ranks
# run their checks (handed their spec in ``parallel_start``, joined in
# ``parallel_finish``): every line printed meanwhile says so, as its times
# were taken on a shared card and compare with no time taken alone.
SHARED_CARD = []


def emit(phase: str, **fields):
    if SHARED_CARD:
        fields["card_shared_with"] = SHARED_CARD[-1]
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def peaks(name: str):
    """(f32 CUDA-core FLOP/s, dense TF32 tensor-core FLOP/s, HBM bytes/s,
    dense bf16 tensor-core FLOP/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51e12, 378e12, 2.0e12, 756e12
    return 67e12, 495e12, 3.35e12, 989e12  # SXM


def field_cost(B, Hd, HHd, I, n, elem=4):
    """Operations and the least bytes moved (each input read once, the
    output written once) of one fused-field call, ``elem`` bytes an
    element (4: f32)."""
    weights = Hd * HHd + (n - 1) * HHd * HHd + n * HHd + HHd * I * Hd + I * Hd
    flops = 2 * B * (Hd * HHd + (n - 1) * HHd * HHd + HHd * I * Hd + I * Hd)
    nbytes = elem * (B * Hd + B * I + weights + B * Hd)
    return flops, nbytes


def field_bwd_cost(B, Hd, HHd, I, n, elem=4):
    """Operations (forward recompute, weight grads and input grads of every
    product) and the least bytes (inputs z, dX, g and the weights read
    once; dz, ddX and the weight grads written once) of one backward call,
    ``elem`` bytes an element (4: f32)."""
    weights = Hd * HHd + (n - 1) * HHd * HHd + n * HHd + HHd * I * Hd + I * Hd
    flops = 3 * 2 * B * (Hd * HHd + (n - 1) * HHd * HHd + HHd * I * Hd)
    nbytes = elem * (2 * B * Hd + B * I + weights + B * Hd + B * I + weights)
    return flops, nbytes


def mode_products(kind, B, Hd, HHd, I, n, dtype, precision):
    """(operations, a is bf16, b is bf16) of each product group of one call
    of the forward, backward or interval kernel in a (storage, precision)
    mode (the interval's: f32 products, bf16 storage only), an
    operand being bf16 where the reference holds it in bf16: z, dX and the
    weights in bf16 storage; every product's operands under "bfloat16"
    (in the backward, the cotangents of rounded operands too); the
    activations, dpre and the dX sum's tanh stay f32 otherwise."""
    rnd, stored = precision == "bfloat16", dtype == torch.bfloat16
    w16 = rnd or stored
    first = 2 * B * Hd * HHd                     # layer 1: z W_1
    rest = 2 * B * (n - 1) * HHd * HHd           # later layers: u W_l
    head = 2 * B * HHd * I * Hd                  # u_n W_o
    fwd = [(first, w16, w16), (rest, rnd, w16), (head, rnd, w16)]
    if kind == "interval":   # bf16 storage: only stage 1's z is bf16 among the inputs
        return [(first, stored, stored), (3 * first + 4 * rest, False, stored),
                (4 * head, False, stored), (4 * 2 * B * I * Hd, False, stored)]
    if kind == "forward":
        return fwd + [(2 * B * I * Hd, False, stored)]   # the dX sum
    return fwd + [(head, False, w16),                   # du_n = dpre W_o^T
                  (first + rest, rnd, w16),             # du_{l-1} = dv_l W_l^T
                  (first, w16, False),                  # dW_1 = z^T dpre_1
                  (rest + head, rnd, False)]            # dW_l = u^T dpre_l, dW_o


def mode_bounds(products, nbytes, pk):
    """``bounds`` for a mode: a product of two bf16 operands at the dense
    bf16 tensor-core rate in both; any other on the f32 CUDA cores in
    ``bound_us`` and, in ``bound_tc_us``, in the TF32 passes that its
    operand types need on the tensor cores (three, two with one bf16
    operand); bytes at the HBM rate in both."""
    peak_f32, peak_tf32, peak_bytes, peak_bf16 = pk
    pair = sum(f for f, a, b in products if a and b) / peak_bf16
    rest = [(f, 3 - int(a) - int(b)) for f, a, b in products if not (a and b)]
    t_ops = pair + sum(f for f, _ in rest) / peak_f32
    t_tc = pair + sum(f * p for f, p in rest) / peak_tf32
    t_bytes = nbytes / peak_bytes
    return {"bound_us": max(t_ops, t_bytes) * 1e6,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_tc_us": max(t_tc, t_bytes) * 1e6}


def rk4_cost(B, Hd, HHd, I, n, K=1, elem=4):
    """One RK4 interval: four field evaluations' operations; the bytes of
    one (z, dX and the weights read once, the state written once), ``elem``
    bytes an element; K replicas K times both."""
    flops, nbytes = field_cost(B, Hd, HHd, I, n, elem)
    return K * 4 * flops, K * nbytes


def bound(flops, nbytes, peak_flops, peak_bytes):
    """(bound in us, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return max(t_ops, t_bytes) * 1e6, "operations" if t_ops > t_bytes else "bytes"


def bounds(flops, nbytes, pk):
    """A timed entry's bounds from ``pk = peaks(...)``: ``bound_us`` on the
    f32 CUDA cores and ``bound_tc_us`` on the tensor cores in 3xTF32 (three
    TF32 passes per f32 product), each the larger of operations and bytes."""
    peak_f32, peak_tf32, peak_bytes, _ = pk
    bound_us, bound_by = bound(flops, nbytes, peak_f32, peak_bytes)
    return {"bound_us": bound_us, "bound_by": bound_by,
            "bound_tc_us": bound(flops, nbytes, peak_tf32 / 3, peak_bytes)[0]}


# Each kernel's launch counter, under the key the phases report it by.
COUNTED = (("forward", "fused_field_kernel"), ("backward", "fused_field_bwd_kernel"),
           ("forward_multi", "fused_field_multi_kernel"),
           ("backward_multi", "fused_field_bwd_multi_kernel"),
           ("rk4", "fused_rk4_kernel"), ("rk4_multi", "fused_rk4_multi_kernel"))


def counted(fn):
    """Runs ``fn`` with every kernel's launch count set to 0 just before
    and read just after; returns (fn's result, the counts)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    for _, attr in COUNTED:
        getattr(kernels, attr).launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def launch_counts():
    """Every kernel's launch count (the wrappers' host counters)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    return {key: getattr(kernels, attr).launches for key, attr in COUNTED}


def expect_launches(what, got, **want):
    """Raise unless ``got`` has the counts ``want`` and 0 for every other
    kernel."""
    full = {key: want.get(key, 0) for key, _ in COUNTED}
    if got != full:
        raise AssertionError(f"{what} launched {got}, expected {full}")


def gate_share(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|): the share of its gate a
    comparison uses (below 1 passes)."""
    got, want = (np.asarray(a, dtype=np.float64) for a in (got, want))
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def percentiles(samples_ms):
    a = np.asarray(samples_ms)
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
            "n": int(a.size)}


def random_field(gen, B, Hd, HHd, I, n, device):
    def u(shape, fan_in):
        b = 1.0 / fan_in ** 0.5
        return (torch.rand(shape, generator=gen) * 2 * b - b).to(device)

    trunk, d_in = [], Hd
    for _ in range(n):
        trunk.append({"w": u((d_in, HHd), d_in), "b": u((HHd,), d_in)})
        d_in = HHd
    head_w, head_b = u((HHd, I * Hd), HHd), u((I * Hd,), HHd)
    z = torch.randn((B, Hd), generator=gen).to(device)
    dx = torch.randn((B, I), generator=gen).to(device)
    return trunk, head_w, head_b, z, dx


def per_launch(fn, calls=20):
    """Each kernel's device time per launch over ``calls`` calls of ``fn``
    under torch.profiler, averaged over the launches whose events the
    profiler kept (``per_call``: those launches per call; it may keep fewer
    than all)."""
    top = profile_call(lambda: [fn() for _ in range(calls)])["top"]
    return [{"name": t["name"], "per_call": t["count"] / calls,
             "us_per_launch": t["ms"] * 1e3 / t["count"]} for t in top]


def mode_name(dtype, precision):
    return f"{str(dtype).removeprefix('torch.')}/{precision}"


def cast_field(field, dtype):
    trunk, head_w, head_b, z, dx = field
    return ([{k: v.to(dtype) for k, v in layer.items()} for layer in trunk],
            head_w.to(dtype), head_b.to(dtype), z.to(dtype), dx.to(dtype))


def rounded_group(name):
    """Whether a backward group is the cotangent of a rounded operand under
    precision "bfloat16": dz, dW_o and every trunk dW."""
    return name in ("dz", "dhead_w") or name.endswith(".w")


def bf16_readings(got, want, precision, f32_out=False, exact=False):
    """One result against the plain version in a bf16 mode: the largest
    error, the share of its gate it uses, the share of the elements within
    one ulp of their own value (BF16_ATOL_REL), the share equal to the bit,
    and ``failed``, what of the gate it fails.  The gate: |got - want| <=
    BF16_RTOL |want| + atol max|want| (atol BF16_ATOL_REL, or
    BF16_ROUNDED_ATOL_REL under "bfloat16"; ``f32_out``, the f32-storage
    forward under "bfloat16", BF16_F32_OUT_*); in bf16 storage the share
    equal to the bit (BF16_MIN_EQUAL* of groups of BF16_EQUAL_MIN_SIZE* or
    more); with ``exact``, every value a bf16 value."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
        return {"failed": [f"shape {tuple(got.shape)}, dtype {got.dtype} (want "
                           f"{tuple(want.shape)}, {want.dtype}) or non-finite values"]}
    g, w = got.double(), want.double()
    err, scale = (g - w).abs(), float(w.abs().max())
    rounded = precision == "bfloat16"
    rtol, atol = ((BF16_F32_OUT_RTOL, BF16_F32_OUT_ATOL_REL) if f32_out else
                  (BF16_RTOL, BF16_ROUNDED_ATOL_REL if rounded else BF16_ATOL_REL))
    share = float((err / (atol * scale + rtol * w.abs()).clamp_min(1e-300)).max())
    equal = float((got == want).double().mean())
    floor, size = ((BF16_MIN_EQUAL_ROUNDED, BF16_EQUAL_MIN_SIZE_ROUNDED) if rounded
                   else (BF16_MIN_EQUAL, BF16_EQUAL_MIN_SIZE))
    failed = []
    if not share <= 1.0:
        failed.append(f"max |err| {float(err.max())} is past its gate (share {share})")
    if got.dtype == torch.bfloat16 and got.numel() >= size and not equal >= floor:
        failed.append(f"only {equal} of the elements equal to the bit")
    if exact and not torch.equal(got, got.to(torch.bfloat16).to(got.dtype)):
        failed.append("not bf16 values")
    within = float((err <= BF16_ATOL_REL * scale + BF16_RTOL * w.abs()).double().mean())
    return {"max_abs_err": float(err.max()), "gate_share": share, "one_ulp_share": within,
            "bit_equal_share": equal, "failed": failed}


def ulp_gate(what, got, want, precision, **kw):
    """Raise unless ``got`` passes its bf16 gate (:func:`bf16_readings`);
    returns the readings."""
    readings = bf16_readings(got, want, precision, **kw)
    failed = readings.pop("failed")
    if failed:
        raise AssertionError(f"{what}: {'; '.join(failed)}")
    return readings


def control_summary(mode, shape, readings):
    """A control case: whether the gate refused it, and its readings (the
    largest gate share, the least share equal to the bit, what failed)."""
    failed = [f"{name}: {f}" for name, r in readings.items() for f in r["failed"]]
    return {"mode": mode, "shape": list(shape), "refused": bool(failed),
            "gate_share": max(r.get("gate_share", float("inf")) for r in readings.values()),
            "bit_equal_share": min(r.get("bit_equal_share", 0.0) for r in readings.values()),
            "failed": failed[:3]}


def expect_refused(what, controls):
    """Raise unless the gate refused every control case."""
    passed = [(c["mode"], c["shape"]) for c in controls if not c["refused"]]
    if passed:
        raise AssertionError(f"{what}: the bf16 gate took the kernel's \"float32\" "
                             f"instantiation in a rounded mode at {passed}")


def f32_digests(kind):
    """sha256 of the f32 field kernel's results at TRAIN_SHAPES from a fixed
    seed: ``kind`` "forward" digests the output, "backward" the six
    cotangent groups in order.  It calls only entry points that older trees
    of the port share, so a run against one on the same card shows whether
    the f32 bits moved."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(13)
    digests = {}
    for shape in TRAIN_SHAPES:
        B, Hd, HHd, I, n = shape
        trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
        g = random_cotangent(gen, B, Hd, "cuda")
        if kind == "forward":
            with torch.inference_mode():
                outs = [kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)]
        else:
            outs = [t for _, t in bwd_groups(kernels._backward(trunk, head_w, head_b, z, dx,
                                                                g, Hd, I))]
        h = hashlib.sha256()
        for t in outs:
            h.update(t.contiguous().cpu().numpy().tobytes())
        digests["x".join(map(str, shape))] = h.hexdigest()
    return digests


def phase_env():
    from online_neural_cdes_tpu_torch.utils.cuda_build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60,
                          ).stdout.strip().splitlines()[-1]
    props = torch.cuda.get_device_properties(0)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         triton=importlib.util.find_spec("triton") is not None,
         cutlass_headers=os.path.isdir("/usr/local/cutlass/include"),
         card=card_line(), kind=torch.cuda.get_device_name(0),
         capability=f"{props.major}.{props.minor}", sms=props.multi_processor_count,
         count=torch.cuda.device_count())


# The backward and interval kernels' libraries build longest (68 and 64 s
# against the forward's 43 on the card); the forward kernel's phase runs
# while they build (for the run's time), and they are joined before
# the first phase that launches them.
LATE_SOURCES = ("fused_field_bwd.cu", "fused_rk4_interval.cu")
BUILDS = {}


def phase_build():
    """Start one ``nvcc`` a source and ``g++`` for the native library, all
    together; return when every library but LATE_SOURCES is built (those
    are joined by :func:`join_builds`)."""
    from online_neural_cdes_tpu_torch.utils.cuda_build import CSRC, build_library

    from online_neural_cdes_tpu_torch.data import native

    sources = sorted(p.name for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    done = {}

    def build(name):
        out = build_library(name)
        done[name] = time.perf_counter() - t0
        return out

    pool = ThreadPoolExecutor(max_workers=len(sources) + 1)
    native_lib = pool.submit(native.build)
    futures = {name: pool.submit(build, name) for name in sources}
    for name, future in futures.items():
        if name not in LATE_SOURCES:
            future.result()
    BUILDS.update(pool=pool, futures=futures, done=done, t0=t0, sources=sources,
                  native=native_lib.result().relative_to(native.LIBRARY.parents[2]))


def join_builds():
    """Wait for LATE_SOURCES, then print the build line: every library's
    ``ptxas`` registers and spills, the seconds each took."""
    if not BUILDS:
        return
    libs = {name: future.result() for name, future in BUILDS["futures"].items()}
    BUILDS["pool"].shutdown()
    ptxas, spills = {}, {}
    for name, lib in libs.items():
        lines = lib.with_suffix(".log").read_text().splitlines()
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
        function = None
        for ln in lines:
            if "Function properties for" in ln:
                function = ln.split("Function properties for")[-1].strip()
            elif "spill stores" in ln and not ln.strip().startswith("0 bytes stack frame, 0 "):
                spills.setdefault(name, []).append(f"{function}: {ln.strip()}")
    emit("build", sources=BUILDS["sources"], seconds=time.perf_counter() - BUILDS["t0"],
         seconds_by_source=BUILDS["done"], joined_late=list(LATE_SOURCES), ptxas=ptxas,
         spills=spills, native_library=str(BUILDS["native"]))
    BUILDS.clear()


def forward_grid(B, Hd, HHd, I):
    """The forward kernel's launch geometry at a shape, as its library
    states it (``oncde_fused_field_forward_grid``)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    grid = (ctypes.c_int * 6)()
    fn = kernels.fused_field_kernel.helper(
        "oncde_fused_field_forward_grid", [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
        ctypes.c_int)
    if fn(B, Hd, HHd, I, grid):
        return {"path": "tensor cores", "trunk_blocks": grid[0],
                "head_blocks": grid[1] * grid[2], "cluster": grid[2],
                "head_rows": grid[3], "channels_per_group": grid[4],
                "head_clusters_at_once": grid[5]}
    return {"path": "cuda cores", "blocks": grid[0] * grid[1]}


def phase_kernel(pk):
    """The forward kernel against its plain version over the sweep and the
    wide shape, a repeat call giving the same bits; CUDA-event times at the
    timed shapes beside both bounds and the plain version's time, with each
    of the kernel's launches' device time (profiler, 20 calls)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(1)
    own = torch.Generator().manual_seed(17)   # the harness shapes' draws
    seq = torch.Generator().manual_seed(23)   # the pipeline's
    errors, timings = [], {}
    with torch.inference_mode():
        for shape in (SWEEP + [CFG3_SHAPE] + ZOO_SHAPES + FWD_WIDE + LOGODE_SHAPES
                      + DATA_SHAPES + HARNESS_SHAPES + RAW_SHAPES + SEQ_SHAPES):
            B, Hd, HHd, I, n = shape
            draw = (own if shape in HARNESS_SHAPES + RAW_SHAPES else
                    seq if shape in SEQ_SHAPES else gen)
            trunk, head_w, head_b, z, dx = random_field(draw, *shape, "cuda")
            got = kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)
            again = kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)
            want = kernels._forward_reference(trunk, head_w, head_b, z, dx, Hd, I)
            torch.cuda.synchronize()
            if got.shape != (B, Hd) or not torch.isfinite(got).all():
                raise AssertionError(f"kernel output at {shape}: shape "
                                     f"{tuple(got.shape)} or non-finite values")
            if not torch.equal(got, again):
                raise AssertionError(f"kernel at {shape}: two calls on the same inputs "
                                     "differ")
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                       msg=lambda m: f"kernel at {shape}: {m}")
            err = (got - want).abs()
            errors.append({"shape": list(shape), "max_abs_err": float(err.max()),
                           "gate_share": float((err / (KERNEL_RTOL * want.abs()
                                                       + KERNEL_ATOL)).max()),
                           "path": forward_grid(B, Hd, HHd, I)["path"]})
        # Timed at the serving and training shapes and config 3's; the zoo's,
        # log-ODE, data and harness shapes are held above, not timed (cut
        # for the run's time).
        for shape in TIMED + [CFG3_SHAPE]:
            B, Hd, HHd, I, n = shape
            trunk, head_w, head_b, z, dx = random_field(
                own if shape in HARNESS_SHAPES else gen, *shape, "cuda")
            call = lambda: kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)
            kernel_us = device_us(call, reps=200)
            plain_us = device_us(lambda: kernels._forward_reference(
                trunk, head_w, head_b, z, dx, Hd, I), reps=50)
            timings[shape] = {
                "shape": list(shape), "kernel_us": kernel_us, "plain_us": plain_us,
                **bounds(*field_cost(*shape), pk), **forward_grid(B, Hd, HHd, I)}
            if shape in TIMED:   # each launch's time at the serving and training shapes
                timings[shape]["per_launch"] = per_launch(call)

        # bf16: the sweep and the wide shape in every mode, against the plain
        # version in the same mode, and in the rounded modes the control;
        # times at the training shapes.
        bf16_sweep, bf16_timed, controls, rounding_flips = [], {}, [], []
        for dtype, precision in BF16_MODES:
            mode = mode_name(dtype, precision)
            f32_out = dtype == torch.float32
            for shape in SWEEP + FWD_WIDE:
                B, Hd, HHd, I, n = shape
                field = cast_field(random_field(gen, *shape, "cuda"), dtype)
                args = (*field, Hd, I, precision)
                got = kernels.fused_matmul_field(*args)
                again = kernels.fused_matmul_field(*args)
                want = kernels._forward_reference(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"kernel {mode} at {shape}: two calls on the same "
                                         "inputs differ")
                if bf16_readings(got, want, precision, f32_out=f32_out)["failed"]:
                    flips, located = bf16_rounding_flips(
                        f"kernel {mode} at {shape}", field, Hd, I, precision, got, want,
                        f32_out)
                    want, _ = plain_fwd_rounded(field, Hd, I, precision, flips)
                    rounding_flips += [{"mode": mode, "shape": list(shape), **f}
                                       for f in located]
                bf16_sweep.append({"mode": mode, "shape": list(shape),
                                   **ulp_gate(f"kernel {mode} at {shape}", got, want,
                                              precision, f32_out=f32_out)})
                if precision == "bfloat16":
                    control = kernels.fused_matmul_field(*field, Hd, I, "float32")
                    controls.append(control_summary(mode, shape, {"out": bf16_readings(
                        control, want, precision, f32_out=f32_out)}))
        for dtype, precision in BF16_TIMED:
            mode = mode_name(dtype, precision)
            for shape in TRAIN_SHAPES:
                B, Hd, HHd, I, n = shape
                args = (*cast_field(random_field(gen, *shape, "cuda"), dtype), Hd, I, precision)
                call = lambda: kernels.fused_matmul_field(*args)
                bf16_timed[mode, shape] = {
                    "mode": mode, "shape": list(shape), "kernel_us": device_us(call, reps=200),
                    "plain_us": device_us(lambda: kernels._forward_reference(*args), reps=50),
                    **mode_bounds(mode_products("forward", *shape, dtype, precision),
                                  field_cost(*shape, elem=dtype.itemsize)[1], pk),
                    "per_launch": per_launch(call)}
    emit("kernel", tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
         sweep=errors, repeat="bit-identical", timed=list(timings.values()),
         library="none: no single PyTorch call computes the fused field",
         bf16={"tolerance": BF16_TOLERANCE, "sweep": bf16_sweep, "repeat": "bit-identical",
               "control": controls, "timed": list(bf16_timed.values()),
               "rounding_flips": rounding_flips,
               "flip_rule": {"margin_per_max": BF16_ROUND_MARGIN, "tries": BF16_FLIP_TRIES,
                             "max_per_shape": BF16_MAX_FLIPS}},
         f32_digest=f32_digests("forward"))
    expect_refused("forward kernel", controls)
    multi, multi_timed, multi_err = multi_check("forward", pk)
    emit("kernel_multi", kind="forward", **multi)
    return (max(e["max_abs_err"] for e in errors), timings, bf16_timed,
            (multi_err, multi_timed))


def random_cotangent(gen, B, Hd, device):
    return torch.randn((B, Hd), generator=gen).to(device)


def bwd_groups(out):
    """The backward's six groups (each trunk layer's pair listed apart) as
    (name, tensor) pairs."""
    dtrunk, dhw, dhb, dz, ddx = out
    groups = [("dz", dz), ("ddx", ddx), ("dhead_w", dhw), ("dhead_b", dhb)]
    for l, layer in enumerate(dtrunk):
        groups += [(f"dtrunk[{l}].w", layer["w"]), (f"dtrunk[{l}].b", layer["b"])]
    return groups


def plain_bwd_flipped(field, g, Hd, I, precision, flips):
    """``kernels._backward_reference`` with the relu decisions at ``flips``
    ((layer, row, unit)) taken the other way: (its result, each trunk
    layer's relu inputs).  With no flips it is the plain version to the
    bit (relu(x) and x * (x > 0) round alike)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    trunk, head_w, head_b, z, dx = field
    leaves = [t.detach().requires_grad_()
              for t in (z, dx, head_w, head_b, *kernels._flat_trunk(trunk))]
    z_, dx_, hw_, hb_, *flat = leaves
    pres = []
    with torch.enable_grad():
        u = z_
        for l, layer in enumerate(kernels._unflat_trunk(flat)):
            pre = kernels._mm(u, layer["w"], precision) + layer["b"]
            keep = pre.detach() > 0
            for fl, r, j in flips:
                if fl == l:
                    keep[r, j] = ~keep[r, j]
            pres.append(pre.detach())
            u = pre * keep.to(pre.dtype)
        a = torch.tanh(kernels._mm(u, hw_, precision) + hb_)
        a = a.reshape(a.shape[:-1] + (I, a.shape[-1] // I))
        out = torch.sum(a * dx_[..., :, None], dim=-2)[..., :Hd].to(z.dtype)
        dz, ddx, dhw, dhb, *dflat = torch.autograd.grad(out, leaves, g)
    return (kernels._unflat_trunk(dflat), dhw, dhb, dz, ddx), pres


def bwd_row_shares(got, want, precision):
    """Each batch row's share of the bf16 gate (:func:`bf16_readings`) on
    the per-row groups dz and ddx."""
    atol = BF16_ROUNDED_ATOL_REL if precision == "bfloat16" else BF16_ATOL_REL
    shares = None
    for (name, gt), (_, wt) in zip(bwd_groups(got), bwd_groups(want)):
        if name not in ("dz", "ddx"):
            continue
        g, w = gt.double(), wt.double()
        gate = (atol * float(w.abs().max()) + BF16_RTOL * w.abs()).clamp_min(1e-300)
        s = ((g - w).abs() / gate).amax(dim=1)
        shares = s if shares is None else torch.maximum(shares, s)
    return shares


def locate_flips(what, flipped, groups, row_shares, nearest, got, want, kind):
    """The decisions a kernel took the other way: for each row past its
    gate (``row_shares(got, want)``), the first of its BF16_FLIP_TRIES
    candidates (``nearest(values, row)`` -> [(margin, layer, unit)], each
    within its margin) whose flip in the plain version (``flipped(flips)``
    -> (result, the values the flips act on, by layer)) brings the row
    within its gate.  At most BF16_MAX_FLIPS rows.  Returns (flips, what
    each flip was) or raises naming the row that no candidate explains."""
    plain, values = flipped([])
    for (name, p), (_, w) in zip(groups(plain), groups(want)):
        if not torch.equal(p, w):
            raise AssertionError(f"{what}: the flippable plain version differs from the "
                                 f"plain version in {name}")
    shares = row_shares(got, want)
    rows = [int(r) for r in torch.nonzero(shares > 1.0).flatten()]
    if len(rows) > BF16_MAX_FLIPS:
        raise AssertionError(f"{what}: {len(rows)} rows past their gate (at most "
                             f"{BF16_MAX_FLIPS} {kind}s are located): {rows[:8]}")
    flips, located = [], []
    for r in rows:
        for margin, l, j in sorted(nearest(values, r))[:BF16_FLIP_TRIES]:
            trial, _ = flipped(flips + [(l, r, j)])
            if float(row_shares(got, trial)[r]) <= 1.0:
                flips.append((l, r, j))
                located.append({"row": r, "layer": l, "unit": j, "kind": kind,
                                "value": float(values[l][r, j]),
                                "row_max": float(values[l][r].abs().max()),
                                "row_share_before": float(shares[r])})
                break
        else:
            raise AssertionError(f"{what}: row {r} is past its gate (share "
                                 f"{float(shares[r])}) and no {kind} explains it")
    return flips, located


def nearest_relu(pres, r):
    """Row ``r``'s relu decisions nearest 0, each within BF16_FLIP_MARGIN
    of its layer's largest input in the row."""
    out = []
    for l, pre in enumerate(pres):
        rel = pre[r].double().abs() / float(pre[r].double().abs().max())
        out += [(float(rel[j]), l, int(j)) for j in torch.argsort(rel)[:BF16_FLIP_TRIES]
                if rel[j] <= BF16_FLIP_MARGIN]
    return out


def bf16_relu_flips(what, field, g, Hd, I, precision, got, want):
    """:func:`locate_flips` for the backward over its relu decisions; its
    rows are dz's and ddx's."""
    return locate_flips(
        what, lambda flips: plain_bwd_flipped(field, g, Hd, I, precision, flips),
        bwd_groups, lambda a, b: bwd_row_shares(a, b, precision), nearest_relu, got, want,
        "relu decision")


def bf16_neighbours(x):
    """The two bf16 values around each f32 value of ``x``: (below, above)
    in magnitude order of the bits (equal where ``x`` is a bf16 value)."""
    down = x.to(torch.bfloat16)
    bits = down.view(torch.int16)
    away = down.float().abs() > x.abs()          # rounded away from zero
    other = torch.where(away, bits - 1, bits + 1).view(torch.bfloat16)
    exact = down.float() == x
    return down, torch.where(exact, down, other)


def plain_fwd_rounded(field, Hd, I, precision, flips):
    """``kernels._forward_reference`` with the bf16 roundings at ``flips``
    ((layer, row, unit): the activation that trunk layer ``layer``'s
    product reads, ``layer = len(trunk)`` the head's) taken to the other
    bf16 neighbour: (its result, the f32 activations each product after
    the first reads, by layer; empty unless precision is "bfloat16").
    With no flips it is the plain version to the bit."""
    from online_neural_cdes_tpu_torch.ops import kernels

    trunk, head_w, head_b, z, dx = field
    acts = [None]

    def mm(u, w, l):
        if precision != "bfloat16" or l == 0:
            return kernels._mm(u, w, precision)
        acts.append(u)
        ub, other = bf16_neighbours(u)
        for fl, r, j in flips:
            if fl == l:
                ub[r, j] = other[r, j]
        return ub.float() @ w.to(torch.bfloat16).float()

    u = z
    for l, layer in enumerate(trunk):
        u = torch.relu(mm(u, layer["w"], l) + layer["b"])
    a = torch.tanh(mm(u, head_w, len(trunk)) + head_b)
    a = a.reshape(a.shape[:-1] + (I, a.shape[-1] // I))
    out = torch.sum(a * dx[..., :, None], dim=-2)[..., :Hd].to(z.dtype)
    return out, acts if len(acts) > 1 else []


def nearest_midpoint(acts, r):
    """Row ``r``'s activations nearest the midpoint of their two bf16
    neighbours, each within BF16_ROUND_MARGIN of its layer's largest in
    the row."""
    out = []
    for l, u in enumerate(acts):
        if u is None:
            continue
        x = u[r].double()
        lo, hi = (t.double() for t in bf16_neighbours(u[r].float()))
        rel = (x - (lo + hi) / 2).abs() / float(x.abs().max())
        rel[lo == hi] = float("inf")
        out += [(float(rel[j]), l, int(j)) for j in torch.argsort(rel)[:BF16_FLIP_TRIES]
                if rel[j] <= BF16_ROUND_MARGIN]
    return out


def fwd_row_shares(got, want, precision, f32_out):
    """Each batch row's share of the forward's bf16 gate
    (:func:`bf16_readings`)."""
    rtol, atol = ((BF16_F32_OUT_RTOL, BF16_F32_OUT_ATOL_REL) if f32_out else
                  (BF16_RTOL, BF16_ROUNDED_ATOL_REL if precision == "bfloat16"
                   else BF16_ATOL_REL))
    g, w = got.double(), want.double()
    gate = (atol * float(w.abs().max()) + rtol * w.abs()).clamp_min(1e-300)
    return ((g - w).abs() / gate).amax(dim=1)


def bf16_rounding_flips(what, field, Hd, I, precision, got, want, f32_out):
    """:func:`locate_flips` for the forward over its activations' bf16
    roundings; its rows are the output's."""
    return locate_flips(
        what, lambda flips: plain_fwd_rounded(field, Hd, I, precision, flips),
        lambda out: [("out", out)], lambda a, b: fwd_row_shares(a, b, precision, f32_out),
        nearest_midpoint, got, want, "bf16 rounding")


def phase_kernel_bwd(pk):
    """The backward kernel against its plain version (autograd through the
    plain forward) over the forward's sweep, each group within
    BWD_RTOL |want| + BWD_ATOL_REL max|want|; a repeat call gives the same
    bits; CUDA-event times at the two training shapes, with each of the
    kernel's launches' device time (profiler, 20 calls)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(2)
    own = torch.Generator().manual_seed(19)   # the harness shapes' draws
    seq = torch.Generator().manual_seed(29)   # the pipeline's
    errors, timings = [], {}
    for shape in (SWEEP + [CFG3_SHAPE] + ZOO_SHAPES + LOGODE_SHAPES + DATA_SHAPES
                  + HARNESS_SHAPES_BWD + RAW_SHAPES[:2] + SEQ_SHAPES):
        B, Hd, HHd, I, n = shape
        draw = (own if shape in HARNESS_SHAPES_BWD + RAW_SHAPES else
                seq if shape in SEQ_SHAPES else gen)
        trunk, head_w, head_b, z, dx = random_field(draw, *shape, "cuda")
        g = random_cotangent(draw, B, Hd, "cuda")
        args = (trunk, head_w, head_b, z, dx, g, Hd, I)
        got = kernels._backward(*args)
        again = kernels._backward(*args)
        want = kernels._backward_reference(*args)
        torch.cuda.synchronize()
        worst, share = {}, 0.0
        for (name, gt), (_, ag), (_, wt) in zip(bwd_groups(got), bwd_groups(again),
                                                 bwd_groups(want)):
            if gt.shape != wt.shape or not torch.isfinite(gt).all():
                raise AssertionError(f"backward kernel at {shape}: {name} has shape "
                                     f"{tuple(gt.shape)} or non-finite values")
            if not torch.equal(gt, ag):
                raise AssertionError(f"backward kernel at {shape}: {name} differs "
                                     "between two calls on the same inputs")
            scale = float(wt.abs().max())
            torch.testing.assert_close(gt, wt, rtol=BWD_RTOL,
                                       atol=BWD_ATOL_REL * scale, msg=lambda m: (
                                           f"backward kernel at {shape}, {name}: {m}"))
            worst[name] = float((gt - wt).abs().max())
            share = max(share, gate_share(gt.cpu(), wt.cpu(), BWD_RTOL, BWD_ATOL_REL * scale))
        errors.append({"shape": list(shape), "max_abs_err": worst, "gate_share": share})
    # A width the kernel's tiles cannot hold: the library refuses it, the
    # wrapper raises, and nothing launches.
    trunk, head_w, head_b, z, dx = random_field(gen, 2, 257, 64, 1, 1, "cuda")
    launches = kernels.fused_field_bwd_kernel.launches
    try:
        kernels._backward_kernel(trunk, head_w, head_b, z, dx,
                                 random_cotangent(gen, 2, 257, "cuda"), 257, 1)
    except ValueError as e:
        if "H and HH up to" not in str(e):
            raise
    else:
        raise AssertionError("backward kernel took H=257")
    if kernels.fused_field_bwd_kernel.launches != launches:
        raise AssertionError("backward kernel launched at H=257")
    # Timed at the training shapes and config 3's; the zoo's, log-ODE, data
    # and harness shapes are held above, not timed (cut for the run's time).
    for shape in TRAIN_SHAPES + [CFG3_SHAPE]:
        B, Hd, HHd, I, n = shape
        draw = own if shape in HARNESS_SHAPES_BWD else gen
        trunk, head_w, head_b, z, dx = random_field(draw, *shape, "cuda")
        args = (trunk, head_w, head_b, z, dx, random_cotangent(draw, B, Hd, "cuda"),
                Hd, I)
        kernel_us = device_us(lambda: kernels._backward_kernel(*args), reps=100)
        plain_us = device_us(lambda: kernels._backward_reference(*args), reps=20)
        timings[shape] = {"shape": list(shape), "kernel_us": kernel_us,
                          "plain_us": plain_us, **bounds(*field_bwd_cost(*shape), pk)}
        if shape in TRAIN_SHAPES:   # each launch's time at the training shapes
            timings[shape]["per_launch"] = per_launch(lambda: kernels._backward_kernel(*args))

    # bf16: every group over the sweep in every mode, against autograd
    # through the plain forward in the same mode, and in the rounded modes
    # the control; times at the training shapes.
    bf16_sweep, bf16_timed, controls, relu_flips = [], {}, [], []
    for dtype, precision in BF16_MODES:
        mode = mode_name(dtype, precision)
        exact = precision == "bfloat16" and dtype == torch.float32
        for shape in SWEEP:
            B, Hd, HHd, I, n = shape
            field = cast_field(random_field(gen, *shape, "cuda"), dtype)
            cotangent = random_cotangent(gen, B, Hd, "cuda").to(dtype)
            args = (*field, cotangent, Hd, I, precision)
            got = kernels._backward(*args)
            again = kernels._backward(*args)
            want = kernels._backward_reference(*args)
            torch.cuda.synchronize()
            for (name, gt), (_, ag) in zip(bwd_groups(got), bwd_groups(again)):
                if not torch.equal(gt, ag):
                    raise AssertionError(f"backward kernel {mode} at {shape}: {name} differs "
                                         "between two calls on the same inputs")
            if any(bf16_readings(gt, wt, precision, exact=exact and rounded_group(name))
                   ["failed"] for (name, gt), (_, wt) in zip(bwd_groups(got),
                                                             bwd_groups(want))):
                flips, located = bf16_relu_flips(f"backward kernel {mode} at {shape}",
                                                 field, cotangent, Hd, I, precision,
                                                 got, want)
                want, _ = plain_bwd_flipped(field, cotangent, Hd, I, precision, flips)
                relu_flips += [{"mode": mode, "shape": list(shape), **f} for f in located]
            groups = {}
            for (name, gt), (_, wt) in zip(bwd_groups(got), bwd_groups(want)):
                groups[name] = ulp_gate(f"backward kernel {mode} at {shape}, {name}", gt, wt,
                                        precision, exact=exact and rounded_group(name))
            if precision == "bfloat16":
                control = kernels._backward(*field, cotangent, Hd, I, "float32")
                controls.append(control_summary(mode, shape, {
                    name: bf16_readings(c, w, precision, exact=exact and rounded_group(name))
                    for (name, c), (_, w) in zip(bwd_groups(control), bwd_groups(want))}))
            worst = max(groups, key=lambda k: groups[k]["gate_share"])
            bf16_sweep.append({
                "mode": mode, "shape": list(shape), "worst_group": worst, **groups[worst],
                "one_ulp_share": min(r["one_ulp_share"] for r in groups.values()),
                "bit_equal_share": min(r["bit_equal_share"] for r in groups.values())})
    for dtype, precision in BF16_TIMED:
        mode = mode_name(dtype, precision)
        for shape in TRAIN_SHAPES:
            B, Hd, HHd, I, n = shape
            field = cast_field(random_field(gen, *shape, "cuda"), dtype)
            args = (*field, random_cotangent(gen, B, Hd, "cuda").to(dtype), Hd, I, precision)
            call = lambda: kernels._backward_kernel(*args)
            bf16_timed[mode, shape] = {
                "mode": mode, "shape": list(shape), "kernel_us": device_us(call, reps=100),
                "plain_us": device_us(lambda: kernels._backward_reference(*args), reps=8),
                **mode_bounds(mode_products("backward", *shape, dtype, precision),
                              field_bwd_cost(*shape, elem=dtype.itemsize)[1], pk),
                "per_launch": per_launch(call)}
    emit("kernel_bwd", tolerance={"rtol": BWD_RTOL, "atol_per_max": BWD_ATOL_REL},
         sweep=errors, repeat="bit-identical", timed=list(timings.values()),
         library="none: no single PyTorch call computes the fused field's VJP",
         bf16={"tolerance": BF16_TOLERANCE, "sweep": bf16_sweep, "repeat": "bit-identical",
               "exact_groups_f32_storage": "dz, dhead_w, dtrunk[*].w", "control": controls,
               "relu_flips": relu_flips,
               "flip_rule": {"margin_per_max": BF16_FLIP_MARGIN, "tries": BF16_FLIP_TRIES,
                             "max_per_shape": BF16_MAX_FLIPS},
               "timed": list(bf16_timed.values())},
         f32_digest=f32_digests("backward"))
    expect_refused("backward kernel", controls)
    max_err = max(e for entry in errors for e in entry["max_abs_err"].values())
    multi, multi_timed, multi_err = multi_check("backward", pk)
    emit("kernel_multi", kind="backward", **multi)
    return max_err, timings, bf16_timed, (multi_err, multi_timed)


def stacked_fields(gen, K, shape, device):
    """K random fields of one shape in the K-replica op's stacked layouts,
    and the K single fields."""
    from online_neural_cdes_tpu_torch.experiments.interleave_experiment import (
        stack_fields)

    fields = [random_field(gen, *shape, device) for _ in range(K)]
    weights = stack_fields([{"trunk": f[0], "head_w": f[1], "head_b": f[2]}
                            for f in fields])
    return (*weights, *(torch.stack([f[i] for f in fields]) for i in (3, 4))), fields


def shared_dx_field(gen, K, shape, dtype=torch.float32):
    """K random fields of one shape in the stacked layouts with one dX that
    every replica reads (an ``expand``: replica stride 0), and the K single
    fields, in ``dtype``."""
    stacked, fields = stacked_fields(gen, K, shape, "cuda")
    stacked = cast_field(stacked, dtype)
    dx = stacked[4][0].expand(K, *stacked[4].shape[1:])
    fields = [(*cast_field(f, dtype)[:4], dx[0]) for f in fields]
    return (*stacked[:4], dx), fields


def f32_bwd_row_shares(got, want):
    """Each batch row's share of the f32 backward gate on dz and ddx."""
    shares = None
    for (name, gt), (_, wt) in zip(bwd_groups(got), bwd_groups(want)):
        if name in ("dz", "ddx"):
            g, w = gt.double(), wt.double()
            gate = BWD_ATOL_REL * float(w.abs().max()) + BWD_RTOL * w.abs()
            s = ((g - w).abs() / gate.clamp_min(1e-300)).amax(dim=1)
            shares = s if shares is None else torch.maximum(shares, s)
    return shares


def f32_bwd_against_plain(what, field, g, Hd, I, got):
    """The plain backward of one replica in f32, with the relu decisions
    that the kernel's 3xTF32 sums took the other way (a pre-activation
    within round-off of 0 flips a unit's mask and moves its whole row of
    dz, past any f32 gate) located as in the bf16 sweep: (the plain
    version with those flips, what each flip was)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    want = kernels._backward_reference(*field, g, Hd, I)
    if float(f32_bwd_row_shares(got, want).max()) <= 1.0:
        return want, []
    flips, located = locate_flips(
        what, lambda fl: plain_bwd_flipped(field, g, Hd, I, "float32", fl), bwd_groups,
        f32_bwd_row_shares, nearest_relu, got, want, "relu decision")
    return plain_bwd_flipped(field, g, Hd, I, "float32", flips)[0], located


def multi_check(kind, pk):
    """The K-replica entry of the forward (``kind`` "forward") or backward
    kernel: at K = 1 equal to the single entry to the bit (f32 and
    MULTI_MODE); at K = 3 and 4 against the plain K version in f32 (the
    single entry's gates, replica by replica) and in MULTI_MODE (its bf16
    gate, a row past it held against the plain version with one decision
    taken the other way, as the sweep; the bf16 wave's MULTI_BF16_TIMED
    shape in MULTI_MODE alone), a repeat giving the same bits, one
    count of its own launcher a call and none of the single's; times
    against the plain K version and K single calls, bounds K times one
    call's, and each launch's device time at MULTI_MAIN.  In f32 too a row
    of the backward past its gate is held against the plain version with
    one relu decision taken the other way (``f32_bwd_against_plain``): the
    wave's shapes make four times the decisions of the sweep's."""
    from online_neural_cdes_tpu_torch.ops import kernels

    fwd = kind == "forward"
    gen = torch.Generator().manual_seed(23 if fwd else 29)
    multi = kernels.fused_matmul_field_multi if fwd else kernels.fused_field_backward_multi
    plain_multi = (kernels._forward_reference_multi if fwd
                   else kernels._backward_reference_multi)
    single = kernels._forward if fwd else kernels._backward
    plain = kernels._forward_reference if fwd else kernels._backward_reference
    groups = (lambda out: [("out", out)]) if fwd else bwd_groups
    lane = ((lambda out, r: out[r]) if fwd else lambda out, r: (
        [{"w": l["w"][r], "b": l["b"][r]} for l in out[0]], *(t[r] for t in out[1:])))
    key = "forward_multi" if fwd else "backward_multi"

    def operands(K, shape, dtype):
        stacked, fields = shared_dx_field(gen, K, shape, dtype)
        if fwd:
            return stacked, [(*f, shape[1], shape[3]) for f in fields], (shape[1], shape[3])
        g = torch.randn((K, shape[0], shape[1]), generator=gen).to("cuda", dtype)
        return ((*stacked, g), [(*f, g[r], shape[1], shape[3]) for r, f in enumerate(fields)],
                (shape[1], shape[3]))

    k1 = []
    for dtype, precision in ((torch.float32, "float32"), MULTI_MODE):
        for shape in MULTI_K1:
            stacked, singles, dims = operands(1, shape, dtype)
            got = multi(*stacked, *dims, precision)
            want = single(*singles[0], precision)
            for (name, gt), (_, wt) in zip(groups(lane(got, 0)), groups(want)):
                if not torch.equal(gt, wt):
                    raise AssertionError(f"{kind} multi at K=1, {shape}, "
                                         f"{mode_name(dtype, precision)}: {name} differs "
                                         "from the single entry")
            k1.append({"mode": mode_name(dtype, precision), "shape": list(shape)})
    sweep, timed, flips = [], {}, []
    cases = [(K, shape, mode) for K, shape in (MULTI_FWD if fwd else MULTI_BWD)
             for mode in ((torch.float32, "float32"), MULTI_MODE)]
    cases += [(K, shape, MULTI_MODE) for K, shape in MULTI_BF16_TIMED]
    with torch.no_grad():
        for K, shape, (dtype, precision) in cases:
            mode = mode_name(dtype, precision)
            what = f"{kind} multi K={K} at {shape}, {mode}"
            stacked, singles, dims = operands(K, shape, dtype)
            got, launches = counted(lambda: multi(*stacked, *dims, precision))
            expect_launches(what, launches, **{key: 1})
            again = multi(*stacked, *dims, precision)
            for (name, gt), (_, ag) in zip(groups(got), groups(again)):
                if not torch.equal(gt, ag):
                    raise AssertionError(f"{what}: {name} differs between two calls")
            if dtype == torch.float32:
                want = plain_multi(*stacked, *dims, precision) if fwd else None
                share = err = 0.0
                for r in range(K):
                    got_r = lane(got, r)
                    if fwd:
                        want_r = lane(want, r)
                    else:
                        want_r, located = f32_bwd_against_plain(
                            f"{what}, replica {r}", singles[r][:5], singles[r][5], *dims,
                            got_r)
                        flips += [{"K": K, "shape": list(shape), "mode": mode,
                                   "replica": r, **f} for f in located]
                    for (name, gt), (_, wt) in zip(groups(got_r), groups(want_r)):
                        rtol, atol = ((KERNEL_RTOL, KERNEL_ATOL) if fwd else
                                      (BWD_RTOL, BWD_ATOL_REL * float(wt.abs().max())))
                        torch.testing.assert_close(gt, wt, rtol=rtol, atol=atol,
                                                   msg=lambda m: f"{what}, {name}: {m}")
                        share = max(share, gate_share(gt.cpu(), wt.cpu(), rtol, atol))
                        err = max(err, float((gt - wt).abs().max()))
                sweep.append({"K": K, "shape": list(shape), "mode": mode,
                              "max_abs_err": err, "gate_share": share})
                continue
            worst = 0.0
            for r in range(K):
                got_r, want_r = lane(got, r), plain(*singles[r], precision)
                field = singles[r][:5]
                if any(bf16_readings(gt, wt, precision)["failed"]
                       for (_, gt), (_, wt) in zip(groups(got_r), groups(want_r))):
                    if fwd:
                        fl, located = bf16_rounding_flips(what, field, *dims, precision,
                                                          got_r, want_r, False)
                        want_r, _ = plain_fwd_rounded(field, *dims, precision, fl)
                    else:
                        fl, located = bf16_relu_flips(what, field, singles[r][5], *dims,
                                                      precision, got_r, want_r)
                        want_r, _ = plain_bwd_flipped(field, singles[r][5], *dims,
                                                      precision, fl)
                    flips += [{"K": K, "shape": list(shape), "replica": r, **f}
                              for f in located]
                for (name, gt), (_, wt) in zip(groups(got_r), groups(want_r)):
                    worst = max(worst, ulp_gate(f"{what}, replica {r}, {name}", gt, wt,
                                                precision)["gate_share"])
            sweep.append({"K": K, "shape": list(shape), "mode": mode, "gate_share": worst})
        for K, shape in (MULTI_FWD if fwd else MULTI_BWD):
            stacked, singles, dims = operands(K, shape, torch.float32)
            call = lambda: multi(*stacked, *dims)
            flops, nbytes = (field_cost if fwd else field_bwd_cost)(*shape)
            timed[K, shape] = {
                "K": K, "shape": list(shape),
                "kernel_us": device_us(call, reps=100 if fwd else 50),
                "k_single_us": device_us(lambda: [single(*f) for f in singles], reps=25),
                "plain_us": device_us(lambda: plain_multi(*stacked, *dims), reps=8),
                **bounds(K * flops, K * nbytes, pk)}
            if (K, shape) == MULTI_MAIN:
                timed[K, shape]["per_launch"] = per_launch(call)
        dtype, precision = MULTI_MODE
        for K, shape in MULTI_BF16_TIMED:
            stacked, singles, dims = operands(K, shape, dtype)
            call = lambda: multi(*stacked, *dims, precision)
            nbytes = (field_cost if fwd else field_bwd_cost)(*shape, elem=dtype.itemsize)[1]
            products = mode_products(kind, *shape, dtype, precision)
            timed[K, shape, "bf16"] = {
                "K": K, "shape": list(shape), "mode": mode_name(dtype, precision),
                "kernel_us": device_us(call, reps=100 if fwd else 50),
                "k_single_us": device_us(lambda: [single(*f, precision) for f in singles],
                                         reps=25),
                "plain_us": device_us(lambda: plain_multi(*stacked, *dims, precision), reps=8),
                **mode_bounds([(K * f, a, b) for f, a, b in products], K * nbytes, pk)}
    max_err = max(e["max_abs_err"] for e in sweep if "max_abs_err" in e)
    return {"k1_bit_identical": k1, "sweep": sweep, "mode_flips": flips,
            "timed": list(timed.values())}, timed, max_err


def phase_kernel_rk4(pk):
    """The whole-interval RK4 kernel (both entry points, through the public
    ops) against its plain version over the sweep, in f32 and in bf16
    storage; each shape's route and grid, the library's own choice, with
    shapes on both routes; repeats, rows against a smaller batch and the
    K-replica form bit for bit against single launches; a width beyond the
    library's limit refused with no launch; CUDA-event times in f32 and
    bf16 beside the bounds and the plain version's time, with each launch's
    device time."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(3)
    sweep, sweep_bf16, multi_errors = [], [], []
    timings, multi_timings, bf16_timed = {}, {}, {}
    with torch.inference_mode():
        for shape in RK4_SWEEP:
            B, Hd, HHd, I, n = shape
            field = random_field(gen, *shape, "cuda")
            want = kernels._rk4_interval_reference(*field, Hd, I)
            field16 = cast_field(field, torch.bfloat16)
            want16 = kernels._rk4_interval_reference(*field16, Hd, I)
            row = {"shape": list(shape), "grid": kernels.rk4_grid(B, Hd, HHd, I, n)}
            name = row["grid"]["route"]
            got = kernels.fused_rk4_interval(*field, Hd, I)
            again = kernels.fused_rk4_interval(*field, Hd, I)
            got16 = kernels.fused_rk4_interval(*field16, Hd, I)
            again16 = kernels.fused_rk4_interval(*field16, Hd, I)
            torch.cuda.synchronize()
            if got.shape != (B, Hd) or not torch.isfinite(got).all():
                raise AssertionError(f"RK4 kernel ({name}) at {shape}: shape "
                                     f"{tuple(got.shape)} or non-finite values")
            if not (torch.equal(got, again) and torch.equal(got16, again16)):
                raise AssertionError(f"RK4 kernel ({name}) at {shape}: two calls on "
                                     "the same inputs differ")
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                       msg=lambda m: f"RK4 kernel ({name}) at {shape}: {m}")
            err = (got - want).abs()
            row["max_abs_err"] = float(err.max())
            row["gate_share"] = float((err / (KERNEL_RTOL * want.abs() + KERNEL_ATOL)).max())
            sweep_bf16.append({"shape": list(shape), "route": name, **ulp_gate(
                f"RK4 kernel ({name}) bf16 at {shape}", got16, want16, "float32")})
            if row["grid"]["route"] == "tensor cores" and B > 1:
                # The first rows of a smaller batch: the same bits.
                part = [t for t in field[:3]] + [field[3][:B // 2].contiguous(),
                                                 field[4][:B // 2].contiguous()]
                half = kernels.fused_rk4_interval(*part, Hd, I)
                if not torch.equal(half, got[:B // 2]):
                    raise AssertionError(f"RK4 kernel at {shape}: rows differ between "
                                         f"B={B} and B={B // 2}")
                row["rows_vs_half_batch"] = "bit-identical"
            sweep.append(row)
        routes = {row["grid"]["route"] for row in sweep}
        if routes != {"tensor cores", "cuda cores"}:
            raise AssertionError(f"the RK4 sweep reached the routes {sorted(routes)}, "
                                 "not both")
        for shape, ks in RK4_MULTI:
            B, Hd, HHd, I, n = shape
            for K in ks:
                for dtype in (torch.float32, torch.bfloat16):
                    stacked, fields = stacked_fields(gen, K, shape, "cuda")
                    if dtype == torch.bfloat16:
                        stacked = (*cast_field(stacked[:5], dtype),)
                        fields = [cast_field(f, dtype) for f in fields]
                    got = kernels.fused_rk4_interval_multi(*stacked, Hd, I)
                    singles = torch.stack([kernels.fused_rk4_interval(*f, Hd, I)
                                           for f in fields])
                    want = kernels._rk4_interval_multi_reference(*stacked, Hd, I)
                    torch.cuda.synchronize()
                    if not torch.equal(got, singles):
                        raise AssertionError(
                            f"K-replica RK4 kernel {dtype} at {shape}, K={K}: differs from "
                            f"K single launches by {float((got - singles).abs().max())}")
                    entry = {"shape": list(shape), "K": K, "dtype": str(dtype).removeprefix("torch."),
                             "route": kernels.rk4_grid(B, Hd, HHd, I, n, K)["route"],
                             "vs_single_launches": "bit-identical"}
                    if dtype == torch.float32:
                        torch.testing.assert_close(
                            got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                            msg=lambda m: f"K-replica RK4 kernel at {shape}, K={K}: {m}")
                        entry["max_abs_err"] = float((got - want).abs().max())
                    else:
                        entry.update(ulp_gate(f"K-replica RK4 kernel bf16 at {shape}, K={K}",
                                              got, want, "float32"))
                    multi_errors.append(entry)
        # A width beyond the library's limit: refused, nothing launched.
        wide = kernels.rk4_max_dim() + 1
        stacked, (field,) = stacked_fields(gen, 1, (2, wide, 64, 1, 1), "cuda")
        counts = (kernels.fused_rk4_kernel.launches,
                  kernels.fused_rk4_multi_kernel.launches)
        for op, args in ((kernels.fused_rk4_interval, field),
                         (kernels.fused_rk4_interval_multi, stacked)):
            try:
                op(*args, wide, 1)
            except ValueError as e:
                if "H and HH up to" not in str(e):
                    raise
            else:
                raise AssertionError(f"{op.__name__} took H={wide}")
        if counts != (kernels.fused_rk4_kernel.launches,
                      kernels.fused_rk4_multi_kernel.launches):
            raise AssertionError(f"the RK4 kernel launched at H={wide}")

        for shape in RK4_TIMED:
            B, Hd, HHd, I, n = shape
            field = random_field(gen, *shape, "cuda")
            args = (*field, Hd, I)
            call = lambda: kernels.fused_rk4_interval(*args)
            timings[shape] = {
                "shape": list(shape), "kernel_us": device_us(call, reps=100),
                "plain_us": device_us(lambda: kernels._rk4_interval_reference(*args), reps=5),
                **bounds(*rk4_cost(*shape), pk), **kernels.rk4_grid(B, Hd, HHd, I, n),
                "per_launch": per_launch(call)}
            args16 = (*cast_field(field, torch.bfloat16), Hd, I)
            call16 = lambda: kernels.fused_rk4_interval(*args16)
            bf16_timed[shape] = {
                "mode": "bfloat16/float32", "shape": list(shape),
                "route": timings[shape]["route"], "kernel_us": device_us(call16, reps=100),
                "plain_us": device_us(lambda: kernels._rk4_interval_reference(*args16), reps=5),
                **mode_bounds(mode_products("interval", *shape, torch.bfloat16, "float32"),
                              rk4_cost(*shape, elem=2)[1], pk),
                "per_launch": per_launch(call16)}
        for K in RK4_MULTI_TIMED:
            B, Hd, HHd, I, n = TRAIN_SHAPE
            args = (*stacked_fields(gen, K, TRAIN_SHAPE, "cuda")[0], Hd, I)
            multi_timings[K] = {
                "shape": list(TRAIN_SHAPE), "K": K,
                "kernel_us": device_us(lambda: kernels.fused_rk4_interval_multi(*args),
                                       reps=100),
                "plain_us": device_us(
                    lambda: kernels._rk4_interval_multi_reference(*args), reps=2),
                **bounds(*rk4_cost(*TRAIN_SHAPE, K=K), pk),
                **kernels.rk4_grid(B, Hd, HHd, I, n, K)}
    emit("kernel_rk4", tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
         sweep=sweep, repeat="bit-identical", multi=multi_errors, refused_width=wide,
         bf16={"tolerance": BF16_TOLERANCE, "sweep": sweep_bf16,
               "timed": list(bf16_timed.values())},
         timed=list(timings.values()), timed_multi=list(multi_timings.values()),
         library="none: no single PyTorch call computes an RK4 interval of the "
                 "fused field")
    max_err = max(row["max_abs_err"] for row in sweep)
    max_err_multi = max(e["max_abs_err"] for e in multi_errors if e["dtype"] == "float32")
    return max_err, max_err_multi, timings, multi_timings, bf16_timed


def flagship_model(device, interpolation="rectilinear", dtype=torch.float32,
                   solver="rk4", seed=0, **kw):
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(
        input_dim=C, hidden_dim=H, output_dim=1, static_dim=STATIC,
        hidden_hidden_dim=HH, num_layers=N_LAYERS, interpolation=interpolation,
        solver=solver, return_sequences=True,
        generator=torch.Generator().manual_seed(seed), device=device, dtype=dtype, **kw,
    )


def make_requests(seed=5):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(MIN_LEN, MAX_LEN + 1, size=N_REQUESTS)
    lengths[0] = MAX_LEN  # pads to 112: 223 knots, 222 intervals
    requests = []
    for length in lengths:
        s = rng.normal(size=(length, C)).astype(np.float32)
        s[:, 0] = np.arange(length)
        holes = rng.random(size=s.shape) < 0.3
        holes[0] = False         # a first row with NaNs is zeroed by the
        holes[:, 0] = False      # stepper but back-filled offline
        s[holes] = np.nan
        requests.append(s)
    static = rng.normal(size=(N_REQUESTS, STATIC)).astype(np.float32)
    return requests, static


def phase_predictor():
    from online_neural_cdes_tpu_torch import Predictor

    coeff_fn = rectilinear_coeffs
    model = flagship_model("cuda")
    pred = Predictor(model, coeff_fn=coeff_fn, batch_buckets=(1, 64),
                     length_multiple=LENGTH_MULTIPLE, device="cuda")
    warmed = pred.precompile(channels=C, max_length=MAX_LEN, static_dim=STATIC)
    requests, static = make_requests()
    padded_len = -(-MAX_LEN // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
    intervals = 2 * padded_len - 2
    expected = intervals * 4  # RK4: four field evaluations per interval

    outs, launches = counted(lambda: pred.predict(requests, static=static))  # serving
    expect_launches("one predict", launches, forward=expected)

    model_cpu = flagship_model("cpu")
    model_cpu.load_state_dict(model.state_dict())
    pred_cpu = Predictor(model_cpu, coeff_fn=coeff_fn, batch_buckets=(1, 64),
                         length_multiple=LENGTH_MULTIPLE, device="cpu")
    outs_cpu = pred_cpu.predict(requests, static=static)
    err = share = 0.0
    for r, g, c in zip(requests, outs, outs_cpu):
        if g.shape != (len(r), 1) or not np.isfinite(g).all():
            raise AssertionError(f"predictor output shape {g.shape} or non-finite")
        np.testing.assert_allclose(g, c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        err = max(err, float(np.abs(g - c).max()))
        share = max(share, gate_share(g, c, SERVE_RTOL, SERVE_ATOL))

    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        pred.predict(requests, static=static)
        lat.append((time.perf_counter() - t0) * 1e3)
    n_batches = 8
    t0 = time.perf_counter()
    many = pred.predict_many([requests] * n_batches, statics=[static] * n_batches)
    many_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    for got, want in zip(many[-1], outs):
        np.testing.assert_allclose(got, want, rtol=STEP_RTOL, atol=STEP_ATOL)
    emit("predictor", warmed_shapes=warmed, padded_length=padded_len,
         intervals=intervals, kernel_launches=launches["forward"],
         backward_launches=launches["backward"], expected_launches=expected,
         vs_cpu={"max_abs_err": err, "gate_share": share, "rtol": SERVE_RTOL,
                 "atol": SERVE_ATOL},
         predict_ms=percentiles(lat), predict_many_ms_per_batch=many_ms)
    emit("profile", **profile_call(lambda: pred.predict(requests, static=static)))
    return model, requests, static, outs, launches


def profile_call(fn, host=True):
    """One call of ``fn`` (ending in a synchronize) under torch.profiler:
    device time by kernel name and the device's busy share of the call's
    wall time, from the profiler's raw events, and the host's kernel
    launches and memory copies (``cudaMemcpy*`` calls) and the CPU
    seconds the process spent in the call (every thread); with ``host``, the host ops by self time too (their tracing
    and ``key_averages`` take about a minute a million events, so the
    adaptive flagship's calls leave them out)."""
    import resource

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = time.perf_counter()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        r1 = resource.getrusage(resource.RUSAGE_SELF)
    by_name, launches, copies = {}, 0, 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            entry = by_name.setdefault(evt.name()[:60], [0, 0.0])
            entry[0] += 1
            entry[1] += evt.duration_ns() / 1e6
        elif evt.name().startswith("cudaLaunchKernel"):
            launches += 1
        elif evt.name().startswith("cudaMemcpy"):
            copies += 1
    device_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    out = {"wall_ms": wall_ms,
           "host_cpu_s": r1.ru_utime - r0.ru_utime + r1.ru_stime - r0.ru_stime,
           "device_busy_ms": device_ms if by_name else "not measured",
           "device_busy_share": device_ms / wall_ms if by_name else "not measured",
           "device_events": sum(n for n, _ in by_name.values()),
           "top": [{"name": k, "count": n, "ms": ms} for k, (n, ms) in top],
           "host_kernel_launches": launches, "host_copies": copies}
    if host:
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
        out["host_top"] = [{"name": e.key[:60], "count": e.count,
                            "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in ops]
    out["seconds"] = time.perf_counter() - start
    return out


def phase_stepper(model, requests, static, outs):
    from online_neural_cdes_tpu_torch import OnlineNCDEStepper
    from online_neural_cdes_tpu_torch.data.loader import pad_ragged
    from online_neural_cdes_tpu_torch.ops.kernels import fused_field_kernel

    # Each stream's tail repeats its last row: dX = 0, the state holds.
    x = pad_ragged(requests, target_len=MAX_LEN)          # (64, 100, C)
    stepper = OnlineNCDEStepper(model, static=static, device="cuda")
    stepper.precompile(N_REQUESTS, block_sizes=(MAX_LEN - 1,))
    torch.cuda.synchronize()

    fused_field_kernel.launches = 0
    state = stepper.init(x[:, 0])
    rows, ticks = [stepper.readout(state["z"])], []
    for k in range(1, MAX_LEN):
        t0 = time.perf_counter()
        state, y = stepper.step(state, x[:, k])
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)
        rows.append(y)
    launches = fused_field_kernel.launches
    if launches != 8 * (MAX_LEN - 1):
        raise AssertionError(f"stepper launched {launches} kernels, expected "
                             f"{8 * (MAX_LEN - 1)}")
    rows = torch.stack(rows, dim=1).cpu().numpy()          # (64, 100, 1)
    err = share = 0.0
    for i, (r, o) in enumerate(zip(requests, outs)):
        np.testing.assert_allclose(rows[i, :len(r)], o, rtol=STEP_RTOL, atol=STEP_ATOL)
        err = max(err, float(np.abs(rows[i, :len(r)] - o).max()))
        share = max(share, gate_share(rows[i, :len(r)], o, STEP_RTOL, STEP_ATOL))

    block = np.ascontiguousarray(np.swapaxes(x[:, 1:65], 0, 1))  # (64, B, C)
    start = stepper.init(x[:, 0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ys = stepper.step_many(start, block)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    s = start
    for k in range(block.shape[0]):
        s, _ = stepper.step(s, block[k])
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    np.testing.assert_allclose(ys.cpu().numpy().swapaxes(0, 1), rows[:, 1:65],
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    emit("stepper", streams=N_REQUESTS, ticks=MAX_LEN - 1, kernel_launches=launches,
         vs_predictor={"max_abs_err": err, "gate_share": share, "rtol": STEP_RTOL,
                       "atol": STEP_ATOL},
         tick_ms=percentiles(ticks), step_many_64_ms=many_ms,
         sequential_64_steps_ms=seq_ms, snapshot=stepper_snapshot(model, static, x))


def stepper_snapshot(model, static, x, ticks=4):
    """A stepper serves the weights it was built with (ROADMAP C1): built on
    a copy of the model that is then updated in place (0.05 N(0, 1) on
    every parameter, as an optimizer step), its rows equal to the bit those
    of a stepper built on a deep copy taken before the update; once its
    ``params`` are assigned the model's new state, those of a stepper built
    after the update."""
    import copy

    from online_neural_cdes_tpu_torch import OnlineNCDEStepper

    def rows(stepper):
        state, out = stepper.init(x[:, 0]), []
        for k in range(1, ticks + 1):
            state, y = stepper.step(state, x[:, k])
            out.append(y)
        return torch.stack(out)

    live = copy.deepcopy(model)
    held = OnlineNCDEStepper(live, static=static, device="cuda")
    before = OnlineNCDEStepper(copy.deepcopy(live), static=static, device="cuda")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in live.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))
    kept = rows(held)
    if not torch.equal(kept, rows(before)):
        raise AssertionError("stepper: an in-place model update reached a running stepper")
    after = rows(OnlineNCDEStepper(live, static=static, device="cuda"))
    held.params = live.state_dict()
    if not torch.equal(rows(held), after):
        raise AssertionError("stepper: the assigned params are not the ones served")
    return {"ticks": ticks, "after_in_place_update": "bit-identical to the construction copy",
            "after_params_assignment": "bit-identical to a fresh stepper",
            "update_moved_rows_by": float((after - kept).abs().max())}


def rectilinear_coeffs(x):
    from online_neural_cdes_tpu_torch import linear_interpolation_coeffs

    return linear_interpolation_coeffs(x, rectilinear=0)


def train_batch(device, seed=7, coeff_fn=rectilinear_coeffs, length=TRAIN_L):
    """The flagship training batch (as ``bench.py``'s flagship step makes
    it): B=512 series of ``length`` (100) observations, time in channel 0,
    static features, random 0/1 labels per observation; ``coeff_fn`` makes
    the model's coefficients (rectilinear by default)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(TRAIN_B, length, C)).astype(np.float32)
    x[:, :, 0] = np.arange(length)
    static = rng.normal(size=(TRAIN_B, STATIC)).astype(np.float32)
    labels = rng.integers(0, 2, size=(TRAIN_B, length)).astype(np.float32)
    coeffs = coeff_fn(torch.from_numpy(x).to(device))
    return ((torch.from_numpy(static).to(device), coeffs),
            torch.from_numpy(labels).to(device))


def slice_grads(model, inputs, labels, rows, compute_dtype=None):
    """Parameter gradients of the masked BCE on the first ``rows`` rows;
    with ``compute_dtype`` the forward and backward run on the parameters
    and inputs cast to it, as ``make_train_step(compute_dtype=...)`` runs
    them."""
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model.zero_grad(set_to_none=True)
    static, coeffs = inputs
    batch = (static[:rows], coeffs[:rows])
    if compute_dtype is None:
        preds = model(batch)
    else:
        params = {name: p.to(compute_dtype) for name, p in model.named_parameters()}
        preds = torch.func.functional_call(
            model, params, (tuple(t.to(compute_dtype) for t in batch),)).float()
    masked_temporal_loss(make_loss("bce"), preds, labels[:rows]).backward()
    return {name: p.grad.detach().clone() for name, p in model.named_parameters()}


def grad_gate(what, got, want):
    """Card against CPU parameter gradients, each tensor within GRAD_RTOL
    |want| + GRAD_ATOL_REL max|want|; returns the worst error per max and
    gate share."""
    grad_err, grad_share = {}, 0.0
    for name, w in want.items():
        g = got[name].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}card gradient of {name} is not finite")
        atol = GRAD_ATOL_REL * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=atol,
                                   msg=lambda m: f"{what}gradient of {name}: {m}")
        grad_err[name] = float((g - w).abs().max() / w.abs().max())
        grad_share = max(grad_share, gate_share(g, w, GRAD_RTOL, atol))
    return {"max_err_per_max": max(grad_err.values()), "gate_share": grad_share,
            "rtol": GRAD_RTOL, "atol_per_max": GRAD_ATOL_REL}


def phase_train():
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    model = flagship_model("cuda")
    inputs, labels = train_batch("cuda")
    intervals = 2 * TRAIN_L - 2
    expected = {"forward": 2 * 4 * intervals, "backward": 4 * intervals}

    # Step-0 gradients: the card against the CPU port on a 16-row slice.
    model_cpu = flagship_model("cpu")
    model_cpu.load_state_dict(model.state_dict())
    got = slice_grads(model, inputs, labels, GRAD_ROWS)
    want = slice_grads(model_cpu, tuple(t.cpu() for t in inputs), labels.cpu(),
                       GRAD_ROWS)
    grads_vs_cpu = grad_gate("", got, want)

    step = make_train_step(model, loss="bce", lr=TRAIN_LR)
    loss, launches = counted(lambda: step(inputs, labels, 1.0))   # the main path
    expect_launches("one training step", launches, **expected)
    losses = [loss]

    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(inputs, labels, 1.0))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    losses = torch.stack(losses).cpu().numpy()
    # Random labels on a fixed batch: the loss falls, though not step by
    # step (the readout's learning rate is 10x), so the gate compares the
    # mean of the last three losses with the first.
    if not np.isfinite(losses).all() or not losses[-3:].mean() < losses[0]:
        raise AssertionError(f"training losses not finite and falling: {losses}")
    # Device time only: the host ops' table took ~11 s (cut for the run's time).
    profile = profile_call(lambda: step(inputs, labels, 1.0), host=False)
    emit("train", batch=TRAIN_B, knots=2 * TRAIN_L - 1, intervals=intervals,
         kernel_launches=launches, expected_launches=expected,
         grads_vs_cpu={"rows": GRAD_ROWS, **grads_vs_cpu},
         losses=[float(v) for v in losses], train_step_ms=percentiles(step_ms),
         peak_memory_mb=peak_mb, profile=profile)
    return launches, step_summary(step_ms, peak_mb, profile)


def step_summary(step_ms, peak_mb, profile):
    """A training step's numbers that the bf16 step reports beside its own."""
    return {"train_step_ms": percentiles(step_ms), "peak_memory_mb": peak_mb,
            "device_busy_ms": profile["device_busy_ms"],
            "device_by_kernel": profile["top"]}


@contextmanager
def jittered_products(rel, seed=0):
    """Every plain product of the fused field (``kernels._mm``, CPU tensors)
    scaled by (1 + rel N(0, 1)) while the context is open."""
    from online_neural_cdes_tpu_torch.ops import kernels

    mm, gen = kernels._mm, torch.Generator().manual_seed(seed)

    def jittered(a, b, precision):
        out = mm(a, b, precision)
        return out * (1 + rel * torch.randn(out.shape, generator=gen, dtype=out.dtype))

    kernels._mm = jittered
    try:
        yield
    finally:
        kernels._mm = mm


def ratio(num, den):
    """num / den, with 0 / 0 read as 0 (a parameter whose gradient bf16
    leaves exactly as it is)."""
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def bf16_grad_ratios(model, model_cpu, inputs, labels, length):
    """On GRAD_ROWS rows and the first ``length`` observations, per
    parameter: ||card_bf16 - cpu_bf16|| / ||cpu_bf16 - cpu_f32||
    (Frobenius), the largest of them and their median over the parameters;
    and the same for the CPU in bf16 with its products jittered by
    BF16_JITTER in place of the card ("jitter")."""
    bf16 = torch.bfloat16
    static, coeffs = inputs
    inputs = (static, coeffs[:, :2 * length - 1].contiguous())
    labels = labels[:, :length]
    cpu_inputs, cpu_labels = tuple(t.cpu() for t in inputs), labels.cpu()
    got = slice_grads(model, inputs, labels, GRAD_ROWS, bf16)
    want = slice_grads(model_cpu, cpu_inputs, cpu_labels, GRAD_ROWS, bf16)
    f32 = slice_grads(model_cpu, cpu_inputs, cpu_labels, GRAD_ROWS)
    with jittered_products(BF16_JITTER):
        jitter = slice_grads(model_cpu, cpu_inputs, cpu_labels, GRAD_ROWS, bf16)
    for name, g in got.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"card bf16 gradient of {name} is not finite")

    def shares(grads):
        norm = {n: ratio(float((grads[n].cpu() - w).norm()), float((w - f32[n]).norm()))
                for n, w in want.items()}
        return {"max": max(norm.values()), "median": float(np.median(list(norm.values()))),
                "by_parameter": norm}

    return {"observations": length, "card": shares(got), "jitter": shares(jitter)}


def phase_train_bf16(f32_step=None):
    """One flagship step with ``compute_dtype="bfloat16"`` (the master
    weights and Adam stay f32): its launches; the card's bf16 gradients on
    16 rows against the CPU's, each parameter's within GRAD_BF16_RATIO of
    the CPU's own bf16-vs-f32 distance over the first GRAD_BF16_L
    observations; the first loss within LOSS_BF16_TOL of the f32 one; 10
    more steps with a falling loss; times, profile and peak memory beside
    ``f32_step`` (the f32 step's, when the train phase ran)."""
    from online_neural_cdes_tpu_torch.training.loop import make_train_step
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    bf16 = torch.bfloat16
    model = flagship_model("cuda")
    inputs, labels = train_batch("cuda")
    intervals = 2 * TRAIN_L - 2
    expected = {"forward": 2 * 4 * intervals, "backward": 4 * intervals}

    model_cpu = flagship_model("cpu")
    model_cpu.load_state_dict(model.state_dict())
    grads = bf16_grad_ratios(model, model_cpu, inputs, labels, GRAD_BF16_L)
    if not grads["card"]["max"] <= GRAD_BF16_RATIO:
        raise AssertionError(
            f"bf16 gradients on {GRAD_BF16_L} observations: a parameter's is "
            f"{grads['card']['max']} of the CPU's bf16-vs-f32 distance from the CPU's "
            f"(limit {GRAD_BF16_RATIO}): {grads}")
    with torch.no_grad():
        loss_f32 = float(masked_temporal_loss(make_loss("bce"), model(inputs), labels))

    step = make_train_step(model, loss="bce", lr=TRAIN_LR, compute_dtype="bfloat16")
    loss, launches = counted(lambda: step(inputs, labels, 1.0))   # the bf16 main path
    expect_launches("one bf16 training step", launches, **expected)
    if not abs(float(loss) - loss_f32) <= LOSS_BF16_TOL:
        raise AssertionError(f"first bf16 loss {float(loss)} vs f32 {loss_f32}")
    losses = [loss]
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(inputs, labels, 1.0))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all() or not losses[-3:].mean() < losses[0]:
        raise AssertionError(f"bf16 training losses not finite and falling: {losses}")
    # Device time only: the host ops' table took ~30 s (cut for the run's time).
    profile = profile_call(lambda: step(inputs, labels, 1.0), host=False)
    emit("train_bf16", batch=TRAIN_B, intervals=intervals, compute_dtype="bfloat16",
         kernel_launches=launches, expected_launches=expected,
         grads_vs_cpu={"rows": GRAD_ROWS, "gate": "max", "ratio_limit": GRAD_BF16_RATIO,
                       "jitter": BF16_JITTER, **grads},
         first_loss={"bf16": float(losses[0]), "f32": loss_f32, "limit": LOSS_BF16_TOL},
         losses=[float(v) for v in losses], train_step_ms=percentiles(step_ms),
         peak_memory_mb=peak_mb, profile=profile, f32_step=f32_step)
    return launches


def phase_bench_bf16_leg():
    """The JAX package's bf16 parity leg (bench.py): the flagship field
    (B=512, H=128, I=21, two trunk layers) in bf16 storage under precision
    "bfloat16", forward and the gradient of sum(out.float()**2) with
    respect to the packed weights and z, the card against the CPU, each
    within max|card - cpu| <= LEG_TOL max|cpu| + 1e-5."""
    from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
    from online_neural_cdes_tpu_torch.ops import kernels

    bf16 = torch.bfloat16

    def leg(device):
        field = VectorField(LEG_I, LEG_H, LEG_H, 2, generator=torch.Generator().manual_seed(3),
                            dtype=bf16, device=device)
        packed = kernels.pack_fused_params(field.params, LEG_H, LEG_I)
        leaves = [packed["head_w"], packed["head_b"]] + [t for layer in packed["trunk"]
                                                         for t in (layer["w"], layer["b"])]
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        rng = np.random.default_rng(3)
        z = torch.from_numpy(rng.normal(size=(LEG_B, LEG_H))).to(device, bf16).requires_grad_()
        dx = torch.from_numpy(rng.normal(size=(LEG_B, LEG_I))).to(device, bf16)
        hw, hb, *flat = leaves
        trunk = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
        out = kernels.fused_matmul_field(trunk, hw, hb, z, dx, LEG_H, LEG_I, "bfloat16")
        grads = torch.autograd.grad((out.float() ** 2).sum(), leaves + [z])
        names = ["head_w", "head_b"] + [f"trunk[{l}].{k}" for l in range(len(trunk))
                                        for k in ("w", "b")] + ["z"]
        return {"out": out.detach(), **{f"d{n}": g for n, g in zip(names, grads)}}

    got, launches = counted(lambda: leg("cuda"))
    expect_launches("the bf16 leg", launches, forward=1, backward=1)
    want = leg("cpu")
    errs = {}
    for name, w in want.items():
        g = got[name].cpu()
        if g.dtype != bf16 or g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"bf16 leg {name}: dtype {g.dtype}, shape "
                                 f"{tuple(g.shape)} or non-finite values")
        g, w = g.double(), w.double()
        scale = float(w.abs().max())
        errs[name] = float((g - w).abs().max()) / scale
        if not float((g - w).abs().max()) <= LEG_TOL * scale + 1e-5:
            raise AssertionError(f"bf16 leg {name}: max err {errs[name]} of max, past "
                                 f"{LEG_TOL}")
    emit("bench_bf16_leg", shape=[LEG_B, LEG_H, LEG_H, LEG_I, 2], storage="bfloat16",
         precision="bfloat16", kernel_launches=launches, tol=LEG_TOL,
         max_err_per_max=errs)


def phase_predict_bf16():
    """One ``predict`` of the flagship model in bf16 (the requests go in at
    the model's dtype): 888 forward launches and no backward; the card's
    outputs within PREDICT_BF16_RATIO of the CPU's bf16-vs-f32 distance
    (the same weights in f32) from the CPU's, beside the share a jitter of
    the CPU's products by BF16_JITTER gives."""
    from online_neural_cdes_tpu_torch import Predictor

    bf16 = torch.bfloat16
    model = flagship_model("cuda", dtype=bf16)
    pred = Predictor(model, coeff_fn=rectilinear_coeffs, batch_buckets=(1, 64),
                     length_multiple=LENGTH_MULTIPLE, device="cuda")
    pred.precompile(channels=C, max_length=MAX_LEN, static_dim=STATIC)
    requests, static = make_requests()
    padded_len = -(-MAX_LEN // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
    expected = 4 * (2 * padded_len - 2)
    outs, launches = counted(lambda: pred.predict(requests, static=static))  # bf16 serving
    expect_launches("one bf16 predict", launches, forward=expected)
    def cpu_predict(dtype):
        m = flagship_model("cpu", dtype=dtype)
        m.load_state_dict(model.state_dict())
        return Predictor(m, coeff_fn=rectilinear_coeffs, batch_buckets=(1, 64),
                         length_multiple=LENGTH_MULTIPLE, device="cpu").predict(
                             requests, static=static)

    outs_cpu, outs_f32 = cpu_predict(bf16), cpu_predict(torch.float32)
    with jittered_products(BF16_JITTER):
        outs_jitter = cpu_predict(bf16)
    for r, g in zip(requests, outs):
        if g.shape != (len(r), 1) or not np.isfinite(g).all():
            raise AssertionError(f"bf16 predictor output shape {g.shape} or non-finite")

    def dist(xs, ys):
        return max(float(np.abs(x - y).max()) for x, y in zip(xs, ys))

    scale = dist(outs_cpu, outs_f32)
    share, jitter_share = dist(outs, outs_cpu) / scale, dist(outs_jitter, outs_cpu) / scale
    if not share <= PREDICT_BF16_RATIO:
        raise AssertionError(f"bf16 predict: the card is {share} of the CPU's bf16-vs-f32 "
                             f"distance ({scale}) from the CPU (limit {PREDICT_BF16_RATIO})")
    emit("predict_bf16", kernel_launches=launches, expected_launches=expected,
         vs_cpu={"max_abs_err": dist(outs, outs_cpu), "cpu_bf16_vs_f32": scale,
                 "ratio": share, "ratio_limit": PREDICT_BF16_RATIO,
                 "cpu_jitter_ratio": jitter_share, "jitter": BF16_JITTER,
                 "max_abs_output": max(float(np.abs(c).max()) for c in outs_cpu)})
    return launches


def rk4_chain_states(model, inputs):
    """The flagship model's hidden states at every knot by chaining the
    whole-interval RK4 kernel over its rectilinear pieces: even pieces with
    the time channel's head slice (I=1), odd pieces with the full head,
    each with its piece's dX/dt times the knot spacing.  Also the same
    states from ``cdeint`` through the per-stage field kernel."""
    from online_neural_cdes_tpu_torch.ops.cdeint import cdeint
    from online_neural_cdes_tpu_torch.ops.kernels import fused_rk4_interval

    with torch.inference_mode():
        spline, h0 = model._setup_h0(inputs)
        func, even_func, packed, vf_type = model.make_solve_func(h0)
        want = cdeint(spline, func, h0, spline.grid_points, packed, adjoint=False,
                      vector_field_type=vf_type, method="rk4", even_func=even_func,
                      options={"substeps": 1})
        grid, dxdt = spline.host_grid(), spline.piece_data()["dxdt"]
        k, states, z = model.rectilinear_time_channel, [h0], h0
        for i in range(len(grid) - 1):
            dx = dxdt[i] * (grid[i + 1] - grid[i])
            if i % 2 == 0:
                z = fused_rk4_interval(packed["trunk"], packed["head_w_time"],
                                       packed["head_b_time"], z,
                                       dx[:, k:k + 1].contiguous(), H, 1)
            else:
                z = fused_rk4_interval(packed["trunk"], packed["head_w"],
                                       packed["head_b"], z, dx.contiguous(), H, C)
            states.append(z)
        return torch.stack(states, dim=-2), want


def phase_chains():
    """Both interval-chain experiments on the card (their variants and the
    launches of every chain), then the interval kernel chained over the
    flagship training batch against ``cdeint``'s per-stage solve."""
    from online_neural_cdes_tpu_torch.experiments import interleave_experiment, pair_probe

    (probe, inter), launches = counted(                  # the chains' main path
        lambda: (pair_probe.main([]), interleave_experiment.main([])))
    n_probe, n_inter = probe["shape"]["N"], inter["shape"]["N"]
    for name, row in probe["variants"].items():
        per = 2 * n_probe if name.startswith("pair") else n_probe
        want = {"fused_field": 4 * per if name.endswith("_stages") else 0,
                "fused_rk4": per if name.endswith("_interval") else 0}
        if row["launches"] != want or not row["finite"]:
            raise AssertionError(f"pair_probe {name}: launches {row['launches']}, "
                                 f"expected {want}, finite {row['finite']}")
    for name, row in inter["variants"].items():
        if "launches" not in row:
            continue
        k = row.get("K", 1)
        want = ({"fused_rk4": 0, "fused_rk4_multi": n_inter} if name.endswith("interleave")
                else {"fused_rk4": k * n_inter, "fused_rk4_multi": 0})
        if row["launches"] != want:
            raise AssertionError(f"interleave {name}: launches {row['launches']}, "
                                 f"expected {want}")

    model = flagship_model("cuda")
    inputs, _ = train_batch("cuda")
    got, want = rk4_chain_states(model, inputs)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"interval chain states: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite values")
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=CHAIN_RTOL, atol=CHAIN_ATOL_REL * scale,
                               msg=lambda m: f"interval chain vs cdeint: {m}")
    per_interval = {  # device us a chain step: an interval, or an even-odd pair
        kind: {path: probe["variants"][f"{kind}_{path}"]["device_us"]
               for path in ("stages", "interval")} for kind in ("even", "odd", "pair")}
    per_interval.update({f"K={k}": {path: inter["variants"][f"k{k}_{path}"]["device_us"]
                                    for path in ("launches", "interleave")} for k in (2, 4)})
    emit("chains", per_interval_us=per_interval, pair_probe=probe["variants"],
         interleave=inter["variants"], parity=inter["parity"], launches=launches,
         model_chain={"intervals": got.shape[-2] - 1,
                      "max_abs_err": float((got - want).abs().max()),
                      "gate_share": gate_share(got.cpu(), want.cpu(), CHAIN_RTOL,
                                               CHAIN_ATOL_REL * scale),
                      "max_abs_state": scale, "rtol": CHAIN_RTOL,
                      "atol_per_max": CHAIN_ATOL_REL})
    return launches


def spline_builders():
    """Every spline coefficient builder of the port, by name."""
    from online_neural_cdes_tpu_torch import (
        SmoothLinearInterpolation, hermite_cubic_coefficients_with_backward_differences,
        linear_interpolation_coeffs, natural_cubic_coeffs, natural_cubic_spline_coeffs)

    def smoothing(quintic):
        return lambda x: SmoothLinearInterpolation.create(
            linear_interpolation_coeffs(x), SMOOTH_EPS,
            match_second_derivatives=quintic).matching_coeffs

    return {"natural_cubic": natural_cubic_coeffs,
            "natural_cubic_v0": natural_cubic_spline_coeffs,
            "hermite": hermite_cubic_coefficients_with_backward_differences,
            "cubic_smoothing": smoothing(False), "quintic_smoothing": smoothing(True)}


def phase_splines():
    """The spline family on the card: every coefficient builder on the
    padded serving batch against the CPU; a Hermite flagship ``Predictor``
    (444 forward launches, 0 backward per ``predict``) against the CPU; one
    Hermite flagship training step (792 forward, 396 backward launches)
    with the card's gradients against the CPU's on 16 rows."""
    from online_neural_cdes_tpu_torch import (
        Predictor, hermite_cubic_coefficients_with_backward_differences as hermite)
    from online_neural_cdes_tpu_torch.data.loader import pad_ragged
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    requests, static = make_requests()
    x = torch.from_numpy(pad_ragged(requests, bucket_multiple=LENGTH_MULTIPLE))
    coeff_err = {}
    with torch.inference_mode():
        for name, fn in spline_builders().items():
            got, want = fn(x.cuda()).cpu(), fn(x)
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name} coefficients on the card: shape "
                                     f"{tuple(got.shape)} or non-finite values")
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=SPLINE_RTOL,
                                       atol=SPLINE_ATOL_REL * scale,
                                       msg=lambda m: f"{name} coefficients: {m}")
            coeff_err[name] = {"shape": list(got.shape),
                               "max_err_per_max": float((got - want).abs().max()) / scale}

    # Serving: the flagship widths with Hermite controls.
    model = flagship_model("cuda", "hermite")
    pred = Predictor(model, coeff_fn=hermite, batch_buckets=(1, 64),
                     length_multiple=LENGTH_MULTIPLE, device="cuda")
    pred.precompile(channels=C, max_length=MAX_LEN, static_dim=STATIC)
    intervals = x.shape[1] - 1
    outs, serve = counted(lambda: pred.predict(requests, static=static))  # Hermite serving
    expect_launches("one Hermite predict", serve, forward=4 * intervals)
    model_cpu = flagship_model("cpu", "hermite")
    model_cpu.load_state_dict(model.state_dict())
    outs_cpu = Predictor(model_cpu, coeff_fn=hermite, batch_buckets=(1, 64),
                         length_multiple=LENGTH_MULTIPLE, device="cpu").predict(
                             requests, static=static)
    serve_err = serve_share = 0.0
    for r, g, c in zip(requests, outs, outs_cpu):
        if g.shape != (len(r), 1) or not np.isfinite(g).all():
            raise AssertionError(f"Hermite predictor output shape {g.shape} or non-finite")
        np.testing.assert_allclose(g, c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        serve_err = max(serve_err, float(np.abs(g - c).max()))
        serve_share = max(serve_share, gate_share(g, c, SERVE_RTOL, SERVE_ATOL))
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        pred.predict(requests, static=static)
        lat.append((time.perf_counter() - t0) * 1e3)

    # Training: one Hermite flagship step, B=512, 100 observations.
    model = flagship_model("cuda", "hermite")
    inputs, labels = train_batch("cuda", coeff_fn=hermite)
    model_cpu.load_state_dict(model.state_dict())
    got = slice_grads(model, inputs, labels, GRAD_ROWS)
    want = slice_grads(model_cpu, tuple(t.cpu() for t in inputs), labels.cpu(), GRAD_ROWS)
    grad_err = {}
    for name, w in want.items():
        g = got[name].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"Hermite card gradient of {name} is not finite")
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(w.abs().max()),
                                   msg=lambda m: f"Hermite gradient of {name}: {m}")
        grad_err[name] = float((g - w).abs().max() / w.abs().max())
    step = make_train_step(model, loss="bce", lr=TRAIN_LR)
    train_intervals = TRAIN_L - 1
    loss, train = counted(lambda: step(inputs, labels, 1.0))  # Hermite training
    expect_launches("one Hermite training step", train, forward=8 * train_intervals,
                    backward=4 * train_intervals)
    losses = [loss]
    step_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(step(inputs, labels, 1.0))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"Hermite training losses not finite: {losses}")
    emit("splines", coefficients=coeff_err,
         coeff_tolerance={"rtol": SPLINE_RTOL, "atol_per_max": SPLINE_ATOL_REL},
         hermite_predict={"intervals": intervals, "kernel_launches": serve,
                          "vs_cpu": {"max_abs_err": serve_err, "gate_share": serve_share,
                                     "rtol": SERVE_RTOL, "atol": SERVE_ATOL},
                          "predict_ms": percentiles(lat)},
         hermite_train={"batch": TRAIN_B, "intervals": train_intervals,
                        "kernel_launches": train,
                        "grads_vs_cpu": {"rows": GRAD_ROWS,
                                         "max_err_per_max": max(grad_err.values()),
                                         "rtol": GRAD_RTOL, "atol_per_max": GRAD_ATOL_REL},
                        "losses": [float(v) for v in losses],
                        "train_step_ms": percentiles(step_ms)})
    return serve, train


def phase_toy():
    """The toy under the rectilinear, Hermite and natural cubic schemes,
    card against CPU from the same weights and data."""
    from online_neural_cdes_tpu_torch.experiments import sim_bm_toy as toy

    data = {device: toy.toy_data(TOY_PATHS, 3, device) for device in ("cuda", "cpu")}
    for scheme in TOY_SCHEMES:
        runs = {device: toy.train_scheme(
            scheme, data[device], epochs=TOY_EPOCHS, hidden=10, width=256, reps=1,
            batch_size=TOY_BATCH, device=device) for device in ("cuda", "cpu")}
        gpu, cpu = runs["cuda"], runs["cpu"]
        np.testing.assert_allclose(gpu["losses"], cpu["losses"], rtol=TOY_RTOL,
                                   atol=TOY_ATOL, err_msg=scheme)
        before, after = float(gpu["train_acc_before"][0]), float(gpu["train_acc"][0])
        if not after > before:
            raise AssertionError(f"toy {scheme}: train accuracy did not rise: "
                                 f"{before} -> {after}")
        emit("toy", scheme=scheme, paths=TOY_PATHS, epochs=TOY_EPOCHS,
             steps=int(gpu["losses"].shape[1]),
             loss_first_last=[float(gpu["losses"][0, 0]), float(gpu["losses"][0, -1])],
             vs_cpu={"max_abs_err": float(np.abs(gpu["losses"] - cpu["losses"]).max()),
                     "rtol": TOY_RTOL, "atol": TOY_ATOL},
             train_acc_before=before, train_acc=after,
             test_acc=float(gpu["test_acc"][0]), seconds_card=gpu["seconds"],
             seconds_cpu=cpu["seconds"])


def config3(device, adjoint=False):
    """The config 3 model (random weights from a seed) and its batch: the
    Hermite coefficients and one normal target per series."""
    from online_neural_cdes_tpu_torch import (
        NeuralCDE, hermite_cubic_coefficients_with_backward_differences)

    model = NeuralCDE(input_dim=CFG3_C, hidden_dim=CFG3_H, output_dim=1,
                      hidden_hidden_dim=CFG3_H, num_layers=2, interpolation="hermite",
                      return_sequences=False, adjoint=adjoint, solver="dopri5",
                      generator=torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(CFG3_B, CFG3_L, CFG3_C)).astype(np.float32)
    x[:, :, 0] = np.arange(CFG3_L)
    labels = rng.normal(size=(CFG3_B,)).astype(np.float32)
    coeffs = hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(x).to(device))
    return model, coeffs, torch.from_numpy(labels).to(device)


def solve_counted(fn):
    """``counted(fn)`` with the solvers' counts (``solvers.COUNTS``) set to
    0 just before too: (fn's result, launches, solver counts)."""
    from online_neural_cdes_tpu_torch.ops import solvers

    def run():
        solvers.reset_counts()
        return fn()

    out, launches = counted(run)
    return out, launches, {kind: dict(c) for kind, c in solvers.COUNTS.items()}


def expect_evals(what, launches, counts):
    """Kernel launches equal the field evaluations the solvers counted: the
    forward kernel once per evaluation (forward and reverse solves' nfe,
    the replay's evaluations and the adjoint's f(t_i, y_i)), the backward
    kernel once per reverse-solve evaluation and replayed evaluation."""
    get = lambda kind, key: counts.get(kind, {}).get(key, 0)
    expect_launches(what, launches,
                    forward=(get("forward", "nfe") + get("reverse", "nfe")
                             + get("reverse", "evals") + get("replay", "evals")),
                    backward=get("reverse", "nfe") + get("replay", "evals"))


def solve_stats(counts, kind="forward"):
    return {k: counts.get(kind, {}).get(k, 0)
            for k in ("solves", "nfe", "accepted", "rejected", "reads", "evals")}


@contextmanager
def recording_steps(steps):
    """Appends each accepted step of the adaptive solves run inside, as its
    controller records it ((t0, dt, t1, t1_eval, reseed)), to ``steps``."""
    from online_neural_cdes_tpu_torch.ops import solvers

    attempt = solvers._Controller.attempt

    def recorded(ctl, s):
        new, step = attempt(ctl, s)
        if step is not None:
            steps.append(step)
        return new, step

    solvers._Controller.attempt = recorded
    try:
        yield steps
    finally:
        solvers._Controller.attempt = attempt


@contextmanager
def following_steps(steps):
    """The adaptive solves run inside take the recorded accepted steps in
    their order instead of deciding, with the port's own stage arithmetic:
    the CPU follows the card's step grid, so the two are held against each
    other on one discretisation (a 3xTF32 round-off that flips one
    decision would otherwise move the whole grid)."""
    from online_neural_cdes_tpu_torch.ops import solvers

    attempt, queue = solvers._Controller.attempt, iter(steps)

    def follow(ctl, s):
        step = next(queue)
        t0, dt, t1, t1_eval, reseed = step
        if t0 != s.t1:
            raise AssertionError(f"following the card's steps: a step from {t0} "
                                 f"where the solve stands at {s.t1}")
        y1, f1, _, k = solvers._runge_kutta_step(ctl.func, s.y1, s.f1, t0, dt,
                                                 ctl.tableau, t1_eval, error=False)
        if reseed is not None:
            f1 = ctl.func(reseed, y1)
        return solvers._RKState(y1=y1, f1=f1, t0=t0, t1=t1, dt=dt, nfe=s.nfe,
                                accepted=s.accepted + 1, rejected=s.rejected,
                                last=(s.y1, y1, k, dt)), step

    solvers._Controller.attempt = follow
    try:
        yield
    finally:
        solvers._Controller.attempt = attempt
    if next(queue, None) is not None:
        raise AssertionError("following the card's steps: steps left over")


def mse_grads(model, coeffs, labels):
    """(predictions, parameter gradients) of the train step's masked MSE."""
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model.zero_grad(set_to_none=True)
    preds = model(coeffs)
    masked_temporal_loss(make_loss("mse"), preds, labels).backward()
    return preds.detach(), {name: p.grad.detach().clone()
                            for name, p in model.named_parameters()}


def phase_adaptive():
    """dopri5 on the card.  Config 3: the differentiable solve's replay
    gives the no-grad solve's outputs to the bit; gradients against the
    CPU port on the full batch; one training step's launches equal the
    solver's own counts (replay: 6 per accepted step plus f0); step times,
    profile, NFE and host reads.  Config 3 with the adjoint: one training
    step through ``odeint_adjoint`` (the augmented reverse dopri5 solve),
    gradients against the CPU on the full batch, launches against the
    counts (reverse: its nfe plus one f(t_i, y_i) per output interval, one
    reverse solve an interval).  The flagship with the adjoint: one
    ``Predictor.predict`` against the CPU's, launches against the counts
    (its B=512 training step is cut for the run's time; config 3 with the
    adjoint runs the same reverse solve).  Each model's card and CPU nfe /
    accepted / rejected are printed (the flagship's on the card only); a
    3xTF32 round-off may flip a step decision, so they are not gated, and
    with the adjoint the CPU is held to the card on the card's own step
    grid (``following_steps``)."""
    from online_neural_cdes_tpu_torch import Predictor
    from online_neural_cdes_tpu_torch.ops import solvers
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    t_phase = time.perf_counter()
    per_step = len(solvers.ADAPTIVE_METHODS["dopri5"].c_sol) - 1
    paths = {}

    # -- config 3 --------------------------------------------------------
    model, coeffs, labels = config3("cuda")
    model_cpu, coeffs_cpu, labels_cpu = config3("cpu")
    model_cpu.load_state_dict(model.state_dict())
    with torch.inference_mode():
        solve_out = model(coeffs)
    (preds, got), launches, counts = solve_counted(lambda: mse_grads(model, coeffs, labels))
    if not torch.equal(preds, solve_out):
        raise AssertionError("config 3: the replay's outputs differ from the no-grad solve's")
    expect_evals("config 3 forward and backward", launches, counts)
    solvers.reset_counts()
    _, want = mse_grads(model_cpu, coeffs_cpu, labels_cpu)
    cpu_counts = {kind: dict(c) for kind, c in solvers.COUNTS.items()}
    grads = grad_gate("config 3: ", got, want)

    step = make_train_step(model, loss="mse")
    loss, launches, counts = solve_counted(lambda: step(coeffs, labels, 1.0))  # the main path
    expect_evals("config 3 train step", launches, counts)
    fwd = counts["forward"]
    if counts["replay"]["evals"] != fwd["accepted"] * per_step + fwd["solves"]:
        raise AssertionError(f"config 3 replay: {counts['replay']['evals']} evaluations "
                             f"for {fwd['accepted']} accepted steps")
    paths["config3_train_step"] = launches
    losses, step_ms = [float(loss)], []
    for _ in range(CFG3_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(coeffs, labels, 1.0)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(losses).all():
        raise AssertionError(f"config 3 losses not finite: {losses}")
    # Device time only: the host ops' table took ~20 s (cut for the run's time).
    profile = profile_call(lambda: step(coeffs, labels, 1.0), host=False)
    emit("adaptive", model="config3", source="bench.py:368-405", batch=CFG3_B,
         length=CFG3_L, shape=list(CFG3_SHAPE), solver="dopri5 min_step=0.5",
         adjoint=False, kernel_launches=launches, solver_counts=counts,
         host_reads_per_step=sum(c["reads"] for c in counts.values()),
         card=solve_stats(counts), cpu=solve_stats(cpu_counts),
         replay_equals_solve="bit-identical", grads_vs_cpu={"rows": CFG3_B, **grads},
         losses=losses, train_step_ms=percentiles(step_ms),
         device_busy_ms=profile["device_busy_ms"],
         device_busy_share=profile["device_busy_share"], profile=profile,
         seconds=time.perf_counter() - t_phase)

    # -- config 3 with the adjoint ---------------------------------------
    t_part = time.perf_counter()
    model, coeffs, labels = config3("cuda", adjoint=True)
    model_cpu, coeffs_cpu, labels_cpu = config3("cpu", adjoint=True)
    model_cpu.load_state_dict(model.state_dict())
    steps = []
    with recording_steps(steps):
        _, got = mse_grads(model, coeffs, labels)
    t0 = time.perf_counter()
    with following_steps(steps):   # the forward solve's steps, then the reverse solve's
        _, want = mse_grads(model_cpu, coeffs_cpu, labels_cpu)
    cpu_seconds = time.perf_counter() - t0
    grads = grad_gate("config 3 adjoint: ", got, want)
    step = make_train_step(model, loss="mse")
    t0 = time.perf_counter()
    loss, launches, counts = solve_counted(lambda: step(coeffs, labels, 1.0))  # the main path
    step_ms = (time.perf_counter() - t0) * 1e3
    expect_evals("config 3 adjoint train step", launches, counts)
    intervals = 1   # return_sequences=False: the one output interval
    rev = counts.get("reverse", {})
    if (rev.get("solves"), rev.get("evals")) != (intervals, intervals) or not rev.get("nfe"):
        raise AssertionError(f"config 3 adjoint: reverse counts {rev} for {intervals} "
                             "output interval")
    if counts.get("replay", {}).get("evals", 0):
        raise AssertionError("config 3 adjoint: the forward solve was replayed")
    if not np.isfinite(float(loss)):
        raise AssertionError(f"config 3 adjoint loss not finite: {loss}")
    paths["config3_adjoint_train_step"] = launches
    profile = profile_call(lambda: step(coeffs, labels, 1.0), host=False)
    emit("adaptive", model="config3", path="adjoint_train_step",
         solver="dopri5 min_step=0.5", adjoint=True, batch=CFG3_B, intervals=intervals,
         kernel_launches=launches, solver_counts=counts,
         host_reads_per_step=sum(c["reads"] for c in counts.values()),
         card={"forward": solve_stats(counts), "reverse": solve_stats(counts, "reverse")},
         grads_vs_cpu_on_the_cards_steps={"rows": CFG3_B, **grads}, loss=float(loss),
         train_step_ms=step_ms, device_busy_ms=profile["device_busy_ms"],
         device_busy_share=profile["device_busy_share"], profile=profile,
         cpu_seconds=cpu_seconds, seconds=time.perf_counter() - t_part)

    # -- the flagship, dopri5 with the adjoint ---------------------------
    t_part = time.perf_counter()
    model = flagship_model("cuda", solver="dopri5")
    model_cpu = flagship_model("cpu", solver="dopri5")
    model_cpu.load_state_dict(model.state_dict())
    requests, static = make_requests()
    pred = Predictor(model, coeff_fn=rectilinear_coeffs, batch_buckets=(1, 64),
                     length_multiple=LENGTH_MULTIPLE, device="cuda")
    pred_cpu = Predictor(model_cpu, coeff_fn=rectilinear_coeffs, batch_buckets=(1, 64),
                         length_multiple=LENGTH_MULTIPLE, device="cpu")
    steps = []
    t0 = time.perf_counter()
    with recording_steps(steps):
        outs, launches, counts = solve_counted(lambda: pred.predict(requests,
                                                                    static=static))
    predict_ms = (time.perf_counter() - t0) * 1e3
    expect_evals("flagship dopri5 predict", launches, counts)
    paths["predict"] = launches
    # The CPU on the card's steps only: its predict on its own steps (read,
    # not gated) is cut for the run's time.
    t0 = time.perf_counter()
    with following_steps(steps):
        outs_cpu = pred_cpu.predict(requests, static=static)
    cpu_seconds = time.perf_counter() - t0
    err = share = 0.0
    for r, g, c in zip(requests, outs, outs_cpu):
        if g.shape != (len(r), 1) or not np.isfinite(g).all():
            raise AssertionError(f"dopri5 predictor output shape {g.shape} or non-finite")
        np.testing.assert_allclose(g, c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        err = max(err, float(np.abs(g - c).max()))
        share = max(share, gate_share(g, c, SERVE_RTOL, SERVE_ATOL))
    # predict_ms is the counted call's wall time: its profiled call was cut
    # for the run's time (PR 18), so its device busy time is not measured.
    emit("adaptive", model="flagship", path="predict", solver="dopri5 min_step=0.5",
         requests=N_REQUESTS, kernel_launches=launches, solver_counts=counts,
         host_reads=sum(c["reads"] for c in counts.values()),
         card=solve_stats(counts),
         vs_cpu_on_the_cards_steps={"max_abs_err": err, "gate_share": share,
                                    "rtol": SERVE_RTOL, "atol": SERVE_ATOL},
         predict_ms=predict_ms, device_busy_ms="not measured",
         cpu_seconds=cpu_seconds, seconds=time.perf_counter() - t_part,
         phase_seconds=time.perf_counter() - t_phase)
    # The flagship's adjoint training step (~73 s) is cut for the run's time
    # (PERF.md); config 3 trains through the same reverse solve above.
    paths.update(adaptive_export_leg(model, requests, static))
    return {f"adaptive_{k}": v for k, v in paths.items()}


def solve_counts(counts):
    return {k: counts.get("forward", {}).get(k, 0)
            for k in ("solves", "nfe", "accepted", "rejected")}


def export_against_live(what, live_pred, requests, static, live_outs, live_launches,
                        live_counts, export_kw, live_ms=None):
    """``live_pred`` exported (``export_kw``: its one length bucket), loaded
    with no model object and serving ``requests``: the loaded ``predict``'s
    solve counts (nfe / accepted / rejected) and kernel launches equal to
    the live one's, its rows within the serving gate of the live rows
    (bit-identity read, not gated).  Then its times beside the live
    predictor's: the counted call (the loaded program's first; ``live_ms``
    the live counted call's) and one more call of each side under the
    profiler (wall ms, host CPU seconds, device busy time, host kernel
    launches and copies).  Returns its readings."""
    from online_neural_cdes_tpu_torch.serving_export import export_predictor, load_predictor

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_adaptive_")
    try:
        path = os.path.join(tmp, "artifact")
        t0 = time.perf_counter()
        n = export_predictor(live_pred, path, **export_kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_predictor(path, device=live_pred.device)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, launches, counts = solve_counted(lambda: loaded.predict(requests,
                                                                     static=static))
        first_ms = (time.perf_counter() - t0) * 1e3
        if solve_counts(counts) != solve_counts(live_counts):
            raise AssertionError(f"{what}: the loaded predict's solve counts "
                                 f"{solve_counts(counts)}, the live one's "
                                 f"{solve_counts(live_counts)}")
        if launches != live_launches:
            raise AssertionError(f"{what}: the loaded predict launched {launches}, the "
                                 f"live one {live_launches}")
        err = share = 0.0
        for g, w in zip(got, live_outs):
            if g.shape != w.shape or not np.isfinite(g).all():
                raise AssertionError(f"{what}: a loaded row {g.shape} or not finite")
            err = max(err, float(np.abs(g - w).max()))
            share = max(share, gate_share(g, w, SERVE_RTOL, SERVE_ATOL))
        if share > 1.0:
            raise AssertionError(f"{what}: loaded rows at {share} of the serving gate")
        profiles = {name: profile_call(lambda p=p: p.predict(requests, static=static),
                                       host=False)
                    for name, p in (("live", live_pred), ("loaded", loaded))}
        return {"shapes_exported": n, "export_seconds": export_s, "load_seconds": load_s,
                "artifact_bytes": artifact_bytes(path), "solve_counts": solve_counts(counts),
                "kernel_launches": launches,
                "vs_live": {"max_abs_err": err, "gate_share": share,
                            "bit_identical": all(np.array_equal(g, w)
                                                 for g, w in zip(got, live_outs))},
                "predict_ms": {"loaded": first_ms, "live": live_ms},
                "torch_threads": torch.get_num_threads(),
                "profiled": {name: {k: prof[k] for k in (
                    "wall_ms", "host_cpu_s", "device_busy_ms", "device_busy_share",
                    "host_kernel_launches", "host_copies")}
                    for name, prof in profiles.items()}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def adaptive_export_leg(model, requests, static):
    """The dopri5 flagship predictor exported with one length bucket,
    loaded with no model object, serving the 64 requests cut to their first
    EXPORT_ADAPTIVE_L observations (cut for the run's time: a
    loaded call of the whole requests took 9-15 s): its nfe / accepted /
    rejected and kernel-1 launches equal to the live ``predict``'s on the
    same requests, rows within the serving gate; the live and loaded calls'
    times side by side (``export_against_live``)."""
    from online_neural_cdes_tpu_torch import Predictor

    t0 = time.perf_counter()
    requests = [r[:EXPORT_ADAPTIVE_L] for r in requests]
    padded = -(-max(len(r) for r in requests) // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
    one_bucket = Predictor(model, coeff_fn=rectilinear_coeffs, batch_buckets=(N_REQUESTS,),
                           length_multiple=padded, device="cuda")
    t1 = time.perf_counter()
    outs, launches, counts = solve_counted(lambda: one_bucket.predict(requests,
                                                                      static=static))
    predict_ms = (time.perf_counter() - t1) * 1e3
    expect_evals("flagship dopri5 predict before the export", launches, counts)
    line = export_against_live(
        "adaptive export", one_bucket, requests, static, outs, launches, counts,
        dict(channels=C, max_length=padded, static_dim=STATIC), live_ms=predict_ms)
    emit("adaptive", model="flagship", path="exported_predict", solver="dopri5 min_step=0.5",
         requests=N_REQUESTS, observations=EXPORT_ADAPTIVE_L, length=padded,
         live_solve_counts=solve_counts(counts), live_kernel_launches=launches, **line,
         seconds=time.perf_counter() - t0)
    return {"exported_predict": line["kernel_launches"]}


def adams_export_leg(device):
    """An implicit Adams model at config 3's shapes (Hermite, C=9, H=HH=32,
    2 layers; 64 requests of its 24 observations) exported with one length
    bucket, loaded with no model object and serving the requests against
    the live predictor: solve counts and kernel launches equal, rows within
    the serving gate."""
    from online_neural_cdes_tpu_torch import (
        Predictor, hermite_cubic_coefficients_with_backward_differences as hermite)

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N_REQUESTS, CFG3_L, CFG3_C)).astype(np.float32)
    x[:, :, 0] = np.arange(CFG3_L)
    requests = list(x)
    pred = Predictor(config3_model(device, "implicit_adams"), coeff_fn=hermite,
                     batch_buckets=(N_REQUESTS,), length_multiple=CFG3_L, device=device)
    live, launches, counts = solve_counted(lambda: pred.predict(requests))
    expect_launches("implicit_adams export: the live predict", launches,
                    forward=counts["forward"]["nfe"])
    line = export_against_live("implicit_adams export", pred, requests, None, live, launches,
                               counts, dict(channels=CFG3_C, max_length=CFG3_L))
    emit("solver_extras", path="implicit_adams_exported_predict", model="config3",
         requests=N_REQUESTS, live_solve_counts=solve_counts(counts),
         live_kernel_launches=launches, **line, seconds=time.perf_counter() - t0)
    return {"implicit_adams_exported_predict": line["kernel_launches"]}


# ---------------------------------------------------------------- zoo


def linear_coeffs(x):
    from online_neural_cdes_tpu_torch import linear_interpolation_coeffs

    return linear_interpolation_coeffs(x)


def cfg4_batch(holes=False):
    """The JAX bench's config 4 batch (bench.py:419-427): B=1024 series of
    L=89 observations, C=21 channels with time arange(L)/L in channel 0,
    one of 10 classes each; with ``holes``, 30% of the non-time values NaN.
    Host arrays, and the per-channel nanmean (NaN -> 0) as feature means."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(CFG4_B, CFG4_L, C)).astype(np.float32)
    x[:, :, 0] = np.arange(CFG4_L) / CFG4_L
    labels = rng.integers(0, CFG4_CLASSES, size=(CFG4_B,)).astype(np.float32)
    if holes:
        drop = rng.random(size=x.shape) < 0.3
        drop[..., 0] = False
        x[drop] = np.nan
    means = np.nanmean(x.reshape(-1, C), axis=0)
    means[np.isnan(means)] = 0.0
    return x, labels, means.astype(np.float32)


def take_rows(inputs, rows):
    """The batch rows ``rows`` (a slice or an index tensor) of a tensor or a
    tuple of tensors."""
    if isinstance(inputs, torch.Tensor):
        return inputs[rows.to(inputs.device) if isinstance(rows, torch.Tensor) else rows]
    return tuple(take_rows(t, rows) for t in inputs)


def to_device(inputs, device, dtype=None):
    if isinstance(inputs, torch.Tensor):
        return inputs.to(device=device, dtype=dtype)
    return tuple(to_device(t, device, dtype) for t in inputs)


def zoo_grads(model, inputs, labels, loss):
    """(parameter gradients, input cotangents) of the train step's masked
    loss: the parameters the loss does not reach have none; one cotangent
    (or None) for each input tensor, in the inputs' order."""
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model.zero_grad(set_to_none=True)
    single = isinstance(inputs, torch.Tensor)
    leaves = tuple(t.detach().clone().requires_grad_()
                   for t in ((inputs,) if single else inputs))
    preds = model(leaves[0] if single else leaves)
    masked_temporal_loss(make_loss(loss), preds, labels).backward()
    return ({name: p.grad.detach().clone() for name, p in model.named_parameters()
             if p.grad is not None}, tuple(t.grad for t in leaves))


def row_shares(got, want):
    """Each batch row's share of its gate on the input cotangents: row r of
    every input within GRAD_RTOL |want| + GRAD_ATOL_REL max|want[r]|."""
    shares = None
    for g, w in zip(got, want):
        if w is None:
            continue
        g = g.cpu().double().reshape(len(w), -1)
        w = w.double().reshape(len(w), -1)
        err = (g - w).abs()
        gate = GRAD_RTOL * w.abs() + GRAD_ATOL_REL * w.abs().amax(dim=1, keepdim=True)
        s = torch.where(err == 0, torch.zeros_like(err), err / gate).amax(dim=1)
        shares = s if shares is None else torch.maximum(shares, s)
    return shares.tolist()


def host_syncs(fn):
    """(fn's result, the operations it ran that made the host wait for the
    card): ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message)[:100] for w in caught if "synchroniz" in str(w.message)]


def resolved_rows(want, want64, rtol, atol):
    """How many of one request's rows (time first) the CPU's f32 result
    resolves: the rows before the first where its own distance from f64
    passes ZOO_RESOLVED of the gate atol + rtol |want|.  A chaotic model
    magnifies round-off along the series until f32 no longer decides the
    output; past that row the card's result cannot be held to the CPU's."""
    want, want64 = (np.asarray(a, np.float64).reshape(len(a) if np.ndim(a) > 1 else 1, -1)
                    for a in (want, want64))
    past = (np.abs(want - want64) > ZOO_RESOLVED * (atol + rtol * np.abs(want))).any(axis=1)
    return int(np.argmax(past)) if past.any() else len(want)


def zoo_grad_gate(name, model, model_cpu, model64, batch, lab, loss):
    """The card's parameter gradients of the train step's loss on ``batch``
    against the CPU's, each tensor within GRAD_RTOL |want| + GRAD_ATOL_REL
    max|want|.  With ``model64`` (a chaotic model) the loss covers only the
    observations the CPU's f32 forward resolves against its f64 one
    (:func:`resolved_rows`).  A row whose input cotangents differ past
    their gate (:func:`row_shares`) took another relu or keep-mask
    decision somewhere in the series, which moves every gradient it reaches
    by far more than round-off; up to ZOO_MAX_DROPPED such rows leave the
    loss, each printed, and the gradients are taken again without them.
    Returns (the line, the host's waits on the card in the first card
    forward and backward)."""
    batch_cpu, lab = to_device(batch, "cpu"), lab.cpu().clone()
    line = {"rows": len(lab)}
    if model64 is not None:
        with torch.no_grad():
            want = model_cpu(batch_cpu)
            want64 = model64(to_device(batch_cpu, "cpu", torch.float64))
        k = resolved_rows(want.transpose(0, 1).numpy(), want64.transpose(0, 1).numpy(),
                          SERVE_RTOL, SERVE_ATOL)
        if k == 0:
            raise AssertionError(f"{name}: the CPU's f32 resolves no observation")
        lab[:, k:] = float("nan")
        line["observations"] = k
    lab_card = lab.cuda()
    (got, got_in), syncs = host_syncs(lambda: zoo_grads(model, batch, lab_card, loss))
    want, want_in = zoo_grads(model_cpu, batch_cpu, lab, loss)
    if set(got) != set(want):
        raise AssertionError(f"{name}: the card's gradients reach {sorted(got)}, the "
                             f"CPU's {sorted(want)}")
    if not all(torch.isfinite(g).all() for g in (*got.values(),
                                                  *(t for t in got_in if t is not None))):
        raise AssertionError(f"{name}: card gradients not finite")
    shares = row_shares(got_in, want_in)
    dropped = {r: s for r, s in enumerate(shares) if not s <= 1.0}
    if len(dropped) > ZOO_MAX_DROPPED:
        raise AssertionError(f"{name}: {len(dropped)} of {len(shares)} rows' input "
                             f"cotangents differ past their gate: {dropped}")
    line.update(input_cotangent_share=max(s for s in shares if s <= 1.0),
                dropped_rows=dropped)
    if dropped:
        lab[list(dropped)] = float("nan")
        got, _ = zoo_grads(model, batch, lab.cuda(), loss)
        want, _ = zoo_grads(model_cpu, batch_cpu, lab, loss)
    per = {n: gate_share(got[n].cpu(), w, GRAD_RTOL, GRAD_ATOL_REL * float(w.abs().max()))
           for n, w in want.items()}
    failed = {n: s for n, s in per.items() if not s <= 1.0}
    if failed:
        raise AssertionError(f"{name}: card gradients past their gate: {failed}")
    line.update(tensors=len(want), gate_share=max(per.values()),
                max_err_per_max=max(float((got[n].cpu() - w).abs().max() / w.abs().max())
                                    for n, w in want.items()),
                rtol=GRAD_RTOL, atol_per_max=GRAD_ATOL_REL)
    if model64 is not None:
        want64, _ = zoo_grads(model64, to_device(batch_cpu, "cpu", torch.float64),
                              lab.double(), loss)
        line["cpu_f32_vs_f64_share"] = max(
            gate_share(w, want64[n], GRAD_RTOL, GRAD_ATOL_REL * float(want64[n].abs().max()))
            for n, w in want.items())
    return line, syncs


def zoo_case(name, model_string, make, inputs, labels, loss, expected_step,
             serve=None, expected_serve=0, steps=ZOO_STEPS, rows=None, source=None,
             gate_syncs=False, resolve=False, **facts):
    """One zoo model on the card (``make(device, dtype)`` builds it; the
    CPU copy takes the card's weights): one request batch (``serve``: the
    Predictor's settings, or a function of the models that runs a forward)
    against the same call on the CPU in f32 within SERVE_RTOL / SERVE_ATOL
    (with ``resolve``, a chaotic model, on each request's rows that f32
    resolves against f64: :func:`resolved_rows`); the gradients on
    ZOO_GRAD_ROWS rows (``rows``) against the CPU's (:func:`zoo_grad_gate`);
    the host's waits on the card in that forward and backward (gated to 0
    with ``gate_syncs``); one Adam step, counted and profiled, its kernel
    launches gated to ``expected_step`` (forward, backward), then ``steps``
    timed steps.  Returns the launches by path."""
    from online_neural_cdes_tpu_torch import Predictor
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    t0 = time.perf_counter()
    model, model_cpu = make("cuda"), make("cpu")
    model_cpu.load_state_dict(model.state_dict())
    model64 = None
    if resolve:
        model64 = make("cpu", torch.float64)
        model64.load_state_dict({k: v.double() for k, v in model_cpu.state_dict().items()})
    out = {"model": name, "model_string": model_string, "source": source, **facts}
    paths = {}
    if isinstance(serve, dict):
        requests, static = make_requests()
        static = static if serve.get("accept_static", True) else None
        kw = dict(batch_buckets=(1, N_REQUESTS), length_multiple=LENGTH_MULTIPLE,
                  **{k: v for k, v in serve.items() if k != "coeff_fn"})
        pred = Predictor(model, coeff_fn=serve["coeff_fn"]("cuda"), **kw, device="cuda")
        got, launches = counted(lambda: pred.predict(requests, static=static))
        expect_launches(f"{name}: one predict", launches, forward=expected_serve)
        # The CPU serves the first ZOO_CPU_REQUESTS of them (the longest
        # first), in a bucket of their own.
        n_cpu = ZOO_CPU_REQUESTS
        kw_cpu = dict(kw, batch_buckets=(1, n_cpu))
        want, want64 = (None if m is None else
                        Predictor(m, coeff_fn=serve["coeff_fn"]("cpu"), **kw_cpu,
                                  device="cpu").predict(
                            requests[:n_cpu], static=None if static is None else static[:n_cpu])
                        for m in (model_cpu, model64))
        if len(got) != N_REQUESTS or not all(np.isfinite(g).all() for g in got):
            raise AssertionError(f"{name}: {len(got)} outputs, or non-finite ones")
        share, compared, total = 0.0, 0, 0
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or not np.isfinite(g).all():
                raise AssertionError(f"{name}: predictor output shape {g.shape} (CPU "
                                     f"{w.shape}) or non-finite")
            n = None if want64 is None else resolved_rows(w, want64[i], SERVE_RTOL,
                                                          SERVE_ATOL)
            g, w = (a.reshape(len(a) if a.ndim > 1 else 1, -1) for a in (g, w))
            n = len(w) if n is None else n
            if n:
                share = max(share, gate_share(g[:n], w[:n], SERVE_RTOL, SERVE_ATOL))
            compared, total = compared + n, total + len(w)
        if not share <= 1.0:
            raise AssertionError(f"{name}: predict, card vs CPU past its gate (share {share})")
        lat = []
        for _ in range(3):
            t1 = time.perf_counter()
            pred.predict(requests, static=static)
            lat.append((time.perf_counter() - t1) * 1e3)
        paths["predict"] = launches
        vs_cpu = {"requests": n_cpu, "gate_share": share, "rows_compared": compared,
                  "rows": total,
                  "max_abs_err": max(float(np.abs(g - w).max()) for g, w in zip(got, want)),
                  "rtol": SERVE_RTOL, "atol": SERVE_ATOL}
        if want64 is not None:
            vs_cpu.update(resolved_share=ZOO_RESOLVED, cpu_f32_vs_f64=max(
                float(np.abs(w - w64).max()) for w, w64 in zip(want, want64)))
        out["predict"] = {"requests": N_REQUESTS, "kernel_launches": launches,
                          "vs_cpu": vs_cpu, "predict_ms": percentiles(lat)}
    elif serve is not None:
        out["forward"], paths["forward"] = serve(model, model_cpu)

    rows = slice(0, ZOO_GRAD_ROWS) if rows is None else rows
    out["grads_vs_cpu"], syncs = zoo_grad_gate(name, model, model_cpu, model64,
                                               take_rows(inputs, rows),
                                               take_rows(labels, rows), loss)
    if gate_syncs and syncs:
        raise AssertionError(f"{name}: its forward and backward made the host wait on the "
                             f"card {len(syncs)} times: {syncs[:3]}")
    out["host_syncs_forward_backward"] = len(syncs)

    step = make_train_step(model, loss=loss, lr=TRAIN_LR)
    first = {}

    def first_step():
        first["loss"], first["syncs"] = host_syncs(lambda: step(inputs, labels, 1.0))

    profile, launches = counted(lambda: profile_call(first_step, host=False))  # the main path
    expect_launches(f"{name}: one training step", launches,
                    forward=expected_step[0], backward=expected_step[1])
    paths["train_step"] = launches
    losses, step_ms = [float(first["loss"])], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(step(inputs, labels, 1.0))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: training losses not finite: {losses}")
    emit("zoo", **out, kernel_launches=launches, expected_launches=list(expected_step),
         host_syncs_per_step=len(first["syncs"]), losses=losses,
         train_step_ms=percentiles(step_ms),
         device_busy_ms=profile["device_busy_ms"],
         device_busy_share=profile["device_busy_share"],
         host_kernel_launches_per_step=profile["host_kernel_launches"],
         device_by_kernel=profile["top"][:5], seconds=time.perf_counter() - t0)
    return {f"zoo_{name}_{path}": counts for path, counts in paths.items()}


def attention_forward(inputs, rows, expected):
    """The attention model's request batch: one forward of ``rows`` rows of
    ``inputs`` on the card, its ``expected`` forward kernel launches, held
    against the same forward on the CPU on the rows whose keep masks agree;
    every entry whose mask differs must have its weight within
    ATTN_FLIP_RTOL of 1/L on both (a 3xTF32 round-off that moves it across
    the threshold).  Returns (its line, launches)."""

    def run(model, model_cpu):
        batch = take_rows(inputs, slice(0, rows))
        with torch.inference_mode():
            got, launches = counted(lambda: model(batch))
            expect_launches("attention: one forward", launches, forward=expected)
            _, w_card = model.attention_weights(batch)
            batch_cpu = to_device(batch, "cpu")
            want = model_cpu(batch_cpu)
            _, w_cpu = model_cpu.attention_weights(batch_cpu)
        w_card = w_card.cpu()
        length = w_card.shape[-1]
        flips = (w_card > 1.0 / length) != (w_cpu > 1.0 / length)
        for w in (w_card, w_cpu):
            near = (w[flips] - 1.0 / length).abs() <= ATTN_FLIP_RTOL / length
            if not near.all():
                raise AssertionError("attention: a keep mask differs between card and CPU "
                                     "at a weight not within "
                                     f"{ATTN_FLIP_RTOL} of 1/L: {w[flips][~near][:4]}")
        same = ~flips.any(dim=-1)
        got = got.cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"attention: output shape {tuple(got.shape)} or non-finite")
        torch.testing.assert_close(got[same], want[same], rtol=SERVE_RTOL, atol=SERVE_ATOL)
        line = {"rows": rows, "rows_whose_mask_differs": int((~same).sum()),
                "flipped_entries": int(flips.sum()),
                "flipped_weight_vs_1_over_L": (w_card[flips] * length - 1).abs().tolist()[:8],
                "kept_per_row": {"min": int((w_card > 1.0 / length).sum(-1).min()),
                                 "max": int((w_card > 1.0 / length).sum(-1).max())},
                "vs_cpu": {"max_abs_err": float((got[same] - want[same]).abs().max()),
                           "gate_share": gate_share(got[same], want[same], SERVE_RTOL,
                                                    SERVE_ATOL),
                           "rtol": SERVE_RTOL, "atol": SERVE_ATOL},
                "kernel_launches": launches}
        return line, launches

    return run


def agreeing_rows(make, inputs, n):
    """The first ZOO_GRAD_ROWS of ``n`` rows whose attention keep masks agree on
    the card and the CPU (same weights), as an index tensor."""
    model, model_cpu = make("cuda"), make("cpu")
    model_cpu.load_state_dict(model.state_dict())
    batch = take_rows(inputs, slice(0, n))
    with torch.inference_mode():
        _, w = model.attention_weights(batch)
        _, w_cpu = model_cpu.attention_weights(to_device(batch, "cpu"))
    length = w.shape[-1]
    agree = ((w.cpu() > 1.0 / length) == (w_cpu > 1.0 / length)).all(dim=-1)
    rows = torch.nonzero(agree).flatten()[:ZOO_GRAD_ROWS]
    if rows.numel() < ZOO_GRAD_ROWS:
        raise AssertionError(f"attention: only {rows.numel()} of {n} rows keep the same "
                             "states on card and CPU")
    return rows


def phase_zoo():
    """The model zoo on the card: every model string of the JAX harness's
    registry and every vector field, each through ``zoo_case``.  The NCDE
    models' field kernels launch 4(L-1) forward a layer a forward, and
    8(L-1) forward plus 4(L-1) backward a layer a step that the loss
    differentiates (the attention model's attention NCDE feeds only its
    keep mask: a forward alone); the plain models launch none and, for the
    recurrent ones, make the host wait on the card nowhere in a forward and
    backward."""
    from online_neural_cdes_tpu_torch import (GRUD, ODERNN, RNN, AttentionNeuralCDE,
                                              StackedNeuralCDE, prepare_gru_variant_data)
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    t_phase = time.perf_counter()
    paths = {}
    gen = lambda: torch.Generator().manual_seed(0)
    n = ZOO_NCDE_L - 1                    # linear intervals of the zoo's NCDE batch
    inputs, labels = train_batch("cuda", coeff_fn=linear_coeffs, length=ZOO_NCDE_L)
    serve_linear = {"coeff_fn": lambda device: linear_coeffs}

    def stacked(device, dtype=torch.float32):
        return StackedNeuralCDE(input_dim=C, hidden_dims=(H, H), output_dim=1,
                                hidden_hidden_dim=HH, static_dim=STATIC,
                                return_sequences=True, device=device, dtype=dtype,
                                generator=gen())

    paths.update(zoo_case(
        "stacked", "ncde-stacked", stacked, inputs, labels, "bce", (2 * 8 * n, 2 * 4 * n),
        serve=serve_linear, expected_serve=2 * 4 * (-(-MAX_LEN // LENGTH_MULTIPLE)
                                                    * LENGTH_MULTIPLE - 1),
        source="bench.py:451-482 widths, hidden_dims=(128, 128)",
        field_shapes=[[TRAIN_B, H, HH, C, 3], [TRAIN_B, H, HH, H, 3]]))

    def attention(device, dtype=torch.float32, use_sparsemax=False):
        return AttentionNeuralCDE(input_dim=C, hidden_dim=H, output_dim=1, static_dim=STATIC,
                                  sparsemax=use_sparsemax, device=device, dtype=dtype,
                                  generator=gen())

    one_label = labels[:, -1].contiguous()
    attn_step = (2 * 8 * n + 4 * n, 2 * 4 * n)
    paths.update(zoo_case(
        "attention", "ncde-attention", attention, inputs, one_label, "bce", attn_step,
        serve=attention_forward(inputs, N_REQUESTS, 3 * 4 * n),
        rows=agreeing_rows(attention, inputs, 2 * ZOO_GRAD_ROWS),
        source="bench.py:451-482 widths, statics in all three NCDEs, the JAX model's HH=15",
        field_shapes=[[TRAIN_B, H, ZOO_HH_ATTN, C, 3], [TRAIN_B, H, ZOO_HH_ATTN, H, 3]]))
    sparse_attn = attention("cuda", use_sparsemax=True)
    step = make_train_step(sparse_attn, loss="bce", lr=TRAIN_LR)
    loss, launches = counted(lambda: step(inputs, one_label, 1.0))
    expect_launches("attention with sparsemax: one training step", launches,
                    forward=attn_step[0], backward=attn_step[1])
    if not np.isfinite(float(loss)):
        raise AssertionError(f"attention with sparsemax: loss {float(loss)}")
    emit("zoo", model="attention_sparsemax", model_string="ncde-attention",
         kernel_launches=launches, loss=float(loss))
    paths["zoo_attention_sparsemax_train_step"] = launches
    del inputs, labels, one_label, sparse_attn, step

    # Config 4 (bench.py:409-448): the ODE-RNN and GRU-dt baselines, and
    # the other GRU variants on the same shapes with holes.
    x, labels, means = cfg4_batch()
    xh, labels_h, means_h = cfg4_batch(holes=True)
    labels, labels_h = (torch.from_numpy(v).cuda() for v in (labels, labels_h))

    def variant_serve(variant, m):
        def coeff_fn(device):
            md = torch.from_numpy(m).to(device)
            return lambda batch: prepare_gru_variant_data(batch, variant, md)
        return {"coeff_fn": coeff_fn, "pad_forward_fill": False, "accept_static": False}

    def odernn(device, dtype=torch.float32):
        return ODERNN(input_dim=C, hidden_dim=32, output_dim=CFG4_CLASSES,
                      hidden_hidden_dim=32, num_layers=2, device=device, dtype=dtype,
                      generator=gen())

    paths.update(zoo_case(
        "odernn", "odernn", odernn, torch.from_numpy(x).cuda(), labels, "ce", (0, 0),
        serve=variant_serve("gru", means), gate_syncs=True, source="bench.py:419-427",
        serve_inputs="prepare_gru_variant_data(requests, 'gru', means)"))
    width = {"gru": 1, "gru-intensity": 2, "gru-dt": 2, "gru-dt-intensity": 3}
    for variant in ("gru-dt", "gru-d", "gru", "gru-intensity", "gru-dt-intensity"):
        holes = variant != "gru-dt"
        data, m, lab = (xh, means_h, labels_h) if holes else (x, means, labels)
        prepared = prepare_gru_variant_data(torch.from_numpy(data).cuda(), variant,
                                            torch.from_numpy(m).cuda() if holes else None)
        if variant == "gru-d":
            def make(device, dtype=torch.float32):
                return GRUD(input_dim=C, hidden_dim=64, output_dim=CFG4_CLASSES,
                            feature_means=torch.from_numpy(means_h), device=device,
                            dtype=dtype, generator=gen())
        else:
            def make(device, dtype=torch.float32, k=width[variant]):
                return RNN(input_dim=C * k, hidden_dim=64, output_dim=CFG4_CLASSES,
                           device=device, dtype=dtype, generator=gen())
        paths.update(zoo_case(
            variant, variant, make, prepared, lab, "ce", (0, 0),
            serve=variant_serve(variant, m), gate_syncs=True,
            source="bench.py:429-431" if not holes else "bench.py:419 shapes, 30% NaN"))

    # The flagship with each other field: the plain field on the card, on
    # ZOO_FIELD_L observations.
    inputs, labels = train_batch("cuda", length=ZOO_FIELD_L)
    for kind, vf_type, sparsity, chaotic in ZOO_FIELDS:
        def make(device, dtype=torch.float32, k=kind, t=vf_type, s=sparsity):
            return flagship_model(device, dtype=dtype, vector_field=k, vector_field_type=t,
                                  sparsity=s)
        paths.update(zoo_case(
            f"ncde_{kind}_{vf_type}", "ncde", make, inputs, labels, "bce", (0, 0),
            serve={"coeff_fn": lambda device: rectilinear_coeffs}, steps=ZOO_FIELD_STEPS,
            resolve=chaotic, source="chip_smoke.py::flagship_model, the field changed"))
    emit("zoo", seconds=time.perf_counter() - t_phase)
    return paths


# ---------------------------------------------------------------- log-ODE


def logode_batch():
    """Config 6's raw batch as ``bench.py`` makes it: B series of L steps,
    C channels scaled by 0.1, time in channel 0, a label per series."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(LOGODE_B, LOGODE_L, LOGODE_C)).astype(np.float32) * 0.1
    x[:, :, 0] = np.arange(LOGODE_L) / LOGODE_L
    return x, (x[:, :, 1].sum(1) > 0).astype(np.float32)


def logode_model(input_dim, device):
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(input_dim=input_dim, hidden_dim=LOGODE_H, output_dim=1,
                     hidden_hidden_dim=LOGODE_H, num_layers=2, interpolation="linear",
                     return_sequences=False, adjoint=True, solver="rk4",
                     generator=torch.Generator().manual_seed(6), device=device)


def bce_grads(model, coeffs, labels):
    """Parameter gradients of the masked BCE of ``model(coeffs)``."""
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model.zero_grad(set_to_none=True)
    masked_temporal_loss(make_loss("bce"), model(coeffs), labels).backward()
    return {name: p.grad.detach().clone() for name, p in model.named_parameters()}


def phase_logode(device="cuda"):
    """The log-ODE NCDE of the JAX bench's config 6, nothing cut: the
    transform on the card against the CPU port's; the model's gradients on
    GRAD_ROWS rows against the CPU port's; one training step's launches
    (8 / 4 per knot interval: the forward solve and the adjoint's reverse
    stages), LOGODE_STEPS timed steps after one warm step, a profiled step
    and the peak memory; one step of the same NCDE on the raw series; the
    trained model's metrics on the batch (numpy, no scikit-learn)."""
    from online_neural_cdes_tpu_torch import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.data.loader import apply_logsig_transform
    from online_neural_cdes_tpu_torch.ops.logsig import logsignature_channels
    from online_neural_cdes_tpu_torch.training.loop import make_train_step
    from online_neural_cdes_tpu_torch.training.metrics import METRICS

    t_phase = time.perf_counter()
    x, labels_np = logode_batch()
    apply_logsig_transform(x[:2], LOGODE_DEPTH, LOGODE_WINDOW, device=device)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xl = apply_logsig_transform(x, LOGODE_DEPTH, LOGODE_WINDOW, device=device)
    transform_ms = (time.perf_counter() - t0) * 1e3
    xl_cpu = apply_logsig_transform(x, LOGODE_DEPTH, LOGODE_WINDOW, device="cpu")
    channels = logsignature_channels(LOGODE_C, LOGODE_DEPTH)
    knots = LOGODE_L // LOGODE_WINDOW + 1
    if xl.shape != (LOGODE_B, knots, channels) or not np.isfinite(xl).all():
        raise AssertionError(f"logsig transform: shape {xl.shape} or non-finite values")
    atol = LOGSIG_ATOL_REL * float(np.abs(xl_cpu).max())
    np.testing.assert_allclose(xl, xl_cpu, rtol=LOGSIG_RTOL, atol=atol)
    transform = {"shape": list(xl.shape), "ms": transform_ms,
                 "max_abs_err": float(np.abs(xl - xl_cpu).max()),
                 "gate_share": gate_share(xl, xl_cpu, LOGSIG_RTOL, atol),
                 "rtol": LOGSIG_RTOL, "atol_per_max": LOGSIG_ATOL_REL}

    labels = torch.from_numpy(labels_np).to(device)
    coeffs = linear_interpolation_coeffs(torch.from_numpy(xl).to(device))
    model = logode_model(channels, device)
    model_cpu = logode_model(channels, "cpu")
    model_cpu.load_state_dict(model.state_dict())
    got = bce_grads(model, coeffs[:GRAD_ROWS], labels[:GRAD_ROWS])
    want = bce_grads(model_cpu, coeffs[:GRAD_ROWS].cpu(), labels[:GRAD_ROWS].cpu())
    grads = grad_gate("log-ODE: ", got, want)

    intervals = knots - 1
    step = make_train_step(model, loss="bce", lr=LOGODE_LR)
    loss, launches = counted(lambda: step(coeffs, labels, 1.0))    # the main path
    expect_launches("one log-ODE step", launches, forward=8 * intervals,
                    backward=4 * intervals)
    losses, step_ms = [float(loss)], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LOGODE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(coeffs, labels, 1.0)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    profile = profile_call(lambda: step(coeffs, labels, 1.0), host=False)
    if not np.isfinite(losses).all():
        raise AssertionError(f"log-ODE losses not finite: {losses}")
    with torch.inference_mode():
        preds = model(coeffs).float().cpu().numpy()
    scores = {name: fn(preds, labels_np) for name, fn in METRICS.items()}
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"log-ODE metrics not finite: {scores}")
    emit("logode", source="bench.py:800-856", batch=LOGODE_B, length=LOGODE_L,
         channels=LOGODE_C, interpolation=f"logsig-{LOGODE_DEPTH}-{LOGODE_WINDOW}",
         transform=transform, knots=knots, shape=list(LOGODE_SHAPES[0]),
         grads_vs_cpu={"rows": GRAD_ROWS, **grads}, kernel_launches=launches,
         losses=losses, train_step_ms=percentiles(step_ms), peak_memory_mb=peak_mb,
         device_busy_ms=profile["device_busy_ms"],
         device_busy_share=profile["device_busy_share"], profile=profile,
         metrics=scores, seconds=time.perf_counter() - t_phase)

    # The same NCDE on the raw series: one step, counted and timed.
    t_part = time.perf_counter()
    raw = logode_model(LOGODE_C, device)
    raw_coeffs = linear_interpolation_coeffs(
        torch.from_numpy(x[:, :LOGODE_RAW_L]).to(device))
    raw_step = make_train_step(raw, loss="bce", lr=LOGODE_LR)
    t0 = time.perf_counter()
    raw_loss, raw_launches = counted(lambda: raw_step(raw_coeffs, labels, 1.0))
    raw_ms = (time.perf_counter() - t0) * 1e3
    expect_launches("one raw-series step", raw_launches, forward=8 * (LOGODE_RAW_L - 1),
                    backward=4 * (LOGODE_RAW_L - 1))
    if not np.isfinite(float(raw_loss)):
        raise AssertionError(f"raw-series loss not finite: {raw_loss}")
    emit("logode", path="raw_series", knots=LOGODE_RAW_L, shape=list(LOGODE_SHAPES[1]),
         kernel_launches=raw_launches, train_step_ms={"one_sample": raw_ms},
         step_ratio_raw_over_logsig=raw_ms / float(np.median(step_ms)),
         launch_ratio_raw_over_logsig=raw_launches["forward"] / launches["forward"],
         seconds=time.perf_counter() - t_part, phase_seconds=time.perf_counter() - t_phase)
    return {"logode_logsig_step": launches, "logode_raw_step": raw_launches}


# ----------------------------------------------------------- solver extras


def mse_input_cotangents(model, coeffs, labels):
    """The masked MSE's gradient with respect to the coefficients."""
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    coeffs = coeffs.detach().clone().requires_grad_()
    model.zero_grad(set_to_none=True)
    masked_temporal_loss(make_loss("mse"), model(coeffs), labels).backward()
    return coeffs.grad


def config3_model(device, solver, dtype=torch.float32):
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(input_dim=CFG3_C, hidden_dim=CFG3_H, output_dim=1,
                     hidden_hidden_dim=CFG3_H, num_layers=2, interpolation="hermite",
                     return_sequences=False, adjoint=False, solver=solver,
                     generator=torch.Generator().manual_seed(0), device=device,
                     dtype=dtype)


def phase_solver_extras(device="cuda"):
    """The rest of the solvers on config 3 (``bench.py:368-405``): each
    Adams method's forward and one training step (launches equal to the
    solver's nfe, backward too since autograd differentiates every field
    call; no host read for implicit_adams; gradients against the CPU
    port); ``scipy_solver`` forward on SCIPY_ROWS rows against the CPU;
    one differentiable ``odeint_event`` with the forward kernel as its field
    (event time, state and gradients against the CPU); a bf16 dopri5
    ``NeuralCDE``: one forward and one step, held to the CPU's bf16 on the
    card's step grid."""
    from online_neural_cdes_tpu_torch import odeint, odeint_event
    from online_neural_cdes_tpu_torch.ops import kernels, solvers
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    t_phase = time.perf_counter()
    _, coeffs, labels = config3(device)
    _, coeffs_cpu, labels_cpu = config3("cpu")
    paths = {}

    # -- the Adams methods ------------------------------------------------
    for method in ("explicit_adams", "implicit_adams"):
        t_part = time.perf_counter()
        model, model_cpu = config3_model(device, method), config3_model("cpu", method)
        model_cpu.load_state_dict(model.state_dict())
        model64 = config3_model("cpu", method, torch.float64)
        model64.load_state_dict({k: v.double() for k, v in model.state_dict().items()})
        with torch.inference_mode():
            out, launches, counts = solve_counted(lambda: model(coeffs))
            want, want64 = model_cpu(coeffs_cpu), model64(coeffs_cpu.double())
        nfe = counts["forward"]["nfe"]
        expect_launches(f"{method} forward", launches, forward=nfe)
        # Explicit Adams-Bashforth of order up to 12 at one step a knot is
        # unstable on config 3: it magnifies round-off until f32 no longer
        # decides some series (``cpu_f32_vs_f64_max`` in the line).
        # Each method is held on the series its CPU f32 resolves against
        # f64 (within ZOO_RESOLVED of the gate): outputs on those whose
        # outputs it resolves (at least half), gradients on the loss over
        # those whose input cotangents it resolves too (at least a quarter).
        keep = ((want - want64).abs() <= ZOO_RESOLVED * (
            SERVE_ATOL + SERVE_RTOL * want.abs())).all(-1)
        if int(keep.sum()) < CFG3_B // 2:
            raise AssertionError(f"{method}: the CPU's f32 resolves {int(keep.sum())} "
                                 f"of {CFG3_B} series")
        torch.testing.assert_close(out.cpu()[keep], want[keep], rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL)
        kept = lambda lab, rows: torch.where(rows.to(lab.device), lab,
                                             torch.full_like(lab, np.nan))
        shares = row_shares([mse_input_cotangents(model_cpu, coeffs_cpu,
                                                  kept(labels_cpu, keep))],
                            [mse_input_cotangents(model64, coeffs_cpu.double(),
                                                  kept(labels_cpu, keep).double())])
        grad_rows = keep & (torch.tensor(shares) <= ZOO_RESOLVED)
        if int(grad_rows.sum()) < CFG3_B // 4:
            raise AssertionError(f"{method}: the CPU's f32 resolves the gradients of "
                                 f"{int(grad_rows.sum())} of {CFG3_B} series")
        _, got = mse_grads(model, coeffs, kept(labels, grad_rows))
        _, want_g = mse_grads(model_cpu, coeffs_cpu, kept(labels_cpu, grad_rows))
        grads = grad_gate(f"{method}: ", got, want_g)
        step = make_train_step(model, loss="mse")
        t0 = time.perf_counter()
        loss, step_launches, step_counts = solve_counted(lambda: step(coeffs, labels, 1.0))
        step_ms = (time.perf_counter() - t0) * 1e3
        step_nfe = step_counts["forward"]["nfe"]
        expect_launches(f"{method} train step", step_launches, forward=step_nfe,
                        backward=step_nfe)
        reads = counts["forward"]["reads"] + step_counts["forward"]["reads"]
        if method == "implicit_adams" and reads:
            raise AssertionError(f"implicit_adams read the card {reads} times")
        if not np.isfinite(float(loss)):
            raise AssertionError(f"{method} loss not finite: {loss}")
        paths[f"{method}_train_step"] = step_launches
        emit("solver_extras", path=method, model="config3", batch=CFG3_B,
             kernel_launches={"forward_pass": launches, "train_step": step_launches},
             nfe=nfe, host_reads=reads, resolved_series=int(keep.sum()),
             cpu_f32_vs_f64_max=float((want - want64).abs().max()),
             vs_cpu={"max_abs_err": float((out.cpu()[keep] - want[keep]).abs().max()),
                     "gate_share": gate_share(out.cpu()[keep], want[keep], SERVE_RTOL,
                                              SERVE_ATOL)},
             grads_vs_cpu={"rows": int(grad_rows.sum()), **grads}, train_step_ms=step_ms,
             seconds=time.perf_counter() - t_part)

    # -- an Adams model as an exported artifact ----------------------------
    paths.update(adams_export_leg(device))

    # -- scipy_solver, forward only ---------------------------------------
    t_part = time.perf_counter()
    model, model_cpu = (config3_model(device, "scipy_solver"),
                        config3_model("cpu", "scipy_solver"))
    model_cpu.load_state_dict(model.state_dict())
    with torch.inference_mode():
        out, launches, counts = solve_counted(lambda: model(coeffs[:SCIPY_ROWS]))
        solvers.reset_counts()
        want = model_cpu(coeffs_cpu[:SCIPY_ROWS])
        cpu_counts = dict(solvers.COUNTS["forward"])
    expect_launches("scipy_solver forward", launches, forward=counts["forward"]["nfe"])
    torch.testing.assert_close(out.cpu(), want, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    emit("solver_extras", path="scipy_solver", model="config3", rows=SCIPY_ROWS,
         kernel_launches=launches, card=solve_stats(counts), cpu=cpu_counts,
         vs_cpu={"max_abs_err": float((out.cpu() - want).abs().max()),
                 "gate_share": gate_share(out.cpu(), want, SERVE_RTOL, SERVE_ATOL)},
         seconds=time.perf_counter() - t_part)

    # -- a differentiable event with the forward kernel as its field --------
    t_part = time.perf_counter()
    gen = torch.Generator().manual_seed(11)
    field = random_field(gen, CFG3_B, CFG3_H, CFG3_H, CFG3_C, 2, "cpu")
    trunk, head_w, head_b, z0, dx = field
    dx = dx * 0.3
    readout = torch.randn(CFG3_H, generator=gen) / CFG3_H ** 0.5

    def event_case(dev):
        """The field on ``dev`` with fresh leaves z0 and head_w (the event's
        args) that take gradients."""
        tr = [{k: v.to(dev) for k, v in layer.items()} for layer in trunk]
        hb, d, r = head_b.to(dev), dx.to(dev), readout.to(dev)
        z, hw = (t.detach().clone().to(dev).requires_grad_() for t in (z0, head_w))

        def f(t, y, args):
            return kernels.fused_matmul_field(tr, args, hb, y, d, CFG3_H, CFG3_C)

        return f, z, hw, r

    def level_of(dev):
        # A short dopri5 solve of the same field puts the level in reach.
        f, z, hw, r = event_case(dev)
        with torch.no_grad():
            ys = odeint(f, z, torch.tensor([0.0, 1.0]), hw, rtol=1e-5, atol=1e-7)
        return float(0.5 * ((ys[0] @ r).mean() + (ys[1] @ r).mean()))

    level = level_of("cpu")

    def event_run(dev):
        f, z, hw, r = event_case(dev)
        event_fn = lambda t, y: (y @ r).mean() - level
        solvers.reset_counts()
        t_event, y_event = odeint_event(f, z, 0.0, event_fn, hw, rtol=1e-5, atol=1e-7,
                                        bisection_iters=EVENT_BISECTIONS,
                                        differentiable=True)
        counts = dict(solvers.COUNTS["forward"])
        (t_event + 0.1 * y_event.mean()).backward()
        return t_event.detach(), y_event.detach(), z.grad, hw.grad, counts

    (t_g, y_g, dz_g, dw_g, counts), launches = counted(lambda: event_run(device))
    t_w, y_w, dz_w, dw_w, cpu_counts = event_run("cpu")
    resolve = 4 * EVENT_BISECTIONS
    # Forward: the solve's nfe, the re-solve and the Newton step's f (its
    # ``evals``); the backward: the Newton step's f's VJP and the re-solve's.
    expect_launches("differentiable event", launches,
                    forward=counts["nfe"] + counts["evals"], backward=resolve + 1)
    torch.testing.assert_close(t_g.cpu(), t_w, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    torch.testing.assert_close(y_g.cpu(), y_w, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    event_grads = grad_gate("event: ", {"z0": dz_g, "head_w": dw_g},
                            {"z0": dz_w, "head_w": dw_w})
    paths["event"] = launches
    emit("solver_extras", path="odeint_event", field="forward kernel, config 3 widths",
         batch=CFG3_B, event_time={"card": float(t_g), "cpu": float(t_w)},
         kernel_launches=launches, card=counts, cpu=cpu_counts,
         grads_vs_cpu=event_grads, seconds=time.perf_counter() - t_part)

    # -- a bf16 dopri5 NeuralCDE -----------------------------------------
    t_part = time.perf_counter()
    model = config3_model(device, "dopri5", torch.bfloat16)
    model_cpu = config3_model("cpu", "dopri5", torch.bfloat16)
    model_cpu.load_state_dict(model.state_dict())
    model_f32 = config3_model("cpu", "dopri5")
    model_f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    c16, c16_cpu = coeffs.bfloat16(), coeffs_cpu.bfloat16()
    steps = []
    with torch.inference_mode():
        with recording_steps(steps):
            out, launches, counts = solve_counted(lambda: model(c16))
        with following_steps(steps):
            want = model_cpu(c16_cpu)
        want32 = model_f32(c16_cpu.float())
    expect_evals("bf16 dopri5 forward", launches, counts)
    dist = float((want.float() - want32).abs().max())
    out_share = float((out.float().cpu() - want.float()).abs().max()) / dist
    if not out_share <= PREDICT_BF16_RATIO:
        raise AssertionError(f"bf16 dopri5 outputs: {out_share} of the CPU's "
                             "bf16-vs-f32 distance")
    steps = []
    with recording_steps(steps):
        _, got = mse_grads(model, c16, labels.bfloat16())
    with following_steps(steps):
        _, want_g = mse_grads(model_cpu, c16_cpu, labels_cpu.bfloat16())
    _, want32_g = mse_grads(model_f32, c16_cpu.float(), labels_cpu)
    shares = {name: float(torch.linalg.norm((got[name].float().cpu() - want_g[name].float()))
                          / torch.linalg.norm(want_g[name].float() - want32_g[name]))
              for name in want_g}
    worst = max(shares, key=shares.get)
    if not shares[worst] <= GRAD_BF16_RATIO:
        raise AssertionError(f"bf16 dopri5 gradient of {worst}: {shares[worst]} of the "
                             "CPU's bf16-vs-f32 distance")
    step = make_train_step(model, loss="mse")
    loss, step_launches, step_counts = solve_counted(
        lambda: step(c16, labels.bfloat16(), 1.0))
    expect_evals("bf16 dopri5 train step", step_launches, step_counts)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"bf16 dopri5 loss not finite: {loss}")
    paths["bf16_dopri5_train_step"] = step_launches
    emit("solver_extras", path="bf16_dopri5", model="config3", batch=CFG3_B,
         kernel_launches={"forward_pass": launches, "train_step": step_launches},
         card=solve_stats(counts), outputs_share_of_bf16_vs_f32=out_share,
         output_gate=PREDICT_BF16_RATIO, grad_shares_of_bf16_vs_f32=shares,
         grad_gate=GRAD_BF16_RATIO, loss=float(loss),
         seconds=time.perf_counter() - t_part, phase_seconds=time.perf_counter() - t_phase)
    return {f"solver_extras_{k}": v for k, v in paths.items()}


# -------------------------------------------------------------------- data


def split_digest(parts):
    """sha256 of a split: each part's length, then its indices as
    little-endian int64."""
    h = hashlib.sha256()
    for part in parts:
        h.update(np.int64(len(part)).tobytes())
        h.update(np.asarray(part).astype("<i8").tobytes())
    return h.hexdigest()


def data_model(device, seed):
    """The flagship on the MIMIC reduced schema's 7 statics."""
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(input_dim=C, hidden_dim=H, output_dim=1, static_dim=DATA_STATIC,
                     hidden_hidden_dim=HH, num_layers=N_LAYERS, interpolation="rectilinear",
                     solver="rk4", return_sequences=True,
                     generator=torch.Generator().manual_seed(seed), device=device)


@contextmanager
def timed_calls(module, name, seconds):
    """Within the block, each call of ``module.name`` adds its seconds to
    ``seconds[<its second argument, or name>]``."""
    original = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = original(*args, **kw)
        key = args[1] if name == "interpolate" else name
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, original)


def batch_to_card(batch):
    (static, temporal), labels = batch
    return ((torch.from_numpy(static).to("cuda"), torch.from_numpy(temporal).to("cuda")),
            torch.from_numpy(labels).to("cuda"))


def run_epoch(step, source, to_device=lambda batch: batch):
    """One pass of ``step`` over ``source``: the losses, and each step's
    milliseconds from asking for its batch to the card's completion of
    the step (``DeviceTimer``)."""
    from online_neural_cdes_tpu_torch.utils.profiling import DeviceTimer

    losses, step_ms, it = [], [], iter(source)
    while True:
        with DeviceTimer() as timer:
            batch = next(it, None)
            if batch is None:
                break
            inputs, labels = to_device(batch)
            loss = step(inputs, labels, 1.0)
            timer.sync(loss)
        losses.append(loss)
        step_ms.append(timer.elapsed * 1e3)
    return torch.stack(losses), step_ms


def same_bits(what, got_losses, got_model, want_losses, want_model):
    if not torch.equal(got_losses, want_losses):
        raise AssertionError(f"{what}: losses {got_losses.tolist()} differ from "
                             f"{want_losses.tolist()}")
    want = want_model.state_dict() if isinstance(want_model, torch.nn.Module) else want_model
    for name, p in got_model.state_dict().items():
        if not torch.equal(p, want[name]):
            raise AssertionError(f"{what}: parameter {name} differs, max "
                                 f"{float((p - want[name]).abs().max())}")


SEPSIS_CORPUS = {}   # the prepared corpus: made once a run, removed at exit


def sepsis_corpus(seconds=None):
    """The synthetic MIMIC corpus (DATA_PATIENTS patients, DATA_SEED)
    prepared for Sepsis under a temporary data root, made on the first call
    of a run (its stages timed into ``seconds``) and shared by the data and
    harness phases; returns (the data root, the processed file)."""
    from online_neural_cdes_tpu_torch.data import common, mimic

    if not SEPSIS_CORPUS:
        seconds = {} if seconds is None else seconds
        root = tempfile.mkdtemp(prefix="chip_smoke_sepsis_")
        atexit.register(shutil.rmtree, root, True)
        SEPSIS_CORPUS["root"] = root
        t0 = time.perf_counter()
        raw = mimic.synthesize_reduced_format(
            os.path.join(root, "reduced_format.npz"), num_patients=DATA_PATIENTS,
            n_features=DATA_FEATURES, seed=DATA_SEED)
        seconds["synthesize"] = time.perf_counter() - t0
        by_method = {}
        t0 = time.perf_counter()
        with timed_calls(common, "interpolate", by_method), \
                timed_calls(mimic, "save_processed", seconds):
            SEPSIS_CORPUS["path"] = mimic.prepare_task("Sepsis", raw, root)
        seconds["prepare_task"] = time.perf_counter() - t0
        seconds["interpolate"] = by_method
    return SEPSIS_CORPUS["root"], SEPSIS_CORPUS["path"]


def phase_data():
    """The MIMIC Sepsis task on the card through the data pipeline: a
    synthetic reduced-schema corpus prepared (all five interpolations, the
    ragged ones through the native library), loaded rectilinear with
    statics, batched, prefetched and trained one epoch, against the same
    epoch from plain copies (bit for bit); 3 steps, a checkpoint, 2 more,
    against a fresh model and Adam resumed from it (bit for bit); the
    corpus's stratified split against scikit-learn's digest; one step
    traced."""
    import glob

    from online_neural_cdes_tpu_torch.data import common, loader
    from online_neural_cdes_tpu_torch.data.prefetch import prefetch_to_device
    from online_neural_cdes_tpu_torch.training.loop import make_train_step
    from online_neural_cdes_tpu_torch.utils.checkpoint import (
        load_checkpoint, optimizer_state_like, save_checkpoint)
    from online_neural_cdes_tpu_torch.utils.profiling import (
        device_memory_mb, device_sync, trace)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        seconds = {}
        _, path = sepsis_corpus(seconds)
        t0 = time.perf_counter()
        train, val, test = loader.load_numpy_data(path, "rectilinear", use_static=True,
                                                  problem="online")
        seconds["load_numpy_data"] = time.perf_counter() - t0
        if (train.input_dim, train.static_dim, train.model_interpolation,
                train.return_sequences) != (C, DATA_STATIC, "rectilinear", True):
            raise AssertionError(f"loaded {train.input_dim}, {train.static_dim}, "
                                 f"{train.model_interpolation}, {train.return_sequences}")
        corpus = sum(len(d.temporal) for d in (train, val, test))

        # The split on the per-series max label: numpy, no scikit-learn.
        with np.load(path, allow_pickle=True) as npz:
            strat = np.array([np.asarray(lab).max() for lab in npz["labels"]])
        digest = split_digest(common.train_val_test_indices(len(strat), strat))
        if digest != SEPSIS_SPLIT_SHA256 or "sklearn" in sys.modules:
            raise AssertionError(f"Sepsis split digest {digest} (scikit-learn's: "
                                 f"{SEPSIS_SPLIT_SHA256}); sklearn imported: "
                                 f"{'sklearn' in sys.modules}")

        batches = loader.Batches(train, batch_size=DATA_B)
        host = list(batches)
        rows = [b[0][1].shape[1] for b in host]
        sizes = [b[1].shape[0] for b in host]
        if sizes[-1] != DATA_TAIL_B or any(n != DATA_B for n in sizes[:-1]):
            raise AssertionError(f"batch sizes {sizes}")
        intervals = sum(r - 1 for r in rows)
        expected = {"forward": 2 * 4 * intervals, "backward": 4 * intervals}
        card = [batch_to_card(b) for b in host]

        # Step-0 gradients: the card against the CPU port on 16 rows.
        model = data_model("cuda", 0)
        model_cpu = data_model("cpu", 0)
        model_cpu.load_state_dict(model.state_dict())
        inputs, labels = card[0]
        got = slice_grads(model, inputs, labels, GRAD_ROWS)
        want = slice_grads(model_cpu, tuple(t.cpu() for t in inputs), labels.cpu(), GRAD_ROWS)
        grads_vs_cpu = grad_gate("data: ", got, want)

        # One epoch from plain copies, then the same from prefetched batches.
        torch.cuda.reset_peak_memory_stats()
        plain = data_model("cuda", 0)
        (plain_losses, plain_ms), plain_launches = counted(
            lambda: run_epoch(make_train_step(plain, loss="bce", lr=TRAIN_LR), batches,
                              batch_to_card))
        expect_launches("data: one epoch from plain copies", plain_launches, **expected)
        pre = data_model("cuda", 0)
        pre_step = make_train_step(pre, loss="bce", lr=TRAIN_LR)
        (pre_losses, pre_ms), launches = counted(          # the main path
            lambda: run_epoch(pre_step, prefetch_to_device(batches, size=DATA_PREFETCH)))
        expect_launches("data: one prefetched epoch", launches, **expected)
        same_bits("data: prefetched epoch vs plain copies", pre_losses, pre, plain_losses,
                  plain)
        if not torch.isfinite(pre_losses).all():
            raise AssertionError(f"data: losses {pre_losses.tolist()}")
        peak_mb = device_memory_mb()

        # Resume: a checkpoint after DATA_RESUME_AT steps, then the rest.
        first = data_model("cuda", 0)
        first_step = make_train_step(first, loss="bce", lr=TRAIN_LR)
        head, tail = card[:DATA_RESUME_AT], card[DATA_RESUME_AT:]
        head_losses, _ = run_epoch(first_step, head)
        ckpt = save_checkpoint(os.path.join(tmp, "trainer_state"), {
            "model": first.state_dict(), "optimizer": first_step.optimizer.state_dict(),
            "best": {"loss": float(head_losses.min()), "step": DATA_RESUME_AT}})
        tail_losses, _ = run_epoch(first_step, tail)
        fresh = data_model("cuda", 1)
        fresh_step = make_train_step(fresh, loss="bce", lr=TRAIN_LR)
        restored = load_checkpoint(ckpt, {
            "model": fresh.state_dict(), "optimizer": optimizer_state_like(fresh_step.optimizer),
            "best": {"loss": 0.0, "step": 0}})
        fresh.load_state_dict(restored["model"])
        fresh_step.optimizer.load_state_dict(restored["optimizer"])
        if restored["best"] != {"loss": float(head_losses.min()), "step": DATA_RESUME_AT}:
            raise AssertionError(f"data: restored best {restored['best']}")
        resumed_losses, _ = run_epoch(fresh_step, tail)
        same_bits("data: resumed vs uninterrupted", resumed_losses, fresh, tail_losses, first)
        if not torch.equal(torch.cat([head_losses, tail_losses]), plain_losses):
            raise AssertionError("data: the checkpointed run's losses differ from the epoch's")

        # One step traced: the trace names the forward and backward kernels.
        inputs, labels = card[0]
        with trace(os.path.join(tmp, "trace")) as log_dir:
            device_sync(pre_step(inputs, labels, 1.0))
        files = glob.glob(os.path.join(log_dir, "*.json"))
        text = "".join(open(f).read() for f in files)
        named = {k: k in text for k in ("trunk_forward", "head_forward", "head_backward",
                                        "weight_grad", "trunk_backward")}
        if len(files) != 1 or not all(named.values()):
            raise AssertionError(f"data: trace files {files}, kernel names found {named}")
        profile = profile_call(lambda: pre_step(inputs, labels, 1.0), host=False)
        emit("data", corpus_after_exclusions=corpus,
             splits=[len(d.temporal) for d in (train, val, test)],
             seconds=seconds, padded_rows=rows, padded_labels=[b[1].shape[1] for b in host],
             batch_sizes=sizes, intervals=intervals, kernel_launches=launches,
             plain_copy_launches=plain_launches, expected_launches=expected,
             split_sha256=digest, grads_vs_cpu={"rows": GRAD_ROWS, **grads_vs_cpu},
             losses=pre_losses.tolist(), prefetch_bit_identical=True,
             resume_bit_identical=True, checkpoint_bytes=os.path.getsize(ckpt),
             train_step_ms={"prefetch": percentiles(pre_ms), "plain": percentiles(plain_ms)},
             epoch_ms={"prefetch": sum(pre_ms), "plain": sum(plain_ms)},
             device_memory_mb=peak_mb, trace={"bytes": len(text), "kernels_named": named},
             profile=profile, phase_seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"data_epoch_prefetch": launches, "data_epoch_plain_copies": plain_launches}


# ----------------------------------------------------------------- harness


def harness_suite(ckpt_dir, profile_dir):
    """The medical-sota suite's ncde leg on Sepsis (configurations.json5),
    hyperparameters set at the flagship's widths, two of its seeds, its
    epochs cut, the best weights kept under ``ckpt_dir`` and the second
    epoch traced into ``profile_dir``."""
    return {"hyperparameters": ["set"], "seed": list(HARNESS_SEEDS),
            "dataset_name": ["Sepsis"], "dataset": {"interpolation": ["rectilinear"]},
            "model": {"model_string": ["ncde"], "adjoint": [False],
                      "interpolation_eps": [None], "solver": ["rk4"], "hidden_dim": [H],
                      "hidden_hidden_dim": [HH], "num_layers": [N_LAYERS]},
            "trainer": {"lr": [HARNESS_LR], "max_epochs": [HARNESS_EPOCHS],
                        "checkpoint_dir": [ckpt_dir], "profile_dir": [profile_dir]}}


def split_intervals(data):
    """Knot intervals of each of a split's batches at HARNESS_B rows."""
    from online_neural_cdes_tpu_torch.data.loader import Batches

    return [b[0][1].shape[1] - 1 for b in Batches(data, HARNESS_B)]


@contextmanager
def probed_trainer(harness, steps, evals):
    """Within the block, each training step that ``harness.train`` takes is
    bracketed by CUDA events (no sync) and appended to ``steps`` as (start,
    end, its kernel launches), and each of its evaluations' launches to
    ``evals``; the launches are read from the wrappers' host counters."""
    make, evaluate = harness.make_train_step, harness._evaluate

    def since(before):
        return {key: n - before[key] for key, n in launch_counts().items()}

    def make_probed(*args, **kw):
        step = make(*args, **kw)

        def probed(*step_args):
            before = launch_counts()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(*step_args)
            end.record()
            steps.append((start, end, since(before)))
            return out

        probed.optimizer = step.optimizer
        return probed

    def evaluate_probed(*args, **kw):
        before = launch_counts()
        out = evaluate(*args, **kw)
        evals.append(since(before))
        return out

    harness.make_train_step, harness._evaluate = make_probed, evaluate_probed
    try:
        yield
    finally:
        harness.make_train_step, harness._evaluate = make, evaluate


def trace_busy(path):
    """The device's busy share of a ``torch.profiler`` Chrome trace: its
    kernels', copies' and memsets' time over the traced span (the first
    event's start to the last event's end)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    start = min(e["ts"] for e in events)
    span_us = max(e["ts"] + e.get("dur", 0) for e in events) - start
    busy_us = sum(e["dur"] for e in device)
    return {"span_ms": span_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if device else "not measured",
            "device_busy_share": busy_us / span_us if device else "not measured",
            "kernels": sum(e["cat"] == "kernel" for e in device)}


def phase_harness():
    """A configuration suite from the command line on the card: the
    medical-sota suite's ncde leg on the data phase's Sepsis corpus through
    ``run.main`` (two seeds, run one after another), its kernel launches
    against the batches' intervals (the whole suite, each epoch's steps and
    each evaluation), each step's time and the traced epoch's device share;
    a re-run that completes nothing and launches nothing; seed 222 again in
    an isolated child with the in-process run's test metrics to the bit;
    the best weights from the checkpoint served through
    ``predictor_from_bundle``, against the CPU; one training step's
    gradients at those weights against the CPU port."""
    import glob

    from online_neural_cdes_tpu_torch import run
    from online_neural_cdes_tpu_torch.data.loader import Batches
    from online_neural_cdes_tpu_torch.serving import predictor_from_bundle
    from online_neural_cdes_tpu_torch.training import config, harness, sweep
    from online_neural_cdes_tpu_torch.training.experiment import load_and_setup
    from online_neural_cdes_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    root, path = sepsis_corpus()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    try:
        ckpt, traces = os.path.join(tmp, "best"), os.path.join(tmp, "traces")
        config_dir = os.path.join(tmp, "configurations")
        os.makedirs(config_dir)
        shutil.copy(os.path.join(config.DEFAULT_CONFIG_DIR, "dataset.json5"), config_dir)
        with open(os.path.join(config_dir, "configurations.json5"), "w") as fh:
            json.dump({HARNESS_SUITE: harness_suite(ckpt, traces)}, fh)
        configs, _ = config.parse_configuration_json(HARNESS_SUITE, config_dir)
        cfg = configs[-1]

        # Seed 222 again, in a spawned child on the card, with its own
        # checkpoint and trace directories: started here, beside the
        # in-process suite (its first ~20 s start an interpreter and a CUDA
        # context), and joined before the phase ends (PR 18, for the run's
        # time).
        child_dir = os.path.join(tmp, "child")
        child_configs = os.path.join(child_dir, "configurations")
        os.makedirs(child_configs)
        shutil.copy(os.path.join(config.DEFAULT_CONFIG_DIR, "dataset.json5"), child_configs)
        with open(os.path.join(child_configs, "configurations.json5"), "w") as fh:
            json.dump({HARNESS_SUITE: harness_suite(os.path.join(child_dir, "best"),
                                                    os.path.join(child_dir, "traces"))}, fh)

        def isolated():
            t0 = time.perf_counter()
            out = sweep.run(HARNESS_SUITE, ledger_path=os.path.join(child_dir, "ledger.jsonl"),
                            data_root=root, config_dir=child_configs, shard_index=1,
                            num_shards=2, config_timeout_s=300)
            return out, time.perf_counter() - t0

        child_pool = ThreadPoolExecutor(max_workers=1)
        child_run = child_pool.submit(isolated)

        # The launches the batches call for: RK4 evaluates the field 4 times
        # an interval; a training step differentiates every evaluation
        # (autograd through the solve), an evaluation runs the forward; the
        # trainer probes its NFE on the first training batch once.
        bundle, (train, val, test) = load_and_setup(cfg, root)
        if bundle.device.type != "cuda":
            raise AssertionError(f"harness: the bundle lives on {bundle.device}")
        train_iv = split_intervals(train)
        eval_iv = [sum(split_intervals(d)) for d in (train, val, test)]
        per_epoch = {"forward": 4 * sum(train_iv), "backward": 4 * sum(train_iv)}
        per_eval = {"forward": 4 * eval_iv[1]}
        per_config = {
            "forward": 4 * train_iv[0] + HARNESS_EPOCHS * (per_epoch["forward"]
                                                         + per_eval["forward"])
            + 4 * sum(eval_iv),
            "backward": HARNESS_EPOCHS * per_epoch["backward"]}
        expected = {k: len(HARNESS_SEEDS) * v for k, v in per_config.items()}

        args = [HARNESS_SUITE, "--config-dir", config_dir, "--data-root", root,
                "--ledger", os.path.join(tmp, "ledger.jsonl")]
        steps, evals = [], []
        t0 = time.perf_counter()
        with probed_trainer(harness, steps, evals):
            completed, launches = counted(lambda: run.main(args))   # the main path
        suite_s = time.perf_counter() - t0
        expect_launches("harness: the suite", launches, **expected)
        n = len(train_iv)
        if len(steps) != len(HARNESS_SEEDS) * HARNESS_EPOCHS * n:
            raise AssertionError(f"harness: {len(steps)} training steps")
        epochs = [{key: sum(s[2][key] for s in steps[i:i + n]) for key, _ in COUNTED}
                  for i in range(0, len(steps), n)]
        for i, got in enumerate(epochs):
            expect_launches(f"harness: epoch {i}", got, **per_epoch)
        want_evals = len(HARNESS_SEEDS) * ([per_eval] * HARNESS_EPOCHS
                                           + [{"forward": 4 * k} for k in eval_iv])
        if len(evals) != len(want_evals):
            raise AssertionError(f"harness: {len(evals)} evaluations")
        for i, (got, want) in enumerate(zip(evals, want_evals)):
            expect_launches(f"harness: evaluation {i}", got, **want)
        step_ms = [start.elapsed_time(end) for start, end, _ in steps]
        if [c["seed"] for c, _ in completed] != list(HARNESS_SEEDS):
            raise AssertionError(f"harness: completed {[c for c, _ in completed]}")
        per_seed = {}
        for c, r in completed:
            if (r["epochs_run"] != HARNESS_EPOCHS or not np.isfinite(r["test.loss"])
                    or not 0.0 <= r["test.auc"] <= 1.0):
                raise AssertionError(f"harness: seed {c['seed']} gave {r}")
            per_seed[c["seed"]] = {k: r[k] for k in (
                "epochs_run", "best_epoch", "test.loss", "test.auc", "test.auprc",
                "num_params", "nfe_per_epoch", "time_per_epoch", "memory_usage")}
            per_seed[c["seed"]]["val_loss"] = [h["loss"] for h in r["history"]]
        own_traces = sorted(glob.glob(os.path.join(traces, f"trace-{os.getpid()}-*.json")))
        if len(own_traces) != len(HARNESS_SEEDS):
            raise AssertionError(f"harness: traces {own_traces}")
        for seed, f in zip(HARNESS_SEEDS, own_traces):
            per_seed[seed]["traced_epoch"] = trace_busy(f)
        inproc = completed[-1][1]
        again, rerun = counted(lambda: run.main(args))
        expect_launches("harness: the re-run", rerun)
        if again:
            raise AssertionError(f"harness: the re-run completed {len(again)} configs")

        # The best weights from the checkpoint, served.
        params = load_checkpoint(os.path.join(ckpt, "best_params"), bundle.model.state_dict())
        for k, v in params.items():
            if not torch.equal(v, inproc["best_params"][k]):
                raise AssertionError(f"harness: checkpointed {k} differs from best_params")
        with np.load(path, allow_pickle=True) as npz:
            idx = npz["test_idxs"][:HARNESS_REQUESTS]
            requests = [np.asarray(r, np.float32) for r in npz["temporal_data_raw"][idx]]
            static = npz["static_data"][idx].astype(np.float32)
        serve_kw = dict(coeff_fn=rectilinear_coeffs, batch_buckets=(1, HARNESS_CPU_REQUESTS,
                                                                     HARNESS_REQUESTS),
                        length_multiple=LENGTH_MULTIPLE)
        pred = predictor_from_bundle(bundle, params, **serve_kw)
        outs, serve_launches = counted(lambda: pred.predict(requests, static=static))
        padded = -(-max(len(r) for r in requests) // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
        expect_launches("harness: predict", serve_launches, forward=4 * (2 * padded - 2))
        bundle_cpu, _ = load_and_setup(cfg, root, device="cpu")
        params_cpu = {k: v.cpu() for k, v in params.items()}
        pred_cpu = predictor_from_bundle(bundle_cpu, params_cpu, **serve_kw)
        outs_cpu = pred_cpu.predict(requests[:HARNESS_CPU_REQUESTS],
                                    static=static[:HARNESS_CPU_REQUESTS])
        err = share = 0.0
        for r, g, c in zip(requests, outs, outs_cpu):
            if g.shape != (len(r), 1) or not np.isfinite(g).all():
                raise AssertionError(f"harness: served shape {g.shape} or non-finite")
            np.testing.assert_allclose(g, c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
            err = max(err, float(np.abs(g - c).max()))
            share = max(share, gate_share(g, c, SERVE_RTOL, SERVE_ATOL))

        # A training step's gradients at the best weights, autograd through
        # the RK4 solve as the suite trains: the card against the CPU port on
        # GRAD_ROWS rows of the first batch of HARNESS_B.
        inputs, labels = next(iter(Batches(train, HARNESS_B)))
        bundle.model.load_state_dict(params)
        bundle_cpu.model.load_state_dict(params_cpu)
        got, grad_launches = counted(lambda: slice_grads(
            bundle.model, bundle.prepare_batch(inputs), bundle.prepare_labels(labels),
            GRAD_ROWS))
        expect_launches("harness: the gradient rows", grad_launches,
                        forward=4 * train_iv[0], backward=4 * train_iv[0])
        want = slice_grads(bundle_cpu.model, bundle_cpu.prepare_batch(inputs),
                           bundle_cpu.prepare_labels(labels), GRAD_ROWS)
        grads_vs_cpu = grad_gate("harness: ", got, want)

        iso, child_s = child_run.result()
        child_pool.shutdown()
        if len(iso) != 1 or iso[0][0]["seed"] != HARNESS_SEEDS[1]:
            raise AssertionError(f"harness: the isolated run completed {iso}")
        child = iso[0][1]
        for key in ("test.loss", "test.auc", "test.auprc", "best_epoch"):
            if child[key] != inproc[key]:
                raise AssertionError(f"harness: isolated {key} {child[key]!r} against "
                                     f"{inproc[key]!r} in process")

        # What the export phase deploys from: the suite's config, the
        # checkpointed best weights (seed 222's, the suite's last) and seed
        # 111's best weights as a second checkpoint of the architecture.
        keep = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
        atexit.register(shutil.rmtree, keep, True)
        with open(os.path.join(keep, "config.json"), "w") as fh:
            json.dump(cfg, fh)
        shutil.copy(os.path.join(ckpt, "best_params.npz"), keep)
        save_checkpoint(os.path.join(keep, "other_params"), completed[0][1]["best_params"])
        deploy = {"config": os.path.join(keep, "config.json"), "root": root, "corpus": path,
                  "checkpoint": os.path.join(keep, "best_params"),
                  "other": os.path.join(keep, "other_params")}
        emit("harness", suite=harness_suite("<tmp>", "<tmp>"), corpus_splits=[
                 len(d.temporal) for d in (train, val, test)],
             train_batch_intervals=train_iv, eval_intervals_by_split=eval_iv,
             launches=launches, expected_launches=expected,
             launches_per_epoch=epochs[0], launches_per_eval=evals[0],
             per_seed=per_seed, suite_seconds=suite_s, rerun_launches=rerun,
             rerun_completed=len(again),
             isolated={"seconds": child_s, "elapsed_time": child["elapsed_time"],
                       "test.loss": child["test.loss"], "test.auc": child["test.auc"],
                       "bit_identical": True},
             serve={"requests": len(requests), "padded_length": padded,
                    "launches": serve_launches, "vs_cpu": {
                        "requests": len(outs_cpu), "max_abs_err": err, "gate_share": share,
                        "rtol": SERVE_RTOL, "atol": SERVE_ATOL}},
             grads_vs_cpu={"rows": GRAD_ROWS, "launches": grad_launches, **grads_vs_cpu},
             train_step_ms={"all": percentiles(step_ms),
                            "untraced": percentiles([t for i, t in enumerate(step_ms)
                                                     if (i // n) % HARNESS_EPOCHS == 0])},
             phase_seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"harness": launches}, per_seed, deploy


def artifact_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def deploy_main(args):
    """``deploy.main(args)`` with its summary line captured; returns it."""
    import contextlib
    import io

    from online_neural_cdes_tpu_torch import deploy

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        deploy.main(args)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    summary["seconds"] = time.perf_counter() - t0
    return summary


_LIBRARY = []


def library_op():
    """The same kernel call registered through ``torch.library.Library``
    (no ``custom_op`` wrapper), only for the dispatch comparison."""
    from online_neural_cdes_tpu_torch.ops import kernels

    if not _LIBRARY:
        lib = torch.library.Library("oncde_smoke", "DEF")
        lib.define("field(Tensor z, Tensor dx, Tensor head_w, Tensor head_b, Tensor[] trunk, "
                   "int hidden_dim, int input_dim, str precision) -> Tensor")
        lib.impl("field", lambda z, dx, hw, hb, trunk, h, i, p: kernels._forward_kernel(
            kernels._unflat_trunk(trunk), hw, hb, z, dx, h, i, p), "CUDA")
        _LIBRARY.append(lib)
    return torch.ops.oncde_smoke.field.default


def op_dispatch_us():
    """Host microseconds a call, under inference mode, of the forward kernel
    at the serving shape (64, 128, 128, 21, 2) through the op
    ``oncde::fused_field_forward`` (a ``custom_op``), through the same call
    registered with ``torch.library.Library`` and through its ctypes
    wrapper called directly (the call before the op), alternating OP_CALLS
    calls of each five times; the medians."""
    from online_neural_cdes_tpu_torch.ops import kernels

    trunk, head_w, head_b, z, dx = random_field(torch.Generator().manual_seed(3), N_REQUESTS,
                                                H, HH, C, N_LAYERS, "cuda")
    flat = kernels._flat_trunk(trunk)
    lib_op = library_op()
    calls = {"op": lambda: kernels.fused_field_forward_op(z, dx, head_w, head_b, flat, H, C,
                                                          "float32"),
             "library_op": lambda: lib_op(z, dx, head_w, head_b, flat, H, C, "float32"),
             "wrapper": lambda: kernels._forward_kernel(trunk, head_w, head_b, z, dx, H, C)}
    samples = {name: [] for name in calls}
    with torch.inference_mode():
        for _ in range(5):
            for name, fn in calls.items():
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(OP_CALLS):
                    fn()
                samples[name].append((time.perf_counter() - t0) * 1e6 / OP_CALLS)
                torch.cuda.synchronize()
    return {name: float(np.median(v)) for name, v in samples.items()}


def phase_export(model, requests, static, outs, deploy):
    """The exported serving artifact on the card.  The flagship predictor's
    grid (buckets 1 and 64, lengths 64 and 128: 4 keys, 2 programs) exported, loaded
    with no model object and serving the 64 requests to the bit of the
    live ``Predictor`` (and of the predictor phase's outputs ``outs``),
    each ``predict`` with the live one's kernel launches; both timed over
    the same repeats.  The stepper at 64 streams with one catch-up block
    (K=8): 12 ticks and a 16-row ``step_many`` backlog to the bit of the
    live stepper, with its launches, and the ticks' times.  Then ``deploy``
    from the harness phase's checkpoint (``deploy``): ``--verify``
    (bit-exact), ``--update-params-only --verify`` to its other seed's
    checkpoint, that artifact's rows to the bit of a live
    ``predictor_from_bundle`` at those weights, and a bfloat16 export
    through its task-metric gate, each with one length bucket (the
    corpus's longest series rounded up); and :func:`op_dispatch_us`."""
    from online_neural_cdes_tpu_torch import OnlineNCDEStepper, Predictor
    from online_neural_cdes_tpu_torch.data.loader import pad_ragged
    from online_neural_cdes_tpu_torch.deploy import serving_coeff_fn
    from online_neural_cdes_tpu_torch.serving import predictor_from_bundle
    from online_neural_cdes_tpu_torch.serving_export import (
        export_predictor, export_stepper, load_predictor, load_stepper,
    )
    from online_neural_cdes_tpu_torch.training.experiment import load_and_setup
    from online_neural_cdes_tpu_torch.utils.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        # The flagship predictor, at EXPORT_LENGTH_MULTIPLE.
        pred = Predictor(model, coeff_fn=rectilinear_coeffs, batch_buckets=(1, N_REQUESTS),
                         length_multiple=EXPORT_LENGTH_MULTIPLE, device="cuda")
        path = os.path.join(tmp, "predictor")
        t0 = time.perf_counter()
        n_modules = export_predictor(pred, path, channels=C, max_length=MAX_LEN,
                                     static_dim=STATIC)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_predictor(path)
        load_s = time.perf_counter() - t0
        padded_len = -(-MAX_LEN // EXPORT_LENGTH_MULTIPLE) * EXPORT_LENGTH_MULTIPLE
        expected = 4 * (2 * padded_len - 2)
        first_s = time.perf_counter()
        loaded.predict(requests, static=static)      # the module's first call
        first_s = time.perf_counter() - first_s
        live_outs, live_launches = counted(lambda: pred.predict(requests, static=static))
        art_outs, art_launches = counted(lambda: loaded.predict(requests, static=static))
        expect_launches("export: the live predict", live_launches, forward=expected)
        expect_launches("export: the loaded predict", art_launches, forward=expected)
        for i, (a, b, o) in enumerate(zip(art_outs, live_outs, outs)):
            if not (np.array_equal(a, b) and np.array_equal(a, o)):
                raise AssertionError(f"export: request {i} served {np.abs(a - b).max()} "
                                     "from the live predictor")
        lat = {"live": [], "loaded": []}
        for _ in range(EXPORT_REPS):
            for name, p in (("live", pred), ("loaded", loaded)):
                t0 = time.perf_counter()
                p.predict(requests, static=static)
                lat[name].append((time.perf_counter() - t0) * 1e3)
        profiles = {name: profile_call(lambda p=p: p.predict(requests, static=static),
                                       host=False)
                    for name, p in (("live", pred), ("loaded", loaded))}

        op_dispatch = op_dispatch_us()

        # The stepper: 12 ticks and a 16-row backlog through blocks of 8.
        x = pad_ragged(requests, target_len=MAX_LEN)
        stepper = OnlineNCDEStepper(model, static=static, device="cuda")
        spath = os.path.join(tmp, "stepper")
        t0 = time.perf_counter()
        n_step_modules = export_stepper(stepper, spath, batch_sizes=(N_REQUESTS,),
                                        channels=C, block_sizes=(EXPORT_BLOCK,))
        step_export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lstep = load_stepper(spath, static=static)
        step_load_s = time.perf_counter() - t0
        backlog = np.ascontiguousarray(np.swapaxes(
            x[:, EXPORT_TICKS + 1:EXPORT_TICKS + 1 + EXPORT_BACKLOG], 0, 1))
        lstep.precompile()

        def stream(s, ticks_ms):
            state = s.init(x[:, 0])
            ys = [s.readout(state["z"])]
            for k in range(1, EXPORT_TICKS + 1):
                t0 = time.perf_counter()
                state, y = s.step(state, x[:, k])
                torch.cuda.synchronize()
                ticks_ms.append((time.perf_counter() - t0) * 1e3)
                ys.append(y)
            state, many = s.step_many(state, backlog)
            return torch.cat([torch.stack(ys), many]), state

        live_ticks, art_ticks = [], []
        (live_ys, live_state), live_stream = counted(lambda: stream(stepper, live_ticks))
        (art_ys, art_state), art_stream = counted(lambda: stream(lstep, art_ticks))
        want_stream = 8 * (EXPORT_TICKS + EXPORT_BACKLOG)
        expect_launches("export: the live stream", live_stream, forward=want_stream)
        expect_launches("export: the loaded stream", art_stream, forward=want_stream)
        if not (torch.equal(art_ys, live_ys) and torch.equal(art_state["z"], live_state["z"])
                and torch.equal(art_state["last_obs"], live_state["last_obs"])):
            raise AssertionError("export: the loaded stepper's rows differ from the live "
                                 f"stepper's by {float((art_ys - live_ys).abs().max())}")

        # deploy from the harness phase's checkpoint.
        # One length bucket, the corpus's longest series rounded up (the
        # flagship's grid above has seven; cut for the run's time).
        cfg = deploy["config"]
        with np.load(deploy["corpus"], allow_pickle=True) as npz:
            longest = max(len(r) for r in npz["temporal_data_raw"])
        deploy_len = -(-longest // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
        base = ["--config", cfg, "--data-root", deploy["root"], "--batch-buckets",
                f"1,{N_REQUESTS}", "--length-multiple", str(deploy_len)]
        out = os.path.join(tmp, "deploy")
        verify = deploy_main(base + ["--checkpoint", deploy["checkpoint"], "--out", out,
                                     "--verify"])
        roll = deploy_main(base + ["--checkpoint", deploy["other"], "--out", out,
                                   "--update-params-only", "--verify"])
        out16 = os.path.join(tmp, "deploy_bf16")
        bf16 = deploy_main(base + ["--checkpoint", deploy["checkpoint"], "--out", out16,
                                   "--params-dtype", "bfloat16", "--verify"])
        if verify["verified"] != "bit-exact" or roll["verified"] != "bit-exact":
            raise AssertionError(f"export: deploy --verify gave {verify}, the roll {roll}")
        if not bf16.get("metric_gate", {}).get("metrics"):
            raise AssertionError(f"export: the bf16 deploy reported no metric gate: {bf16}")
        # The rolled artifact against a live predictor at the other weights.
        with open(cfg) as fh:
            config = json.load(fh)
        bundle, _ = load_and_setup(config, deploy["root"])
        other = load_checkpoint(deploy["other"], bundle.model.state_dict())
        live = predictor_from_bundle(bundle, other, coeff_fn=serving_coeff_fn(
            config["dataset"]["interpolation"]), batch_buckets=(1, N_REQUESTS),
            length_multiple=deploy_len)
        with np.load(deploy["corpus"], allow_pickle=True) as npz:
            idx = npz["test_idxs"][:HARNESS_REQUESTS]
            rows = [np.asarray(r, np.float32) for r in npz["temporal_data_raw"][idx]]
            rows_static = npz["static_data"][idx].astype(np.float32)
        rolled = load_predictor(out)
        padded = -(-max(len(r) for r in rows) // deploy_len) * deploy_len
        live_rows, live_roll = counted(lambda: live.predict(rows, static=rows_static))
        art_rows, art_roll = counted(lambda: rolled.predict(rows, static=rows_static))
        for what, got in (("live", live_roll), ("rolled", art_roll)):
            expect_launches(f"export: the {what} predict at the other weights", got,
                            forward=4 * (2 * padded - 2))
        if not all(np.array_equal(a, b) for a, b in zip(art_rows, live_rows)):
            raise AssertionError("export: the rolled artifact's rows differ from the live "
                                 "predictor's at the same weights")
        card = card_line()
        emit("export", card=card, modules=n_modules, export_seconds=export_s,
             load_seconds=load_s, first_call_seconds=first_s,
             artifact_bytes=artifact_bytes(path),
             params_bytes=os.path.getsize(os.path.join(path, "params.npz")),
             launches={"live": live_launches["forward"], "loaded": art_launches["forward"]},
             expected_launches=expected, bit_identical=True,
             predict_ms={name: percentiles(v) for name, v in lat.items()},
             profile=profiles, op_dispatch_us=op_dispatch,
             stepper={"modules": n_step_modules, "export_seconds": step_export_s,
                      "load_seconds": step_load_s, "artifact_bytes": artifact_bytes(spath),
                      "streams": N_REQUESTS, "ticks": EXPORT_TICKS,
                      "backlog": EXPORT_BACKLOG, "block": EXPORT_BLOCK,
                      "launches": {"live": live_stream["forward"],
                                   "loaded": art_stream["forward"]},
                      "bit_identical": True,
                      "tick_ms": {"live": percentiles(live_ticks),
                                  "loaded": percentiles(art_ticks)}},
             deploy={"verify": verify, "update_params_only": roll, "bfloat16": bf16,
                     "rolled_vs_live": {"requests": len(rows), "padded_length": padded,
                                        "launches": art_roll["forward"],
                                        "bit_identical": True},
                     "artifact_bytes": {"float32": artifact_bytes(out),
                                        "bfloat16": artifact_bytes(out16)}},
             phase_seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"export_predict": art_launches, "export_stream": art_stream,
            "export_rolled_predict": art_roll}


# The export phase runs in a process of its own beside the wave phase (for
# the run's time); EXPORT_TIMEOUT_S bounds its wait.
EXPORT_TIMEOUT_S = 600


def export_start(model, requests, static, outs, deploy):
    """Start :func:`export_worker` (spawned) on the predictor phase's
    weights, requests, statics and outputs and the harness phase's
    checkpoint; returns the handle :func:`export_finish` joins."""
    import torch.multiprocessing as tmp

    out = tempfile.mkdtemp(prefix="chip_smoke_export_run_")
    spec_file = os.path.join(out, "spec.pt")
    torch.save({"state": {k: v.cpu() for k, v in model.state_dict().items()},
                "requests": requests, "static": static, "outs": outs, "deploy": deploy},
               spec_file)
    return {"ctx": tmp.spawn(export_worker, args=(spec_file,), nprocs=1, join=False),
            "boot": {"world": 1}, "out": out}


def export_worker(rank, spec_file):
    """The export phase (:func:`phase_export`) in a process of its own on
    the flagship model with the predictor phase's weights; its launches
    and the lines it printed saved to ``rank0.pt`` beside ``spec_file``
    (the parent prints them when it joins).  An exception ends the process
    nonzero, its lines on stderr."""
    import contextlib
    import io

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_file, weights_only=False)
    model = flagship_model("cuda")
    model.load_state_dict(spec["state"])
    SHARED_CARD.append("the wave phase and the parallel phase's ranks")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            launches = phase_export(model, spec["requests"], spec["static"], spec["outs"],
                                    spec["deploy"])
    except BaseException:
        sys.stderr.write(buf.getvalue())
        raise
    torch.save({"launches": launches, "printed": buf.getvalue()},
               os.path.join(os.path.dirname(spec_file), f"rank{rank}.pt"))


def export_finish(handle):
    """Join :func:`export_worker`, print its lines and return its
    launches by path."""
    try:
        (result,) = par_join(handle, EXPORT_TIMEOUT_S)
    finally:
        shutil.rmtree(handle["out"], ignore_errors=True)
    sys.stdout.write(result["printed"])
    sys.stdout.flush()
    return result["launches"]


def wave_suites():
    """The wave phase's two suites: the harness's suite with medical-sota's
    three seeds (its checkpoint and profile keys dropped: a wave takes
    neither), and a search over trainer__lr of WAVE_TRIALS trials in one
    wave, one epoch each."""
    suite = harness_suite(None, None)
    suite["seed"] = list(WAVE_SEEDS)
    suite["trainer"] = {k: v for k, v in suite["trainer"].items()
                        if k not in ("checkpoint_dir", "profile_dir")}
    search = {**suite, "hyperparameters": ["hyperopt"], "seed": [9999],
              "total_trials": [WAVE_TRIALS], "wave_size": [WAVE_TRIALS],
              "parameterization": [[{"name": "trainer__lr", "type": "range",
                                     "bounds": [1e-4, 1e-2], "log_scale": True}]],
              "trainer": {"max_epochs": [1]}}
    return {WAVE_SUITE: suite, WAVE_SEARCH: search}


@contextmanager
def probed_wave(wave, calls, steps, evals):
    """Within the block, each wave that ``wave.run_trials_vmapped`` trains
    appends its lane count to ``calls``, each of its steps (start, end, its
    launches) to ``steps`` and each evaluation's launches to ``evals``, as
    :func:`probed_trainer` does for the serial trainer."""
    run, make, evaluate = wave.run_trials_vmapped, wave.make_wave_step, wave._wave_evaluate

    def since(before):
        return {key: n - before[key] for key, n in launch_counts().items()}

    def run_counted(cfgs, **kw):
        calls.append(len(cfgs))
        return run(cfgs, **kw)

    def make_probed(*args, **kw):
        optimizer, step = make(*args, **kw)

        def probed(*step_args):
            before = launch_counts()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(*step_args)
            end.record()
            steps.append((start, end, since(before)))
            return out

        return optimizer, probed

    def evaluate_probed(*args, **kw):
        before = launch_counts()
        out = evaluate(*args, **kw)
        evals.append(since(before))
        return out

    wave.run_trials_vmapped, wave.make_wave_step, wave._wave_evaluate = (
        run_counted, make_probed, evaluate_probed)
    try:
        yield
    finally:
        wave.run_trials_vmapped, wave.make_wave_step, wave._wave_evaluate = run, make, evaluate


@contextmanager
def first_wave_step(wave, box):
    """Within the block, the first step of the first wave that
    ``wave.run_trials_vmapped`` trains fills ``box``: the lanes' losses
    (K,), its launches, the solvers' counts it made (``solvers.COUNTS``'
    change over the step), the lanes' (nfe, accepted, rejected) of each of
    its K-lane forward solves (:func:`recording_lane_counts`' rows) and its
    CUDA-event ms."""
    from online_neural_cdes_tpu_torch.ops import solvers

    make = wave.make_wave_step

    def make_probed(*args, **kw):
        optimizer, step = make(*args, **kw)

        def probed(*step_args):
            if box:
                return step(*step_args)
            torch.cuda.synchronize()
            launches = launch_counts()
            counts = {kind: dict(c) for kind, c in solvers.COUNTS.items()}
            rows = []
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            with recording_lane_counts(rows):
                out = step(*step_args)
            end.record()
            end.synchronize()
            box.update(
                losses=out.detach().clone(),
                launches={key: n - launches[key] for key, n in launch_counts().items()},
                counts={kind: {key: n - counts.get(kind, {}).get(key, 0)
                               for key, n in c.items()}
                        for kind, c in solvers.COUNTS.items()},
                lane_counts=rows, event_ms=start.elapsed_time(end))
            return out

        return optimizer, probed

    wave.make_wave_step = make_probed
    try:
        yield box
    finally:
        wave.make_wave_step = make


def timed_steps(step, n):
    """``n`` calls of ``step`` after two warm-up calls: each call's host ms
    (the time to queue it, no sync) and CUDA-event ms, one call's launches,
    one call under the profiler (device busy ms and share, device kernels by
    name) and the peak device memory of one call."""
    for _ in range(2):
        step()
    host, device = [], []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    _, launches = counted(step)
    prof = profile_call(step)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return {"host_ms": percentiles(host), "event_ms": percentiles(device),
            "launches": launches, "device_busy_ms": prof["device_busy_ms"],
            "device_busy_share": prof["device_busy_share"], "wall_ms": prof["wall_ms"],
            "device_kernels": prof["top"], "host_top": prof["host_top"][:5],
            "peak_mb": torch.cuda.max_memory_allocated() / 2**20}


def mean_std_cells(table):
    """The cells of a table's non-float columns: each "-" or "mean $\\pm$
    std"; returns how many are mean +- std."""
    import re

    cell = re.compile(r"^-?\d+\.\d+ \$\\pm\$ \d+\.\d+$")
    n = 0
    for row in table.cells:
        for value, numeric in zip(row, table.numeric):
            if numeric:
                continue
            if value != "-" and not cell.match(value):
                raise AssertionError(f"wave: analysis cell {value!r} is not mean +- std")
            n += value != "-"
    return n


# ---------------------------------------------------------------------------
# Waves over the solvers (ROADMAP item 17c; the wave phase's solver legs)
# ---------------------------------------------------------------------------

# The wave phase's solver legs, each a K=3 seed wave (WAVE_SEEDS).  Through
# ``run_trials_vmapped`` for one epoch each, on the raw_data phase's
# synthetic BeijingPM2pt5 archive (RAW_TSR_CASES cases, L=24, 10 channels;
# batches of BEIJING_B, one a split: the suite's 512 raised for the run's
# time, each epoch's passes being bound by the K-lane controller's host
# work, not by rows) at the flagship's widths: the interval adjoint
# (rectilinear, paired; and linear), the hermite-dopri5 leg of the
# interpolation suite (configurations.json5) with and without the adjoint,
# and an ODE-RNN on dopri5.  Then one wave step beside the serial steps of
# its lanes' weights for three legs: (a) the harness leg with the adjoint
# (Sepsis, B=1,024, the first batch's 62 intervals), (b) hermite-dopri5 on
# the first Beijing batch, (c) the JAX bench's config 3 with the adjoint
# (``odeint_adjoint``): the batch's wave step launches only the multi
# entries, as reckoned; on its first GRAD_ROWS rows each lane's loss and
# gradients are held against the serial step of its weights at the train
# phase's gradient gate (both on the card; a K-replica launch groups the
# head's channels otherwise than a single one, ``head_forward_grid``, so
# the two round differently and a serial adaptive solve follows the lane's
# accepted steps); each lane's nfe / accepted / rejected on the batch
# against its serial solve's (equal expected, a flip printed); the wave's
# and each serial gradient step's wall and busy ms, under the device-only
# profiler.
BEIJING_B = 1024
SOLVER_WAVES = {
    "beijing-rectilinear-adjoint": ("rectilinear", {"adjoint": True, "solver": "rk4"}),
    "beijing-linear-adjoint": ("linear", {"adjoint": True, "solver": "rk4"}),
    "beijing-hermite-dopri5": ("hermite", {"adjoint": False, "solver": "dopri5"}),
    "beijing-hermite-dopri5-adjoint": ("hermite", {"adjoint": True, "solver": "dopri5"}),
    "beijing-odernn-dopri5": (None, {"model_string": "odernn", "adjoint": False,
                                     "solver": "dopri5"}),
}
ADJOINT_WAVE = "sepsis-ncde-adjoint-wave"
# The bfloat16 adaptive wave (ROADMAP item 17d): the hermite-dopri5 leg with
# trainer.compute_dtype "bfloat16", one epoch; its lanes' test losses (RMSE,
# ~75 on Beijing's PM2.5) within LOSS_BF16_REL of the float32 wave's (the
# card's lanes read 8.8e-4 to 2.1e-3 of the loss apart; the limit about
# five times the largest), and lane 0's first step's search (nfe /
# accepted / rejected) the serial bf16 step's on the same batch.
BF16_WAVE = "beijing-hermite-dopri5-bf16"
LOSS_BF16_REL = 1e-2
RAW_ROOT = {}   # the raw_data phase's processed BeijingPM2pt5, kept until exit


def solver_wave_suites():
    """The solver legs' suites (see SOLVER_WAVES) and the harness leg with
    the adjoint (leg a)."""
    out = {}
    for name, (interp, model) in SOLVER_WAVES.items():
        out[name] = {
            "hyperparameters": ["set"], "seed": list(WAVE_SEEDS),
            "dataset_name": [RAW_TSR_NAME],
            "dataset": {"interpolation": [interp], "batch_size": [BEIJING_B]},
            "model": {"model_string": ["ncde"], "interpolation_eps": [None],
                      "hidden_dim": [H], "hidden_hidden_dim": [HH],
                      "num_layers": [N_LAYERS], **{k: [v] for k, v in model.items()}},
            "trainer": {"max_epochs": [1]}}
    bf16 = json.loads(json.dumps(out["beijing-hermite-dopri5"]))
    bf16["trainer"]["compute_dtype"] = ["bfloat16"]
    out[BF16_WAVE] = bf16
    adjoint = harness_suite(None, None)
    adjoint["seed"] = list(WAVE_SEEDS)
    adjoint["model"]["adjoint"] = [True]
    adjoint["trainer"] = {"lr": [HARNESS_LR], "max_epochs": [1]}
    out[ADJOINT_WAVE] = adjoint
    return out


def beijing_root():
    """The data root holding the processed BeijingPM2pt5 archive: the
    raw_data phase's, or one built here from the same synthetic archive
    when that phase did not run."""
    if not RAW_ROOT:
        from online_neural_cdes_tpu_torch.data import builders

        root = tempfile.mkdtemp(prefix="chip_smoke_beijing_")
        atexit.register(shutil.rmtree, root, True)
        raw = os.path.join(root, "raw")
        write_tser(raw, RAW_TSR_NAME, RAW_TSR_CASES)
        builders.build_tsr(RAW_TSR_NAME, root=os.path.join(root, "processed"), raw_dir=raw)
        RAW_ROOT["processed"] = os.path.join(root, "processed")
    return RAW_ROOT["processed"]


def keep_beijing(processed_root):
    """The raw_data phase's processed BeijingPM2pt5 copied to a root that
    lives until exit, for the wave phase's solver legs."""
    root = tempfile.mkdtemp(prefix="chip_smoke_beijing_")
    atexit.register(shutil.rmtree, root, True)
    shutil.copytree(os.path.join(processed_root, "TSR"), os.path.join(root, "TSR"))
    RAW_ROOT["processed"] = root


def lane_loss_grads(bundle, states, prepared, labels, loss):
    """Each lane's loss and gradients as the wave's step takes them: one
    ``torch.func.vmap`` of the loss over the stacked weights and plain
    autograd of the losses' sum.  Returns (losses (K,), a gradient dict a
    lane)."""
    from online_neural_cdes_tpu_torch.training import wave
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model, pointwise = bundle.model, make_loss(loss)
    names = [n for n, _ in model.named_parameters()]
    stacked = wave._stack_states(states)
    params = {k: stacked[k].detach().requires_grad_() for k in names}
    buffers = {k: v for k, v in stacked.items() if k not in params}

    def lane(p, b):
        preds = torch.func.functional_call(model, (p, b), (prepared,))
        return masked_temporal_loss(pointwise, preds, labels, sqrt=loss == "rmse")

    losses = torch.func.vmap(lane)(params, buffers)
    grads = torch.autograd.grad(losses.sum(), list(params.values()))
    return losses.detach(), [{n: g[j].detach() for n, g in zip(names, grads)}
                             for j in range(len(states))]


def serial_loss_grads(bundle, state, prepared, labels, loss):
    """One lane's loss and gradients on its own (the serial step's)."""
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model = bundle.model
    params = {n: state[n].detach().clone().requires_grad_() for n, _ in
              model.named_parameters()}
    buffers = {k: v for k, v in state.items() if k not in params}
    preds = torch.func.functional_call(model, (params, buffers), (prepared,))
    value = masked_temporal_loss(make_loss(loss), preds, labels, sqrt=loss == "rmse")
    grads = torch.autograd.grad(value, list(params.values()))
    return value.detach(), {n: g.detach() for n, g in zip(params, grads)}


def lane_reckoning(counts):
    """The multi entries' launches that the solvers' K-lane counts reckon:
    every K-lane field evaluation one forward-multi launch; the replay's
    and the reverse solves' (not the reverse's one f(t_i, y_i) an output
    interval, ``lane_solves``) one backward-multi launch each too."""
    get = lambda kind, key: counts.get(kind, {}).get(key, 0)
    return {"forward_multi": sum(get(k, "lane_evals") for k in ("forward", "replay",
                                                                 "reverse")),
            "backward_multi": get("replay", "lane_evals") + get("reverse", "lane_evals")
            - get("reverse", "lane_solves")}


def lane_search(counts):
    """The K-lane controller's figures from the solvers' counts: attempts,
    device reads an attempt, lane-attempts that rode masked."""
    fwd = counts.get("forward", {})
    attempts = fwd.get("attempts", 0)
    return {"attempts": attempts, "wasted_lane_attempts": fwd.get("wasted", 0),
            "reads_per_attempt": fwd.get("reads", 0) / attempts if attempts else None,
            "lane_evals": {k: c.get("lane_evals", 0) for k, c in counts.items()}}


@contextmanager
def recording_lane_steps(steps):
    """Appends each lane's accepted steps of the K-lane solves run inside,
    in their order, to ``steps[j]`` (as :func:`recording_steps` does for a
    serial solve)."""
    from online_neural_cdes_tpu_torch.ops import solvers

    attempt = solvers._LaneController.attempt

    def recorded(lc, st, active, fits=False):
        accepted, fit = attempt(lc, st, active, fits)
        for j, step in enumerate(accepted):
            if step is not None:
                steps[j].append(step)
        return accepted, fit

    solvers._LaneController.attempt = recorded
    try:
        yield steps
    finally:
        solvers._LaneController.attempt = attempt


def lane_input_grads(bundle, states, inputs, labels, loss):
    """Each lane's loss, parameter gradients and input cotangents, every
    lane with its own copy of ``inputs`` and its own row of ``labels``
    (K, ...): one ``torch.func.vmap`` of the loss, plain autograd of the
    sum (the wave's step)."""
    from online_neural_cdes_tpu_torch.training import wave
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model, pointwise, k = bundle.model, make_loss(loss), len(states)
    names = [n for n, _ in model.named_parameters()]
    stacked = wave._stack_states(states)
    params = {n: stacked[n].detach().requires_grad_() for n in names}
    buffers = {n: v for n, v in stacked.items() if n not in params}
    single = isinstance(inputs, torch.Tensor)
    leaves = tuple(t.detach().unsqueeze(0).expand((k,) + tuple(t.shape)).clone()
                   .requires_grad_() for t in ((inputs,) if single else inputs))

    def lane(p, b, xs, lab):
        preds = torch.func.functional_call(model, (p, b), (xs[0] if single else tuple(xs),))
        return masked_temporal_loss(pointwise, preds, lab, sqrt=loss == "rmse")

    losses = torch.func.vmap(lane)(params, buffers, leaves, labels)
    grads = torch.autograd.grad(losses.sum(), [*params.values(), *leaves], allow_unused=True)
    n = len(names)
    return (losses.detach(),
            [{name: g[j].detach() for name, g in zip(names, grads[:n]) if g is not None}
             for j in range(k)],
            [tuple(None if g is None else g[j].detach() for g in grads[n:]) for j in range(k)])


@contextmanager
def recording_lane_counts(rows, kind="forward"):
    """Appends each lane's (nfe, accepted, rejected) of every K-lane solve
    of ``kind`` (``solvers.COUNTS``' kinds) run inside to ``rows``, one list
    of K a solve."""
    from online_neural_cdes_tpu_torch.ops import solvers

    count = solvers._LaneController.count

    def recorded(lc, st):
        if solvers._KIND[-1] == kind:
            rows.append([(int(st.nfe[j]), int(st.accepted[j]), int(st.rejected[j]))
                         for j in range(lc.k)])
        return count(lc, st)

    solvers._LaneController.count = recorded
    try:
        yield rows
    finally:
        solvers._LaneController.count = count


def profiled_counted(fn):
    """:func:`solve_counted` of ``fn`` as one call under the device-only
    profiler: (result, launches, solver counts, the call's wall ms, the
    card's busy ms and share)."""
    box = {}

    def run():
        box["out"] = solve_counted(fn)

    prof = profile_call(run, host=False)
    return (*box["out"], {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                               "device_busy_share")})


def lanes_against_serial(what, bundle, states, prepared, labels, loss, expect,
                         wave_step=None):
    """A wave of ``states`` against each lane's serial step.  The batch's
    gradient step (forward and backward) as one wave gives the launches
    (``expect(counts)``, 0 on the single entries) and its wall and busy ms,
    or ``wave_step`` (a wave run's first step on this batch from these
    states, :func:`first_wave_step`) gives them and its CUDA-event ms;
    each lane's serial gradient step on the batch gives its own, K of them
    beside the wave's.  An adaptive solve's nfe / accepted / rejected a
    lane on the batch against its serial solve's: equal expected, any flip
    printed.  On the batch's first GRAD_ROWS rows each lane's gradients
    are held against the serial step of its weights at the zoo's gate
    (:func:`zoo_grad_gate`'s rules: every tensor at the gradient gate, after
    up to ZOO_MAX_DROPPED rows whose input cotangents differ past theirs, a
    relu decision that a K-replica launch and a single one round to
    different sides, leave the loss, each printed); a serial adaptive solve
    follows the lane's own accepted steps (``following_steps``)."""
    k = len(states)
    if wave_step is None:
        lane_counts = []
        with recording_lane_counts(lane_counts):
            (losses, _), launches, counts, wave_time = profiled_counted(
                lambda: lane_loss_grads(bundle, states, prepared, labels, loss))
    else:
        losses, launches, counts, lane_counts = (
            wave_step[key] for key in ("losses", "launches", "counts", "lane_counts"))
        wave_time = {"event_ms": wave_step["event_ms"], "from": "the run's first step"}
    want = expect(counts)
    expect_launches(f"{what}: the wave step", launches, **want)
    serial_runs = [profiled_counted(lambda state=state: serial_loss_grads(
        bundle, state, prepared, labels, loss)) for state in states]
    adaptive = bool(lane_counts)
    flips, batch_counts = [], None
    if adaptive:
        batch_counts = []
        for j, run in enumerate(serial_runs):
            fwd = run[2]["forward"]
            row = {"nfe": [lane_counts[0][j][0], fwd["nfe"]],
                   "accepted": [lane_counts[0][j][1], fwd["accepted"]],
                   "rejected": [lane_counts[0][j][2], fwd["rejected"]]}
            if any(a != b for a, b in row.values()):
                flips.append({"lane": j, **row})
            batch_counts.append(row)
    busy = [run[3]["device_busy_ms"] for run in serial_runs]
    times = {"wave_step": wave_time, "serial_steps": [run[3] for run in serial_runs],
             "k_serial_wall_ms": sum(run[3]["wall_ms"] for run in serial_runs),
             "k_serial_busy_ms": (sum(busy) if all(isinstance(b, float) for b in busy)
                                  else "not measured")}

    rows = slice(0, GRAD_ROWS)
    sub = take_rows(prepared, rows)
    lane_labels = labels[rows].unsqueeze(0).repeat((k,) + (1,) * (labels.dim()))
    steps = [[] for _ in states]
    with recording_lane_steps(steps):
        _, got, got_in = lane_input_grads(bundle, states, sub, lane_labels, loss)

    def serial(j):
        from online_neural_cdes_tpu_torch.training.metrics import (
            make_loss, masked_temporal_loss,
        )

        model = bundle.model
        model.load_state_dict(states[j])
        model.zero_grad(set_to_none=True)
        single = isinstance(sub, torch.Tensor)
        leaves = tuple(t.detach().clone().requires_grad_()
                       for t in ((sub,) if single else sub))
        with following_steps(steps[j]) if adaptive else nullcontext():
            preds = model(leaves[0] if single else leaves)
            masked_temporal_loss(make_loss(loss), preds, lane_labels[j],
                                 sqrt=loss == "rmse").backward()
        return ({n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}, tuple(t.grad for t in leaves))

    lanes, dropped_by_lane = [], {}
    wants = [serial(j) for j in range(k)]
    for j, (w, w_in) in enumerate(wants):
        shares = row_shares(got_in[j], [None if t is None else t.cpu() for t in w_in])
        dropped = {r: s for r, s in enumerate(shares) if not s <= 1.0}
        if len(dropped) > ZOO_MAX_DROPPED:
            raise AssertionError(f"{what}: lane {j}: {len(dropped)} of {len(shares)} rows' "
                                 f"input cotangents differ past their gate: {dropped}")
        if dropped:
            lane_labels[j, list(dropped)] = float("nan")
            dropped_by_lane[j] = dropped
        lanes.append({"loss": [float(losses[j]), float(serial_runs[j][0][0])],
                      "serial_launches": serial_runs[j][1],
                      "input_cotangent_share": max(s for s in shares if s <= 1.0),
                      "dropped_rows": dropped})
    if dropped_by_lane:
        _, got, _ = lane_input_grads(bundle, states, sub, lane_labels, loss)
        for j in dropped_by_lane:
            wants[j] = serial(j)
    gates = []
    for j, (w, _) in enumerate(wants):
        w = {n: t.cpu() for n, t in w.items()}
        if set(got[j]) != set(w):
            raise AssertionError(f"{what}: lane {j}'s gradients reach {sorted(got[j])}, "
                                 f"its serial step's {sorted(w)}")
        per = {n: gate_share(got[j][n].cpu(), t, GRAD_RTOL,
                             GRAD_ATOL_REL * float(t.abs().max())) for n, t in w.items()}
        failed = {n: sh for n, sh in per.items() if not sh <= 1.0}
        if failed:
            raise AssertionError(f"{what}: lane {j}'s gradients past their gate: {failed}")
        gates.append(max(per.values()))
        lanes[j]["grad_gate_share"] = max(per.values())
    return {"launches": launches, "expected": want, "solver_counts": counts,
            "search": lane_search(counts), "grad_rows": GRAD_ROWS,
            "max_grad_gate_share": max(gates), "lanes": lanes, "times": times,
            "batch_counts_wave_serial": batch_counts, "count_flips": flips}


def solver_waves(config_dir, sepsis_root):
    """The wave phase's solver legs (see SOLVER_WAVES): each suite through
    ``run_trials_vmapped`` on the card for one epoch, then legs (a)-(c) a
    step each beside their serial steps.  Returns the launches by path."""
    from online_neural_cdes_tpu_torch.data.loader import Batches
    from online_neural_cdes_tpu_torch.ops import solvers
    from online_neural_cdes_tpu_torch.training import config, wave
    from online_neural_cdes_tpu_torch.training.experiment import load_and_setup

    root = beijing_root()
    paths, f32_results = {}, {}
    first_step = {}     # leg (b)'s wave step: the hermite-dopri5 run's first
    for name, (interp, model) in SOLVER_WAVES.items():
        t0 = time.perf_counter()
        cfgs, _ = config.parse_configuration_json(name, config_dir)
        bundle, (train, val, test) = load_and_setup(cfgs[0], root)
        with (first_wave_step(wave, first_step) if name == "beijing-hermite-dopri5"
              else nullcontext()):
            results, launches, counts = solve_counted(
                lambda: wave.run_trials_vmapped(cfgs, data_root=root))   # the main path
        if model.get("model_string") == "odernn":
            want = {}           # the plain field: no kernel
        elif model["solver"] == "rk4":
            def iv(data):
                return [b[0].shape[1] - 1 for b in Batches(data, BEIJING_B)]
            train_iv = iv(train)
            evals = sum(train_iv) + sum(iv(val)) + sum(iv(val)) + sum(iv(test))
            want = {"forward_multi": 4 * train_iv[0] + 8 * sum(train_iv) + 4 * evals,
                    "backward_multi": 4 * sum(train_iv)}
        else:
            want = lane_reckoning(counts)
        expect_launches(f"wave {name}", launches, **want)
        if len(results) != len(WAVE_SEEDS) or not all(
                np.isfinite(r["test.loss"]) and r["epochs_run"] == 1 for r in results):
            raise AssertionError(f"wave {name}: {results}")
        emit("wave", leg=name, run_trials_vmapped={
                 "lanes": len(results), "launches": launches, "expected": want,
                 "search": lane_search(counts),
                 "nfe": [r["nfe"] for r in results],
                 "test_loss": [r["test.loss"] for r in results],
                 "seconds": time.perf_counter() - t0})
        paths[f"wave_{name}"] = launches
        f32_results[name] = results
    paths.update(bf16_wave_leg(config_dir, root, f32_results["beijing-hermite-dopri5"]))

    # (a) The harness leg with the adjoint: B=1,024 on Sepsis, K=3.
    t0 = time.perf_counter()
    cfgs, _ = config.parse_configuration_json(ADJOINT_WAVE, config_dir)
    bundle, (train, _, _) = load_and_setup(cfgs[0], sepsis_root)
    inputs, labels = next(iter(Batches(train, HARNESS_B)))
    prepared, labels = bundle.prepare_batch(inputs), bundle.prepare_labels(labels)
    iv = split_intervals(train)[0]
    states = [bundle.init(s) for s in WAVE_SEEDS]
    leg = lanes_against_serial(
        "wave adjoint", bundle, states, prepared, labels, "bce",
        lambda counts: {"forward_multi": 8 * iv, "backward_multi": 4 * iv})
    for lane in leg["lanes"]:
        expect_launches("wave adjoint: a serial step", lane["serial_launches"],
                        forward=8 * iv, backward=4 * iv)
    emit("wave", leg="a_adjoint_step", batch=HARNESS_B, intervals=iv, **leg,
         seconds=time.perf_counter() - t0)
    paths["wave_adjoint_step"] = leg["launches"]

    # (b) hermite-dopri5 on the first Beijing batch, K=3: the wave step is
    # the hermite-dopri5 run's first (the same batch and initial weights).
    t0 = time.perf_counter()
    if not first_step:
        raise AssertionError("wave dopri5: the hermite-dopri5 run took no step")
    cfgs, _ = config.parse_configuration_json("beijing-hermite-dopri5", config_dir)
    bundle, (train, _, _) = load_and_setup(cfgs[0], root)
    inputs, labels = next(iter(Batches(train, BEIJING_B)))
    prepared, labels = bundle.prepare_batch(inputs), bundle.prepare_labels(labels)
    states = [bundle.init(s) for s in WAVE_SEEDS]
    leg = lanes_against_serial("wave dopri5", bundle, states, prepared, labels, "rmse",
                               lane_reckoning, wave_step=first_step)
    emit("wave", leg="b_dopri5_step", batch=BEIJING_B, **leg,
         seconds=time.perf_counter() - t0)
    paths["wave_dopri5_step"] = leg["launches"]
    paths.update(hermite_dopri5_deploy_leg(cfgs[0], states[0], root))

    # (c) config 3 with the adjoint (odeint_adjoint), K=3.
    t0 = time.perf_counter()
    model, coeffs, cfg3_labels = config3("cuda", adjoint=True)
    states = [config3_state(s) for s in WAVE_SEEDS]

    bundle = types.SimpleNamespace(model=model)   # the step helpers' view of a bundle
    leg = lanes_against_serial("wave odeint_adjoint", bundle, states, coeffs, cfg3_labels,
                               "mse", lane_reckoning)
    emit("wave", leg="c_odeint_adjoint_step", batch=CFG3_B, **leg,
         seconds=time.perf_counter() - t0)
    paths["wave_odeint_adjoint_step"] = leg["launches"]
    solvers.reset_counts()
    return paths


def bf16_wave_leg(config_dir, root, f32_results):
    """The bf16 adaptive wave (ROADMAP item 17d, BF16_WAVE) through
    ``run_trials_vmapped`` (the main path): only the multi entries launch,
    as the float32 leg reckons them from the K-lane counts; the training
    steps' launches all in bf16 storage and the rest (the evaluations and
    the NFE probe, at the float32 master weights as JAX's wave and the
    serial harness take them) in float32; each lane's test loss within
    LOSS_BF16_REL of the float32 wave's; lane 0's first step (its K-lane
    search on the batch) against the serial ``compute_dtype="bfloat16"``
    step of its weights on the same batch: the same nfe / accepted /
    rejected."""
    from online_neural_cdes_tpu_torch.data.loader import Batches
    from online_neural_cdes_tpu_torch.training import config, wave
    from online_neural_cdes_tpu_torch.training.experiment import load_and_setup
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    t0 = time.perf_counter()
    cfgs, _ = config.parse_configuration_json(BF16_WAVE, config_dir)
    steps, lane_counts = [], []
    t1 = time.perf_counter()
    with probed_wave(wave, [], steps, []), recording_lane_counts(lane_counts), \
            multi_launches_by_storage() as storage:
        results, launches, counts = solve_counted(
            lambda: wave.run_trials_vmapped(cfgs, data_root=root))   # the main path
    run_s = time.perf_counter() - t1
    want = lane_reckoning(counts)
    expect_launches("wave bf16", launches, **want)
    in_steps = {key: sum(s[2][key] for s in steps) for key in want}
    by_storage = {key: {"bfloat16": storage.get(f"{key}_bfloat16", 0),
                        "float32": storage.get(f"{key}_float32", 0)} for key in want}
    for key in want:
        if by_storage[key] != {"bfloat16": in_steps[key], "float32": want[key] - in_steps[key]}:
            raise AssertionError(f"wave bf16: {key} launches by storage {by_storage[key]}; "
                                 f"the steps made {in_steps[key]} of {want[key]}")
    if not in_steps["forward_multi"] or by_storage["backward_multi"]["float32"]:
        raise AssertionError(f"wave bf16: launches by storage {by_storage}")
    losses = [[r["test.loss"], f["test.loss"]] for r, f in zip(results, f32_results)]
    if len(results) != len(WAVE_SEEDS) or not all(
            np.isfinite(a) and abs(a - b) <= LOSS_BF16_REL * abs(b) for a, b in losses):
        raise AssertionError(f"wave bf16: test losses (bf16, f32) {losses}, "
                             f"limit {LOSS_BF16_REL} of the f32 loss")
    bundle, (train, _, _) = load_and_setup(cfgs[0], root)
    inputs, labels = next(iter(Batches(train, BEIJING_B)))
    bundle.model.load_state_dict(bundle.init(WAVE_SEEDS[0]))
    serial = make_train_step(bundle.model, loss=cfgs[0]["trainer"].get("loss_str", "bce"),
                             lr=1e-3, compute_dtype="bfloat16")
    t1 = time.perf_counter()
    _, serial_launches, serial_counts = solve_counted(lambda: serial(
        bundle.prepare_batch(inputs), bundle.prepare_labels(labels), 1.0))
    serial_s = time.perf_counter() - t1
    first = dict(zip(("nfe", "accepted", "rejected"), lane_counts[0][0]))
    serial_first = {key: serial_counts["forward"][key] for key in first}
    if first != serial_first:
        raise AssertionError(f"wave bf16: lane 0's first search {first}, the serial bf16 "
                             f"step's {serial_first}")
    emit("wave", leg="bf16_hermite_dopri5", run_trials_vmapped={
             "lanes": len(results), "launches": launches, "expected": want,
             "launches_by_storage": by_storage, "steps": len(steps),
             "search": lane_search(counts), "nfe": [r["nfe"] for r in results],
             "test_loss_bf16_f32": losses, "loss_limit_rel": LOSS_BF16_REL,
             "seconds": run_s},
         lane0_first_step={"wave": first, "serial_bf16": serial_first,
                           "serial_launches": serial_launches, "serial_seconds": serial_s},
         seconds=time.perf_counter() - t0)
    return {"wave_bf16_hermite_dopri5": launches}


# The wave's other corners (ROADMAP item 17d) on the card: K = 3 flagship
# fields (H = HH = 128, I = 21, two trunk layers, seeds CORNER_SEEDS; each
# lane its model's h0) on the flagship batch's linear spline (B = 512, 100
# observations), under ``torch.func.vmap``: each lane's own CORNER_T output
# times (seeded, sorted, spanning CORNER_WINDOW of the series' time from a
# start of its own), the differentiable dopri5 ``odeint`` and then
# ``odeint_adjoint`` (config 3's tolerances), forward and the gradient of a
# seeded weighting of the outputs with respect to the times and the weights;
# then an rk4 ``grid_constructor`` solve whose grid is CORNER_GRID points of
# each lane's span.  Each against every lane's serial solve on the card:
# the forward counts equal, outputs at the serving gate and gradients at the
# gradient gate (a K-replica launch groups the head's channels otherwise
# than a single one, so the two round differently; up to CORNER_MAX_DROPPED
# rows whose start cotangents differ past the gate, a relu decision the two
# take to different sides, leave the gradients, as in legs a-c; a decision
# that moves a weight's entries and not a start's leaves up to
# CORNER_MAX_FLIPS entries of a tensor past the gate, the tensor within
# GRAD_RTOL of its Frobenius norm), launches as reckoned.
# The adjoint's forward counts are held to the serial forward solve's and
# its gradients to the serial adjoint on the lane's own steps
# (``following_steps``): the weights' cotangent blocks in its reverse error
# norm let float32 round-off move reverse decisions (on the card: a
# lane's reverse nfe 1,258-1,252 against its serial solve's 1,324-1,228;
# on the CPU at 16 rows 1-8% apart, the gradients 5e-6 apart on one set of
# steps).  Two output times a lane, one reverse interval, for the run's
# time.
CORNER_SEEDS, CORNER_T, CORNER_WINDOW, CORNER_GRID = (0, 1, 2), 2, 1.0, 17
CORNER_MAX_DROPPED, CORNER_MAX_FLIPS = 8, 8
CORNER_RTOL, CORNER_ATOL = 1e-3, 1e-5


def corner_operands(device, rows=TRAIN_B):
    """The corner legs' spline, stacked h0 (K, rows, H) and packed field
    weights (K, ...), and each lane's output times (K, CORNER_T)."""
    from online_neural_cdes_tpu_torch.utils.tree import flatten

    inputs, _ = train_batch(device, coeff_fn=linear_coeffs)
    inputs = tuple(x[:rows] for x in inputs)
    models = [flagship_model(device, interpolation="linear", solver="dopri5", seed=seed)
              for seed in CORNER_SEEDS]
    with torch.no_grad():
        built = [m._setup_h0(inputs) for m in models]
        packed = [flatten(m.packed_field()) for m in models]
    rebuild = packed[0][1]
    weights = rebuild([torch.stack([p[0][i] for p in packed]).detach().contiguous()
                       for i in range(len(packed[0][0]))])
    rng = np.random.default_rng(41)
    k = len(CORNER_SEEDS)
    starts = rng.uniform(0.0, TRAIN_L - 1 - CORNER_WINDOW, size=(k, 1))
    fractions = np.sort(np.concatenate([np.zeros((k, 1)), np.ones((k, 1)),
                                        rng.uniform(size=(k, CORNER_T - 2))], 1), 1)
    times = torch.tensor(starts + CORNER_WINDOW * fractions, dtype=torch.float32,
                         device=device)
    return built[0][0], torch.stack([h for _, h in built]).detach(), weights, times


def serving_gate(what, got, want):
    """``par_gate`` at the serving gate, its readings named."""
    return dict(zip(("max_abs_err", "gate_share", "bit_identical"),
                    par_gate(what, got.cpu(), want.cpu(), SERVE_RTOL, SERVE_ATOL)))


def corner_legs(device="cuda", rows=TRAIN_B):
    """The corner legs (see CORNER_SEEDS).  Returns the launches by leg."""
    from online_neural_cdes_tpu_torch.ops import solvers
    from online_neural_cdes_tpu_torch.ops.cdeint import odeint_adjoint
    from online_neural_cdes_tpu_torch.ops.kernels import fused_matmul_field
    from online_neural_cdes_tpu_torch.utils.tree import flatten

    spline, z0, weights, times = corner_operands(device, rows)
    k = z0.shape[0]
    gen = torch.Generator().manual_seed(43)
    w = torch.randn((CORNER_T,) + tuple(z0.shape[1:]), generator=gen).to(device)

    def field(tt, z, p):
        return fused_matmul_field(p["trunk"], p["head_w"], p["head_b"], z,
                                  spline.derivative(tt), H, C)

    kw = dict(method="dopri5", rtol=CORNER_RTOL, atol=CORNER_ATOL)
    solves = {
        "odeint": lambda z, tt, p: solvers.odeint(field, z, tt, p,
                                                  options={"differentiable": True}, **kw),
        "odeint_adjoint": lambda z, tt, p: odeint_adjoint(field, z, tt, p, **kw)}

    def run(solve, z, tt, p, lanes, weight=w):
        """The outputs, and the gradients of the outputs weighted by
        ``weight`` (a lane's own, (K, ...), under vmap) with respect to
        the times, every weight and the starts (in that order)."""
        z, tt = (x.detach().requires_grad_() for x in (z, tt))
        leaves, rebuild = flatten(p)
        leaves = [x.detach().requires_grad_() for x in leaves]
        ys = (torch.func.vmap(solve) if lanes else solve)(z, tt, rebuild(leaves))
        grads = torch.autograd.grad((ys * weight).sum(), [tt, *leaves, z])
        return ys.detach(), [g.detach() for g in grads]

    def lane(j):
        return z0[j], times[j], flatten(weights)[1]([x[j] for x in flatten(weights)[0]])

    def flipped_rows(what, got, want):
        """The rows whose start cotangents differ past the gradient gate (a
        relu decision that a K-replica launch and a single one round to
        different sides: their gradients leave the comparison), at most
        CORNER_MAX_DROPPED."""
        rows_ = [r for r, sh in enumerate(row_shares([got], [want])) if not sh <= 1.0]
        if len(rows_) > CORNER_MAX_DROPPED:
            raise AssertionError(f"{what}: {len(rows_)} rows' start cotangents differ past "
                                 "their gate")
        return rows_

    paths = {}
    for name, solve in solves.items():
        t0 = time.perf_counter()
        forward, reverse, steps = [], [], [[] for _ in range(k)]
        with recording_lane_counts(forward), recording_lane_counts(reverse, "reverse"), \
                recording_lane_steps(steps):
            (ys, grads), launches, counts = solve_counted(
                lambda: run(solve, z0, times, weights, True))      # the main path
        want = lane_reckoning(counts)
        expect_launches(f"wave corners: {name} with each lane's times", launches, **want)
        lanes, serial, dropped = [], [], {}
        follow = bool(reverse)
        for j in range(k):
            if follow:
                # The adjoint: the serial forward solve's counts, then the
                # gradients on the lane's own steps (float32 round-off moves
                # the reverse decisions: see CORNER_SEEDS).
                with torch.no_grad():
                    _, serial_launches, serial_counts = solve_counted(lambda: solve(*lane(j)))
                with following_steps(steps[j]):
                    sy, sgrads = run(solve, *lane(j), False)
            else:
                (sy, sgrads), serial_launches, serial_counts = solve_counted(
                    lambda: run(solve, *lane(j), False))
            got = dict(zip(("nfe", "accepted", "rejected"), forward[0][j]))
            wanted = {key: serial_counts["forward"][key] for key in got}
            if got != wanted:
                raise AssertionError(f"wave corners: {name} lane {j} counts {got}, its serial "
                                     f"solve's {wanted}")
            entry = {"counts": got, "serial_launches": serial_launches}
            if follow:
                entry["reverse_counts"] = [int(sum(r[j][i] for r in reverse)) for i in range(3)]
                entry["followed_the_lanes_steps"] = True
            entry["outputs"] = serving_gate(f"wave corners: {name} lane {j} outputs", ys[j], sy)
            rows_ = flipped_rows(f"wave corners: {name} lane {j}", grads[-1][j],
                                 sgrads[-1].cpu())
            if rows_:
                dropped[j] = rows_
            lanes.append(entry)
            serial.append([sy, sgrads])
        if dropped:
            # The flipped rows' outputs weigh 0 in the lanes' and those
            # lanes' serial gradients, computed again.
            # (The reverse solves see the new weights: the serial ones follow
            # the lanes' steps of this run.)
            weight = w.expand((k,) + tuple(w.shape)).clone()
            for j, rows_ in dropped.items():
                weight[j][:, rows_] = 0.0
            steps = [[] for _ in range(k)]
            with recording_lane_steps(steps):
                _, grads = run(solve, z0, times, weights, True, weight)
            for j in dropped:
                with following_steps(steps[j]):
                    serial[j][1] = run(solve, *lane(j), False, weight[j])[1]
                lanes[j]["dropped_rows"] = dropped[j]
        for j, entry in enumerate(lanes):
            shares, past = [], []
            for i, (g, sg) in enumerate(zip(grads, serial[j][1])):
                what = f"wave corners: {name} lane {j} gradient {i}"
                got, want_ = g[j].cpu().double(), sg.cpu().double()
                atol = GRAD_ATOL_REL * float(want_.abs().max())
                over = int(((got - want_).abs() > GRAD_RTOL * want_.abs() + atol).sum())
                frob = float((got - want_).norm() / want_.norm().clamp_min(1e-30))
                if over > CORNER_MAX_FLIPS or not frob <= GRAD_RTOL:
                    raise AssertionError(f"{what}: {over} entries past the gradient gate "
                                         f"(at most {CORNER_MAX_FLIPS}), Frobenius distance "
                                         f"{frob} of its norm (at most {GRAD_RTOL})")
                shares.append(gate_share(got, want_, GRAD_RTOL, atol))
                past.append(over)
            entry.update(times_grad_gate_share=shares[0],
                         weights_grad_gate_share=max(shares[1:-1]),
                         starts_grad_gate_share=shares[-1], entries_past_the_gate=past)
        emit("wave", leg=f"corners_{name}_lane_times", batch=rows, lane_times=times.tolist(),
             launches=launches, expected=want, search=lane_search(counts), lanes=lanes,
             seconds=time.perf_counter() - t0)
        paths[f"wave_corners_{name}"] = launches

    t0 = time.perf_counter()

    def grid(f, y, tt):
        return torch.linspace(tt[0], tt[-1], CORNER_GRID, dtype=tt.dtype, device=tt.device)

    def rk4(z, tt, p):
        return solvers.odeint(field, z, tt, p, method="rk4", options={"grid_constructor": grid})

    with torch.no_grad():
        ys, launches, counts = solve_counted(lambda: torch.func.vmap(rk4)(z0, times, weights))
        expect_launches("wave corners: grid_constructor", launches,
                        forward_multi=4 * (CORNER_GRID - 1))
        lanes = []
        for j in range(k):
            sy, serial_launches, _ = solve_counted(lambda: rk4(*lane(j)))
            expect_launches(f"wave corners: grid_constructor lane {j}", serial_launches,
                            forward=4 * (CORNER_GRID - 1))
            lanes.append(serving_gate(f"wave corners: grid_constructor lane {j}", ys[j], sy))
    emit("wave", leg="corners_grid_constructor", batch=rows, grid_points=CORNER_GRID,
         launches=launches, lanes=lanes, seconds=time.perf_counter() - t0)
    paths["wave_corners_grid_constructor"] = launches
    return paths


def hermite_dopri5_deploy_leg(cfg, state, root):
    """The ``hermite-dopri5`` config's weights (a lane of leg b, kept with
    ``utils/checkpoint.py``) through ``deploy --verify`` on the card: its
    adaptive solve exported at the Beijing series' length (the Hermite
    build serves that length alone: ``exact_length`` in the manifest),
    loaded and held to the live predictor to the bit; the loaded artifact
    refuses a shorter request."""
    from online_neural_cdes_tpu_torch.serving_export import load_predictor
    from online_neural_cdes_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_dopri5_")
    try:
        ckpt = save_checkpoint(os.path.join(tmp, "best_params"), state)
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh)
        art = os.path.join(tmp, "art")
        summary, launches = counted(lambda: deploy_main([
            "--config", cfg_path, "--checkpoint", ckpt, "--out", art,
            "--data-root", root, "--batch-buckets", "8", "--verify"]))
        if summary.get("verified") != "bit-exact" or summary["shapes_exported"] != 1:
            raise AssertionError(f"wave hermite-dopri5 deploy: {summary}")
        with open(os.path.join(art, "manifest.json")) as fh:
            exact = json.load(fh).get("exact_length")
        if exact != summary["max_length"]:
            raise AssertionError(f"wave hermite-dopri5 deploy: exact_length {exact}, "
                                 f"the corpus length {summary['max_length']}")
        refusal = None
        try:
            load_predictor(art, device="cuda").predict(
                [np.zeros((exact // 2, summary["channels"]), np.float32)])
        except ValueError as exc:
            refusal = str(exc)
        if not refusal or f"exactly {exact} observations" not in refusal:
            raise AssertionError("wave hermite-dopri5 deploy: a request of "
                                 f"{exact // 2} observations was not refused ({refusal})")
        emit("wave", leg="hermite_dopri5_deploy", summary=summary, exact_length=exact,
             short_request_refused=True, kernel_launches=launches,
             seconds=time.perf_counter() - t0)
        return {"deploy_hermite_dopri5": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def config3_state(seed):
    """Config 3's weights drawn from ``seed`` (the lanes of leg c)."""
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(input_dim=CFG3_C, hidden_dim=CFG3_H, output_dim=1,
                     hidden_hidden_dim=CFG3_H, num_layers=2, interpolation="hermite",
                     return_sequences=False, adjoint=True, solver="dopri5",
                     generator=torch.Generator().manual_seed(seed),
                     device="cuda").state_dict()


def phase_wave(serial=None):
    """A suite's seeds as one wave on the card: the harness phase's suite
    with medical-sota's three seeds through ``run.main`` (co-scheduled: one
    wave of K=3), its kernel launches on the multi entries against the
    batches' intervals (the harness's reckoning, not K times it) and none
    on the single entries, its lanes 111 and 222 against the harness
    phase's serial runs (``serial``, or runs made here), a wave step's and a
    serial step's host and device times, busy share and peak memory on the
    first batch; then a search over trainer__lr whose four trials train as
    one wave of K=4, no trial failed, its best parameters in the ledger;
    then ``run.main --analyse --tables-out`` on both ledgers."""
    import glob

    from online_neural_cdes_tpu_torch import run
    from online_neural_cdes_tpu_torch.data.loader import Batches
    from online_neural_cdes_tpu_torch.training import analyse, config, hyperopt, sweep, wave
    from online_neural_cdes_tpu_torch.training.experiment import load_and_setup
    from online_neural_cdes_tpu_torch.training.ledger import Ledger
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    t_phase = time.perf_counter()
    root, _ = sepsis_corpus()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wave_")
    try:
        config_dir = os.path.join(tmp, "configurations")
        os.makedirs(config_dir)
        shutil.copy(os.path.join(config.DEFAULT_CONFIG_DIR, "dataset.json5"), config_dir)
        with open(os.path.join(config_dir, "configurations.json5"), "w") as fh:
            json.dump({**wave_suites(), **solver_wave_suites()}, fh)
        configs, _ = config.parse_configuration_json(WAVE_SUITE, config_dir)
        bundle, (train, val, test) = load_and_setup(configs[0], root)
        train_iv = split_intervals(train)
        eval_iv = [sum(split_intervals(d)) for d in (train, val, test)]

        def reckoned(epochs):
            """A wave's launches, the harness's reckoning of one config: the
            NFE probe on the first batch, every epoch's steps and validation,
            the three splits at the best weights; all on the multi entries."""
            return {"forward_multi": 4 * train_iv[0] + 4 * sum(eval_iv)
                    + epochs * 4 * (sum(train_iv) + eval_iv[1]),
                    "backward_multi": epochs * 4 * sum(train_iv)}

        ledger_path = os.path.join(tmp, "wave.jsonl")
        args = [WAVE_SUITE, "--config-dir", config_dir, "--data-root", root,
                "--ledger", ledger_path]
        calls, steps, evals = [], [], []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with probed_wave(wave, calls, steps, evals):
            completed, launches = counted(lambda: run.main(args))   # the main path
        suite_s = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if calls != [len(WAVE_SEEDS)]:
            raise AssertionError(f"wave: run_trials_vmapped called with {calls} lanes")
        expect_launches("wave: the suite", launches, **reckoned(HARNESS_EPOCHS))
        n = len(train_iv)
        if len(steps) != HARNESS_EPOCHS * n:
            raise AssertionError(f"wave: {len(steps)} steps")
        for i in range(HARNESS_EPOCHS):
            got = {key: sum(s[2][key] for s in steps[i * n:(i + 1) * n]) for key, _ in COUNTED}
            expect_launches(f"wave: epoch {i}", got, forward_multi=4 * sum(train_iv),
                            backward_multi=4 * sum(train_iv))
        want_evals = ([{"forward_multi": 4 * eval_iv[1]}] * HARNESS_EPOCHS
                      + [{"forward_multi": 4 * k} for k in eval_iv])
        if len(evals) != len(want_evals):
            raise AssertionError(f"wave: {len(evals)} evaluations")
        for i, (got, want) in enumerate(zip(evals, want_evals)):
            expect_launches(f"wave: evaluation {i}", got, **want)
        lanes = {c["seed"]: r for c, r in completed}
        if sorted(lanes) != sorted(WAVE_SEEDS):
            raise AssertionError(f"wave: completed seeds {sorted(lanes)}")
        for seed, r in lanes.items():
            if (r["epochs_run"] != HARNESS_EPOCHS or not np.isfinite(r["test.loss"])
                    or not 0.0 <= r["test.auc"] <= 1.0 or r["memory_usage"] is not None):
                raise AssertionError(f"wave: seed {seed} gave {r}")

        # Lanes against serial runs of the same configs.
        if serial is None:
            serial_runs = sweep.run(WAVE_SUITE, ledger_path=os.path.join(tmp, "serial.jsonl"),
                                    data_root=root, config_dir=config_dir, co_schedule=False,
                                    num_shards=len(WAVE_SEEDS), shard_index=0)
            serial_runs += sweep.run(WAVE_SUITE, ledger_path=os.path.join(tmp, "s1.jsonl"),
                                     data_root=root, config_dir=config_dir, co_schedule=False,
                                     num_shards=len(WAVE_SEEDS), shard_index=1)
            serial = {c["seed"]: {"val_loss": [h["loss"] for h in r["history"]],
                                  **{k: r[k] for k in ("best_epoch", "test.loss", "test.auc")}}
                      for c, r in serial_runs}
        vs_serial = {}
        for seed in WAVE_SEEDS[:2]:
            lane, ref = lanes[seed], serial[seed]
            if lane["best_epoch"] != ref["best_epoch"]:
                raise AssertionError(f"wave: seed {seed} best epoch {lane['best_epoch']} "
                                     f"against {ref['best_epoch']} serially")
            val = [h["loss"] for h in lane["history"]]
            np.testing.assert_allclose(val, ref["val_loss"], rtol=WAVE_RTOL)
            np.testing.assert_allclose(lane["test.loss"], ref["test.loss"], rtol=WAVE_RTOL)
            np.testing.assert_allclose(lane["test.auc"], ref["test.auc"], atol=WAVE_AUC_ATOL)
            vs_serial[seed] = {
                "val_loss_gate_share": gate_share(val, ref["val_loss"], WAVE_RTOL, 0.0),
                "test_loss": [lane["test.loss"], ref["test.loss"]],
                "test_auc": [lane["test.auc"], ref["test.auc"]]}

        # One wave step (K=3) and one serial step on the first training batch.
        inputs, labels = next(iter(Batches(train, HARNESS_B)))
        prepared, labels = bundle.prepare_batch(inputs), bundle.prepare_labels(labels)
        make_optimizer, wave_step = wave.make_wave_step(bundle, "bce")
        state = wave._stack_states([bundle.init(s) for s in WAVE_SEEDS])
        adam = make_optimizer(state)
        rates = [HARNESS_LR] * len(WAVE_SEEDS)
        wave_timed = timed_steps(lambda: wave_step(state, adam, prepared, labels, rates,
                                                   [10 * r for r in rates]), WAVE_STEPS)
        expect_launches("wave: one step", wave_timed["launches"],
                        forward_multi=4 * train_iv[0], backward_multi=4 * train_iv[0])
        bundle.model.load_state_dict(bundle.init(WAVE_SEEDS[0]))
        serial_step = make_train_step(bundle.model, loss="bce", lr=HARNESS_LR)
        serial_timed = timed_steps(lambda: serial_step(prepared, labels, 1.0), WAVE_STEPS)
        expect_launches("wave: one serial step", serial_timed["launches"],
                        forward=4 * train_iv[0], backward=4 * train_iv[0])

        # The search: its four trials as one wave of K=4.
        search_ledger = os.path.join(tmp, "search.jsonl")
        search_args = [WAVE_SEARCH, "--config-dir", config_dir, "--data-root", root,
                       "--ledger", search_ledger]
        calls = []
        t0 = time.perf_counter()
        with probed_wave(wave, calls, [], []):
            searched, search_launches = counted(lambda: run.main(search_args))
        search_s = time.perf_counter() - t0
        if calls != [WAVE_TRIALS]:
            raise AssertionError(f"wave: the search ran waves of {calls} lanes")
        expect_launches("wave: the search", search_launches, **reckoned(1))
        trials = Ledger(search_ledger).query(
            lambda e: e.get("run_name") == f"{WAVE_SEARCH}::trials")
        if len(trials) != WAVE_TRIALS:
            raise AssertionError(f"wave: {len(trials)} trial records")
        for e in trials:
            res = e["results"]
            if "error" in res["trial_results"] or res["score"] == hyperopt.FAILURE_SENTINEL:
                raise AssertionError(f"wave: trial {e['config']['trial']} failed: {res}")
        best = Ledger(search_ledger).query(lambda e: e.get("run_name") == WAVE_SEARCH
                                           and e.get("status") == "completed")
        if len(best) != 1 or "lr" not in best[0]["info"].get("best_parameters", {}).get(
                "trainer", {}):
            raise AssertionError(f"wave: the search's ledger entry {best}")

        # The analysis tables of both ledgers.
        tables = {}
        for name, path in ((WAVE_SUITE, ledger_path), (WAVE_SEARCH, search_ledger)):
            out_dir = os.path.join(tmp, "tables", name)
            run.main([name, "--ledger", path, "--analyse", "--tables-out", out_dir])
            written = sorted(os.path.relpath(p, out_dir) for p in glob.glob(
                os.path.join(out_dir, "**", "*.tex"), recursive=True))
            frame = analyse.runs_frame(Ledger(path), name)
            built = {**{f"sparsity/{k}.tex": t for k, t in
                        analyse.sparsity_tables(frame, name).items()},
                     "medical-sota.tex": analyse.medical_sota_table(frame, name)}
            cells = 0
            for rel, table in built.items():
                if table.empty:
                    continue
                with open(os.path.join(out_dir, rel)) as fh:
                    if fh.read() != table.to_latex():
                        raise AssertionError(f"wave: {rel} is not its table")
                cells += mean_std_cells(table)
            if "medical-sota.tex" not in written or not cells:
                raise AssertionError(f"wave: tables {written} of {name}, {cells} cells")
            tables[name] = {"written": written, "mean_std_cells": cells}
        step_ms = [start.elapsed_time(end) for start, end, _ in steps]
        emit("wave", suite={k: v for k, v in wave_suites()[WAVE_SUITE].items()},
             lanes=len(WAVE_SEEDS), launches=launches, expected_launches=reckoned(
                 HARNESS_EPOCHS), launches_per_epoch={"forward_multi": 4 * sum(train_iv),
                                                      "backward_multi": 4 * sum(train_iv)},
             per_seed={seed: {k: r[k] for k in ("best_epoch", "test.loss", "test.auc",
                                                "time_per_epoch")}
                       for seed, r in lanes.items()},
             vs_serial={"rtol": WAVE_RTOL, "auc_atol": WAVE_AUC_ATOL, **vs_serial},
             suite_seconds=suite_s, peak_mb=peak_mb,
             train_step_ms=percentiles(step_ms),
             step_on_first_batch={"batch": HARNESS_B, "wave_k3": wave_timed,
                                  "serial": serial_timed},
             search={"trials": WAVE_TRIALS, "waves": calls, "launches": search_launches,
                     "seconds": search_s, "best_parameters": best[0]["info"][
                         "best_parameters"], "scores": [e["results"]["score"]
                                                       for e in trials]},
             tables=tables, seconds=time.perf_counter() - t_phase)
        # The solver legs (item 17c) and the wave's corners (17d).
        solver_paths = solver_waves(config_dir, root)
        solver_paths.update(corner_legs())
        emit("wave", phase_seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"wave": launches, "wave_step": wave_timed["launches"], "search": search_launches,
            **solver_paths}


# ---------------------------------------------------------------------------
# Synthetic raw archives (the raw_data phase; tests/test_torch_port_raw_builders.py)
# ---------------------------------------------------------------------------

SPEECH_RATE = 16000


def _ts_value(v):
    return "?" if np.isnan(v) else repr(float(v))


def write_ts(path, series, labels, problem, classes=None):
    """A plain-layout ``.ts`` file: ``series[i]`` is (L_i, D), NaN written
    as '?'; ``labels`` are class labels (``classes`` lists them) or real
    targets."""
    dims = series[0].shape[1]
    head = ["# synthetic archive at the published shape", f"@problemName {problem}",
            "@timeStamps false", "@missing true", "@univariate false",
            f"@dimensions {dims}", "@equalLength false",
            f"@seriesLength {max(len(s) for s in series)}",
            f"@classLabel true {' '.join(classes)}" if classes else "@targetLabel true",
            "@data"]
    with open(path, "w") as fh:
        fh.write("\n".join(head) + "\n")
        for s, y in zip(series, labels):
            fields = [",".join(_ts_value(v) for v in s[:, d]) for d in range(dims)]
            fh.write(":".join(fields) + f":{y}\n")


def write_character_trajectories(raw_dir, cases, seed=0):
    """CharacterTrajectories' TRAIN and TEST ``.ts`` files at the UEA
    archive's shape: 3 dimensions (x, y velocity and pen force), 20
    classes labelled '1'..'20', ragged lengths 60-182; ``cases`` =
    (train, test) counts.  Each class is a smooth pen stroke of its own
    frequency with noise."""
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    classes = [str(c) for c in range(1, 21)]
    for split, n in zip(("TRAIN", "TEST"), cases):
        series, labels = [], []
        for _ in range(n):
            k = int(rng.integers(0, 20))
            length = int(rng.integers(60, 183))
            t = np.linspace(0.0, 1.0, length)
            s = np.stack([np.sin(2 * np.pi * (k + 1) * t / 4), np.cos(2 * np.pi * (k + 1) * t / 5),
                          np.abs(np.sin(np.pi * t))], 1)
            series.append((s + 0.05 * rng.normal(size=s.shape)).astype(np.float32))
            labels.append(classes[k])
        write_ts(os.path.join(raw_dir, f"CharacterTrajectories_{split}.ts"), series, labels,
                 "CharacterTrajectories", classes)


def write_tser(raw_dir, name, cases, seed=0):
    """A TSER regression archive's ``<name>_TRAIN.ts`` at the Beijing
    air-quality sets' shape: 9 dimensions of 24 hourly readings, some
    missing ('?'), one real target a case."""
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    series = rng.normal(size=(cases, 24, 9)).astype(np.float32)
    series[rng.uniform(size=series.shape) < 0.02] = np.nan
    targets = [repr(float(v)) for v in 80.0 + 40.0 * rng.normal(size=cases)]
    write_ts(os.path.join(raw_dir, f"{name}_TRAIN.ts"), list(series), targets, name)


def write_timestamped_ts(path, cases=4, seed=0):
    """A ``@timestamps true`` file: epoch-scale numeric stamps (~1.7e9 s,
    where float32's spacing is 128 s), three dimensions of which the middle
    one is empty ('::'), class labels."""
    rng = np.random.default_rng(seed)
    lines = ["@problemName Stamped", "@timeStamps true", "@missing true",
             "@univariate false", "@dimensions 3", "@equalLength false",
             "@classLabel true a b", "@data"]
    for i in range(cases):
        stamps = 1_700_000_000 + np.cumsum(rng.integers(1, 90, size=8))
        first = ",".join(f"({t},{rng.normal():.6f})" for t in stamps[::2])
        last = ",".join(f"({t},{'?' if j == 1 else f'{rng.normal():.6f}'})"
                        for j, t in enumerate(stamps[1::2]))
        lines.append(f"{first}::{last}:{'ab'[i % 2]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_speech_commands(raw_dir, per_class, short_per_class, seed=0):
    """SpeechCommands v0.02's ten classes as folders of 16 kHz mono int16
    ``.wav`` files: ``per_class`` one-second clips (a tone of the class's
    pitch in noise) and ``short_per_class`` shorter ones, which the
    builder drops."""
    from scipy.io import wavfile

    from online_neural_cdes_tpu_torch.data.builders import SPEECH_CLASSES

    rng = np.random.default_rng(seed)
    t = np.arange(SPEECH_RATE) / SPEECH_RATE
    for y, cls in enumerate(SPEECH_CLASSES):
        folder = os.path.join(raw_dir, cls)
        os.makedirs(folder, exist_ok=True)
        for i in range(per_class + short_per_class):
            length = SPEECH_RATE if i < per_class else int(rng.integers(4000, SPEECH_RATE))
            clip = (0.3 * np.sin(2 * np.pi * (200.0 + 150.0 * y) * t[:length])
                    + 0.1 * rng.normal(size=length))
            wavfile.write(os.path.join(folder, f"{i:05d}.wav"), SPEECH_RATE,
                          (clip * 2 ** 15 * 0.9).astype(np.int16))


MIMIC_VITALS = ("dbp", "dbp_ni", "heart_rate", "mbp", "mbp_ni", "o2_flow", "resp_rate",
                "sbp", "spo2", "temperature")
MIMIC_LABS = ("alp", "ast", "baseexcess", "bicarbonate_bg", "bilirubin_direct",
              "bilirubin_total", "bun", "calcium", "chloride", "creatinine", "fibrinogen",
              "fio2", "glucose", "glucose_bg", "hematocrit", "hemoglobin", "lactate", "pco2",
              "ph", "platelet", "po2", "potassium_bg", "ptt", "so2", "sodium", "troponin_i",
              "wbc")
# (mean, sd, share observed) of the features the synthetic export fills.
MIMIC_FILLED = {"heart_rate": (80, 10, 1.0), "sbp": (120, 15, 0.7), "dbp": (70, 10, 0.7),
                "resp_rate": (16, 2, 0.9), "spo2": (97, 1, 0.9), "temperature": (37, 0.5, 0.3),
                "glucose": (120, 30, 0.15), "lactate": (2, 1, 0.1), "wbc": (9, 3, 0.1)}
VENT_STATUS = ("", "Oxygen", "InvasiveVent", "Trach", "HighFlow", "NonInvasiveVent")


def write_bigquery_export(path, n_patients, seed=0):
    """A MIMIC-IV BigQuery export in the schema of ``mimic_query.sql``'s
    result (the fixture of ``tests/test_raw_builders.py``), written with
    the standard library: one row per measurement, timestamps as
    'YYYY-MM-DD HH:MM:SS.ffffff', missing values empty.  Every eighth
    patient has a burst of measurements a minute apart (continuously
    monitored, dropped by the build), every eighth another a reading a
    minute after another (merged), and some readings fall before the ICU
    admission (filtered)."""
    import csv

    rng = np.random.default_rng(seed)
    hour = np.timedelta64(3_600_000_000, "us")
    base = np.datetime64("2150-01-01T00:00:00", "us")

    def stamp(t):
        return "" if t is None else str(t).replace("T", " ")

    def after(t0, hours):
        return t0 + np.timedelta64(int(round(hours * 3_600_000_000)), "us")

    columns = (["stay_id", "charttime", "icu_intime", "icu_outtime", "t_sofa", "gender",
                "ethnicity", "admission_age", "height", "weight", "hospital_expire_flag",
                "ventilation_status"] + list(MIMIC_VITALS) + list(MIMIC_LABS))
    with open(path, "w", newline="") as fh:
        out = csv.writer(fh)
        out.writerow(columns)
        for pid in range(n_patients):
            intime = base + int(rng.integers(0, 24 * 365)) * hour
            stay = float(rng.uniform(6, 60))
            outtime = after(intime, stay)
            times = np.sort(rng.uniform(-1.0, stay, int(rng.integers(6, 25))))
            if pid % 8 == 3:
                times = np.sort(np.r_[times, times[2] + np.arange(1, 8) / 60.0])
            elif pid % 8 == 5:
                times = np.sort(np.r_[times, times[1:4] + 1.0 / 60.0])
            t_sofa = after(intime, float(rng.uniform(2, stay))) if rng.uniform() < 0.4 else None
            static = {"stay_id": str(30_000_000 + pid), "gender": "MF"[int(rng.integers(0, 2))],
                      "ethnicity": ("WHITE", "BLACK", "ASIAN", "OTHER")[int(rng.integers(0, 4))],
                      "admission_age": repr(float(rng.uniform(20, 90))),
                      "height": repr(float(rng.uniform(150, 200)))
                      if rng.uniform() < 0.8 else "",
                      "weight": repr(float(rng.uniform(50, 120))),
                      "hospital_expire_flag": str(int(rng.uniform() < 0.2)),
                      "icu_intime": stamp(intime), "icu_outtime": stamp(outtime),
                      "t_sofa": stamp(t_sofa)}
            for tt in times:
                row = dict(static, charttime=stamp(after(intime, float(tt))),
                           ventilation_status=VENT_STATUS[int(rng.choice(
                               6, p=[0.7, 0.12, 0.08, 0.03, 0.04, 0.03]))])
                for name, (mean, sd, share) in MIMIC_FILLED.items():
                    row[name] = (repr(float(rng.normal(mean, sd)))
                                 if rng.uniform() < share else "")
                out.writerow([row.get(c, "") for c in columns])


def raw_suite():
    """The interpolation suite's rk4-schemes-benchmarks leg
    (configurations.json5) for SpeechCommands under linear interpolation:
    batches of 512, the NCDE without the adjoint, RK4; hyperparameters set
    at the flagship's widths (the leg loads a search's, and no search has
    run); its epochs cut to one."""
    return {"hyperparameters": ["set"], "seed": [RAW_SEED],
            "dataset_name": ["SpeechCommands"],
            "dataset": {"interpolation": ["linear"], "batch_size": [RAW_B]},
            "model": {"model_string": ["ncde"], "adjoint": [False],
                      "interpolation_eps": [0.5], "solver": ["rk4"], "hidden_dim": [H],
                      "hidden_hidden_dim": [HH], "num_layers": [N_LAYERS]},
            "trainer": {"max_epochs": [1]}}


def phase_raw_data():
    """The raw-archive builders on synthetic archives (CharacterTrajectories
    and a timestamped ``.ts`` file, BeijingPM2pt5, SpeechCommands with its
    MFCCs on the card, a MIMIC-IV BigQuery export through
    ``mimic_raw.build_reduced_format`` into ``mimic.prepare_all``), the
    card's MFCCs against the CPU's, then one configuration of
    rk4-schemes-benchmarks trained from the built root through
    ``run.main`` (launches against its batches' reckoning) and its best
    weights served against the CPU."""
    from online_neural_cdes_tpu_torch import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch import run
    from online_neural_cdes_tpu_torch.data import audio, builders, mimic, mimic_raw
    from online_neural_cdes_tpu_torch.data.loader import Batches
    from online_neural_cdes_tpu_torch.data.ts_format import load_ts_file
    from online_neural_cdes_tpu_torch.serving import predictor_from_bundle
    from online_neural_cdes_tpu_torch.training import config
    from online_neural_cdes_tpu_torch.training.experiment import load_and_setup

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_raw_")
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    try:
        raw, root = os.path.join(tmp, "raw"), os.path.join(tmp, "processed")
        uea, tsr = os.path.join(raw, "UEA"), os.path.join(raw, "TSR")
        speech, export = os.path.join(raw, "SpeechCommands"), os.path.join(raw, "mimic-iv")
        os.makedirs(export)
        timed("write_archives", lambda: (
            write_character_trajectories(uea, RAW_CT_CASES),
            write_timestamped_ts(os.path.join(uea, "Stamped_TRAIN.ts")),
            write_tser(tsr, RAW_TSR_NAME, RAW_TSR_CASES),
            write_speech_commands(speech, RAW_SC_PER_CLASS, RAW_SC_SHORT),
            write_bigquery_export(os.path.join(export, "export_0.csv"), RAW_MIMIC_PATIENTS)))

        built = {}
        ct = timed("character_trajectories", lambda: builders.build_character_trajectories(
            root=root, raw_dir=uea))
        stamped, _ = load_ts_file(os.path.join(uea, "Stamped_TRAIN.ts"))
        if not all(s.shape[1] == 4 and np.isnan(s[:, 2]).all() and s[0, 0] == 0.0
                   and (np.diff(s[:, 0]) > 0).all() for s in stamped):
            raise AssertionError("raw_data: the timestamped file's columns")
        tsr_path = timed("tsr", lambda: builders.build_tsr(RAW_TSR_NAME, root=root,
                                                            raw_dir=tsr))
        keep_beijing(root)          # the wave phase's solver legs train on it
        sc = timed("speech_commands", lambda: builders.build_speech_commands(
            root=root, raw_dir=speech))
        for name, path, n, channels, labels in (
                ("CharacterTrajectories", ct, sum(RAW_CT_CASES), 4, set(range(20))),
                (RAW_TSR_NAME, tsr_path, RAW_TSR_CASES, 10, None),
                ("SpeechCommands", sc, 10 * RAW_SC_PER_CLASS, RAW_SC_CHANNELS,
                 set(range(10)))):
            with np.load(path, allow_pickle=True) as npz:
                series = npz["temporal_data_raw"]
                lengths = sorted({len(s) for s in series})
                got_labels = npz["labels"]
                splits = [len(npz[k]) for k in ("train_idxs", "val_idxs", "test_idxs")]
            if len(series) != n or series[0].shape[-1] != channels or sum(splits) != n:
                raise AssertionError(f"raw_data: {name} built {len(series)} series of "
                                     f"{series[0].shape} channels, splits {splits}")
            if labels is not None and set(np.unique(got_labels)) != labels:
                raise AssertionError(f"raw_data: {name} labels {np.unique(got_labels)}")
            built[name] = {"series": len(series), "channels": channels,
                           "lengths": [lengths[0], lengths[-1]], "splits": splits}
        if built["SpeechCommands"]["lengths"] != [RAW_SC_FRAMES, RAW_SC_FRAMES]:
            raise AssertionError(f"raw_data: SpeechCommands frames {built['SpeechCommands']}")

        # The MFCCs on the card against the CPU's on the same clips.
        from scipy.io import wavfile

        clips = np.stack([wavfile.read(os.path.join(speech, "yes", f"{i:05d}.wav"))[1]
                          for i in range(RAW_MFCC_CLIPS)]).astype(np.float32) / 2 ** 15
        card = audio.mfcc(clips)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = audio.mfcc(clips)
        torch.cuda.synchronize()
        mfcc_ms = (time.perf_counter() - t0) * 1e3
        cpu = audio.mfcc(clips, device="cpu")
        if card.device.type != "cuda":
            raise AssertionError(f"raw_data: mfcc ran on {card.device}")
        torch.testing.assert_close(card.cpu(), cpu, rtol=MFCC_RTOL, atol=MFCC_ATOL)
        mfcc_vs_cpu = {"clips": RAW_MFCC_CLIPS, "shape": list(card.shape),
                       "max_abs_err": float((card.cpu() - cpu).abs().max()),
                       "gate_share": gate_share(card.cpu(), cpu, MFCC_RTOL, MFCC_ATOL),
                       "bit_identical": bool(torch.equal(card.cpu(), cpu)),
                       "rtol": MFCC_RTOL, "atol": MFCC_ATOL, "card_ms": mfcc_ms}

        reduced = timed("mimic_reduced_format",
                        lambda: mimic_raw.build_reduced_format(export))
        tasks = timed("mimic_prepare_all", lambda: mimic.prepare_all(reduced, out_root=root))
        with np.load(reduced, allow_pickle=True) as npz:
            mimic_summary = {"patients": len(npz["static_data"]),
                             "temporal_columns": len(npz["temporal_columns"])}
        for task, path in tasks.items():
            with np.load(path, allow_pickle=True) as npz:
                mimic_summary[task] = len(npz["temporal_data_raw"])
        if not 0 < mimic_summary["patients"] < RAW_MIMIC_PATIENTS:
            raise AssertionError(f"raw_data: MIMIC kept {mimic_summary}")

        # One configuration of rk4-schemes-benchmarks from the built root.
        config_dir = os.path.join(tmp, "configurations")
        os.makedirs(config_dir)
        shutil.copy(os.path.join(config.DEFAULT_CONFIG_DIR, "dataset.json5"), config_dir)
        with open(os.path.join(config_dir, "configurations.json5"), "w") as fh:
            json.dump({RAW_SUITE: raw_suite()}, fh)
        (cfg,), _ = config.parse_configuration_json(RAW_SUITE, config_dir)
        bundle, (train, val, test) = load_and_setup(cfg, root)

        def intervals(data):
            return [b[0].shape[1] - 1 for b in Batches(data, RAW_B)]

        train_iv = intervals(train)
        eval_iv = [sum(intervals(d)) for d in (train, val, test)]
        shapes = sorted({(len(b[1]), H, HH, b[0].shape[-1], 2)
                         for d in (train, val, test) for b in Batches(d, RAW_B)})
        if shapes != sorted(RAW_SHAPES):
            raise AssertionError(f"raw_data: the leg's kernel shapes {shapes}")
        # Autograd through RK4: 4 forward and 4 backward launches an
        # interval a step; the trainer probes the first batch's NFE once.
        expected = {"forward": 4 * train_iv[0] + 4 * sum(train_iv) + 4 * eval_iv[1]
                    + 4 * sum(eval_iv), "backward": 4 * sum(train_iv)}
        args = [RAW_SUITE, "--config-dir", config_dir, "--data-root", root,
                "--ledger", os.path.join(tmp, "ledger.jsonl")]
        t0 = time.perf_counter()
        completed, launches = counted(lambda: run.main(args))   # the main path
        suite_s = time.perf_counter() - t0
        expect_launches("raw_data: the suite", launches, **expected)
        ((_, res),) = completed
        if res["epochs_run"] != 1 or not np.isfinite(res["test.loss"]) \
                or not 0.0 <= res["test.acc"] <= 1.0:
            raise AssertionError(f"raw_data: the suite gave {res}")

        # Its best weights served: test-split series through linear
        # coefficients, the card against the CPU.
        with np.load(sc, allow_pickle=True) as npz:
            idx = npz["test_idxs"][:RAW_REQUESTS]
            requests = [np.asarray(r, np.float32) for r in npz["temporal_data_raw"][idx]]
        serve_kw = dict(coeff_fn=linear_interpolation_coeffs,
                        batch_buckets=(1, RAW_CPU_REQUESTS, RAW_REQUESTS),
                        length_multiple=LENGTH_MULTIPLE)
        pred = predictor_from_bundle(bundle, res["best_params"], **serve_kw)
        outs, serve_launches = counted(lambda: pred.predict(requests))
        padded = -(-RAW_SC_FRAMES // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
        expect_launches("raw_data: predict", serve_launches, forward=4 * (padded - 1))
        bundle_cpu, _ = load_and_setup(cfg, root, device="cpu")
        pred_cpu = predictor_from_bundle(
            bundle_cpu, {k: v.cpu() for k, v in res["best_params"].items()}, **serve_kw)
        outs_cpu = pred_cpu.predict(requests[:RAW_CPU_REQUESTS])
        serve = par_gate("raw_data: served", outs[:RAW_CPU_REQUESTS], outs_cpu, SERVE_RTOL,
                         SERVE_ATOL)
        if outs[0].shape != (10,):
            raise AssertionError(f"raw_data: served shape {outs[0].shape}")
        emit("raw_data", archives={
                 "CharacterTrajectories": {"cases": list(RAW_CT_CASES), "dimensions": 3,
                                           "classes": 20, "lengths": [60, 182]},
                 RAW_TSR_NAME: {"cases": RAW_TSR_CASES, "dimensions": 9, "length": 24},
                 "SpeechCommands": {"clips_per_class": RAW_SC_PER_CLASS,
                                    "short_per_class_dropped": RAW_SC_SHORT},
                 "MIMIC-IV export": {"patients": RAW_MIMIC_PATIENTS}},
             built=built, timestamped_cases=len(stamped), mfcc_vs_cpu=mfcc_vs_cpu,
             mimic=mimic_summary, seconds=seconds,
             suite={"config": raw_suite(), "train_batch_intervals": train_iv,
                    "eval_intervals_by_split": eval_iv, "kernel_shapes": shapes,
                    "launches": launches, "expected_launches": expected,
                    "seconds": suite_s, **{k: res[k] for k in (
                        "test.loss", "test.acc", "time_per_epoch", "memory_usage",
                        "nfe_per_epoch")}},
             serve={"requests": len(requests), "launches": serve_launches,
                    "vs_cpu": {"requests": RAW_CPU_REQUESTS, "max_abs_err": serve[0],
                               "gate_share": serve[1], "rtol": SERVE_RTOL,
                               "atol": SERVE_ATOL}},
             phase_seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"raw_data_suite": launches, "raw_data_predict": serve_launches}


# ---------------------------------------------------------------------------
# Data parallelism: one process a rank (the parallel phase;
# tests/test_torch_port_parallel.py runs the same worker on the CPU)
# ---------------------------------------------------------------------------


def par_batch(spec, seed, rows=None):
    """A training batch of the parallel checks: series (B, L, C) with time
    in channel 0, statics (B, S) and binary labels (B, L) whose second
    half of rows ends half way (NaN), so the shards' NaN masks differ."""
    rng = np.random.default_rng(seed)
    b, length, c = rows or spec["B"], spec["L"], spec["C"]
    x = rng.normal(size=(b, length, c))
    x[..., 0] = np.arange(length)
    static = rng.normal(size=(b, spec["S"]))
    labels = rng.integers(0, 2, size=(b, length)).astype(np.float64)
    labels[b // 2:, length // 2:] = np.nan
    return x, static, labels


def par_class_labels(spec, seed, rows):
    """Class ids (as floats, the padded tail's NaN-able layout) of the
    padded cross-entropy check."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, spec["classes"], size=(rows, spec["L"])).astype(np.float64)


def par_requests(spec, seed=5):
    """Ragged NaN-holding requests (time in channel 0) and their statics."""
    rng = np.random.default_rng(seed)
    requests = []
    for length in rng.integers(spec["L"] // 2, spec["L"] + 1, size=spec["requests"]):
        s = rng.normal(size=(length, spec["C"]))
        s[:, 0] = np.arange(length)
        holes = rng.random(size=s.shape) < 0.3
        holes[0] = False
        holes[:, 0] = False
        s[holes] = np.nan
        requests.append(s.astype(np.float32))
    return requests, rng.normal(size=(spec["requests"], spec["S"])).astype(np.float32)


def par_streams(spec, seed=6):
    """Observations (ticks, streams, C) of the streaming check and the
    streams' statics."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(spec["ticks"], spec["streams"], spec["C"]))
    x[..., 0] = np.arange(spec["ticks"])[:, None]
    x[1:][rng.random(size=x[1:].shape) < 0.3] = np.nan
    x[..., 0] = np.arange(spec["ticks"])[:, None]
    return x.astype(np.float32), rng.normal(size=(spec["streams"], spec["S"])).astype(
        np.float32)


def _par_model(spec, device, dtype, output_dim=1, params=None):
    from online_neural_cdes_tpu_torch import NeuralCDE
    from online_neural_cdes_tpu_torch.utils.convert import params_from_jax

    model = NeuralCDE(
        input_dim=spec["C"], hidden_dim=spec["H"], output_dim=output_dim,
        static_dim=spec["S"], hidden_hidden_dim=spec["HH"], num_layers=spec["layers"],
        interpolation="rectilinear", solver="rk4", return_sequences=True,
        generator=torch.Generator().manual_seed(0), device=device, dtype=dtype)
    if params is not None:
        with np.load(params) as npz:
            params_from_jax(dict(npz), model)
    return model


def _grads(model):
    """The gradients a step left in ``.grad`` (the last step's, which Adam
    took)."""
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _record_grads(adam):
    """The gradients a ``StackedAdam`` is stepped with, recorded into the
    returned dict as it steps (the wave step keeps none in ``.grad``)."""
    recorded = {}
    step = adam.step

    def recording(grads, lr_rest, lr_final):
        recorded.update({k: g.detach().clone() for k, g in grads.items()})
        return step(grads, lr_rest, lr_final)

    adam.step = recording
    return recorded


def _first_step(optimizer, model):
    """The weights and gradients of ``model`` just after ``optimizer``'s
    first step, recorded into the returned dict."""
    first = {}

    def record(opt, args, kwargs):
        if not first:
            first["params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
            first["grads"] = _grads(model)

    optimizer.register_step_post_hook(record)
    return first


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _host_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return tree


def _par_counted(fn, device):
    """``fn``'s result and, on the card, its kernel launches in this
    process (the counts set to 0 just before)."""
    if device.type != "cuda":
        return fn(), None
    return counted(fn)


def par_worker(rank, boot):
    """One rank of the parallel checks: joins the gloo group of
    ``boot["world"]`` ranks at ``boot["address"]`` on ``boot["device"]``,
    waits for its spec (:func:`par_start`), runs every check
    (:func:`par_checks`, or with ``spec["checks"] == "export"`` only
    :func:`export_mesh_checks`) and saves its results (host tensors) to
    ``<spec["out"]>/rank<rank>.pt``.  An exception ends the process
    nonzero."""
    import torch.distributed as dist

    device = torch.device(boot["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.zeros(1, device=device)           # the CUDA context, before the spec
    dist.init_process_group("gloo", init_method=boot["address"], world_size=boot["world"],
                            rank=rank)
    try:
        deadline = time.monotonic() + boot["timeout_s"]
        while not os.path.exists(boot["spec_file"]):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"no spec at {boot['spec_file']} after "
                                   f"{boot['timeout_s']} s")
            time.sleep(0.2)
        spec = torch.load(boot["spec_file"], weights_only=False)
        artifacts_s = None
        if spec.get("prepare"):
            # The artifacts the checks serve, rank 0 the flagship's and rank
            # 1 C3's at once, each then read by both.
            t0 = time.perf_counter()
            part = ({"artifacts": par_artifacts(spec["out"])} if rank == 0
                    else {"c3": c3_spec(spec["out"])})
            torch.save(part, os.path.join(spec["out"], f"prepared{rank}.pt"))
            artifacts_s = time.perf_counter() - t0
            dist.barrier()
            for r in range(boot["world"]):
                spec.update(torch.load(os.path.join(spec["out"], f"prepared{r}.pt"),
                                       weights_only=False))
        checks = export_mesh_checks if spec.get("checks") == "export" else par_checks
        out = checks(rank, spec, device)
        out["artifacts_seconds"] = artifacts_s
        torch.save(_host_tree(out), os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def par_checks(rank, spec, device):
    """Every data-parallel path once over a mesh of the group's ranks, and
    on rank 0 the single-process run of each on the whole batch (``ref``):
    a train step, a forward, gradient accumulation, an epoch step, a
    cross-entropy step on a padded tail, prefetched shards, ``Predictor``
    and ``OnlineNCDEStepper`` with their divisibility refusals, a seed
    ensemble over (ensemble, data) = (world, 1), and the toy suite through
    ``run.main --data-parallel``."""
    import glob

    from online_neural_cdes_tpu_torch import OnlineNCDEStepper, Predictor
    from online_neural_cdes_tpu_torch import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch import run as port_run
    from online_neural_cdes_tpu_torch.data.prefetch import prefetch_to_device
    from online_neural_cdes_tpu_torch.parallel import ensemble
    from online_neural_cdes_tpu_torch.parallel import mesh as pm
    from online_neural_cdes_tpu_torch.training import harness, loop
    from online_neural_cdes_tpu_torch.utils.convert import params_from_jax

    dtype = getattr(torch, spec["dtype"])
    world, lr = spec["world"], spec["lr"]
    mesh = pm.make_mesh(world, devices=spec["device"])
    ref = spec["reference"] and rank == 0
    out = {"rank": rank, "lr": lr, "launches": {}, "ref": {}}

    def run(name, fn):
        result, launches = _par_counted(fn, device)
        if launches is not None:
            out["launches"][name] = launches
        return result

    def tensors(x, static, labels):
        coeffs = linear_interpolation_coeffs(torch.as_tensor(x, dtype=dtype, device=device),
                                             rectilinear=0)
        return ((torch.as_tensor(static, dtype=dtype, device=device), coeffs),
                torch.as_tensor(labels, dtype=dtype, device=device))

    def model(output_dim=1, params=spec.get("params")):
        return _par_model(spec, device, dtype, output_dim, params)

    inputs, labels = tensors(*par_batch(spec, 11))
    shard_in, shard_lab = pm.shard_batch((inputs, labels), mesh)

    # The train step, the forward, accumulation and the epoch step.
    for name, kw in (("train_step", {}), ("accum_step", {"accum_steps": spec["accum"]})):
        m = pm.replicate(model(), mesh)
        step = loop.make_train_step(m, loss="bce", lr=lr, mesh=mesh, **kw)
        loss = run(name, lambda: step(shard_in, shard_lab, 1.0))
        out[name] = {"loss": loss, "params": m.state_dict(), "grads": _grads(m)}
        if ref:
            m = model()
            init = _state(m)
            loss = loop.make_train_step(m, loss="bce", lr=lr, **kw)(inputs, labels, 1.0)
            out["ref"][name] = {"loss": loss, "params": m.state_dict(), "grads": _grads(m),
                                "init": init}
    forward = loop.make_eval_step(model(), mesh=mesh)
    out["forward"] = run("forward", lambda: forward(shard_in))
    if ref:
        out["ref"]["forward"] = loop.make_eval_step(model())(inputs)

    inputs2, labels2 = tensors(*par_batch(spec, 12))
    stacked = (tuple(torch.stack([a, b]) for a, b in zip(inputs, inputs2)),
               torch.stack([labels, labels2]))
    m = model()
    epoch = loop.make_epoch_step(m, loss="bce", lr=lr, mesh=mesh)
    first = _first_step(epoch.optimizer, m)
    shards = [pm.shard_batch((i, lab), mesh) for i, lab in ((inputs, labels),
                                                             (inputs2, labels2))]
    shard_stack = (tuple(torch.stack([a, b]) for a, b in zip(shards[0][0], shards[1][0])),
                   torch.stack([shards[0][1], shards[1][1]]))
    losses = run("epoch_step", lambda: epoch(*shard_stack, 1.0))
    out["epoch_step"] = {"loss": losses, "params": m.state_dict(), "grads": _grads(m),
                         "first": first}
    if ref:
        m = model()
        init = _state(m)
        epoch = loop.make_epoch_step(m, loss="bce", lr=lr)
        first = _first_step(epoch.optimizer, m)
        losses = epoch(*stacked, 1.0)
        out["ref"]["epoch_step"] = {"loss": losses, "params": m.state_dict(),
                                    "grads": _grads(m), "first": first, "init": init}

    # Cross-entropy on a batch that does not divide the data axis: padded
    # (inputs repeat the last row, labels NaN) and sharded.
    rows = spec["B"] - 1
    x, static, _ = par_batch(spec, 13, rows)
    ce_labels = par_class_labels(spec, 13, rows)
    ce_in, ce_lab = tensors(x, static, ce_labels)
    padded = harness._pad_to_mesh_multiple(ce_in, ce_lab, world)
    m = pm.replicate(model(spec["classes"], spec.get("ce_params")), mesh)
    step = loop.make_train_step(m, loss="ce", lr=lr, mesh=mesh)
    loss = run("ce_step", lambda: step(*pm.shard_batch(padded, mesh), 1.0))
    out["ce_step"] = {"loss": loss, "params": m.state_dict(), "grads": _grads(m),
                      "padded_rows": int(padded[1].shape[0])}
    if ref:
        m = model(spec["classes"], spec.get("ce_params"))
        init = _state(m)
        loss = loop.make_train_step(m, loss="ce", lr=lr)(ce_in, ce_lab, 1.0)
        out["ref"]["ce_step"] = {"loss": loss, "params": m.state_dict(), "grads": _grads(m),
                                 "init": init}

    # Prefetched shards: this rank's rows of each raw batch, as shard_batch
    # gives them.
    raw = [(par_batch(spec, s)[0], par_batch(spec, s)[2]) for s in (21, 22)]
    got = list(prefetch_to_device(iter(raw), size=2,
                                  sharding=pm.data_parallel_sharding(mesh)[0]))
    out["prefetch_equal"] = all(
        g.shape == w.shape and bool(((g == w) | (g.isnan() & w.isnan())).all())
        for (gx, gl), (x_, l_) in zip(got, raw)
        for g, w in ((gx, pm.shard_batch(torch.from_numpy(x_), mesh)),
                     (gl, pm.shard_batch(torch.from_numpy(l_), mesh))))

    # Serving.
    requests, req_static = par_requests(spec)
    serve_kw = dict(coeff_fn=lambda s: linear_interpolation_coeffs(s, rectilinear=0),
                    batch_buckets=spec["buckets"], length_multiple=spec["length_multiple"])
    m = model()
    pred = Predictor(m, mesh=mesh, **serve_kw)
    out["predict"] = run("predict", lambda: pred.predict(requests, static=req_static))
    refusals = []
    try:
        Predictor(m, mesh=mesh, batch_buckets=(world + 1,))
    except ValueError as exc:
        refusals.append(str(exc))
    obs, stream_static = par_streams(spec)
    stepper = OnlineNCDEStepper(m, static=stream_static, mesh=mesh)
    half = spec["ticks"] // 2

    def stream():
        state = stepper.init(obs[0])
        ys = []
        for t in range(1, half):
            state, y = stepper.step(state, obs[t])
            ys.append(y)
        state, many = stepper.step_many(state, obs[half:])
        return torch.cat([torch.stack(ys), many])

    out["stream"] = run("stream", stream)
    try:
        stepper.init(obs[0][:world + 1])
    except ValueError as exc:
        refusals.append(str(exc))
    out["refusals"] = refusals
    if ref:
        m = model()
        out["ref"]["predict"] = Predictor(m, device=device, **serve_kw).predict(
            requests, static=req_static)
        single = OnlineNCDEStepper(m, static=stream_static, device=device)
        state = single.init(obs[0])
        ys = []
        for t in range(1, half):
            state, y = single.step(state, obs[t])
            ys.append(y)
        out["ref"]["stream"] = torch.cat([torch.stack(ys), single.step_many(state, obs[half:])[1]])

    # A seed ensemble: one seed a rank over (ensemble, data) = (world, 1).
    ens_mesh = ensemble.make_ensemble_mesh(world, 1, devices=spec["device"])
    bundle = harness.setup_model(
        "ncde", input_dim=spec["C"], output_dim=1, static_dim=spec["S"],
        hidden_dim=spec["H"], hidden_hidden_dim=spec["HH"], num_layers=spec["layers"],
        interpolation="rectilinear", adjoint=False, solver="rk4", return_sequences=True,
        device=device, dtype=dtype)
    stacked_params = None
    if spec.get("ensemble_params"):
        with np.load(spec["ensemble_params"]) as npz:
            stacked_params = params_from_jax(dict(npz), bundle.model, stacked=True)
    state, adam = ensemble.init_ensemble(bundle, world, mesh=ens_mesh, params=stacked_params)
    ens_grads = _record_grads(adam)
    ens_step = ensemble.make_ensemble_step(bundle, loss="bce", lr=lr, mesh=ens_mesh)
    ens_in = pm.shard_batch((inputs, labels), ens_mesh)
    _, _, ens_losses = run("ensemble_step", lambda: ens_step(state, adam, *ens_in, 1.0))
    out["ensemble_step"] = {"loss": ens_losses, "params": state, "grads": ens_grads}
    if ref:
        state, adam = ensemble.init_ensemble(bundle, world, params=stacked_params)
        init = {k: v.detach().clone() for k, v in state.items()}
        ens_grads = _record_grads(adam)
        _, _, losses = ensemble.make_ensemble_step(bundle, loss="bce", lr=lr)(
            state, adam, inputs, labels, 1.0)
        out["ref"]["ensemble_step"] = {"loss": losses, "params": state, "grads": ens_grads,
                                       "init": init}

    # The toy suite from the command line over the group, then (rank 0) the
    # same suite in one process.
    toy = spec.get("toy")
    if toy:
        args = [toy["suite"], "--config-dir", toy["config_dir"], "--data-root", toy["root"]]
        device_args = ["--device", "cpu"] if device.type == "cpu" else []
        out["run"] = run("run_data_parallel", lambda: port_run.main(
            args + ["--ledger", toy["ledger"], "--data-parallel", str(world)]
            + device_args))
        out["run"] = [r for _, r in out["run"]]
        out["run_files"] = sorted(glob.glob(os.path.join(toy["ledger"] + "*")))
        if ref:
            out["ref"]["run"] = [r for _, r in port_run.main(
                args + ["--ledger", toy["serial_ledger"]] + device_args)]
    if spec.get("seq"):
        out["seq"] = seq_checks(rank, spec, device)
    if spec.get("artifacts"):
        out["export"] = export_mesh_checks(rank, spec, device)
    if spec.get("c3"):
        out["c3"] = c3_checks(rank, spec, device)
    return out


def export_mesh_checks(rank, spec, device):
    """Exported artifacts served over meshes of the group's ranks
    (``spec["artifacts"]``: a predictor's directory, stepper directories
    by name with whether each takes statics, and two stream counts, ``B``
    that divides the data axis and ``odd`` that does not):
    ``load_predictor(path, mesh=)`` on the ragged requests and, for each
    stepper, ``load_stepper(path, mesh=)`` over the streams (ticks, then a
    ``step_many`` backlog), each against the same artifact loaded in this
    process alone (``ref``); for a stepper without statics, the refusal of
    the stream count that does not divide the data axis, and on an
    (ensemble, data) = (world, 1) mesh that count served, since it divides
    the data axis.  Each call's kernel launches on the card."""
    from online_neural_cdes_tpu_torch.parallel import ensemble
    from online_neural_cdes_tpu_torch.parallel import mesh as pm
    from online_neural_cdes_tpu_torch.serving_export import load_predictor, load_stepper

    art = spec["artifacts"]
    mesh = pm.make_mesh(spec["world"], devices=spec["device"])
    ens_mesh = ensemble.make_ensemble_mesh(spec["world"], 1, devices=spec["device"])
    out = {"rank": rank, "launches": {}, "ref": {}}

    def run(name, fn):
        result, launches = _par_counted(fn, device)
        if launches is not None:
            out["launches"][name] = launches
        return result

    requests, req_static = par_requests(spec)
    pred = load_predictor(art["predictor"], mesh=mesh)
    req_static = req_static if pred.accept_static else None
    out["predict"] = run("artifact_predict", lambda: pred.predict(requests, static=req_static))
    out["ref"]["predict"] = load_predictor(art["predictor"], device=device).predict(
        requests, static=req_static)

    obs, stream_static = par_streams(spec)

    def stream(stepper, n):
        x = obs[:, :n]
        state = stepper.init(x[0])
        ys, half = [], len(x) // 2
        for t in range(1, half):
            state, y = stepper.step(state, x[t])
            ys.append(y)
        state, many = stepper.step_many(state, x[half:])
        return {"ys": torch.cat([torch.stack(ys), many]), "rows": int(state["z"].shape[0])}

    b, odd = art["B"], art["odd"]
    for name, (path, takes_static) in art["steppers"].items():
        key = "stream" if name == "plain" else f"stream_{name}"
        static = stream_static[:b] if takes_static else None
        out[key] = run(f"artifact_{key}", lambda: stream(
            load_stepper(path, static=static, mesh=mesh), b))
        out["ref"][key] = stream(load_stepper(path, static=static, device=device), b)
        if takes_static:
            continue
        # A stepper without statics serves any exported count: the count
        # that does not divide the data axis is refused over it, and
        # served over (ensemble, data) = (world, 1) and in one process.
        try:
            stream(load_stepper(path, mesh=mesh), odd)
            out[f"refusal_{name}"] = None
        except ValueError as exc:
            out[f"refusal_{name}"] = str(exc)
        out[f"ensemble_{key}"] = stream(load_stepper(path, mesh=ens_mesh), odd)
        out["ref"][f"ensemble_{key}"] = stream(load_stepper(path, device=device), odd)
    return out


def c3_batch(c3, rows, seed):
    """Series (rows, L, C), time in channel 0, whose second half of rows is
    4 times rougher than the first (so each shard's own controller would
    take other steps than the whole batch's: ROADMAP C3), and float
    targets, one a series (``return_sequences=False``) or one a time."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, c3["L"], c3["C"]))
    x[rows // 2:] *= 4.0
    x[..., 0] = np.arange(c3["L"])
    shape = (rows, c3["L"]) if c3["return_sequences"] else (rows,)
    return x, rng.normal(size=shape)


def c3_coeffs(c3):
    from online_neural_cdes_tpu_torch import (
        hermite_cubic_coefficients_with_backward_differences, linear_interpolation_coeffs)

    return (hermite_cubic_coefficients_with_backward_differences
            if c3["interpolation"] == "hermite" else linear_interpolation_coeffs)


def c3_model(c3, solver, device, dtype, adjoint=False):
    """The C3 checks' NCDE on ``solver``: weights from seed 0, or the JAX
    package's from ``c3["params"][solver]`` where given."""
    from online_neural_cdes_tpu_torch import NeuralCDE
    from online_neural_cdes_tpu_torch.utils.convert import params_from_jax

    model = NeuralCDE(
        input_dim=c3["C"], hidden_dim=c3["H"], output_dim=1, hidden_hidden_dim=c3["HH"],
        num_layers=c3["layers"], interpolation=c3["interpolation"],
        return_sequences=c3["return_sequences"], solver=solver, adjoint=adjoint,
        generator=torch.Generator().manual_seed(0), device=device, dtype=dtype)
    params = c3.get("params", {}).get(solver)
    if params is not None:
        with np.load(params) as npz:
            params_from_jax(dict(npz), model)
    return model


def c3_bundle(c3, device, dtype, adjoint=False):
    """The C3 checks' NCDE on dopri5 as a bundle (``harness.setup_model``),
    for the seed ensemble."""
    from online_neural_cdes_tpu_torch.training import harness

    return harness.setup_model(
        "ncde", input_dim=c3["C"], output_dim=1, hidden_dim=c3["H"],
        hidden_hidden_dim=c3["HH"], num_layers=c3["layers"],
        interpolation=c3["interpolation"], adjoint=adjoint, solver="dopri5",
        return_sequences=c3["return_sequences"], device=device, dtype=dtype)


def c3_checks(rank, spec, device):
    """ROADMAP C3 over a mesh of the group's ranks (``spec["c3"]``): for
    each adaptive solver, ``Predictor(mesh=)`` on requests whose second
    half of rows is rougher (one rank's rows smooth, the other's rough),
    the loaded artifact of ``c3["artifacts"][solver]`` over the same mesh,
    and one ``make_train_step(mesh=)`` step on such a batch; each with this
    rank's solve counts (``solvers.COUNTS``) and, on the card, kernel
    launches; with ``c3["ensemble"]`` (K seeds, their stacked weights from
    ``c3["ensemble_params"]`` where given), a dopri5 ``make_ensemble_step``
    over (1 ensemble x the world's data): every rank solves the K lanes on
    its rows, each lane's controller deciding over the whole batch; for
    each of ``c3["adjoint_solvers"]`` a ``make_train_step(mesh=)`` step of
    the model with ``adjoint=True`` (``odeint_adjoint``'s reverse solve
    deciding its steps as one process over the whole batch: ROADMAP item
    18c), with the ensemble its adjoint step too (each lane's reverse solve
    so), and ``summed_norm_probe``.  On rank 0 the same in one process
    (``ref``).  Then the refusal of a ``scipy_solver`` step over the
    mesh."""
    from online_neural_cdes_tpu_torch import Predictor
    from online_neural_cdes_tpu_torch.ops import solvers
    from online_neural_cdes_tpu_torch.parallel import ensemble
    from online_neural_cdes_tpu_torch.parallel import mesh as pm
    from online_neural_cdes_tpu_torch.serving_export import load_predictor
    from online_neural_cdes_tpu_torch.training.loop import make_train_step
    from online_neural_cdes_tpu_torch.utils.convert import params_from_jax

    c3 = spec["c3"]
    dtype = getattr(torch, spec["dtype"])
    mesh = pm.make_mesh(spec["world"], devices=spec["device"])
    ref = spec["reference"] and rank == 0
    coeff_fn = c3_coeffs(c3)
    out = {"rank": rank, "lr": c3["lr"], "ref": {}}

    def counted_solve(fn):
        solvers.reset_counts()
        result, launches = _par_counted(fn, device)
        counts = {k: solvers.COUNTS.get("forward", {}).get(k, 0)
                  for k in ("solves", "nfe", "accepted", "rejected")}
        if "reverse" in solvers.COUNTS:     # odeint_adjoint's reverse solves (18c)
            counts.update({f"reverse_{k}": solvers.COUNTS["reverse"].get(k, 0)
                           for k in ("solves", "nfe", "accepted", "rejected")})
        return {"out": result, "launches": launches, "counts": counts}

    x_req, _ = c3_batch(c3, c3["requests"], 43)
    requests = [r.astype(np.float32) for r in x_req]
    serve_kw = dict(coeff_fn=coeff_fn, batch_buckets=(c3["requests"],),
                    length_multiple=c3["L"])
    x, labels = c3_batch(c3, c3["B"], 41)
    inputs = coeff_fn(torch.as_tensor(x, dtype=dtype, device=device))
    labels = torch.as_tensor(labels, dtype=dtype, device=device)
    shard_in, shard_lab = pm.shard_batch((inputs, labels), mesh)

    def step(model, mesh_, batch):
        init = _state(model)
        run = make_train_step(model, loss=c3["loss"], lr=c3["lr"], mesh=mesh_)
        res = counted_solve(lambda: run(*batch, 1.0))
        res.update(params=model.state_dict(), grads=_grads(model), init=init)
        return res

    for solver in c3["solvers"]:
        model = c3_model(c3, solver, device, dtype)
        out[f"{solver}_predict"] = counted_solve(
            lambda: Predictor(model, mesh=mesh, **serve_kw).predict(requests))
        path = c3.get("artifacts", {}).get(solver)
        if path:
            loaded = load_predictor(path, mesh=mesh)
            out[f"{solver}_artifact"] = counted_solve(lambda: loaded.predict(requests))
        out[f"{solver}_step"] = step(pm.replicate(c3_model(c3, solver, device, dtype), mesh),
                                     mesh, (shard_in, shard_lab))
        if ref:
            out["ref"][f"{solver}_predict"] = counted_solve(
                lambda: Predictor(model, device=device, **serve_kw).predict(requests))
            if path:
                loaded = load_predictor(path, device=device)
                out["ref"][f"{solver}_artifact"] = counted_solve(
                    lambda: loaded.predict(requests))
            out["ref"][f"{solver}_step"] = step(c3_model(c3, solver, device, dtype), None,
                                                (inputs, labels))
    for solver in c3.get("adjoint_solvers", ()):   # ROADMAP item 18c
        out[f"{solver}_adjoint_step"] = step(
            pm.replicate(c3_model(c3, solver, device, dtype, adjoint=True), mesh), mesh,
            (shard_in, shard_lab))
        if ref:
            out["ref"][f"{solver}_adjoint_step"] = step(
                c3_model(c3, solver, device, dtype, adjoint=True), None, (inputs, labels))
    if c3.get("ensemble"):
        def ens_step(mesh_, batch, adjoint=False):
            bundle = c3_bundle(c3, device, dtype, adjoint=adjoint)
            stacked = None
            if c3.get("ensemble_params"):
                with np.load(c3["ensemble_params"]) as npz:
                    stacked = params_from_jax(dict(npz), bundle.model, stacked=True)
            state, adam = ensemble.init_ensemble(bundle, c3["ensemble"], mesh=mesh_,
                                                 params=stacked)
            init = {k: v.detach().clone() for k, v in state.items()}
            grads = _record_grads(adam)
            run = ensemble.make_ensemble_step(bundle, loss=c3["loss"], lr=c3["lr"],
                                              mesh=mesh_)
            res = counted_solve(lambda: run(state, adam, *batch, 1.0)[2])
            res.update(params=state, grads=grads, init=init)
            return res

        ens_mesh = ensemble.make_ensemble_mesh(1, spec["world"], devices=spec["device"])
        for key, adjoint in (("dopri5_ensemble_step", False),
                             ("dopri5_adjoint_ensemble_step", True)):
            if adjoint and not c3.get("adjoint_solvers"):
                continue
            out[key] = ens_step(ens_mesh, pm.shard_batch((inputs, labels), ens_mesh), adjoint)
            if ref:
                out["ref"][key] = ens_step(None, (inputs, labels), adjoint)
    if c3.get("adjoint_solvers"):    # 18c's reductions on their own
        out["summed_norms"] = summed_norm_probe(mesh.groups[pm.DATA_AXIS], spec["world"],
                                                rank, device, dtype)
        if ref:
            out["ref"]["summed_norms"] = summed_norm_probe(None, spec["world"], rank, device,
                                                           dtype)
    refusals = []
    try:
        make_train_step(c3_model(c3, "scipy_solver", device, dtype), loss=c3["loss"],
                        lr=c3["lr"], mesh=mesh)(shard_in, shard_lab, 1.0)
        refusals.append(None)
    except ValueError as exc:
        refusals.append(str(exc))
    out["refusals"] = refusals
    return out


def summed_norm_probe(group, world, rank, device, dtype):
    """ROADMAP 18c's reductions on their own: an augmented reverse state --
    row leaves (y, a: this rank's rows of the batch) and summed leaves (vt
    and a weight-shaped cotangent: this rank's part of a sum over the rows)
    -- with its error, DOP853's stages and a field, made from a seed.  Over
    ``group`` (``world`` ranks, this one ``rank``; None: one process on the
    whole batch and the parts' totals) the step-deciding quantities: dopri5's
    per-leaf error ratio, DOP853's blended one, each as one block
    (``norm="rms"``: rows and parts in one sum), and the initial step's
    norms (d0, d1, d2, h0).  Each rank's equal one process's."""
    from online_neural_cdes_tpu_torch.ops import reduce as data_reduce
    from online_neural_cdes_tpu_torch.ops import solvers

    gen = torch.Generator().manual_seed(53)
    rows, shapes = 4, [(5, 3), ()]
    n_stages = len(solvers.DOP853.c_sol)

    def draw(kind):
        """Every rank's rows (kind "rows") or parts (kind "parts") of one
        quantity, drawn alike on every rank; this rank's, or one process's
        whole batch / totals."""
        if kind == "rows":
            full = [torch.randn((world * rows, 3), generator=gen, dtype=torch.float64)
                    for _ in range(2)]
            return [x if group is None else x[rank * rows:(rank + 1) * rows] for x in full]
        parts = [torch.randn((world,) + s, generator=gen, dtype=torch.float64)
                 for s in shapes]
        return [p.sum(0) if group is None else p[rank] for p in parts]

    def state():
        return [x.to(device, dtype) for x in draw("rows") + draw("parts")]

    y0, y1, err, f0, d = state(), state(), state(), state(), state()
    err = [e * 1e-4 for e in err]
    k = [state() for _ in range(n_stages)]
    summed = [False, False, True, True]
    kw = dict(rtol=1e-5, atol=1e-7, min_step=0.0, max_step=float("inf"), first_step=None,
              safety=0.9, ifactor=10.0, dfactor=0.2)
    t = np.array([0.0, 1.0], dtype=solvers._NUMPY[dtype])

    def field(tt, y):
        # The row leaves' field row by row, the summed leaves' a part of a
        # sum (its own constant term): linear in the rows, as the adjoint's.
        return [-y[0] * 0.5, y[1] * 0.25, d[2], d[3]]

    out = {}
    with data_reduce.over(group) if group is not None else nullcontext():
        for name, tableau, blocks in (("dopri5", solvers.DOPRI5, True),
                                      ("dop853", solvers.DOP853, True),
                                      ("rms", solvers.DOPRI5, False),
                                      ("dop853_rms", solvers.DOP853, False)):
            ctl = solvers._Controller(field, y0, t, tableau, error_blocks=blocks,
                                      summed=None if group is None else summed, **kw)
            out[name] = ctl.error_ratio(err, y0, y1, k, solvers._NUMPY[dtype](0.1))
        out["initial"] = torch.stack(solvers._initial_norms(
            field, t[0], y0, kw["rtol"], kw["atol"], f0, None if group is None else summed))
    return {key: v.detach().cpu() for key, v in out.items()}


def c3_verify(ranks, failed, check, gate):
    """The C3 checks' gates (``c3_checks``): every rank's solve counts (nfe /
    accepted / rejected) and kernel launches equal one process's, the
    served rows (live and loaded) within the serving gate of one
    process's, the step's loss at PAR_LOSS_RTOL, its gradients at the
    gradient gate and its weights Adam's update (``adam_gate``), the
    adjoint steps' reverse counts too (ROADMAP 18c); the ``scipy_solver``
    refusal names C3.  Returns the readings."""
    ref = ranks[0]["c3"]["ref"]
    out = {}
    for r in ranks:
        c3, i = r["c3"], r["rank"]
        for key, want in ref.items():
            got = c3[key]
            what = f"parallel: rank {i} c3 {key}"
            if key == "summed_norms":    # each rank's decisions one process's
                out.setdefault(key, []).append(gate(what, got, want, SUMMED_NORM_RTOL, 0.0))
                continue
            if got["counts"] != want["counts"]:
                failed.append(f"{what}: counts {got['counts']}, one process's "
                              f"{want['counts']}")
            if got["launches"] != want["launches"]:
                failed.append(f"{what}: launches {got['launches']}, one process's "
                              f"{want['launches']}")
            line = {"counts": got["counts"], "one_process": want["counts"],
                    "launches": got["launches"]}
            if key.endswith("_step"):
                line["loss"] = gate(f"{what} loss", got["out"].reshape(-1),
                                    want["out"].reshape(-1), PAR_LOSS_RTOL, 0.0)
                grads = check(par_grad_gate, what, got["grads"], want["grads"])
                line["grads"] = grads if isinstance(grads, dict) else dict(
                    zip(("max_abs_err", "gate_share", "bit_identical"), grads))
                line["params"] = check(adam_gate, what, got["params"], want["params"],
                                       want["grads"], got["grads"], want["init"], c3["lr"])
            else:
                line["rows"] = gate(f"{what} rows", got["out"], want["out"], SERVE_RTOL,
                                    SERVE_ATOL)
            out.setdefault(key, []).append(line)
        if not all(msg and "C3" in msg for msg in c3["refusals"]):
            failed.append(f"parallel: rank {i} c3 refusals {c3['refusals']}")
    return out


@contextmanager
def launches_by_width(device):
    """Counts each field kernel's launches by their I (the value pieces'
    21 channels, the time pieces' 1) while open, into the dict it yields
    (``forward_I21``, ``backward_I1``, ...); on the CPU it counts nothing."""
    from online_neural_cdes_tpu_torch.ops import kernels

    widths, saved = {}, []
    if device.type == "cuda":
        # The C entry points' I argument: forward position 13, backward 19.
        for key, attr, index in (("forward", "fused_field_kernel", 13),
                                 ("backward", "fused_field_bwd_kernel", 19)):
            kernel = getattr(kernels, attr)
            fn = kernel.function()

            def by_width(*args, _fn=fn, _key=key, _index=index):
                name = f"{_key}_I{args[_index]}"
                widths[name] = widths.get(name, 0) + 1
                return _fn(*args)

            saved.append((kernel, fn))
            kernel._fn = by_width
    try:
        yield widths
    finally:
        for kernel, fn in saved:
            kernel._fn = fn


@contextmanager
def multi_launches_by_storage():
    """Counts the K-replica entries' launches by their operands' storage
    while open, into the dict it yields (``forward_multi_bfloat16``,
    ``backward_multi_float32``, ...): the storage index is each C entry
    point's third argument from the end."""
    from online_neural_cdes_tpu_torch.ops import kernels

    by_storage, saved = {}, []
    for key, attr in (("forward_multi", "fused_field_multi_kernel"),
                      ("backward_multi", "fused_field_bwd_multi_kernel")):
        kernel = getattr(kernels, attr)
        fn = kernel.function()

        def by_dtype(*args, _fn=fn, _key=key):
            name = f"{_key}_{str(kernels.STORAGE[args[-3]]).replace('torch.', '')}"
            by_storage[name] = by_storage.get(name, 0) + 1
            return _fn(*args)

        saved.append((kernel, fn))
        kernel._fn = by_dtype
    try:
        yield by_storage
    finally:
        for kernel, fn in saved:
            kernel._fn = fn


def _seq_model(spec, device, dtype, adjoint):
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(
        input_dim=spec["C"], hidden_dim=spec["H"], output_dim=1, static_dim=spec["S"],
        hidden_hidden_dim=spec["HH"], num_layers=spec["layers"], interpolation="rectilinear",
        solver="rk4", return_sequences=True, adjoint=adjoint,
        generator=torch.Generator().manual_seed(0), device=device, dtype=dtype)


def _seq_grads(model, inputs, labels, mesh, adjoint, microbatches):
    """Gradients of the masked BCE through the pipelined forward."""
    from online_neural_cdes_tpu_torch.parallel import PipelinedNCDE
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    piped = PipelinedNCDE(model, mesh=mesh, microbatches=microbatches, adjoint=adjoint)
    piped.zero_grad(set_to_none=True)
    masked_temporal_loss(make_loss("bce"), piped(inputs), labels).backward()
    return _grads(piped)


def _seq_peak(model, inputs, labels, mesh, adjoint, microbatches):
    """Bytes allocated on the card above what was live before, at the peak
    of one pipelined step (the spline, h0, forward, loss, backward) on the
    terminal states (as the JAX test's memory check: per-knot outputs are
    themselves as long as the series); the inputs are the caller's."""
    from online_neural_cdes_tpu_torch.parallel import pipelined_cde_solve
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss
    from online_neural_cdes_tpu_torch.utils.params import linear_apply

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    spline, h0 = model._setup_h0(inputs)
    func, even, args, vf = model.make_solve_func(h0)
    hidden = pipelined_cde_solve(spline, func, h0, args, mesh=mesh, substeps=1,
                                 microbatches=microbatches, vector_field_type=vf,
                                 adjoint=adjoint, even_func=even)
    masked_temporal_loss(make_loss("bce"), linear_apply(model.final, hidden),
                         labels[:, :1]).backward()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def seq_checks(rank, spec, device):
    """The time-pipelined solve (item 18b) over a ``seq`` mesh of the
    group's ranks, the flagship at ``spec["seq"]``'s batch (B rows of L
    observations, M microbatches; aux_M for the memory check):
    ``ncde_apply_pipelined`` forward; one
    Adam step through the pipelined adjoint and one through autograd
    (``adjoint=False``), each a ``make_train_step`` of ``PipelinedNCDE``
    without ``mesh=``; the adjoint's gradients on SEQ_ROWS rows on the
    card, and over the same group on the CPU in float32 and float64 (the
    plain versions); and the peak memory of an adjoint and a direct step
    at two lengths.  Each card call's launches, by kernel and by I.  Rank
    0 also runs the forward and both steps on one process (``ref``)."""
    from online_neural_cdes_tpu_torch import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.parallel import (
        PipelinedNCDE, make_sequence_mesh, ncde_apply_pipelined)
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    seq = spec["seq"]
    dtype = getattr(torch, spec["dtype"])
    M, lr = seq["M"], spec["lr"]
    mesh = make_sequence_mesh(spec["world"], devices=spec["device"])
    out = {"launches": {}, "widths": {}, "ms": {}, "ref": {}, "ref_ms": {}}
    ref = spec["reference"] and rank == 0

    def run(name, fn):
        with launches_by_width(device) as widths:
            t0 = time.perf_counter()
            result, launches = _par_counted(fn, device)
            out["ms"][name] = (time.perf_counter() - t0) * 1e3
        if launches is not None:
            out["launches"][name], out["widths"][name] = launches, widths
        return result

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        out["ref_ms"][name] = (time.perf_counter() - t0) * 1e3
        return result

    def batch(B, L, dev, dt, rows=None):
        x, static, labels = par_batch(dict(spec, B=B, L=L), 41)
        x, static, labels = x[:rows], static[:rows], labels[:rows]
        coeffs = linear_interpolation_coeffs(torch.as_tensor(x, dtype=dt, device=dev),
                                             rectilinear=0)
        return ((torch.as_tensor(static, dtype=dt, device=dev), coeffs),
                torch.as_tensor(labels, dtype=dt, device=dev))

    inputs, labels = batch(seq["B"], seq["L"], device, dtype)

    m = _seq_model(spec, device, dtype, False)
    with torch.no_grad():
        out["forward"] = run("seq_forward", lambda: ncde_apply_pipelined(
            m, inputs, mesh=mesh, microbatches=M))
        if ref:
            out["ref"]["forward"] = timed("forward", lambda: m(inputs))

    for name, adjoint in (("adjoint_step", True), ("direct_step", False)):
        m = _seq_model(spec, device, dtype, adjoint)
        init = _state(m)
        step = make_train_step(PipelinedNCDE(m, mesh=mesh, microbatches=M, adjoint=adjoint),
                               loss="bce", lr=lr)
        loss = run(f"seq_{name}", lambda: step(inputs, labels, 1.0))
        out[name] = {"loss": loss, "grads": _grads(m), "params": _state(m), "init": init}
        if ref:
            m = _seq_model(spec, device, dtype, adjoint)
            step = make_train_step(m, loss="bce", lr=lr)
            loss = timed(name, lambda: step(inputs, labels, 1.0))
            out["ref"][name] = {"loss": loss, "grads": _grads(m), "params": _state(m)}

    # The adjoint's gradients on SEQ_ROWS rows (``rows_M`` microbatches):
    # the card, then the same pipeline on the CPU (the plain versions) in
    # float32 and float64.
    rows, rows_M = seq["rows"], seq.get("rows_M", M)
    m = _seq_model(spec, device, dtype, True)
    rows_in, rows_lab = batch(seq["B"], seq["L"], device, dtype, rows)
    out["adjoint_rows"] = run("seq_adjoint_rows", lambda: _seq_grads(
        m, rows_in, rows_lab, mesh, True, rows_M))
    cpu_mesh = make_sequence_mesh(spec["world"], devices="cpu")
    for dt in (torch.float32, torch.float64):
        m_cpu = _seq_model(spec, torch.device("cpu"), dt, True)
        m_cpu.load_state_dict({k: v.to("cpu", dt) for k, v in m.state_dict().items()})
        cpu_in, cpu_lab = batch(seq["B"], seq["L"], "cpu", dt, rows)
        t0 = time.perf_counter()
        out[f"adjoint_rows_cpu_{str(dt)[6:]}"] = _seq_grads(m_cpu, cpu_in, cpu_lab, cpu_mesh,
                                                            True, rows_M)
        out["ms"][f"adjoint_rows_cpu_{str(dt)[6:]}"] = (time.perf_counter() - t0) * 1e3

    # Peak memory of a step at two lengths (the card only).
    if device.type == "cuda":
        out["peak_bytes"] = {}
        for adjoint in (True, False):
            key = "adjoint" if adjoint else "direct"
            out["peak_bytes"][key] = []
            for L in seq["memory_lengths"]:
                m = _seq_model(spec, device, dtype, adjoint)
                mem_in, mem_lab = batch(seq["memory_B"], L, device, dtype)
                out["peak_bytes"][key].append(run(f"seq_memory_{key}_{L}", lambda: _seq_peak(
                    m, mem_in, mem_lab, mesh, adjoint, seq["aux_M"])))
    return out


def par_start(world, device, out, timeout_s):
    """Start ``world`` ranks of :func:`par_worker` (spawned) before their
    spec is ready: each starts its interpreter, joins the gloo group and
    makes its CUDA context while the caller prepares the checks' inputs,
    then waits (up to ``timeout_s``) for the spec :func:`par_release`
    writes.  Returns the handle :func:`par_release` and :func:`par_join`
    take."""
    import socket

    import torch.multiprocessing as tmp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    boot = {"world": world, "device": device, "address": address, "timeout_s": timeout_s,
            "spec_file": os.path.join(out, "spec.pt")}
    return {"ctx": tmp.spawn(par_worker, args=(boot,), nprocs=world, join=False),
            "boot": boot, "out": out}


def par_release(handle, spec):
    """Hand the started ranks their spec (written whole, then renamed)."""
    path = handle["boot"]["spec_file"]
    torch.save(dict(spec, **{k: handle["boot"][k] for k in ("world", "device", "address")}),
               path + ".tmp")
    os.replace(path + ".tmp", path)


def par_join(handle, timeout_s):
    """Join the ranks within ``timeout_s`` and return their results in rank
    order.  A rank that fails, or that has not finished in time, fails the
    call (the others are stopped)."""
    ctx = handle["ctx"]
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"parallel ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
    return [torch.load(os.path.join(handle["out"], f"rank{r}.pt"), weights_only=False)
            for r in range(handle["boot"]["world"])]


def par_stop(handle):
    """Stop the started ranks (a caller that failed before joining them)."""
    for p in handle["ctx"].processes:
        if p.is_alive():
            p.terminate()
            p.join(5.0)


def par_spawn(spec, timeout_s):
    """Start ``spec["world"]`` ranks of :func:`par_worker`, hand them
    ``spec`` and return their results in rank order (:func:`par_join`)."""
    handle = par_start(spec["world"], spec["device"], spec["out"], timeout_s)
    par_release(handle, spec)
    return par_join(handle, timeout_s)


def par_gate(what, got, want, rtol, atol):
    """Raise unless ``got`` is within the gate of ``want`` (tensors, lists
    of arrays or dicts of tensors); returns (max |err|, gate share, equal
    to the bit)."""
    if isinstance(want, dict):
        parts = [par_gate(f"{what} {k}", got[k], w, rtol, atol) for k, w in want.items()]
        return (max(p[0] for p in parts), max(p[1] for p in parts),
                all(p[2] for p in parts))
    if isinstance(want, (list, tuple)):
        parts = [par_gate(f"{what}[{i}]", g, w, rtol, atol)
                 for i, (g, w) in enumerate(zip(got, want))]
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} parts, want {len(want)}")
        return (max(p[0] for p in parts), max(p[1] for p in parts),
                all(p[2] for p in parts))
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want.float() if isinstance(want, torch.Tensor) else want, np.float64)
    if g.shape != w.shape or not np.isfinite(g).all():
        raise AssertionError(f"{what}: shape {g.shape} (want {w.shape}) or not finite")
    share = gate_share(g, w, rtol, atol) if g.size else 0.0
    if share > 1.0:
        raise AssertionError(f"{what}: gate share {share} (rtol {rtol}, atol {atol})")
    return float(np.abs(g - w).max()) if g.size else 0.0, share, bool(np.array_equal(g, w))


def toy_intervals(root, suite_cfg):
    """Each split's batches' knot intervals of the toy suite's config."""
    from online_neural_cdes_tpu_torch.data.loader import Batches
    from online_neural_cdes_tpu_torch.training.experiment import load_and_setup

    _, splits = load_and_setup(suite_cfg, root, device="cpu")
    b = int(suite_cfg["dataset"]["batch_size"])
    return [[batch[0][1].shape[1] - 1 if isinstance(batch[0], tuple)
             else batch[0].shape[1] - 1 for batch in Batches(d, b)] for d in splits]


def parallel_world_of_one(step_launches):
    """A world of one rank over NCCL in this process: the flagship step with
    ``mesh=`` equal to the step without it, to the bit.  Returns (its
    readings, its launches)."""
    import socket

    import torch.distributed as dist

    from online_neural_cdes_tpu_torch.parallel.mesh import make_mesh
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    # A world of one over NCCL.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    dist.init_process_group("nccl", init_method=address, world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        inputs, labels = train_batch("cuda")
        got, want = flagship_model("cuda"), flagship_model("cuda")
        step = make_train_step(got, loss="bce", lr=TRAIN_LR, mesh=mesh)
        loss, one_launches = counted(lambda: step(inputs, labels, 1.0))
        expect_launches("parallel: the world of one's step", one_launches, **step_launches)
        want_loss = make_train_step(want, loss="bce", lr=TRAIN_LR)(inputs, labels, 1.0)
        if not torch.equal(loss, want_loss) or not all(
                torch.equal(v, want.state_dict()[k]) for k, v in got.state_dict().items()):
            raise AssertionError("parallel: the world of one's step differs from the "
                                 "step without a mesh")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    return ({"backend": backend, "launches": one_launches, "bit_identical": True,
             "loss": float(loss)}, one_launches)


def parallel_start():
    """Data parallelism on the card, its first part.  A world of one rank
    over NCCL in this process: the flagship step with ``mesh=`` equals the
    step without it to the bit.  Then two ranks on cuda:0 over gloo, each
    launching the kernels in its own process (``par_worker``), started
    first and handed their spec once the artifacts they serve are made:
    the flagship step at B=512, gradient accumulation, an epoch step, a
    padded cross-entropy tail, prefetched shards, ``Predictor(mesh=)`` and
    ``OnlineNCDEStepper(mesh=)``, a (2 ensemble x 1 data) seed ensemble,
    one epoch of ``run --data-parallel 2`` on the toy suite, the time
    pipeline and C3's checks; the ranks export the artifacts they serve.
    Returns the state :func:`parallel_finish` joins: the ranks run their
    checks meanwhile (beside the wave and export phases, for the run's
    time)."""
    from online_neural_cdes_tpu_torch.data.builders import build_toy_bm
    from online_neural_cdes_tpu_torch.training import config

    t_phase = time.perf_counter()
    intervals = 2 * TRAIN_L - 2
    step_launches = {"forward": 2 * 4 * intervals, "backward": 4 * intervals}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    # The two ranks start (interpreter, imports, gloo group, CUDA context)
    # while this process runs the world of one (for the run's time);
    # they wait for their spec.
    handle = par_start(2, "cuda:0", tmp, PAR_TIMEOUT_S)
    try:
        world_of_one, one_launches = parallel_world_of_one(step_launches)
        root = os.path.join(tmp, "toy")
        build_toy_bm(root=root)
        config_dir = os.path.join(tmp, "configurations")
        os.makedirs(config_dir)
        shutil.copy(os.path.join(config.DEFAULT_CONFIG_DIR, "dataset.json5"), config_dir)
        toy = config.load_json(os.path.join(config.DEFAULT_CONFIG_DIR,
                                            "configurations.json5"))["toy"]
        toy["trainer"] = dict(toy["trainer"], max_epochs=[1])
        with open(os.path.join(config_dir, "configurations.json5"), "w") as fh:
            json.dump({PAR_TOY_SUITE: toy}, fh)
        (suite_cfg,), _ = config.parse_configuration_json(PAR_TOY_SUITE, config_dir)
        # The artifacts the ranks serve over the mesh (the flagship's
        # predictor at bucket 64 and its stepper at 63 and 64 streams; C3's
        # dopri5 predictor) are exported by the ranks themselves, one each
        # (``par_worker``'s ``prepare``).
        spec = dict(world=2, device="cuda:0", dtype="float32", B=TRAIN_B, L=PAR_LENGTH, C=C,
                    H=H, HH=HH, layers=N_LAYERS, S=STATIC, lr=TRAIN_LR, accum=2,
                    classes=PAR_CLASSES, requests=N_REQUESTS, buckets=(2, N_REQUESTS),
                    length_multiple=LENGTH_MULTIPLE, streams=PAR_STREAMS, ticks=PAR_TICKS,
                    reference=True, out=tmp, prepare=True,
                    toy={"suite": PAR_TOY_SUITE, "config_dir": config_dir, "root": root,
                         "ledger": os.path.join(tmp, "dp.jsonl"),
                         "serial_ledger": os.path.join(tmp, "serial.jsonl")},
                    seq={"B": SEQ_B, "L": SEQ_L, "M": SEQ_M, "rows": SEQ_ROWS,
                         "rows_M": SEQ_ROWS_M,
                         "aux_M": SEQ_AUX_M, "memory_B": SEQ_MEM_B,
                         "memory_lengths": SEQ_MEM_LENGTHS})
        par_release(handle, spec)
        SHARED_CARD.append("the parallel phase's two ranks")
    except BaseException:
        par_stop(handle)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dict(handle=handle, tmp=tmp, t_phase=t_phase, spec=spec, root=root,
                suite_cfg=suite_cfg, world_of_one=world_of_one, one_launches=one_launches,
                step_launches=step_launches, intervals=intervals,
                t_release=time.perf_counter())


def parallel_abort(state):
    """Stop the started ranks and remove their directory (a phase between
    :func:`parallel_start` and :func:`parallel_finish` failed)."""
    par_stop(state["handle"])
    SHARED_CARD.clear()
    shutil.rmtree(state["tmp"], ignore_errors=True)


def parallel_finish(state):
    """The parallel phase's second part: the ranks joined, their results
    held against the reckoning and rank 0's single-process runs, each
    rank's launches against the reckoning."""
    handle, tmp, t_phase, spec, root = (state[k] for k in ("handle", "tmp", "t_phase", "spec",
                                                            "root"))
    suite_cfg, world_of_one, one_launches = (state[k] for k in ("suite_cfg", "world_of_one",
                                                                "one_launches"))
    step_launches, intervals = state["step_launches"], state["intervals"]
    try:
        ranks = par_join(handle, PAR_TIMEOUT_S)
        SHARED_CARD.clear()
        spawn_s = time.perf_counter() - state["t_release"]

        # The reckoning: RK4 evaluates the field 4 times an interval; the
        # flagship steps run the interval adjoint (2 forward passes, 1
        # backward), the ensemble autograd through RK4 on the multi entries.
        requests, _ = par_requests(spec)
        padded = -(-max(len(r) for r in requests) // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
        train_iv, val_iv, test_iv = toy_intervals(root, suite_cfg)
        toy_epoch = sum(train_iv)
        want_launches = {
            "train_step": step_launches,
            "accum_step": {k: 2 * v for k, v in step_launches.items()},
            "epoch_step": {k: 2 * v for k, v in step_launches.items()},
            "ce_step": step_launches,
            "forward": {"forward": 4 * intervals},
            "predict": {"forward": 4 * (2 * padded - 2)},
            "stream": {"forward": 2 * 4 * (PAR_TICKS - 1)},
            "ensemble_step": {"forward_multi": 4 * intervals, "backward_multi": 4 * intervals},
            "run_data_parallel": {
                "forward": 4 * train_iv[0] + 2 * 4 * toy_epoch + 4 * sum(val_iv)
                + 4 * (toy_epoch + sum(val_iv) + sum(test_iv)),
                "backward": 4 * toy_epoch}}
        want_export = {"artifact_predict": want_launches["predict"],
                       "artifact_stream": want_launches["stream"]}
        for r in ranks:
            for name, want in want_launches.items():
                expect_launches(f"parallel: rank {r['rank']} {name}", r["launches"][name],
                                **want)
            for name, want in want_export.items():
                expect_launches(f"parallel: rank {r['rank']} {name}",
                                r["export"]["launches"][name], **want)
        want_seq = seq_launches(spec)
        for r in ranks:
            for name, (want, widths) in want_seq.items():
                expect_launches(f"parallel: rank {r['rank']} {name}",
                                r["seq"]["launches"][name], **want)
                if r["seq"]["widths"][name] != widths:
                    raise AssertionError(f"parallel: rank {r['rank']} {name} launched "
                                         f"{r['seq']['widths'][name]} by width, expected "
                                         f"{widths}")
        gates, serial, failed = par_verify(ranks)
        emit("parallel", failed=failed, world_of_one=world_of_one, ranks=len(ranks), backend="gloo",
             device="cuda:0", spawn_seconds=spawn_s,
             launches={f"rank{r['rank']}": {**r["launches"], **r["export"]["launches"]}
                       for r in ranks},
             expected_launches={**want_launches, **want_export}, gates=gates,
             artifacts_seconds=[r["artifacts_seconds"] for r in ranks],
             tolerance={"loss_rtol": PAR_LOSS_RTOL, "param_rtol": PAR_PARAM_RTOL,
                        "param_atol": PAR_PARAM_ATOL, "grad_rtol": GRAD_RTOL,
                        "grad_atol_per_max": GRAD_ATOL_REL, "row_rtol": SERVE_RTOL,
                        "row_atol": SERVE_ATOL, "run_rtol": PAR_RUN_RTOL},
             toy={"intervals": [train_iv, val_iv, test_iv],
                  "data_parallel": {k: ranks[0]["run"][0][k] for k in (
                      "train.loss", "val.loss", "test.loss", "time_per_epoch")},
                  "serial": {k: serial[k] for k in (
                      "train.loss", "val.loss", "test.loss", "time_per_epoch")}},
             ce_padded_rows=ranks[0]["ce_step"]["padded_rows"],
             seq={"batch": {"B": SEQ_B, "L": SEQ_L, "M": SEQ_M, "rows": SEQ_ROWS,
                            "rows_M": SEQ_ROWS_M, "aux_M": SEQ_AUX_M, "memory_B": SEQ_MEM_B,
                            "memory_lengths": SEQ_MEM_LENGTHS},
                  "launches": {f"rank{r['rank']}": r["seq"]["launches"] for r in ranks},
                  "by_width": {f"rank{r['rank']}": r["seq"]["widths"] for r in ranks},
                  "expected": {k: {"kernels": w, "by_width": b}
                               for k, (w, b) in want_seq.items()},
                  "pipelined_ms": {f"rank{r['rank']}": r["seq"]["ms"] for r in ranks},
                  "one_process_ms": ranks[0]["seq"]["ref_ms"],
                  "peak_bytes": {f"rank{r['rank']}": r["seq"]["peak_bytes"] for r in ranks},
                  "tolerance": {"forward_rtol": SERVE_RTOL, "forward_atol": SERVE_ATOL,
                                "loss_rtol": SERVE_RTOL, "grad_rtol": GRAD_RTOL,
                                "grad_atol_per_max": GRAD_ATOL_REL,
                                "rows_ratio": SEQ_ROWS_RATIO,
                                "memory_direct_growth": SEQ_MEM_DIRECT_GROWTH,
                                "memory_adjoint_growth": SEQ_MEM_ADJOINT_GROWTH}},
             phase_seconds=time.perf_counter() - t_phase)
        if failed:
            raise AssertionError(f"parallel: {len(failed)} gates failed: {failed}")
    finally:
        par_stop(handle)
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]["launches"]
    return {"dp_world_of_one_step": one_launches, "dp_train_step": r0["train_step"],
            "dp_predict": r0["predict"], "dp_stream": r0["stream"],
            "dp_ensemble_step": r0["ensemble_step"], "dp_toy_suite": r0["run_data_parallel"],
            "dp_artifact_predict": ranks[0]["export"]["launches"]["artifact_predict"],
            "dp_artifact_stream": ranks[0]["export"]["launches"]["artifact_stream"],
            **{f"dp_c3_{key}": ranks[0]["c3"][key]["launches"] for key in ranks[0]["c3"]["ref"]
               if key != "summed_norms"},
            **{name: ranks[0]["seq"]["launches"][name] for name in (
                "seq_forward", "seq_adjoint_step", "seq_direct_step")}}


def seq_launches(spec):
    """Each pipelined call's launches on a rank, by kernel and by I: RK4
    evaluates the field 4 times an interval, a rank's chunk is Tc =
    pieces / ranks intervals for each of M microbatches, half of them
    value pieces (I=C) and half time pieces (I=1); the adjoint's forward
    pass and its reverse stages each evaluate the field once a stage and
    the reverse stages take its VJP; autograd takes the VJP of every
    forward evaluation."""
    seq, world, c = spec["seq"], spec["world"], spec["C"]

    def counts(L, adjoint, M=seq["M"]):
        evals = 4 * M * (2 * L - 2) // world
        fwd, bwd = (2 * evals, evals) if adjoint else (evals, evals)
        widths = {f"forward_I{c}": fwd // 2, "forward_I1": fwd // 2}
        if bwd:
            widths.update({f"backward_I{c}": bwd // 2, "backward_I1": bwd // 2})
        return {"forward": fwd, "backward": bwd}, widths

    evals = 4 * seq["M"] * (2 * seq["L"] - 2) // world
    want = {"seq_forward": ({"forward": evals},
                            {f"forward_I{c}": evals // 2, "forward_I1": evals // 2}),
            "seq_adjoint_step": counts(seq["L"], True),
            "seq_direct_step": counts(seq["L"], False),
            "seq_adjoint_rows": counts(seq["L"], True, seq.get("rows_M", seq["M"]))}
    for L in seq["memory_lengths"]:
        want[f"seq_memory_adjoint_{L}"] = counts(L, True, seq["aux_M"])
        want[f"seq_memory_direct_{L}"] = counts(L, False, seq["aux_M"])
    return want


def c3_spec(tmp):
    """The parallel phase's C3 checks (``c3_checks``): config 3's model on
    dopri5 and on implicit Adams (Hermite, C=9, H=HH=32, 2 layers, one
    output a series, MSE) on its B=512 batch and 64 requests of its 24
    observations, the second half of each 4 times rougher; the dopri5
    predictor exported with one bucket."""
    from online_neural_cdes_tpu_torch import Predictor
    from online_neural_cdes_tpu_torch.serving_export import export_predictor

    c3 = dict(B=CFG3_B, requests=N_REQUESTS, L=CFG3_L, C=CFG3_C, H=CFG3_H, HH=CFG3_H,
              layers=2, interpolation="hermite", return_sequences=False, loss="mse",
              lr=5e-3, solvers=("dopri5", "implicit_adams"),
              adjoint_solvers=("dopri5", "implicit_adams"))
    path = os.path.join(tmp, "c3_dopri5_artifact")
    export_predictor(Predictor(c3_model(c3, "dopri5", torch.device("cuda"), torch.float32),
                               coeff_fn=c3_coeffs(c3), batch_buckets=(c3["requests"],),
                               length_multiple=c3["L"], device="cuda"),
                     path, channels=c3["C"], max_length=c3["L"])
    return dict(c3, artifacts={"dopri5": path})


def par_artifacts(tmp):
    """The parallel phase's artifacts: the flagship predictor at bucket 64
    with one length bucket, PAR_LENGTH rounded up to LENGTH_MULTIPLE (the
    length every request batch of the phase pads to), and its stepper at
    PAR_STREAMS - 1 and PAR_STREAMS streams, with statics."""
    from online_neural_cdes_tpu_torch import OnlineNCDEStepper, Predictor
    from online_neural_cdes_tpu_torch.serving_export import export_predictor, export_stepper

    model = flagship_model("cuda")
    paths = {"predictor": os.path.join(tmp, "artifact_predictor"),
             "stepper": os.path.join(tmp, "artifact_stepper")}
    padded = -(-PAR_LENGTH // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
    export_predictor(Predictor(model, coeff_fn=rectilinear_coeffs,
                               batch_buckets=(N_REQUESTS,), length_multiple=padded,
                               device="cuda"),
                     paths["predictor"], channels=C, max_length=padded,
                     static_dim=STATIC)
    stepper = OnlineNCDEStepper(model, static=np.zeros((1, STATIC), np.float32),
                                device="cuda")
    export_stepper(stepper, paths["stepper"], batch_sizes=(PAR_STREAMS - 1, PAR_STREAMS),
                   channels=C)
    return {"predictor": paths["predictor"], "steppers": {"plain": (paths["stepper"], True)},
            "B": PAR_STREAMS, "odd": PAR_STREAMS - 1}


def _same_bits(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def par_grad_gate(what, got, want):
    """Sharded against one process's gradients, each tensor within the
    train phase's card-vs-CPU gate, GRAD_RTOL |want| + GRAD_ATOL_REL
    max|want|."""
    parts = []
    for k, w in want.items():
        atol = GRAD_ATOL_REL * float(w.abs().max())
        parts.append(par_gate(f"{what} gradient of {k}", got[k], w, GRAD_RTOL, atol))
    return (max(p[0] for p in parts), max(p[1] for p in parts), all(p[2] for p in parts))


def own_update_gate(what, got, got_grads, init, lr, keys=None):
    """Raise unless the weights ``got`` (those of ``keys``) after Adam's
    first step are the update from ``init`` by the step's own gradients,
    lr g / (|g| + eps) (x10 on the readout), within PAR_PARAM_RTOL |w| +
    PAR_PARAM_ATOL; returns the largest |err|."""
    worst = 0.0
    for k in keys or got:
        w, g = got[k], got_grads[k].double()
        k_lr = lr * (10.0 if k.split(".")[0] == "final" else 1.0)
        own = init[k].double() - k_lr * g / (g.abs() + ADAM_EPS)
        err = (w.double() - own).abs()
        if bool((err > PAR_PARAM_ATOL + PAR_PARAM_RTOL * own.abs()).any()):
            raise AssertionError(f"{what} {k}: not Adam's update from its own gradients, "
                                 f"max |err| {float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def adam_gate(what, got, want, grads, got_grads, init, lr):
    """Weights after one Adam step (the learning rate ``lr``, x10 on the
    readout), sharded against one process.  Adam's first step moves a
    weight by lr g / (|g| + eps) (the bias corrections cancel), about lr
    whatever the gradient's size.  So each weight is held twice: to the
    update from ``init`` by the step's own gradients ``got_grads`` within
    PAR_PARAM_RTOL |w| + PAR_PARAM_ATOL (the step applied the gradients
    the gradient gate held), and to one process's weights within that plus
    what the update moves across the gradient gate (one process's gradient
    ``grads`` +- GRAD_RTOL |g| + GRAD_ATOL_REL max|g|): a gradient within
    its gate of 0 may move its weight by up to 2 lr the other way."""

    def update(x):
        return x / (x.abs() + ADAM_EPS)

    own_worst = own_update_gate(what, got, got_grads, init, lr, keys=want)
    share, worst, moved = 0.0, 0.0, 0
    for k, w in want.items():
        g_got, w = got[k].double(), w.double()
        k_lr = lr * (10.0 if k.split(".")[0] == "final" else 1.0)
        err = (g_got - w).abs()
        tight = PAR_PARAM_ATOL + PAR_PARAM_RTOL * w.abs()
        g = grads[k].double()
        delta = GRAD_RTOL * g.abs() + GRAD_ATOL_REL * g.abs().max()
        allowed = tight + k_lr * torch.maximum(update(g + delta) - update(g),
                                               update(g) - update(g - delta))
        if bool((err > allowed).any()):
            raise AssertionError(f"{what} {k}: {int((err > allowed).sum())} weights past "
                                 f"their gate, max |err| {float(err.max())}")
        moved += int((err > tight).sum())
        share = max(share, float((err / allowed).max()))
        worst = max(worst, float(err.max()))
    return {"max_abs_err": worst, "gate_share": share, "past_the_tight_gate": moved,
            "own_update_max_abs_err": own_worst}


def par_verify(ranks):
    """Every rank's sharded results against rank 0's single-process ones,
    at the parallel phase's gates; returns (the gates' readings, the
    serial toy run's results, the gates that failed).  Every gate is read
    before any failure is reported, so one run shows them all."""
    gates, failed = {}, []
    ref = ranks[0]["ref"]
    readings = ("max_abs_err", "gate_share", "bit_identical")

    def check(fn, *args):
        try:
            return fn(*args)
        except AssertionError as exc:
            failed.append(str(exc))
            return {"failed": str(exc)}

    def gate(*args):
        out = check(par_gate, *args)
        return out if isinstance(out, dict) else dict(zip(readings, out))

    for name in ("train_step", "accum_step", "epoch_step", "ce_step", "ensemble_step"):
        want = ref[name]
        if name != "ensemble_step":
            keys = ("loss", "grads", "params") + (("first",) if name == "epoch_step" else ())
            for r in ranks[1:]:   # the replicas stay in step, to the bit
                for key in keys:
                    if not _same_bits(r[name][key], ranks[0][name][key]):
                        failed.append(f"parallel: {name} {key} differs between ranks")
        # An epoch is gated on its first step (the same batch and weights
        # as the train step's); its second step starts from weights that
        # differ by the first step's sign-uncertain entries (adam_gate), so
        # its losses are held to GRAD_RTOL and its final weights and
        # gradients are read, not gated.
        epoch = name == "epoch_step"
        per_rank = []
        for r in ranks:
            got, i = r[name], r["rank"]
            one, want_one = (got["first"], want["first"]) if epoch else (got, want)

            def lane(tree):
                return ({k: v[i:i + 1] for k, v in tree.items()}
                        if name == "ensemble_step" else tree)

            loss = gate(f"parallel: rank {i} {name} loss", got["loss"].reshape(-1)[:1],
                        want["loss"].reshape(-1)[:1], PAR_LOSS_RTOL, 0.0)
            if epoch:
                loss = {"first": loss, "later": gate(
                    f"parallel: rank {i} {name} later losses", got["loss"][1:],
                    want["loss"][1:], GRAD_RTOL, 0.0)}
            if name == "ensemble_step":
                loss = gate(f"parallel: rank {i} {name} losses", got["loss"], want["loss"],
                            PAR_LOSS_RTOL, 0.0)
            grads = check(par_grad_gate, f"parallel: rank {i} {name}", one["grads"],
                          lane(want_one["grads"]))
            entry = {
                "loss": loss,
                "grads": grads if isinstance(grads, dict) else dict(zip(readings, grads)),
                "params": check(adam_gate, f"parallel: rank {i} {name}", one["params"],
                                lane(want_one["params"]), lane(want_one["grads"]),
                                one["grads"], lane(want["init"]), r["lr"])}
            if epoch:   # read, not gated
                entry["after_the_epoch"] = {key: max(
                    float((got[key][k].double() - v.double()).abs().max())
                    for k, v in want[key].items()) for key in ("params", "grads")}
            per_rank.append(entry)
        gates[name] = per_rank
    for name in ("forward", "predict", "stream"):
        gates[name] = [gate(f"parallel: rank {r['rank']} {name}", r[name], ref[name],
                            SERVE_RTOL, SERVE_ATOL) for r in ranks]
    for g, r in zip(gates["forward"], ranks):   # which rows differ, and by how much
        err = (r["forward"] - ref["forward"]).abs().reshape(len(ref["forward"]), -1)
        scale = ref["forward"].abs().reshape(len(ref["forward"]), -1).amax(1)
        g["rows_differing"] = int((err.amax(1) > 0).sum())
        g["rows"] = len(ref["forward"])
        g["max_err_per_row_max"] = float((err.amax(1) / scale).max())
    for r in ranks:   # the served artifacts over the mesh (export_mesh_checks)
        ex = r.get("export")
        if ex is None:
            continue
        for key in ("predict", "stream"):
            got = ex[key] if key == "predict" else ex[key]["ys"]
            want = ex["ref"][key] if key == "predict" else ex["ref"][key]["ys"]
            gates.setdefault(f"artifact_{key}", []).append(gate(
                f"parallel: rank {r['rank']} artifact {key}", got, want, SERVE_RTOL,
                SERVE_ATOL))
        if ex["stream"]["rows"] != ex["ref"]["stream"]["rows"] // len(ranks):
            failed.append(f"parallel: rank {r['rank']} artifact stream holds "
                          f"{ex['stream']['rows']} streams")
    if not all(r["prefetch_equal"] for r in ranks):
        failed.append("parallel: prefetched shards differ from shard_batch's")
    for r in ranks:
        if len(r["refusals"]) != 2 or "does not divide" not in r["refusals"][1] \
                or "do not divide" not in r["refusals"][0]:
            failed.append(f"parallel: rank {r['rank']} refusals {r['refusals']}")
    (serial,) = ref["run"]
    gates["run"] = []
    for r in ranks:
        (got,) = r["run"]
        if got["epochs_run"] != 1:
            failed.append(f"parallel: the data-parallel suite ran {got['epochs_run']} epochs")
        gates["run"].append(gate(f"parallel: rank {r['rank']} run", [got[k] for k in (
            "train.loss", "val.loss", "test.loss")], [serial[k] for k in (
                "train.loss", "val.loss", "test.loss")], PAR_RUN_RTOL, 0.0))
    if [os.path.basename(f) for f in ranks[0]["run_files"]] != ["dp.jsonl"]:
        failed.append(f"parallel: ledger files {ranks[0]['run_files']}")
    if "seq" in ranks[0]:
        gates["seq"] = seq_verify(ranks, failed, check, gate)
    if "c3" in ranks[0]:
        gates["c3"] = c3_verify(ranks, failed, check, gate)
    return gates, serial, failed


def _frobenius_ratios(got, want, yardstick):
    """Per tensor ||got - want|| / ||yardstick - want|| (Frobenius), 0 / 0
    read as 0."""
    return {k: ratio(float((got[k].double().cpu() - w.double()).norm()),
                     float((yardstick[k].double() - w.double()).norm()))
            for k, w in want.items()}


def seq_verify(ranks, failed, check, gate):
    """The time-pipelined solve's gates (``seq_checks``): every rank's
    results equal rank 0's to the bit; the forward against one process's
    at the serving gate; both steps' losses at SERVE_RTOL (the forwards'
    gate) and their weights Adam's update from their own gradients; the
    direct step's gradients against one process's at the gradient gate and
    its weights against one process's (``adam_gate``); the adjoint's
    gradients on SEQ_ROWS rows no further from the CPU's float64 pipeline
    (Frobenius, per tensor) than SEQ_ROWS_RATIO times the CPU's float32
    pipeline is, plus GRAD_RTOL of the tensor (the readout's and h0's
    gradients, which no reverse integration magnifies, sit far inside
    round-off of either);
    the peak memory of a step from the shorter length to the longer: the
    direct step's at least SEQ_MEM_DIRECT_GROWTH times, the adjoint's at
    most SEQ_MEM_ADJOINT_GROWTH times and below the direct step's.  The
    adjoint step's distance to one process's interval adjoint is read, not
    gated (the pipelined adjoint reverse-integrates the state through a
    rank's chunk; see PERF.md)."""
    seq0, ref = ranks[0]["seq"], ranks[0]["seq"]["ref"]
    out = {"forward": [], "adjoint_step": [], "direct_step": [], "adjoint_rows": [],
           "memory": []}
    for r in ranks[1:]:
        for key in ("forward", "adjoint_step", "direct_step", "adjoint_rows",
                    "adjoint_rows_cpu_float32", "adjoint_rows_cpu_float64"):
            if not _same_bits(r["seq"][key], seq0[key]):
                failed.append(f"parallel: seq {key} differs between ranks")
    for r in ranks:
        seq, i = r["seq"], r["rank"]
        what = f"parallel: rank {i} seq"
        line = gate(f"{what} forward", seq["forward"], ref["forward"], SERVE_RTOL, SERVE_ATOL)
        err = (seq["forward"] - ref["forward"]).abs().reshape(len(ref["forward"]), -1)
        scale = ref["forward"].abs().reshape(len(ref["forward"]), -1).amax(1)
        line.update(rows_differing=int((err.amax(1) > 0).sum()), rows=len(ref["forward"]),
                    max_err_per_row_max=float((err.amax(1) / scale).max()))
        out["forward"].append(line)
        for name in ("adjoint_step", "direct_step"):
            got, want = seq[name], ref[name]
            entry = {"loss": gate(f"{what} {name} loss", got["loss"].reshape(1),
                                  want["loss"].reshape(1), SERVE_RTOL, 0.0),
                     "own_update_max_abs_err": check(own_update_gate, f"{what} {name}",
                                                     got["params"], got["grads"],
                                                     got["init"], r["lr"])}
            if name == "direct_step":
                grads = check(par_grad_gate, f"{what} {name}", got["grads"], want["grads"])
                entry["grads"] = (grads if isinstance(grads, dict) else
                                  dict(zip(("max_abs_err", "gate_share", "bit_identical"),
                                           grads)))
                entry["params"] = check(adam_gate, f"{what} {name}", got["params"],
                                        want["params"], want["grads"], got["grads"],
                                        got["init"], r["lr"])
            else:   # read, not gated
                entry["vs_interval_adjoint_max_err_per_max"] = max(
                    float((got["grads"][k].double() - w.double()).abs().max()
                          / w.double().abs().max()) for k, w in want["grads"].items())
            out[name].append(entry)
        want64, cpu32 = seq["adjoint_rows_cpu_float64"], seq["adjoint_rows_cpu_float32"]
        ratios = _frobenius_ratios(seq["adjoint_rows"], want64, cpu32)
        shares = {k: float((seq["adjoint_rows"][k].double().cpu() - w.double()).norm())
                  / (SEQ_ROWS_RATIO * float((cpu32[k].double() - w.double()).norm())
                     + GRAD_RTOL * float(w.double().norm()))
                  for k, w in want64.items()}
        worst = max(shares.values())
        if not worst <= 1.0:
            failed.append(f"{what} adjoint gradients on the rows: gate share {worst} "
                          f"(ratios to the CPU float32's distance to float64: {ratios})")
        out["adjoint_rows"].append({
            "gate_share": worst, "max_ratio": max(ratios.values()),
            "median_ratio": float(np.median(list(ratios.values()))), "by_tensor": ratios,
            "gate": {"ratio": SEQ_ROWS_RATIO, "rtol": GRAD_RTOL},
            "cpu_float32_vs_float64_max_err_per_max": max(
                float((seq["adjoint_rows_cpu_float32"][k].double() - w.double()).abs().max()
                      / w.double().abs().max())
                for k, w in seq["adjoint_rows_cpu_float64"].items())})
        peak = seq.get("peak_bytes")
        if peak is not None:
            adj, direct = peak["adjoint"], peak["direct"]
            if not (direct[1] >= SEQ_MEM_DIRECT_GROWTH * direct[0]
                    and adj[1] <= SEQ_MEM_ADJOINT_GROWTH * adj[0] and adj[1] < direct[1]):
                failed.append(f"{what} peak memory: adjoint {adj}, direct {direct} bytes")
            out["memory"].append({"adjoint_bytes": adj, "direct_bytes": direct})
    return out


def times(t):
    return {"ms": t["kernel_us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "bound_tc_us": t["bound_tc_us"]}


def kernel_entry(name, source, replaces, launches, max_err, timings):
    """One kernel's entry: its times at TRAIN_SHAPE, and every timed
    shape's under ``by_shape``."""
    return {"name": name, "route": "cuda",
            "source": f"online_neural_cdes_tpu_torch/csrc/{source}",
            "replaces": f"online_neural_cdes_tpu/ops/kernels.py:{replaces}",
            "launches": launches, "max_abs_err": max_err,
            **times(timings[TRAIN_SHAPE]), "library_ms": None,
            "timed_shape": list(TRAIN_SHAPE),
            "by_shape": [{"shape": list(shape), **times(t)}
                         for shape, t in timings.items()]}


PHASE_SECONDS = {}


def timed_phase(name, fn, *args):
    """``fn(*args)``, its seconds added to PHASE_SECONDS[name] and printed
    (also when it raises), with the collector's passes in it.  What the
    earlier phases left alive is frozen first (``gc.freeze``), so the
    collector's passes in a late phase do not walk every object the run
    made before it."""
    gc.collect()
    gc.freeze()
    passes = sum(st["collections"] for st in gc.get_stats())
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
        print(json.dumps({"timed_phase": name, "seconds": PHASE_SECONDS[name],
                          "gc_passes": sum(st["collections"] for st in gc.get_stats())
                          - passes}), flush=True)


PHASES = ("kernel", "kernel_bwd", "kernel_rk4", "predictor", "stepper", "train",
          "chains", "splines", "toy", "train_bf16", "predict_bf16", "bench_bf16_leg",
          "adaptive", "zoo", "logode", "solver_extras", "data", "harness", "raw_data",
          "wave", "export", "parallel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES),
                    help="development aid: run only these phases (env and build "
                         "always run) and stop without the kernels and ok lines; "
                         "the smoke run proper takes no arguments")
    phases = set(ap.parse_args(argv).phases)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pk = peaks(torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    timed_phase("env", phase_env)
    timed_phase("build", phase_build)
    if "kernel" in phases:
        max_err, timings, timings_bf16, timings_multi_fwd = timed_phase(
            "kernel", phase_kernel, pk)
    timed_phase("build", join_builds)
    if "kernel_bwd" in phases:
        max_err_bwd, timings_bwd, timings_bwd_bf16, timings_multi_bwd = timed_phase(
            "kernel_bwd", phase_kernel_bwd, pk)
    if "kernel_rk4" in phases:
        (max_err_rk4, max_err_multi, timings_rk4, timings_multi,
         timings_rk4_bf16) = timed_phase("kernel_rk4", phase_kernel_rk4, pk)
    if phases & {"predictor", "stepper", "export"}:
        model, requests, static, outs, serve_launches = timed_phase("predictor", phase_predictor)
    if "stepper" in phases:
        timed_phase("stepper", phase_stepper, model, requests, static, outs)
    f32_step = None
    if "train" in phases:
        train_launches, f32_step = timed_phase("train", phase_train)
    if "chains" in phases:
        chain_launches = timed_phase("chains", phase_chains)
    if "splines" in phases:
        hermite_serve, hermite_train = timed_phase("splines", phase_splines)
    if "toy" in phases:
        timed_phase("toy", phase_toy)
    if "train_bf16" in phases:
        train_bf16_launches = timed_phase("train_bf16", phase_train_bf16, f32_step)
    if "predict_bf16" in phases:
        predict_bf16_launches = timed_phase("predict_bf16", phase_predict_bf16)
    if "bench_bf16_leg" in phases:
        timed_phase("bench_bf16_leg", phase_bench_bf16_leg)
    if "adaptive" in phases:
        adaptive_launches = timed_phase("adaptive", phase_adaptive)
    if "zoo" in phases:
        zoo_launches = timed_phase("zoo", phase_zoo)
    if "logode" in phases:
        logode_launches = timed_phase("logode", phase_logode)
    if "solver_extras" in phases:
        extras_launches = timed_phase("solver_extras", phase_solver_extras)
    if "data" in phases:
        data_launches = timed_phase("data", phase_data)
    serial = deploy = None
    if "harness" in phases:
        harness_launches, serial, deploy = timed_phase("harness", phase_harness)
    if "raw_data" in phases:
        raw_launches = timed_phase("raw_data", phase_raw_data)
    # The parallel phase's ranks run their checks beside the wave and export
    # phases (for the run's time): started here, joined after them.
    # So does the export phase, in a process of its own (export_worker).
    par_state = timed_phase("parallel", parallel_start) if "parallel" in phases else None
    export_state = None
    try:
        if "export" in phases:
            if deploy is None:   # the checkpoint to deploy from: the harness's
                _, _, deploy = timed_phase("harness", phase_harness)
            export_state = timed_phase("export", export_start, model, requests, static,
                                       outs, deploy)
        if "wave" in phases:
            wave_launches = timed_phase("wave", phase_wave, serial)
        if export_state is not None:
            export_launches = timed_phase("export", export_finish, export_state)
            export_state = None
    except BaseException:
        if export_state is not None:
            par_stop(export_state)
            shutil.rmtree(export_state["out"], ignore_errors=True)
        if par_state is not None:
            parallel_abort(par_state)
        raise
    if par_state is not None:
        parallel_launches = timed_phase("parallel", parallel_finish, par_state)
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules):
        raise AssertionError("JAX was imported")
    if phases != set(PHASES):
        print(json.dumps({"seconds": time.perf_counter() - t0, "by_phase": PHASE_SECONDS}),
              flush=True)
        print(card_line(), flush=True)
        return 0

    # Every kernel's launches on each path; ``launches`` is the count on
    # its own slice's main path: the training step for the field kernels,
    # the interval chains for the RK4 kernels.
    by_path = {"predict": serve_launches, "train_step": train_launches,
               "hermite_predict": hermite_serve, "hermite_train_step": hermite_train,
               "interval_chain": chain_launches, "train_step_bf16": train_bf16_launches,
               "predict_bf16": predict_bf16_launches, **adaptive_launches, **zoo_launches,
               **logode_launches, **extras_launches, **data_launches, **harness_launches,
               **wave_launches, **export_launches, **raw_launches, **parallel_launches}

    def paths(key):
        return {path: counts[key] for path, counts in by_path.items()}

    entries = []
    for kernel, source, replaces, key, err, tm, tm_bf16, main_path in (
            ("fused_matmul_field", "fused_field.cu", 184, "forward", max_err, timings,
             timings_bf16, "train_step"),
            ("fused_matmul_field_bwd", "fused_field_bwd.cu", 367, "backward",
             max_err_bwd, timings_bwd, timings_bwd_bf16, "train_step"),
            ("fused_rk4_interval", "fused_rk4_interval.cu", 511, "rk4", max_err_rk4,
             timings_rk4, timings_rk4_bf16, "interval_chain")):
        entry = kernel_entry(kernel, source, replaces, by_path[main_path][key], err, tm)
        entry["launches_by_path"] = paths(key)
        if key == "rk4":  # each timed shape's route and grid
            entry["routes"] = [{"shape": t["shape"], "route": t["route"],
                                "cluster": t.get("cluster"), "rows": t.get("rows"),
                                "blocks": t["blocks"]}
                               for t in tm.values()]
        if tm_bf16 is not None:
            entry["by_dtype"] = [{"mode": t["mode"], "shape": t["shape"], **times(t)}
                                 for t in tm_bf16.values()]
        entries.append(entry)
    for kernel, source, replaces, key, (err, tm) in (
            ("fused_matmul_field_multi", "fused_field.cu", 184, "forward_multi",
             timings_multi_fwd),
            ("fused_matmul_field_bwd_multi", "fused_field_bwd.cu", 367, "backward_multi",
             timings_multi_bwd)):
        entries.append({
            "name": kernel, "route": "cuda",
            "source": f"online_neural_cdes_tpu_torch/csrc/{source}",
            "replaces": f"online_neural_cdes_tpu/ops/kernels.py:{replaces} (under jax.vmap)",
            "launches": by_path["wave"][key], "max_abs_err": err,
            **times(tm[MULTI_MAIN]), "library_ms": None, "K": MULTI_MAIN[0],
            "timed_shape": list(MULTI_MAIN[1]),
            "k_single_ms": tm[MULTI_MAIN]["k_single_us"] / 1e3,
            "by_shape": [{"K": t["K"], "shape": t["shape"], "mode": t.get("mode", "float32"),
                          **times(t), "k_single_ms": t["k_single_us"] / 1e3}
                         for t in tm.values()],
            "launches_by_path": paths(key)})
    k_main = RK4_MULTI_TIMED[0]
    entries.append({
        "name": "fused_rk4_interval_multi", "route": "cuda",
        "source": "online_neural_cdes_tpu_torch/csrc/fused_rk4_interval.cu",
        "replaces": "online_neural_cdes_tpu/ops/kernels.py:637",
        "launches": chain_launches["rk4_multi"], "max_abs_err": max_err_multi,
        **times(timings_multi[k_main]), "library_ms": None, "K": k_main,
        "timed_shape": list(TRAIN_SHAPE),
        "by_K": [{"K": k, **times(t), "route": t["route"], "rows": t.get("rows"),
                  "clusters": t.get("clusters"),
                  "clusters_at_once": t.get("clusters_at_once")}
                 for k, t in timings_multi.items()],
        "launches_by_path": paths("rk4_multi")})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0, "by_phase": PHASE_SECONDS}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
