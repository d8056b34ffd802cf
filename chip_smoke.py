"""Drive the PyTorch/CUDA port's serving, training and command-line paths once on one NVIDIA GPU.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --grid-precision`` runs phases 1-2 and then only
the comparison of the grid route's preconditioner built five ways on phase
10a's system (``phase_grid_precision``); ``--stack-apply`` phases 1-2 and
then the slice-stack apply's int8 products in each layout they could take
(``phase_stack_apply``); ``--atat-factors`` phases 1-2 and then phase 8d's
task by CG with each factor and first matvec rung (``phase_atat_factors``);
``--strip-apply`` phases 1-2 and then the int8 products of the pair route's
strip solve in each layout they could take (``phase_strip_apply``).

It imports only the port (``sgdml_tpu_torch``), builds its CUDA kernels from
``sgdml_tpu_torch/csrc/`` into ``build/kernels/``, and runs these phases,
each a plain assertion that ends the run with a traceback when it fails:

1. device: a CUDA card is required; prints its name and power limit;
2. build: builds the fused (E, F) kernel K1 and prints the build time, the
   ptxas report of each kernel and the count of FP64 tensor-core
   instructions (``DMMA``) in the SASS of the f64 two-pass kernels;
3. K1 against its plain PyTorch version on the card, f32 and f64, with and
   without the energy constraint, launched twice for the same bits: the
   route that ``route(T, D)`` picks at a ragged shape, the ethanol width, the
   aspirin width and the full AT-AT width at B = 1, 512 and 10,000; both
   routes at the ragged and aspirin shapes; pass A's planes and pass B's
   forces each against its own plain version. Then kernel and plain times
   at those shapes, and both routes' times across widths (the measurement
   that sets ``ONE_PASS_MAX_STEPS``), and the two passes' times on their own;
4. the golden model (trained by the original sGDML) through
   ``GDMLPredict(device='cuda')`` against the reference's predictions;
5. serving at full AT-AT width (N=60, M=3000, D=1770) through
   ``GDMLPredict.predict`` for requests of 1, 17, 512 and 10,000 geometries
   in f64 and f32, each against the plain path, and geometries per second;
6. 200 NVE steps and 50 Langevin steps of MD on the golden model, one K1
   launch per force evaluation;
7. training on the card through ``GDMLTrain(device='cuda')``: (a) the dense
   kernel assembly against the reference's golden kernels and against the
   CPU plain path at a ragged shape with two permutations; (b) the
   reference's training recipes (the golden split, std, coefficients,
   integration constant and predictions; energy constraints; a symmetric
   molecule with and without discovered permutations); (c) the ethanol
   recipe of ``bench.py`` at M = 200, whose held-out force MAE must be the
   JAX package's, and at M = 1000 (27,000 unknowns), with each phase's
   seconds, the peak device memory and K1's launches, and the assembly at
   the JAX package's 64 MB tile budget and at the port's, in turns. K1 runs
   in the integration constant and in every validation prediction;
8. training by CG on the card (``GDMLTrain(device='cuda').train(task,
   solver='cg')`` and ``Iterative.solve``), K1 in every matvec: (a) the
   ill-conditioned anchor of ``tests/dev_sigma_warmstart.py`` (M=200, five
   sigmas, at two budgets) against the JAX package's CPU f64 iteration
   counts; (b) ethanol M=1000 by CG with k capped well below M, against
   phase 7c's dense model; (c) the aspirin recipe of ``bench_large.py``
   (63,000 unknowns, past the dense bound): convergence, the re-measured
   residual, the held-out force MAE, seconds by phase and peak memory; (d)
   the full AT-AT width (540,000 unknowns) under a wall budget: the factor
   at the memory cap, a falling residual, iterations per second, and the
   column assembly at the JAX package's 1.5 GB tile budget and the port's in
   turns. In 8c and 8d the residual is re-measured, and three factor
   columns are checked, through the plain contraction, apart from K1 and
   the solver's matvec. Each CG width also holds K1 against its plain
   version on the solve's own tables (one matvec's inputs) and times one
   iteration's parts (the matvec, K1 inside it, the Woodbury apply); those
   launches are not counted;
9. the command line (``sgdml_tpu_torch.cli``) and the host modules on the
   card, in a temporary directory with the tune cache pointed there: (a) the
   README's quick start ``all <ethanol> 200 1000 5000`` on phase 7c's data
   (default sigma grid, symmetry discovery, default solver), its wall and
   seconds by step; where the grid stopped, the selected sigma and the test
   errors must be the JAX package's for the same command (its CPU f64 run,
   ``tests/dev_quickstart_jax.py``); (b) ``all --gdml -s 10``
   against ``GDMLTrain`` and ``GDMLPredict`` called directly: the same
   split, coefficients within 1e-10 and recorded test errors within 1e-12;
   (c) ``train --solver cg`` cut by ``--max_seconds``, then ``resume`` to
   convergence, against phase 7c's dense model within 8b's bounds; (d) the
   batch-size tuner (``prepare_parallel``) at the AT-AT width of phase 5 in
   f64 and f32, its ladder, and a second call served from the cache; (e) the
   ASE calculator through the stand-in for ASE of the CPU tests
   (``tests/ase_standin.py``), 100 calls against ``GDMLPredict`` within
   1e-12. Launches are counted over the CLI's commands, the tuner's first
   calls and the calculator's calls, not over the library runs they are
   compared with;
10. the analytic solver's f32 block-grid route on the card (``GDMLTrain(
   device='cuda').train(task)`` past the dense bound), each run held on the
   grid route by ``grid_probe`` (``Analytic.est_memory_inplace`` and
   ``est_memory_pair`` read as infinite: ``solve`` takes the in-place f64
   route of phase 15 where it fits, and their lam is below 1e-7 lmax, where
   the JAX package's rule takes the pair route of phase 12), which asserts
   the route: (a) the aspirin recipe of
   ``bench_large.py`` ``bench_aspirin_analytic`` (63,000 unknowns) with
   ``solver=None`` (and that it is in the pair region), the residual
   re-measured through the plain contraction, the held-out force MAE, lmax,
   the lam' rungs, the refinement iterations, seconds by phase, the packed
   Cholesky's TFLOP/s, the peak memory against ``est_memory_grid``, the kept
   f32 factor against the f64 system on a probe vector, and one refinement
   iteration and its parts, each timed alone (the matvec, K1 inside it,
   checked against its plain version on the solve's tables, the grid solve
   and its leaf triangular solves); (b) phase 8c's aspirin task by the grid
   route, against 8c's CG model; (c) energy constraints on a small ethanol
   task forced past the dense route by ``max_memory``, against the dense
   model;
11. the int8 Ozaki routes (``ops/ozaki.py``; ``Iterative(factor_mode=
   'ozaki')``): (a) ``ozaki._int8_mm`` bit for bit against the float64
   product of the same int8 values at the route's shapes (the slice-stack
   apply both ways, one Gram chunk, the prediction products at the AT-AT
   width, a ragged shape that needs every padding), each timed beside
   ``torch.matmul`` on the float64 operands; the splits on the card against
   the CPU bit for bit; ``ozaki_gemm_nt``, ``matvec_sliced`` and
   ``matvec_sliced_long`` (and ``_t``) on the card against the CPU (1e-14);
   (b) the CG matvec's rungs ``ozaki``, ``ozaki8`` and ``ozaki10`` against
   ``native`` (K1) at the AT-AT and aspirin CG widths, errors beside 2^-6N
   and times beside K1's; (c) phase 8c's aspirin task and (d) phase 8d's
   AT-AT task trained again through ``train()`` with the slice-stack factor
   at the card's free memory (automatic slices; 11d also at 8 slices): k,
   the slices, the stack, the build's sweeps, iterations, the peak and the
   re-measured residual beside 8c's and 8d's; 11c must converge to 8c's MAE
   bound and agree with 8c's model; both 11d runs must take a larger k than
   8d, and the 8-slice run's residual must fall (at lam 1e-10 the 6-slice
   stack that automatic slices pick keeps it above its start in 60 s).
   Each times an iteration's parts alone (the matvec at its rung, K1 at the
   same shape, held against its plain version on the solve's tables, and
   the slice-stack apply);
12. the analytic solver's pair-precision route (``ops/pairchol.py``,
   ``Analytic._solve_pair_pcg``), each run held off the in-place f64 route
   of phase 15 by ``pair_probe`` (``Analytic.est_memory_inplace`` reads as
   infinite), so that the JAX package's pair-or-grid rule decides: (a)
   phase 10a's task through ``train()`` with ``solver=None`` must take the
   pair route without falling back (``pair_probe`` asserts it): lmax, the
   rungs and lam', the
   refinement iterations, the residual re-measured through the plain
   contraction, the held-out force MAE, seconds by phase with the factor's
   trailing updates, panel refinements and leaf Cholesky timed by CUDA
   events, the peak against ``est_memory_pair``; its lam' and its
   iterations must be below 10a's grid route's in the same run; the kept
   pair factor against the f64 system on a probe vector; an iteration's
   parts (the matvec, K1 held against its plain version on the solve's
   tables, the strip solve, its forward and transposed strip sweeps and leaf
   applies, with GB/s); the route's library products against what could
   replace them (an Ozaki trailing update against ``torch.matmul`` in f64;
   the int8 strip solve against the pair-form one); (b) phase 10c's
   energy-constrained task on the pair route against the dense model;
13. the mesh (``sgdml_tpu_torch/parallel``) on a one-rank NCCL world that the
   phase makes, with no launcher, and destroys: (a) phase 7c's ethanol M=1000
   task by ``GDMLTrain(mesh=default_mesh(1))`` against 7c's dense model (1e-7),
   with both routes' phases side by side; (b) 10a's aspirin task (63,000
   unknowns, lam 1e-10) by the sharded f64 Cholesky, whose one strip stores
   the matrix once (8 n^2 bytes against the dense route's 24 n^2): seconds by
   phase, the factor's TFLOP/s on n^3/3 and on the flops it does, the peak
   against the strip, the residual re-measured through K1, the held-out MAE
   against 10a's and the forces against 12a's pair-route model; (c) 8c's task
   by CG on the mesh (the factor column-sharded) at 8c's budget: 8c's k,
   iterations and model; (d) ``GDMLPredict(mesh=)`` at phase 5's AT-AT width
   (B = 1, 512 and 10,000) against one device, both timed; (e)
   ``dryrun_multichip(1)`` and the quick start with ``--devices 1`` against
   9a;
14. the mesh's pair and int8 routes on a second one-rank NCCL world, made
   and destroyed as phase 13's: (a) 10a's aspirin task by
   ``Analytic(mesh=, mesh_precision='pair')`` (``train.Analytic`` wrapped
   by ``mesh_pair_probe``): the pair Cholesky of ``ops/meshchol.py`` as
   the preconditioner of CG on the kept f64 strip; the rung taken and no
   f64 fallback (from the log), lam' on a rung of the ladder, the CG's
   iterations and residual, the residual re-measured through the plain
   matvec, the held-out MAE against 10a's, the forces against 13b's and
   12a's models, the peak against the strip and the pair factor (14 n^2
   bytes) plus a transient; the factor's steps timed by CUDA events, the
   CG's iteration split into the strip matvec and the two pair triangular
   solves (each timed alone on the CG's right-hand side, with GB/s), and
   the time beside 13b's, 10a's and 12a's; (b) 13b's task through
   ``solve_interleaved(layout='cyclic')`` (``ops/cyclic.py``): forces
   against 13b's model, the factor's seconds and TFLOP/s beside 13b's; (c)
   11c's run by ``GDMLTrain(mesh=)`` with the slice stack at 11c's budget
   (the column-sharded streamed build of ``spmd.
   nystrom_factor_sharded_streamed``): 11c's k, slices and stack, its
   iterations, the re-measured residual, 8c's model, the build's sweeps,
   and K1 held against its plain version on the solve's tables with an
   iteration's parts (``ozaki_split``); (d) 10c's energy-constrained
   ethanol task by the mesh pair route (against the dense model, 10c's
   bound) and by the bordered slice stack at 6 slices, renormalized
   (against the dense model by 8b's bounds: CG stops at tol 1e-4);
15. the in-place f64 route that ``Analytic.solve`` takes on one card past
   the dense bound (``ops/linalg.cholesky_``), not held: (a) 10a's task
   through ``GDMLTrain(device='cuda').train(task)`` with ``solver=None``
   and no budget patch must take it (``inplace_probe``: ``route ==
   'inplace'``, no ``'lmax'`` phase, no fallback in the solver's log):
   seconds by phase, the factor's TFLOP/s on n^3/3, the peak against ``8
   n^2`` and ``est_memory_inplace`` (it must stay within the estimate), the
   residual re-measured through K1 (13b's bound), the held-out MAE against
   10a's and the forces against 13b's model, with ``train()`` beside 10a's,
   12a's and 13b's; (b) the same recipe at M=1400 (88,200 unknowns, ``8 n^2``
   = 62.2 GB), the same checks but 13b's.

Phases 4-15 are the main path: each sets the launch counts to 0 before it
drives the path (phases 8-15 before each training run, solve or command)
and reads them right after. The last lines are the command's wall, the
kernels' JSON record, the card's name and power limit, and ``{"ok": true,
...}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sgdml_tpu_torch import cli, perm, tune
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset, generate_symmetric_md_dataset
from sgdml_tpu_torch.intf import ase_calc
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch import train as train_mod
from sgdml_tpu_torch.ops import _build, blockchol, fused_predict, ozaki, pairchol
from sgdml_tpu_torch.parallel import mesh as mesh_mod
from sgdml_tpu_torch.parallel import spmd
from sgdml_tpu_torch.parallel.dryrun import dryrun_multichip
from sgdml_tpu_torch.ops import kernel as kernel_ops
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops._precision import _true_f32
from sgdml_tpu_torch.predict import (
    GDMLPredict, _predict_from_tables_body, _predict_geoms, build_tables, center_tables, desc_perm_table,
)
from sgdml_tpu_torch.solvers import analytic as an_mod
from sgdml_tpu_torch.solvers import iterative as it_mod
from sgdml_tpu_torch.solvers.analytic import Analytic, memory_budget
from sgdml_tpu_torch.train import GDMLTrain
from sgdml_tpu_torch.utils import io

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden')

# Kernel against plain version, max |delta| over max |value| of E and F:
# f64 differ only in summation order; f32 is the bound of
# tests/test_pallas_predict.py (both sides centered f32).
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
NAME = {torch.float64: 'f64', torch.float32: 'f32'}

# Phase 3 shapes (B, T, D): T = M P training rows, D = N (N - 1) / 2.
SHAPES = {
    'ragged': (17, 37, 45),          # multiples of no tile
    'ethanol': (10_000, 1000, 36),   # N = 9
    'aspirin': (1024, 1000, 210),    # N = 21, a predict() chunk
    'at-at-1': (1, 3000, 1770),      # N = 60, one MD geometry
    'at-at': (512, 3000, 1770),
    'at-at-10k': (10_000, 3000, 1770),
}
# Both routes are checked here, elsewhere the one route(T, D) picks; both
# are timed here and at AT-AT width B=512, to hold the two designs side by side.
BOTH_ROUTES = ('ragged', 'ethanol', 'aspirin')
# Pass A and pass B are checked on their own here (ragged with 3 K splits).
PASSES = {'ragged': 3, 'at-at-1': None, 'at-at': None}
# The route-setting measurement: both routes at these widths (N = 5, 9, 15,
# 21, 30 atoms), table sizes and batches.
SWEEP_D, SWEEP_T, SWEEP_B = (10, 36, 105, 210, 435), (30, 100, 200, 400, 1000), (1, 1024)

# Phase 6: NVE step and initial temperature, picked on the CPU with the
# plain path so that the energy drift of 200 steps stays far under the
# bound (1.6e-5 of the mean kinetic energy there).
MD_DT, MD_KT, MD_STEPS, MD_DRIFT = 0.02, 0.05, 200, 1e-3

# Phase 7: the ragged assembly check (N atoms, M points: multiples of no
# tile); the ethanol recipe of bench.py (N, frames, data seed, split seed,
# validation points, sig, lam) at its two training sizes; the held-out f64
# force MAE at M = 200 that the JAX package's bench recorded (BENCH_r05.json;
# the original sGDML gives 0.031677) and the tolerance on it.
ASSEMBLY_RAGGED = (7, 23)
ETHANOL = (9, 12_000, 0, 1, 500, 10.0, 1e-10)
ETHANOL_M = (200, 1000)
ETHANOL_MAE = (200, 0.03168, 1e-4)

# Phase 8a: the anchor recipe of tests/dev_sigma_warmstart.py (N, frames,
# data seed, split seed, M, validation points, lam) and its sigmas; the JAX
# package's CPU f64 iteration counts at each budget in GB (that script rerun
# on a CPU; PERF.md), and the port's tolerance on them: 10% or 3 iterations,
# whichever is larger.
CG_ANCHOR = (9, 300, 3, 1, 200, 50, 1e-10)
CG_ANCHOR_SIGS = (6.0, 8.0, 10.0, 12.0, 15.0)
CG_ANCHOR_JAX = {0.1: (2289, 1436, 867, 618, 383), 0.75: (77, 45, 31, 22, 13)}
CG_ANCHOR_TOL = (0.10, 3)
# 8b: the budget in GB that caps k at 73 of phase 7c's M=1000 ethanol points,
# and tests/test_iterative.py's bounds against the dense model: mean force
# difference over mean |F|, and mean difference of centered energies.
CG_ETHANOL_GB = 2.0
CG_DENSE_BOUNDS = (5e-3, 1e-2)
# 8c / 8d: the recipes of bench_large.py `aspirin` and `atat3000` (N, frames,
# data seed, split seed, validation points, M, sig, lam) and their CG wall
# budgets in seconds.
CG_ASPIRIN = (21, 2200, 10, 1, 200, 1000, 15.0, 1e-8)
CG_ATAT = (60, 3600, 11, 1, 200, 3000, 25.0, 1e-10)
CG_ASPIRIN_SECONDS, CG_ATAT_SECONDS = 300.0, 60.0
# 8c's held-out force MAE bound, a share of the mean |F| of those frames
# (tests/test_torch_iterative.py's bound); the factor columns checked in 8c
# and 8d against the plain matvec of unit vectors, and their bound (max
# |delta| over max |value|; both sides are f64 sums of the same terms).
CG_MAE_SHARE = 0.08
CG_COLUMNS_CHECKED, CG_COLUMN_TOL = 3, 1e-12
# The JAX package's column staging cap, timed against the port's in 8d.
JAX_COLUMN_TILE_BYTES = 1.5e9

# Phase 9: the README's quick start (`all ethanol_dft.npz 200 1000 5000`) on
# phase 7c's ethanol data, and the JAX package's result for the same command
# on the CPU in f64 (tests/dev_quickstart_jax.py): the sigmas trained before
# the grid stopped, the selected sigma and the recorded test force and energy
# MAE, which the port's are held to within 1e-6 relative (the bound of
# tests/test_torch_cli.py on recorded errors). That force MAE is 10.6% of
# this data's mean |F|, so tests/test_cli.py's 10% bound (set at N=5) does
# not apply here. 9c's CG wall budget in seconds (8b's cold solve takes
# several times that) at 8b's memory budget; 9d's request size; 9e's
# calculator calls.
QUICKSTART = ('200', '1000', '5000')
QUICKSTART_JAX = ((10, 20, 30, 40), 30, 0.03448262107392924, 0.01582989888423556)
QUICKSTART_TOL = 1e-6
CLI_CG_CUT_SECONDS = 0.1
TUNE_BULK = 1000
ASE_CALLS = 100

# Phase 10: the recipe of bench_large.py `bench_aspirin_analytic` (N, frames,
# data seed, split seed, validation points, M, sig, lam) and its held-out
# frames; its bound on the re-measured relative residual (the grid route's
# warning threshold; the refinement CG stops at 1e-9); the refinement
# iterations that the split's timed chunk runs; 10c's ethanol training
# points with energy constraints, the budget in GB that leaves the grid
# route but not the dense one, lam (1e-8, as 8c: at the ethanol recipe's
# 1e-10 the grid route's lam'/lam is ~3e5 and its CG does not converge in
# PCG_MAX_ITERS, on the CPU at M=100 too), and the bound on the relative
# deviation of the two models' training forces (tests/test_analytic_grid.py's).
GRID_ASPIRIN = (21, 1600, 10, 1, 200, 1000, 20.0, 1e-10)
GRID_HELD_OUT = 500
GRID_RESID = 1e-6
GRID_SPLIT_ITERS = 20
# 10a's bound on the kept factor's error on its probe vector as a share of
# lam' |v|: the refinement CG pays for that error in iterations (the
# precision comparison on the H100: 0.041 took 1,736 iterations, 0.103 with
# the panel solve written into its own input 2,060, all f64 1,636). Power
# steps for the top of the preconditioned spectrum in that comparison
# (``--grid-precision``).
GRID_FACTOR_SHIFT_TOL = 0.075
GRID_EIG_STEPS = 30
GRID_ECSTR = (400, 1.0, 1e-8, 1e-7)

# Phase 12: the pair route on 10a's task and 10c's. The bound on the kept
# pair factor's error on 10a's probe vector, as a share of lam' |v|: the
# shift must absorb the factor's error for the refinement CG to keep the
# lam'/lam bound.
PAIR_FACTOR_SHIFT_TOL = 0.5
# The int8 strip solve against the pair-form one on strips rebuilt from it
# (rounded to pair precision, ~2^-33): tests/test_pairchol.py's bound
# between the int8 and the pair solves.
PAIR_SOLVE_TOL = 1e-5

# Phase 11: the AT-AT and aspirin widths of 11b's matvec rungs (B = T = M,
# D, N), the rungs, and 11a's bound on the card's Ozaki products against the
# CPU's (max |delta| over max |value|: the same int32 sums, float64 sums of
# them in another order).
OZAKI_WIDTHS = {'AT-AT': (3000, 1770, 60), 'aspirin': (1000, 210, 21)}
OZAKI_RUNGS = ('ozaki', 'ozaki8', 'ozaki10')
OZAKI_DEVICE_TOL = 1e-14
# 11d's 8-slice run must take the re-measured residual below this share of
# its start within 8d's wall budget (on the H100: 0.85 after 600 iterations
# at k=54 and 68.5 GB; the 6-slice stack, k=70, stayed at 1.0).
OZAKI_ATAT_FALL = 0.95
# ``--atat-factors``: the CG seconds of each of its five solves and the
# budget in GB they share (what 11d had free when an earlier 11a-11c run
# still held memory).
ATAT_FACTOR_SECONDS, ATAT_FACTOR_GB = 40.0, 68.5

# Phase 13: 13a's bound on the mesh's ethanol forces against the dense
# model's (max |dF| / max |F|; the two factorizations sum in different
# orders at a condition number near 1e10); 13b's bounds: its held-out MAE
# within this share of 10a's, its peak allocated in bytes, its residual
# re-measured through K1 (6.7e-10 read on the H100: 15x above that, where a
# wrong factor lands orders of magnitude higher), and its forces against
# 12a's pair-route model (1.3e-9 read; a second solve of the same system,
# held as 13a's are); 13d's request sizes and bound against the single
# device; 13e's bound on the quick start's errors against 9a's.
MESH_ETHANOL_TOL = 1e-7
MESH_MAE_SHARE = 0.01
MESH_PEAK_BYTES = 36e9
MESH_RESID = 1e-8
MESH_PAIR_TOL = 1e-7
MESH_SERVE_B = (1, 512, 10_000)
MESH_SERVE_TOL = 1e-12
MESH_CLI_TOL = 1e-7

# Phase 14: the mesh's pair and int8 routes on a one-rank world. 14a's
# bounds on the pair route's held-out forces against 13b's f64 sharded model
# and against 12a's single-device pair model (max |dF| / max |F|; three
# solves of one system, each refined to a relative residual of 1e-9, held as
# 13b's are held to 12a's; 1.8e-9 and 1.1e-9 read on the H100), and the
# transient on top of the strip and the pair factor (14 n^2 bytes) that its
# peak may reach (the first block column's panel at 62,000 rows: its f64
# copies, slices and Ozaki products; 5.71 GB read); 14b's bound on the
# cyclic layout's forces against 13b's (the same f64 factorization at
# another block size; 2.1e-10 read); 14d's slice count (below 8: the factor
# is renormalized) and its bound on the pair route against the dense model
# (10c's). 14d's slice-stack CG model stops at CG's tol 1e-4 and is held to
# the dense model by 8b's bounds (CG_DENSE_BOUNDS).
MESH_PAIR_F64_TOL = 1e-7
MESH_PAIR_12A_TOL = 1e-7
MESH_PAIR_TRANSIENT_BYTES = 8e9
MESH_CYCLIC_TOL = 1e-9
MESH_STACK_SLICES = 6
MESH_ECSTR_PAIR_TOL = 1e-7

# Phase 15: the in-place f64 route that single-card ``solve`` takes past the
# dense bound. 15a trains 10a's task; 15b the same recipe at 2,000 frames
# and M=1400 (88,200 unknowns: 8 n^2 = 62.2 GB, 24 n^2 = 186.7 GB), near the
# top of the route's window on 80 GB. 15a's bound on its forces against
# 13b's model (the same arithmetic on the one-rank mesh; 14b's layout landed
# 2.1e-10 away); 15a and 15b are held by 13b's residual bound and 10a's MAE.
INPLACE_TOP = (21, 2000, 10, 1, 200, 1400, 20.0, 1e-10)
INPLACE_13B_TOL = 1e-9

# H100 SXM data sheet: FP64 tensor-core and FP32 peak (both 67 TFLOP/s),
# dense int8 tensor-core peak (1,979 TOP/s) and HBM3 bandwidth, for the
# bounds of K1 and of the int8 products.
H100_FLOPS, H100_BYTES_PER_S = 67e12, 3.35e12
H100_INT8_OPS = 1979e12

# What a later phase holds an earlier phase's run against: phase 5's AT-AT
# queries ('5'), 8c's aspirin recipe ('8c'), 9a's quick start ('9a'), 11c's
# slice-stack run ('11c'), 12a's held-out forces ('12a') and 13b's ('13b').
RESULTS = {}


def rel_err(ours, ref):
    return float((ours - ref).abs().max() / ref.abs().max())


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, reps=None):
    """(kernel ms, plain ms), warmed up and timed in turns plain, kernel,
    kernel, plain so that clock drift falls on both alike. Without
    ``reps``, enough runs for about 20 ms of the slower one (3 to 200)."""
    kernel(), plain()
    torch.cuda.synchronize()
    if reps is None:
        reps = int(min(200, max(3, 20.0 / max(cuda_ms(kernel, 1), cuda_ms(plain, 1)))))
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available() is False)')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print('[1 device] %s | torch %s | CUDA %s | %d device(s)' % (
        torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))
    return smi


def sass_counts(lib_path, opcode):
    """{kernel: number of ``opcode`` instructions} in the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', lib_path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts = {}
    for chunk in sass.split('Function : ')[1:]:
        kind = re.search(r'([a-z_]+_kernel)I([df])', chunk.split()[0])
        name = '%s<%s>' % (kind.group(1), {'d': 'double', 'f': 'float'}[kind.group(2)])
        counts[name] = len(re.findall(r'\b%s\b' % opcode, chunk))
    return counts


def phase_build():
    t0 = time.perf_counter()
    lib = _build.load_library()
    secs = time.perf_counter() - t0
    for kernel, line in sorted(_build.ptxas_report(lib).items()):
        print('    ptxas %-29s %s' % (kernel, line))
    dmma = sass_counts(lib._name, 'DMMA')
    print('    SASS DMMA instructions: %s' % ', '.join('%s %d' % kv for kv in sorted(dmma.items())))
    for kernel in ('planes_kernel<double>', 'forces_kernel<double>'):
        assert dmma[kernel] > 0, ('no FP64 tensor-core instruction in', kernel)
    print('[2 build] K1 built and loaded in %.2f s from sgdml_tpu_torch/csrc into %s' % (
        secs, os.path.relpath(os.path.dirname(lib._name), ROOT)))


def contraction_inputs(B, T, D, dtype, with_aE, seed, device):
    """Centered random descriptors (as bench.py draws its MD22-shape tables)
    and the table-side terms, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    Xq, Xt = 0.3 + rng.random((B, D)), 0.3 + rng.random((T, D))
    JA = rng.normal(size=(T, D)) * 1e-2
    aE = rng.normal(size=T) if with_aE else None
    sig = math.sqrt(5.0 * D / 6.0) / 2.0  # typical u5 / sig near 2

    def t(x):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)

    tables = center_tables(t(Xt), t(JA))
    return (t(Xq) - tables.mu, tables.Xt, tables.JA, tables.xt_sq, tables.tja, t(aE), sig)


def check(what, kernel, plain, tol):
    """Kernel outputs against plain ones (tuples of tensors), and a second
    launch for the same bits; returns the max abs error."""
    outs, refs = kernel(), plain()
    again = kernel()
    torch.cuda.synchronize()
    errs = [rel_err(o, r) for o, r in zip(outs, refs)]
    print('    %-44s err %s  (bound %.0e)' % (what, ' '.join('%.2e' % e for e in errs), tol))
    assert all(torch.isfinite(o).all() for o in outs), what
    assert max(errs) <= tol, (what, errs)
    # No atomics: a second launch gives the same bits.
    assert all(torch.equal(o, a) for o, a in zip(outs, again)), what
    return max(float((o - r).abs().max()) for o, r in zip(outs, refs))


def phase_kernel_vs_plain(device):
    """Returns (max abs error over all cases, {(label, dtype): (ms, plain_ms)})."""
    fp = fused_predict
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_abs, n_cases = 0.0, 0
    for label, (B, T, D) in SHAPES.items():
        routes = ('one_pass', 'two_pass') if label in BOTH_ROUTES else (fp.route(T, D),)
        for dtype in (torch.float64, torch.float32):
            for with_aE in (False, True):
                args = contraction_inputs(B, T, D, dtype, with_aE, seed=B + T + D, device=device)
                plain = lambda: fp.fused_predict_tables_reference(*args)  # noqa: E731
                head = '%-9s B=%5d T=%4d D=%4d %s aE=%-5s' % (label, B, T, D, NAME[dtype], with_aE)
                for r in routes:
                    run = getattr(fp, r)
                    max_abs = max(max_abs, check('%s %s' % (head, r), lambda: run(*args), plain,
                                                 TOL[dtype]))
                    n_cases += 1
                if label in PASSES:
                    split = fp.split_k(B, D, T, n_sms)
                    if PASSES[label]:
                        n_k = 2 * -(-T // fp.TILE) * fp.TILE // fp.K_STEP
                        split = (PASSES[label], -(-n_k // PASSES[label]))
                    planes = fp.planes(*args)
                    max_abs = max(max_abs, check(
                        '%s pass A' % head, lambda: fp.planes(*args),
                        lambda: fp.planes_reference(*args), TOL[dtype]))
                    max_abs = max(max_abs, check(
                        '%s pass B, %d x %d K steps' % (head, *split),
                        lambda: fp.forces(*args[:3], *planes, *split),
                        lambda: fp.forces_reference(*args[:3], *planes, *split), TOL[dtype]))
                    n_cases += 2
    print('[3a kernel vs plain] all %d cases within bounds and bitwise repeatable; '
          'max abs error %.3e' % (n_cases, max_abs))

    times = {}
    for label, (B, T, D) in SHAPES.items():
        if label == 'ragged':
            continue
        for dtype in (torch.float64, torch.float32):
            args = contraction_inputs(B, T, D, dtype, False, seed=1, device=device)
            both = label in BOTH_ROUTES or label == 'at-at'
            line = []
            for name in ('one_pass', 'two_pass') if both else (fp.route(T, D),):
                run = getattr(fp, name)
                ms, plain_ms = time_pair(lambda: run(*args),
                                         lambda: fp.fused_predict_tables_reference(*args))
                if name == fp.route(T, D):
                    times[label, dtype] = (ms, plain_ms)
                line.append('%s %.3f ms vs plain %.3f ms (%.1f TFLOP/s)' % (
                    name, ms, plain_ms, 8.0 * B * T * D / ms * 1e-9))
            b_ms, b_by = bound(B, T, D, args[0].element_size())
            line.append('bound %.4f ms by %s, route(T, D) at %.1f%% of it' % (
                b_ms, b_by, 100 * b_ms / times[label, dtype][0]))
            print('    %-9s B=%5d T=%4d D=%4d %s  %s' % (label, B, T, D, NAME[dtype], '; '.join(line)))
            if fp.route(T, D) == 'two_pass':
                out, split = fp.planes(*args), fp.split_k(B, D, T, n_sms)
                a_ms, b_ms = time_pair(lambda: fp.planes(*args),
                                       lambda: fp.forces(*args[:3], *out, *split))
                print('    %-9s %s two_pass: pass A %.3f ms (%.1f TFLOP/s), pass B and its reduction '
                      '%.3f ms (%.1f TFLOP/s), %d K split(s)' % (
                          label, NAME[dtype], a_ms, 4.0 * B * T * D / a_ms * 1e-9, b_ms,
                          4.0 * B * T * D / b_ms * 1e-9, split[0]))
    for D in SWEEP_D:
        for T in SWEEP_T:
            for B in SWEEP_B:
                args = contraction_inputs(B, T, D, torch.float64, False, seed=2, device=device)
                one, two = time_pair(lambda: fp.one_pass(*args), lambda: fp.two_pass(*args))
                print('    route sweep f64 D=%3d T=%4d B=%4d: one_pass %.4f ms, two_pass %.4f ms '
                      '-> %s (route(T, D) = %s)' % (D, T, B, one, two,
                                                 'one_pass' if one <= two else 'two_pass', fp.route(T, D)))
    print('[3b times] kernel and plain timed in turns in this call')
    return max_abs, times


def phase_golden(device):
    model = io.load_dict(os.path.join(GOLDEN, 'model_ref.npz'))
    ref = np.load(os.path.join(GOLDEN, 'train_predict_ref.npz'))
    fused_predict.reset_launches()
    E, F = GDMLPredict(model, dtype=torch.float64, device=device).predict(ref['R_test'])
    counts = dict(fused_predict.PATH_LAUNCHES, total=fused_predict.LAUNCHES)
    np.testing.assert_allclose(E, ref['e_pred'], rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(F, ref['f_pred'], rtol=1e-8, atol=1e-9)
    assert counts['one_pass'] > 0 and counts['total'] > 0, counts
    print('[4 golden] GDMLPredict(cuda, f64) on %d geometries: max |dE| %.2e, max |dF| %.2e '
          'against the reference; launches %s' % (
              len(E), np.abs(E - ref['e_pred']).max(), np.abs(F - ref['f_pred']).max(), counts))
    return counts


def atat_model(n_atoms, n_train, R_train, z, device, seed=0):
    """A model dict in the reference layout at full AT-AT width: training
    descriptors of synthetic frames, random coefficients from a seed scaled
    so that the contracted Jacobians are ~1e-2 (as bench.py draws them), sig
    at the typical descriptor distance."""
    R_t = torch.as_tensor(R_train, dtype=torch.float64, device=device)
    X, Jc = desc_ops.descriptor_batch(R_t, n_atoms)
    rng = np.random.default_rng(seed)
    alphas = torch.as_tensor(rng.normal(size=(n_train, 3 * n_atoms)), dtype=torch.float64, device=device)
    JA = desc_ops.jac_dot_vec(Jc, alphas, n_atoms)
    scale = 1e-2 / float(JA.std())
    idx = torch.as_tensor(rng.integers(0, n_train, size=(2, 512)), device=device)
    u = torch.linalg.vector_norm(X[idx[0]] - X[idx[1]], dim=1)
    sig = float(math.sqrt(5.0) * u.median())
    return {
        'type': 'm', 'z': z, 'perms': np.arange(n_atoms)[None],
        'R_desc': X.T.cpu().numpy(), 'R_d_desc_alpha': (JA * scale).cpu().numpy(),
        'alphas_F': (alphas * scale).reshape(-1).cpu().numpy(),
        'sig': sig, 'std': 1.0, 'c': 0.0, 'lam': 1e-10,
    }


def phase_serving(device, card, n_atoms=60, n_train=3000, requests=(1, 17, 512, 10_000),
                  timed=(512, 10_000)):
    t0 = time.perf_counter()
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_train + max(requests), seed=0)
    R = ds['R'].reshape(len(ds['R']), -1)
    model = atat_model(n_atoms, n_train, R[:n_train], ds['z'], device)
    R_q = R[n_train:]
    print('    model N=%d M=%d D=%d sig=%.4g built in %.1f s (data, descriptors, tables)' % (
        n_atoms, n_train, desc_ops.descriptor_dim(n_atoms), model['sig'], time.perf_counter() - t0))

    preds = {dt: GDMLPredict(model, dtype=dt, device=device) for dt in (torch.float64, torch.float32)}

    def plain(pred, Rb):
        Xq, Jcq = desc_ops.descriptor_batch(Rb, n_atoms)
        return _predict_from_tables_body(
            Xq, Jcq, pred.tables, pred.alphas_E_lin, pred.sig, pred.std, pred.c, n_atoms=n_atoms)

    # The main path: the counts are read from 0 over exactly these requests.
    fused_predict.reset_launches()
    for dtype, pred in preds.items():
        for B in requests:
            before = fused_predict.LAUNCHES
            E, F = pred.predict(R_q[:B])
            assert fused_predict.LAUNCHES > before, 'request did not launch the kernel'
            assert E.shape == (B,) and F.shape == (B, 3 * n_atoms)
            assert np.isfinite(E).all() and np.isfinite(F).all()
            E_p, F_p = plain(pred, torch.as_tensor(R_q[:B], dtype=dtype, device=device))
            e_err = rel_err(torch.as_tensor(E), E_p.cpu())
            f_err = rel_err(torch.as_tensor(F), F_p.cpu())
            print('    predict %s B=%5d: E err %.2e  F err %.2e against the plain path (bound %.0e); '
                  '%d launch(es)' % (NAME[dtype], B, e_err, f_err, TOL[dtype], fused_predict.LAUNCHES - before))
            assert e_err <= TOL[dtype] and f_err <= TOL[dtype], (dtype, B, e_err, f_err)
    counts = dict(fused_predict.PATH_LAUNCHES, total=fused_predict.LAUNCHES)
    assert counts['pass_a'] > 0 and counts['pass_b'] > 0 and counts['one_pass'] == 0, counts

    for dtype, pred in preds.items():
        for B in timed:
            Rb = torch.as_tensor(R_q[:B], dtype=dtype, device=device)
            ms, plain_ms = time_pair(
                lambda: _predict_geoms(Rb, pred.tables, pred.alphas_E_lin, None, pred.sig,
                                       pred.std, pred.c, n_atoms=n_atoms),
                lambda: plain(pred, Rb), reps=3,
            )
            t0 = time.perf_counter()
            pred.predict(R_q[:B])
            e2e = time.perf_counter() - t0
            print('    %s B=%5d: on the device, kernel path %.0f gps (%.3f ms), plain path %.0f gps '
                  '(%.3f ms); predict() host to host %.0f gps (%s)' % (
                      NAME[dtype], B, B / ms * 1e3, ms, B / plain_ms * 1e3, plain_ms, B / e2e, card))
    print('[5 serving] AT-AT width: %d requests in f64 and f32 agree with the plain path; '
          'launches %s' % (2 * len(requests), counts))
    RESULTS['5'] = R_q
    return counts, model


def phase_md(device):
    model = io.load_dict(os.path.join(GOLDEN, 'model_ref.npz'))
    r0 = np.load(os.path.join(GOLDEN, 'train_predict_ref.npz'))['R_test'][0]
    drifts = {}
    for dev in ('cpu', device):
        eng = MDEngine(model, device=dev)
        masses = eng.masses.cpu().numpy()
        v0 = np.random.default_rng(0).normal(size=(len(masses), 3)) * np.sqrt(MD_KT / masses)[:, None]
        v0 -= (masses[:, None] * v0).sum(0) / masses.sum()
        fused_predict.reset_launches()
        R, V, E_pot, E_kin = eng.run_nve(r0, v0, MD_DT, MD_STEPS)
        E_tot = E_pot + E_kin
        drift = np.abs(E_tot - E_tot[0]).max() / E_kin.mean()
        drifts[dev] = drift
        assert np.isfinite(R).all() and np.abs(R[-1] - R[0]).max() > 1e-2
        assert drift < MD_DRIFT, (dev, drift)
    # One launch per force evaluation: the first, one per step, one per snapshot.
    nve = dict(fused_predict.PATH_LAUNCHES, total=fused_predict.LAUNCHES)
    assert nve['one_pass'] == nve['total'] == 1 + 2 * MD_STEPS and nve['pass_a'] == 0, nve
    eng = MDEngine(model, device=device)
    fused_predict.reset_launches()
    R, V, E_pot, E_kin = eng.run_langevin(r0, np.zeros_like(r0), MD_DT, 50, friction=0.1, kT=MD_KT, seed=0)
    assert np.isfinite(R).all() and np.isfinite(E_pot).all() and np.isfinite(E_kin).all()
    assert fused_predict.LAUNCHES == 1 + 2 * 50, fused_predict.LAUNCHES
    counts = {k: nve[k] + v for k, v in dict(fused_predict.PATH_LAUNCHES,
                                             total=fused_predict.LAUNCHES).items()}
    print('[6 md] NVE %d steps dt=%g: drift / mean kinetic energy %.2e on cpu, %.2e on %s '
          '(bound %.0e); Langevin 50 steps finite; one K1 launch per force evaluation; '
          'launches %s' % (MD_STEPS, MD_DT, drifts['cpu'], drifts[device], device, MD_DRIFT, counts))
    return counts


def launch_counts():
    return dict(fused_predict.PATH_LAUNCHES, total=fused_predict.LAUNCHES)


def golden_dataset():
    data = dict(np.load(os.path.join(GOLDEN, 'train_predict_ref.npz'), allow_pickle=True))
    ds = {'type': 'd', 'name': np.array('synth5'), 'theory': np.array('morse'),
          'z': data['z'], 'R': data['R'], 'E': data['E'], 'F': data['F']}
    ds['md5'] = io.dataset_md5(ds)
    return data, ds


def held_out(ds, task, n):
    """The first ``n`` frames outside the training split, as bench.py picks them."""
    ti = np.setdiff1d(np.arange(len(ds['R'])), task['idxs_train'])[:n]
    return ds['R'][ti].reshape(len(ti), -1), ds['F'][ti].reshape(len(ti), -1), ti


def phase_train_goldens(device):
    """7a: the dense assembly on the card against the reference's kernels, and
    against the CPU plain path at a ragged shape with P = 2."""
    for fixture in ('kernel_ref.npz', 'kernel_ecstr_ref.npz'):
        data = np.load(os.path.join(GOLDEN, fixture))
        K = kernel_ops.assemble_kernel(
            torch.as_tensor(data['R_desc'], device=device), torch.as_tensor(data['R_d_desc'], device=device),
            desc_perm_table(data['perms']), float(data['sig']), data['perms'].shape[1],
            use_E_cstr='ecstr' in fixture, tile_i=4, tile_j=2).cpu().numpy()
        np.testing.assert_allclose(K, data['K'], rtol=1e-8, atol=1e-10)
        print('    assemble_kernel(%s) %s: max |dK| %.2e against the reference (rtol 1e-8, atol 1e-10)' % (
            device, fixture, np.abs(K - data['K']).max()))
    n_atoms, m = ASSEMBLY_RAGGED
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=m, seed=3)
    perms = np.stack([np.arange(n_atoms), np.r_[1, 0, np.arange(2, n_atoms)]])
    for use_E_cstr in (False, True):
        Ks = {}
        for dev in ('cpu', device):
            X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'], dtype=torch.float64, device=dev), n_atoms)
            Ks[dev] = kernel_ops.assemble_kernel(X, Jc, desc_perm_table(perms), 3.0, n_atoms,
                                             use_E_cstr=use_E_cstr, tile_i=5, tile_j=7).cpu()
        err = rel_err(Ks[device], Ks['cpu'])
        print('    assemble_kernel N=%d M=%d P=2 tiles 5 x 7 E_cstr=%s: %s against the CPU plain path '
              '%.2e of max |K| (bound 1e-12)' % (n_atoms, m, use_E_cstr, device, err))
        assert err <= 1e-12, err


def phase_train_reference(device):
    """7b: the reference's training recipes (tests/test_train.py and
    tests/test_perm.py) on the card, held to their tolerances."""
    data, ds = golden_dataset()
    trainer = GDMLTrain(device=device)
    task = trainer.create_task(ds, 30, ds, 20, sig=4.0, lam=1e-10, use_sym=False, rng=np.random.RandomState(7))
    model = trainer.train(task, solver='analytic')
    np.testing.assert_array_equal(task['idxs_train'], data['idxs_train'])
    np.testing.assert_allclose(model['std'], data['std'], rtol=1e-12)
    a_err = np.abs(model['alphas_F'] - data['alphas_F']).max() / np.abs(data['alphas_F']).max()
    assert a_err < 1e-4, a_err
    np.testing.assert_allclose(model['c'], data['c'], rtol=1e-5)
    E, F = GDMLPredict(model, device=device).predict(data['R_test'])
    np.testing.assert_allclose(E, data['e_pred'], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(F, data['f_pred'], rtol=1e-5, atol=1e-7)
    print('    golden recipe: split identical; alphas_F %.2e of max |alpha| (bound 1e-4); c %.2e rel (1e-5); '
          'max |dE| %.2e, max |dF| %.2e against the reference' % (
              a_err, abs(model['c'] - data['c']) / abs(data['c']), np.abs(E - data['e_pred']).max(),
              np.abs(F - data['f_pred']).max()))

    task = trainer.create_task(ds, 25, ds, 10, sig=4.0, lam=1e-10, use_sym=False, use_E_cstr=True,
                               rng=np.random.RandomState(3))
    model = trainer.train(task, solver='analytic')
    E, _ = GDMLPredict(model, device=device).predict(data['R_test'])
    e_mae = np.abs(E - data['E'][100:120]).mean()
    assert 'alphas_E' in model and e_mae < 0.1, e_mae
    print('    use_E_cstr recipe: energy MAE %.4f on R_test (bound 0.1)' % e_mae)

    sym = generate_symmetric_md_dataset(n_frames=60, seed=0)
    maes, n_perms = {}, {}
    for use_sym in (False, True):
        task = trainer.create_task(sym, 30, sym, 10, sig=6.0, lam=1e-10, use_sym=use_sym,
                                   rng=np.random.RandomState(13))
        model = trainer.train(task, solver='analytic')
        R, F_ref, _ = held_out(sym, task, 40)
        _, F = GDMLPredict(model, device=device).predict(R)
        maes[use_sym], n_perms[use_sym] = np.abs(F - F_ref).mean(), task['perms'].shape[0]
    assert n_perms[True] > 1 and maes[True] <= 1.1 * maes[False], (n_perms, maes)
    print('    symmetric molecule: find_perms found P=%d; force MAE sGDML %.4f vs GDML %.4f (bound 1.1x)' % (
        n_perms[True], maes[True], maes[False]))


def phase_train_ethanol(device, card):
    """7c: the ethanol recipe of bench.py at M = 200 (force MAE against the
    JAX package's) and at M = 1000 (phase seconds and peak memory), and the
    assembly at the JAX package's 64 MB tile budget and at the port's."""
    n_atoms, n_frames, seed, split_seed, n_valid, sig, lam = ETHANOL
    t0 = time.perf_counter()
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_frames, seed=seed)
    print('    ethanol data N=%d, %d frames in %.1f s' % (n_atoms, n_frames, time.perf_counter() - t0))
    for m in ETHANOL_M:
        trainer = GDMLTrain(device=device)
        task = trainer.create_task(ds, m, ds, n_valid, sig=sig, lam=lam, use_sym=False,
                                   rng=np.random.RandomState(split_seed))
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        # Twice: the first call also pays one-off set-up (cuSOLVER's handle
        # and workspace, the allocator's growth).
        cold = trainer.train(task, solver='analytic')
        t_cold = trainer.times['total']
        model = trainer.train(task, solver='analytic')
        a_diff = np.abs(cold['alphas_F'] - model['alphas_F']).max() / np.abs(model['alphas_F']).max()
        assert a_diff <= 1e-6, a_diff
        peak = torch.cuda.max_memory_allocated()
        during = {k: v - before[k] for k, v in launch_counts().items()}
        R, F_ref, _ = held_out(ds, task, 1000)
        pred = GDMLPredict(model, batch_size=1000, device=device)
        E, F = pred.predict(R)
        mae = float(np.abs(F - F_ref).mean())
        Rt = torch.as_tensor(R, dtype=torch.float64, device=device)
        Xq, Jcq = desc_ops.descriptor_batch(Rt, n_atoms)
        E_p, F_p = _predict_from_tables_body(Xq, Jcq, pred.tables, pred.alphas_E_lin, pred.sig, pred.std,
                                             pred.c, n_atoms=n_atoms)
        p_err = max(rel_err(torch.as_tensor(E), E_p.cpu()), rel_err(torch.as_tensor(F), F_p.cpu()))
        assert np.isfinite(E).all() and np.isfinite(F).all() and p_err <= TOL[torch.float64], p_err
        t = trainer.times
        n = m * 3 * n_atoms
        print('    ethanol M=%d (%d unknowns, K %.2f GB): train() cold %.3f s, warm %.3f s = descriptors %.3f + '
              'assembly %.3f + Cholesky %.3f + model %.3f + integration constant %.3f; assembly %.1f%% of '
              'train(); peak allocated %.2f GB; held-out force MAE %.6f on %d frames (f64); K1 launches in '
              'two train() %s, their alphas %.1e apart; held-out predictions vs plain %.2e (%s)' % (
                  m, n, 8 * n * n / 1e9, t_cold, t['total'], t['descriptors'], t['assembly'], t['cholesky'],
                  t['model creation'], t['integration constant'], 100 * t['assembly'] / t['total'],
                  peak / 1e9, mae, len(R), during, a_diff, p_err, card))
        if m == ETHANOL_MAE[0]:
            assert abs(mae - ETHANOL_MAE[1]) <= ETHANOL_MAE[2], mae

    # The tile budget: the JAX package's 64 MB against the port's, at M = 1000.
    X, Jc = desc_ops.descriptor_batch(
        torch.as_tensor(task['R_train'].reshape(m, -1), dtype=torch.float64, device=device), n_atoms)
    dperms = desc_perm_table(task['perms'])
    tiles = {'64 MB': kernel_ops._tile_sizes(m, n_atoms, 64 * 1024**2, 8),
             'port': kernel_ops.default_tile_sizes(m, n_atoms, 1)}
    secs = {name: [] for name in tiles}
    peaks = {}
    for name in ('64 MB', 'port', 'port', '64 MB'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        K = kernel_ops.assemble_kernel(X, Jc, dperms, sig, n_atoms, tile_i=tiles[name][0], tile_j=tiles[name][1])
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
        peaks[name] = (torch.cuda.max_memory_allocated() - base - K.numel() * 8) / 1e9
        del K
    for name, (ti, tj) in tiles.items():
        print('    assembly M=%d at the %s tile budget: tiles %d x %d (%d tiles), %.3f and %.3f s in turns; '
              'peak above K %.3f GB (%s)' % (m, name, ti, tj, -(-m // ti) * -(-m // tj), *secs[name],
                                             peaks[name], card))
    return ds, task, model


def phase_train(device, card):
    """7: training on the card, the main path for K1 through the integration
    constant and the validation predictions."""
    t0 = time.perf_counter()
    fused_predict.reset_launches()
    phase_train_goldens(device)
    phase_train_reference(device)
    ethanol = phase_train_ethanol(device, card)
    counts = launch_counts()
    assert counts['total'] > 0 and counts['one_pass'] > 0 and counts['pass_a'] > 0, counts
    print('[7 train] assembly matches the goldens and the plain path; the reference recipes and the '
          'ethanol M=%d force MAE reproduced; M=%d trained; launches %s; %.1f s' % (
              ETHANOL_MAE[0], ETHANOL_M[-1], counts, time.perf_counter() - t0))
    return counts, ethanol


def cg_system(ds, task, n_atoms, device):
    """Descriptors of a task's training points on the device, its
    permutation table and its normalized force labels."""
    m = task['R_train'].shape[0]
    X, Jc = desc_ops.descriptor_batch(
        torch.as_tensor(task['R_train'].reshape(m, -1), dtype=torch.float64, device=device), n_atoms)
    y = task['F_train'].ravel()
    return X, Jc, desc_perm_table(task['perms']), y / np.std(y), float(np.std(y))


def plain_matvec(v, X, Jc, dperms, sig, lam, n_atoms):
    """``A v`` of a force-only system through ``predict.py``'s tables and
    the plain contraction: apart from K1 and from the solver's matvec."""
    JA = desc_ops.jac_dot_vec(Jc, v.reshape(X.shape[0], -1), n_atoms)
    _, F = _predict_from_tables_body(X, Jc, center_tables(*build_tables(X, JA, dperms)), None, sig, 1.0, 0.0,
                                     n_atoms=n_atoms)
    return -F.reshape(-1) + lam * v


def true_resid(model, X, Jc, dperms, y, n_atoms):
    """``|y - A x|`` of a force-only CG model, re-measured from its alphas
    through the plain matvec."""
    x = -torch.as_tensor(model['alphas_F'], dtype=torch.float64, device=X.device)
    r = torch.as_tensor(y, device=X.device) - plain_matvec(
        x, X, Jc, dperms, float(model['sig']), float(model['lam']), n_atoms)
    return float(torch.linalg.vector_norm(r))


def k1_resid(model, X, Jc, dperms, y, n_atoms):
    """``|y - A x| / |y|`` of a force-only model, re-measured from its alphas
    through the solvers' matvec (K1 on the card)."""
    x = -torch.as_tensor(model['alphas_F'], dtype=torch.float64, device=X.device)
    r = torch.as_tensor(y, device=X.device) - it_mod._matvec_A(
        x, it_mod.matvec_tables(X, Jc, dperms), float(model['sig']), float(model['lam']), n_atoms=n_atoms,
        use_E_cstr=False)
    return float(torch.linalg.vector_norm(r)) / float(np.linalg.norm(y))


def check_columns(label, r, sig, n_atoms):
    """Kernel columns at ``CG_COLUMNS_CHECKED`` of a solve's inducing
    indices (the factor's input) against ``K e_j`` by the plain matvec."""
    idxs = np.asarray(r['model']['inducing_pts_idxs'])
    cols = idxs[np.linspace(0, len(idxs) - 1, CG_COLUMNS_CHECKED).astype(int)]
    X, Jc, dperms = r['X'], r['Jc'], r['dperms']
    C = kernel_ops.assemble_kernel_columns(X, Jc, dperms, sig, n_atoms, cols)
    refs = []
    for j in cols:
        e = torch.zeros(C.shape[0], dtype=torch.float64, device=X.device)
        e[j] = 1.0
        refs.append(-plain_matvec(e, X, Jc, dperms, sig, 0.0, n_atoms))
    err = rel_err(C, torch.stack(refs, dim=1))
    print('    %s factor columns %s against the plain matvec of unit vectors: %.2e of max |K| (bound %.0e)' % (
        label, cols.tolist(), err, CG_COLUMN_TOL))
    assert err <= CG_COLUMN_TOL, (label, err)


def cg_split(label, X, Jc, dperms, sig, lam, n_atoms, idxs, card):
    """Device ms of one CG iteration and of its parts at a solve's shapes,
    with the factor rebuilt from the solve's inducing columns: the whole
    iteration (a chunk of CG_CHUNK_ITERS over its count), the matvec, K1
    inside it (checked against its plain version on one matvec's inputs,
    then timed in turns with it), and the Woodbury apply.
    Returns K1's shape, times, bound and error against the plain version."""
    F, _ = it_mod.Iterative(device=X.device)._build_factor(X, Jc, dperms, sig, lam, idxs, n_atoms, False)
    tab = it_mod.matvec_tables(X, Jc, dperms)
    n = F.shape[1]
    v = torch.as_tensor(np.random.default_rng(0).normal(size=n), device=X.device)
    JA = desc_ops.jac_dot_vec(Jc, v.reshape(-1, 3 * n_atoms), n_atoms)[:, tab.dp].reshape(-1, X.shape[1])
    JA = JA.contiguous()
    args = (X - tab.mu, tab.Xt, JA, tab.xt_sq, torch.sum(tab.Xt * JA, dim=1), None, sig)
    B, D, T = X.shape[0], X.shape[1], tab.Xt.shape[0]
    kernel = lambda: fused_predict.fused_predict_tables(*args)  # noqa: E731
    plain = lambda: fused_predict.fused_predict_tables_reference(*args)  # noqa: E731
    max_abs = check('CG matvec %s B=%d T=%d D=%d f64' % (label, B, T, D), kernel, plain, TOL[torch.float64])
    k1_ms, plain_ms = time_pair(kernel, plain)
    mv_ms, apply_ms = time_pair(
        lambda: it_mod._matvec_A(v, tab, sig, lam, n_atoms=n_atoms, use_E_cstr=False),
        lambda: it_mod._factor_apply(F, v))
    z = it_mod._factor_apply(F, v) / lam
    zero = torch.zeros((), dtype=torch.int64, device=X.device)
    state = (torch.zeros_like(v), v, z, z, v @ z, zero,
             torch.zeros(it_mod.CG_CHUNK_ITERS, dtype=torch.float64, device=X.device), zero)
    chunk_ms = cuda_ms(lambda: it_mod._pcg_chunk(state, F, tab, sig, lam, 1.0, 0.0, n_atoms=n_atoms,
                                                 use_E_cstr=False, chunk_iters=it_mod.CG_CHUNK_ITERS), 2)
    it_ms = chunk_ms / it_mod.CG_CHUNK_ITERS
    b_ms, b_by = bound(B, T, D, 8)
    f_bytes = F.numel() * 8
    print('    %s iteration split (k=%d columns, n=%d, factor %.2f GB): %.3f ms an iteration = matvec %.3f '
          '(K1 %.3f, %.0f%% of the iteration) + Woodbury apply %.3f (%.0f%%; reads the factor twice, %.0f GB/s) '
          '+ the rest %.3f (the parts timed alone); K1 at B=%d T=%d D=%d f64 %.3f ms vs plain %.3f ms, bound %.4f ms by %s (%.1f%%), '
          'route %s (%s)' % (
              label, F.shape[0], n, f_bytes / 1e9, it_ms, mv_ms, k1_ms, 100 * k1_ms / it_ms, apply_ms,
              100 * apply_ms / it_ms, 2 * f_bytes / apply_ms * 1e-6, it_ms - mv_ms - apply_ms, B, T, D, k1_ms,
              plain_ms, b_ms, b_by, 100 * b_ms / k1_ms, fused_predict.route(T, D), card))
    return {'label': label, 'B': B, 'T': T, 'D': D, 'ms': k1_ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
            'bound_by': b_by, 'max_abs_err': max_abs, 'iteration_ms': it_ms, 'matvec_ms': mv_ms,
            'apply_ms': apply_ms}


def cg_launches(iters):
    """The counts since the last reset, and K1 launches an iteration."""
    during = launch_counts()
    return during, during['total'] / max(iters, 1)


def phase_cg_anchor(device, card):
    """8a: cold solves of the ill-conditioned anchor against the JAX
    package's CPU f64 iteration counts."""
    n_atoms, n_frames, seed, split, m, n_valid, lam = CG_ANCHOR
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_frames, seed=seed)
    trainer = GDMLTrain(device=device)
    task0 = trainer.create_task(ds, m, ds, n_valid, sig=CG_ANCHOR_SIGS[0], lam=lam, use_sym=False,
                                rng=np.random.RandomState(split))
    X, Jc, dperms, y, y_std = cg_system(ds, task0, n_atoms, device)
    counts = dict.fromkeys(launch_counts(), 0)
    first = None
    for gb, refs in CG_ANCHOR_JAX.items():
        for sig, ref in zip(CG_ANCHOR_SIGS, refs):
            solver = it_mod.Iterative(trainer, max_memory=gb)
            fused_predict.reset_launches()
            _, _, iters, resid, _, idxs, conv = solver.solve(dict(task0, sig=sig), X, Jc, dperms, y, y_std)
            during, per_it = cg_launches(iters)
            counts = {k: counts[k] + during[k] for k in counts}
            first = first or (sig, idxs)
            t = solver.timer.durations
            ok = abs(iters - ref) <= max(CG_ANCHOR_TOL[0] * ref, CG_ANCHOR_TOL[1])
            print('    anchor M=%d budget %.2f GB sig=%4.1f: k=%d, %d iterations (JAX CPU f64 %d, %+.1f%%), '
                  'converged %s, resid %.3e; %.1f iterations/s (cg %.3f s, factor %.3f s, leverage scores '
                  '%.3f s); K1 %.2f launches an iteration %s (%s)' % (
                      m, gb, sig, len(idxs) // (3 * n_atoms), iters, ref, 100 * (iters - ref) / ref, conv,
                      resid, iters / t['cg'], t['cg'], t['factor'], t['leverage scores'], per_it,
                      during, card))
            assert conv and ok, (gb, sig, iters, ref)
    split = cg_split('anchor', X, Jc, dperms, first[0], lam, n_atoms, first[1], card)
    return counts, split, None


def phase_cg_dense(device, ethanol, card):
    """8b: ethanol M=1000 by CG with k well below M, against phase 7c's
    dense model on held-out geometries."""
    ds, task, dense = ethanol
    n_atoms = task['R_train'].shape[1]
    trainer = GDMLTrain(max_memory=CG_ETHANOL_GB, device=device)
    fused_predict.reset_launches()
    model = trainer.train(task, solver='cg')
    during, per_it = cg_launches(model['solver_iters'])
    k = len(model['inducing_pts_idxs']) // (3 * n_atoms)
    R, F_ref, _ = held_out(ds, task, 1000)
    Ea, Fa = GDMLPredict(dense, device=device).predict(R)
    Ec, Fc = GDMLPredict(model, device=device).predict(R)
    f_rel = float(np.abs(Fc - Fa).mean() / np.abs(Fa).mean())
    e_diff = float(np.abs((Ec - Ec.mean()) - (Ea - Ea.mean())).mean())
    conv = model['solver_resid'] <= model['solver_tol'] * model['norm_y_train']
    t = trainer.times
    print('    ethanol M=%d by CG at %.1f GB: k=%d of %d points, %d iterations, converged %s; train() %.3f s '
          '(leverage scores %.3f, factor %.3f, cg %.3f: %.1f iterations/s); against the dense model on %d '
          'held-out frames: mean |dF| / mean |F| %.2e (bound %.0e), centered |dE| %.2e (bound %.0e); CG force '
          'MAE %.6f; K1 %.2f launches an iteration %s (%s)' % (
              len(task['idxs_train']), CG_ETHANOL_GB, k, len(task['idxs_train']), model['solver_iters'], conv,
              t['total'], t['leverage scores'], t['factor'], t['cg'], model['solver_iters'] / t['cg'], len(R),
              f_rel, CG_DENSE_BOUNDS[0], e_diff, CG_DENSE_BOUNDS[1], np.abs(Fc - F_ref).mean(), per_it,
              during, card))
    assert conv and k < len(task['idxs_train']) // 4, (conv, k)
    assert f_rel < CG_DENSE_BOUNDS[0] and e_diff < CG_DENSE_BOUNDS[1], (f_rel, e_diff)
    X, Jc, dperms, _, _ = cg_system(ds, task, n_atoms, device)
    split = cg_split('ethanol', X, Jc, dperms, float(task['sig']), float(task['lam']), n_atoms,
                     model['inducing_pts_idxs'], card)
    split['solver_iters'] = int(model['solver_iters'])
    return during, split, None


def cg_recipe(device, recipe, max_seconds):
    """Data, the budget pinned to what the card has free (so the cap on k is
    known), the task, and train() by CG with its peak memory."""
    n_atoms, n_frames, seed, split, n_valid, m, sig, lam = recipe
    t0 = time.perf_counter()
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_frames, seed=seed)
    budget = memory_budget(device)
    trainer = GDMLTrain(max_memory=budget / 1024**3, device=device)
    task = trainer.create_task(ds, m, ds, n_valid, sig=sig, lam=lam, use_sym=False,
                               rng=np.random.RandomState(split))
    t_data = time.perf_counter() - t0
    need = Analytic.est_memory_requirement(m, n_atoms)
    assert need > torch.cuda.get_device_properties(0).total_memory, need
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_predict.reset_launches()
    model = trainer.train(task, solver='cg', solver_max_seconds=max_seconds)
    during, per_it = cg_launches(model['solver_iters'])
    peak = torch.cuda.max_memory_allocated()
    k = len(model['inducing_pts_idxs']) // (3 * n_atoms)
    cap = min(m, it_mod.Iterative.max_n_inducing_pts(m, n_atoms, budget))
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    resid = true_resid(model, X, Jc, dperms, y, n_atoms)
    return dict(ds=ds, task=task, model=model, times=trainer.times, peak=peak, during=during, per_it=per_it,
                k=k, cap=cap, budget=budget, need=need, X=X, Jc=Jc, dperms=dperms, y=y, resid=resid,
                t_data=t_data, n=m * 3 * n_atoms)


def phase_cg_aspirin(device, card):
    """8c: the bench_large.py aspirin recipe, past the dense bound."""
    n_atoms, sig, lam = CG_ASPIRIN[0], CG_ASPIRIN[6], CG_ASPIRIN[7]
    r = cg_recipe(device, CG_ASPIRIN, CG_ASPIRIN_SECONDS)
    model, t = r['model'], r['times']
    tol_b = model['solver_tol'] * model['norm_y_train']
    conv = model['solver_resid'] <= tol_b
    R, F_ref, _ = held_out(r['ds'], r['task'], 500)
    _, F = GDMLPredict(model, device=device).predict(R)
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    drift = abs(r['resid'] - model['solver_resid']) / r['resid']
    print('    aspirin N=%d M=%d sig=%g lam=%g (%d unknowns; dense needs %.1f GB): budget %.1f GB, k=%d (cap %d), '
          '%d iterations, converged %s, recorded resid %.3e, re-measured by the plain matvec %.3e (drift %.2e; '
          'target %.3e); train() %.2f s = descriptors %.3f + leverage scores %.2f + factor %.2f + cg %.2f (%.1f '
          'iterations/s) + model %.3f + integration constant %.3f; data %.1f s; peak allocated %.2f GB; held-out '
          'force MAE %.5f (force scale %.4f, bound %.4f) on %d frames; K1 %.2f launches an iteration %s (%s)' % (
              n_atoms, r['task']['R_train'].shape[0], sig, lam, r['n'], r['need'] / 1e9, r['budget'] / 1e9,
              r['k'], r['cap'], model['solver_iters'], conv, model['solver_resid'], r['resid'], drift, tol_b,
              t['total'], t['descriptors'], t['leverage scores'], t['factor'], t['cg'],
              model['solver_iters'] / t['cg'], t['model creation'], t['integration constant'], r['t_data'],
              r['peak'] / 1e9, mae, scale, CG_MAE_SHARE * scale, len(R), r['per_it'], r['during'], card))
    assert r['k'] == r['cap'] and conv and r['resid'] <= tol_b, (r['k'], r['cap'], conv, r['resid'], tol_b)
    assert drift <= it_mod.RESID_REPLACE_DRIFT and mae < CG_MAE_SHARE * scale, (drift, mae, scale)
    check_columns('aspirin', r, sig, n_atoms)
    split = cg_split('aspirin', r['X'], r['Jc'], r['dperms'], sig, lam, n_atoms, model['inducing_pts_idxs'], card)
    return r['during'], split, r


def phase_cg_atat(device, card):
    """8d: the bench_large.py atat3000 recipe at full width, under a wall
    budget; then the column assembly at two tile budgets in turns."""
    n_atoms, sig, lam = CG_ATAT[0], CG_ATAT[6], CG_ATAT[7]
    r = cg_recipe(device, CG_ATAT, CG_ATAT_SECONDS)
    model, t = r['model'], r['times']
    drift = abs(r['resid'] - model['solver_resid']) / r['resid']
    print('    AT-AT N=%d M=%d sig=%g lam=%g (%d unknowns; dense needs %.0f GB): budget %.1f GB, k=%d (cap %d), '
          'factor %.2f s, leverage scores %.2f s, %d iterations in %.1f s of CG (%.2f iterations/s, wall budget '
          '%.0f s); residual %.4e -> %.4e (target %.3e), re-measured by the plain matvec %.4e (drift %.2e, bound '
          '%.0e); train() %.1f '
          's; data %.1f s; peak allocated %.2f GB; K1 %.2f launches an iteration %s (%s)' % (
              n_atoms, r['task']['R_train'].shape[0], sig, lam, r['n'], r['need'] / 1e9, r['budget'] / 1e9,
              r['k'], r['cap'], t['factor'], t['leverage scores'], model['solver_iters'], t['cg'],
              model['solver_iters'] / t['cg'], CG_ATAT_SECONDS, model['norm_y_train'], model['solver_resid'],
              model['solver_tol'] * model['norm_y_train'], r['resid'], drift, it_mod.RESID_REPLACE_DRIFT,
              t['total'], r['t_data'], r['peak'] / 1e9, r['per_it'], r['during'], card))
    assert r['k'] == r['cap'], (r['k'], r['cap'])
    assert model['solver_resid'] < model['norm_y_train'] and drift <= it_mod.RESID_REPLACE_DRIFT, drift
    check_columns('AT-AT', r, sig, n_atoms)
    split = cg_split('AT-AT', r['X'], r['Jc'], r['dperms'], sig, lam, n_atoms, model['inducing_pts_idxs'], card)

    idxs = model['inducing_pts_idxs']
    m, n_perms = r['X'].shape[0], r['dperms'].shape[0]
    rows = {'JAX 1.5 GB': kernel_ops.column_tile_rows(m, len(idxs), n_atoms, n_perms, budget=JAX_COLUMN_TILE_BYTES),
            'port': kernel_ops.column_tile_rows(m, len(idxs), n_atoms, n_perms)}
    secs = {name: [] for name in rows}
    for name in ('JAX 1.5 GB', 'port', 'port', 'JAX 1.5 GB'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C = kernel_ops.assemble_kernel_columns(r['X'], r['Jc'], r['dperms'], sig, n_atoms, idxs, tile_i=rows[name])
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
        del C
    for name, ti in rows.items():
        print('    AT-AT column assembly (%d x %d, %.1f GB) at the %s tile budget: %d rows a tile (%d tiles), '
              '%.3f and %.3f s in turns (%s)' % (r['n'], len(idxs), r['n'] * len(idxs) * 8 / 1e9, name, ti,
                                                -(-m // ti), *secs[name], card))
    return r['during'], split, r


def phase_cg(device, ethanol, card):
    """8: CG training on the card; K1 runs in every matvec."""
    t0 = time.perf_counter()
    counts = dict.fromkeys(launch_counts(), 0)
    splits, recipes = [], []
    for run in (lambda: phase_cg_anchor(device, card), lambda: phase_cg_dense(device, ethanol, card),
                lambda: phase_cg_aspirin(device, card), lambda: phase_cg_atat(device, card)):
        during, split, recipe = run()
        counts = {k: counts[k] + during[k] for k in counts}
        splits.append(split)
        recipes.append(recipe)
    assert counts['one_pass'] > 0 and counts['pass_a'] > 0 and counts['pass_b'] > 0, counts
    print('[8 cg] anchor within %d%% of the JAX CPU f64 counts; ethanol CG agrees with the dense model; aspirin '
          '(63,000 unknowns) converged; AT-AT (540,000 unknowns) ran at the memory cap; launches %s; %.1f s' % (
              100 * CG_ANCHOR_TOL[0], counts, time.perf_counter() - t0))
    return counts, splits, recipes[2], recipes[3]


@contextlib.contextmanager
def grid_probe():
    """Hold ``train()`` on the grid route and watch it: ``Analytic.
    est_memory_inplace`` and ``est_memory_pair`` read as infinite inside the
    block, so a system past the dense bound leaves the in-place f64 route
    (phase 15) and the solver's pair region (lam < 1e-7 lmax, phase 12) takes
    the grid route; each
    ``chol_grid`` call's side, ``info`` and device seconds (synchronized
    before and after), the last factor that held, the ``Analytic`` instance
    that solved, and the solver's log lines at INFO."""
    probe = {'chol': [], 'factor': None, 'solver': None, 'log': Records()}
    chol, solve = blockchol.chol_grid, Analytic._solve_grid_pcg
    needs = Analytic.est_memory_inplace, Analytic.est_memory_pair

    def timed_chol(G):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L, info = chol(G)
        torch.cuda.synchronize()
        probe['chol'].append((len(G) * G[0][0].shape[0], info, time.perf_counter() - t0))
        if info == 0:
            probe['factor'] = L
        return L, info

    def watched(self, *args, **kw):
        probe['solver'] = self
        return solve(self, *args, **kw)

    logger = logging.getLogger(an_mod.__name__)
    level = logger.level
    logger.addHandler(probe['log'])
    logger.setLevel(logging.INFO)
    blockchol.chol_grid, Analytic._solve_grid_pcg = timed_chol, watched
    Analytic.est_memory_inplace = staticmethod(lambda *args: math.inf)
    Analytic.est_memory_pair = staticmethod(lambda n_train, n_atoms: math.inf)
    try:
        yield probe
    finally:
        blockchol.chol_grid, Analytic._solve_grid_pcg = chol, solve
        Analytic.est_memory_inplace, Analytic.est_memory_pair = (staticmethod(need) for need in needs)
        logger.removeHandler(probe['log'])
        logger.setLevel(level)


def grid_train(trainer, task, solver=None):
    """``trainer.train(task, solver)`` held on the grid route
    (``grid_probe``), with its peak memory above what was allocated before
    it, its K1 launches (from 0) and the probe."""
    with grid_probe() as probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fused_predict.reset_launches()
        model = trainer.train(task, solver=solver)
        during = launch_counts()
    assert model['solver_name'] == 'analytic' and probe['solver'] is not None and probe['factor'] is not None
    assert probe['solver'].route == 'grid', probe['solver'].route
    return model, during, torch.cuda.max_memory_allocated() - base, probe


def in_pair_region(lam, lmax, m, n_atoms, budget):
    """Whether ``Analytic.solve`` takes the pair route past the dense bound
    at this lam and lmax and ``budget`` bytes (lam < 1e-7 lmax and
    ``est_memory_pair`` within the budget)."""
    return lam < an_mod.PAIR_REGION * lmax and Analytic.est_memory_pair(m, n_atoms) <= budget


def k1_on_tables(what, X, Jc, dperms, sig, n_atoms):
    """K1 at a solve's shapes: held against its plain version on one
    matvec's inputs (the solve's tables and a random vector), then timed in
    turns with it. Returns the tables, the vector and K1's entry (shape,
    times, bound, error against the plain version)."""
    tab = it_mod.matvec_tables(X, Jc, dperms)
    n = X.shape[0] * 3 * n_atoms
    v = torch.as_tensor(np.random.default_rng(0).normal(size=n), device=X.device)
    JA = desc_ops.jac_dot_vec(Jc, v.reshape(-1, 3 * n_atoms), n_atoms)[:, tab.dp].reshape(-1, X.shape[1])
    JA = JA.contiguous()
    args = (X - tab.mu, tab.Xt, JA, tab.xt_sq, torch.sum(tab.Xt * JA, dim=1), None, sig)
    B, D, T = X.shape[0], X.shape[1], tab.Xt.shape[0]
    kernel = lambda: fused_predict.fused_predict_tables(*args)  # noqa: E731
    plain = lambda: fused_predict.fused_predict_tables_reference(*args)  # noqa: E731
    max_abs = check('%s B=%d T=%d D=%d f64' % (what, B, T, D), kernel, plain, TOL[torch.float64])
    k1_ms, plain_ms = time_pair(kernel, plain)
    b_ms, b_by = bound(B, T, D, 8)
    return tab, v, {'B': B, 'T': T, 'D': D, 'ms': k1_ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
                    'max_abs_err': max_abs}


def grid_split(label, L32, X, Jc, dperms, sig, lam, n_atoms, iters, card):
    """Device ms of one refinement-CG iteration at a grid solve's shapes
    and factor (a chunk of GRID_SPLIT_ITERS), and of its parts, each timed
    alone, so they need not add up to the iteration: the matvec, K1 inside
    it (``k1_on_tables``), the grid solve (the preconditioner) and its 2k
    single-vector leaf triangular solves. Returns K1's shape, times, bound
    and error against the plain version, and the parts' times."""
    tab, v, k1 = k1_on_tables('grid CG matvec %s' % label, X, Jc, dperms, sig, n_atoms)
    n = v.shape[0]
    A_apply, M_apply = an_mod._grid_operators(L32, None, None, tab, sig, lam, n_atoms=n_atoms, n=n,
                                              use_E_cstr=False)
    mv_ms, solve_ms = time_pair(lambda: A_apply(v), lambda: M_apply(v))
    k, b = len(L32), L32[0][0].shape[0]
    vb = torch.ones((b, 1), dtype=torch.float32, device=X.device)

    def leaves():
        for j in range(k):
            torch.linalg.solve_triangular(L32[j][j], vb, upper=False)
            torch.linalg.solve_triangular(L32[j][j].mT, vb, upper=True)

    leaves()
    leaf_ms = cuda_ms(leaves, 3)
    z = M_apply(v)
    state = (torch.zeros_like(v), v, z, z, v @ z, None)
    chunk = lambda: an_mod._pcg_chol(state, A_apply, M_apply, 1.0, 0.0, max_iters=GRID_SPLIT_ITERS)  # noqa: E731
    chunk()
    it_ms = cuda_ms(chunk, 1) / GRID_SPLIT_ITERS
    f_bytes = sum(blk.numel() * blk.element_size() for row in L32 for blk in row)
    print('    %s refinement iteration (grid %d x %d blocks of %d, factor %.2f GB f32): %.3f ms in a chunk of %d; '
          'its parts timed alone: matvec %.3f (K1 %.3f), grid solve %.3f (two sweeps read the factor: %.0f GB/s; '
          'bytes floor %.3f) and its %d single-vector leaf triangular solves %.3f; K1 at B=%d T=%d D=%d f64 %.3f ms '
          'vs plain %.3f ms, bound %.4f ms by %s (%.1f%%), route %s (%s)' % (
              label, k, k, b, f_bytes / 1e9, it_ms, GRID_SPLIT_ITERS, mv_ms, k1['ms'], solve_ms,
              2 * f_bytes / solve_ms * 1e-6, 2 * f_bytes / H100_BYTES_PER_S * 1e3, 2 * k, leaf_ms, k1['B'], k1['T'],
              k1['D'], k1['ms'], k1['plain_ms'], k1['bound_ms'], k1['bound_by'], 100 * k1['bound_ms'] / k1['ms'],
              fused_predict.route(k1['T'], k1['D']), card))
    return dict(k1, label=label, iteration_ms=it_ms, matvec_ms=mv_ms, apply_ms=solve_ms, leaf_solves_ms=leaf_ms,
                solver_iters=int(iters))


def factor_llt(block, k, b, v):
    """``L L^T v`` in f64 from a lower-triangle grid factor given as
    ``block(r, c)`` (each block in f64, made when it is used)."""
    vb = v.split(b)
    u = [sum(block(r, c).mT @ vb[r] for r in range(c, k)) for c in range(k)]
    return torch.cat([sum(block(r, c) @ u[c] for c in range(r + 1)) for r in range(k)])


def grid_llt(L, v):
    """``L L^T v`` from a lower-triangle grid factor of any dtype."""
    return factor_llt(lambda r, c: (torch.tril(L[r][c]) if r == c else L[r][c]).to(torch.float64),
                      len(L), L[0][0].shape[0], v)


def probe_vector(n, n_pad, device):
    """The factor checks' random probe vector, zero on the padding."""
    v = torch.zeros(n_pad, dtype=torch.float64, device=device)
    v[:n] = torch.as_tensor(np.random.default_rng(2).normal(size=n), device=device)
    return v


def factor_error(LLt_v, v, X, Jc, dperms, sig, lam_p, n_atoms):
    """How far a factor is from the f64 system it factors, on the probe
    vector ``v``: ``|L L^T v - A v|`` over ``|A v|`` and over ``lam' |v|``,
    with ``A = -K + lam' I`` applied through the plain contraction, apart
    from K1."""
    n = X.shape[0] * 3 * n_atoms
    Av = plain_matvec(v[:n], X, Jc, dperms, sig, lam_p, n_atoms)
    E = LLt_v.clone()
    E[:n] -= Av
    e = float(torch.linalg.vector_norm(E))
    return e / float(torch.linalg.vector_norm(Av)), e / (lam_p * float(torch.linalg.vector_norm(v)))


def grid_factor_error(L, X, Jc, dperms, sig, lam_p, n_atoms):
    """``factor_error`` of a grid factor (any dtype)."""
    v = probe_vector(X.shape[0] * 3 * n_atoms, len(L) * L[0][0].shape[0], X.device)
    return factor_error(grid_llt(L, v), v, X, Jc, dperms, sig, lam_p, n_atoms)


def grid_M(L, n):
    """The refinement CG's preconditioner from a grid factor of any dtype:
    pad to the grid's side, solve in the factor's dtype, cast back (the
    route's own ``M_ff`` for an f32 factor)."""
    n_pad = len(L) * L[0][0].shape[0]

    def M_apply(v):
        vp = torch.zeros(n_pad, dtype=L[0][0].dtype, device=v.device)
        vp[:n] = v
        return blockchol.solve_grid(L, vp)[:n].to(v.dtype)

    return M_apply


def top_eig(A_apply, M_apply, n, device):
    """The largest eigenvalue of ``M^-1 A`` by GRID_EIG_STEPS power steps
    (from below). 1 for an exact factor of ``A + lam' I``; above 1 where
    the factor's error eats into the shift ``lam'``."""
    v = torch.as_tensor(np.random.default_rng(1).normal(size=n), device=device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(GRID_EIG_STEPS):
        w = M_apply(A_apply(v))
        top = torch.linalg.vector_norm(w)
        v = w / top
    return float(top)


def grid_aspirin_train(device):
    """10a's recipe, trained with solver=None on the grid route."""
    n_atoms, n_frames, seed, split, n_valid, m, sig, lam = GRID_ASPIRIN
    t0 = time.perf_counter()
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_frames, seed=seed)
    trainer = GDMLTrain(device=device)
    task = trainer.create_task(ds, m, ds, n_valid, sig=sig, lam=lam, use_sym=False, rng=np.random.RandomState(split))
    t_data = time.perf_counter() - t0
    need, grid_need = Analytic.est_memory_requirement(m, n_atoms), Analytic.est_memory_grid(m, n_atoms)
    assert grid_need < memory_budget(device) < need, (grid_need, need)
    model, during, peak, probe = grid_train(trainer, task)
    return ds, task, trainer, model, during, peak, probe, t_data


def phase_grid_aspirin(device, card):
    """10a: the bench_large.py analytic aspirin recipe with solver=None, held
    on the grid route (its pair region: phase 12 trains it there)."""
    n_atoms, _, _, _, _, m, sig, lam = GRID_ASPIRIN
    need, grid_need = Analytic.est_memory_requirement(m, n_atoms), Analytic.est_memory_grid(m, n_atoms)
    budget = memory_budget(device)
    ds, task, trainer, model, during, peak, probe, t_data = grid_aspirin_train(device)
    solver, t = probe['solver'], trainer.times
    pair_region = in_pair_region(lam, solver.lmax, m, n_atoms, budget)
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    rel = true_resid(model, X, Jc, dperms, y, n_atoms) / float(np.linalg.norm(y))
    R, F_ref, _ = held_out(ds, task, GRID_HELD_OUT)
    _, F = GDMLPredict(model, device=device).predict(R)
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    n_pad, _, t_fac = probe['chol'][-1]
    print('    aspirin N=%d M=%d sig=%g lam=%g (%d unknowns; dense needs %.1f GB, the grid %.1f GB, the pair route %.1f '
          'GB): solver=None took the analytic grid route (held there by grid_probe; its pair region: %s); lmax %.6e, '
          'rungs lam\'/info %s, lam\' %.6e; %d refinement iterations; relative '
          'residual re-measured by the plain matvec %.3e (bound %.0e); train() %.2f s = descriptors %.3f + lmax %.3f + '
          'assembly %.2f + factor %.2f (%d rung(s); the one that held %.3f s, %.1f TFLOP/s on n^3/3 at n=%d) + '
          'refinement CG %.2f (%.1f iterations/s) + model %.3f + integration constant %.3f; data %.1f s; peak '
          'allocated by train() %.2f GB (est_memory_grid %.2f GB); held-out force MAE %.5f on %d frames (force '
          'scale %.4f, bound %.4f); K1 %.2f launches an iteration %s (%s)' % (
              n_atoms, m, sig, lam, m * 3 * n_atoms, need / 1e9, grid_need / 1e9,
              Analytic.est_memory_pair(m, n_atoms) / 1e9, pair_region, solver.lmax,
              [(float('%.6g' % lp), info) for lp, info in solver.rungs], solver.lam_p_used, solver.pcg_iters, rel,
              GRID_RESID, t['total'], t['descriptors'], t['lmax'], t['assembly'], t['factor'], len(solver.rungs),
              t_fac, n_pad**3 / 3 / t_fac * 1e-12, n_pad, t['cg'], solver.pcg_iters / t['cg'], t['model creation'],
              t['integration constant'], t_data, peak / 1e9, grid_need / 1e9, mae, len(R), scale,
              CG_MAE_SHARE * scale, during['total'] / max(solver.pcg_iters, 1), during, card))
    assert pair_region and 'lmax' in t and rel <= GRID_RESID and mae < CG_MAE_SHARE * scale, (pair_region, rel, mae)
    L32, lam_p = probe['factor'], solver.lam_p_used
    err, err_shift = grid_factor_error(L32, X, Jc, dperms, sig, lam_p, n_atoms)
    tol = math.sqrt(n_pad) * float(torch.finfo(torch.float32).eps)
    print('    the kept f32 factor on a probe vector: |L L^T v - (A + lam\' I) v| / |(A + lam\' I) v| %.3e (bound '
          'sqrt(n) eps32 = %.3e), %.3f lam\' |v| (bound %.3f) (%s)' % (err, tol, err_shift, GRID_FACTOR_SHIFT_TOL,
                                                                         card))
    assert err <= tol and err_shift <= GRID_FACTOR_SHIFT_TOL, (err, tol, err_shift)
    split = grid_split('aspirin grid', L32, X, Jc, dperms, sig, lam, n_atoms, solver.pcg_iters, card)
    grid = dict(ds=ds, task=task, lam_p=lam_p, iters=solver.pcg_iters, lmax=solver.lmax, times=dict(t), peak=peak,
                mae=mae, iteration_ms=split['iteration_ms'], err_shift=err_shift)
    return during, split, grid


def refine(A_apply, M_apply, y):
    """The grid route's refinement CG (its chunks, tolerance and cap) on
    ``y`` with the preconditioner ``M_apply``: (iterations, relative
    residual, seconds)."""
    b_norm = float(torch.linalg.vector_norm(y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z0 = M_apply(y)
    state, iters, rel = (torch.zeros_like(y), y, z0, z0, y @ z0, None), 0, 1.0
    for _ in range(-(-an_mod.PCG_MAX_ITERS // an_mod.PCG_CHUNK_ITERS)):
        state, resid = an_mod._pcg_chol(state, A_apply, M_apply, b_norm, an_mod.PCG_RTOL,
                                        max_iters=an_mod.PCG_CHUNK_ITERS)
        done, rel = int(state[5]), float(resid) / b_norm
        iters += done
        if not math.isfinite(rel) or rel <= an_mod.PCG_RTOL or done < an_mod.PCG_CHUNK_ITERS:
            break
    return iters, rel, time.perf_counter() - t0


def panel_alias_check(device, b, card):
    """``chol_grid``'s panel solve ``B <- B L^-T`` at a grid block's side
    ``b`` on seeded f32 inputs, written through ``out=`` into its own input
    (the form the port used before) against a fresh output: max |delta|
    over max |value|, and each result's residual ``|X L^T - B| / |B|``."""
    g = torch.Generator().manual_seed(0)
    A, B = (torch.randn(b, b, generator=g).to(device) for _ in range(2))
    with _true_f32(torch.float32):
        L = torch.linalg.cholesky(A @ A.mT / b + 2 * torch.eye(b, device=device))
        fresh = torch.linalg.solve_triangular(L.mT, B, upper=True, left=False)
        aliased = B.clone()
        torch.linalg.solve_triangular(L.mT, aliased, upper=True, left=False, out=aliased)
        resid = [float(torch.linalg.norm(X @ L.mT - B) / torch.linalg.norm(B)) for X in (fresh, aliased)]
    print('    panel solve at b=%d f32: out= aliasing its input against a fresh output %.3e of max |value|; residual '
          '|X L^T - B| / |B| fresh %.3e, aliased %.3e (%s)' % (b, rel_err(aliased, fresh), *resid, card))


def chol_grid_out(G):
    """``blockchol.chol_grid`` with its panel solve written through
    ``out=`` into its own input, the form the port used before."""
    k, b = len(G), G[0][0].shape[0]
    with _true_f32(G[0][0].dtype):
        for j in range(k):
            G[j][j], info = torch.linalg.cholesky_ex(G[j][j])
            for i in range(j + 1, k):
                torch.linalg.solve_triangular(G[j][j].mT, G[i][j], upper=True, left=False, out=G[i][j])
            for c in range(j + 1, k):
                for r in range(c, k):
                    G[r][c].addmm_(G[r][j], G[c][j].mT, alpha=-1)
            if int(info) != 0:
                return G, j * b + int(info)
    return G, 0


def phase_grid_precision(device, card):
    """``--grid-precision``: 10a's system at the lam' its ladder chose, with
    the preconditioner built five ways: the route's (f32 assembly, factor
    and solve), the route with the panel solve through ``out=``
    (``chol_grid_out``), the route's factor solved in f64, an f64 assembly
    rounded to f32 before the f32 factor, and all f64. For each: the
    refinement iterations to the route's tolerance, the factor's error on a
    probe vector and the top of the preconditioned spectrum. First the
    panel solve through ``out=`` (``panel_alias_check``)."""
    n_atoms, _, _, _, _, m, sig, lam = GRID_ASPIRIN
    for b in (512, 7875):
        panel_alias_check(device, b, card)
    ds, task, trainer, model, _, _, probe = grid_aspirin_train(device)[:7]
    solver = probe['solver']
    lam_p, L32 = solver.lam_p_used, probe['factor']
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    y = torch.as_tensor(y, device=X.device)
    tab = it_mod.matvec_tables(X, Jc, dperms)
    A_apply = an_mod._grid_operators(L32, None, None, tab, sig, lam, n_atoms=n_atoms, n=len(y), use_E_cstr=False)[0]
    dim_i = 3 * n_atoms
    spec = blockchol.grid_spec(-(-m // 8) * 8 * dim_i, target_block=an_mod.GRID_TARGET_BLOCK, align=dim_i)
    print('    aspirin M=%d sig=%g lam=%g: the route took %d refinement iterations at lam\' %.6e (lmax %.6e, lam\'/lam '
          '%.4e) in %.2f s (%s)' % (m, sig, lam, solver.pcg_iters, lam_p, solver.lmax, lam_p / lam,
                                   trainer.times['cg'], card))

    def assembled(dtype, factor_dtype, chol=blockchol.chol_grid):
        G = kernel_ops.assemble_kernel_grid(X, Jc, dperms, sig, n_atoms, spec, dtype=dtype)
        for row in G:
            for j in range(len(row)):
                row[j] = row[j].to(factor_dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L, info = chol(blockchol.grid_diag_add(G, lam_p))
        torch.cuda.synchronize()
        assert info == 0, info
        return L, time.perf_counter() - t0

    variants = (
        ('f32 assembly, f32 factor, f32 solve (the route)', lambda: (L32, probe['chol'][-1][2])),
        ('the route with the panel solve through out= into its own input',
         lambda: assembled(torch.float32, torch.float32, chol_grid_out)),
        ('the same f32 factor, solved in f64', lambda: ([[b.double() for b in row] for row in L32], 0.0)),
        ('f64 assembly rounded to f32, f32 factor, f32 solve', lambda: assembled(torch.float64, torch.float32)),
        ('f64 assembly, f64 factor, f64 solve', lambda: assembled(torch.float64, torch.float64)),
    )
    for label, build in variants:
        L, t_fac = build()
        M_apply = grid_M(L, len(y))
        err, err_shift = grid_factor_error(L, X, Jc, dperms, sig, lam_p, n_atoms)
        top = top_eig(A_apply, M_apply, len(y), X.device)
        iters, rel, secs = refine(A_apply, M_apply, y)
        print('    %s: %d refinement iterations to relative residual %.3e in %.2f s (%.3f ms an iteration); '
              'factor %.2f s; |L L^T v - (A + lam\' I) v| / |(A + lam\' I) v| %.3e = %.3f lam\' |v|; top of '
              'M^-1 A %.4f (%s)' % (label, iters, rel, secs, 1e3 * secs / max(iters, 1), t_fac, err, err_shift,
                                     top, card))
        del L, M_apply
        torch.cuda.empty_cache()


def phase_grid_vs_cg(device, aspirin_cg, card):
    """10b: phase 8c's aspirin task by the grid route (held there: at its
    lam, 1e-8, below 1e-7 lmax, ``solve`` takes the pair route), against
    8c's CG model on held-out frames."""
    task, cg_model = aspirin_cg['task'], aspirin_cg['model']
    trainer = GDMLTrain(device=device)
    model, during, peak, probe = grid_train(trainer, task, solver='analytic')
    R, F_ref, _ = held_out(aspirin_cg['ds'], task, GRID_HELD_OUT)
    _, Fg = GDMLPredict(model, device=device).predict(R)
    _, Fc = GDMLPredict(cg_model, device=device).predict(R)
    f_rel = float(np.abs(Fg - Fc).mean() / np.abs(Fc).mean())
    t, tc, solver = trainer.times, aspirin_cg['times'], probe['solver']
    print('    aspirin M=%d sig=%g lam=%g by the grid route (held; pair region %s): train() %.2f s (lmax %.2f, assembly %.2f, factor %.2f, '
          'refinement CG %.2f), lam\' %.6e after %d rung(s), %d refinement iterations, peak %.2f GB, held-out force '
          'MAE %.5f; by CG (phase 8c): train() %.2f s (leverage scores %.2f, factor %.2f, cg %.2f), %d iterations, '
          'peak %.2f GB, held-out force MAE %.5f; mean |dF| / mean |F| between the two %.2e (bound %.0e) on %d '
          'frames; K1 launches %s (%s)' % (
              len(task['idxs_train']), float(task['sig']), float(task['lam']),
              in_pair_region(float(task['lam']), solver.lmax, len(task['idxs_train']), task['R_train'].shape[1],
                             memory_budget(device)), t['total'], t['lmax'], t['assembly'],
              t['factor'], t['cg'], solver.lam_p_used, len(solver.rungs), solver.pcg_iters, peak / 1e9,
              np.abs(Fg - F_ref).mean(), tc['total'], tc['leverage scores'], tc['factor'], tc['cg'],
              cg_model['solver_iters'], aspirin_cg['peak'] / 1e9, np.abs(Fc - F_ref).mean(), f_rel,
              CG_DENSE_BOUNDS[0], len(R), during, card))
    assert f_rel < CG_DENSE_BOUNDS[0], f_rel
    return during


def phase_grid_ecstr(device, ethanol, card):
    """10c: energy constraints on the grid route (forced by max_memory; held
    there, off the pair route that phase 12 takes) against the dense model on
    the card, on the training geometries."""
    ds = ethanol[0]
    m, gb, lam, bound_rel = GRID_ECSTR
    n_atoms = ds['R'].shape[1]
    task = GDMLTrain(device=device).create_task(ds, m, ds, 100, sig=ETHANOL[5], lam=lam, use_sym=False,
                                               use_E_cstr=True, rng=np.random.RandomState(ETHANOL[3]))
    assert Analytic.est_memory_grid(m, n_atoms) < gb * 1024**3 < Analytic.est_memory_requirement(m, n_atoms, True)
    trainer = GDMLTrain(max_memory=gb, device=device)
    model, during, _, probe = grid_train(trainer, task)
    dense = GDMLTrain(device=device).train(task)
    R = task['R_train'].reshape(m, -1)
    Eg, Fg = GDMLPredict(model, device=device).predict(R)
    Ed, Fd = GDMLPredict(dense, device=device).predict(R)
    f_rel = float(np.linalg.norm(Fg - Fd) / np.linalg.norm(Fd))
    solver = probe['solver']
    print('    ethanol M=%d lam=%g with energy constraints (%d unknowns) at %g GB: the grid route (held; %d rung(s), '
          'lam\' %.4e, %d refinement iterations, train() %.3f s, border %.3f s) against the dense model: training '
          'forces %.2e relative (bound %.0e), energies %.2e; K1 launches %s (%s)' % (
              m, lam, m * (3 * n_atoms + 1), gb, len(solver.rungs), solver.lam_p_used, solver.pcg_iters,
              trainer.times['total'], trainer.times['border'], f_rel, bound_rel,
              float(np.abs(Eg - Ed).max() / np.abs(Ed).max()), during, card))
    assert 'alphas_E' in model and f_rel < bound_rel, f_rel
    return during


def phase_grid(device, ethanol, aspirin_cg, card):
    """10: the analytic solver's f32 grid route on the card; K1 runs in
    lmax's power iteration, every refinement matvec and the integration
    constant."""
    t0 = time.perf_counter()
    during, split, grid = phase_grid_aspirin(device, card)
    counts = during
    for run in (lambda: phase_grid_vs_cg(device, aspirin_cg, card), lambda: phase_grid_ecstr(device, ethanol, card)):
        during = run()
        counts = {k: counts[k] + during[k] for k in counts}
    assert counts['pass_a'] > 0 and counts['pass_b'] > 0, counts
    print('[10 grid] aspirin (63,000 unknowns) trained by the f32 grid route with solver=None (held there); the grid '
          'agrees with CG on 8c\'s task and with the dense model under energy constraints; launches %s; %.1f s' % (
              counts, time.perf_counter() - t0))
    return counts, split, grid


@contextlib.contextmanager
def in_dir(path):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)


@contextlib.contextmanager
def step_timer(records):
    """Append ``(step, enclosing step, sig, seconds)`` for each step that
    ``cli all`` runs: create (and the symmetry search in it), the grid's
    train, each ``GDMLTrain.train`` and validation, select and test."""
    stack = [None]

    def wrap(owner, name, label, sig_of):
        fn = getattr(owner, name)

        def run(*args, **kw):
            parent = stack[-1]
            stack.append(label)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                stack.pop()
                records.append((label, parent, sig_of(args), time.perf_counter() - t0))
        return fn, run

    no_sig = lambda args: None  # noqa: E731
    patches = [(cli, 'create', 'create', no_sig), (cli, 'train', 'grid', no_sig),
               (cli, 'select', 'select', no_sig), (cli, 'test', 'test', no_sig),
               (cli, '_validate_model', 'validate', lambda args: float(np.squeeze(args[0]['sig']))),
               (cli.GDMLTrain, 'train', 'train', lambda args: float(np.squeeze(args[1]['sig']))),
               (perm, 'find_perms', 'symmetry search', no_sig)]
    saved = []
    for owner, name, label, sig_of in patches:
        fn, run = wrap(owner, name, label, sig_of)
        saved.append((owner, name, fn))
        setattr(owner, name, run)
    try:
        yield records
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def final_model():
    """The model file that ``all`` wrote into the working directory."""
    names = [f for f in os.listdir('.') if f.endswith('.npz')]
    assert len(names) == 1, names
    return names[0], io.load_dict(names[0])


def recorded(model, key):
    """A model file's recorded error dict (``f_err`` or ``e_err``)."""
    err = model[key]
    return err.item() if isinstance(err, np.ndarray) else err


def cli_quickstart(device, ds_path, ds, card):
    """9a: ``sgdml-tpu-torch all <ethanol> 200 1000 5000``: the default sigma
    grid, symmetry discovery and the default solver."""
    records = []
    fused_predict.reset_launches()
    t0 = time.perf_counter()
    with step_timer(records):
        np.random.seed(1)
        cli.main(['--device', device, 'all', ds_path, *QUICKSTART])
    wall = time.perf_counter() - t0
    during = launch_counts()
    name, model = final_model()
    task_dir = [d for d in os.listdir('.') if os.path.isdir(d)][0]
    trained = sorted(f for f in os.listdir(task_dir) if f.startswith('model-'))
    err, e_err = recorded(model, 'f_err'), recorded(model, 'e_err')
    scale = float(np.abs(ds['F']).mean())
    secs = {label: sum(r[3] for r in records if r[:2] == (label, None))
            for label in ('create', 'grid', 'select', 'test')}
    sigs = sorted({r[2] for r in records if r[0] == 'train'})
    grid = ', '.join('sig %g: train %.3f + validate %.3f' % (
        sig, sum(r[3] for r in records if r[:3] == ('train', 'grid', sig)),
        sum(r[3] for r in records if r[:3] == ('validate', 'grid', sig))) for sig in sigs)
    sym = sum(r[3] for r in records if r[0] == 'symmetry search')
    ref_sigs, ref_sig, ref_f, ref_e = QUICKSTART_JAX
    rel = max(abs(err['mae'] - ref_f) / ref_f, abs(e_err['mae'] - ref_e) / ref_e)
    print('    quick start `all ethanol.npz %s` (N=9, %d frames, grid 10:10:100): %.3f s = create %.3f (symmetry search '
          '%.3f, P=%d) + grid %.3f [%s] + select %.3f (validates %d models) + test %.3f; the grid stopped after %d of '
          '10 sigmas; selected sig=%g -> %s; test force MAE %.8f (%.1f%% of mean |F|), energy MAE %.8f on %d frames, '
          '%.1e relative from the JAX package\'s CPU f64 run (bound %.0e); K1 launches %s (%s)' % (
              ' '.join(QUICKSTART), len(ds['R']), wall, secs['create'], sym, model['perms'].shape[0], secs['grid'],
              grid, secs['select'], len(trained), secs['test'], len(trained), float(np.squeeze(model['sig'])), name,
              err['mae'], 100 * err['mae'] / scale, e_err['mae'], model['n_test'], rel, QUICKSTART_TOL, during,
              card))
    assert io.is_model(model) and np.isfinite(err['mae']) and model['n_test'] == int(QUICKSTART[2]), err
    assert tuple(sigs) == ref_sigs and float(np.squeeze(model['sig'])) == ref_sig and rel <= QUICKSTART_TOL
    assert during['total'] > 0, during
    RESULTS['9a'] = dict(trained=trained, sig=float(np.squeeze(model['sig'])), f_mae=err['mae'], e_mae=e_err['mae'],
                         wall=wall)
    return during


def cli_vs_library(device, ds_path, ds, card):
    """9b: ``all --gdml -s 10`` against ``GDMLTrain`` and ``GDMLPredict``
    called directly on the same split and test indices."""
    fused_predict.reset_launches()
    np.random.seed(1)
    cli.main(['--device', device, 'all', ds_path, *QUICKSTART, '--gdml', '-s', '10', '--task_dir', 't9b'])
    during = launch_counts()
    _, model = final_model()
    n_train, n_valid, n_test = (int(x) for x in QUICKSTART)
    trainer = GDMLTrain(device=device)
    task = trainer.create_task(ds, n_train, ds, n_valid, sig=10, use_sym=False, rng=np.random.RandomState(1))
    ref = trainer.train(task)
    for key in ('idxs_train', 'idxs_valid'):
        np.testing.assert_array_equal(model[key], ref[key])
    a_err = float(np.abs(model['alphas_F'] - ref['alphas_F']).max() / np.abs(ref['alphas_F']).max())
    # The test indices as `test` draws them (sgdml_tpu_torch/cli.py, _validate_model).
    cands = np.setdiff1d(np.arange(len(ds['R'])), np.concatenate([task['idxs_train'], task['idxs_valid']]))
    np.random.seed(0)
    idxs = np.random.choice(cands, n_test, replace=False)
    E, F = GDMLPredict(ref, device=device).predict(ds['R'][idxs].reshape(n_test, -1))
    n_atoms = ds['R'].shape[1]
    refs = {'f_err': cli.force_error_metrics(F, ds['F'][idxs].reshape(n_test, -1), n_atoms),
            'e_err': cli.energy_error_metrics(E, ds['E'][idxs])}
    e_rel = max(abs(recorded(model, key)[k] - v) / abs(v) for key, r in refs.items() for k, v in r.items())
    print('    `all --gdml -s 10` against GDMLTrain/GDMLPredict: splits identical; alphas_F %.2e of max |alpha| (bound '
          '1e-10); recorded test errors (%d metrics on %d frames) %.2e relative from force_error_metrics and '
          'energy_error_metrics of GDMLPredict (bound 1e-12); K1 launches %s (%s)' % (
              a_err, sum(len(r) for r in refs.values()), n_test, e_rel, during, card))
    assert model['n_test'] == n_test and a_err <= 1e-10 and e_rel <= 1e-12, (a_err, e_rel)
    return during


def cli_cg_resume(device, ds_path, ethanol, cold_iters, card):
    """9c: a CG training cut by its wall budget, then ``resume`` to
    convergence, against phase 7c's dense model."""
    ds, task7, dense = ethanol
    n_train, n_valid = len(task7['idxs_train']), len(task7['idxs_valid'])
    np.random.seed(ETHANOL[3])
    cli.main(['--device', device, 'create', ds_path, str(n_train), str(n_valid), '-s', '%g' % ETHANOL[5], '--gdml',
              '--task_dir', 't9c'])
    path = os.path.join('t9c', io.model_file_name(task7))
    counts, models, secs = [], [], []
    for argv in (['train', 't9c', '--solver', 'cg', '--max_seconds', str(CLI_CG_CUT_SECONDS)],
                 ['resume', path, ds_path]):
        fused_predict.reset_launches()
        t0 = time.perf_counter()
        cli.main(['--device', device, *argv, '--max_memory', str(CG_ETHANOL_GB)])
        secs.append(time.perf_counter() - t0)
        counts.append(launch_counts())
        models.append(io.load_dict(path))
    cut, model = models
    np.testing.assert_array_equal(model['idxs_train'], task7['idxs_train'])
    conv = [m['solver_resid'] <= m['solver_tol'] * m['norm_y_train'] for m in models]
    R, _, _ = held_out(ds, task7, 1000)
    Ea, Fa = GDMLPredict(dense, device=device).predict(R)
    Ec, Fc = GDMLPredict(model, device=device).predict(R)
    f_rel = float(np.abs(Fc - Fa).mean() / np.abs(Fa).mean())
    e_diff = float(np.abs((Ec - Ec.mean()) - (Ea - Ea.mean())).mean())
    print('    ethanol M=%d by `train --solver cg --max_seconds %g --max_memory %g`: %d iterations in %.3f s, converged '
          '%s (resid %.3e, target %.3e); `resume`: %d iterations in all (phase 8b cold: %d) in %.3f s, converged %s; '
          'against the dense model on %d held-out frames: mean |dF| / mean |F| %.2e (bound %.0e), centered |dE| '
          '%.2e (bound %.0e); K1 launches %s and %s (%s)' % (
              n_train, CLI_CG_CUT_SECONDS, CG_ETHANOL_GB, cut['solver_iters'], secs[0], conv[0], cut['solver_resid'],
              cut['solver_tol'] * cut['norm_y_train'], model['solver_iters'], cold_iters, secs[1], conv[1], len(R),
              f_rel, CG_DENSE_BOUNDS[0], e_diff, CG_DENSE_BOUNDS[1], counts[0], counts[1], card))
    assert conv == [False, True] and model['solver_iters'] > cut['solver_iters'], conv
    assert f_rel < CG_DENSE_BOUNDS[0] and e_diff < CG_DENSE_BOUNDS[1], (f_rel, e_diff)
    return {k: counts[0][k] + counts[1][k] for k in counts[0]}


class Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages, self.records = [], []

    def emit(self, record):
        self.messages.append(record.getMessage())
        self.records.append(record)


def cli_tuner(device, model, card):
    """9d: ``prepare_parallel`` at the AT-AT width of phase 5 in f64 and f32;
    a second predictor's call comes from the cache (no launch)."""
    logger, records = logging.getLogger(tune.__name__), Records()
    level = logger.level
    logger.addHandler(records)
    logger.setLevel(logging.INFO)
    counts = dict.fromkeys(launch_counts(), 0)
    try:
        for dtype in (torch.float64, torch.float32):
            pred = GDMLPredict(model, dtype=dtype, device=device)
            del records.messages[:]
            fused_predict.reset_launches()
            t0 = time.perf_counter()
            gps = pred.prepare_parallel(n_bulk=TUNE_BULK)
            secs = time.perf_counter() - t0
            during = launch_counts()
            counts = {k: counts[k] + during[k] for k in counts}
            ladder = [m for m in records.messages if m.startswith('bucket')]
            again = GDMLPredict(model, dtype=dtype, device=device)
            fused_predict.reset_launches()
            gps2 = again.prepare_parallel(n_bulk=TUNE_BULK)
            print('    tuner %s N=%d M=%d n_bulk=%d: %s; chose batch_size %d (%.0f geometries/s) in %.2f s, K1 '
                  'launches %s; a second predictor: batch_size %d from the cache, %d launches (%s)' % (
                      NAME[dtype], pred.n_atoms, pred.n_train, TUNE_BULK, '; '.join(ladder), pred.batch_size, gps,
                      secs, during, again.batch_size, fused_predict.LAUNCHES, card))
            rungs = [b for b in tune.BUCKET_LADDER if b < 2 * max(TUNE_BULK, 32)]
            assert len(ladder) == len(rungs) and during['total'] > 0, (ladder, during)
            assert fused_predict.LAUNCHES == 0 and gps2 == gps and again.batch_size == pred.batch_size
    finally:
        logger.removeHandler(records)
        logger.setLevel(level)
    return counts


def cli_ase(device, card):
    """9e: the ASE calculator on the golden model, through the stand-in for
    ASE that the CPU tests use (ASE is not installed), against
    ``GDMLPredict`` converted by the unit factors."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import ase_standin

    model = io.load_dict(os.path.join(GOLDEN, 'model_ref.npz'))
    R = np.load(os.path.join(GOLDEN, 'train_predict_ref.npz'))['R_test']
    with ase_standin.installed():
        calc = importlib.reload(ase_calc).SGDMLCalculator(model, device=device)
    atoms = [ase_standin.Atoms(r) for r in R]
    fused_predict.reset_launches()
    t0 = time.perf_counter()
    E_calc, F_calc = [], []
    for i in range(ASE_CALLS):
        calc.calculate(atoms[i % len(atoms)])
        E_calc.append(calc.results['energy'])
        F_calc.append(calc.results['forces'])
    us = (time.perf_counter() - t0) / ASE_CALLS * 1e6
    during = launch_counts()
    E, F = GDMLPredict(model, device=device).predict(R)
    picks = np.arange(ASE_CALLS) % len(R)
    E_ref, F_ref = E[picks] * calc.E_to_eV, F[picks].reshape(ASE_CALLS, -1, 3) * calc.F_to_eV_Ang
    e_rel = float(np.abs(np.array(E_calc) - E_ref).max() / np.abs(E_ref).max())
    f_rel = float(np.abs(np.array(F_calc) - F_ref).max() / np.abs(F_ref).max())
    print('    ASE calculator (stand-in ase module) on the golden model: %d calculate() calls, %.1f us a call; E %.2e, '
          'F %.2e of max |value| from GDMLPredict times the unit factors (bound 1e-12); K1 launches %s (%s)' % (
              ASE_CALLS, us, e_rel, f_rel, during, card))
    assert e_rel <= 1e-12 and f_rel <= 1e-12 and during['total'] == ASE_CALLS, (e_rel, f_rel, during)
    return during


def phase_cli(device, ethanol, atat_model, cold_iters, card):
    """9: the command line and the host modules on the card, in a temporary
    directory, with the tune cache pointed there."""
    t0 = time.perf_counter()
    ds = ethanol[0]
    counts = dict.fromkeys(launch_counts(), 0)
    saved = os.environ.get(tune._CACHE_ENV)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_') as tmp:
        os.environ[tune._CACHE_ENV] = os.path.join(tmp, 'bmark_cache.json')
        try:
            ds_path = os.path.join(tmp, 'ethanol.npz')
            io.save_dict(ds_path, ds)
            runs = (('9a', lambda: cli_quickstart(device, ds_path, ds, card)),
                    ('9b', lambda: cli_vs_library(device, ds_path, ds, card)),
                    ('9c', lambda: cli_cg_resume(device, ds_path, ethanol, cold_iters, card)),
                    ('9d', lambda: cli_tuner(device, atat_model, card)),
                    ('9e', lambda: cli_ase(device, card)))
            for sub, run in runs:
                with in_dir(os.path.join(tmp, sub)):
                    during = run()
                counts = {k: counts[k] + during[k] for k in counts}
        finally:
            if saved is None:
                os.environ.pop(tune._CACHE_ENV, None)
            else:
                os.environ[tune._CACHE_ENV] = saved
    assert counts['total'] > 0, counts
    print('[9 cli] quick start = the JAX package\'s; CLI model = library model; resume converged and agrees with the '
          'dense model; tuner ladder and cache; ASE calculator = GDMLPredict; launches %s; %.1f s' % (
              counts, time.perf_counter() - t0))
    return counts


def int8_bound(m, k, n):
    """(ms, 'bytes' or 'operations'): the least time of an (m, k) x (k, n)
    int8 product with an int32 result on an H100 SXM."""
    t_ops = 2.0 * m * k * n / H100_INT8_OPS * 1e3
    t_bytes = (m * k + k * n + 4 * m * n) / H100_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def int8_operands(m, k, n, device, seed, b_layout='rows'):
    """Random int8 operands of the slices' range; ``b_layout`` 'cols' gives a
    column-major ``b`` (the route's vector slices and Gram operands),
    'chunk^T' also ``a`` as the transpose of a column chunk of a wider
    matrix (a slice of the stack, read in place)."""
    g = torch.Generator(device='cpu').manual_seed(seed)

    def draw(*shape):
        return torch.randint(-96, 97, shape, generator=g, dtype=torch.int8).to(device)

    if b_layout == 'chunk^T':  # a column chunk of a wider slice, read as A^T; b column-major
        return draw(k, 3 * m)[:, m:2 * m].T, draw(n, k).T
    a = draw(m, k)
    if b_layout == 'cols':
        return a, draw(n, k).T
    return a, draw(k, n)


def phase_ozaki_products(device, card):
    """11a: the int8 product, the splits and the Ozaki functions on the card.
    Returns the AT-AT plan (slices, k) at the card's free memory."""
    budget = memory_budget(device)
    ns, k = it_mod.Iterative(max_memory=budget / 1024**3, device=device).resolve_factor_slices(3000, 60)
    kcols, stride = -(-k * 180 // 16) * 16, -(-45 * 180 // 16) * 16  # the AT-AT stack's rows and chunk
    n_ch = -(-3000 // 45)  # the stack's chunks; the last column is how many products of the kind a CG
    # iteration launches at the 'ozaki' rung (the Gram chunk's are the build's; the transposed apply's take
    # a slice's whole width)
    cases = [
        ('stack apply F v: %d slices x %d rows, one chunk, against the 8 vector slices and 8 zero columns' % (
            ns, kcols), (ns * kcols, stride, 16, 'cols'), n_ch),
        ('stack apply F^T w: a slice\'s chunk, column-major, against the 8 vector slices (the route takes a '
         'slice\'s whole width at once)', (stride, kcols, 8, 'chunk^T'), ns),
        ('Gram chunk: one slice of Y (k x 8,100) against another, transposed', (kcols, stride, kcols, 'cols'), 0),
        ('predict Xq Xt^T and Xq JA^T (D 1,770 -> 1,776): one slice against 6', (3000, 1776, 6 * 3000, 'cols'), 12),
        ('predict w1 Xt and w2 JA (T 3,000 -> 3,008): one slice against 6', (3000, 3008, 6 * 1776, 'cols'), 12),
        ('ragged: 5 rows, inner 1,770, 3 columns (every padding)', (5, 1770, 3, 'rows'), 0),
    ]
    for i, (label, (m, kk, n, layout), per_use) in enumerate(cases):
        a, b = int8_operands(m, kk, n, device, seed=i, b_layout=layout)
        out = ozaki._int8_mm(a, b)
        a64, b64 = a.double(), b.double()
        exact = torch.equal(out.double(), a64 @ b64)
        ms, mm_ms = time_pair(lambda: ozaki._int8_mm(a, b), lambda: a64 @ b64)
        b_ms, b_by = int8_bound(m, kk, n)
        print('    _int8_mm %-74s (%d, %d) x (%d, %d): exact %s; %.3f ms (%.1f TOP/s; bound %.4f ms by %s, %.1f%%) vs '
              'torch.matmul f64 %.3f ms (%.1f TFLOP/s); %d of the kind a CG iteration (%s)' % (
                  label, m, kk, kk, n, exact, ms, 2e-9 * m * kk * n / ms, b_ms, b_by, 100 * b_ms / ms, mm_ms,
                  2e-9 * m * kk * n / mm_ms, per_use, card))
        assert exact and out.shape == (m, n) and out.dtype == torch.int32, label
        del a, b, a64, b64, out

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 1770)) * np.exp(3.0 * rng.standard_normal((3000, 1)))
    xs = {d: torch.as_tensor(x, device=d) for d in (device, 'cpu')}
    pairs = {d: (v.float(), (v - v.float().double()).float()) for d, v in xs.items()}
    for name, fn in (('split_pair_int8 (6 slices)', lambda d: ozaki.split_pair_int8(*pairs[d], 6)),
                     ('split_global_int8 (8 slices)', lambda d: ozaki.split_global_int8(xs[d], 8))):
        (s_d, sig_d), (s_c, sig_c) = fn(device), fn('cpu')
        assert torch.equal(s_d.cpu(), s_c) and torch.equal(sig_d.cpu(), sig_c), name
    errs = {}
    A = torch.as_tensor(rng.standard_normal((2000, 4 * stride)))
    parts = [ozaki.split_global_int8(A[:, c * stride:(c + 1) * stride], ns) for c in range(4)]
    stack, sig = torch.cat([p[0] for p in parts], 2), torch.stack([p[1] for p in parts])
    v, w = torch.as_tensor(rng.standard_normal(4 * stride)), torch.as_tensor(rng.standard_normal(2000))
    sa, sga = ozaki.split_global_int8(A[:, :800])
    funcs = {
        'ozaki_gemm_nt': lambda d: ozaki.ozaki_gemm_nt(pairs[d][0][:500], pairs[d][0][500:1100],
                                                        lo_a=pairs[d][1][:500], lo_b=pairs[d][1][500:1100]),
        'matvec_sliced': lambda d: ozaki.matvec_sliced(sa.to(d), sga.to(d), v[:800].to(d)),
        'matvec_sliced transposed': lambda d: ozaki.matvec_sliced(sa.to(d), sga.to(d), w[:, None].to(d),
                                                                  transpose=True),
        'matvec_sliced_long': lambda d: ozaki.matvec_sliced_long(stack.to(d), sig.to(d), v.to(d), chunk=stride),
        'matvec_sliced_long_t': lambda d: ozaki.matvec_sliced_long_t(stack.to(d), sig.to(d), w.to(d), chunk=stride),
    }
    for name, fn in funcs.items():
        errs[name] = rel_err(fn(device).cpu(), fn('cpu'))
    print('    splits of a (3000, 1770) f64 matrix on the card equal the CPU\'s bit for bit; against the CPU: %s '
          '(bound %.0e)' % (', '.join('%s %.1e' % kv for kv in errs.items()), OZAKI_DEVICE_TOL))
    assert max(errs.values()) <= OZAKI_DEVICE_TOL, errs
    return ns, k


def phase_ozaki_ladder(device, card):
    """11b: the CG matvec at each Ozaki rung against 'native' (K1) at the
    AT-AT and aspirin CG widths, on descriptors drawn as bench.py draws
    them; these launches are not counted."""
    for label, (m, D, n_atoms) in OZAKI_WIDTHS.items():
        rng = np.random.default_rng(m)
        X = torch.as_tensor(0.3 + rng.random((m, D)), device=device)
        Jc = torch.as_tensor(rng.normal(size=(m, D, 3)) * 1e-2, device=device)
        tab = it_mod.matvec_tables(X, Jc, np.arange(D)[None])
        v = torch.as_tensor(rng.normal(size=m * 3 * n_atoms), device=device)
        sig = math.sqrt(5.0 * D / 6.0) / 2.0

        def mv(mm):
            return it_mod._matvec_A(v, tab, sig, 0.0, n_atoms=n_atoms, use_E_cstr=False, mm=mm)

        ref = mv('native')
        line = []
        for rung in OZAKI_RUNGS:
            ns = int(rung[5:] or 6)
            err = rel_err(mv(rung), ref)
            ms, native_ms = time_pair(lambda: mv(rung), lambda: mv('native'))
            line.append('%s %.2e (2^-6N %.1e) %.3f ms vs native %.3f ms' % (rung, err, 2.0 ** (-6 * ns), ms,
                                                                          native_ms))
            # Far below f32 (the products cancel in F_d, so not 2^-6N itself).
            assert err <= 1e-6, (label, rung, err)
        print('    matvec rungs at the %s CG width B=T=%d D=%d: %s (%s)' % (label, m, D, '; '.join(line), card))


@contextlib.contextmanager
def ozaki_factor():
    """``train()`` builds its solver with ``factor_mode='ozaki'``; yields the
    solvers made, each keeping the last slice stack it built (``factor``; on
    a mesh its ``spmd.ShardedSliceFactor``) and the solver's and the mesh
    layer's log records."""
    made, records = [], Records()

    class OzakiIterative(it_mod.Iterative):
        def __init__(self, *args, **kw):
            super().__init__(*args, factor_mode='ozaki', **kw)
            self.factor = None
            made.append(self)

        def _build_factor(self, *args, **kw):
            self.factor = None
            self.factor, lev = super()._build_factor(*args, **kw)
            return self.factor, lev

    loggers = [logging.getLogger(mod.__name__) for mod in (it_mod, spmd)]
    levels = [logger.level for logger in loggers]
    for logger in loggers:
        logger.addHandler(records)
        logger.setLevel(logging.INFO)
    saved, train_mod.Iterative = train_mod.Iterative, OzakiIterative
    try:
        yield made, records
    finally:
        train_mod.Iterative = saved
        for logger, level in zip(loggers, levels):
            logger.removeHandler(records)
            logger.setLevel(level)


def ozaki_recipe(device, r, max_seconds, slices=None):
    """Phase 8's task ``r`` trained again through ``train()`` with the slice-
    stack factor (``slices``: None reads the default, automatic), at the
    budget the card has free now; the run's counts, peak, re-measured
    residual and what the solver logged."""
    gc.collect()  # an earlier run's solvers and stack sit in a reference cycle (their class closes over `made`)
    budget = memory_budget(device)
    trainer = GDMLTrain(max_memory=budget / 1024**3, device=device)
    n_atoms = r['task']['R_train'].shape[1]
    with ozaki_factor() as (made, records):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_predict.reset_launches()
        model = trainer.train(r['task'], solver='cg', solver_max_seconds=max_seconds, factor_slices=slices)
        during, per_it = cg_launches(model['solver_iters'])
        peak = torch.cuda.max_memory_allocated()
    solver = made[-1]
    build = [rec.args for rec in records.records if rec.msg.startswith('Streamed slice-stack factor')][-1]
    rungs = [rec.args[2] for rec in records.records if 'escalating' in rec.msg]
    return dict(model=model, times=trainer.times, peak=peak, during=during, per_it=per_it, budget=budget,
                k=len(model['inducing_pts_idxs']) // (3 * n_atoms), ns=solver._ns(), factor=solver.factor,
                resid=true_resid(model, r['X'], r['Jc'], r['dperms'], r['y'], n_atoms),
                capped=[m for m in records.messages if 'capped at' in m], rung=(rungs or ['ozaki'])[-1],
                sweeps=dict(zip(('W', 'Gram', 'F', 'renorm'), build[-4:])), stack_gb=build[3])


def ozaki_split(label, r, o, card):
    """Device ms of one iteration's parts at an ``ozaki_recipe`` run's shapes,
    each alone: the matvec at the rung it reached, K1 at the same shape
    (held against its plain version on one matvec's inputs, then timed in
    turns with it), and the slice-stack apply. Returns K1's entry for the
    kernels line."""
    X, Jc, dperms = r['X'], r['Jc'], r['dperms']
    sig, lam = float(r['task']['sig']), float(r['task']['lam'])
    n_atoms = r['task']['R_train'].shape[1]
    tab = it_mod.matvec_tables(X, Jc, dperms)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=r['n']), device=X.device)
    JA = desc_ops.jac_dot_vec(Jc, v.reshape(-1, 3 * n_atoms), n_atoms)[:, tab.dp].reshape(-1, X.shape[1])
    JA = JA.contiguous()
    args = (X - tab.mu, tab.Xt, JA, tab.xt_sq, torch.sum(tab.Xt * JA, dim=1), None, sig)
    B, D, T = X.shape[0], X.shape[1], tab.Xt.shape[0]
    kernel = lambda: fused_predict.fused_predict_tables(*args)  # noqa: E731
    plain = lambda: fused_predict.fused_predict_tables_reference(*args)  # noqa: E731
    max_abs = check('CG matvec %s (slice stack) B=%d T=%d D=%d f64' % (label, B, T, D), kernel, plain,
                    TOL[torch.float64])
    k1_ms, plain_ms = time_pair(kernel, plain)
    F = o['factor']
    mv_ms, apply_ms = time_pair(
        lambda: it_mod._matvec_A(v, tab, sig, lam, n_atoms=n_atoms, use_E_cstr=False, mm=o['rung']),
        lambda: it_mod._precond(F, v, lam))
    b_ms, b_by = bound(B, T, D, 8)
    s_bytes = (F.F if isinstance(F, spmd.ShardedSliceFactor) else F).s.numel()
    print('    %s slice-stack iteration parts (k=%d, %d slices, stack %.2f GB): matvec at %r %.3f ms; K1 at B=%d T=%d '
          'D=%d f64 %.3f ms vs plain %.3f ms, bound %.4f ms by %s (%.1f%%); slice-stack apply %.3f ms (reads the '
          'stack twice, %.0f GB/s) (%s)' % (
              label, o['k'], o['ns'], s_bytes / 1e9, o['rung'], mv_ms, B, T, D, k1_ms, plain_ms, b_ms, b_by,
              100 * b_ms / k1_ms, apply_ms, 2 * s_bytes / apply_ms * 1e-6, card))
    return {'label': label + ' (slice stack)', 'B': B, 'T': T, 'D': D, 'ms': k1_ms, 'plain_ms': plain_ms,
            'bound_ms': b_ms, 'bound_by': b_by, 'max_abs_err': max_abs, 'k': o['k'], 'slices': o['ns'],
            'matvec_rung': o['rung'], 'matvec_ms': mv_ms, 'apply_ms': apply_ms}


def ozaki_line(label, o):
    t = o['times']
    return ('%s by the slice stack: budget %.1f GB, %d slices, k=%d%s, stack %.2f GB, factor %.2f s (sweeps of the '
            'factor\'s build: W %.2f, Gram %.2f, F %.2f, renormalization %.2f s), leverage scores %.2f s, %d iterations '
            'in %.2f s of CG (%.2f iterations/s), rung reached %r, train() %.2f s, peak allocated %.2f GB' % (
                label, o['budget'] / 1e9, o['ns'], o['k'], ' (%s)' % '; '.join(o['capped']) if o['capped'] else '',
                o['stack_gb'], t['factor'], *(o['sweeps'][key] for key in ('W', 'Gram', 'F', 'renorm')),
                t['leverage scores'], o['model']['solver_iters'], t['cg'], o['model']['solver_iters'] / t['cg'],
                o['rung'], t['total'], o['peak'] / 1e9))


def phase_ozaki_aspirin(device, aspirin_cg, card):
    """11c: phase 8c's aspirin task with the slice-stack factor: it must
    converge, to 8c's MAE bound and to 8c's model."""
    r = aspirin_cg
    o = ozaki_recipe(device, r, CG_ASPIRIN_SECONDS)
    model, c8 = o['model'], r['model']
    tol_b = model['solver_tol'] * model['norm_y_train']
    conv = model['solver_resid'] <= tol_b
    drift = abs(o['resid'] - model['solver_resid']) / o['resid']
    R, F_ref, _ = held_out(r['ds'], r['task'], 500)
    _, F = GDMLPredict(model, device=device).predict(R)
    _, F8 = GDMLPredict(c8, device=device).predict(R)
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    f_rel = float(np.abs(F - F8).mean() / np.abs(F8).mean())
    print('    %s; converged %s, recorded resid %.3e, re-measured by the plain matvec %.3e (drift %.2e; target %.3e); '
          'held-out force MAE %.5f (bound %.4f) on %d frames, mean |dF| / mean |F| against 8c\'s model %.2e (bound '
          '%.0e); 8c (f64 factor): k=%d, %d iterations, train() %.2f s, peak %.2f GB; K1 %.2f launches an iteration %s '
          '(%s)' % (
              ozaki_line('aspirin M=%d' % len(r['task']['idxs_train']), o), conv, model['solver_resid'], o['resid'],
              drift, tol_b, mae, CG_MAE_SHARE * scale, len(R), f_rel, CG_DENSE_BOUNDS[0], r['k'], c8['solver_iters'],
              r['times']['total'], r['peak'] / 1e9, o['per_it'], o['during'], card))
    assert conv and o['resid'] <= tol_b and drift <= it_mod.RESID_REPLACE_DRIFT, (conv, o['resid'], tol_b, drift)
    assert mae < CG_MAE_SHARE * scale and f_rel < CG_DENSE_BOUNDS[0], (mae, scale, f_rel)
    split = ozaki_split('aspirin', r, o, card)
    split['solver_iters'] = int(model['solver_iters'])
    RESULTS['11c'] = {key: o[key] for key in ('budget', 'k', 'ns', 'stack_gb', 'times', 'peak', 'sweeps', 'rung')}
    RESULTS['11c'].update(iters=int(model['solver_iters']), apply_ms=split['apply_ms'])
    return o['during'], split


def phase_ozaki_atat(device, atat_cg, card, slices):
    """11d: phase 8d's AT-AT task with the slice-stack factor under 8d's wall
    budget, at ``slices`` (None: automatic): a larger k than 8d's, and with
    ``fall`` a residual re-measured below its start (``OZAKI_ATAT_FALL``)."""
    r = atat_cg
    o = ozaki_recipe(device, r, CG_ATAT_SECONDS, slices)
    model, c8 = o['model'], r['model']
    drift = abs(o['resid'] - model['solver_resid']) / o['resid']
    print('    %s; residual %.4e -> %.4e (target %.3e), re-measured by the plain matvec %.4e (drift %.2e, bound %.0e); '
          '8d (f64 factor) after its %.0f s: k=%d, %d iterations (%.2f iterations/s), residual %.4e; K1 %.2f launches '
          'an iteration %s (%s)' % (
              ozaki_line('AT-AT M=%d' % len(r['task']['idxs_train']), o), model['norm_y_train'],
              model['solver_resid'], model['solver_tol'] * model['norm_y_train'], o['resid'], drift,
              it_mod.RESID_REPLACE_DRIFT, CG_ATAT_SECONDS, r['k'], c8['solver_iters'],
              c8['solver_iters'] / r['times']['cg'], c8['solver_resid'], o['per_it'], o['during'], card))
    assert o['k'] > r['k'] and drift <= it_mod.RESID_REPLACE_DRIFT, (o['k'], r['k'], drift)
    if slices == 8:
        assert o['resid'] < OZAKI_ATAT_FALL * model['norm_y_train'], (o['resid'], model['norm_y_train'])
    split = ozaki_split('AT-AT %d slices' % o['ns'], r, o, card)
    split['solver_iters'] = int(model['solver_iters'])
    return o['during'], split


def phase_ozaki(device, aspirin_cg, atat_cg, card):
    """11: the int8 Ozaki routes; K1 runs in every residual replacement, the
    first residual, the integration constant and the 'native' rung."""
    t0 = time.perf_counter()
    ns, k = phase_ozaki_products(device, card)
    phase_ozaki_ladder(device, card)
    counts = dict.fromkeys(launch_counts(), 0)
    splits = []
    for run in (lambda: phase_ozaki_aspirin(device, aspirin_cg, card),
                lambda: phase_ozaki_atat(device, atat_cg, card, None),
                lambda: phase_ozaki_atat(device, atat_cg, card, 8)):
        during, split = run()
        counts = {key: counts[key] + during[key] for key in counts}
        splits.append(split)
    assert counts['total'] > 0, counts
    print('[11 ozaki] int8 products exact at the route\'s shapes; splits and products on the card = the CPU\'s; the '
          'slice stack trained aspirin to 8c\'s model and AT-AT at k=%d (%d slices) and k=%d (8 slices, its residual '
          'fell) > 8d\'s (11a\'s plan at its budget: %d slices, k=%d); launches %s; %.1f s' % (
              splits[1]['k'], splits[1]['slices'], splits[2]['k'], ns, k, counts, time.perf_counter() - t0))
    return counts, splits


@contextlib.contextmanager
def pair_probe(n):
    """Watch the pair route inside ``train()``: the device ms of the
    factor's steps by kind (CUDA events recorded around each leaf Cholesky,
    panel refinement and trailing update, read at the end: the device time
    between them), each ``chol_grid_pair`` call's side, ``info`` and seconds
    (synchronized before and after), ``L L^T v`` of the factor that held on
    ``probe_vector(n, ...)`` (made when the factor returns, before the repack
    consumes it; the seconds it takes, which train() counts in its factor
    phase), the int8 strips and leaf stacks the repack made, the ``Analytic``
    instance that solved, and the solver's log lines at INFO.
    ``Analytic.est_memory_inplace`` reads as infinite inside the block, so a
    system past the dense bound leaves the in-place f64 route (phase 15)
    for the JAX package's pair-or-grid rule."""
    probe = {'events': {'leaf': [], 'panel': [], 'update': []}, 'chol': [], 'llt': None, 'v': None,
             'llt_s': 0.0, 'strips': None, 'leaves': None, 'solver': None, 'log': Records()}
    names = ('_diag_chol_pair', '_panel_refine_pair', '_trailing_update_pair', 'chol_grid_pair', 'int8_strips',
             'slice_leaf_inverses')
    saved = {name: getattr(pairchol, name) for name in names}
    solve, inplace_need = Analytic._solve_pair_pcg, Analytic.est_memory_inplace

    def timed(kind, fn):
        def run(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            probe['events'][kind].append((start, end))
            return out
        return run

    def chol(Ghi, Glo):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Lh, Ll, info = saved['chol_grid_pair'](Ghi, Glo)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probe['chol'].append((len(Ghi) * Ghi[0][0].shape[0], info, t1 - t0))
        if info == 0:
            k, b = len(Lh), Lh[0][0].shape[0]
            probe['v'] = v = probe_vector(n, k * b, Lh[0][0].device)

            def block(r, c):
                x = pairchol.pair_to_f64(Lh[r][c], Ll[r][c])
                return torch.tril(x) if r == c else x

            probe['llt'] = factor_llt(block, k, b, v)
            torch.cuda.synchronize()
            probe['llt_s'] = time.perf_counter() - t1
        return Lh, Ll, info

    def kept(key, fn):
        def run(arg):
            probe[key] = fn(arg)
            return probe[key]
        return run

    def watched(self, *args, **kw):
        probe['solver'] = self
        return solve(self, *args, **kw)

    logger = logging.getLogger(an_mod.__name__)
    level = logger.level
    logger.addHandler(probe['log'])
    logger.setLevel(logging.INFO)
    pairchol._diag_chol_pair = timed('leaf', saved['_diag_chol_pair'])
    pairchol._panel_refine_pair = timed('panel', saved['_panel_refine_pair'])
    pairchol._trailing_update_pair = timed('update', saved['_trailing_update_pair'])
    pairchol.chol_grid_pair = chol
    pairchol.int8_strips = kept('strips', saved['int8_strips'])
    pairchol.slice_leaf_inverses = kept('leaves', saved['slice_leaf_inverses'])
    Analytic._solve_pair_pcg = watched
    Analytic.est_memory_inplace = staticmethod(lambda *args: math.inf)
    try:
        yield probe
    finally:
        for name, fn in saved.items():
            setattr(pairchol, name, fn)
        Analytic._solve_pair_pcg = solve
        Analytic.est_memory_inplace = staticmethod(inplace_need)
        logger.removeHandler(probe['log'])
        logger.setLevel(level)


def pair_train(trainer, task, solver=None):
    """``trainer.train(task, solver)``, which must take the pair route and
    not fall back, with its peak memory above what was allocated before it,
    its K1 launches (from 0) and the probe."""
    n = task['R_train'].shape[0] * 3 * task['R_train'].shape[1]
    with pair_probe(n) as probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fused_predict.reset_launches()
        model = trainer.train(task, solver=solver)
        during = launch_counts()
    fell_back = [msg for msg in probe['log'].messages if 'falling back' in msg]
    assert model['solver_name'] == 'analytic' and probe['solver'] is not None and not fell_back, fell_back
    assert probe['solver'].route == 'pair' and probe['llt'] is not None, probe['solver'].route
    return model, during, torch.cuda.max_memory_allocated() - base, probe


def factor_steps(probe):
    """Seconds and calls of the factor's steps by kind (the probe's events)."""
    return {kind: (sum(a.elapsed_time(b) for a, b in ev) / 1e3, len(ev)) for kind, ev in probe['events'].items()}


def host_ms(fn):
    """Host milliseconds to enqueue ``fn()`` on an idle card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def pair_split(label, sstrips, leaves, X, Jc, dperms, sig, lam, n_atoms, iters, card):
    """Device ms of one refinement-CG iteration at a pair solve's shapes and
    factor (a chunk of GRID_SPLIT_ITERS), and of its parts, each timed alone:
    the matvec, K1 inside it (``k1_on_tables``), the strip solve as the route
    runs it (replayed from its CUDA graph, which must give the eager solve's
    bits) and eager (with the host's milliseconds to enqueue each), its
    forward strip sweep, its transposed strip sweep and its 2k leaf applies
    (eager), with GB/s over the bytes each reads (the strips once a sweep,
    the leaf stacks twice). Returns K1's entry and the parts' times."""
    tab, v, k1 = k1_on_tables('pair CG matvec %s' % label, X, Jc, dperms, sig, n_atoms)
    n = v.shape[0]
    A_apply = an_mod._matvec_op(tab, sig, lam, n_atoms=n_atoms, use_E_cstr=False)
    M_apply = an_mod._pair_M_apply(sstrips, leaves, None, None, n, 0, False)
    eager = lambda: pairchol.solve_strips_int8(sstrips, leaves, v)  # noqa: E731
    graphed = M_apply(v)
    assert torch.equal(graphed, eager()), 'the strip solve replayed from its CUDA graph differs from the eager one'
    mv_ms, solve_ms = time_pair(lambda: A_apply(v), lambda: M_apply(v))
    eager_ms = cuda_ms(eager, 2)
    host_graph_ms, host_eager_ms = host_ms(lambda: M_apply(v)), host_ms(eager)
    k, b = len(leaves), leaves[0].rows
    z = torch.ones((b, 1), dtype=torch.float64, device=X.device)
    y = torch.zeros((k * b, 1), dtype=torch.float64, device=X.device)
    x = torch.ones((k * b, 1), dtype=torch.float64, device=X.device)
    sweeps = {
        'forward': lambda: [pairchol._strip_apply_int8(st, z, y, (j + 1) * b) for j, st in enumerate(sstrips)
                            if st is not None],
        'transposed': lambda: [pairchol._strip_tapply_int8(st, x, (j + 1) * b, b) for j, st in enumerate(sstrips)
                               if st is not None],
        'leaves': lambda: [pairchol._leaf_apply(d, z, t) for d in leaves for t in (False, True)],
    }
    ms = {}
    for name, fn in sweeps.items():
        fn()
        torch.cuda.synchronize()
        ms[name] = cuda_ms(fn, 3)
    z0 = M_apply(v)
    state = (torch.zeros_like(v), v, z0, z0, v @ z0, None)
    chunk = lambda: an_mod._pcg_chol(state, A_apply, M_apply, 1.0, 0.0, max_iters=GRID_SPLIT_ITERS)  # noqa: E731
    chunk()
    it_ms = cuda_ms(chunk, 1) / GRID_SPLIT_ITERS
    s_bytes = sum(st.slices.numel() for st in sstrips if st is not None)
    l_bytes = sum(d.slices.numel() for d in leaves)
    floor = (2 * s_bytes + 2 * l_bytes) / H100_BYTES_PER_S * 1e3
    print('    %s refinement iteration (%d x %d blocks of %d; int8 strips %.2f GB, leaf stacks %.2f GB): %.3f ms in a '
          'chunk of %d; its parts timed alone: matvec %.3f (K1 %.3f), the strip solve from its CUDA graph %.3f '
          '(enqueued in %.3f ms; its reads floor %.3f, %.1f%%) = the eager one\'s bits, the eager solve %.3f '
          '(enqueued in %.3f ms); eager, its forward strip sweep %.3f (%.0f GB/s), transposed strip sweep %.3f (%.0f '
          'GB/s), %d leaf applies %.3f (%.0f GB/s); K1 at B=%d T=%d D=%d f64 %.3f ms vs plain %.3f ms, bound %.4f ms '
          'by %s (%.1f%%), route %s (%s)' % (
              label, k, k, b, s_bytes / 1e9, l_bytes / 1e9, it_ms, GRID_SPLIT_ITERS, mv_ms, k1['ms'], solve_ms,
              host_graph_ms, floor, 100 * floor / solve_ms, eager_ms, host_eager_ms, ms['forward'],
              s_bytes / ms['forward'] * 1e-6, ms['transposed'], s_bytes / ms['transposed'] * 1e-6, 2 * k,
              ms['leaves'], 2 * l_bytes / ms['leaves'] * 1e-6, k1['B'], k1['T'], k1['D'], k1['ms'], k1['plain_ms'],
              k1['bound_ms'], k1['bound_by'], 100 * k1['bound_ms'] / k1['ms'], fused_predict.route(k1['T'], k1['D']),
              card))
    return dict(k1, label=label, iteration_ms=it_ms, matvec_ms=mv_ms, apply_ms=solve_ms, eager_apply_ms=eager_ms,
                host_apply_ms=host_graph_ms, host_eager_apply_ms=host_eager_ms, forward_ms=ms['forward'],
                transposed_ms=ms['transposed'], leaves_ms=ms['leaves'], solver_iters=int(iters))


def strip_to_pair(st, b):
    """The pair form ``(hi, lo)`` of an int8 strip, a block at a time."""
    weights = torch.tensor([2.0 ** (-ozaki.Q_BITS * (s + 1)) for s in range(st.slices.shape[0])],
                           dtype=torch.float64, device=st.slices.device)
    his, los = [], []
    for r0 in range(0, st.rows, b):
        x = torch.tensordot(weights, st.slices[:, r0:r0 + b, :b].to(torch.float64), 1) * st.sigma.double()
        h, lo = pairchol.pair_split(x)
        his.append(h)
        los.append(lo)
    return torch.cat(his), torch.cat(los)


def pair_products(sstrips, leaves, card):
    """The route's library products against what could replace them: one
    Ozaki trailing update at the grid's block side (``ozaki_gemm_nt`` of
    pair operands with their lo parts, and the route's update from operands
    sliced once) against ``torch.matmul`` in f64 of the same blocks; the int8
    strip solve against the pair-form ``solve_strips`` on the same factor
    (its strips rebuilt from the int8 ones; the same leaf stacks). Bounds:
    int8 at 1,979 TOP/s, f64 at 67 TFLOP/s, bytes at 3.35 TB/s."""
    b, device = leaves[0].rows, leaves[0].slices.device
    g = torch.Generator(device='cpu').manual_seed(0)
    a64, c64 = (torch.randn(b, b, generator=g, dtype=torch.float64).to(device) for _ in range(2))
    (ah, al), (ch, cl) = pairchol.pair_split(a64), pairchol.pair_split(c64)
    pa, pc_ = pairchol.pair_to_f64(ah, al), pairchol.pair_to_f64(ch, cl)
    ozaki_nt = lambda: ozaki.ozaki_gemm_nt(ah, ch, lo_a=al, lo_b=cl)  # noqa: E731
    f64_nt = lambda: pa @ pc_.mT  # noqa: E731
    err = rel_err(ozaki_nt(), f64_nt())
    oz_ms, mm_ms = time_pair(ozaki_nt, f64_nt)
    sa, sc = pairchol._split7(ah, al), pairchol._split7(ch, cl)
    th, tl = pairchol.pair_split(c64)
    update = lambda: pairchol._trailing_update_pair(th, tl, sa, sc)  # noqa: E731
    split = lambda: pairchol._split7(ah, al)  # noqa: E731
    for fn in (update, split):
        fn()
    torch.cuda.synchronize()
    upd_ms, split_ms = cuda_ms(update, 5), cuda_ms(split, 5)
    S = ozaki.DEFAULT_SLICES
    pairs = S * (S + 1) // 2
    int8_ms = max(pairs * 2.0 * b**3 / H100_INT8_OPS, 2 * S * b * b / H100_BYTES_PER_S) * 1e3
    dgemm_ms = max(2.0 * b**3 / H100_FLOPS, 3 * 8 * b * b / H100_BYTES_PER_S) * 1e3
    print('    library products at b=%d (%s):' % (b, card))
    print('      trailing update: ozaki_gemm_nt (7 slices, %d slice pairs, lo parts) %.3f ms (%.0f int8 TOP/s; bound '
          '%.3f ms by operations, %.1f%%) vs torch.matmul f64 on pair_to_f64 of the same blocks %.3f ms (%.1f '
          'TFLOP/s; bound %.3f ms, %.1f%%), %.2e of max |value| apart; the route\'s update from operands sliced '
          'once %.3f ms; one operand\'s 7-slice split %.3f ms' % (
              pairs, oz_ms, pairs * 2e-9 * b**3 / oz_ms, int8_ms, 100 * int8_ms / oz_ms, mm_ms, 2e-9 * b**3 / mm_ms,
              dgemm_ms, 100 * dgemm_ms / mm_ms, err, upd_ms, split_ms))
    del a64, c64, ah, al, ch, cl, pa, pc_, sa, sc, th, tl
    pstrips = [None if st is None else strip_to_pair(st, b) for st in sstrips]
    k = len(leaves)
    v = torch.as_tensor(np.random.default_rng(3).normal(size=k * b), device=device)
    x8 = pairchol.solve_strips_int8(sstrips, leaves, v)
    xp = pairchol.solve_strips(pstrips, leaves, v)
    agree = float(torch.linalg.vector_norm(x8 - xp) / torch.linalg.vector_norm(xp))
    s8_ms, sp_ms = time_pair(lambda: pairchol.solve_strips_int8(sstrips, leaves, v),
                             lambda: pairchol.solve_strips(pstrips, leaves, v))
    s_bytes = sum(st.slices.numel() for st in sstrips if st is not None)
    p_bytes = sum(h.numel() * 6 for h, _ in (p for p in pstrips if p is not None))
    l_bytes = sum(d.slices.numel() for d in leaves)
    print('      strip solve: solve_strips_int8 (7-slice int8 strips, %.2f GB) %.3f ms (reads floor %.3f ms, %.1f%%) vs '
          'the pair-form solve_strips (f32 + bf16 strips, %.2f GB, each block in f64) %.3f ms (reads floor %.3f ms, '
          '%.1f%%); the same leaf stacks (%.2f GB); %.2e apart (relative; bound %.0e)' % (
              s_bytes / 1e9, s8_ms, (2 * s_bytes + 2 * l_bytes) / H100_BYTES_PER_S * 1e3,
              100 * (2 * s_bytes + 2 * l_bytes) / H100_BYTES_PER_S * 1e3 / s8_ms, p_bytes / 1e9, sp_ms,
              (2 * p_bytes + 2 * l_bytes) / H100_BYTES_PER_S * 1e3,
              100 * (2 * p_bytes + 2 * l_bytes) / H100_BYTES_PER_S * 1e3 / sp_ms, l_bytes / 1e9, agree,
              PAIR_SOLVE_TOL))
    assert err <= 1e-9 and agree <= PAIR_SOLVE_TOL, (err, agree)
    del pstrips


def phase_pair_aspirin(device, grid, card):
    """12a: 10a's task through ``train()`` with solver=None, held off the
    in-place f64 route that ``solve`` takes there (phase 15) by
    ``pair_probe``, so that the JAX package's rule decides: it must take the
    pair route and not fall back, converge (the residual
    re-measured through the plain matvec), reach 10a's MAE bound within
    ``est_memory_pair``, and take a lower lam' and fewer refinement
    iterations than 10a's grid route in this run; the kept factor's error on
    a probe vector, an iteration's split and the library products."""
    n_atoms, _, _, _, _, m, sig, lam = GRID_ASPIRIN
    ds, task = grid['ds'], grid['task']
    pair_need = Analytic.est_memory_pair(m, n_atoms)
    trainer = GDMLTrain(device=device)
    model, during, peak, probe = pair_train(trainer, task)
    solver, t = probe['solver'], trainer.times
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    rel = true_resid(model, X, Jc, dperms, y, n_atoms) / float(np.linalg.norm(y))
    R, F_ref, _ = held_out(ds, task, GRID_HELD_OUT)
    _, F = GDMLPredict(model, device=device).predict(R)
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    RESULTS['12a'] = dict(F=F, times=dict(trainer.times))
    n_pad, _, t_fac = probe['chol'][-1]
    steps = factor_steps(probe)
    print('    aspirin N=%d M=%d sig=%g lam=%g (%d unknowns; est_memory_pair %.2f GB): solver=None, held off the '
          'in-place f64 route, took the pair route; '
          'lmax %.6e, rungs lam\'/info %s, lam\' %.6e (the grid route in 10a: %.6e, %.0fx); %d refinement '
          'iterations (10a: %d); relative residual re-measured by the plain matvec %.3e (bound %.0e); train() %.2f s '
          '= descriptors %.3f + lmax %.3f + assembly %.2f + factor %.2f + repack %.2f + refinement CG %.2f (%.1f '
          'iterations/s) + model %.3f + integration constant %.3f (10a: train() %.2f s, CG %.2f s); the factor that '
          'held %.3f s: its %d trailing updates %.3f s, %d panel refinements %.3f s, %d leaf Cholesky %.3f s (device '
          'time between events); its probe product L L^T v %.3f s (in train()\'s factor phase); peak allocated by '
          'train() %.2f GB (est_memory_pair %.2f GB); held-out force MAE %.5f on %d frames (10a: %.5f; bound %.4f); '
          'K1 %.2f launches an iteration %s (%s)' % (
              n_atoms, m, sig, lam, m * 3 * n_atoms, pair_need / 1e9, solver.lmax,
              [(float('%.6g' % lp), info) for lp, info in solver.rungs], solver.lam_p_used, grid['lam_p'],
              grid['lam_p'] / solver.lam_p_used, solver.pcg_iters, grid['iters'], rel, GRID_RESID, t['total'],
              t['descriptors'], t['lmax'], t['assembly'], t['factor'], t['repack'], t['cg'],
              solver.pcg_iters / t['cg'], t['model creation'], t['integration constant'], grid['times']['total'],
              grid['times']['cg'], t_fac, steps['update'][1], steps['update'][0], steps['panel'][1],
              steps['panel'][0], steps['leaf'][1], steps['leaf'][0], probe['llt_s'], peak / 1e9, pair_need / 1e9,
              mae, len(R), grid['mae'], CG_MAE_SHARE * scale, during['total'] / max(solver.pcg_iters, 1), during,
              card))
    assert rel <= GRID_RESID and mae < CG_MAE_SHARE * scale and peak <= pair_need, (rel, mae, peak, pair_need)
    assert solver.lam_p_used < grid['lam_p'] and solver.pcg_iters < grid['iters'], (
        solver.lam_p_used, grid['lam_p'], solver.pcg_iters, grid['iters'])
    err, err_shift = factor_error(probe['llt'], probe['v'], X, Jc, dperms, sig, solver.lam_p_used, n_atoms)
    print('    the kept pair factor on a probe vector: |L L^T v - (A + lam\' I) v| / |(A + lam\' I) v| %.3e, %.3e '
          'lam\' |v| (bound %.2f; the f32 grid factor in 10a: %.3f of its lam\' |v|) (%s)' % (
              err, err_shift, PAIR_FACTOR_SHIFT_TOL, grid['err_shift'], card))
    assert err_shift <= PAIR_FACTOR_SHIFT_TOL, err_shift
    sstrips, leaves = probe['strips'], probe['leaves']
    del probe, model
    split = pair_split('aspirin pair', sstrips, leaves, X, Jc, dperms, sig, lam, n_atoms, solver.pcg_iters, card)
    pair_products(sstrips, leaves, card)
    return during, split


def phase_pair_ecstr(device, ethanol, card):
    """12b: 10c's energy-constrained ethanol task at its budget, held off the
    in-place f64 route by ``pair_probe``: the pair route against the dense
    model (10c's bound)."""
    ds = ethanol[0]
    m, gb, lam, bound_rel = GRID_ECSTR
    n_atoms = ds['R'].shape[1]
    task = GDMLTrain(device=device).create_task(ds, m, ds, 100, sig=ETHANOL[5], lam=lam, use_sym=False,
                                               use_E_cstr=True, rng=np.random.RandomState(ETHANOL[3]))
    assert Analytic.est_memory_pair(m, n_atoms) <= gb * 1024**3 < Analytic.est_memory_requirement(m, n_atoms, True)
    trainer = GDMLTrain(max_memory=gb, device=device)
    model, during, _, probe = pair_train(trainer, task)
    dense = GDMLTrain(device=device).train(task)
    R = task['R_train'].reshape(m, -1)
    Ep, Fp = GDMLPredict(model, device=device).predict(R)
    Ed, Fd = GDMLPredict(dense, device=device).predict(R)
    f_rel = float(np.linalg.norm(Fp - Fd) / np.linalg.norm(Fd))
    solver = probe['solver']
    print('    ethanol M=%d lam=%g with energy constraints (%d unknowns) at %g GB: the pair route (%d rung(s), lam\' '
          '%.4e, %d refinement iterations, train() %.3f s, border %.3f s) against the dense model: training forces '
          '%.2e relative (bound %.0e), energies %.2e; K1 launches %s (%s)' % (
              m, lam, m * (3 * n_atoms + 1), gb, len(solver.rungs), solver.lam_p_used, solver.pcg_iters,
              trainer.times['total'], trainer.times['border'], f_rel, bound_rel,
              float(np.abs(Ep - Ed).max() / np.abs(Ed).max()), during, card))
    assert 'alphas_E' in model and f_rel < bound_rel, f_rel
    return during


def phase_pair(device, ethanol, grid, card):
    """12: the analytic solver's pair route on the card; K1 runs in lmax's
    power iteration, every refinement matvec and the integration constant."""
    t0 = time.perf_counter()
    counts, split = phase_pair_aspirin(device, grid, card)
    gc.collect()
    torch.cuda.empty_cache()
    during = phase_pair_ecstr(device, ethanol, card)
    counts = {k: counts[k] + during[k] for k in counts}
    assert counts['pass_a'] > 0 and counts['pass_b'] > 0, counts
    print('[12 pair] aspirin (63,000 unknowns) trained by the pair route with solver=None (held off the in-place route) '
          'below the grid route\'s lam\' '
          'and iterations; the pair route agrees with the dense model under energy constraints; launches %s; %.1f s' % (
              counts, time.perf_counter() - t0))
    return counts, split


def phase_stack_apply(device, card):
    """``--stack-apply``: the slice-stack apply's int8 products in the
    layouts ``ozaki.matvec_sliced_long`` and ``_t`` could take, at the AT-AT
    stack that 11a's plan gives the card's free memory (random slices), each
    over one pass of the stack, with its GB/s against the bytes bound; then
    ``_gram_apply`` on that stack, which reads it twice."""
    ns, k = it_mod.Iterative(max_memory=memory_budget(device) / 1024**3, device=device).resolve_factor_slices(3000, 60)
    rows, ch, n_ch = -(-k * 180 // 16) * 16, -(-45 * 180 // 16) * 16, -(-3000 // 45)
    g = torch.Generator(device=device).manual_seed(0)
    stack = torch.randint(-96, 97, (ns, rows, n_ch * ch), dtype=torch.int8, device=device, generator=g)
    sv = torch.randint(-96, 97, (16, n_ch * ch), dtype=torch.int8, device=device, generator=g)
    w = torch.zeros((24, rows), dtype=torch.int8, device=device)
    w[:8] = torch.randint(-96, 97, (8, rows), dtype=torch.int8, device=device, generator=g)
    wc = w[:8].contiguous().T  # a column-major (rows, 8)
    flat = stack.view(ns * rows, -1)
    one_pass = stack.numel() / H100_BYTES_PER_S * 1e3
    print('    stack-apply layouts: %d slices x %d rows x %d columns (k=%d), %.2f GB, one pass at least %.3f ms (%s)' % (
        ns, rows, stack.shape[2], k, stack.numel() / 1e9, one_pass, card))
    variants = (
        ('F v, per chunk: (S rows, chunk) x column-major (chunk, 8)',
         lambda: [torch._int_mm(flat[:, c * ch:(c + 1) * ch], sv[:8, c * ch:(c + 1) * ch].T) for c in range(n_ch)]),
        ('F v, per chunk: (S rows, chunk) x column-major (chunk, 16), 8 zero columns [the route]',
         lambda: [torch._int_mm(flat[:, c * ch:(c + 1) * ch], sv[:, c * ch:(c + 1) * ch].T) for c in range(n_ch)]),
        ('F^T w, per slice and chunk: (24, rows) x (rows, chunk) [the JAX layout]',
         lambda: [torch._int_mm(w, stack[i, :, c * ch:(c + 1) * ch]) for i in range(ns) for c in range(n_ch)]),
        ('F^T w, per slice: (24, rows) x (rows, width)', lambda: [torch._int_mm(w, stack[i]) for i in range(ns)]),
        ('F^T w, per slice: column-major (width, rows) x column-major (rows, 8) [the route]',
         lambda: [torch._int_mm(stack[i].T, wc) for i in range(ns)]),
    )
    for label, fn in variants:
        fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 3)
        print('      %-88s %9.3f ms, %5.0f GB/s, %4.1f%% of the bytes bound' % (
            label, ms, stack.numel() / ms * 1e-6, 100 * one_pass / ms))
    del sv, w, wc
    F = it_mod.SliceFactor(stack, torch.ones(n_ch, device=device), ch, rows)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=n_ch * ch), device=device)
    it_mod._gram_apply(F, v)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: it_mod._gram_apply(F, v), 3)
    print('      %-88s %9.3f ms, %5.0f GB/s, %4.1f%% of the bytes bound (%s)' % (
        'the apply F^T (F v) (it_mod._gram_apply; reads the stack twice)', ms, 2 * stack.numel() / ms * 1e-6,
        200 * one_pass / ms, card))


def phase_strip_apply(device, card):
    """``--strip-apply``: the int8 products of the pair route's strip solve
    in the layouts they could take, at phase 12's aspirin grid (k=20 blocks
    of 3,150: random 7-slice strips of 13.21 GB, 8-slice leaf stacks), each
    over a whole sweep, with GB/s against one read of what it reads. The
    transposed strip product of strip j contracts its rows against the
    per-block vector slices as disjoint column groups (``W``, rows x 8C);
    the leaf's transposed product contracts the stack's rows against the
    vector's 8 slices."""
    k, b, S = 20, 3150, pairchol.STRIP_SLICES
    bp = -(-b // 16) * 16
    g = torch.Generator(device=device).manual_seed(0)

    def draw(*shape):
        return torch.randint(-96, 97, shape, dtype=torch.int8, device=device, generator=g)

    strips, groups = [], []
    for j in range(k - 1):
        C = k - 1 - j
        rows_p = -(-C * b // 16) * 16
        strips.append(draw(S, rows_p, bp))
        Wt = torch.zeros((max(24, -(-8 * C // 16) * 16), rows_p), dtype=torch.int8, device=device)
        for c in range(C):
            Wt[8 * c:8 * c + 8, c * b:(c + 1) * b] = draw(8, b)
        groups.append((Wt, Wt.T.contiguous()))
    leaves = draw(k, 8, bp, bp)
    vt = torch.zeros((16, bp), dtype=torch.int8, device=device)
    vt[:8, :b] = draw(8, b)
    a24 = torch.zeros((24, bp), dtype=torch.int8, device=device)
    a24[:8] = vt[:8]
    s_bytes, l_bytes = sum(st.numel() for st in strips), leaves.numel()
    print('    strip-apply layouts at k=%d, b=%d: strips %.2f GB (one read at least %.3f ms), leaf stacks %.2f GB (%.3f '
          'ms) (%s)' % (k, b, s_bytes / 1e9, s_bytes / H100_BYTES_PER_S * 1e3, l_bytes / 1e9,
                       l_bytes / H100_BYTES_PER_S * 1e3, card))
    mm = torch._int_mm
    variants = (
        ('forward: every slice\'s rows (S rows, b) x column-major (b, 16) [the route]', s_bytes,
         lambda: [mm(st.view(-1, bp), vt.T) for st in strips]),
        ('transposed: a slice column-major (b, rows) x W row-major (rows, 8C)', s_bytes,
         lambda: [mm(st[i].T, W) for st, (_, W) in zip(strips, groups) for i in range(S)]),
        ('transposed: a slice column-major (b, rows) x W column-major (rows, 8C) [the route]', s_bytes,
         lambda: [mm(st[i].T, Wt.T) for st, (Wt, _) in zip(strips, groups) for i in range(S)]),
        ('transposed, out^T: W^T row-major (8C, rows) x a slice row-major (rows, b)', s_bytes,
         lambda: [mm(Wt, st[i]) for st, (Wt, _) in zip(strips, groups) for i in range(S)]),
        ('leaf forward: every slice\'s rows (8 b, b) x column-major (b, 16) [the route]', l_bytes,
         lambda: [mm(d.view(-1, bp), vt.T) for d in leaves]),
        ('leaf transposed: (24, b) x a slice row-major (b, b) [the route]', l_bytes,
         lambda: [mm(a24, d[i]) for d in leaves for i in range(8)]),
        ('leaf transposed: a slice column-major (b, b) x column-major (b, 16)', l_bytes,
         lambda: [mm(d[i].T, vt.T) for d in leaves for i in range(8)]),
    )
    for label, n_bytes, fn in variants:
        fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 3)
        print('      %-86s %9.3f ms, %5.0f GB/s, %4.1f%% of the bytes bound' % (
            label, ms, n_bytes / ms * 1e-6, 100 * n_bytes / H100_BYTES_PER_S * 1e3 / ms))


def phase_atat_factors(device, card):
    """``--atat-factors``: phase 8d's AT-AT task solved by CG for
    ``ATAT_FACTOR_SECONDS`` each with the 6-slice stack (automatic slices),
    the 8-slice stack and the f64 factor, the stacks' matvec started on the
    ``'ozaki'`` rung (the default) and on ``'native'`` (K1), at one budget
    (``ATAT_FACTOR_GB``); the CG log, one line a chunk."""
    n_atoms, n_frames, seed, split, n_valid, m, sig, lam = CG_ATAT
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_frames, seed=seed)
    gb = ATAT_FACTOR_GB * 1e9 / 1024**3
    trainer = GDMLTrain(max_memory=gb, device=device)
    task = trainer.create_task(ds, m, ds, n_valid, sig=sig, lam=lam, use_sym=False, rng=np.random.RandomState(split))
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    logger = logging.getLogger(it_mod.__name__)
    handler = logging.StreamHandler(sys.stdout)
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    for mode, slices, rung in (('ozaki', 'auto', 'ozaki'), ('ozaki', 'auto', 'native'), ('ozaki', 8, 'ozaki'),
                               ('ozaki', 8, 'native'), ('f64', 'auto', 'native')):
        solver = it_mod.Iterative(trainer, max_memory=gb, factor_mode=mode, factor_slices=slices, device=device)
        t0 = time.perf_counter()
        _, _, iters, resid, _, idxs, _ = solver.solve(dict(task, solver_mv_mm=rung), X, Jc, dperms, y, 1.0,
                                                      max_seconds=ATAT_FACTOR_SECONDS)
        print('    AT-AT factor %s, %s slices (%d), first matvec rung %r: k=%d, %d iterations in %.0f s of CG, '
              'residual %.4e -> %.4e; %.1f s (%s)' % (
                  mode, slices, solver._ns(), rung, len(idxs) // (3 * n_atoms), iters, ATAT_FACTOR_SECONDS,
                  np.linalg.norm(y), resid, time.perf_counter() - t0, card), flush=True)
        del solver
        gc.collect()
    logger.removeHandler(handler)


def cholesky_flops(n, nb):
    """Flops of ``ops/linalg.blocked_cholesky`` on one strip of all ``n``
    rows at block ``nb``: each block column's leaf (``b^3 / 3``), its panel
    solve (``rows b^2``) and its trailing updates, a row block at a time up to
    the block's last row (``2 rows b cols``)."""
    total = 0.0
    for k0 in range(0, n, nb):
        k1 = min(n, k0 + nb)
        b = k1 - k0
        total += b**3 / 3 + (n - k1) * b * b
        for i0 in range(k1, n, nb):
            i1 = min(n, i0 + nb)
            total += 2.0 * (i1 - i0) * b * (i1 - k1)
    return total


def mesh_times(t, keys):
    return ' + '.join('%s %.3f' % (k, t[k]) for k in keys if k in t)


def phase_mesh_ethanol(device, mesh, ethanol, card):
    """13a: phase 7c's ethanol M=1000 task on the one-rank mesh against the
    single-device dense model, with both routes' phases side by side."""
    ds, task, dense_model = ethanol
    n_atoms, m = ds['R'].shape[1], task['R_train'].shape[0]
    dense = GDMLTrain(device=device)
    dense.train(task, solver='analytic')  # the dense route's seconds, warm
    trainer = GDMLTrain(mesh=mesh, device=device)
    trainer.train(task, solver='analytic')  # the mesh route's first call pays its set-up
    R, _, _ = held_out(ds, task, 1000)
    fused_predict.reset_launches()
    model = trainer.train(task, solver='analytic')
    _, Fm = GDMLPredict(model, mesh=mesh, device=device).predict(R)
    during = launch_counts()
    _, Fd = GDMLPredict(dense_model, device=device).predict(R)
    rel = float(np.abs(Fm - Fd).max() / np.abs(Fd).max())
    print('    ethanol M=%d (%d unknowns) on the one-rank mesh: train() %.3f s = %s; the dense route (one device): '
          'train() %.3f s = %s; held-out forces of the mesh model against phase 7c\'s dense model: max |dF| / max |F| '
          '%.3e (bound %.0e) on %d frames; K1 launches %s (%s)' % (
              m, m * 3 * n_atoms, trainer.times['total'],
              mesh_times(trainer.times, ('descriptors', 'assembly', 'factor', 'solve', 'model creation',
                                         'integration constant')),
              dense.times['total'], mesh_times(dense.times, ('descriptors', 'assembly', 'cholesky', 'model creation',
                                                             'integration constant')),
              rel, MESH_ETHANOL_TOL, len(R), during, card))
    assert rel <= MESH_ETHANOL_TOL, rel
    return during


def phase_mesh_aspirin(device, mesh, grid, card):
    """13b: 10a's aspirin task (63,000 unknowns, lam 1e-10) on the one-rank
    mesh by the sharded f64 Cholesky: its one strip stores the matrix once."""
    n_atoms, _, _, _, _, m, sig, lam = GRID_ASPIRIN
    ds, task = grid['ds'], grid['task']
    n = m * 3 * n_atoms
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_predict.reset_launches()
    trainer = GDMLTrain(mesh=mesh, device=device)
    model = trainer.train(task, solver='analytic')
    peak = torch.cuda.max_memory_allocated() - base
    R, F_ref, _ = held_out(ds, task, GRID_HELD_OUT)
    _, F = GDMLPredict(model, mesh=mesh, device=device).predict(R)
    during = launch_counts()
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    rel = k1_resid(model, X, Jc, dperms, y, n_atoms)
    F_pair = RESULTS['12a']['F']
    d_pair = float(np.abs(F - F_pair).max() / np.abs(F_pair).max())
    t = trainer.times
    flops = cholesky_flops(n, spmd.NB)
    print('    aspirin N=%d M=%d sig=%g lam=%g (%d unknowns) on the one-rank mesh (sharded f64 Cholesky, nb %d): '
          'train() %.2f s = %s; the factor %.1f TFLOP/s on n^3/3, %.1f on the %.3e flops it does; peak allocated by '
          'train() %.2f GB (the strip 8 n^2 = %.2f GB; bound %.0f GB); relative residual re-measured by the K1 matvec '
          '%.3e (bound %.0e); held-out force MAE %.6f on %d frames (10a: %.6f, bound %.0f%%); max |dF| / max |F| '
          'from 12a\'s pair-route model %.3e (bound %.0e); the grid route (10a) train() %.2f s, the pair route '
          '(12a) %.2f s; K1 launches %s (%s)' % (
              n_atoms, m, sig, lam, n, spmd.NB, t['total'],
              mesh_times(t, ('descriptors', 'assembly', 'factor', 'solve', 'model creation', 'integration constant')),
              n**3 / 3 / t['factor'] * 1e-12, flops / t['factor'] * 1e-12, flops,
              peak / 1e9, 8.0 * n * n / 1e9, MESH_PEAK_BYTES / 1e9, rel, MESH_RESID, mae, len(R), grid['mae'],
              100 * MESH_MAE_SHARE, d_pair, MESH_PAIR_TOL, grid['times']['total'], RESULTS['12a']['times']['total'],
              during, card))
    assert peak < MESH_PEAK_BYTES and rel <= MESH_RESID and d_pair <= MESH_PAIR_TOL, (peak, rel, d_pair)
    assert abs(mae - grid['mae']) <= MESH_MAE_SHARE * grid['mae'] and mae < CG_MAE_SHARE * scale, (mae, grid['mae'])
    RESULTS['13b'] = dict(F=F, times=dict(t), flops=flops)
    return during


def phase_mesh_cg(device, mesh, card):
    """13c: 8c's aspirin task (lam 1e-8) by CG on the one-rank mesh, the f64
    factor column-sharded, at 8c's budget: 8c's k, its iterations within
    ``CG_ANCHOR_TOL``, and its model within 10b's bound of 8c's."""
    r = RESULTS['8c']
    task, ds, cg_model = r['task'], r['ds'], r['model']
    n_atoms = ds['R'].shape[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_predict.reset_launches()
    trainer = GDMLTrain(max_memory=r['budget'] / 1024**3, mesh=mesh, device=device)
    model = trainer.train(task, solver='cg', solver_max_seconds=CG_ASPIRIN_SECONDS)
    during = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    k = len(model['inducing_pts_idxs']) // (3 * n_atoms)
    iters, iters_8c = model['solver_iters'], cg_model['solver_iters']
    conv = model['solver_resid'] <= model['solver_tol'] * model['norm_y_train']
    R, F_ref, _ = held_out(ds, task, 500)
    _, F = GDMLPredict(model, device=device).predict(R)
    _, Fc = GDMLPredict(cg_model, device=device).predict(R)
    f_rel = float(np.abs(F - Fc).mean() / np.abs(Fc).mean())
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    t, tc = trainer.times, r['times']
    print('    aspirin M=%d sig=%g lam=%g by CG on the one-rank mesh: k=%d (8c: %d), %d iterations (8c: %d; bound %d%% '
          'or %d), converged %s; train() %.2f s = %s (8c: train() %.2f s = %s); peak allocated %.2f GB (8c: %.2f); '
          'held-out force MAE %.5f (bound %.4f); mean |dF| / mean |F| from 8c\'s model %.2e (bound %.0e) on %d '
          'frames; K1 launches %s (%s)' % (
              len(task['idxs_train']), float(task['sig']), float(task['lam']), k, r['k'], iters, iters_8c,
              100 * CG_ANCHOR_TOL[0], CG_ANCHOR_TOL[1], conv, t['total'],
              mesh_times(t, ('descriptors', 'leverage scores', 'factor', 'cg', 'integration constant')), tc['total'],
              mesh_times(tc, ('descriptors', 'leverage scores', 'factor', 'cg', 'integration constant')), peak / 1e9,
              r['peak'] / 1e9, mae, CG_MAE_SHARE * scale, f_rel, CG_DENSE_BOUNDS[0], len(R), during, card))
    assert k == r['k'] and conv, (k, r['k'], conv)
    assert abs(iters - iters_8c) <= max(CG_ANCHOR_TOL[0] * iters_8c, CG_ANCHOR_TOL[1]), (iters, iters_8c)
    assert f_rel < CG_DENSE_BOUNDS[0] and mae < CG_MAE_SHARE * scale, (f_rel, mae)
    return during


def phase_mesh_serving(device, mesh, atat, card):
    """13d: ``GDMLPredict(mesh=)`` at phase 5's AT-AT width against the
    single device, and both timed host to host (the median of three)."""
    R_q = RESULTS['5']
    single, sharded = GDMLPredict(atat, device=device), GDMLPredict(atat, mesh=mesh, device=device)
    counts = dict.fromkeys(launch_counts(), 0)

    def wall(pred, R):
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict(R)
            secs.append(time.perf_counter() - t0)
        return 1e3 * sorted(secs)[1]

    for B in MESH_SERVE_B:
        fused_predict.reset_launches()
        Em, Fm = sharded.predict(R_q[:B])
        during = launch_counts()
        counts = {k: counts[k] + during[k] for k in counts}
        Es, Fs = single.predict(R_q[:B])
        err = max(rel_err(torch.as_tensor(Em), torch.as_tensor(Es)), rel_err(torch.as_tensor(Fm), torch.as_tensor(Fs)))
        ms_mesh, ms_single = wall(sharded, R_q[:B]), wall(single, R_q[:B])
        print('    AT-AT N=%d T=%d B=%5d: the one-rank mesh against one device: %.2e of max |value| (bound %.0e); '
              'predict() %.3f ms on the mesh, %.3f ms on one device (host to host, the median of 3); K1 launches %s '
              '(%s)' % (len(atat['z']), atat['R_desc'].shape[1], B, err, MESH_SERVE_TOL, ms_mesh, ms_single, during,
                        card))
        assert err <= MESH_SERVE_TOL and during['total'] > 0, (B, err, during)
    return counts


def phase_mesh_entry_points(device, mesh, ethanol, card):
    """13e: ``dryrun_multichip(1)``, then the quick start ``all <ethanol>
    200 1000 5000 --devices 1`` against 9a's run."""
    fused_predict.reset_launches()
    t0 = time.perf_counter()
    df = dryrun_multichip(1, device=device)
    t_dry = time.perf_counter() - t0
    ref = RESULTS['9a']
    with tempfile.TemporaryDirectory(prefix='chip_smoke_mesh_') as tmp:
        ds_path = os.path.join(tmp, 'ethanol.npz')
        io.save_dict(ds_path, ethanol[0])
        with in_dir(os.path.join(tmp, 'all')):
            t0 = time.perf_counter()
            np.random.seed(1)
            cli.main(['--device', device, 'all', ds_path, *QUICKSTART, '--devices', '1'])
            wall = time.perf_counter() - t0
            name, model = final_model()
            task_dir = [d for d in os.listdir('.') if os.path.isdir(d)][0]
            trained = sorted(f for f in os.listdir(task_dir) if f.startswith('model-'))
    during = launch_counts()
    err, e_err = recorded(model, 'f_err'), recorded(model, 'e_err')
    rel = max(abs(err['mae'] - ref['f_mae']) / ref['f_mae'], abs(e_err['mae'] - ref['e_mae']) / ref['e_mae'])
    print('    dryrun_multichip(1): sharded against single-device forces %.2e (bound %.0e), %.2f s; `all ethanol.npz %s '
          '--devices 1`: %.3f s (9a: %.3f s), %d sigmas trained (9a: %d), selected sig=%g (9a: %g), test force MAE '
          '%.8f, energy MAE %.8f, %.1e relative from 9a\'s (bound %.0e); K1 launches %s (%s)' % (
              df, 1e-6, t_dry, ' '.join(QUICKSTART), wall, ref['wall'], len(trained), len(ref['trained']),
              float(np.squeeze(model['sig'])), ref['sig'], err['mae'], e_err['mae'], rel, MESH_CLI_TOL, during,
              card))
    assert trained == ref['trained'] and float(np.squeeze(model['sig'])) == ref['sig'] and rel <= MESH_CLI_TOL
    return during


def phase_mesh(device, ethanol, grid, atat, card):
    """13: the mesh on the card: a one-rank NCCL world made here (no
    launcher) and destroyed at the end; K1 runs in every rank's serving, the
    CG matvec and the integration constant."""
    t0 = time.perf_counter()
    assert not torch.distributed.is_initialized()
    mesh_mod.init_distributed(world_size=1, rank=0, device=device)
    counts = dict.fromkeys(launch_counts(), 0)
    try:
        mesh = mesh_mod.default_mesh(1, device=device)
        torch.distributed.barrier()  # the backend makes its communicator at the first collective
        t_init = time.perf_counter() - t0
        assert str(torch.distributed.get_backend()) == ('nccl' if device == 'cuda' else 'gloo')
        runs = (lambda: phase_mesh_ethanol(device, mesh, ethanol, card),
                lambda: phase_mesh_aspirin(device, mesh, grid, card),
                lambda: phase_mesh_cg(device, mesh, card),
                lambda: phase_mesh_serving(device, mesh, atat, card),
                lambda: phase_mesh_entry_points(device, mesh, ethanol, card))
        for run in runs:
            gc.collect()
            torch.cuda.empty_cache()
            during = run()
            counts = {k: counts[k] + during[k] for k in counts}
    finally:
        torch.distributed.destroy_process_group()
    assert counts['pass_a'] > 0 and counts['pass_b'] > 0, counts
    print('[13 mesh] one-rank %s world (%.2f s to make, its first collective included): ethanol on the mesh = the dense model; aspirin (%d unknowns) '
          'by the sharded f64 Cholesky within 1%% of 10a\'s MAE; CG on the mesh = 8c; mesh serving = one device; '
          'dryrun_multichip(1) and the quick start with --devices 1 = 9a; launches %s; %.1f s (%s)' % (
              'NCCL' if device == 'cuda' else 'gloo', t_init, GRID_ASPIRIN[5] * 3 * GRID_ASPIRIN[0], counts,
              time.perf_counter() - t0, card))
    return counts


@contextlib.contextmanager
def mesh_pair_probe(split=True):
    """``train()`` builds its analytic solver with ``mesh_precision='pair'``
    (``train.Analytic``); yields ``(probe, records)``: the solvers made, the
    mesh layer's log records and, with ``split``, CUDA events around the
    pair factor's steps (``meshchol._diag_factor``, ``_panel``,
    ``_panel_operands``, ``_trailing_update``) and, where CG starts on a
    factor that held, the device ms of its parts each alone on the CG's
    right-hand side: the strip matvec and the two pair triangular solves."""
    from sgdml_tpu_torch.ops import meshchol

    probe = {'solvers': [], 'steps': {}, 'cg': None, 'factor': None}
    records = Records()

    class PairAnalytic(an_mod.Analytic):
        def __init__(self, *args, **kw):
            super().__init__(*args, mesh_precision='pair', **kw)
            probe['solvers'].append(self)

    def timed(name, fn):
        def wrapper(*args, **kw):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            probe['steps'].setdefault(name, []).append(ev)
            return out
        return wrapper

    def keep(Ahi, Alo, nb, mesh=None):
        out = saved['blocked_cholesky_pair'](Ahi, Alo, nb, mesh)
        probe['factor'] = (out[0], out[1], nb, mesh) if out[2] == 0 else None
        return out

    def pair_cg(A_apply, M_apply, b, info, max_iters):
        if probe['factor'] is not None:
            Lh, Ll, nb, mesh = probe['factor']
            probe['factor'] = None
            probe['cg'] = dict(
                matvec_ms=cuda_ms(lambda: A_apply(b), 3),
                forward_ms=cuda_ms(lambda: meshchol.tri_solve_pair(Lh, Ll, b, nb, mesh=mesh), 2),
                transposed_ms=cuda_ms(lambda: meshchol.tri_solve_pair(Lh, Ll, b, nb, trans=True, mesh=mesh), 2))
            del Lh, Ll
        return saved['_pair_cg'](A_apply, M_apply, b, info, max_iters)

    names = ('_diag_factor', '_panel', '_panel_operands', '_trailing_update')
    saved = {name: getattr(meshchol, name) for name in names + ('blocked_cholesky_pair',)}
    saved['_pair_cg'], saved['Analytic'] = spmd._pair_cg, train_mod.Analytic
    logger = logging.getLogger(spmd.__name__)
    level = logger.level
    logger.addHandler(records)
    logger.setLevel(logging.INFO)
    train_mod.Analytic = PairAnalytic
    if split:
        for name in names:
            setattr(meshchol, name, timed(name, saved[name]))
        meshchol.blocked_cholesky_pair, spmd._pair_cg = keep, pair_cg
    try:
        yield probe, records
    finally:
        train_mod.Analytic, spmd._pair_cg = saved.pop('Analytic'), saved.pop('_pair_cg')
        for name, fn in saved.items():
            setattr(meshchol, name, fn)
        logger.removeHandler(records)
        logger.setLevel(level)


def step_seconds(probe):
    """{step: (seconds, calls)} of ``mesh_pair_probe``'s events."""
    return {name: (sum(a.elapsed_time(b) for a, b in evs) / 1e3, len(evs)) for name, evs in probe['steps'].items()}


def pair_route_log(records):
    """The mesh pair solve's log: the message of the rung taken, and
    whether it fell back to f64."""
    taken = [m for m in records.messages if m.startswith('Mesh pair solve: lam')]
    fallback = any('falling back to f64' in m for m in records.messages)
    return taken, fallback


def phase_mesh_pair(device, mesh, grid, card):
    """14a: 10a's aspirin task (63,000 unknowns, lam 1e-10) by
    ``Analytic(mesh=, mesh_precision='pair')`` on the one-rank mesh: the pair
    Cholesky of a lam'-shifted pair copy as the preconditioner of CG on the
    kept f64 strip (14 n^2 bytes at one rank)."""
    n_atoms, _, _, _, _, m, sig, lam = GRID_ASPIRIN
    ds, task = grid['ds'], grid['task']
    n = m * 3 * n_atoms
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with mesh_pair_probe() as (probe, records):
        fused_predict.reset_launches()
        trainer = GDMLTrain(mesh=mesh, device=device)
        model = trainer.train(task, solver='analytic')
        peak = torch.cuda.max_memory_allocated() - base
        R, F_ref, _ = held_out(ds, task, GRID_HELD_OUT)
        _, F = GDMLPredict(model, mesh=mesh, device=device).predict(R)
        during = launch_counts()
    solver, t, cg, steps = probe['solvers'][-1], trainer.times, probe['cg'], step_seconds(probe)
    taken, fallback = pair_route_log(records)
    shift = solver.lam_p_used / solver.lmax
    rel_cg = [r[3] for r in solver.rungs if r[0] == solver.lam_p_used][0]
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    rel = true_resid(model, X, Jc, dperms, y, n_atoms) / float(np.linalg.norm(y))
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    d_f64 = float(np.abs(F - RESULTS['13b']['F']).max() / np.abs(RESULTS['13b']['F']).max())
    d_pair = float(np.abs(F - RESULTS['12a']['F']).max() / np.abs(RESULTS['12a']['F']).max())
    it_ms = 1e3 * t['solve'] / max(solver.pcg_iters, 1)
    solves_ms = cg['forward_ms'] + cg['transposed_ms']
    strip_bytes, pair_half = 8.0 * n * n, 3.0 * n * n
    nb = spmd._largest_divisor(n, spmd.NB)
    print('    aspirin N=%d M=%d sig=%g lam=%g (%d unknowns) on the one-rank mesh by the pair route (nb %d): lmax %.6e, '
          'rungs (lam\', info, CG iterations, CG relative residual) %s, lam\' %.6e = %g lmax, %d CG iterations '
          '(cap %d), CG relative residual %.3e (gate %.0e), fell back to f64: %s; relative residual re-measured by '
          'the plain matvec %.3e (bound %.0e); train() %.2f s = %s; the factor(s) by step (device time between CUDA '
          'events): %d leaf Cholesky %.3f s, %d panel solves %.3f s, %d panel slicings %.3f s, %d trailing updates '
          '%.3f s; CG %.2f s, %.3f ms an iteration: the strip matvec %.3f ms (reads the %.2f GB strip once, %.0f GB/s; '
          'its bytes floor %.2f ms) and the two pair triangular solves %.3f + %.3f ms (read the pair factor\'s lower '
          'half twice, %.2f GB, %.0f GB/s; floor %.2f ms); peak allocated by train() %.2f GB (14 n^2 = %.2f GB, bound '
          '%.2f GB with the transient); held-out force MAE %.6f on %d frames (10a: %.6f, bound %.0f%%); max |dF| / '
          'max |F| from 13b\'s f64 sharded model %.3e (bound %.0e), from 12a\'s pair-route model %.3e (bound %.0e); '
          'train() beside this call\'s other routes of the lam 1e-10 region: the mesh f64 Cholesky (13b) %.2f s, '
          'the grid route (10a) %.2f s, the single-device pair route (12a) %.2f s; K1 launches %s (%s)' % (
              n_atoms, m, sig, lam, n, nb, solver.lmax,
              [(float('%.6g' % r[0]), r[1], r[2], float('%.3g' % r[3])) for r in solver.rungs], solver.lam_p_used,
              shift, solver.pcg_iters, spmd.PAIR_CG_ITERS, rel_cg, spmd.PAIR_CG_GATE, fallback, rel, MESH_RESID,
              t['total'], mesh_times(t, ('descriptors', 'assembly', 'factor', 'solve', 'model creation',
                                         'integration constant')),
              steps['_diag_factor'][1], steps['_diag_factor'][0], steps['_panel'][1], steps['_panel'][0],
              steps['_panel_operands'][1], steps['_panel_operands'][0], steps['_trailing_update'][1],
              steps['_trailing_update'][0], t['solve'], it_ms, cg['matvec_ms'], strip_bytes / 1e9,
              strip_bytes / cg['matvec_ms'] * 1e-6, strip_bytes / H100_BYTES_PER_S * 1e3, cg['forward_ms'],
              cg['transposed_ms'], 2 * pair_half / 1e9, 2 * pair_half / solves_ms * 1e-6,
              2 * pair_half / H100_BYTES_PER_S * 1e3, peak / 1e9, 14.0 * n * n / 1e9,
              (14.0 * n * n + MESH_PAIR_TRANSIENT_BYTES) / 1e9, mae, len(R), grid['mae'], 100 * MESH_MAE_SHARE, d_f64,
              MESH_PAIR_F64_TOL, d_pair, MESH_PAIR_12A_TOL, RESULTS['13b']['times']['total'],
              grid['times']['total'], RESULTS['12a']['times']['total'], during, card))
    assert taken and not fallback and any(abs(shift - s) <= 1e-9 * s for s in spmd.PAIR_LAM_P_SHIFTS), (taken, shift)
    assert 0 < solver.pcg_iters <= spmd.PAIR_CG_ITERS and rel_cg <= spmd.PAIR_CG_GATE, (solver.pcg_iters, rel_cg)
    assert rel <= MESH_RESID and peak < 14.0 * n * n + MESH_PAIR_TRANSIENT_BYTES, (rel, peak)
    assert abs(mae - grid['mae']) <= MESH_MAE_SHARE * grid['mae'] and mae < CG_MAE_SHARE * scale, (mae, grid['mae'])
    assert d_f64 <= MESH_PAIR_F64_TOL and d_pair <= MESH_PAIR_12A_TOL, (d_f64, d_pair)
    return during


def phase_mesh_cyclic(device, mesh, grid, card):
    """14b: 13b's task through ``solve_interleaved(layout='cyclic')`` (the
    block-cyclic f64 Cholesky of ``ops/cyclic.py``; at one rank the layout is
    the identity and the strip is factored in place), against 13b's model."""
    n_atoms, _, _, _, _, m, sig, lam = GRID_ASPIRIN
    ds, task = grid['ds'], grid['task']
    n = m * 3 * n_atoms
    saved = spmd.solve_interleaved
    spmd.solve_interleaved = functools.partial(saved, layout='cyclic')
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        fused_predict.reset_launches()
        trainer = GDMLTrain(mesh=mesh, device=device)
        model = trainer.train(task, solver='analytic')
        peak = torch.cuda.max_memory_allocated() - base
        R, _, _ = held_out(ds, task, GRID_HELD_OUT)
        _, F = GDMLPredict(model, mesh=mesh, device=device).predict(R)
        during = launch_counts()
    finally:
        spmd.solve_interleaved = saved
    ref = RESULTS['13b']
    d = float(np.abs(F - ref['F']).max() / np.abs(ref['F']).max())
    t, t13 = trainer.times, ref['times']
    nb = spmd._largest_divisor(n, spmd.NB)
    print('    aspirin N=%d M=%d (%d unknowns) on the one-rank mesh by the cyclic layout (nb %d, %d block rows): train() '
          '%.2f s = %s, the factor %.3f s, %.1f TFLOP/s on n^3/3 (13b\'s masked layout: the factor %.3f s, %.1f '
          'TFLOP/s; train() %.2f s); peak allocated by train() %.2f GB (the strip 8 n^2 = %.2f GB); max |dF| / max |F| '
          'from 13b\'s model %.3e (bound %.0e) on %d frames; K1 launches %s (%s)' % (
              n_atoms, m, n, nb, -(-n // nb), t['total'],
              mesh_times(t, ('descriptors', 'assembly', 'factor', 'solve', 'model creation', 'integration constant')),
              t['factor'], n**3 / 3 / t['factor'] * 1e-12, t13['factor'], n**3 / 3 / t13['factor'] * 1e-12,
              t13['total'], peak / 1e9, 8.0 * n * n / 1e9, d, MESH_CYCLIC_TOL, len(R), during, card))
    assert d <= MESH_CYCLIC_TOL and peak < MESH_PEAK_BYTES, (d, peak)
    return during


def phase_mesh_stack(device, mesh, card):
    """14c: 11c's run (8c's aspirin task, sig 15, lam 1e-8, by the int8 slice
    stack at 11c's budget) by ``GDMLTrain(mesh=)``: the column-sharded
    streamed build and its apply at one rank."""
    r, r8 = RESULTS['11c'], RESULTS['8c']
    ds, task, c8 = r8['ds'], r8['task'], r8['model']
    n_atoms = ds['R'].shape[1]
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    with ozaki_factor() as (made, records):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_predict.reset_launches()
        trainer = GDMLTrain(max_memory=r['budget'] / 1024**3, mesh=mesh, device=device)
        model = trainer.train(task, solver='cg', solver_max_seconds=CG_ASPIRIN_SECONDS)
        during, per_it = cg_launches(model['solver_iters'])
        peak = torch.cuda.max_memory_allocated()
    solver = made[-1]
    build = [rec.args for rec in records.records if rec.msg.startswith('Sharded streamed slice-stack factor')][-1]
    sweeps = dict(zip(('W', 'Gram', 'F', 'renorm'), build[-4:]))
    k, ns, stack_gb = len(model['inducing_pts_idxs']) // (3 * n_atoms), solver._ns(), build[4]
    iters = int(model['solver_iters'])
    tol_b = model['solver_tol'] * model['norm_y_train']
    resid = true_resid(model, X, Jc, dperms, y, n_atoms)
    drift = abs(resid - model['solver_resid']) / resid
    R, F_ref, _ = held_out(ds, task, 500)
    _, F = GDMLPredict(model, device=device).predict(R)
    _, F8 = GDMLPredict(c8, device=device).predict(R)
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    f_rel = float(np.abs(F - F8).mean() / np.abs(F8).mean())
    t = trainer.times
    print('    aspirin M=%d sig=%g lam=%g by the slice stack on the one-rank mesh at 11c\'s budget (%.1f GB): %d slices, '
          'k=%d, local stack %.2f GB (11c: %d slices, k=%d, %.2f GB); the sharded build\'s sweeps W %.2f, Gram %.2f, F '
          '%.2f, renormalization %.2f s (11c: %.2f, %.2f, %.2f, %.2f); %d iterations (11c: %d; bound %d%% or %d), '
          'train() %.2f s = %s (11c: %.2f s); peak allocated %.2f GB (11c: %.2f); recorded resid %.3e, re-measured by '
          'the plain matvec %.3e (drift %.2e; target %.3e); held-out force MAE %.5f (bound %.4f), mean |dF| / mean '
          '|F| against 8c\'s model %.2e (bound %.0e) on %d frames; K1 %.2f launches an iteration %s (%s)' % (
              len(task['idxs_train']), float(task['sig']), float(task['lam']), r['budget'] / 1e9, ns, k, stack_gb,
              r['ns'], r['k'], r['stack_gb'], sweeps['W'], sweeps['Gram'], sweeps['F'], sweeps['renorm'],
              r['sweeps']['W'], r['sweeps']['Gram'], r['sweeps']['F'], r['sweeps']['renorm'], iters, r['iters'],
              100 * CG_ANCHOR_TOL[0], CG_ANCHOR_TOL[1], t['total'],
              mesh_times(t, ('descriptors', 'leverage scores', 'factor', 'cg', 'integration constant')),
              r['times']['total'], peak / 1e9, r['peak'] / 1e9, model['solver_resid'], resid, drift, tol_b, mae,
              CG_MAE_SHARE * scale, f_rel, CG_DENSE_BOUNDS[0], len(R), per_it, during, card))
    assert (k, ns, stack_gb) == (r['k'], r['ns'], r['stack_gb']), (k, ns, stack_gb, r)
    assert abs(iters - r['iters']) <= max(CG_ANCHOR_TOL[0] * r['iters'], CG_ANCHOR_TOL[1]), (iters, r['iters'])
    assert resid <= tol_b and drift <= it_mod.RESID_REPLACE_DRIFT, (resid, tol_b, drift)
    assert mae < CG_MAE_SHARE * scale and f_rel < CG_DENSE_BOUNDS[0], (mae, f_rel)
    o = dict(factor=solver.factor, k=k, ns=ns, rung=model.get('solver_mv_mm', 'ozaki'))
    r8 = dict(r8, X=X, Jc=Jc, dperms=dperms, n=X.shape[0] * 3 * n_atoms)
    split = ozaki_split('aspirin mesh', r8, o, card)
    split['solver_iters'] = iters
    print('    the sharded apply at one rank: %.3f ms against 11c\'s single-device apply %.3f ms (%s)' % (
        split['apply_ms'], r['apply_ms'], card))
    return during, split


def phase_mesh_ecstr(device, mesh, ethanol, card):
    """14d: 10c's energy-constrained ethanol task on the one-rank mesh by the
    pair route and by the bordered slice stack at ``MESH_STACK_SLICES``
    (renormalized), each against the dense model on the training geometries:
    the only runs of the bordered apply and the sharded renormalization."""
    ds = ethanol[0]
    m, _, lam, _ = GRID_ECSTR
    n_atoms = ds['R'].shape[1]
    task = GDMLTrain(device=device).create_task(ds, m, ds, 100, sig=ETHANOL[5], lam=lam, use_sym=False,
                                               use_E_cstr=True, rng=np.random.RandomState(ETHANOL[3]))
    dense = GDMLTrain(device=device).train(task)
    R = task['R_train'].reshape(m, -1)
    Ed, Fd = GDMLPredict(dense, device=device).predict(R)
    counts = dict.fromkeys(launch_counts(), 0)
    with mesh_pair_probe(split=False) as (probe, records):
        fused_predict.reset_launches()
        trainer = GDMLTrain(mesh=mesh, device=device)
        pair = trainer.train(task, solver='analytic')
        during = launch_counts()
    counts = {key: counts[key] + during[key] for key in counts}
    solver, (taken, fallback) = probe['solvers'][-1], pair_route_log(records)
    Ep, Fp = GDMLPredict(pair, device=device).predict(R)
    p_rel = float(np.linalg.norm(Fp - Fd) / np.linalg.norm(Fd))
    with ozaki_factor() as (made, records):
        fused_predict.reset_launches()
        stack_trainer = GDMLTrain(mesh=mesh, device=device)
        stack = stack_trainer.train(task, solver='cg', factor_slices=MESH_STACK_SLICES,
                                    solver_max_seconds=CG_ASPIRIN_SECONDS)
        during = launch_counts()
    counts = {key: counts[key] + during[key] for key in counts}
    F_stack = made[-1].factor
    build = [rec.args for rec in records.records if rec.msg.startswith('Sharded streamed slice-stack factor')][-1]
    Es, Fs = GDMLPredict(stack, device=device).predict(R)
    s_rel = float(np.abs(Fs - Fd).mean() / np.abs(Fd).mean())
    e_rel = float(np.abs((Es - Es.mean()) - (Ed - Ed.mean())).mean() / np.abs(Ed - Ed.mean()).mean())
    conv = stack['solver_resid'] <= stack['solver_tol'] * stack['norm_y_train']
    print('    ethanol M=%d lam=%g with energy constraints (%d unknowns) on the one-rank mesh: the pair route (%d '
          'rung(s), lam\' %.4e, %d CG iterations, fell back to f64: %s, train() %.3f s) against the dense model: '
          'training forces %.2e relative (bound %.0e), energies %.2e; the bordered slice stack (%d slices, k=%d, '
          'border F_E %s, renormalization %.3f s, %d iterations, converged %s, train() %.3f s) against the dense model: '
          'mean |dF| / mean |F| %.2e (bound %.0e), centered energies %.2e (bound %.0e); K1 launches %s (%s)' % (
              m, lam, m * (3 * n_atoms + 1), len(solver.rungs), solver.lam_p_used, solver.pcg_iters, fallback,
              trainer.times['total'], p_rel, MESH_ECSTR_PAIR_TOL, float(np.abs(Ep - Ed).max() / np.abs(Ed).max()),
              made[-1]._ns(), len(stack['inducing_pts_idxs']) // (3 * n_atoms), tuple(F_stack.F_E.shape), build[-1],
              stack['solver_iters'], conv, stack_trainer.times['total'], s_rel, CG_DENSE_BOUNDS[0], e_rel,
              CG_DENSE_BOUNDS[1], counts, card))
    assert taken and not fallback and 'alphas_E' in pair and p_rel < MESH_ECSTR_PAIR_TOL, (taken, fallback, p_rel)
    assert made[-1]._ns() == MESH_STACK_SLICES and F_stack.F_E is not None and build[-1] > 0, build
    assert conv and 'alphas_E' in stack and s_rel < CG_DENSE_BOUNDS[0] and e_rel < CG_DENSE_BOUNDS[1], (
        conv, s_rel, e_rel)
    return counts


def phase_mesh_routes(device, ethanol, grid, card):
    """14: the mesh's pair and int8 routes on a one-rank NCCL world made here
    (no launcher) and destroyed at the end, as phase 13's; K1 runs in the
    integration constants, the mesh serving, the slice stack's CG matvecs and
    the validations."""
    t0 = time.perf_counter()
    assert not torch.distributed.is_initialized()
    mesh_mod.init_distributed(world_size=1, rank=0, device=device)
    counts = dict.fromkeys(launch_counts(), 0)
    split = None
    try:
        mesh = mesh_mod.default_mesh(1, device=device)
        torch.distributed.barrier()
        secs = {}
        for name, run in (('14a', lambda: phase_mesh_pair(device, mesh, grid, card)),
                          ('14b', lambda: phase_mesh_cyclic(device, mesh, grid, card)),
                          ('14c', lambda: phase_mesh_stack(device, mesh, card)),
                          ('14d', lambda: phase_mesh_ecstr(device, mesh, ethanol, card))):
            gc.collect()
            torch.cuda.empty_cache()
            t_run = time.perf_counter()
            during = run()
            if isinstance(during, tuple):
                during, split = during
            secs[name] = time.perf_counter() - t_run
            counts = {k: counts[k] + during[k] for k in counts}
    finally:
        torch.distributed.destroy_process_group()
    assert counts['pass_a'] > 0 and counts['pass_b'] > 0, counts
    print('[14 mesh routes] one-rank %s world: aspirin (%d unknowns) by the mesh pair route without the f64 fallback; '
          'the cyclic layout = 13b\'s model; the sharded slice stack = 11c (k, slices, stack) and 8c\'s model; '
          'energy constraints by the pair route and the bordered, renormalized stack = the dense model; seconds %s; '
          'launches %s; %.1f s (%s)' % (
              'NCCL' if device == 'cuda' else 'gloo', GRID_ASPIRIN[5] * 3 * GRID_ASPIRIN[0],
              {k: round(v, 1) for k, v in secs.items()}, counts, time.perf_counter() - t0, card))
    return counts, split


@contextlib.contextmanager
def inplace_probe():
    """Watch ``train()``'s analytic solve: the ``Analytic`` instance that
    ran the in-place route (``Analytic._solve_inplace`` wrapped; its
    ``route`` says whether it solved there) and the solver's log lines at
    INFO. Nothing is held: ``solve`` picks its route by the budget."""
    probe = {'solver': None, 'log': Records()}
    solve = Analytic._solve_inplace

    def watched(self, *args, **kw):
        probe['solver'] = self
        return solve(self, *args, **kw)

    logger = logging.getLogger(an_mod.__name__)
    level = logger.level
    logger.addHandler(probe['log'])
    logger.setLevel(logging.INFO)
    Analytic._solve_inplace = watched
    try:
        yield probe
    finally:
        Analytic._solve_inplace = solve
        logger.removeHandler(probe['log'])
        logger.setLevel(level)


def inplace_run(label, device, ds, task, card, ref_mae=None):
    """``GDMLTrain(device=).train(task)`` with solver=None and no budget
    patch, which must take the in-place f64 route (no ``'lmax'`` phase, no
    fallback in the solver's log) within ``est_memory_inplace`` and fit
    the system to ``MESH_RESID`` through the K1 matvec; its held-out force
    MAE must stay under 8c's bound (and within ``MESH_MAE_SHARE`` of
    ``ref_mae``, 10a's, on the same task). Returns the held-out forces, the
    launches and the seconds by phase."""
    n_atoms, m = task['R_train'].shape[1], task['R_train'].shape[0]
    n = m * 3 * n_atoms
    need = Analytic.est_memory_inplace(m, n_atoms, False, len(task['perms']))
    budget = memory_budget(device)
    assert need <= budget < Analytic.est_memory_requirement(m, n_atoms), (need, budget)
    trainer = GDMLTrain(device=device)
    with inplace_probe() as probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fused_predict.reset_launches()
        model = trainer.train(task)
        peak = torch.cuda.max_memory_allocated() - base
        R, F_ref, _ = held_out(ds, task, GRID_HELD_OUT)
        _, F = GDMLPredict(model, device=device).predict(R)
        during = launch_counts()
    solver, t = probe['solver'], trainer.times
    fell_back = [msg for msg in probe['log'].messages if 'falling back' in msg]
    assert model['solver_name'] == 'analytic' and solver is not None and solver.route == 'inplace', (
        solver and solver.route)
    assert not fell_back and 'lmax' not in t and {'assembly', 'factor', 'solve'} <= set(t), (fell_back, t)
    X, Jc, dperms, y, _ = cg_system(ds, task, n_atoms, device)
    rel = k1_resid(model, X, Jc, dperms, y, n_atoms)
    mae, scale = float(np.abs(F - F_ref).mean()), float(np.abs(F_ref).mean())
    print('    %s aspirin N=%d M=%d sig=%g lam=%g (%d unknowns; budget %.2f GB; the dense route needs %.1f GB): '
          'solver=None took the in-place f64 route (nb %d, no fallback); train() %.2f s = %s; the factor %.1f '
          'TFLOP/s on n^3/3; peak allocated by train() %.2f GB (8 n^2 = %.2f GB, est_memory_inplace %.2f GB, '
          'the card %.1f GB); relative residual re-measured by the K1 matvec %.3e (bound %.0e); held-out force MAE '
          '%.6f on %d frames (force scale %.4f, bound %.4f%s); K1 launches %s (%s)' % (
              label, n_atoms, m, float(task['sig']), float(task['lam']), n, budget / 1e9,
              Analytic.est_memory_requirement(m, n_atoms) / 1e9, an_mod.INPLACE_BLOCK, t['total'],
              mesh_times(t, ('descriptors', 'assembly', 'factor', 'solve', 'model creation',
                             'integration constant')),
              n**3 / 3 / t['factor'] * 1e-12, peak / 1e9, 8.0 * n * n / 1e9, need / 1e9,
              torch.cuda.get_device_properties(device).total_memory / 1e9, rel, MESH_RESID, mae, len(R), scale,
              CG_MAE_SHARE * scale, '' if ref_mae is None else '; 10a: %.6f, bound %.0f%%' % (
                  ref_mae, 100 * MESH_MAE_SHARE), during, card))
    assert peak <= need and rel <= MESH_RESID and mae < CG_MAE_SHARE * scale, (peak, need, rel, mae)
    if ref_mae is not None:
        assert abs(mae - ref_mae) <= MESH_MAE_SHARE * ref_mae, (mae, ref_mae)
    return F, during, dict(t)


def phase_inplace(device, grid, card):
    """15: the in-place f64 route of single-card ``solve`` past the dense
    bound, not held: (a) 10a's task (63,000 unknowns, lam 1e-10) through
    ``train()`` with solver=None, against 10a's MAE and 13b's model, with
    ``train()`` beside 10a's, 12a's and 13b's; (b) the same recipe at
    M=1400 (``INPLACE_TOP``, 88,200 unknowns), where memory is tight. K1
    runs in the integration constants and the held-out predictions."""
    t0 = time.perf_counter()
    F, counts, t = inplace_run('15a', device, grid['ds'], grid['task'], card, ref_mae=grid['mae'])
    F_13b = RESULTS['13b']['F']
    d_13b = float(np.abs(F - F_13b).max() / np.abs(F_13b).max())
    print('    15a train() %.2f s; 10a (the grid route, held) %.2f s, 12a (the pair route, held) %.2f s, 13b (the '
          'one-rank mesh f64 Cholesky) %.2f s, in this call; max |dF| / max |F| from 13b\'s model %.3e (bound %.0e) '
          '(%s)' % (t['total'], grid['times']['total'], RESULTS['12a']['times']['total'],
                    RESULTS['13b']['times']['total'], d_13b, INPLACE_13B_TOL, card))
    assert d_13b <= INPLACE_13B_TOL, d_13b
    gc.collect()
    torch.cuda.empty_cache()
    n_atoms, n_frames, seed, split, n_valid, m, sig, lam = INPLACE_TOP
    t_data = time.perf_counter()
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_frames, seed=seed)
    task = GDMLTrain(device=device).create_task(ds, m, ds, n_valid, sig=sig, lam=lam, use_sym=False,
                                               rng=np.random.RandomState(split))
    t_data = time.perf_counter() - t_data
    _, during, t_top = inplace_run('15b', device, ds, task, card)
    counts = {k: counts[k] + during[k] for k in counts}
    assert counts['pass_a'] > 0 and counts['pass_b'] > 0, counts
    print('[15 in-place] aspirin by the in-place f64 route that solver=None takes past the dense bound: M=%d '
          '(%d unknowns) in %.2f s, = 13b\'s model; M=%d (%d unknowns) in %.2f s (data %.1f s); launches %s; '
          '%.1f s' % (GRID_ASPIRIN[5], GRID_ASPIRIN[5] * 3 * GRID_ASPIRIN[0], t['total'], m, m * 3 * n_atoms,
                      t_top['total'], t_data, counts, time.perf_counter() - t0))
    return counts


def bound(B, T, D, itemsize):
    """(ms, 'bytes' or 'operations'): the least time of one contraction on
    an H100 SXM: 8 B T D operations at 67 TFLOP/s (FP64 tensor core and FP32
    alike) or its inputs read and outputs written once at 3.35 TB/s."""
    flops = 8.0 * B * T * D
    n_bytes = itemsize * (B * D + 2 * T * D + 2 * T + B + B * D)
    t_ops, t_bytes = flops / H100_FLOPS * 1e3, n_bytes / H100_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def main():
    t_start = time.perf_counter()
    logging.basicConfig(level=logging.WARNING, format='%(levelname)s %(name)s: %(message)s')
    smi = phase_device()
    device = 'cuda'
    phase_build()
    if sys.argv[1:] == ['--grid-precision']:
        phase_grid_precision(device, smi)
        print(smi)
        return
    if sys.argv[1:] == ['--atat-factors']:
        phase_atat_factors(device, smi)
        print(smi)
        return
    if sys.argv[1:] == ['--stack-apply']:
        phase_stack_apply(device, smi)
        print(smi)
        return
    if sys.argv[1:] == ['--strip-apply']:
        phase_strip_apply(device, smi)
        print(smi)
        return
    max_abs, times = phase_kernel_vs_plain(device)
    serving_counts, atat = phase_serving(device, smi)
    main_path = [phase_golden(device), serving_counts, phase_md(device)]
    train_counts, ethanol = phase_train(device, smi)
    cg_counts, splits, aspirin_cg, atat_cg = phase_cg(device, ethanol, smi)
    cli_counts = phase_cli(device, ethanol, atat, splits[1]['solver_iters'], smi)
    grid_counts, grid_split_, grid = phase_grid(device, ethanol, aspirin_cg, smi)
    splits.append(grid_split_)
    ozaki_counts, ozaki_splits = phase_ozaki(device, aspirin_cg, atat_cg, smi)
    splits += ozaki_splits
    RESULTS['8c'] = {k: aspirin_cg[k] for k in ('ds', 'task', 'model', 'k', 'budget', 'times', 'peak')}
    del aspirin_cg, atat_cg
    gc.collect()
    pair_counts, pair_split_ = phase_pair(device, ethanol, grid, smi)
    splits.append(pair_split_)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_counts = phase_mesh(device, ethanol, grid, atat, smi)
    gc.collect()
    torch.cuda.empty_cache()
    routes_counts, stack_split = phase_mesh_routes(device, ethanol, grid, smi)
    splits.append(stack_split)
    gc.collect()
    torch.cuda.empty_cache()
    inplace_counts = phase_inplace(device, grid, smi)
    main_path += [train_counts, cg_counts, cli_counts, grid_counts, ozaki_counts, pair_counts, mesh_counts,
                  routes_counts, inplace_counts]
    counts = {k: sum(c[k] for c in main_path) for k in main_path[0]}
    assert all(counts[k] > 0 for k in ('one_pass', 'pass_a', 'pass_b')), counts
    ms, plain_ms = times['at-at', torch.float64]
    bound_ms, bound_by = bound(*SHAPES['at-at'], 8)
    print('[wall] %.1f s from the start of chip_smoke.py, the kernel build included' % (time.perf_counter() - t_start))
    print(json.dumps({'kernels': [{
        'name': 'fused_predict', 'route': 'cuda',
        'source': 'sgdml_tpu_torch/csrc/fused_predict.cu',
        'replaces': 'sgdml_tpu/ops/pallas_predict.py:43',
        'launches': counts['total'], 'max_abs_err': max(max_abs, *(s['max_abs_err'] for s in splits)),
        'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
        'launches_by_path': {k: counts[k] for k in ('one_pass', 'pass_a', 'pass_b')},
        'cg_matvec_shapes': splits,
    }]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
    sys.stdout.flush()
