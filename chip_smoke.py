"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

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
   launch per force evaluation.

Phases 4-6 are the main path: each sets the launch counts to 0 before it
and reads them after. The last two lines are the kernels' JSON record and
``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.ops import _build, fused_predict
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.predict import (
    GDMLPredict, _predict_from_tables_body, _predict_geoms, center_tables,
)
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
    return counts


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


def main():
    smi = phase_device()
    device = 'cuda'
    phase_build()
    max_abs, times = phase_kernel_vs_plain(device)
    main_path = [phase_golden(device), phase_serving(device, smi), phase_md(device)]
    counts = {k: sum(c[k] for c in main_path) for k in main_path[0]}
    assert all(counts[k] > 0 for k in ('one_pass', 'pass_a', 'pass_b')), counts
    ms, plain_ms = times['at-at', torch.float64]
    print(json.dumps({'kernels': [{
        'name': 'fused_predict', 'route': 'cuda',
        'source': 'sgdml_tpu_torch/csrc/fused_predict.cu',
        'replaces': 'sgdml_tpu/ops/pallas_predict.py:43',
        'launches': counts['total'], 'max_abs_err': max_abs, 'ms': ms, 'plain_ms': plain_ms,
        'launches_by_path': {k: counts[k] for k in ('one_pass', 'pass_a', 'pass_b')},
    }]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
    sys.stdout.flush()
