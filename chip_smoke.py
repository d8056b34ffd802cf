"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

It imports only the port (``sgdml_tpu_torch``), builds its CUDA kernel from
``sgdml_tpu_torch/csrc/`` into ``build/kernels/``, and runs these phases,
each a plain assertion that ends the run with a traceback when it fails:

1. device: a CUDA card is required; prints its name and power limit;
2. build: builds the fused (E, F) kernel and prints the build time;
3. kernel against its plain PyTorch version on the card, f32 and f64, with
   and without the energy constraint, at a ragged shape, the ethanol width
   and the full AT-AT width, launched twice for the same bits, with kernel
   and plain times;
4. the golden model (trained by the original sGDML) through
   ``GDMLPredict(device='cuda')`` against the reference's predictions;
5. serving at full AT-AT width (N=60, M=3000, D=1770) through
   ``GDMLPredict.predict`` for requests of 1, 17, 512 and 10,000 geometries
   in f64 and f32, each against the plain path, and geometries per second;
6. 200 NVE steps and 50 Langevin steps of MD on the golden model.

The last two lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import math
import os
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


def time_pair(kernel, plain, reps):
    """(kernel ms, plain ms), warmed up and timed in turns plain, kernel,
    kernel, plain so that clock drift falls on both alike."""
    kernel(), plain()
    torch.cuda.synchronize()
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


def phase_build():
    t0 = time.perf_counter()
    lib = _build.load_library()
    secs = time.perf_counter() - t0
    ptxas = os.path.splitext(lib._name)[0] + '.ptxas.txt'
    report = open(ptxas).read().splitlines() if os.path.exists(ptxas) else []
    for line in report:
        if 'registers' in line or 'spill' in line:
            print('    ptxas:', line.strip())
    print('[2 build] K1 built and loaded in %.2f s from sgdml_tpu_torch/csrc into %s' % (
        secs, os.path.relpath(os.path.dirname(lib._name), ROOT)))
    return secs


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


def phase_kernel_vs_plain(device, shapes):
    """Returns (max abs error over all cases, {(shape, dtype): (ms, plain_ms)})."""
    max_abs, times = 0.0, {}
    for label, (B, T, D) in shapes.items():
        for dtype in (torch.float64, torch.float32):
            for with_aE in (False, True):
                args = contraction_inputs(B, T, D, dtype, with_aE, seed=B + T + D, device=device)
                E_k, F_k = fused_predict.fused_predict_tables(*args)
                E_p, F_p = fused_predict.fused_predict_tables_reference(*args)
                torch.cuda.synchronize()
                e_err, f_err = rel_err(E_k, E_p), rel_err(F_k, F_p)
                max_abs = max(max_abs, float((E_k - E_p).abs().max()), float((F_k - F_p).abs().max()))
                print('    %-8s B=%5d T=%4d D=%4d %s aE=%-5s  E err %.2e  F_d err %.2e  (bound %.0e)' % (
                    label, B, T, D, NAME[dtype], with_aE, e_err, f_err, TOL[dtype]))
                assert torch.isfinite(E_k).all() and torch.isfinite(F_k).all()
                assert e_err <= TOL[dtype] and f_err <= TOL[dtype], (label, dtype, e_err, f_err)
                # No atomics: a second launch gives the same bits.
                E_k2, F_k2 = fused_predict.fused_predict_tables(*args)
                assert torch.equal(E_k, E_k2) and torch.equal(F_k, F_k2), (label, dtype)
            if label != 'ragged':
                args = contraction_inputs(B, T, D, dtype, False, seed=1, device=device)
                ms, plain_ms = time_pair(
                    lambda: fused_predict.fused_predict_tables(*args),
                    lambda: fused_predict.fused_predict_tables_reference(*args),
                    reps=5,
                )
                times[label, dtype] = (ms, plain_ms)
                print('    %-8s B=%5d T=%4d D=%4d %s  kernel %.3f ms (%.0f gps)  plain %.3f ms (%.0f gps)' % (
                    label, B, T, D, NAME[dtype], ms, B / ms * 1e3, plain_ms, B / plain_ms * 1e3))
    print('[3 kernel vs plain] all %d cases within bounds and bitwise repeatable; max abs error %.3e' % (
        len(shapes) * 4, max_abs))
    return max_abs, times


def phase_golden(device):
    model = io.load_dict(os.path.join(GOLDEN, 'model_ref.npz'))
    ref = np.load(os.path.join(GOLDEN, 'train_predict_ref.npz'))
    before = fused_predict.LAUNCHES
    E, F = GDMLPredict(model, dtype=torch.float64, device=device).predict(ref['R_test'])
    np.testing.assert_allclose(E, ref['e_pred'], rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(F, ref['f_pred'], rtol=1e-8, atol=1e-9)
    assert fused_predict.LAUNCHES > before
    print('[4 golden] GDMLPredict(cuda, f64) on %d geometries: max |dE| %.2e, max |dF| %.2e '
          'against the reference; %d launch(es)' % (
              len(E), np.abs(E - ref['e_pred']).max(), np.abs(F - ref['f_pred']).max(),
              fused_predict.LAUNCHES - before))


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

    # The main path: LAUNCHES is read from 0 over exactly these requests.
    fused_predict.LAUNCHES = 0
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
    launches = fused_predict.LAUNCHES
    assert launches > 0

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
          '%d kernel launches on the main path' % (2 * len(requests), launches))
    return launches


def phase_md(device):
    model = io.load_dict(os.path.join(GOLDEN, 'model_ref.npz'))
    r0 = np.load(os.path.join(GOLDEN, 'train_predict_ref.npz'))['R_test'][0]
    drifts = {}
    for dev in ('cpu', device):
        eng = MDEngine(model, device=dev)
        masses = eng.masses.cpu().numpy()
        v0 = np.random.default_rng(0).normal(size=(len(masses), 3)) * np.sqrt(MD_KT / masses)[:, None]
        v0 -= (masses[:, None] * v0).sum(0) / masses.sum()
        before = fused_predict.LAUNCHES
        R, V, E_pot, E_kin = eng.run_nve(r0, v0, MD_DT, MD_STEPS)
        E_tot = E_pot + E_kin
        drift = np.abs(E_tot - E_tot[0]).max() / E_kin.mean()
        drifts[dev] = drift
        assert np.isfinite(R).all() and np.abs(R[-1] - R[0]).max() > 1e-2
        assert drift < MD_DRIFT, (dev, drift)
        if dev != 'cpu':
            assert fused_predict.LAUNCHES > before
    eng = MDEngine(model, device=device)
    R, V, E_pot, E_kin = eng.run_langevin(r0, np.zeros_like(r0), MD_DT, 50, friction=0.1, kT=MD_KT, seed=0)
    assert np.isfinite(R).all() and np.isfinite(E_pot).all() and np.isfinite(E_kin).all()
    print('[6 md] NVE %d steps dt=%g: drift / mean kinetic energy %.2e on cpu, %.2e on %s '
          '(bound %.0e); Langevin 50 steps finite' % (
              MD_STEPS, MD_DT, drifts['cpu'], drifts[device], device, MD_DRIFT))


def main():
    smi = phase_device()
    device = 'cuda'
    phase_build()
    shapes = {'ragged': (17, 37, 45), 'ethanol': (10_000, 1000, 36), 'at-at': (512, 3000, 1770)}
    max_abs, times = phase_kernel_vs_plain(device, shapes)
    phase_golden(device)
    launches = phase_serving(device, smi)
    phase_md(device)
    ms, plain_ms = times['at-at', torch.float64]
    print(json.dumps({'kernels': [{
        'name': 'fused_predict', 'route': 'cuda',
        'source': 'sgdml_tpu_torch/csrc/fused_predict.cu',
        'replaces': 'sgdml_tpu/ops/pallas_predict.py:43',
        'launches': launches, 'max_abs_err': max_abs, 'ms': ms, 'plain_ms': plain_ms,
    }]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
    sys.stdout.flush()
