"""Benchmark: train + bulk inference on the synthetic ethanol-sized system.

The counterpart of the repository's ``bench.py`` for this package, on the
same recipe: analytic training at M=200 (synthetic ethanol, N=9, 12,000
frames, seed 0; split seed 1; sig 10, lam 1e-10, energies used), one cold
and three warm ``train()`` calls, the held-out force and energy MAE on
1,000 geometries, and bulk energy and force prediction over 10,000
geometries in float64, float64 with float32 transfers and float32. Then the
device-only throughput of the prediction on resident inputs (slope-timed
with CUDA events over chains of 2 and 8 calls) at this width and at the
MD22 width (N=60, T=3000, D=1770, B=512, synthetic tables). Every
prediction on a GPU runs the fused (E, F) kernel K1.

Run on the GPU (the default), or on the CPU only when asked:

    python3 -m sgdml_tpu_torch.bench [--device cpu]

Prints one JSON line ``{"metric", "value", "unit", "vs_baseline",
"extra"}``. The headline is the fastest dtype whose force MAE stays within
1e-3 of float64's. The gate: the float64 force MAE (``force_mae_float64``)
must lie within 1e-4 of ``BENCH_BASELINE.json``'s ``reference_force_mae``;
when it does not, the line says ``"correct": false`` and the program exits
1. ``k1_launches`` counts the fused kernel's launches over the run (0 on the
CPU, where its plain version runs).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import timeit

import numpy as np
import torch

from . import resolve_device
from .datasets.synthetic import generate_md_dataset
from .ops import _build, fused_predict
from .predict import GDMLPredict, _predict_geoms, center_tables
from .train import GDMLTrain

BASELINE_PATH = pathlib.Path(__file__).resolve().parent.parent / 'BENCH_BASELINE.json'
BASELINE_NOTE = ('BENCH_BASELINE.json: the reference sGDML NumPy path (with its process auto-tuner) '
                 'on one host CPU of another machine, tests/measure_reference_baseline.py')

# H100 SXM data sheet: the FP64 tensor-core peak (and FP32's, the same) and
# the HBM3 bandwidth. K1 does 8 T D operations a geometry (two (B, D) x
# (D, T) products for the Gram and the Jacobian terms, two (B, T) x (T, D)
# for the forces).
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
GATE_MAE = 1e-4  # the float64 force MAE against the reference's
HEADLINE_MAE = 1e-3  # a dtype's force MAE against float64's, for the headline


def k1_flops(T: int, D: int) -> float:
    return 8.0 * T * D


def warm_device(device: torch.device):
    """Build and load K1, then touch the card, before any timer starts: the
    first use of K1 runs ``nvcc``, which no training or prediction time
    should include."""
    if device.type == 'cuda':
        _build.load_library()
        torch.zeros(8, device=device).add_(1.0)
        torch.cuda.synchronize(device)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``'cpu'``."""
    if device.type != 'cuda':
        return 'cpu'
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _seconds(fn, device: torch.device) -> float:
    """Seconds of ``fn()``: CUDA events on a GPU, the host clock on the CPU."""
    if device.type != 'cuda':
        t0 = timeit.default_timer()
        fn()
        return timeit.default_timer() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def slope_gps(call, batch: int, device: torch.device) -> float:
    """Geometries per second of ``call()`` on ``batch`` resident geometries,
    from the slope between chains of 2 and 8 calls (each the minimum of 3),
    which cancels what a chain pays once."""
    call()
    k1, k2 = 2, 8

    def chain(reps):
        def run():
            for _ in range(reps):
                call()
        return run

    t_k1 = t_k2 = float('inf')
    for _ in range(3):
        t_k1 = min(t_k1, _seconds(chain(k1), device))
        t_k2 = min(t_k2, _seconds(chain(k2), device))
    return batch / max((t_k2 - t_k1) / (k2 - k1), 1e-9)


def read_baseline() -> dict:
    return json.loads(BASELINE_PATH.read_text()) if BASELINE_PATH.exists() else {}


def run(n_atoms=9, m_train=200, n_bulk=10000, n_frames=12000, md22=(60, 3000, 512), device='cuda',
        reference_force_mae=None):
    """The benchmark at the given sizes (the defaults are the recipe);
    returns the result dict. ``reference_force_mae`` is the gate's
    reference, by default ``BENCH_BASELINE.json``'s, which holds only at the
    full recipe."""
    device = resolve_device(device)
    baseline = read_baseline()
    if reference_force_mae is None:
        reference_force_mae = baseline['reference_force_mae']
    warm_device(device)
    launches0 = fused_predict.LAUNCHES

    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_frames, seed=0)
    trainer = GDMLTrain(device=device)
    np.random.seed(1)
    task = trainer.create_task(ds, m_train, ds, 500, sig=10.0, lam=1e-10, use_sym=False, use_E=True)
    t0 = timeit.default_timer()
    model = trainer.train(task, solver='analytic')
    t_train_cold = timeit.default_timer() - t0
    t_train = float('inf')
    for _ in range(3):
        t0 = timeit.default_timer()
        model = trainer.train(task, solver='analytic')
        t_train = min(t_train, timeit.default_timer() - t0)

    ti = np.setdiff1d(np.arange(len(ds['R'])), task['idxs_train'])[:1000]
    R_test = ds['R'][ti].reshape(len(ti), -1)
    f_ref = ds['F'][ti].reshape(len(ti), -1)
    R_bulk = ds['R'][:n_bulk].reshape(n_bulk, -1)

    def measure(dtype, transfer_dtype=None):
        pred = GDMLPredict(model, dtype=dtype, batch_size=1000, transfer_dtype=transfer_dtype, device=device)
        E, F = pred.predict(R_test)
        f_mae = float(np.abs(F - f_ref).mean())
        e_mae = float(np.abs(E - ds['E'][ti]).mean())
        pred = GDMLPredict(model, dtype=dtype, batch_size=n_bulk, transfer_dtype=transfer_dtype, device=device)
        pred.predict(R_bulk)
        dt = float('inf')
        for _ in range(3):
            t0 = timeit.default_timer()
            pred.predict(R_bulk)  # numpy results: the copy back synchronizes
            dt = min(dt, timeit.default_timer() - t0)
        return n_bulk / dt, f_mae, e_mae

    gps64, f_mae64, e_mae64 = measure(torch.float64)
    gps64t32, f_mae64t32, e_mae64t32 = measure(torch.float64, transfer_dtype=torch.float32)
    gps32, f_mae32, e_mae32 = measure(torch.float32)

    # Device-only: f64 compute on f32 geometries already on the card.
    pred = GDMLPredict(model, dtype=torch.float64, batch_size=n_bulk, transfer_dtype=torch.float32,
                       device=device)
    Rb = torch.as_tensor(R_bulk, dtype=torch.float32, device=device)
    gps_device = slope_gps(lambda: _predict_geoms(
        Rb, pred.tables, pred.alphas_E_lin, None, pred.sig, pred.std, pred.c, n_atoms=pred.n_atoms,
        out_dtype=torch.float32), n_bulk, device)
    T_tab, D_tab = pred.tables.Xt.shape

    # MD22 width: synthetic tables of descriptor scale (the contraction's
    # cost does not depend on the values), centred as a model's are.
    n_at22, T22, B22 = md22
    D22 = n_at22 * (n_at22 - 1) // 2
    rng22 = np.random.default_rng(7)
    R22 = torch.as_tensor(rng22.normal(size=(B22, 3 * n_at22)) * 3.0, dtype=torch.float32, device=device)
    tables22 = center_tables(torch.as_tensor(0.3 + rng22.random((T22, D22)), device=device),
                             torch.as_tensor(rng22.normal(size=(T22, D22)) * 1e-2, device=device))
    gps_device_md22 = slope_gps(lambda: _predict_geoms(
        R22, tables22, None, None, 10.0, 1.0, 0.0, n_atoms=n_at22, out_dtype=torch.float32), B22, device)

    candidates = [
        (gps64, f_mae64, e_mae64, 'float64'),
        (gps64t32, f_mae64t32, e_mae64t32, 'float64 compute, float32 transfer'),
        (gps32, f_mae32, e_mae32, 'float32'),
    ]
    eligible = [c for c in candidates if c[1] <= f_mae64 + HEADLINE_MAE]
    gps, f_mae, e_mae, dtype = max(eligible, key=lambda c: c[0])
    base_gps = baseline.get('reference_pred_geoms_per_sec')

    def mfu(flops_per_s):
        """Percent of the H100's FP64 peak; None off the card."""
        return 100.0 * flops_per_s / PEAK_FLOPS if device.type == 'cuda' else None

    return {
        'metric': 'bulk inference throughput (ethanol-sized N=%d, M=%d, %d geoms)' % (n_atoms, m_train, n_bulk),
        'value': gps,
        'unit': 'geoms/sec',
        'vs_baseline': gps / base_gps if base_gps else None,
        'extra': {
            'device': device_line(device),
            'baseline': BASELINE_NOTE,
            'dtype': dtype,
            'train_s': t_train,
            'train_s_cold': t_train_cold,
            'train_s_vs_baseline': (baseline['reference_train_s'] / t_train
                                    if 'reference_train_s' in baseline else None),
            'force_mae': f_mae,
            'force_mae_reference': reference_force_mae,
            'energy_mae': e_mae,
            'gps_float64': gps64,
            'gps_f64_compute_f32_transfer': gps64t32,
            'gps_float32': gps32,
            'gps_device_only': gps_device,
            'mfu_f64_pct': mfu(k1_flops(T_tab, D_tab) * gps_device),
            'gps_device_only_md22': gps_device_md22,
            'mfu_md22_pct': mfu(k1_flops(T22, D22) * gps_device_md22),
            'mfu_flops_per_geometry': {'ethanol': k1_flops(T_tab, D_tab), 'md22': k1_flops(T22, D22)},
            'mfu_peak_flops': PEAK_FLOPS,
            'force_mae_float64': f_mae64,
            'energy_mae_float64': e_mae64,
            'k1_launches': fused_predict.LAUNCHES - launches0,
            'correct': abs(f_mae64 - reference_force_mae) <= GATE_MAE,
        },
    }


def main(argv=None):
    """Run the recipe, print its JSON line and return the result; exit 1
    when the float64 force MAE misses the gate."""
    ap = argparse.ArgumentParser(prog='python3 -m sgdml_tpu_torch.bench', description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    result = run(device=args.device)
    print(json.dumps(result))
    if not result['extra']['correct']:
        raise SystemExit(1)
    return result


if __name__ == '__main__':
    main()
