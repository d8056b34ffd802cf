"""The port's MDEngine on the CPU against the JAX MDEngine: NVE trajectories
agree, whatever the split of a block into graph-sized programs; Langevin runs
are finite, reproducible from their seed, and draw fresh noise for every
program call, as a plain loop over the same generator does."""

import pathlib

import numpy as np
import pytest
import torch

from sgdml_tpu.md import MDEngine as JaxMDEngine
from sgdml_tpu_torch import md
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.utils import io

GOLDEN = pathlib.Path(__file__).parent / 'golden'


@pytest.fixture(scope='module')
def setup():
    model = io.load_dict(str(GOLDEN / 'model_ref.npz'))
    r0 = np.load(GOLDEN / 'train_predict_ref.npz')['R_test'][0].reshape(-1, 3)
    v0 = np.random.default_rng(0).normal(size=r0.shape) * 0.05
    return model, r0, v0


def test_nve_matches_jax(setup):
    model, r0, v0 = setup
    out = MDEngine(model, device='cpu').run_nve(r0, v0, dt=0.02, n_steps=20, snapshot_every=2)
    ref = JaxMDEngine(model).run_nve(r0, v0, dt=0.02, n_steps=20, snapshot_every=2)
    for ours, theirs, name in zip(out, ref, ('R', 'V', 'E_pot', 'E_kin')):
        assert ours.shape == np.asarray(theirs).shape, name
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-8, atol=1e-12, err_msg=name)
    assert out[0].shape == (10, 5, 3)


@pytest.mark.parametrize('snapshot_every, max_steps', [(1, 100), (3, 100), (3, 2), (5, 2)])
def test_static_buffer_blocks_match_jax(setup, snapshot_every, max_steps, monkeypatch):
    """The block body over static buffers (a GPU captures it, the CPU runs it)
    against the JAX scan, with blocks of one program and, at max_steps 2,
    blocks split into a run of 2-step programs and a last one with the
    snapshot; the caller's r0 and v0 are not written."""
    model, r0, v0 = setup
    monkeypatch.setattr(md, 'GRAPH_MAX_STEPS', max_steps)
    kept = r0.copy(), v0.copy()
    n_steps = 4 * snapshot_every + snapshot_every // 2
    out = MDEngine(model, device='cpu').run_nve(r0, v0, dt=0.02, n_steps=n_steps, snapshot_every=snapshot_every)
    ref = JaxMDEngine(model).run_nve(r0, v0, dt=0.02, n_steps=n_steps, snapshot_every=snapshot_every)
    assert out[0].shape == (4, 5, 3) and out[2].shape == (4,)
    for ours, theirs, name in zip(out, ref, ('R', 'V', 'E_pot', 'E_kin')):
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-8, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(r0, kept[0])
    np.testing.assert_array_equal(v0, kept[1])


def _langevin_loop(eng, r0, v0, dt, n_steps, friction, kT, seed, snapshot_every, max_steps):
    """Plain BAOAB loop on numpy-fed tensors, drawing each program's noise
    rows from one seeded generator as the engine should."""
    inv_m = 1.0 / eng.masses[:, None]
    c1 = np.exp(-friction * dt)
    sigma_v = torch.sqrt(kT * (1 - c1**2) / eng.masses)[:, None]
    gen = torch.Generator().manual_seed(seed)
    r, v = torch.tensor(r0), torch.tensor(v0)
    f = eng.energy_forces(r)[1]
    per = min(snapshot_every, max_steps)
    runs = [per] * (snapshot_every // per) + ([snapshot_every % per] if snapshot_every % per else [])
    out = []
    for _ in range(n_steps // snapshot_every):
        for k in runs:
            noise = torch.empty((per, len(r0), 3), dtype=r.dtype)
            noise[:k].normal_(generator=gen)
            for i in range(k):
                v = v + 0.5 * dt * f * inv_m
                r = r + 0.5 * dt * v
                v = c1 * v + sigma_v * noise[i]
                r = r + 0.5 * dt * v
                f = eng.energy_forces(r)[1]
                v = v + 0.5 * dt * f * inv_m
        out.append((r, v, eng.energy_forces(r)[0], 0.5 * torch.sum(eng.masses[:, None] * v * v)))
    return [torch.stack(x).numpy() for x in zip(*out)]


@pytest.mark.parametrize('max_steps', [100, 2])
def test_langevin_draws_fresh_noise_for_every_program(setup, max_steps, monkeypatch):
    """Bit for bit the plain loop that draws new noise before each program
    call: a graph that replayed one draw would give every block the same
    noise and miss it."""
    model, r0, _ = setup
    monkeypatch.setattr(md, 'GRAPH_MAX_STEPS', max_steps)
    eng = MDEngine(model, device='cpu')
    kw = dict(dt=0.02, n_steps=15, friction=0.1, kT=0.05, seed=3, snapshot_every=5)
    out = eng.run_langevin(r0, np.zeros_like(r0), **kw)
    ref = _langevin_loop(eng, r0, np.zeros_like(r0), max_steps=max_steps, **kw)
    for ours, theirs in zip(out, ref):
        np.testing.assert_array_equal(ours, theirs)


def test_langevin_is_finite_and_reproducible_from_seed(setup):
    model, r0, _ = setup
    eng = MDEngine(model, device='cpu')
    kw = dict(dt=0.02, n_steps=12, friction=0.1, kT=0.05, snapshot_every=3)
    a = eng.run_langevin(r0, np.zeros_like(r0), seed=4, **kw)
    b = eng.run_langevin(r0, np.zeros_like(r0), seed=4, **kw)
    c = eng.run_langevin(r0, np.zeros_like(r0), seed=5, **kw)
    assert all(np.isfinite(x).all() for x in a)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert np.abs(a[1] - c[1]).max() > 0


def test_masses_and_forces_match_the_predictor(setup):
    model, r0, _ = setup
    eng = MDEngine(model, device='cpu')
    np.testing.assert_array_equal(
        eng.masses.numpy(), io.ATOMIC_MASSES[np.asarray(model['z'], dtype=np.int64)]
    )
    E1, F1 = eng.energy_forces(torch.as_tensor(r0))
    E2, F2 = GDMLPredict(model, device='cpu').predict(r0.reshape(1, -1))
    np.testing.assert_allclose(float(E1), E2[0], rtol=1e-12)
    np.testing.assert_allclose(F1.numpy().ravel(), F2[0], rtol=1e-10, atol=1e-14)
    if torch.cuda.is_available():
        assert MDEngine(model).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            MDEngine(model)  # the card by default: no silent CPU fallback
