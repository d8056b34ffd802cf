"""The NVE step as one ``fused_predict.md_step``: its plain version against
the eager substep it replaces, the routing of ``MDEngine.run_nve`` to it, and
on a card (marked ``card``; skipped without one) the step kernel against its
plain version and the fused trajectory against the unfused graphs. This file
imports no JAX: its card tests run on a machine without it
(``python3 -m pytest --noconftest tests/test_torch_md_step.py -m card``)."""

import math
import pathlib

import numpy as np
import pytest
import torch

from sgdml_tpu_torch import md
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.ops import fused_predict
from sgdml_tpu_torch.train import GDMLTrain
from sgdml_tpu_torch.utils import io, profiling

GOLDEN = pathlib.Path(__file__).parent / 'golden'
DT = 0.01


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: PyTorch sees none here')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def models():
    """``{N: (model, r0)}``: the golden model (N=5) and one trained on the CPU
    at the aspirin width (N=21, 40 points)."""
    golden = io.load_dict(str(GOLDEN / 'model_ref.npz'))
    r_g = np.load(GOLDEN / 'train_predict_ref.npz')['R_test'][0].reshape(-1, 3)
    ds = generate_md_dataset(n_atoms=21, n_frames=80, seed=1)
    trainer = GDMLTrain(device='cpu')
    task = trainer.create_task(ds, 40, ds, 10, sig=20.0, lam=1e-10, use_sym=False, use_E=True,
                               rng=np.random.RandomState(0))
    return {5: (golden, r_g), 21: (trainer.train(task), ds['R'][50])}


def _velocities(eng, kT=0.05, seed=0):
    masses = eng.masses.cpu().numpy()
    return np.random.default_rng(seed).normal(size=(eng.n_atoms, 3)) * np.sqrt(kT / masses)[:, None]


def _unfused(eng):
    """``eng`` held to the step's operations one by one."""
    eng._fused_nve = lambda: False
    return eng


# f64 and f32: positions, velocities (over their largest entry) and the
# energy (over its own size) after 200 steps; the plain step and the eager
# substep add in other orders, and the trajectory carries the difference on.
TOL = {torch.float64: (1e-11, 1e-10, 1e-10), torch.float32: (1e-3, 1e-2, 1e-2)}


@pytest.mark.parametrize('blocks', [1, 7])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['f64', 'f32'])
@pytest.mark.parametrize('n_atoms', [5, 21])
def test_plain_step_follows_the_eager_substep(models, n_atoms, dtype, blocks):
    model, r0 = models[n_atoms]
    eng = _unfused(MDEngine(model, dtype=dtype, device='cpu'))
    v0 = _velocities(eng)
    R, V, E, _ = eng.run_nve(r0, v0, DT, 200, snapshot_every=200)
    inv_m = 1.0 / eng.masses[:, None]
    r, v = torch.tensor(r0, dtype=dtype), torch.tensor(v0, dtype=dtype)
    f = eng.energy_forces(r)[1].clone()
    for _ in range(200):
        e = fused_predict.md_step_reference(r, v, f, inv_m, eng.tables, eng.sig, eng.std, DT, blocks)
    tol_r, tol_v, tol_e = TOL[dtype]
    assert np.abs(r.numpy() - R[-1]).max() <= tol_r * np.abs(R[-1]).max()
    assert np.abs(v.numpy() - V[-1]).max() <= tol_v * np.abs(V[-1]).max()
    assert abs(float(e[0]) * eng.std + eng.c - E[-1]) <= tol_e * abs(E[-1])
    assert np.abs(R[-1] - r0).max() > 0.1  # the atoms moved


@pytest.mark.parametrize('n_atoms', [5, 21])
def test_the_step_splits_the_table_as_split_t_does(models, n_atoms):
    """One step: E_raw and F_d of the new positions are split T's on the same
    descriptor and blocks, bit for bit, and the forces are the incidence sum
    of F_d over each atom's pairs."""
    model, r0 = models[n_atoms]
    eng = MDEngine(model, device='cpu')
    inv_m = 1.0 / eng.masses[:, None]
    r, v = torch.tensor(r0), torch.tensor(_velocities(eng))
    f = eng.energy_forces(r)[1].clone()
    r_new = r + DT * (v + 0.5 * DT * f * inv_m)
    E = fused_predict.md_step(r, v, f, inv_m, eng.tables, eng.sig, eng.std, DT, blocks=3)
    torch.testing.assert_close(r, r_new, rtol=0, atol=0)
    x, jc = desc_ops.descriptor_jacobian(r_new.reshape(-1), n_atoms)
    E_t, F_d = fused_predict.split_t_reference((x - eng.tables.mu)[None], eng.tables.Xt, eng.tables.JA,
                                               eng.tables.xt_sq, eng.tables.tja, None, eng.sig, 3)
    assert abs(float(E[0]) - float(E_t[0])) <= 1e-14 * abs(float(E_t[0]))
    F = desc_ops.vec_dot_jac(jc, F_d[0], n_atoms).reshape(n_atoms, 3) * eng.std
    torch.testing.assert_close(f, F, rtol=1e-12, atol=1e-14 * float(F.abs().max()))


def _counting(monkeypatch):
    calls = []
    step = fused_predict.md_step

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return step(*args, **kwargs)

    monkeypatch.setattr(fused_predict, 'md_step', counted)
    return calls


@pytest.mark.parametrize('snapshot_every, max_steps', [(5, 100), (5, 2)])
def test_nve_takes_the_fused_step_where_k1_takes_split_t(models, monkeypatch, snapshot_every, max_steps):
    """NVE on the CPU: one md_step a step, ``md.fused_steps`` counts them by
    program call, and the snapshots' energies are the last steps' (those
    of a new prediction at the same positions, to rounding)."""
    monkeypatch.setattr(md, 'GRAPH_MAX_STEPS', max_steps)
    model, r0 = models[5]
    eng = MDEngine(model, device='cpu')
    assert fused_predict.route(eng.tables.Xt.shape[1], 1) == 'split_t' and eng._fused_nve()
    calls = _counting(monkeypatch)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        R, _, E, _ = eng.run_nve(r0, _velocities(eng), DT, 4 * snapshot_every, snapshot_every=snapshot_every)
        steps = profiling.counter('md.fused_steps')
    assert len(calls) == steps == 4 * snapshot_every
    E_new = [float(eng.energy_forces(torch.tensor(x))[0]) for x in R]
    np.testing.assert_allclose(E, E_new, rtol=1e-12)


def test_langevin_never_takes_the_fused_step(models, monkeypatch):
    model, r0 = models[5]
    eng = MDEngine(model, device='cpu')
    calls = _counting(monkeypatch)
    out = eng.run_langevin(r0, np.zeros_like(r0), DT, 6, friction=0.1, kT=0.05, seed=1, snapshot_every=3)
    assert calls == [] and all(np.isfinite(x).all() for x in out)


def test_a_width_past_split_t_keeps_the_substep(models, monkeypatch):
    """Where K1 at one geometry leaves split T (its descriptor past
    SPLIT_T_XQ_BYTES), NVE steps one operation at a time, as before, and
    follows the same trajectory."""
    model, r0 = models[21]
    v0 = _velocities(MDEngine(model, device='cpu'))
    fused = MDEngine(model, device='cpu').run_nve(r0, v0, DT, 20, snapshot_every=10)
    monkeypatch.setattr(fused_predict, 'SPLIT_T_XQ_BYTES', 8 * 210 - 8)
    eng = MDEngine(model, device='cpu')
    assert fused_predict.route(eng.tables.Xt.shape[1], 1) != 'split_t' and not eng._fused_nve()
    calls = _counting(monkeypatch)
    out = eng.run_nve(r0, v0, DT, 20, snapshot_every=10)
    assert calls == []
    for ours, theirs in zip(out, fused):
        np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize('what', ['r shape', 'width', 'inv_m', 'dtype', 'blocks'])
def test_md_step_rejects_what_the_kernel_does_not_take(models, what):
    model, r0 = models[5]
    eng = MDEngine(model, device='cpu')
    r, v = torch.tensor(r0), torch.tensor(_velocities(eng))
    f, inv_m, blocks = torch.zeros_like(r), 1.0 / eng.masses[:, None], None
    if what == 'r shape':
        r = r.reshape(-1)
    elif what == 'width':
        r, v, f = r[:4], v[:4], f[:4]
    elif what == 'inv_m':
        inv_m = inv_m[:4]
    elif what == 'dtype':
        v = v.float()
    else:
        blocks = 0
    with pytest.raises(ValueError):
        fused_predict.md_step(r, v, f, inv_m, eng.tables, eng.sig, eng.std, DT, blocks=blocks)


# --- On the card ------------------------------------------------------------

def _random_model(n_atoms, n_train, seed=0):
    """A model dict at a published width without training: descriptors of
    synthetic frames, seeded coefficients scaled so that the contracted
    Jacobians are ~1e-2, sig at the typical descriptor distance; and a
    frame outside the table."""
    ds = generate_md_dataset(n_atoms=n_atoms, n_frames=n_train + 1, seed=seed)
    R = torch.as_tensor(ds['R'][:n_train].reshape(n_train, -1))
    X, Jc = desc_ops.descriptor_batch(R, n_atoms)
    rng = np.random.default_rng(seed)
    alphas = torch.as_tensor(rng.normal(size=(n_train, 3 * n_atoms)))
    JA = desc_ops.jac_dot_vec(Jc, alphas, n_atoms)
    scale = 1e-2 / float(JA.std())
    idx = torch.as_tensor(rng.integers(0, n_train, size=(2, 512)))
    sig = float(math.sqrt(5.0) * torch.linalg.vector_norm(X[idx[0]] - X[idx[1]], dim=1).median())
    model = {'type': 'm', 'z': ds['z'], 'perms': np.arange(n_atoms)[None], 'R_desc': X.T.numpy(),
             'R_d_desc_alpha': (JA * scale).numpy(), 'alphas_F': (alphas * scale).reshape(-1).numpy(),
             'sig': sig, 'std': 1.0, 'c': 0.0, 'lam': 1e-10}
    return model, ds['R'][n_train]


WIDTHS = {'aspirin': (21, 1000), 'atat': (60, 3000)}
CARD_TOL = {torch.float64: 1e-9, torch.float32: 1e-3}  # positions after 1,000 steps, over their largest


@pytest.fixture(scope='module')
def card_models():
    return {}


def _card_model(card_models, width):
    if width not in card_models:
        card_models[width] = _random_model(*WIDTHS[width])
    return card_models[width]


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['f64', 'f32'])
@pytest.mark.parametrize('width, blocks', [('aspirin', None), ('aspirin', 5), ('aspirin', 64), ('atat', None),
                                           ('golden', 1), ('golden', 40)])
def test_step_kernel_matches_its_plain_version_on_the_card(card, card_models, width, blocks, dtype):
    if width == 'golden':
        model = io.load_dict(str(GOLDEN / 'model_ref.npz'))
        r0 = np.load(GOLDEN / 'train_predict_ref.npz')['R_test'][0].reshape(-1, 3)
    else:
        model, r0 = _card_model(card_models, width)
    eng = MDEngine(model, dtype=dtype, device=card)
    inv_m = 1.0 / eng.masses[:, None]
    state = [torch.tensor(r0, dtype=dtype, device=card), torch.tensor(_velocities(eng), dtype=dtype, device=card)]
    state.append(eng.energy_forces(state[0])[1].clone())
    T = eng.tables.Xt.shape[0]
    work = fused_predict.MDStepWork(T, eng.tables.Xt.shape[1], dtype, card, blocks)
    outs = []
    for _ in range(2):  # a second launch from the same state: the same bits, the tickets back at zero
        r, v, f = (x.clone() for x in state)
        E = fused_predict.md_step(r, v, f, inv_m, eng.tables, eng.sig, eng.std, DT, work=work).clone()
        outs.append((r, v, f, E))
        assert int(work.tickets.abs().sum()) == 0
    plain = [x.clone() for x in state]
    E_p = fused_predict.md_step_reference(*plain, inv_m, eng.tables, eng.sig, eng.std, DT, work.blocks)
    # f32: the forces are sums of terms that nearly cancel; the kernel and the
    # plain version add them in other orders (1.5e-4 at the golden width).
    tol = 1e-12 if dtype == torch.float64 else 1e-3
    for a, b, p in zip(outs[0], outs[1], plain + [E_p]):
        assert torch.equal(a, b)
        assert float((a - p).abs().max()) <= tol * max(float(p.abs().max()), 1e-300)


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['f64', 'f32'])
@pytest.mark.parametrize('width', ['aspirin', 'atat'])
def test_fused_nve_follows_the_unfused_graphs_on_the_card(card, card_models, width, dtype):
    """1,000 steps, a snapshot every 100, from the graphs: the fused steps
    against the step's operations one by one around split T; and a second
    fused run repeats the first bit for bit."""
    model, r0 = _card_model(card_models, width)
    eng = MDEngine(model, dtype=dtype, device=card)
    v0 = _velocities(eng)
    out = eng.run_nve(r0, v0, DT, 1000, snapshot_every=100)
    again = eng.run_nve(r0, v0, DT, 1000, snapshot_every=100)
    ref = _unfused(MDEngine(model, dtype=dtype, device=card)).run_nve(r0, v0, DT, 1000, snapshot_every=100)
    assert all(np.array_equal(a, b) for a, b in zip(out, again))
    assert np.abs(out[0] - ref[0]).max() <= CARD_TOL[dtype] * np.abs(ref[0]).max()
    assert np.abs(out[2] - ref[2]).max() <= 10 * CARD_TOL[dtype] * np.abs(ref[2]).max()


@pytest.mark.card
def test_fused_nve_counts_one_launch_a_step_on_the_card(card, card_models):
    """Through graph replays: one contraction and one md_step a step in the
    launch counts, and ``md.fused_steps`` the steps; K1 once more for the
    first forces."""
    model, r0 = _card_model(card_models, 'aspirin')
    eng = MDEngine(model, device=card)
    fused_predict.reset_launches()
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.run_nve(r0, _velocities(eng), DT, 300, snapshot_every=100)
        steps = profiling.counter('md.fused_steps')
    assert fused_predict.LAUNCHES == 301 and steps == 300
    assert fused_predict.PATH_LAUNCHES['md_step'] == 300 and fused_predict.PATH_LAUNCHES['split_t'] == 1
