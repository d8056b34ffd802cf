"""The port's blocked Cholesky and triangular solves (``ops/linalg.py``)
against ``sgdml_tpu.ops.linalg``: on one tensor, and on row strips over a
gloo world of four CPU ranks (a 1-D mesh, and a 2 x 2 mesh), with the same
numpy inputs. The factor and the solves sum in the same order as the JAX
program up to the trailing update's, so they agree to 1e-11."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import linalg as jax_linalg
from sgdml_tpu_torch.ops import linalg
from sgdml_tpu_torch.parallel import mesh as mesh_mod

from torch_mesh_worker import run_world

TOL = 1e-11


def _spd(rng, n):
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """One gloo world of 4 ranks: n=128 in strips of 32, nb=16 (blocks
    straddle no strip), and a 64-unknown solve on a 2 x 2 mesh."""
    tmp = tmp_path_factory.mktemp('linalg')
    rng = np.random.default_rng(0)
    inputs = {'A': _spd(rng, 128), 'b': rng.normal(size=128), 'A2': _spd(rng, 64), 'b2': rng.normal(size=64)}
    np.savez(tmp / 'linalg_inputs.npz', **inputs)
    return inputs, run_world('linalg', 4, tmp, n=128, nb=16)


@pytest.mark.parametrize('n, nb', [(96, 32), (96, 96), (70, 16)])
def test_blocked_cholesky_single_tensor(rng, n, nb):
    A = _spd(rng, n)
    L = linalg.blocked_cholesky(torch.as_tensor(A), nb).numpy()
    if n % nb == 0:
        ref = np.asarray(jax_linalg.blocked_cholesky(jnp.asarray(A), nb=nb))
    else:  # the JAX function takes aligned sizes only; the port's last block is smaller
        ref = np.linalg.cholesky(A)
    np.testing.assert_allclose(L, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('trans', [False, True])
def test_blocked_tri_solve_single_tensor(rng, trans):
    A = _spd(rng, 64)
    L = np.array(jnp.linalg.cholesky(jnp.asarray(A)))
    b = rng.normal(size=(64, 3))
    ours = linalg.blocked_tri_solve(torch.as_tensor(L), torch.as_tensor(b), 16, trans=trans).numpy()
    ref = np.asarray(jax_linalg.blocked_tri_solve(jnp.asarray(L), jnp.asarray(b), nb=16, trans=trans))
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_cho_solve_blocked_unaligned(rng):
    """n=70 is padded to a multiple of nb=32 by an identity extension."""
    A, b = _spd(rng, 70), rng.normal(size=70)
    ours = linalg.cho_solve_blocked(torch.as_tensor(A), torch.as_tensor(b), nb=32).numpy()
    ref = np.asarray(jax_linalg.cho_solve_blocked(jnp.asarray(A), jnp.asarray(b), nb=32))
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_row_strip_factor_matches_jax(world):
    inputs, ranks = world
    ref = np.asarray(jax_linalg.blocked_cholesky(jnp.asarray(inputs['A']), nb=16))
    for out in ranks:
        np.testing.assert_allclose(out['L'], ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('key, trans', [('y', False), ('z', True)])
def test_row_strip_tri_solves_match_jax(world, key, trans):
    inputs, ranks = world
    L = jax_linalg.blocked_cholesky(jnp.asarray(inputs['A']), nb=16)
    ref = np.asarray(jax_linalg.blocked_tri_solve(L, jnp.asarray(inputs['b']), nb=16, trans=trans))
    for out in ranks:  # whole on every rank
        np.testing.assert_allclose(out[key], ref, rtol=TOL, atol=TOL)


def test_row_strip_cho_solve_matches_jax(world):
    inputs, ranks = world
    ref = np.asarray(jax_linalg.cho_solve_blocked(jnp.asarray(inputs['A']), jnp.asarray(inputs['b']), nb=16))
    for out in ranks:
        np.testing.assert_allclose(out['x'], ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ranks[0]['x'], ranks[-1]['x'])


def test_cho_solve_blocked_2d_mesh(world):
    """Rows sharded over all four ranks of a 2 x 2 mesh (the JAX test shards
    P('r', 'c') over a 2 x 4 mesh of virtual devices)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sgdml_tpu.parallel.mesh import mesh_2d

    inputs, ranks = world
    mesh = mesh_2d(2, 4)
    A_sh = jax.device_put(jnp.asarray(inputs['A2']), NamedSharding(mesh, P('r', 'c')))
    ref = np.asarray(jax_linalg.cho_solve_blocked(A_sh, jnp.asarray(inputs['b2']), nb=16))
    for out in ranks:
        np.testing.assert_allclose(out['x2'], ref, rtol=1e-10, atol=1e-10)


def test_init_distributed_noop_by_default(monkeypatch):
    from sgdml_tpu.parallel.mesh import init_distributed as jax_init

    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    assert mesh_mod.init_distributed() is False and jax_init() is False
    assert not torch.distributed.is_initialized()


def test_mesh_needs_a_world_and_a_device_mesh():
    with pytest.raises(RuntimeError, match='init_distributed'):
        mesh_mod.default_mesh(2, device='cpu')
    with pytest.raises(TypeError, match='DeviceMesh'):
        linalg.cho_solve_blocked(torch.eye(4), torch.ones(4), nb=2, mesh=object())
