"""The port's block-cyclic Cholesky (``ops/cyclic.py``) on contiguous row
strips over a gloo world of four CPU ranks against ``sgdml_tpu.ops.cyclic``
on ``default_mesh(4)`` of the conftest's virtual CPU devices and against the
dense factor, at ``tests/test_cyclic.py``'s tilings and bounds (the factor
to ``1e-9 n``, the padded solve to 1e-8); the row permutation equal to the
JAX package's; and ``solve_interleaved(layout='cyclic')`` against the masked
layout and the JAX package's cyclic solve on ``tests/test_cyclic.py``'s
kernel system. Without a mesh the functions work on one tensor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdml_tpu.ops import cyclic as jax_cyclic
from sgdml_tpu.parallel import spmd as jax_spmd
from sgdml_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sgdml_tpu_torch.datasets.synthetic import generate_md_dataset
from sgdml_tpu_torch.ops import cyclic
from sgdml_tpu_torch.ops import descriptor as desc_ops

from torch_mesh_worker import run_world

# (nb, n_blocks) of tests/test_cyclic.py: on four ranks one, two and four
# slots a rank (the first with a ragged trailing set at every step).
TILINGS = [(16, 4), (16, 8), (8, 16), (8, 8)]
N_ATOMS, M = 5, 12


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    return B @ B.T + n * np.eye(n)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The tilings' matrices, a padded system (n=152 over 4 ranks at nb=8:
    padded to 160), and tests/test_cyclic.py's kernel system (N=5, M=12),
    run once through a four-rank world."""
    tmp = tmp_path_factory.mktemp('cyclic')
    inp = {'n_cases': len(TILINGS)}
    for i, (nb, n_blocks) in enumerate(TILINGS):
        inp['A%d' % i], inp['nb%d' % i] = _spd(nb * n_blocks), nb
    inp['A_pad'], inp['b_pad'] = _spd(152, seed=3), np.random.default_rng(4).standard_normal(152)
    ds = generate_md_dataset(n_atoms=N_ATOMS, n_frames=M, seed=2)
    X, Jc = desc_ops.descriptor_batch(torch.as_tensor(ds['R'][:M].reshape(M, -1)), N_ATOMS)
    inp.update(X=X.numpy(), Jc=Jc.numpy(), dperms=np.arange(N_ATOMS * (N_ATOMS - 1) // 2)[None],
               y=np.random.default_rng(8).standard_normal(M * 3 * N_ATOMS))
    np.savez(tmp / 'cyclic_inputs.npz', **inp)
    return inp, run_world('cyclic', 4, tmp)


@pytest.mark.parametrize('n_blocks, nb, n_dev', [(8, 4, 4), (8, 4, 2), (16, 8, 8), (4, 16, 1), (6, 3, 3)])
def test_cyclic_row_perm_matches_jax(n_blocks, nb, n_dev):
    perm = cyclic.cyclic_row_perm(n_blocks, nb, n_dev)
    np.testing.assert_array_equal(perm, jax_cyclic.cyclic_row_perm(n_blocks, nb, n_dev))
    assert sorted(perm.tolist()) == list(range(n_blocks * nb))
    for k in range(n_blocks):
        assert cyclic._u_start(k, n_dev) == jax_cyclic._u_start(k, n_dev)


@pytest.mark.parametrize('case', range(len(TILINGS)))
def test_factor_matches_dense_and_jax(world, case):
    """Gathered strips against ``np.linalg.cholesky`` (``1e-9 n``, the JAX
    test's bound) and the JAX package's cyclic factor on four devices, with
    zeros above the diagonal."""
    inp, ranks = world
    A, nb = inp['A%d' % case], int(inp['nb%d' % case])
    n = A.shape[0]
    ref = np.linalg.cholesky(A)
    jax_L = np.asarray(jax_cyclic.blocked_cholesky_cyclic(jnp.asarray(A), nb, jax_default_mesh(4)))
    for out in ranks:
        L = out['L%d' % case]
        assert np.allclose(L, ref, atol=1e-9 * n) and np.allclose(L, jax_L, atol=1e-9 * n)
        assert not np.triu(L, 1).any()
    np.testing.assert_array_equal(ranks[0]['L%d' % case], ranks[-1]['L%d' % case])


@pytest.mark.parametrize('nb, n_blocks', TILINGS)
def test_factor_on_one_tensor(nb, n_blocks):
    """Without a mesh (one rank's layout, the identity): the dense factor,
    the input left as it is; a size that does not tile raises."""
    A = torch.as_tensor(_spd(nb * n_blocks))
    A0 = A.clone()
    L = cyclic.blocked_cholesky_cyclic(A, nb).numpy()
    assert np.allclose(L, np.linalg.cholesky(A0.numpy()), atol=1e-9 * A.shape[0])
    assert torch.equal(A, A0)
    with pytest.raises(ValueError, match='must tile'):
        cyclic.blocked_cholesky_cyclic(A[:-1, :-1], nb)


def test_cho_solve_cyclic_padded(world):
    """n=152 on four ranks at nb=8 exercises the identity extension (to 160):
    within 1e-8 of the dense solve (tests/test_cyclic.py's bound) and of the
    JAX package's padded solve; on one tensor (n=150) as well."""
    inp, ranks = world
    A, b = inp['A_pad'], inp['b_pad']
    want = np.linalg.solve(A, b)
    jax_x = np.asarray(jax_cyclic.cho_solve_cyclic(jnp.asarray(A), jnp.asarray(b), 8, jax_default_mesh(4)))
    for out in ranks:
        assert np.allclose(out['x_pad'], want, atol=1e-8) and np.allclose(out['x_pad'], jax_x, atol=1e-8)
    A150, b150 = _spd(150, seed=3), np.random.default_rng(4).standard_normal(150)
    x = cyclic.cho_solve_cyclic(torch.as_tensor(A150), torch.as_tensor(b150), 8).numpy()
    assert np.allclose(x, np.linalg.solve(A150, b150), atol=1e-8)


def test_solve_interleaved_cyclic_layout(world):
    """``layout='cyclic'`` on the four ranks' interleaved kernel strips at
    the JAX package's block size (the whole system, padded to four blocks)
    against the masked layout (1e-9 of max |alpha|, tests/test_cyclic.py's
    bound). Where the factor sums in another order (at nb=30: 12 blocks,
    three a rank) or the kernel was assembled by the JAX package (4.5e-16
    apart), the coefficients move by about 3e-7 at this system's condition
    number (lam 1e-10, one permutation): there the relative residual of
    each solve, 3.2e-7 for the JAX package's own, and the fits' difference
    are held to 1e-6."""
    inp, ranks = world
    K, lay = jax_spmd.assemble_kernel_sharded(jnp.asarray(inp['X']), jnp.asarray(inp['Jc']), inp['dperms'], 5.0,
                                              N_ATOMS, jax_default_mesh(4))
    jax_a = np.asarray(jax_spmd.solve_interleaved(K, inp['y'], 1e-10, lay, layout='cyclic'))
    K1 = np.asarray(K)[np.ix_(lay.from_std, lay.from_std)]
    for out in ranks:
        masked = out['masked']
        assert np.abs(out['cyclic'] - masked).max() / np.abs(masked).max() < 1e-9
        for a, ref in ((out['cyclic'], jax_a), (out['cyclic_nb30'], masked)):
            r = (-K1 + 1e-10 * np.eye(K1.shape[0])) @ (-a) - inp['y']
            assert np.linalg.norm(r) / np.linalg.norm(inp['y']) < 1e-6
            fit = K1 @ ref
            assert np.abs(K1 @ a - fit).max() / np.abs(fit).max() < 1e-6
