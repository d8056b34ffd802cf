"""Operations and bytes of the permutation-summed kernel assembly, from the
inputs alone (M training points, N atoms, P permutations), for
``assembly_roofline.train``.

K is symmetric, so the least an assembly can do is its lower triangle:
M (M + 1) / 2 geometry pairs, each a 3N x 3N Hessian block summed over the
P permutations. One (pair, permutation) block needs at least, with
D = N (N - 1) / 2 and J's two nonzero atoms per descriptor row:

* d = x_i - x_j^q and |d|^2: 3 D;
* J_i^T d and d^T J_j^q: each of the 3N entries sums the N - 1
  descriptors through its atom, 2 x 3N (N - 1) = 12 D apiece;
* the Jacobian Gram J_i^T J_j^q: one product for each of the 9 N (N - 1)
  entries of an off-diagonal atom block (18 D) and N - 1 products summed
  for each of the 9 N entries of a diagonal slot (36 D);
* the entries 5 b (J_i^T d)(d^T J_j^q)^T - (sig^2 + sig u) G: a product,
  a scaled Gram entry and their difference, 3 (3N)^2.

The block's scalars (the exponential, b and its factor) are left out. K's
lower triangle is written once in float64, at least 8 n (n + 1) / 2 bytes
for n = 3 N M. The bound is the longer of the two at the H100's peaks
(``counts.py``).
"""

from __future__ import annotations

from benchmark import counts

__all__ = ['assembly_bound_s', 'assembly_bytes', 'assembly_flops', 'block_flops']


def block_flops(n_atoms: int) -> float:
    """One (geometry pair, permutation) Hessian block: 81 D + 27 N^2."""
    dim_d = counts.descriptor_dim(n_atoms)
    return 81.0 * dim_d + 27.0 * n_atoms**2


def assembly_flops(m: int, n_atoms: int, n_perms: int) -> float:
    """The lower triangle's M (M + 1) / 2 pairs, P blocks each."""
    return m * (m + 1) / 2.0 * n_perms * block_flops(n_atoms)


def assembly_bytes(m: int, n_atoms: int) -> float:
    """K's lower triangle written once in float64."""
    n = 3 * n_atoms * m
    return 8.0 * n * (n + 1) / 2.0


def assembly_bound_s(m: int, n_atoms: int, n_perms: int) -> float:
    """Least seconds of the assembly on an H100."""
    return counts.dense_bound_s(assembly_flops(m, n_atoms, n_perms), assembly_bytes(m, n_atoms))
