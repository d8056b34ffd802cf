"""Operations and bytes the algorithms need, and the H100's peaks.

Each count is what the inputs need, not what a kernel happens to do: an
H100 can do no better than these at its published peaks, so a share of the
roofline computed from them cannot pass 100% unless the time leaves out work.
``k1_bound`` is the arithmetic of ``chip_smoke.bound`` (PERF.md's table of
kernels), copied so that the program cannot change the yardstick.
"""

from __future__ import annotations

__all__ = [
    'H100_FLOPS', 'H100_BYTES_PER_S', 'descriptor_dim', 'k1_flops', 'k1_bytes', 'k1_bound_s', 'request_bound_s',
    'cholesky_flops', 'dense_bound_s', 'nystrom_build_flops', 'cg_iteration_flops',
]

# NVIDIA's data sheet, H100 SXM at 700 W: FP64 tensor-core and FP32 peaks
# alike, and HBM3 bandwidth.
H100_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def descriptor_dim(n_atoms: int) -> int:
    """D = N (N - 1) / 2 inverse pairwise distances."""
    return n_atoms * (n_atoms - 1) // 2


def k1_flops(B: int, T: int, D: int) -> float:
    """The contraction of B queries against T table rows of width D: the
    five (B, T)-by-D products, 8 B T D operations."""
    return 8.0 * B * T * D


def k1_bytes(B: int, T: int, D: int, itemsize: int) -> float:
    """Each input read once (queries B D, tables 2 T D, the table terms 2 T)
    and each output written once (E B, F_d B D)."""
    return float(itemsize * (B * D + 2 * T * D + 2 * T + B + B * D))


def k1_bound_s(B: int, T: int, D: int, itemsize: int = 8) -> float:
    """Least seconds of one contraction: operations at the peak or bytes at
    the bandwidth, whichever is longer."""
    return max(k1_flops(B, T, D) / H100_FLOPS, k1_bytes(B, T, D, itemsize) / H100_BYTES_PER_S)


def request_bound_s(B: int, batch_size: int, T: int, D: int, itemsize: int = 8) -> float:
    """K1's least seconds for a request of B geometries, served in chunks of
    at most ``batch_size``: the geometries actually requested, not the
    padded bucket."""
    full, rest = divmod(B, batch_size)
    return full * k1_bound_s(batch_size, T, D, itemsize) + (k1_bound_s(rest, T, D, itemsize) if rest else 0.0)


def cholesky_flops(n: int) -> float:
    """A Cholesky factor of an n x n matrix: n^3 / 3."""
    return n**3 / 3.0


def dense_bound_s(flops: float, n_bytes: float) -> float:
    """Least seconds of work that needs ``flops`` and moves ``n_bytes``."""
    return max(flops / H100_FLOPS, n_bytes / H100_BYTES_PER_S)


def nystrom_build_flops(n: int, k: int) -> float:
    """The Nystrom factor from k kernel columns of n rows: the Cholesky of
    W (k^3 / 3), the whitening L_W^-1 C^T (n k^2), the symmetric Gram
    Y Y^T (n k^2), its Cholesky (k^3 / 3) and F = L^-1 Y (n k^2). The
    columns' assembly is not counted."""
    return 2.0 * k**3 / 3.0 + 3.0 * n * k**2


def cg_iteration_flops(m: int, n_perms: int, D: int, n: int, k: int) -> float:
    """One CG iteration: the matvec, K1 over all m training points against
    the m P table rows, and the Woodbury apply, two products with the
    (k, n) factor (4 n k)."""
    return k1_flops(m, m * n_perms, D) + 4.0 * n * k
