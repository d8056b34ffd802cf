"""The operation and byte counts against hand counts."""

from __future__ import annotations

import pytest

from benchmark import counts


def test_k1_counts_by_hand():
    # AT-AT, one geometry against 3,000 training points: 8 * 1 * 3000 * 1770.
    assert counts.k1_flops(1, 3000, 1770) == 42_480_000
    # Bytes in float64: B D + 2 T D + 2 T + B + B D = 1770 + 10,620,000 + 6000 + 1 + 1770.
    assert counts.k1_bytes(1, 3000, 1770, 8) == 8 * 10_629_541
    # At B=1 the bytes bound it, at B=512 the operations.
    assert counts.k1_bound_s(1, 3000, 1770) == pytest.approx(8 * 10_629_541 / 3.35e12)
    assert counts.k1_bound_s(512, 3000, 1770) == pytest.approx(8 * 512 * 3000 * 1770 / 67e12)


def test_a_request_is_bounded_by_its_geometries_not_its_buckets():
    # 1,500 geometries at batch 1024: a chunk of 1024 and one of 476.
    assert counts.request_bound_s(1500, 1024, 3000, 1770) == pytest.approx(
        counts.k1_bound_s(1024, 3000, 1770) + counts.k1_bound_s(476, 3000, 1770))
    assert counts.request_bound_s(1024, 1024, 3000, 1770) == counts.k1_bound_s(1024, 3000, 1770)


def test_dense_and_cg_counts_by_hand():
    assert counts.cholesky_flops(63_000) == pytest.approx(63_000**3 / 3)
    assert counts.cholesky_flops(63_000) / counts.H100_FLOPS == pytest.approx(1.2440, rel=1e-4)
    assert counts.dense_bound_s(67e12, 0.0) == 1.0 and counts.dense_bound_s(0.0, 3.35e12) == 1.0
    n, k = 108_000, 3_780
    assert counts.nystrom_build_flops(n, k) == pytest.approx(2 * k**3 / 3 + 3 * n * k**2)
    assert counts.cg_iteration_flops(600, 1, 1770, n, k) == 8 * 600 * 600 * 1770 + 4 * n * k
    assert counts.descriptor_dim(21) == 210 and counts.descriptor_dim(60) == 1770
