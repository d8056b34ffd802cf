"""Fused (E, F) inference contraction: CUDA kernel wrappers and plain versions.

The kernel (``csrc/fused_predict.cu``) replaces the TPU kernel
``sgdml_tpu/ops/pallas_predict.py:_kernel`` and computes, on table-mean
centered inputs, the unscaled energies ``E_raw (B,)`` and descriptor-space
forces ``F_d (B, D)`` of ``sgdml_tpu/predict.py:_predict_from_tables_body``
-- the energy-constraint term included. ``fused_predict_tables`` launches it
for CUDA tensors and runs :func:`fused_predict_tables_reference`, the plain
PyTorch version, for CPU tensors.

It has three routes, picked by :func:`route` from the batch B and the
descriptor width D: :func:`split_t` for small B, the table rows spread over
the card and the blocks' partial sums added by a second small kernel;
:func:`wide` for up to :data:`WIDE_MAX_B` queries, each too wide for split
T, the table rows spread over thread-block clusters and each row's columns
over a cluster's blocks; and :func:`two_pass` for the rest, two tiled
products with the ``(B, T)`` coefficient planes in device memory between
them. The two-pass route's passes also launch on their own (:func:`planes`,
:func:`forces`). Each of :func:`split_t`, :func:`wide`, :func:`planes` and
:func:`forces` has a plain version beside it (:func:`split_t_reference`,
:func:`wide_reference`, :func:`planes_reference`, :func:`forces_reference`)
that mirrors the kernel's scratch layout, its partial sums and the order in
which it adds them.

:func:`md_step` is one velocity-Verlet step of MD at B = 1 in one launch:
the split-T kernel with the drift and the descriptor before its rows and
the reduction, the Jacobian-transpose map and the kick after them
(``csrc/fused_predict.cu``: ``NveStep``); :func:`md_step_reference` is its
plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch
import torch.nn.functional as nnf

from ..utils import profiling
from . import _build
from . import descriptor as desc_ops
from .kernel import Mat52Coeffs

__all__ = [
    'K_STEP', 'LAUNCHES', 'MDStepWork', 'PATH_LAUNCHES', 'SPLIT_T_MAX_B', 'TILE', 'WIDE_MAX_B',
    'count_replay', 'fused_predict_tables', 'fused_predict_tables_reference', 'forces',
    'forces_reference', 'md_step', 'md_step_reference', 'planes', 'planes_reference',
    'recording_launches', 'reset_launches', 'route', 'split_k', 'split_t', 'split_t_blocks',
    'split_t_reference', 'two_pass', 'wide', 'wide_reference',
]

_SQRT5 = math.sqrt(5.0)

# Tiling of the two-pass route (csrc/fused_predict.cu: TILE, BK): rows and
# columns of a block tile, and the depth of one pipeline stage, which is the
# unit in which pass B's K axis is split.
TILE = 64
K_STEP = 16

# The split-T route (csrc/fused_predict.cu: ST_WARPS, ST_RUNS): the warps of
# a block, one table row each at a time, so that a block owns at least this
# many rows; the blocks it launches for each SM (two hold more loads in
# flight where a block has several chunks of rows); the runs of consecutive
# blocks whose partials its reduction adds first, then the runs in order.
SPLIT_T_WARPS = 8
SPLIT_T_BLOCKS_PER_SM = 2
SPLIT_T_REDUCE_RUNS = 32

# Batches of up to SPLIT_T_MAX_B queries whose f64 descriptors (B x D) take
# up to SPLIT_T_XQ_BYTES take the split-T route; others the two-pass route.
# Set from both routes' times on an H100 at B = 1 ... 64 (PERF.md, section
# 6): split T is the fastest up to B = 16 at D = 210 and D = 36, and up to
# B = 4 at D = 1770 (4 x 1770 x 8 bytes; at B = 8 the two-pass route wins).
SPLIT_T_MAX_B = 16
SPLIT_T_XQ_BYTES = 64 * 1024

# The wide route (csrc/fused_predict.cu: WD_CLUSTER, WD_LOAD_THREADS,
# WD_COLS): the blocks of a cluster, each owning a slice of ceil(D /
# WIDE_CLUSTER) descriptor columns, held WIDE_COLS a thread by its
# WIDE_THREADS loader threads, so it takes D up to 11,520 (152 atoms); and
# the queries of its largest instance, Wide<4> (csrc/fused_predict.cu:
# wide_takes).
# Batches of up to WIDE_MAX_B queries take it where a query alone is too wide
# for split T (D > SPLIT_T_XQ_BYTES / 8: 129 atoms and more) and the kernel
# takes their width. Set from the routes' times on an H100 at the buckyball
# catcher's width: at B = 1, 2 and 4 the wide route beats two passes 12-19
# times over (PERF.md, section 6). Narrower batches that split T turns away
# for their count (B * D * 8 bytes) were not measured and keep two passes.
WIDE_CLUSTER = 4
WIDE_THREADS = 480
WIDE_COLS = 6
WIDE_MAX_B = 4
# The runs of the wide route's reduction (csrc/fused_predict.cu:
# WD_REDUCE_RUNS): consecutive cluster partials added in runs, then the
# runs in order, as split T's reduction adds its blocks' in
# SPLIT_T_REDUCE_RUNS runs.
WIDE_REDUCE_RUNS = 4

# The pass B grid is split along K until it has at least as many blocks as the
# card has SMs, while each split keeps at least this many K steps.
_MIN_SPLIT_STEPS = 8

# Kernel launches in this process. LAUNCHES counts calls of the contraction
# that launched any route (an MD step is one); PATH_LAUNCHES counts each kernel's launches, in
# the wrapper that launches it and nowhere else, so that a run can show which
# kernels its path went through. A launch enqueued while a CUDA graph is
# captured does not run then but at each replay: the capture records it
# (``recording_launches``) and each replay counts it (``count_replay``).
# While a profiler session records, the same counts also go to the
# recorder's counters ``k1.launches`` and ``k1.wide_launches``.
LAUNCHES = 0
PATH_LAUNCHES = {'pass_a': 0, 'pass_b': 0, 'split_t': 0, 'md_step': 0, 'wide': 0}
_RECORDING = []  # the counts of the graph being captured


def reset_launches():
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for key in PATH_LAUNCHES:
        PATH_LAUNCHES[key] = 0


def _add(counts):
    """Add ``counts`` (``{'total': n, 'pass_a': n, ...}``) to the launch
    counts, and to the recorder's while a profiler session is on."""
    global LAUNCHES
    LAUNCHES += counts.get('total', 0)
    for key in PATH_LAUNCHES:
        PATH_LAUNCHES[key] += counts.get(key, 0)
    profiling.count('k1.launches', counts.get('total', 0))
    profiling.count('k1.wide_launches', counts.get('wide', 0))


@contextlib.contextmanager
def recording_launches():
    """Record, and do not count, the launches made in the block, which
    captures a CUDA graph: its kernels run at each replay, not now. Yields
    the recorded counts; :func:`count_replay` counts them at each replay."""
    recorded = {}
    _RECORDING.append(recorded)
    try:
        yield recorded
    finally:
        _RECORDING.pop()


def count_replay(recorded):
    """Count the launches of one replay of a graph whose capture recorded
    ``recorded``."""
    _add(recorded)


def _count(counts, capturing):
    """Count the launches ``counts`` just enqueued, or record them while a
    graph is captured (``capturing``). A capture outside
    :func:`recording_launches`, or a recording without one, raises: the
    graph's replays would go uncounted, or launches that ran would."""
    if capturing != bool(_RECORDING):
        raise RuntimeError(
            'K1 launched %s a CUDA graph capture %s fused_predict.recording_launches(): its launches '
            'would be miscounted' % (('inside', 'outside') if capturing else ('outside', 'inside'))
        )
    if not capturing:
        _add(counts)
        return
    recorded = _RECORDING[-1]
    for key, n in counts.items():
        recorded[key] = recorded.get(key, 0) + n


def _cdiv(a, b):
    return -(-a // b)


def _split_t_takes(B: int, D: int, itemsize: int) -> bool:
    """Whether the split-T kernel takes B queries of width D: at most 16
    (its largest instance, the route's SPLIT_T_MAX_B), whose descriptors
    and planes fit a block's shared memory on sm_90 (227 KB;
    csrc/fused_predict.cu:launch_split_t_b)."""
    maxb = 1 if B == 1 else 4 if B <= 4 else 16  # the kernel's instance
    return B <= 16 and itemsize * (3 * maxb * SPLIT_T_WARPS + maxb + B * D) <= 227 * 1024


def _wide_takes(B: int, D: int) -> bool:
    """Whether the wide kernel takes B queries of width D: at most
    :data:`WIDE_MAX_B` (its largest instance), each block's slice of
    ceil(D / WIDE_CLUSTER) columns in WIDE_COLS a thread
    (csrc/fused_predict.cu:wide_takes)."""
    return 1 <= B <= WIDE_MAX_B and 1 <= D and _cdiv(D, WIDE_CLUSTER) <= WIDE_COLS * WIDE_THREADS


def route(D: int, B: int) -> str:
    """``'split_t'`` for at most :data:`SPLIT_T_MAX_B` queries of at most
    :data:`SPLIT_T_XQ_BYTES` of f64 descriptors; else ``'wide'`` for
    queries each wider than those bytes, as many and as wide as the wide
    kernel takes; ``'two_pass'`` otherwise."""
    if B <= SPLIT_T_MAX_B and B * D * 8 <= SPLIT_T_XQ_BYTES:
        return 'split_t'
    return 'wide' if D * 8 > SPLIT_T_XQ_BYTES and _wide_takes(B, D) else 'two_pass'


def split_t_blocks(T: int, n_sms: int) -> int:
    """The split-T route's blocks: the T table rows cut into runs of
    ``ceil(T / blocks)``, :data:`SPLIT_T_BLOCKS_PER_SM` blocks for each SM,
    or fewer so that each block has a row for each of its
    :data:`SPLIT_T_WARPS` warps."""
    return _cdiv(T, max(SPLIT_T_WARPS, _cdiv(T, SPLIT_T_BLOCKS_PER_SM * n_sms)))


def split_k(B: int, D: int, T: int, n_sms: int):
    """``(splits, per)``: pass B cuts its ``K = 2 Tp`` axis (``Tp`` is T
    rounded up to :data:`TILE`) into ``splits`` runs of ``per`` K steps
    each, the last one possibly shorter and none empty."""
    n_k = 2 * _cdiv(T, TILE) * TILE // K_STEP
    blocks = _cdiv(B, TILE) * _cdiv(D, TILE)
    want = 1 if blocks >= n_sms else min(_cdiv(n_sms, blocks), max(1, n_k // _MIN_SPLIT_STEPS))
    per = _cdiv(n_k, want)
    return _cdiv(n_k, per), per


def _check_kind(x, name):
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('%s takes CPU or CUDA tensors, got %s' % (name, x.device))
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError('%s takes float32 or float64, got %s' % (name, x.dtype))


def _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin):
    _check_kind(Xq, 'fused_predict_tables')
    if Xq.dim() != 2:
        raise ValueError('Xq must be (B, D), got shape %s' % (tuple(Xq.shape),))
    B, D = Xq.shape
    T = Xt.shape[0]
    if B == 0 or T == 0 or D == 0:
        raise ValueError('empty input: B=%d, T=%d, D=%d' % (B, T, D))
    named = {'Xq': (Xq, (B, D)), 'Xt': (Xt, (T, D)), 'JA': (JA, (T, D)),
             'xt_sq': (xt_sq, (T,)), 'tja': (tja, (T,))}
    if alphas_E_lin is not None:
        named['alphas_E_lin'] = (alphas_E_lin, (T,))
    _check_named(Xq, named)


def _check_named(Xq, named):
    for name, (x, shape) in named.items():
        if tuple(x.shape) != shape:
            raise ValueError('%s has shape %s, expected %s' % (name, tuple(x.shape), shape))
        if x.device != Xq.device or x.dtype != Xq.dtype:
            raise ValueError(
                '%s is %s on %s; Xq is %s on %s' % (name, x.dtype, x.device, Xq.dtype, Xq.device)
            )
        if Xq.device.type == 'cuda' and not x.is_contiguous():
            raise ValueError('%s must be contiguous for the CUDA kernel' % name)


def _device_args(x):
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(x.device).cuda_stream


def fused_predict_tables_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig, with_forces=True, matmul=torch.matmul):
    """Plain PyTorch version of the kernel, line for line with
    ``sgdml_tpu/predict.py:158-186`` after the centering.

    Xq ``(B, D)`` and Xt ``(T, D)`` are centered on the table mean; JA
    ``(T, D)``; ``xt_sq = |Xt|^2`` and ``tja = <Xt, JA>`` per table row
    ``(T,)``; alphas_E_lin ``(T,)`` or None. Returns ``E_raw (B,)`` and
    ``F_d (B, D)`` (None without forces). ``matmul`` computes the five
    ``(B, T)``-sized products (``torch.matmul`` by default; the Ozaki rungs
    of ``predict_from_tables`` pass their int8 product).
    """
    # A fill, not a copy from the host: the CG chunk's CUDA graphs capture
    # this function on the Ozaki rungs, and a capture takes no such copy.
    sig = torch.full((), sig, dtype=Xq.dtype, device=Xq.device)

    xq_sq = torch.sum(Xq * Xq, dim=1)  # (B,)
    gram = matmul(Xq, Xt.T)  # (B, T)
    u2 = torch.clamp_min(xq_sq[:, None] - 2.0 * gram + xt_sq[None, :], 0.0)
    u5 = _SQRT5 * torch.sqrt(u2)

    e = torch.exp(-u5 / sig)
    b1 = (5.0 / (3.0 * sig**3)) * e  # gradient-kernel base
    w2 = b1 * (u5 + sig)

    a = matmul(Xq, JA.T) - tja[None, :]  # (B, T): d.(J alpha), centering-invariant

    E = torch.sum(a * w2, dim=1)

    if alphas_E_lin is not None:
        k_ee = Mat52Coeffs.value(u5, sig)
        E = E + k_ee @ alphas_E_lin

    if not with_forces:
        return E, None

    w1 = a * b1 * (5.0 / sig)
    F_d = torch.sum(w1, dim=1)[:, None] * Xq - matmul(w1, Xt)  # (B, D)
    F_d = F_d - matmul(w2, JA)

    if alphas_E_lin is not None:
        w3 = w2 * alphas_E_lin[None, :]
        F_d = F_d + torch.sum(w3, dim=1)[:, None] * Xq - matmul(w3, Xt)

    return E, F_d


def _plane_terms(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """The ``(B, T)`` planes of the kernel's ``plane_terms``: the energy
    term ``ep``, ``cx = w1 + w3`` and ``cj = w2``."""
    return _planes_from_dots(Xq @ Xt.T, Xq @ JA.T, torch.sum(Xq * Xq, dim=1), xt_sq, tja, alphas_E_lin, sig)


def _planes_from_dots(gram, q, xq_sq, xt_sq, tja, alphas_E_lin, sig):
    """:func:`_plane_terms` from the dots ``gram = Xq Xt^T``, ``q = Xq JA^T``
    ``(B, T)`` and ``xq_sq = |Xq|^2 (B,)``."""
    sig = torch.as_tensor(sig, dtype=gram.dtype, device=gram.device)
    u2 = torch.clamp_min(xq_sq[:, None] - 2.0 * gram + xt_sq[None, :], 0.0)
    u5 = _SQRT5 * torch.sqrt(u2)
    b1 = (5.0 / (3.0 * sig**3)) * torch.exp(-u5 / sig)
    cj = b1 * (u5 + sig)
    a = q - tja[None, :]
    ep = a * cj
    cx = a * b1 * (5.0 / sig)
    if alphas_E_lin is not None:
        ep = ep + Mat52Coeffs.value(u5, sig) * alphas_E_lin[None, :]
        cx = cx + cj * alphas_E_lin[None, :]
    return ep, cx, cj


def planes_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """Plain version of pass A. Returns ``planes (B, 2 Tp)`` -- ``cx = w1 +
    w3`` in columns ``[0, Tp)`` and ``cj = w2`` in ``[Tp, 2 Tp)``, zero past
    T, with ``Tp`` = T rounded up to :data:`TILE` -- and the row sums of the
    energy term and of ``cx`` over each TILE-wide block of table rows,
    ``e_part`` and ``s_part (B, Tp / TILE)``."""
    B, T = Xq.shape[0], Xt.shape[0]
    pad = _cdiv(T, TILE) * TILE - T
    ep, cx, cj = _plane_terms(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig)
    ep, cx, cj = (nnf.pad(x, (0, pad)) for x in (ep, cx, cj))
    return (torch.cat([cx, cj], dim=1),
            ep.reshape(B, -1, TILE).sum(-1), cx.reshape(B, -1, TILE).sum(-1))


def forces_reference(Xq, Xt, JA, planes, e_part, s_part, splits, per):
    """Plain version of pass B and its reduction: ``E_raw = sum_j e_part``
    and ``F_d = (sum_j s_part) Xq - sum_s planes[:, K_s] @ [Xt ; JA][K_s]``,
    the K axis cut as :func:`split_k` says (``per`` steps of
    :data:`K_STEP` per split) and the splits added in order."""
    Tp = planes.shape[1] // 2
    pad = Tp - Xt.shape[0]
    W = torch.cat([nnf.pad(Xt, (0, 0, 0, pad)), nnf.pad(JA, (0, 0, 0, pad))])  # (2 Tp, D)
    acc = None
    for s in range(splits):
        k0, k1 = s * per * K_STEP, min(2 * Tp, (s + 1) * per * K_STEP)
        part = planes[:, k0:k1] @ W[k0:k1]
        acc = part if acc is None else acc + part
    return e_part.sum(1), s_part.sum(1)[:, None] * Xq - acc


def split_t_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig, blocks):
    """Plain version of the split-T route, ``(E_raw (B,), F_d (B, D))``.

    The T table rows are cut into ``blocks`` runs of ``ceil(T / blocks)``
    (runs past T are empty); each run gives the kernel's block partial
    ``[sum_t cx xt + cj ja, sum_t ep, sum_t cx]`` ``(blocks, B, D + 2)``.
    These are added as the reduction adds them: runs of ``ceil(blocks /``
    :data:`SPLIT_T_REDUCE_RUNS` ``)`` consecutive blocks each, then the runs
    in order; ``E_raw`` is the ``ep`` column, ``F_d = (sum cx) Xq - sum``.
    """
    (B, D), T = Xq.shape, Xt.shape[0]
    rows = _cdiv(T, blocks)
    pad = blocks * rows - T
    ep, cx, cj = (nnf.pad(x, (0, pad)).reshape(B, blocks, rows)
                  for x in _plane_terms(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig))
    Xt_b, JA_b = (nnf.pad(x, (0, 0, 0, pad)).reshape(blocks, rows, D) for x in (Xt, JA))
    part = torch.cat([torch.einsum('bjr,jrd->jbd', cx, Xt_b) + torch.einsum('bjr,jrd->jbd', cj, JA_b),
                      ep.sum(2).T[:, :, None], cx.sum(2).T[:, :, None]], dim=2)
    return _reduce_parts(part, Xq, SPLIT_T_REDUCE_RUNS)


def _reduce_parts(part, Xq, runs):
    """``(E_raw, F_d)`` from the partials ``part (blocks, B, D + 2)`` as the
    reduction kernel of ``runs`` runs adds them: runs of ``ceil(blocks /
    runs)`` consecutive partials each, then the runs in order."""
    blocks, D = part.shape[0], Xq.shape[1]
    per = _cdiv(blocks, runs)
    total = None
    for j0 in range(0, blocks, per):
        run = part[j0:j0 + per].sum(0)
        total = run if total is None else total + run
    return total[:, D], total[:, D + 1, None] * Xq - total[:, :D]


def wide_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig, clusters):
    """Plain version of the wide route, ``(E_raw (B,), F_d (B, D))``.

    The D columns are cut into :data:`WIDE_CLUSTER` slices of ``ceil(D /
    WIDE_CLUSTER)`` (a cluster's blocks; slices past D are empty), and each
    slice's partial dots ``xq.xt``, ``xq.ja`` and ``|xq|^2`` are added in
    slice order before the planes are formed. The T table rows are cut
    into ``clusters`` runs, run g the rows ``[g T // clusters, (g + 1) T //
    clusters)``; each gives the partial ``[sum_t cx xt + cj ja, sum_t ep,
    sum_t cx]``, and these are added as the reduction adds them, in
    :data:`WIDE_REDUCE_RUNS` runs.
    """
    (B, D), T = Xq.shape, Xt.shape[0]
    width = _cdiv(D, WIDE_CLUSTER)
    dots = None
    for rank in range(WIDE_CLUSTER):
        cols = slice(rank * width, min(D, (rank + 1) * width))
        xq = Xq[:, cols]
        part = (xq @ Xt[:, cols].T, xq @ JA[:, cols].T, torch.sum(xq * xq, dim=1))
        dots = part if dots is None else tuple(a + b for a, b in zip(dots, part))
    ep, cx, cj = _planes_from_dots(*dots, xt_sq, tja, alphas_E_lin, sig)
    ends = [g * T // clusters for g in range(clusters + 1)]
    part = torch.stack([torch.cat([cx[:, t0:t1] @ Xt[t0:t1] + cj[:, t0:t1] @ JA[t0:t1],
                                   ep[:, t0:t1].sum(1, keepdim=True), cx[:, t0:t1].sum(1, keepdim=True)], dim=1)
                        for t0, t1 in zip(ends, ends[1:])])
    return _reduce_parts(part, Xq, WIDE_REDUCE_RUNS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _wide_max_clusters(index: int, dtype: torch.dtype, B: int) -> int:
    """The clusters of the wide kernel's instance for B queries that the card
    runs at once (every SM it can use, one block each)."""
    lib, n = _build.load_library(), ctypes.c_int(0)
    err = getattr(lib, 'sgdml_wide_clusters' + ('_f64' if dtype == torch.float64 else '_f32'))(
        B, index, ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError('the wide kernel fits no cluster on device %d: CUDA error %d (%s)'
                           % (index, err, lib.sgdml_cuda_error_string(err).decode()))
    return n.value


def _ptr(x):
    return None if x is None else x.data_ptr()


def _call(lib, stem, paths, x, *args, contraction=False):
    """Call ``lib.<stem>_f32`` or ``_f64`` (by x's dtype); count one launch
    of each kernel in ``paths``, and one of the contraction (``LAUNCHES``)
    with ``contraction``."""
    err = getattr(lib, stem + ('_f64' if x.dtype == torch.float64 else '_f32'))(*args)
    if err != 0:
        raise RuntimeError(
            'fused_predict kernel (%s) launch failed: CUDA error %d (%s)'
            % ('+'.join(paths), err, lib.sgdml_cuda_error_string(err).decode())
        )
    counts = dict.fromkeys(paths, 1)
    if contraction:
        counts['total'] = 1
    _count(counts, torch.cuda.is_current_stream_capturing())


# The route launchers take checked CUDA tensors, the library and the (device
# index, stream) pair, and allocate only their outputs and scratch.

def _launch_two_pass(lib, dev, Xq, Xt, JA, xt_sq, tja, aE, sig):
    """Pass A then pass B in one call, their scratch in one allocation."""
    (B, D), T = Xq.shape, Xt.shape[0]
    n_t = _cdiv(T, TILE)
    splits, per = split_k(B, D, T, _sm_count(dev[0]))
    scratch = torch.empty(B * (2 * n_t * TILE + 2 * n_t + splits * D), dtype=Xq.dtype,
                          device=Xq.device)
    E = torch.empty(B, dtype=Xq.dtype, device=Xq.device)
    F_d = torch.empty(B, D, dtype=Xq.dtype, device=Xq.device)
    _call(lib, 'sgdml_two_pass', ('pass_a', 'pass_b'), Xq, Xq.data_ptr(), Xt.data_ptr(),
          JA.data_ptr(), xt_sq.data_ptr(), tja.data_ptr(), _ptr(aE), float(sig), B, T, D,
          splits, per, scratch.data_ptr(), E.data_ptr(), F_d.data_ptr(), *dev, contraction=True)
    return E, F_d


def _launch_split_t(lib, dev, Xq, Xt, JA, xt_sq, tja, aE, sig, blocks=None):
    """The split-T kernel and its reduction; the block partials in one
    scratch allocation."""
    (B, D), T = Xq.shape, Xt.shape[0]
    if blocks is None:
        blocks = split_t_blocks(T, _sm_count(dev[0]))
    part = torch.empty(blocks * B * (D + 2), dtype=Xq.dtype, device=Xq.device)
    E = torch.empty(B, dtype=Xq.dtype, device=Xq.device)
    F_d = torch.empty(B, D, dtype=Xq.dtype, device=Xq.device)
    _call(lib, 'sgdml_split_t', ('split_t',), Xq, Xq.data_ptr(), Xt.data_ptr(), JA.data_ptr(),
          xt_sq.data_ptr(), tja.data_ptr(), _ptr(aE), float(sig), B, T, D, blocks, part.data_ptr(),
          E.data_ptr(), F_d.data_ptr(), *dev, contraction=True)
    return E, F_d


def _launch_wide(lib, dev, Xq, Xt, JA, xt_sq, tja, aE, sig, clusters=None):
    """The wide kernel and its reduction; the cluster partials in one
    scratch allocation. By default one cluster for each that the card runs
    at once, and no more than T."""
    (B, D), T = Xq.shape, Xt.shape[0]
    if clusters is None:
        clusters = min(T, _wide_max_clusters(dev[0], Xq.dtype, B))
    part = torch.empty(clusters * B * (D + 2), dtype=Xq.dtype, device=Xq.device)
    E = torch.empty(B, dtype=Xq.dtype, device=Xq.device)
    F_d = torch.empty(B, D, dtype=Xq.dtype, device=Xq.device)
    _call(lib, 'sgdml_wide', ('wide',), Xq, Xq.data_ptr(), Xt.data_ptr(), JA.data_ptr(), xt_sq.data_ptr(),
          tja.data_ptr(), _ptr(aE), float(sig), B, T, D, clusters, part.data_ptr(), E.data_ptr(),
          F_d.data_ptr(), *dev, contraction=True)
    return E, F_d


def planes(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """Pass A of the two-pass route (see :func:`planes_reference` for what it
    returns): the kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin)
    if Xq.device.type == 'cpu':
        return planes_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig)
    (B, D), T = Xq.shape, Xt.shape[0]
    n_t = _cdiv(T, TILE)
    out = torch.empty(B, 2 * n_t * TILE, dtype=Xq.dtype, device=Xq.device)
    e_part, s_part = torch.empty(2, B, n_t, dtype=Xq.dtype, device=Xq.device)
    _call(_build.load_library(), 'sgdml_planes', ('pass_a',), Xq, Xq.data_ptr(), Xt.data_ptr(),
          JA.data_ptr(), xt_sq.data_ptr(), tja.data_ptr(), _ptr(alphas_E_lin), float(sig), B,
          T, D, out.data_ptr(), e_part.data_ptr(), s_part.data_ptr(), *_device_args(Xq))
    return out, e_part, s_part


def forces(Xq, Xt, JA, planes_, e_part, s_part, splits, per):
    """Pass B of the two-pass route and its reduction (see
    :func:`forces_reference`): ``(E_raw (B,), F_d (B, D))`` from pass A's
    outputs. The kernel on CUDA tensors, the plain version on CPU tensors."""
    B, D = Xq.shape
    T = Xt.shape[0]
    n_t = _cdiv(T, TILE)
    _check_named(Xq, {'Xq': (Xq, (B, D)), 'Xt': (Xt, (T, D)), 'JA': (JA, (T, D)),
                      'planes': (planes_, (B, 2 * n_t * TILE)),
                      'e_part': (e_part, (B, n_t)), 's_part': (s_part, (B, n_t))})
    n_k = 2 * n_t * TILE // K_STEP
    if not (splits >= 1 and per >= 1 and (splits - 1) * per < n_k <= splits * per):
        raise ValueError('splits=%d x per=%d does not cut %d K steps' % (splits, per, n_k))
    if Xq.device.type == 'cpu':
        return forces_reference(Xq, Xt, JA, planes_, e_part, s_part, splits, per)
    partial = torch.empty(splits, B, D, dtype=Xq.dtype, device=Xq.device)
    E = torch.empty(B, dtype=Xq.dtype, device=Xq.device)
    F_d = torch.empty(B, D, dtype=Xq.dtype, device=Xq.device)
    _call(_build.load_library(), 'sgdml_forces', ('pass_b',), Xq, Xq.data_ptr(), Xt.data_ptr(),
          JA.data_ptr(), planes_.data_ptr(), e_part.data_ptr(), s_part.data_ptr(), B, T, D,
          splits, per, partial.data_ptr(), E.data_ptr(), F_d.data_ptr(), *_device_args(Xq))
    return E, F_d


def two_pass(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """The two-pass route: pass A then pass B, K split by :func:`split_k`
    for the card, on CUDA tensors; the plain passes, in one K run, on CPU
    tensors."""
    _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin)
    if Xq.device.type == 'cpu':
        out = planes_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig)
        return forces_reference(Xq, Xt, JA, *out, *split_k(Xq.shape[0], Xq.shape[1],
                                                           Xt.shape[0], 1))
    return _launch_two_pass(_build.load_library(), _device_args(Xq), Xq, Xt, JA, xt_sq, tja,
                            alphas_E_lin, sig)


def split_t(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig, blocks=None):
    """The split-T route: the kernel and its reduction on CUDA tensors, the
    plain version on CPU tensors, with the table cut into ``blocks`` runs
    (default: :func:`split_t_blocks` for the card's SMs, on the CPU for
    one SM).
    Raises ValueError for a batch the kernel does not take: more than 16
    queries, or more than fit a block's shared memory."""
    _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin)
    B, D = Xq.shape
    if not _split_t_takes(B, D, Xq.element_size()):
        raise ValueError("the split-T route takes at most 16 queries whose descriptors fit a block's "
                         'shared memory, got B=%d, D=%d in %s' % (B, D, Xq.dtype))
    if blocks is not None and blocks < 1:
        raise ValueError('blocks must be at least 1, got %d' % blocks)
    if Xq.device.type == 'cpu':
        return split_t_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig,
                                 blocks or split_t_blocks(Xt.shape[0], 1))
    return _launch_split_t(_build.load_library(), _device_args(Xq), Xq, Xt, JA, xt_sq, tja,
                           alphas_E_lin, sig, blocks)


def wide(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig, clusters=None):
    """The wide route: the kernel and its reduction on CUDA tensors, the
    plain version on CPU tensors, with the table cut into ``clusters`` runs
    (default: one for each cluster the card runs at once, at most T; on the
    CPU one run). Raises ValueError for a batch the kernel does not take:
    more than :data:`WIDE_MAX_B` queries, or a slice of more than
    ``WIDE_COLS x WIDE_THREADS`` columns."""
    _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin)
    B, D = Xq.shape
    if not _wide_takes(B, D):
        raise ValueError('the wide route takes at most %d queries of width up to %d, got B=%d, D=%d'
                         % (WIDE_MAX_B, WIDE_CLUSTER * WIDE_COLS * WIDE_THREADS, B, D))
    if clusters is not None and clusters < 1:
        raise ValueError('clusters must be at least 1, got %d' % clusters)
    if Xq.device.type == 'cpu':
        return wide_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig, clusters or 1)
    return _launch_wide(_build.load_library(), _device_args(Xq), Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig,
                        clusters)


def fused_predict_tables(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """``(E_raw (B,), F_d (B, D))`` from centered inputs (see
    :func:`fused_predict_tables_reference` for the arguments).

    CUDA tensors launch the kernel on the current stream, by the route that
    :func:`route` picks for D and B; CPU tensors run the plain version. All
    tensors share one device and one dtype (float32 or float64) and must be
    contiguous for the kernel.
    """
    _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin)
    if Xq.device.type == 'cpu':
        return fused_predict_tables_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig)
    launch = {'split_t': _launch_split_t, 'wide': _launch_wide, 'two_pass': _launch_two_pass}[
        route(Xq.shape[1], Xq.shape[0])]
    return launch(_build.load_library(), _device_args(Xq), Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig)


# One NVE step of MD at B = 1 (csrc/fused_predict.cu: NveStep).

def _step_smem_fits(n_atoms: int, D: int, itemsize: int) -> bool:
    """Whether the step's block takes a query of width D and the state of
    n_atoms atoms in its shared memory on sm_90 (227 KB;
    csrc/fused_predict.cu:launch_md_step): every width that split T takes
    at B = 1 (``route``: at most SPLIT_T_XQ_BYTES of f64 descriptor)."""
    return itemsize * (3 * SPLIT_T_WARPS + 1 + 3 * D + 7 * n_atoms + 3) <= 227 * 1024


@functools.lru_cache(maxsize=None)
def _atom_pairs(n_atoms: int, device: torch.device):
    """``(idx, sign)``, each ``(N, N - 1)``: the pairs of each atom in pair
    order and the incidence of the atom in each (-1 in ``(n, b)``, +1 in
    ``(a, n)``), the order in which the step adds an atom's forces."""
    pairs = desc_ops.tril_pairs(n_atoms)
    idx = [[p for p, (a, b) in enumerate(pairs) if n in (a, b)] for n in range(n_atoms)]
    sign = [[-1.0 if pairs[p][0] == n else 1.0 for p in row] for n, row in enumerate(idx)]
    return torch.as_tensor(idx, device=device), torch.as_tensor(sign, device=device)


def md_step_reference(r, v, f, inv_m, tables, sig, std, dt, blocks):
    """Plain version of :func:`md_step`, with the kernel's arithmetic: the
    drift ``v_half = v + dt/2 f inv_m``, ``r' = r + dt v_half``; the centred
    descriptor of ``r'`` and ``1/d^3``; ``(E_raw, F_d)`` by
    :func:`split_t_reference` over ``blocks`` blocks; the forces ``F = std
    J^T F_d``, each atom's sum over its pairs in pair order; then ``v =
    v_half + dt/2 F inv_m``. Updates ``r``, ``v``, ``f`` in place and returns
    ``E_raw (1,)`` at ``r'``."""
    n = r.shape[0]
    inv_m = inv_m.reshape(n, 1)
    a, b = torch.as_tensor(desc_ops.tril_pairs(n).T, device=r.device)
    h = 0.5 * dt
    v_half = v + h * f * inv_m
    r_new = r + dt * v_half
    diffs = r_new[a] - r_new[b]
    inv_d = torch.rsqrt((diffs[:, 0] * diffs[:, 0] + diffs[:, 1] * diffs[:, 1]) + diffs[:, 2] * diffs[:, 2])
    E, F_d = split_t_reference((inv_d - tables.mu)[None], tables.Xt, tables.JA, tables.xt_sq, tables.tja, None,
                               sig, blocks)
    w = diffs * (inv_d * inv_d * inv_d)[:, None] * F_d[0, :, None]
    idx, sign = _atom_pairs(n, r.device)
    acc = torch.zeros_like(r)
    for j in range(n - 1):
        acc = acc + sign[:, j, None].to(r.dtype) * w[idx[:, j]]
    F = acc * std
    v_new = v_half + h * F * inv_m
    r.copy_(r_new)
    v.copy_(v_new)
    f.copy_(F)
    return E


class MDStepWork:
    """The step kernel's device scratch for a table of T rows of width D cut
    into ``blocks`` blocks (default: :func:`split_t_blocks` for the card's
    SMs): the block partials, the run sums, the tickets (zero, and each
    launch leaves them so) and ``E`` (E_raw, ``(1,)``). Kept across steps: a
    CUDA graph of steps replays over the same buffers."""

    def __init__(self, T: int, D: int, dtype, device, blocks=None):
        device = torch.device(device)
        if blocks is None:
            blocks = split_t_blocks(T, _sm_count(device.index if device.index is not None
                                                 else torch.cuda.current_device()))
        self.blocks = blocks
        self.part = torch.empty(blocks * (D + 2), dtype=dtype, device=device)
        self.runs = torch.empty(SPLIT_T_REDUCE_RUNS * (D + 2), dtype=dtype, device=device)
        self.tickets = torch.zeros(SPLIT_T_REDUCE_RUNS + 1, dtype=torch.int32, device=device)
        self.E = torch.empty(1, dtype=dtype, device=device)


def md_step(r, v, f, inv_m, tables, sig, std, dt, blocks=None, work=None):
    """One velocity-Verlet step of MD on one geometry: ``r``, ``v``, ``f``
    ``(N, 3)`` advanced in place by ``dt``, with the forces of the model
    whose centred tables are ``tables`` (``predict.Tables``), kernel width
    ``sig`` and label scale ``std``; ``inv_m`` the ``N`` inverse masses.
    Returns ``E_raw (1,)`` at the new positions (the energy is ``E_raw std +
    c``).

    CUDA tensors launch the step kernel on the current stream (one
    contraction in ``LAUNCHES``, one ``md_step`` in ``PATH_LAUNCHES``), its
    scratch in ``work`` (an :class:`MDStepWork`, allocated here when None;
    its ``E`` is the returned tensor); CPU tensors run
    :func:`md_step_reference`. ``blocks`` cuts the table as
    :func:`split_t` does (default: :func:`split_t_blocks`, on the CPU for one
    SM). Raises ValueError for a width the kernel does not take."""
    n, (T, D) = r.shape[0], tables.Xt.shape
    if r.dim() != 2 or r.shape[1] != 3 or D != n * (n - 1) // 2 or inv_m.numel() != n:
        raise ValueError('md_step takes r (N, 3) and N inverse masses against tables of width N (N - 1) / 2, '
                         'got r %s, inv_m %s and D=%d' % (tuple(r.shape), tuple(inv_m.shape), D))
    _check_kind(r, 'md_step')
    _check_named(r, {'r': (r, (n, 3)), 'v': (v, (n, 3)), 'f': (f, (n, 3)), 'inv_m': (inv_m, tuple(inv_m.shape)),
                     'mu': (tables.mu, (D,)), 'Xt': (tables.Xt, (T, D)), 'JA': (tables.JA, (T, D)),
                     'xt_sq': (tables.xt_sq, (T,)), 'tja': (tables.tja, (T,))})
    if not _step_smem_fits(n, D, r.element_size()):
        raise ValueError("the MD step takes a geometry whose descriptor and state fit a block's shared memory, "
                         'got N=%d, D=%d in %s' % (n, D, r.dtype))
    if blocks is not None and blocks < 1:
        raise ValueError('blocks must be at least 1, got %d' % blocks)
    if r.device.type == 'cpu':
        return md_step_reference(r, v, f, inv_m, tables, sig, std, dt, blocks or split_t_blocks(T, 1))
    if work is None:
        work = MDStepWork(T, D, r.dtype, r.device, blocks)
    elif blocks is not None and blocks != work.blocks:
        raise ValueError('blocks=%d, but work was made for %d' % (blocks, work.blocks))
    _call(_build.load_library(), 'sgdml_md_step', ('md_step',), r, tables.Xt.data_ptr(), tables.JA.data_ptr(),
          tables.xt_sq.data_ptr(), tables.tja.data_ptr(), tables.mu.data_ptr(), inv_m.data_ptr(), float(sig),
          float(std), float(dt), n, T, D, work.blocks, r.data_ptr(), v.data_ptr(),
          f.data_ptr(), work.part.data_ptr(), work.runs.data_ptr(), work.tickets.data_ptr(), work.E.data_ptr(),
          *_device_args(r), contraction=True)
    return work.E
