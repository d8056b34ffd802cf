"""Fused (E, F) inference contraction: CUDA kernel wrappers and plain versions.

The kernel (``csrc/fused_predict.cu``) replaces the TPU kernel
``sgdml_tpu/ops/pallas_predict.py:_kernel`` and computes, on table-mean
centered inputs, the unscaled energies ``E_raw (B,)`` and descriptor-space
forces ``F_d (B, D)`` of ``sgdml_tpu/predict.py:_predict_from_tables_body``
-- the energy-constraint term included. ``fused_predict_tables`` launches it
for CUDA tensors and runs :func:`fused_predict_tables_reference`, the plain
PyTorch version, for CPU tensors.

It has two routes, picked by :func:`route` from the table size T and the
descriptor width D:
:func:`one_pass`, one kernel with the ``(B, T)`` coefficient planes kept
on chip, and :func:`two_pass`, two tiled products with the planes in device
memory between them. Its passes also launch on their own (:func:`planes`,
:func:`forces`), and each has a plain version beside it
(:func:`planes_reference`, :func:`forces_reference`) that mirrors the
kernel's scratch layout, its per-tile partial sums and its split of the K
axis.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as nnf

from . import _build
from .kernel import Mat52Coeffs

__all__ = [
    'K_STEP', 'LAUNCHES', 'ONE_PASS_MAX_STEPS', 'PATH_LAUNCHES', 'TILE',
    'fused_predict_tables', 'fused_predict_tables_reference', 'forces',
    'forces_reference', 'one_pass', 'planes', 'planes_reference',
    'reset_launches', 'route', 'split_k', 'two_pass',
]

_SQRT5 = math.sqrt(5.0)

# Tiling of the two-pass route (csrc/fused_predict.cu: TILE, BK): rows and
# columns of a block tile, and the depth of one pipeline stage, which is the
# unit in which pass B's K axis is split.
TILE = 64
K_STEP = 16

# A block of the one-pass kernel walks the table in 32-row tiles, and each
# tile in 32-wide chunks of D: ceil(T / 32) ceil(D / 32) steps one after the
# other, whatever B. Up to this many steps it beats the two-pass route (one
# kernel against three); above, the two-pass route wins. Set from both routes'
# times on an H100 across T = 30 ... 1000 and D = 10 ... 435 (PERF.md,
# section 6): D alone does not decide it.
ONE_PASS_MAX_STEPS = 16

# The pass B grid is split along K until it has at least as many blocks as the
# card has SMs, while each split keeps at least this many K steps.
_MIN_SPLIT_STEPS = 8

# Kernel launches in this process. LAUNCHES counts calls of the contraction
# that launched either route; PATH_LAUNCHES counts each kernel's launches, in
# the wrapper that launches it and nowhere else, so that a run can show which
# kernels its path went through.
LAUNCHES = 0
PATH_LAUNCHES = {'one_pass': 0, 'pass_a': 0, 'pass_b': 0}


def reset_launches():
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for key in PATH_LAUNCHES:
        PATH_LAUNCHES[key] = 0


def _cdiv(a, b):
    return -(-a // b)


def route(T: int, D: int) -> str:
    """``'one_pass'`` while the one-pass kernel's ``ceil(T / 32) ceil(D /
    32)`` serial steps are at most :data:`ONE_PASS_MAX_STEPS`,
    ``'two_pass'`` above."""
    return 'one_pass' if _cdiv(T, 32) * _cdiv(D, 32) <= ONE_PASS_MAX_STEPS else 'two_pass'


def split_k(B: int, D: int, T: int, n_sms: int):
    """``(splits, per)``: pass B cuts its ``K = 2 Tp`` axis (``Tp`` is T
    rounded up to :data:`TILE`) into ``splits`` runs of ``per`` K steps
    each, the last one possibly shorter and none empty."""
    n_k = 2 * _cdiv(T, TILE) * TILE // K_STEP
    blocks = _cdiv(B, TILE) * _cdiv(D, TILE)
    want = 1 if blocks >= n_sms else min(_cdiv(n_sms, blocks), max(1, n_k // _MIN_SPLIT_STEPS))
    per = _cdiv(n_k, want)
    return _cdiv(n_k, per), per


def _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin):
    if Xq.device.type not in ('cpu', 'cuda'):
        raise ValueError('fused_predict_tables takes CPU or CUDA tensors, got %s' % Xq.device)
    if Xq.dtype not in (torch.float32, torch.float64):
        raise ValueError('fused_predict_tables takes float32 or float64, got %s' % Xq.dtype)
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


def fused_predict_tables_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig, with_forces=True):
    """Plain PyTorch version of the kernel, line for line with
    ``sgdml_tpu/predict.py:158-186`` after the centering.

    Xq ``(B, D)`` and Xt ``(T, D)`` are centered on the table mean; JA
    ``(T, D)``; ``xt_sq = |Xt|^2`` and ``tja = <Xt, JA>`` per table row
    ``(T,)``; alphas_E_lin ``(T,)`` or None. Returns ``E_raw (B,)`` and
    ``F_d (B, D)`` (None without forces).
    """
    sig = torch.as_tensor(sig, dtype=Xq.dtype, device=Xq.device)

    xq_sq = torch.sum(Xq * Xq, dim=1)  # (B,)
    gram = Xq @ Xt.T  # (B, T)
    u2 = torch.clamp_min(xq_sq[:, None] - 2.0 * gram + xt_sq[None, :], 0.0)
    u5 = _SQRT5 * torch.sqrt(u2)

    e = torch.exp(-u5 / sig)
    b1 = (5.0 / (3.0 * sig**3)) * e  # gradient-kernel base
    w2 = b1 * (u5 + sig)

    a = Xq @ JA.T - tja[None, :]  # (B, T): d.(J alpha), centering-invariant

    E = torch.sum(a * w2, dim=1)

    if alphas_E_lin is not None:
        k_ee = Mat52Coeffs.value(u5, sig)
        E = E + k_ee @ alphas_E_lin

    if not with_forces:
        return E, None

    w1 = a * b1 * (5.0 / sig)
    F_d = torch.sum(w1, dim=1)[:, None] * Xq - w1 @ Xt  # (B, D)
    F_d = F_d - w2 @ JA

    if alphas_E_lin is not None:
        w3 = w2 * alphas_E_lin[None, :]
        F_d = F_d + torch.sum(w3, dim=1)[:, None] * Xq - w3 @ Xt

    return E, F_d


def planes_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """Plain version of pass A. Returns ``planes (B, 2 Tp)`` -- ``cx = w1 +
    w3`` in columns ``[0, Tp)`` and ``cj = w2`` in ``[Tp, 2 Tp)``, zero past
    T, with ``Tp`` = T rounded up to :data:`TILE` -- and the row sums of the
    energy term and of ``cx`` over each TILE-wide block of table rows,
    ``e_part`` and ``s_part (B, Tp / TILE)``."""
    B, T = Xq.shape[0], Xt.shape[0]
    pad = _cdiv(T, TILE) * TILE - T
    sig = torch.as_tensor(sig, dtype=Xq.dtype, device=Xq.device)

    xq_sq = torch.sum(Xq * Xq, dim=1)
    u2 = torch.clamp_min(xq_sq[:, None] - 2.0 * (Xq @ Xt.T) + xt_sq[None, :], 0.0)
    u5 = _SQRT5 * torch.sqrt(u2)
    b1 = (5.0 / (3.0 * sig**3)) * torch.exp(-u5 / sig)
    cj = b1 * (u5 + sig)
    a = Xq @ JA.T - tja[None, :]
    ep = a * cj
    cx = a * b1 * (5.0 / sig)
    if alphas_E_lin is not None:
        ep = ep + Mat52Coeffs.value(u5, sig) * alphas_E_lin[None, :]
        cx = cx + cj * alphas_E_lin[None, :]

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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(x):
    return None if x is None else x.data_ptr()


def _call(lib, stem, paths, x, *args):
    """Call ``lib.<stem>_f32`` or ``_f64`` (by x's dtype); count one launch
    of each kernel in ``paths``."""
    err = getattr(lib, stem + ('_f64' if x.dtype == torch.float64 else '_f32'))(*args)
    if err != 0:
        raise RuntimeError(
            'fused_predict kernel (%s) launch failed: CUDA error %d (%s)'
            % ('+'.join(paths), err, lib.sgdml_cuda_error_string(err).decode())
        )
    for path in paths:
        PATH_LAUNCHES[path] += 1


# The route launchers take checked CUDA tensors, the library and the (device
# index, stream) pair, and allocate only their outputs and scratch.

def _launch_one_pass(lib, dev, Xq, Xt, JA, xt_sq, tja, aE, sig):
    global LAUNCHES
    (B, D), T = Xq.shape, Xt.shape[0]
    E = torch.empty(B, dtype=Xq.dtype, device=Xq.device)
    F_d = torch.empty(B, D, dtype=Xq.dtype, device=Xq.device)
    _call(lib, 'sgdml_fused_predict', ('one_pass',), Xq, Xq.data_ptr(), Xt.data_ptr(),
          JA.data_ptr(), xt_sq.data_ptr(), tja.data_ptr(), _ptr(aE), float(sig), B, T, D,
          E.data_ptr(), F_d.data_ptr(), *dev)
    LAUNCHES += 1
    return E, F_d


def _launch_two_pass(lib, dev, Xq, Xt, JA, xt_sq, tja, aE, sig):
    """Pass A then pass B in one call, their scratch in one allocation."""
    global LAUNCHES
    (B, D), T = Xq.shape, Xt.shape[0]
    n_t = _cdiv(T, TILE)
    splits, per = split_k(B, D, T, _sm_count(dev[0]))
    scratch = torch.empty(B * (2 * n_t * TILE + 2 * n_t + splits * D), dtype=Xq.dtype,
                          device=Xq.device)
    E = torch.empty(B, dtype=Xq.dtype, device=Xq.device)
    F_d = torch.empty(B, D, dtype=Xq.dtype, device=Xq.device)
    _call(lib, 'sgdml_two_pass', ('pass_a', 'pass_b'), Xq, Xq.data_ptr(), Xt.data_ptr(),
          JA.data_ptr(), xt_sq.data_ptr(), tja.data_ptr(), _ptr(aE), float(sig), B, T, D,
          splits, per, scratch.data_ptr(), E.data_ptr(), F_d.data_ptr(), *dev)
    LAUNCHES += 1
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


def one_pass(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """The one-pass route: one kernel launch on CUDA tensors, the plain
    version on CPU tensors."""
    _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin)
    if Xq.device.type == 'cpu':
        return fused_predict_tables_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig)
    return _launch_one_pass(_build.load_library(), _device_args(Xq), Xq, Xt, JA, xt_sq, tja,
                            alphas_E_lin, sig)


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


def fused_predict_tables(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """``(E_raw (B,), F_d (B, D))`` from centered inputs (see
    :func:`fused_predict_tables_reference` for the arguments).

    CUDA tensors launch the kernel on the current stream, by the route that
    :func:`route` picks for T and D; CPU tensors run the plain version. All
    tensors share one device and one dtype (float32 or float64) and must be
    contiguous for the kernel.
    """
    _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin)
    if Xq.device.type == 'cpu':
        return fused_predict_tables_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig)
    one = route(Xt.shape[0], Xq.shape[1]) == 'one_pass'
    return (_launch_one_pass if one else _launch_two_pass)(_build.load_library(), _device_args(Xq), Xq, Xt, JA, xt_sq, tja,
                  alphas_E_lin, sig)
