"""Fused (E, F) inference contraction: CUDA kernel wrapper and plain version.

The kernel (``csrc/fused_predict.cu``) replaces the TPU kernel
``sgdml_tpu/ops/pallas_predict.py:_kernel`` and computes, on table-mean
centered inputs, the unscaled energies ``E_raw (B,)`` and descriptor-space
forces ``F_d (B, D)`` of ``sgdml_tpu/predict.py:_predict_from_tables_body``
-- the energy-constraint term included. ``fused_predict_tables`` launches it
for CUDA tensors and runs :func:`fused_predict_tables_reference`, the plain
PyTorch version, for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .kernel import Mat52Coeffs

__all__ = ['fused_predict_tables', 'fused_predict_tables_reference', 'LAUNCHES']

_SQRT5 = math.sqrt(5.0)

# Number of kernel launches in this process. The wrapper adds one per launch
# and nowhere else, so a run can show that its path went through the kernel.
LAUNCHES = 0


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
    for name, (x, shape) in named.items():
        if tuple(x.shape) != shape:
            raise ValueError('%s has shape %s, expected %s' % (name, tuple(x.shape), shape))
        if x.device != Xq.device or x.dtype != Xq.dtype:
            raise ValueError(
                '%s is %s on %s; Xq is %s on %s' % (name, x.dtype, x.device, Xq.dtype, Xq.device)
            )
        if Xq.device.type == 'cuda' and not x.is_contiguous():
            raise ValueError('%s must be contiguous for the CUDA kernel' % name)


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


def fused_predict_tables(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig):
    """``(E_raw (B,), F_d (B, D))`` from centered inputs (see
    :func:`fused_predict_tables_reference` for the arguments).

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    the plain version. All tensors share one device and one dtype (float32
    or float64) and must be contiguous for the kernel.
    """
    global LAUNCHES
    _check(Xq, Xt, JA, xt_sq, tja, alphas_E_lin)
    if Xq.device.type == 'cpu':
        return fused_predict_tables_reference(Xq, Xt, JA, xt_sq, tja, alphas_E_lin, sig)

    lib = _build.load_library()
    B, D = Xq.shape
    T = Xt.shape[0]
    E = torch.empty(B, dtype=Xq.dtype, device=Xq.device)
    F_d = torch.empty(B, D, dtype=Xq.dtype, device=Xq.device)
    fn = lib.sgdml_fused_predict_f64 if Xq.dtype == torch.float64 else lib.sgdml_fused_predict_f32
    err = fn(
        Xq.data_ptr(), Xt.data_ptr(), JA.data_ptr(), xt_sq.data_ptr(), tja.data_ptr(),
        None if alphas_E_lin is None else alphas_E_lin.data_ptr(),
        float(sig), B, T, D, E.data_ptr(), F_d.data_ptr(),
        Xq.device.index if Xq.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(Xq.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            'fused_predict kernel launch failed: CUDA error %d (%s)'
            % (err, lib.sgdml_cuda_error_string(err).decode())
        )
    LAUNCHES += 1
    return E, F_d
