"""GDML inference engine: batched energy/force prediction in PyTorch.

Every prediction is a linear combination over ``T = M * P`` kernel terms
(M training points x P symmetry permutations), evaluated as one contraction
against permuted training tables:

    G   = Xq @ Xt^T                          (B, T)   query x table Gram
    a   = Xq @ JA^T - <Xt, JA>               (B, T)   d . (J alpha) terms
    F_d = rowsum(w1) * Xq - w1 @ Xt - w2 @ JA  (B, D) descriptor-space force
    E   = rowsum(a * w2)                     (B,)

with elementwise coefficient planes ``w1, w2`` from the Matern-5/2 family.
Squared distances come from the Gram identity on descriptors centered on the
table mean; the centered tables, ``|Xt|^2`` and ``<Xt, JA>`` are computed
once, when the tables are built. On a CUDA device the contraction is one
hand-written kernel (``ops/fused_predict.py``) whose ``(B, T)`` planes never
leave the chip; on the CPU it is the plain PyTorch version. Cartesian forces
come from the incidence-factorized Jacobian transpose.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .models.gdml import as_model_dict, model_to_torch
from .ops import descriptor as desc_ops
from .ops import fused_predict, ozaki
from .ops._precision import _true_f32
from .utils import io

__all__ = [
    'GDMLPredict',
    'Tables',
    'build_tables',
    'center_tables',
    'desc_perm_table',
    'predict_from_tables',
]


class Tables(NamedTuple):
    """Permuted training tables, centered once on their mean.

    Distances and differences are translation-invariant, so centering is
    exact math; it shrinks the magnitudes entering the Gram-identity
    cancellation from ``|x|`` to the descriptor cloud's spread, which is
    what makes float32 serving accurate.
    """

    mu: torch.Tensor  # (D,) table mean
    Xt: torch.Tensor  # (T, D) Xt - mu
    JA: torch.Tensor  # (T, D)
    xt_sq: torch.Tensor  # (T,) |Xt - mu|^2
    tja: torch.Tensor  # (T,) <Xt - mu, JA>


def desc_perm_table(perms: np.ndarray) -> np.ndarray:
    """Atom permutations (P, N) -> descriptor permutations (P, D)."""
    return np.stack(
        [desc_ops.perm_to_desc_perm(p) for p in np.asarray(perms, dtype=np.int64)]
    )


def build_tables(R_desc, R_d_desc_alpha, desc_perms):
    """Flatten permuted training tables.

    Parameters
    ----------
    R_desc: ``(M, D)`` training descriptors.
    R_d_desc_alpha: ``(M, D)`` alpha-contracted training Jacobians.
    desc_perms: ``(P, D)`` descriptor permutations (array or tensor).

    Returns
    -------
    Xt, JA: ``(M*P, D)`` permuted tables, laid out ``t = m * P + p``
        (reference layout, sgdml/predict.py:426-441).
    """
    dp = torch.as_tensor(desc_perms, device=R_desc.device)
    Xt = R_desc[:, dp].reshape(-1, R_desc.shape[1])
    JA = R_d_desc_alpha[:, dp].reshape(-1, R_desc.shape[1])
    return Xt, JA


def center_tables(Xt, JA) -> Tables:
    """Center ``Xt`` on its mean and precompute the table-side terms."""
    mu = torch.mean(Xt, dim=0)
    Xt = (Xt - mu[None, :]).contiguous()
    JA = JA.contiguous()
    return Tables(mu, Xt, JA, torch.sum(Xt * Xt, dim=1), torch.sum(Xt * JA, dim=1))


def _ozaki_slices(mm: str):
    """The slice count of an ``'ozaki<N>'`` rung (N defaults to 6), or None
    for ``'native'``."""
    if mm == 'native':
        return None
    if not (mm.startswith('ozaki') and (mm[5:] == '' or mm[5:].isdigit())):
        raise ValueError("mm must be 'native' or 'ozaki<N>', got %r" % (mm,))
    return int(mm[5:] or 6)


def _scale(E, F_d, Jcq, std, c, n_atoms):
    F = None if F_d is None else desc_ops.vec_dot_jac(Jcq, F_d, n_atoms) * std
    return E * std + c, F


def predict_from_tables(
    Xq, Jcq, tables: Tables, alphas_E_lin, sig, std, c,
    *, n_atoms: int, with_forces: bool = True, mm: str = 'native',
):
    """Batched (E, F) prediction from centered tables.

    Xq: ``(B, D)`` query descriptors. Jcq: ``(B, D, 3)`` query compressed
    Jacobians. alphas_E_lin: ``(T,)`` permuted energy coefficients or None.
    Returns ``E (B,)`` and ``F (B, 3N)`` (None without forces).

    ``mm='native'``: CUDA tensors run the fused kernel; CPU tensors its
    plain version. ``mm='ozaki<N>'`` (``'ozaki'``: N = 6) on float64 inputs
    runs the plain contraction with its five ``(B, T)``-sized products as
    Ozaki int8 products of N slices (``sgdml_tpu/predict.py:113-189``): the
    CG matvec's lower precision rungs. float32 inputs ignore ``mm``, and a
    table or descriptor width past the exact-int32 bound
    (``ozaki.max_contraction_dim(N)``) takes ``'native'``.
    """
    ns = _ozaki_slices(mm)
    if ns is not None and Xq.dtype == torch.float64 and max(tables.Xt.shape) <= ozaki.max_contraction_dim(ns):
        E, F_d = fused_predict.fused_predict_tables_reference(
            Xq - tables.mu, tables.Xt, tables.JA, tables.xt_sq, tables.tja,
            alphas_E_lin, sig, with_forces=with_forces, matmul=lambda a, b: ozaki.ozaki_gemm_nt_f64(a, b.T, ns),
        )
        return _scale(E, F_d, Jcq, std, c, n_atoms)
    with _true_f32(Xq.dtype):
        E, F_d = fused_predict.fused_predict_tables(
            Xq - tables.mu, tables.Xt, tables.JA, tables.xt_sq, tables.tja,
            alphas_E_lin, sig,
        )
        return _scale(E, F_d if with_forces else None, Jcq, std, c, n_atoms)


def _predict_from_tables_body(
    Xq, Jcq, tables: Tables, alphas_E_lin, sig, std, c, *, n_atoms, with_forces=True,
):
    """Plain PyTorch version of :func:`predict_from_tables` on any device
    (``sgdml_tpu/predict.py:_predict_from_tables_body`` with the centering
    moved to :func:`center_tables`); the oracle for the CUDA kernel."""
    with _true_f32(Xq.dtype):
        E, F_d = fused_predict.fused_predict_tables_reference(
            Xq - tables.mu, tables.Xt, tables.JA, tables.xt_sq, tables.tja,
            alphas_E_lin, sig, with_forces=with_forces,
        )
        return _scale(E, F_d, Jcq, std, c, n_atoms)


def _predict_geoms(
    R, tables: Tables, alphas_E_lin, lat_and_inv, sig, std, c,
    *, n_atoms, with_forces=True, out_dtype=None,
):
    """Descriptors + prediction for one chunk of geometries ``R (B, 3N)``.

    ``R`` may arrive in a narrower *transfer* dtype than the compute dtype
    (taken from the tables); ``out_dtype`` narrows the results before the
    device-to-host copy.
    """
    R = R.to(tables.Xt.dtype)
    Xq, Jcq = desc_ops.descriptor_batch(R, n_atoms, lat_and_inv)
    E, F = predict_from_tables(
        Xq, Jcq, tables, alphas_E_lin, sig, std, c,
        n_atoms=n_atoms, with_forces=with_forces,
    )
    if out_dtype is not None:
        E = E.to(out_dtype)
        F = F if F is None else F.to(out_dtype)
    return E, F


def _auto_batch_size(device: torch.device) -> int:
    """Default chunk of geometries per device call: large on a GPU, where
    a call's fixed cost is amortized over the chunk; small on the CPU."""
    return 64 if device.type == 'cpu' else 1024


def _numpy(x):
    return None if x is None else x.cpu().numpy()


class GDMLPredict:
    """Load a trained (s)GDML model and predict energies and forces.

    Accepts model dicts in the reference's npz layout
    (sgdml/train.py:793-831), a :class:`~sgdml_tpu_torch.models.GDMLModel`
    or a model file path.

    Parameters
    ----------
    model: model dict, GDMLModel or path.
    dtype: computation dtype (``torch.float64`` default for parity;
        ``torch.float32`` is the fast path).
    batch_size: geometries per device call; requests are chunked by it.
    transfer_dtype: optional narrower ``torch.dtype`` for host<->device
        copies of geometries and results (compute stays in ``dtype``).
    mesh: a ``DeviceMesh`` (``parallel/mesh.py``) for data-parallel serving,
        every rank calling :meth:`predict` alike: each rank predicts its shard
        of the request against the whole tables (K1 on a GPU) and one
        all-gather returns all of ``E`` and ``F`` to every rank.
        ``batch_size`` is then rounded up to a multiple of the ranks, each
        rank taking its share of a batch.
    device: the device to serve on: the GPU unless the caller asks for the
        CPU (``device='cpu'``); without a card the default raises. With a
        mesh, this rank's device of the mesh, which ``device`` must name.
    """

    def __init__(self, model, dtype=torch.float64, batch_size: int | None = None,
                 transfer_dtype=None, mesh=None, *, device='cuda'):
        model = as_model_dict(model)
        if not io.is_model(model):
            raise ValueError('The provided data structure is not a valid model.')

        self.mesh = mesh
        self._info = None
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from .parallel.mesh import mesh_device, mesh_info

            self._info = mesh_info(mesh)
            self.device = mesh_device(self._info, device)
        self._n_dev = 1 if self._info is None else self._info.size
        self.n_atoms = int(model['z'].shape[0])
        self.dim_i = 3 * self.n_atoms
        self.dtype = dtype
        self.transfer_dtype = transfer_dtype
        if batch_size is None:
            batch_size = _auto_batch_size(self.device)
        self.batch_size = -(-int(batch_size) // self._n_dev) * self._n_dev

        self.sig = float(np.squeeze(model['sig']))
        self.std = float(np.squeeze(model.get('std', 1.0)))
        self.c = float(np.squeeze(model.get('c', 0.0)))

        w = model_to_torch(model, self.device, dtype)
        self.lat_and_inv = (w['lattice'], w['lattice_inv']) if 'lattice' in w else None
        self._desc_perms = w['desc_perms']
        self.n_perms = self._desc_perms.shape[0]
        self.n_train = w['R_desc'].shape[0]
        self.alphas_E_lin = w.get('alphas_E_lin')

        # Caches for iterative-training mode.
        self._R_desc_train = w['R_desc']
        self._R_d_desc_train = None
        self._Xt, JA = build_tables(w['R_desc'], w['R_d_desc_alpha'], self._desc_perms)
        self.tables = center_tables(self._Xt, JA)

    def _tensor(self, x, dtype=None):
        dtype = dtype or self.dtype
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    # -- iterative-training hooks (reference: predict.py:510-601) ---------

    def set_R_desc(self, R_desc):
        """Replace the training descriptors ``(M, D)`` of the tables."""
        self._R_desc_train = self._tensor(R_desc)
        self._Xt, _ = build_tables(self._R_desc_train, self._R_desc_train, self._desc_perms)
        self.tables = center_tables(self._Xt, self.tables.JA)

    def set_R_d_desc(self, R_d_desc):
        """Store training compressed Jacobians ``(M, D, 3)`` -- required
        before :meth:`set_alphas`."""
        self._R_d_desc_train = self._tensor(R_d_desc)

    def set_alphas(self, alphas_F, alphas_E=None):
        """Re-derive the contracted tables from new regression coefficients
        (CG matvec hot path)."""
        if self._R_d_desc_train is None:
            raise RuntimeError('call set_R_d_desc first')
        al = self._tensor(alphas_F).reshape(-1, self.dim_i)
        R_d_desc_alpha = desc_ops.jac_dot_vec(self._R_d_desc_train, al, self.n_atoms)
        _, JA = build_tables(self._R_desc_train, R_d_desc_alpha, self._desc_perms)
        self.tables = center_tables(self._Xt, JA)
        if alphas_E is not None:
            self.alphas_E_lin = torch.repeat_interleave(self._tensor(alphas_E), self.n_perms)

    # -- main API ----------------------------------------------------------

    def predict(self, R=None, R_desc=None, R_d_desc=None, return_E=True):
        """Predict energies and forces.

        Parameters
        ----------
        R: ``(B, 3N)`` / ``(B, N, 3)`` / ``(3N,)`` Cartesian geometries, or
            None to predict on cached training descriptors (train mode).
        R_desc / R_d_desc: optionally pass precomputed descriptors.

        Returns
        -------
        (E (B,), F (B, 3N)) as NumPy arrays (on a mesh, all of them on every
        rank).
        """
        if self._info is None:
            E, F = self._predict(R, R_desc, R_d_desc)
        else:
            E, F = self._predict_sharded(R, R_desc, R_d_desc)
        return (_numpy(E), _numpy(F)) if return_E else (None, _numpy(F))

    def _predict_sharded(self, R, R_desc, R_d_desc):
        """Descriptors and the training points go through
        ``parallel/spmd.predict_sharded``; geometries are sharded here, on
        the host, padded with copies of the first (whose descriptors are
        finite), predicted and all-gathered."""
        from .parallel.mesh import all_gather_rows
        from .parallel.spmd import predict_sharded

        if R_desc is not None or R is None:
            if R_desc is None:  # train mode
                Xq, Jcq, bs = self._R_desc_train, self._R_d_desc_train, None
            else:
                Xq, Jcq, bs = self._tensor(R_desc), self._tensor(R_d_desc), self.batch_size // self._n_dev
            return predict_sharded(Xq, Jcq, self.tables, self.sig, self.std, self.c, self.n_atoms, self.mesh,
                                   alphas_E_lin=self.alphas_E_lin, batch_size=bs)
        info = self._info
        R = np.asarray(R, dtype=np.float64)
        R = R.reshape(-1, self.dim_i) if R.ndim != 1 else R[None, :]
        B = R.shape[0]
        loc = -(-B // info.size)
        part = R[info.rank * loc:(info.rank + 1) * loc]
        if part.shape[0] < loc:
            part = np.concatenate([part, np.repeat(R[:1], loc - part.shape[0], axis=0)])
        E, F = self._predict(part, None, None)
        return all_gather_rows(E, info)[:B], all_gather_rows(F, info)[:B]

    def _predict(self, R, R_desc, R_d_desc):
        """(E, F) as tensors on this device, in chunks of ``batch_size`` (a
        rank's share of it on a mesh)."""
        args = (self.tables, self.alphas_E_lin)
        scal = (self.sig, self.std, self.c)
        bs = self.batch_size // self._n_dev
        if R is None and R_desc is None:
            # Train mode: descriptors already cached on the device.
            E, F = predict_from_tables(
                self._R_desc_train, self._R_d_desc_train, *args, *scal, n_atoms=self.n_atoms,
            )
        elif R_desc is not None:
            Xq, Jcq = self._tensor(R_desc), self._tensor(R_d_desc)
            parts = [
                predict_from_tables(
                    Xq[b0 : b0 + bs], Jcq[b0 : b0 + bs], *args, *scal, n_atoms=self.n_atoms,
                )
                for b0 in range(0, Xq.shape[0], bs)
            ]
            E, F = (torch.cat(x) for x in zip(*parts))
        else:
            # Geometry path: copy each chunk in the transfer dtype, compute
            # descriptors and prediction on the device, gather, copy back.
            R = np.asarray(R, dtype=np.float64)
            if R.ndim == 1:
                R = R[None, :]
            R = R.reshape(R.shape[0], -1)
            tdt = self.transfer_dtype
            parts = [
                _predict_geoms(
                    self._tensor(R[b0 : b0 + bs], tdt), *args, self.lat_and_inv, *scal,
                    n_atoms=self.n_atoms, out_dtype=tdt,
                )
                for b0 in range(0, R.shape[0], bs)
            ]
            E, F = (torch.cat(x) for x in zip(*parts))
        return E, F

    def prepare_parallel(self, n_bulk: int = 1000, **kwargs):
        """Auto-tune ``batch_size`` for bulk throughput (API parity with the
        reference's process auto-tuner, sgdml/predict.py:770).
        Returns measured geometries/sec."""
        from .tune import prepare_parallel as _tune

        return _tune(self, n_bulk=n_bulk, **kwargs)

    def predict_train_forces(self, alphas_F, alphas_E=None):
        """CG matvec core: set coefficients, predict all training points.

        Returns the raveled force prediction ``(M * 3N,)`` (plus negated
        energies when energy constraints are active, matching the
        reference's matvec layout, sgdml/solvers/iterative.py:190-202).
        """
        self.set_alphas(alphas_F, alphas_E=alphas_E)
        E, F = self.predict()
        if alphas_E is not None:
            return np.hstack((F.ravel(), -E))
        return F.ravel()
