"""Molecular dynamics on trained (s)GDML models, on one device.

The trajectory stays on the device. Positions, velocities and forces are
static tensors that each block of steps updates in place; each snapshot is
written into a trajectory allocated on the device up front, at a slot index
that the device itself advances; the trajectory comes back to the host once,
at the end. An NVE step is one ``fused_predict.md_step`` wherever K1 at one
geometry takes the split-T route (on a GPU one kernel launch: the drift, the
descriptor, the contraction, the force projection and the kick; on the CPU
its plain version), and each snapshot's energy is the last step's. Elsewhere,
and in every Langevin step, a step is a few dozen small device operations
around one (E, F) prediction (the fused kernel on a GPU).

Enqueued one by one from the host, those operations set the pace of a step.
So on a GPU a block (``snapshot_every`` steps and the snapshot; at most
``GRAPH_MAX_STEPS`` steps to a graph) is captured once as a CUDA graph
(``utils/graphs.py``) and replayed: the counterpart of the JAX package's
one compiled scan (``sgdml_tpu/md.py:_run_nve``, ``_run_langevin``), with
one graph launch a block from the host. On the CPU the same block body
runs eagerly.

Integrators: velocity Verlet (NVE) and Langevin (NVT, BAOAB splitting).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import resolve_device
from .models.gdml import as_model_dict, model_to_torch
from .ops import descriptor as desc_ops
from .ops import fused_predict
from .predict import build_tables, center_tables, predict_from_tables
from .utils import graphs, profiling
from .utils.io import ATOMIC_MASSES

__all__ = ['GRAPH_MAX_STEPS', 'MDEngine']

# Steps in one captured graph. A block of more steps replays a graph of this
# many steps, then one of the rest with the snapshot: a graph's capture time
# and size grow with its steps (PERF.md, section 6).
GRAPH_MAX_STEPS = 100


class MDEngine:
    """MD over a trained model dict on one device.

    Parameters
    ----------
    model: model dict (reference-compatible npz layout), GDMLModel or path.
    masses: ``(N,)`` atomic masses in u. Defaults to the standard atomic
        weights of the model's elements (``model['z']``) -- the same
        convention as the reference's ASE-driven MD
        (sgdml/intf/ase_calc.py:93-106).
    dtype: computation dtype (``torch.float64`` default).
    device: the device to run on: the GPU unless the caller asks for the
        CPU (``device='cpu'``); without a card the default raises.
    """

    def __init__(self, model, masses=None, dtype=torch.float64, *, device='cuda'):
        model = as_model_dict(model)
        if masses is None:
            masses = ATOMIC_MASSES[np.asarray(model['z'], dtype=np.int64)]
        self.device = resolve_device(device)
        self.n_atoms = int(model['z'].shape[0])
        self.sig = float(np.squeeze(model['sig']))
        self.std = float(np.squeeze(model.get('std', 1.0)))
        self.c = float(np.squeeze(model.get('c', 0.0)))
        w = model_to_torch(model, self.device, dtype)
        self.tables = center_tables(*build_tables(w['R_desc'], w['R_d_desc_alpha'], w['desc_perms']))
        self.masses = torch.as_tensor(masses, dtype=dtype, device=self.device)
        self.dtype = dtype
        # On a GPU the blocks replay CUDA graphs captured on this stream;
        # with False they run eagerly there (chip_smoke.py's private oracle).
        self._graphs = self.device.type == 'cuda'
        self._stream = torch.cuda.Stream(self.device) if self._graphs else None

    def energy_forces(self, r):
        """(E, F(N,3)) for a single geometry ``r (N, 3)`` tensor."""
        x, jc = desc_ops.descriptor_jacobian(r.reshape(-1), self.n_atoms)
        E, F = predict_from_tables(
            x[None], jc[None], self.tables, None,
            self.sig, self.std, self.c, n_atoms=self.n_atoms,
        )
        return E[0], F[0].reshape(self.n_atoms, 3)

    def _state(self, x):
        """A fresh ``(N, 3)`` tensor of ``x`` (never the caller's memory: the
        trajectory updates it in place)."""
        x = np.asarray(x).reshape(self.n_atoms, 3)
        return torch.tensor(x, dtype=self.dtype, device=self.device)

    def _fused_nve(self) -> bool:
        """Whether an NVE step is one ``fused_predict.md_step``: where K1 at
        one geometry of the model's width takes the split-T route."""
        return fused_predict.route(self.tables.Xt.shape[1], 1) == 'split_t'

    def _trajectory(self, r0, v0, n_steps, snapshot_every, substep, noise=None, gen=None, energy=None,
                    counter=None):
        """Run ``n_steps // snapshot_every`` blocks of ``snapshot_every``
        substeps and a snapshot; return numpy (R (S,N,3), V, E_pot (S,),
        E_kin).

        ``substep(r, v, f, i)`` is the ``i``-th substep of a program's run of
        them; it may update ``r, v, f`` in place and return them. With
        ``noise`` (a static ``(k, N, 3)`` buffer), each program call first
        draws its substeps' rows of it from ``gen``, eagerly: a graph replays
        its kernels, not its draws, so a captured draw would give every block
        the same noise. With ``energy`` (each substep one fused step,
        ``energy()`` the unscaled energy of the last one), the snapshot takes
        its energy from the block's last step, not from a new prediction. With
        ``counter``, each program call adds its steps to that counter, on the
        host (:meth:`run_nve`'s ``md.fused_steps`` and ``md.unfused_steps``).

        The call is the root span ``md.trajectory`` (with its steps), each
        snapshot's block ``md.blocks`` and the trajectory's copy to the host
        ``md.to_host``: the root's self time is the state and the first
        forces.
        """
        n, dev = self.n_atoms, self.device
        n_snap = n_steps // snapshot_every
        per = min(snapshot_every, GRAPH_MAX_STEPS)
        n_full, rest = divmod(snapshot_every, per)
        if not rest:
            n_full, rest = n_full - 1, per
        with graphs.on_stream(self._stream), profiling.span('md.trajectory', steps=n_steps):
            r, v = self._state(r0), self._state(v0)
            f = self.energy_forces(r)[1]
            traj = (torch.empty((n_snap, n, 3), dtype=self.dtype, device=dev),
                    torch.empty((n_snap, n, 3), dtype=self.dtype, device=dev),
                    torch.empty(n_snap, dtype=self.dtype, device=dev),
                    torch.empty(n_snap, dtype=self.dtype, device=dev))
            slot = torch.zeros(1, dtype=torch.int64, device=dev)
            pool = torch.cuda.graph_pool_handle() if self._graphs else None

            def program(k, snapshot):
                def body():
                    rk, vk, fk = r, v, f
                    for i in range(k):
                        rk, vk, fk = substep(rk, vk, fk, i)
                    for dst, src in ((r, rk), (v, vk), (f, fk)):
                        if src is not dst:
                            dst.copy_(src)
                    if snapshot:
                        E = self.energy_forces(r)[0] if energy is None else (energy() * self.std + self.c)[0]
                        ke = 0.5 * torch.sum(self.masses[:, None] * v * v)
                        for out, x in zip(traj, (r, v, E, ke)):
                            out.index_copy_(0, slot, x[None])
                        slot.add_(1)

                run = graphs.Program(body, self._graphs, pool)
                if noise is None and counter is None:
                    return run

                def call():
                    if noise is not None:
                        noise[:k].normal_(generator=gen)
                    run()
                    if counter is not None:
                        profiling.count(counter, k)

                return call

            full = program(per, False) if n_full else None
            last = program(rest, True)
            for _ in range(n_snap):
                with profiling.span('md.blocks'):
                    for _ in range(n_full):
                        full()
                    last()
            with profiling.span('md.to_host'):
                return tuple(x.cpu().numpy() for x in traj)

    def run_nve(self, r0, v0, dt, n_steps, snapshot_every: int = 1):
        """NVE (velocity Verlet). Returns (R (S,N,3), V, E_pot (S,), E_kin).

        Where K1 at one geometry takes the split-T route, each step is one
        ``fused_predict.md_step`` (one kernel on a GPU) and each snapshot's
        energy the last step's; elsewhere the step's operations run one by
        one around ``predict_from_tables``. Under a profiler session the
        steps are counted by route: ``md.fused_steps`` and
        ``md.unfused_steps``."""
        inv_m = 1.0 / self.masses[:, None]
        if self._fused_nve():
            work = (fused_predict.MDStepWork(*self.tables.Xt.shape, self.dtype, self.device)
                    if self.device.type == 'cuda' else None)
            last = []  # the last step's E_raw

            def step(r, v, f, i):
                last[:] = [fused_predict.md_step(r, v, f, inv_m, self.tables, self.sig, self.std, dt, work=work)]
                return r, v, f

            return self._trajectory(r0, v0, n_steps, snapshot_every, step, energy=lambda: last[0],
                                    counter='md.fused_steps')

        def substep(r, v, f, i):
            v_half = v + 0.5 * dt * f * inv_m
            r = r + dt * v_half
            _, f = self.energy_forces(r)
            v = v_half + 0.5 * dt * f * inv_m
            return r, v, f

        return self._trajectory(r0, v0, n_steps, snapshot_every, substep, counter='md.unfused_steps')

    def run_langevin(
        self, r0, v0, dt, n_steps, friction=0.01, kT=0.1, seed=0,
        snapshot_every: int = 1,
    ):
        """Langevin (BAOAB) thermostatted dynamics on the device. The noise
        comes from a ``torch.Generator`` on the device seeded with ``seed``,
        drawn for each program's substeps before it runs; its numbers differ
        from ``jax.random``'s."""
        inv_m = 1.0 / self.masses[:, None]
        c1 = math.exp(-friction * dt)
        sigma_v = torch.sqrt(kT * (1 - c1**2) / self.masses)[:, None]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        noise = torch.empty((min(snapshot_every, GRAPH_MAX_STEPS), self.n_atoms, 3), dtype=self.dtype,
                            device=self.device)

        def substep(r, v, f, i):
            v = v + 0.5 * dt * f * inv_m
            r = r + 0.5 * dt * v
            v = c1 * v + sigma_v * noise[i]
            r = r + 0.5 * dt * v
            _, f = self.energy_forces(r)
            v = v + 0.5 * dt * f * inv_m
            return r, v, f

        return self._trajectory(r0, v0, n_steps, snapshot_every, substep, noise, gen)
