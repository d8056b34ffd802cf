"""``md``: ``MDEngine.run_nve`` from a model trained in set-up, a chunk of
``chunk_steps`` at a time, each chunk continuing the last; the start a
seeded frame at seeded thermal velocities (``kT``)."""

from __future__ import annotations

import numpy as np
import torch
from sgdml_tpu_torch.md import MDEngine
from sgdml_tpu_torch.ops import fused_predict
from sgdml_tpu_torch.train import GDMLTrain

from benchmark import generator
from benchmark.reference import md as ref_md
from benchmark.reference import predict as ref_predict
from benchmark.reference import train as ref_train


class Driver(generator.Kind):
    program_state = ('engine',)

    def setup(self):
        c, tr = self.config, self.traffic
        ds = generator.dataset(c, self.seeds, c['n_frames'])
        trainer = GDMLTrain(device=self.device)
        task = generator.task(trainer, c, ds, self.seeds, c['n_valid'])
        model = trainer.train(task)
        self.task, self.trained = task, model
        self.masses = np.array([generator.MASSES[int(z)] for z in model['z']])
        self.engine = MDEngine(model, masses=self.masses, device=self.device)
        rng = self.seeds.rng('start')
        self.r = ds['R'][rng.integers(len(ds['R']))]
        self.v = rng.standard_normal(self.r.shape) * np.sqrt(tr['kT'] / self.masses)[:, None]
        self.pick = self.seeds.rng('check')
        self.pairs, self.seen, self.final = [], 0, None
        self.records['steps'] = self.records['k1_calls'] = 0
        every = tr['snapshot_every']
        self.engine.run_nve(self.r, self.v, tr['dt'], 2 * every, snapshot_every=every)

    def unit(self):
        tr = self.traffic
        calls = fused_predict.LAUNCHES
        R, V, E_pot, E_kin = self.engine.run_nve(self.r, self.v, tr['dt'], tr['chunk_steps'],
                                                 snapshot_every=tr['snapshot_every'])
        self.records['k1_calls'] += fused_predict.LAUNCHES - calls
        snaps = [{'r': R[i], 'v': V[i], 'E_pot': E_pot[i], 'E_kin': E_kin[i]} for i in range(len(R))]
        if self.final is not None:
            snaps.insert(0, self.final[1])
        for pair in zip(snaps[:-1], snaps[1:]):
            self._keep(pair)
        self.final = (snaps[-2], snaps[-1])
        self.r, self.v = R[-1], V[-1]
        self.records['steps'] += tr['chunk_steps']
        return tr['chunk_steps']

    def _keep(self, pair):
        """Reservoir sampling of ``check_pairs`` consecutive snapshots."""
        self.seen += 1
        k = self.traffic['check_pairs']
        if len(self.pairs) < k:
            self.pairs.append(pair)
        else:
            j = int(self.pick.integers(self.seen))
            if j < k:
                self.pairs[j] = pair

    def _model(self, dtype):
        """The reference's force field: the coefficients that the program
        trained in set-up (judged on their own by :meth:`judge`), with the
        label scale and the integration constant worked out again here."""
        t, sig = self.task, self.config['sig']
        alphas = self.trained['alphas_F']
        std, c = ref_train.scales(alphas, t['R_train'], t['F_train'], t['E_train'], sig, self.device)
        return ref_predict.Model(t['R_train'], alphas, sig, std, c, self.device, dtype)

    def _judge_md(self, model, pairs):
        tr = self.traffic
        return ref_md.judge(model, self.masses, tr['dt'], tr['snapshot_every'], pairs)

    def judge(self):
        """The trajectory, on the coefficients that the program trained in
        set-up; and that training itself, as the training cells judge it."""
        t = self.task
        numbers = self._judge_md(self._model(torch.float64), self.pairs + [self.final])
        numbers.update(ref_train.judge(self.trained, t['R_train'], t['F_train'], t['E_train'], self.config['sig'],
                                       self.config['lam'], self.device))
        return numbers

    def control(self):
        """The sound reading; a step that returns its state unchanged; a
        position altered; and the reference's steps in float32 (TF32 off) in
        the program's place."""
        out = {'sound': self.judge()}
        model = self._model(torch.float64)
        pairs = self.pairs + [self.final]
        out['state_unchanged'] = self._judge_md(model, [(a, dict(a)) for a, _ in pairs])
        last = dict(pairs[-1][1], r=generator.altered(pairs[-1][1]['r'], 5))
        out['answer_altered'] = self._judge_md(model, pairs[:-1] + [(pairs[-1][0], last)])
        torch.backends.cuda.matmul.allow_tf32 = False
        low = self._model(torch.float32)
        tr = self.traffic
        first = np.stack([a['r'] for a, _ in pairs]), np.stack([a['v'] for a, _ in pairs])
        r, v, E, ke = ref_md.integrate(low, *first, self.masses, tr['dt'], tr['snapshot_every'])
        E0, _ = low.predict(first[0])
        m = np.asarray(self.masses)[None, :, None]
        ke0 = 0.5 * np.sum(m * first[1].astype(np.float32) ** 2, axis=(1, 2))
        ctrl = [({'r': a['r'], 'v': a['v'], 'E_pot': E0[i], 'E_kin': ke0[i]},
                 {'r': r[i], 'v': v[i], 'E_pot': E[i], 'E_kin': ke[i]}) for i, (a, _) in enumerate(pairs)]
        out['control'] = self._judge_md(model, ctrl)
        return out
