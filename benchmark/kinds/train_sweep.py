"""``train_sweep``: ``sgdml all``'s sigma grid, one ``GDMLTrain.train`` a
unit at the mix's ``sigs`` in turn, on one task. The mix's ``data_seed``
fixes the trajectory and the split, so that every seed meets each sigma on
the same problem and takes the same route, and the run's seed orders the
training points. The warm-up trains once at each sigma, so that no route
is first taken in the window; its records stay apart as ``warmups``.

Each model is judged at the sigma the driver asked for, which its training
record holds, and not at the ``sig`` the program wrote into the model: a
model whose ``sig`` is another (a model of an earlier sigma handed back
again) reads an infinite ``model``."""

from __future__ import annotations

import math

import numpy as np
from sgdml_tpu_torch.train import GDMLTrain

from benchmark import generator
from benchmark.kinds import train as base
from benchmark.reference import train as ref_train


class Driver(base.Driver):

    def __init__(self, config, traffic, seed, device):
        super().__init__(dict(config, data_seed=traffic['data_seed']), traffic, seed, device)
        self.turn = 0

    def setup(self):
        c = self.config
        ds = generator.dataset(c, self.seeds, c['n_frames'])
        self.trainer = GDMLTrain(device=self.device)
        self.task = generator.task(self.trainer, c, ds, self.seeds, c['n_valid'])
        self.models, self.records['trainings'] = [], []
        for _ in self.traffic['sigs']:
            self.unit()
        self.records['warmups'] = self.records['trainings']
        self.models, self.records['trainings'] = [], []
        self.turn = 0

    def unit(self):
        sigs = self.traffic['sigs']
        self.task['sig'] = sigs[self.turn % len(sigs)]
        self.turn += 1
        self._train()
        self.records['trainings'][-1]['sig'] = self.task['sig']
        return 1

    def _judge(self, i):
        """Model i at the sigma its training was asked for."""
        t, c = self.task, self.config
        model, sig = self.models[i], self.records['trainings'][i]['sig']
        got = ref_train.judge(model, t['R_train'], t['F_train'], t['E_train'], sig, c['lam'], self.device)
        if float(np.squeeze(model['sig'])) != sig:
            got['model'] = math.inf
        return got

    def judge(self):
        """Every model of the window, or ``check_models`` of them drawn
        from the seed with the last among them."""
        k = self.traffic['check_models']
        last = len(self.models) - 1
        picked = sorted(self.seeds.rng('check').permutation(last)[:k - 1]) + [last]
        worst = {}
        for i in picked:
            got = self._judge(i)
            worst = {n: max(worst.get(n, 0.0), v) if np.isfinite(v) else math.inf for n, v in got.items()}
        return worst

    def control(self):
        """``train``'s readings, the faults and the float32 control at the
        sigma of the last training."""
        self.config = dict(self.config, sig=self.records['trainings'][-1]['sig'])
        return super().control()
