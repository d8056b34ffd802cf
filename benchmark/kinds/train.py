"""``train``: ``GDMLTrain.train`` of one task, back to back. Every key of
the mix's ``train_args`` goes to ``train()`` as it stands (``solver``,
``factor_slices``, ``solver_max_seconds``)."""

from __future__ import annotations

import math
import timeit

import numpy as np
import torch
from sgdml_tpu_torch.train import GDMLTrain

from benchmark import generator
from benchmark.reference import train as ref_train


class Driver(generator.Kind):
    program_state = ('trainer',)

    def setup(self):
        c = self.config
        ds = generator.dataset(c, self.seeds, c['n_frames'])
        self.trainer = GDMLTrain(device=self.device)
        self.task = generator.task(self.trainer, c, ds, self.seeds, c['n_valid'])
        self.models, self.records['trainings'] = [], []
        self._train()  # the warm-up: every kernel and shape of a training
        self.models.clear()
        self.records['trainings'].clear()

    def _train(self):
        t0 = timeit.default_timer()
        model = self.trainer.train(self.task, **self.traffic.get('train_args', {}))
        seconds = timeit.default_timer() - t0
        self.models.append(model)
        self.records['trainings'].append({
            'seconds': seconds, 'times': dict(self.trainer.times), 'iters': int(model.get('solver_iters', 0)),
            'n_cols': len(model.get('inducing_pts_idxs', ())), 'n': int(np.size(model['alphas_F'])),
        })

    def unit(self):
        self._train()
        return 1

    def _args(self):
        t, c = self.task, self.config
        return t['R_train'], t['F_train'], t['E_train'], c['sig'], c['lam'], self.device

    def judge(self):
        """Every model of the window, or ``check_models`` of them drawn
        from the seed with the last among them."""
        k = self.traffic['check_models']
        last = len(self.models) - 1
        picked = sorted(self.seeds.rng('check').permutation(last)[:k - 1]) + [last]
        worst = {}
        for i in picked:
            got = ref_train.judge(self.models[i], *self._args())
            worst = {n: max(worst.get(n, 0.0), v) if np.isfinite(v) else math.inf for n, v in got.items()}
        return worst

    def control(self):
        """The sound reading; the faults planted in the last model; and the
        reference trained in float32 (TF32 off) in the program's place."""
        c, model = self.config, self.models[-1]
        half = np.array(model['alphas_F'], copy=True).reshape(c['n_train'], -1)
        half[c['n_train'] // 2:] = 0.0
        faults = {
            'answer_altered': dict(model, alphas_F=generator.altered(model['alphas_F'], 7)),
            'state_unchanged': dict(model, alphas_F=np.zeros_like(model['alphas_F'])),
            'half_left_out': dict(model, alphas_F=half.ravel()),
            'table_altered': dict(model, R_d_desc_alpha=generator.altered(model['R_d_desc_alpha'], 7)),
        }
        out = {'sound': self.judge()}
        out.update({k: ref_train.judge(m, *self._args()) for k, m in faults.items()})
        self.models = []
        torch.backends.cuda.matmul.allow_tf32 = False
        t = self.task
        low = ref_train.train(t['R_train'], t['F_train'], t['E_train'], c['sig'], c['lam'], self.device,
                              torch.float32)
        out['control'] = 'crashed: the float32 factor broke down' if low is None else ref_train.judge(
            low, *self._args())
        return out
