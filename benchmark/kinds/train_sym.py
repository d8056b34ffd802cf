"""``train_sym``: ``GDMLTrain.train`` of one symmetric task back to back, as
``train`` does, on the C3v molecule of ``synthetic_sym``: the task comes
from ``GDMLTrain.create_task`` (through ``generator.task``) with the
dataset's permutations, so no symmetry search runs, and each training is
judged by the permutation-summed reference (``reference/sym.py``) for the
group the configuration asks for, kept from the set-up: the dataset's where
it sets ``use_sym``, the identity alone where not; never the task's or the
model's own. A task or model whose group is another, or a group whose order
is not the configuration's ``n_perms``, reads an infinite ``model``. Each
training's record holds that group's order as ``n_perms``.

The set-up trains twice: the first training is the process's first use of
every kernel and shape; both records stay apart as ``warmups``, untraced."""

from __future__ import annotations

import math

import numpy as np
import torch
from sgdml_tpu_torch.train import GDMLTrain

from benchmark import generator, synthetic_sym
from benchmark.kinds import train as base
from benchmark.reference import sym as ref_sym


def _group(perms) -> set:
    return {tuple(int(i) for i in p) for p in np.asarray(perms)}


class Driver(base.Driver):

    def setup(self):
        c = self.config
        seed = c.get('data_seed', self.seeds.state('data'))
        ds = synthetic_sym.generate_md_dataset(c['n_atoms'], c['n_frames'], c['molecule_seed'], seed,
                                               **c.get('trajectory', {}))
        self.perms = np.array(ds['perms'] if c['use_sym'] else np.arange(c['n_atoms'])[None, :], copy=True)
        self.trainer = GDMLTrain(device=self.device)
        self.task = generator.task(self.trainer, c, ds, self.seeds, c['n_valid'])
        self.models, self.records['trainings'] = [], []
        for _ in range(2):
            self._train()
        self.records['warmups'] = self.records['trainings']
        self.models, self.records['trainings'] = [], []

    def _train(self):
        super()._train()
        self.records['trainings'][-1]['n_perms'] = len(self.perms)

    def _kept(self, perms) -> bool:
        """``perms`` is the group the configuration asks for, of the order
        it states (where it states one)."""
        order = self.config.get('n_perms', len(self.perms))
        return len(self.perms) == order and _group(perms) == _group(self.perms)

    def _judge(self, model):
        t, c = self.task, self.config
        got = ref_sym.judge(model, t['R_train'], t['F_train'], t['E_train'], self.perms, c['sig'], c['lam'],
                            self.device)
        if not (self._kept(t['perms']) and self._kept(model['perms'])):
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
            got = self._judge(self.models[i])
            worst = {n: max(worst.get(n, 0.0), v) if np.isfinite(v) else math.inf for n, v in got.items()}
        return worst

    def control(self):
        """The sound reading; ``train``'s faults planted in the last model;
        ``perms_ignored``, a model of the same task trained without the
        group (``use_sym=False``) and judged for it; and the reference
        trained in float32 (TF32 off) in the program's place."""
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
        out.update({k: self._judge(m) for k, m in faults.items()})
        self.models = []
        t = self.task
        trainer = GDMLTrain(device=self.device)
        plain = trainer.train(dict(t, use_sym=False, perms=np.arange(c['n_atoms'])[None, :]),
                              **self.traffic.get('train_args', {}))
        out['perms_ignored'] = self._judge(dict(plain, perms=self.perms))
        del trainer
        self.free()
        low = ref_sym.train(t['R_train'], t['F_train'], t['E_train'], self.perms, c['sig'], c['lam'], self.device,
                            torch.float32)
        out['control'] = 'crashed: the float32 factor broke down' if low is None else self._judge(
            dict(low, perms=self.perms))
        return out
