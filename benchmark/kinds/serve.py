"""``serve``: one client in a closed loop of ``GDMLPredict.predict``
requests (numpy in, numpy out), as ``sgdml test`` and ``validate`` send
them: each pass of ``passes`` geometries, drawn without repeats from the
held-out frames (``pool``) in an order from the seed, goes out in requests
of ``request`` geometries and one remainder. Every seed sends the same
sizes. The served model is MD22-sized: the configuration's training
geometries with coefficients drawn from the seed."""

from __future__ import annotations

import timeit

import numpy as np
import torch
from sgdml_tpu_torch.ops import descriptor as desc_ops
from sgdml_tpu_torch.predict import GDMLPredict
from sgdml_tpu_torch.train import GDMLTrain

from benchmark import generator
from benchmark.reference import predict as ref_predict


class Driver(generator.Kind):
    program_state = ('pred',)

    def setup(self):
        c, tr = self.config, self.traffic
        ds = generator.dataset(c, self.seeds, c['n_train'] + tr['pool'])
        trainer = GDMLTrain(device=self.device)
        task = generator.task(trainer, c, ds, self.seeds, 0)
        R = torch.as_tensor(task['R_train'].reshape(c['n_train'], -1), dtype=torch.float64, device=self.device)
        X, Jc = desc_ops.descriptor_batch(R, c['n_atoms'])
        self.alphas = self.seeds.rng('alphas').standard_normal(c['n_train'] * 3 * c['n_atoms'])
        self.std = float(np.std(task['F_train']))
        self.c = float(np.mean(task['E_train']))
        model = trainer.create_model(task, 'analytic', X, Jc, self.std, self.alphas)
        model['c'] = self.c
        del X, Jc, R
        self.R_train = task['R_train']
        self.pool = ds['R'][np.setdiff1d(np.arange(len(ds['R'])), task['idxs_train'])]
        self.pred = GDMLPredict(model, dtype=getattr(torch, tr['dtype']), batch_size=tr['batch_size'],
                                device=self.device)
        self.queue, self.order = [], self.seeds.rng('requests')
        self.pick = self.seeds.rng('check')
        self.kept, self.longest = [], None
        self.records['requests'] = []
        # Warm-up: every request size of the traffic once.
        for b in sorted({len(r) for r in self._round()}):
            self.pred.predict(self.pool[:b].reshape(b, -1))

    def _round(self):
        """The requests of one round of passes: lists of pool indices."""
        frames = self.order.permutation(len(self.pool))
        out, start, step = [], 0, self.traffic['request']
        for n in self.traffic['passes']:
            out += [frames[i:min(i + step, start + n)] for i in range(start, start + n, step)]
            start += n
        return out

    def unit(self):
        if not self.queue:
            self.queue = self._round()[::-1]
        R = self.pool[self.queue.pop()]
        B = R.shape[0]
        t0 = timeit.default_timer()
        E, F = self.pred.predict(R.reshape(B, -1))
        seconds = timeit.default_timer() - t0
        self.records['requests'].append((B, seconds))
        answer = (R, E, F)
        if self.longest is None or B > self.longest[0].shape[0]:
            self.longest = answer
        if self.pick.random() < self.traffic['check_share']:
            self.kept.append(answer)
        return B

    def _model(self, dtype):
        return ref_predict.Model(self.R_train, self.alphas, self.config['sig'], self.std, self.c, self.device,
                                 dtype)

    def judge(self):
        """A share of the window's answers drawn from the seed, and the
        longest."""
        return ref_predict.judge(self._model(torch.float64), self.kept + [self.longest])

    def control(self):
        """The sound reading; an answer altered; half of a request the mean
        of the rest; and the reference in float32 (TF32 off) in the
        program's place."""
        answers = self.kept + [self.longest]
        out = {'sound': self.judge()}
        model = self._model(torch.float64)
        R, E, F = self.longest
        half = max(F.shape[0] // 2, 1)
        F_half, E_half = np.array(F, copy=True), np.array(E, copy=True)
        F_half[half:] = F_half[:half].mean(axis=0)
        E_half[half:] = E_half[:half].mean()
        out['answer_altered'] = ref_predict.judge(model, answers[:-1] + [(R, E, generator.altered(F, 11))])
        out['half_left_out'] = ref_predict.judge(model, answers[:-1] + [(R, E_half, F_half)])
        torch.backends.cuda.matmul.allow_tf32 = False
        low = self._model(torch.float32)
        out['control'] = ref_predict.judge(model, [(R_, *low.predict(R_)) for R_, _, _ in answers])
        return out
