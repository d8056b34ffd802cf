"""The one traffic generator: it reads a mix's parameters and drives the
program through the driver that the mix's ``kind`` names.

A driver is the file ``kinds/<kind>.py`` (``kinds/train.py``,
``kinds/serve.py``, ``kinds/md.py``), found by that name, whose class
``Driver`` subclasses :class:`Kind`. Each makes its inputs from the seed
(:class:`Seeds`) in ``setup``, warms up the shapes its traffic uses there,
runs one unit of work per ``unit`` call (one training, request or chunk,
ended on the host), keeps what the check will judge and what the per-layer
metrics read, and judges it against the plain reference in ``judge``, after
``free`` has dropped the program's state. ``control`` gives the readings
that the limits of ``correct`` are set from (``control.py``).

So a later mix of a known kind is a data file, and a new kind is a new
driver file.
"""

from __future__ import annotations

import gc
import importlib.util
import pathlib

import numpy as np
import torch

from . import synthetic

__all__ = ['Kind', 'Seeds', 'altered', 'load', 'load_file', 'make']

ROOT = pathlib.Path(__file__).resolve().parent
# Standard atomic weights (u) of the synthetic molecules' elements.
MASSES = {1: 1.008, 6: 12.011, 7: 14.007, 8: 15.999}


class Seeds:
    """Independent draws from one run seed, one stream per purpose."""

    def __init__(self, seed: int):
        self._root = np.random.SeedSequence(int(seed) % (1 << 63))

    def state(self, name: str) -> int:
        """A 32-bit seed for ``name``, the same for the same run seed."""
        key = sum(ord(ch) << (8 * i) for i, ch in enumerate(name[:8]))
        return int(np.random.SeedSequence(self._root.entropy, spawn_key=(key,)).generate_state(1)[0])

    def rng(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self.state(name))


def dataset(config, seeds, n_frames):
    """The configuration's trajectory: drawn from the run's seed, or from
    the configuration's own ``data_seed`` where it fixes the data."""
    seed = config.get('data_seed', seeds.state('data'))
    return synthetic.generate_md_dataset(config['n_atoms'], n_frames, config['molecule_seed'], seed,
                                         **config.get('trajectory', {}))


def task(trainer, config, ds, seeds, n_valid):
    """The training task. Where the configuration fixes the data
    (``data_seed``), its split too, and the run's seed only orders the
    training points."""
    fixed = 'data_seed' in config
    split = np.random.RandomState(config['data_seed'] if fixed else seeds.state('split'))
    out = trainer.create_task(ds, config['n_train'], ds, n_valid, sig=config['sig'], lam=config['lam'],
                              use_sym=config['use_sym'], use_E=config['use_E'], use_E_cstr=config['use_E_cstr'],
                              rng=split)
    if fixed:
        order = seeds.rng('order').permutation(config['n_train'])
        for key in ('R_train', 'F_train', 'E_train', 'idxs_train'):
            if key in out:
                out[key] = out[key][order]
    return out


def altered(x, index=0, share=0.01):
    """A copy of x with one entry moved by ``share`` of x's largest value:
    a planted fault of the control's readings."""
    x = np.array(x, dtype=np.float64, copy=True)
    flat = x.reshape(-1)
    flat[index % flat.size] += share * np.max(np.abs(flat))
    return x


class Kind:
    """What the drivers share: the records the per-layer metrics read, and
    dropping the program's state (the attributes ``program_state`` names)
    before the reference runs."""

    program_state = ()

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seeds = config, traffic, Seeds(seed)
        self.device = torch.device(device)
        self.records = {}

    def free(self):
        for name in self.program_state:
            setattr(self, name, None)
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


def load_file(root, folder: str, name: str):
    """The module ``<folder>/<name>.py`` under ``root``, or under this
    folder where ``root`` has no such file."""
    path = pathlib.Path(root or ROOT) / folder / (name + '.py')
    if not path.exists():
        path = ROOT / folder / (name + '.py')
    spec = importlib.util.spec_from_file_location('benchmark.%s.%s' % (folder, name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(kind: str, root=None):
    """The ``Driver`` class of ``kinds/<kind>.py``."""
    return load_file(root, 'kinds', kind).Driver


def make(config, traffic, seed, device, root=None):
    return load(traffic['kind'], root)(config, traffic, seed, device)
