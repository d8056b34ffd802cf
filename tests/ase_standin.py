"""A minimal stand-in for the parts of ASE that the sGDML calculators use.

ASE is an optional dependency and is not installed where the tests and the
GPU smoke run. ``installed()`` puts ``ase``, ``ase.calculators``,
``ase.calculators.calculator`` (``Calculator``) and ``ase.units`` (``kcal``,
``mol``) into ``sys.modules`` for the duration of a ``with`` block, so that a
calculator module imported (or reloaded) inside it takes the ASE branch of
its import gate. ``Atoms`` holds positions, as ``ase.Atoms`` does.
"""

import contextlib
import sys
import types

import numpy as np

# ase.units in eV: 1 kcal (4184 J) and Avogadro's number (CODATA 2018).
KCAL = 4184.0 / 1.602176634e-19
MOL = 6.02214076e23


class Calculator:
    """``ase.calculators.calculator.Calculator``: keeps the last atoms and
    the results dict that ``calculate`` fills."""

    def __init__(self, *args, **kwargs):
        self.atoms = None
        self.results = {}

    def calculate(self, atoms=None, properties=None, system_changes=None):
        if atoms is not None:
            self.atoms = atoms


class Atoms:
    def __init__(self, positions):
        self.positions = np.array(positions, dtype=np.float64).reshape(-1, 3)

    def get_positions(self):
        return self.positions.copy()


def _modules():
    ase = types.ModuleType('ase')
    calculators = types.ModuleType('ase.calculators')
    calculator = types.ModuleType('ase.calculators.calculator')
    units = types.ModuleType('ase.units')
    calculator.Calculator = Calculator
    units.kcal, units.mol = KCAL, MOL
    ase.calculators, ase.units, calculators.calculator = calculators, units, calculator
    return {'ase': ase, 'ase.calculators': calculators, 'ase.calculators.calculator': calculator,
            'ase.units': units}


@contextlib.contextmanager
def installed():
    """The stand-in modules in ``sys.modules`` inside the block; what was
    there before is put back after it."""
    mods = _modules()
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
