"""ASE calculator wrapping the port's GDML predictor.

Drop-in equivalent of the reference's ``SGDMLCalculator``
(sgdml/intf/ase_calc.py:37-106): loads a model npz, converts units
(model default kcal/mol & Angstrom -> ASE eV & Angstrom), and serves
``calculate()`` for ASE molecular dynamics, geometry optimization and
vibrational analysis. Each call is one prediction of one geometry on the
calculator's device: the GPU (the fused (E, F) kernel) unless the caller
asks for the CPU.

ASE is an optional dependency; importing this module without ASE works,
making a calculator raises an informative ImportError.
"""

from __future__ import annotations

import numpy as np

try:
    from ase.calculators.calculator import Calculator
    _HAS_ASE = True
except ImportError:
    _HAS_ASE = False

    class Calculator:  # type: ignore[no-redef]
        """Stub so the module can be imported for inspection without ASE."""

        def __init__(self, *a, **kw):
            raise ImportError(
                'Optional ASE dependency not found! Install ase to use the '
                'calculator interface.'
            )


class SGDMLCalculator(Calculator):
    """ASE calculator backed by a (s)GDML model on a PyTorch device."""

    implemented_properties = ['energy', 'forces']

    def __init__(
        self,
        model_path,
        E_to_eV=None,
        F_to_eV_Ang=None,
        use_torch=False,  # accepted for API parity; ignored (always PyTorch)
        *args,
        device='cuda',
        **kwargs,
    ):
        if not _HAS_ASE:
            raise ImportError(
                'Optional ASE dependency not found! Install ase to use the '
                'calculator interface.'
            )
        super().__init__(*args, **kwargs)

        from ..models.gdml import as_model_dict
        from ..predict import GDMLPredict

        # Typed front door: a GDMLModel, a model dict, or a file path.
        self.gdml_predict = GDMLPredict(
            as_model_dict(model_path), batch_size=1, device=device
        )

        # Unit conversion (reference default: kcal/mol -> eV).
        if E_to_eV is None:
            try:
                from ase.units import kcal, mol

                E_to_eV = kcal / mol
            except ImportError:
                E_to_eV = 0.0433641153087705
        self.E_to_eV = E_to_eV
        self.F_to_eV_Ang = F_to_eV_Ang if F_to_eV_Ang is not None else E_to_eV
        # Positions are converted with the inverse force factor ratio
        # (reference: ase_calc.py:84-91).
        self.Ang_to_R = self.F_to_eV_Ang / self.E_to_eV

    def calculate(self, atoms=None, *args, **kwargs):
        super().calculate(atoms, *args, **kwargs)
        r = np.array(atoms.get_positions()) * self.Ang_to_R
        e, f = self.gdml_predict.predict(r.ravel())
        self.results = {
            'energy': float(e[0]) * self.E_to_eV,
            'forces': f.reshape(-1, 3) * self.F_to_eV_Ang,
        }
