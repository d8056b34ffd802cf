"""sGDML on PyTorch and CUDA: the serving path of ``sgdml_tpu`` for NVIDIA GPUs.

Symmetric Gradient Domain Machine Learning (sGDML) reconstructs
energy-conserving molecular force fields by kernel ridge regression in the
gradient domain. This package serves trained models -- batched energy and
force prediction and molecular dynamics -- with PyTorch tensors on an
explicit device. Its one hand-written kernel, the fused (E, F) contraction
(``ops/fused_predict.py``, ``csrc/fused_predict.cu``), runs every CUDA
prediction; CPU tensors take its plain PyTorch version.

Module names mirror ``sgdml_tpu`` one for one. Model files (the
reference's ``.npz`` layout) move freely between the two packages. This
package imports neither JAX nor ``sgdml_tpu``.
"""

import logging

__version__ = '0.1.0'

# Custom log level between INFO and WARNING signalling the completion of a
# pipeline step (mirrors the reference's logging UX, sgdml/__init__.py:31).
LOG_LEVEL_DONE = 25
logging.addLevelName(LOG_LEVEL_DONE, 'DONE')


def _done(self, message, *args, **kws):
    if self.isEnabledFor(LOG_LEVEL_DONE):
        self._log(LOG_LEVEL_DONE, message, args, **kws)


logging.Logger.done = _done
