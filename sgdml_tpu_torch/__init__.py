"""sGDML on PyTorch and CUDA: ``sgdml_tpu`` for NVIDIA GPUs.

Symmetric Gradient Domain Machine Learning (sGDML) reconstructs
energy-conserving molecular force fields by kernel ridge regression in the
gradient domain. This package trains models (symmetry discovery, then a
dense kernel assembly and an f64 Cholesky solve; past the dense bound an
f32 block-grid Cholesky with f64 refinement CG, or Nystrom-preconditioned
CG) and serves them -- batched energy and
force prediction and molecular dynamics -- with PyTorch tensors; the command
line ``sgdml-tpu-torch`` (``cli.py``) runs the whole workflow. Every
engine runs on the GPU (``device='cuda'``) unless the caller asks for the
CPU. Its one hand-written kernel, the fused (E, F) contraction
(``ops/fused_predict.py``, ``csrc/fused_predict.cu``), runs every CUDA
prediction, every CG matvec included; CPU tensors take its plain PyTorch
version.

Module names mirror ``sgdml_tpu`` one for one. Model files (the
reference's ``.npz`` layout) move freely between the two packages. This
package imports neither JAX nor ``sgdml_tpu``.
"""

import logging

import torch

__version__ = '0.1.0'

# Custom log level between INFO and WARNING signalling the completion of a
# pipeline step (mirrors the reference's logging UX, sgdml/__init__.py:31).
LOG_LEVEL_DONE = 25
logging.addLevelName(LOG_LEVEL_DONE, 'DONE')


def _done(self, message, *args, **kws):
    if self.isEnabledFor(LOG_LEVEL_DONE):
        self._log(LOG_LEVEL_DONE, message, args, **kws)


logging.Logger.done = _done


def resolve_device(device) -> torch.device:
    """The engines' device: ``'cuda'`` by default, the CPU only when asked.

    Raises ``RuntimeError`` for a CUDA device when PyTorch sees no card, so
    that nothing falls back to the CPU unasked.
    """
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is False); "
            "pass device='cpu' to run on the CPU"
        )
    return device
