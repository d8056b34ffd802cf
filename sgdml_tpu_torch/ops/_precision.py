"""Full-precision float32 matrix products for the ops that need them.

TF32 keeps about three decimal digits. The centered Gram form of the
prediction contraction and the f32 factor of the analytic grid route both
need true f32 products (the JAX package forces ``'highest'`` matmul
precision for the same reasons).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _true_f32(dtype):
    """True-f32 matrix products inside the block for float32 ``dtype``; a
    no-op for any other dtype."""
    if dtype != torch.float32:
        yield
        return
    prev = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision('highest')
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if torch.get_float32_matmul_precision() != 'highest' or torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError('could not switch float32 matmuls to full precision')
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
