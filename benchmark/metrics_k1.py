"""K1's kernels (``sgdml_tpu_torch/csrc/fused_predict.cu``) in a device trace.

PyTorch 2.11's profiler on the H100 reports the kernels of the port's own
nvcc-built library (loaded by ctypes) with an empty name, and that library
holds K1's kernels alone; a profiler that names them gives the one-pass
kernel, or passes A and B and the reduction, as
:func:`benchmark.trace.short_name` shortens them. Anchored at the start, so
that PyTorch's own ``at::native::reduce_kernel`` does not match.
"""

K1_KERNELS = r'^$|^(fused_predict_kernel|planes_kernel|forces_kernel|reduce_kernel)<'
