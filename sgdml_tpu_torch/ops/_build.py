"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

The sources in ``sgdml_tpu_torch/csrc/*.cu`` have a plain C interface, so
they compile in seconds without PyTorch's headers. The shared library goes
to ``build/kernels/`` beside the package (git-ignored), named by a hash of
the sources and flags so that an edited source is never served stale. The
build runs at first use, in the process that needs the kernel; nothing is
downloaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

__all__ = ['load_library', 'BUILD_DIR']

_CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'kernels'
_FLAGS = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
]


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [os.path.join(cuda_home, 'bin', 'nvcc')] if cuda_home else []
    candidates += [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        'nvcc not found (set CUDA_HOME): the CUDA kernels of sgdml_tpu_torch '
        'are built from source at first use.'
    )


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load ``libsgdml_kernels``; declare its C
    functions' argument and return types."""
    sources = sorted(_CSRC.glob('*.cu'))
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / ('libsgdml_kernels_%s.so' % digest.hexdigest()[:16])
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix('.so.%d.tmp' % os.getpid())
        cmd = [nvcc, *_FLAGS, '-o', str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                'nvcc failed (%d):\n%s\n%s' % (proc.returncode, ' '.join(cmd), proc.stderr)
            )
        # ptxas's report of registers, shared memory and spills per kernel.
        lib_path.with_suffix('.ptxas.txt').write_text(proc.stderr)
        os.replace(tmp, lib_path)

    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    argtypes = {
        # xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, planes, e_part, s_part, device, stream
        'sgdml_planes': [ptr] * 6 + [f64, i32, i32, i32, ptr, ptr, ptr, i32, ptr],
        # xq, xt, ja, planes, e_part, s_part, B, T, D, splits, per, partial, E, F_d, device, stream
        'sgdml_forces': [ptr] * 6 + [i32] * 5 + [ptr, ptr, ptr, i32, ptr],
        # xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, splits, per, scratch, E, F_d, device, stream
        'sgdml_two_pass': [ptr] * 6 + [f64] + [i32] * 5 + [ptr, ptr, ptr, i32, ptr],
        # xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, blocks, part, E, F_d, device, stream
        'sgdml_split_t': [ptr] * 6 + [f64] + [i32] * 4 + [ptr, ptr, ptr, i32, ptr],
        # xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, clusters, part, E, F_d, device, stream
        'sgdml_wide': [ptr] * 6 + [f64] + [i32] * 4 + [ptr, ptr, ptr, i32, ptr],
        # B, device, out
        'sgdml_wide_clusters': [i32, i32, ctypes.POINTER(i32)],
        # xt, ja, xt_sq, tja, mu, inv_m, sig, std, dt, N, T, D, blocks,
        # r, v, f, part, runs, tickets, E, device, stream
        'sgdml_md_step': [ptr] * 6 + [f64] * 3 + [i32] * 4 + [ptr] * 7 + [i32, ptr],
        # x, jc, xp, jcp, gs, pim, sig, scale, N, P, I, T, out, ld, device, stream
        'sgdml_perm_hessian': [ptr] * 6 + [f64] * 2 + [i32] * 4 + [ptr, ctypes.c_int64, i32, ptr],
    }
    for stem, types in argtypes.items():
        for suffix in ('_f32', '_f64'):
            fn = getattr(lib, stem + suffix)
            fn.argtypes = types
            fn.restype = i32
    lib.sgdml_cuda_error_string.argtypes = [i32]
    lib.sgdml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_name(mangled: str) -> str:
    """A kernel's function, scalar type, integer template argument and step
    policy (other than the default ``Queries``) or shape from its mangled
    name, e.g. ``planes_kernel<double>``, ``fused_predict_kernel<float, 4>``,
    ``fused_predict_kernel<double, 1, NveStep>`` or
    ``fused_predict_kernel<double, Wide<4>>``; the mangled name if it has
    none."""
    kind = re.search(r'([a-z_]+_kernel)I([df])(?:Li(\d+)E(?:NS_\d+([A-Za-z]+)I)?|NS_\d+([A-Za-z]+)ILi(\d+)E)?',
                     mangled)
    if not kind:
        return mangled
    shape = kind.group(5) and '%s<%s>' % (kind.group(5), kind.group(6))
    args = [{'d': 'double', 'f': 'float'}[kind.group(2)], kind.group(3), kind.group(4), shape]
    return '%s<%s>' % (kind.group(1), ', '.join(a for a in args if a and a != 'Queries'))


def ptxas_report(lib: ctypes.CDLL) -> dict:
    """``{kernel: 'N registers, M bytes smem, ... spill ...'}`` from the
    ptxas report written beside the library at its build; a kernel is named
    by :func:`kernel_name`."""
    path = pathlib.Path(lib._name).with_suffix('.ptxas.txt')
    report, name = {}, None
    for line in path.read_text().splitlines() if path.exists() else []:
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif name and ('spill' in line or 'Used' in line):
            report[name] = (report.get(name, '') + ' ' + line.split(':', 1)[-1].strip()).strip()
    return report
