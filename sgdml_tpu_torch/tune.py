"""Inference auto-tuner with a persistent benchmark cache.

The reference hill-climbs (num_workers x chunk_size x bulk_mp) process
configurations and caches results in ``_bmark_cache.npz``
(sgdml/predict.py:770-1127). Here one knob remains: ``batch_size``, the
geometries per device call, which trades the fixed cost of a call against
the size of its chunk. This module measures a small ladder of batch sizes
once per (molecule size, model size, dtype, device) and persists the winner.

The cache is the port's own file (``.bmark_cache_torch.json`` beside the
package, or ``$SGDML_TPU_TORCH_BMARK_CACHE``), so that a key measured by one
package is never replayed for the other.
"""

from __future__ import annotations

import json
import logging
import os
import timeit

import numpy as np
import torch

log = logging.getLogger(__name__)

_CACHE_ENV = 'SGDML_TPU_TORCH_BMARK_CACHE'
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.bmark_cache_torch.json',
)

BUCKET_LADDER = (64, 128, 256, 512, 1024)


def _cache_path() -> str:
    return os.environ.get(_CACHE_ENV, _DEFAULT_CACHE)


def _load_cache() -> dict:
    path = _cache_path()
    if os.path.exists(path):
        try:
            with open(path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            pass
    return {}


def _save_cache(cache: dict):
    try:
        with open(_cache_path(), 'w') as fh:
            json.dump(cache, fh, indent=1)
    except OSError:
        pass


def reset_cache():
    path = _cache_path()
    if os.path.exists(path):
        os.remove(path)
        return True
    return False


def _dtype_name(dtype) -> str:
    return 'none' if dtype is None else str(dtype).replace('torch.', '')


def _cache_key(n_atoms, n_train, n_perms, n_bulk, dtype, transfer_dtype, device, n_dev=1) -> str:
    # The card's name (not just 'cuda') is part of the key: a batch size
    # tuned on one GPU model must not be replayed on another, nor one tuned
    # for a mesh of n_dev devices on another mesh.
    device = torch.device(device)
    dev = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    return '%d-%d-%d-%d-%s-%s-%dx%s' % (
        n_atoms, n_train, n_perms, n_bulk, _dtype_name(dtype), _dtype_name(transfer_dtype), n_dev, dev
    )


def prepare_parallel(predictor, n_bulk: int = 1000, n_reps: int = 3,
                     use_cache: bool = True):
    """Pick the fastest batch size for ``predictor`` and install it.

    Returns the measured throughput (geometries/sec) at the chosen size.
    Results are cached per (N, M, P, n_bulk, dtype, transfer dtype, device).
    """
    key = _cache_key(
        predictor.n_atoms,
        predictor.n_train,
        predictor.n_perms,
        n_bulk,
        predictor.dtype,
        predictor.transfer_dtype,
        predictor.device,
        getattr(predictor, '_n_dev', 1),
    )
    cache = _load_cache() if use_cache else {}
    if key in cache:
        predictor.batch_size = int(cache[key]['batch_size'])
        log.info(
            'Using cached batch size %d (%.0f geoms/sec).',
            predictor.batch_size,
            cache[key]['gps'],
        )
        return cache[key]['gps']

    rng = np.random.default_rng(0)
    R = rng.normal(size=(n_bulk, predictor.dim_i))

    best = (None, 0.0)
    for bucket in BUCKET_LADDER:
        # Measure every rung up to and *including* the first one that
        # covers the whole request in a single call; only rungs beyond
        # that are pure padding waste.
        if bucket >= 2 * max(n_bulk, 32):
            break
        predictor.batch_size = bucket
        predictor.predict(R[:bucket])  # warm-up (kernel build, allocator)
        times = []
        for _ in range(n_reps):
            t0 = timeit.default_timer()
            predictor.predict(R)
            times.append(timeit.default_timer() - t0)
        gps = n_bulk / min(times)
        log.info('bucket %4d -> %.0f geoms/sec', bucket, gps)
        if gps > best[1]:
            best = (bucket, gps)

    predictor.batch_size = best[0]
    if use_cache:
        cache[key] = {'batch_size': best[0], 'gps': best[1]}
        _save_cache(cache)
    return best[1]
