"""Device meshes over ``torch.distributed`` and the collectives the port uses.

The JAX package drives every device from one process through a
``jax.sharding.Mesh``; here each device has its own process, and a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialised world. A rank's device is ``cuda:LOCAL_RANK`` (NCCL) unless the
caller asks for the CPU (gloo). Nothing falls back: a CUDA mesh needs the
NCCL backend and a card, a CPU mesh gloo.

:func:`init_distributed` sets up the world, from explicit arguments or from
``torchrun``'s environment; a world of one may be made in-process, with no
launcher. :func:`mesh_info` reads the group, rank, size and device of a
mesh, and the helpers below it wrap the collectives (``all_gather``,
``all_reduce``, ``broadcast``) in forms that every supported PyTorch has.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import resolve_device

__all__ = [
    'MeshInfo',
    'agree',
    'all_gather_rows',
    'all_reduce_',
    'check_device',
    'default_mesh',
    'init_distributed',
    'is_writer',
    'mesh_2d',
    'mesh_device',
    'mesh_info',
]

log = logging.getLogger(__name__)

# Collectives that wait longer than this raise instead of hanging a rank.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

_BACKEND = {'cuda': 'nccl', 'cpu': 'gloo'}


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'))


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device='cuda', timeout=None) -> bool:
    """Initialise the default process group, once per process.

    From explicit arguments (``world_size`` and ``rank``, with an
    ``init_method`` such as ``'tcp://localhost:<port>'`` or
    ``'file://<path>'``; a world of one needs none: its store lives in this
    process) or from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``). ``device``: ``'cuda'`` (the default)
    takes NCCL and binds the rank to ``cuda:LOCAL_RANK``; ``'cpu'`` takes
    gloo. ``timeout`` bounds every collective (default 30 minutes).

    Returns False, and does nothing, when neither arguments nor the
    environment ask for a world, so that callers may call it
    unconditionally; True when the world exists afterwards.
    """
    explicit = world_size is not None or init_method is not None
    if not explicit and not _torchrun_env():
        return False
    if dist.is_initialized():
        return True
    device = resolve_device(device)
    backend = _BACKEND[device.type]
    if device.type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK', rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs = {'backend': backend, 'timeout': timeout or DEFAULT_TIMEOUT}
    if explicit:
        if world_size is None or rank is None:
            raise ValueError('init_distributed: pass world_size and rank with init_method')
        if init_method is None:
            if world_size != 1:
                raise ValueError('init_distributed: a world of %d ranks needs an init_method' % world_size)
            kwargs['store'] = dist.HashStore()
        else:
            kwargs['init_method'] = init_method
        kwargs.update(world_size=world_size, rank=rank)
    else:
        kwargs['init_method'] = 'env://'
    dist.init_process_group(**kwargs)
    log.info('torch.distributed initialised: rank %d of %d (%s).', dist.get_rank(), dist.get_world_size(), backend)
    return True


def _check_world(device_type: str, n: int):
    if not dist.is_initialized():
        raise RuntimeError('no torch.distributed world: call init_distributed() first (or run under torchrun)')
    world = dist.get_world_size()
    if n > world:
        raise ValueError('a mesh of %d devices needs %d ranks; the world has %d' % (n, n, world))
    backend = str(dist.get_backend())
    if _BACKEND[device_type] not in backend:
        raise ValueError('a %s mesh needs the %s backend; the world runs %s' % (
            device_type, _BACKEND[device_type], backend))


def default_mesh(n_devices: int | None = None, device='cuda') -> DeviceMesh:
    """1-D mesh, its axis named ``'dev'``, over the first ``n_devices`` ranks
    of the world (None or -1: all of them). Every rank of the world calls it.
    Raises when the world is smaller, or when its backend does not serve
    ``device``'s type."""
    device_type = torch.device(device).type
    world = dist.get_world_size() if dist.is_initialized() else 0
    n = world if n_devices in (None, -1) else int(n_devices)
    _check_world(device_type, n)
    if n == world:
        return init_device_mesh(device_type, (n,), mesh_dim_names=('dev',))
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=('dev',))


def mesh_2d(rows: int, cols: int, device='cuda') -> DeviceMesh:
    """2-D mesh ``(rows, cols)``, its axes named ``('r', 'c')``, over the
    first ``rows * cols`` ranks. The
    port's distributed factorization shards rows over all of its ranks."""
    device_type = torch.device(device).type
    _check_world(device_type, rows * cols)
    if rows * cols == dist.get_world_size():
        return init_device_mesh(device_type, (rows, cols), mesh_dim_names=('r', 'c'))
    return DeviceMesh(device_type, torch.arange(rows * cols).reshape(rows, cols), mesh_dim_names=('r', 'c'))


class MeshInfo(NamedTuple):
    """What a sharded function needs of a mesh: the process group over all
    of its ranks, this rank's index and the count in it, and its device."""

    group: object
    rank: int
    size: int
    device: torch.device


def mesh_info(mesh) -> MeshInfo:
    """The group, rank, size and device of ``mesh`` (a ``DeviceMesh``).

    A 1-D mesh's group is its own; a 2-D mesh must span the world, whose
    group then orders its ranks row-major. Raises ``TypeError`` for anything
    but a ``DeviceMesh`` and ``ValueError`` on a rank outside the mesh.
    """
    if not isinstance(mesh, DeviceMesh):
        raise TypeError('mesh must be a torch.distributed.device_mesh.DeviceMesh, got %s' % type(mesh).__name__)
    if mesh.get_coordinate() is None:
        raise ValueError('rank %d is not in the mesh %s' % (dist.get_rank(), mesh))
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    else:
        flat = mesh.mesh.flatten().tolist()
        if flat != list(range(dist.get_world_size())):
            raise ValueError('a %d-D mesh must span the world in rank order' % mesh.ndim)
        group = dist.group.WORLD
    if mesh.device_type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())
    elif mesh.device_type == 'cpu':
        device = torch.device('cpu')
    else:
        raise ValueError('unsupported mesh device type %r' % mesh.device_type)
    return MeshInfo(group, dist.get_rank(group), dist.get_world_size(group), device)


def mesh_device(info: MeshInfo, device=None) -> torch.device:
    """This rank's device of the mesh; raises ``ValueError`` when ``device``
    (where given) names another."""
    if device is not None:
        d = torch.device(device)
        if d.type != info.device.type or (d.index is not None and d.index != info.device.index):
            raise ValueError('device %s disagrees with the mesh, whose device on this rank is %s' % (d, info.device))
    return info.device


def check_device(info: MeshInfo, *tensors):
    """Raise ``ValueError`` unless every tensor lies on the mesh's device."""
    for t in tensors:
        if t is not None and t.device != info.device:
            raise ValueError('a tensor on %s was given to a mesh on %s' % (t.device, info.device))


def all_gather_rows(t: torch.Tensor, info: MeshInfo) -> torch.Tensor:
    """Concatenate every rank's ``t`` (equal shapes) along dim 0, in rank
    order: the list form of ``all_gather``, which gloo and NCCL both serve
    in every supported PyTorch."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(info.size)]
    dist.all_gather(parts, t, group=info.group)
    return torch.cat(parts)


def all_reduce_(t: torch.Tensor, info: MeshInfo) -> torch.Tensor:
    """Sum ``t`` over the mesh in place (``t`` must be contiguous); every
    rank gets the same bits."""
    dist.all_reduce(t, group=info.group)
    return t


def agree(values, info: MeshInfo) -> np.ndarray:
    """Rank 0's copy of the host numbers ``values``, on every rank: each
    decision a rank takes from data (a stop, a restart, a retry) is taken
    from these, so that no rank leaves a collective the others enter."""
    t = torch.as_tensor(np.asarray(values, dtype=np.float64), device=info.device).reshape(-1).contiguous()
    dist.broadcast(t, src=dist.get_global_rank(info.group, 0), group=info.group)
    return t.cpu().numpy()


def is_writer() -> bool:
    """Whether this process writes files and prints: rank 0 of the world, or
    any process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0
