"""Mesh / sharding / collective utilities: the data-parallel half.

Parity: the JAX package's parallel/__init__.py (:45-330), which expresses
parallelism as jax.sharding over a device Mesh and lets XLA GSPMD insert
the collectives into ONE program. The port runs one process per rank on
torch.distributed (NCCL on the card, gloo on the CPU): every rank runs the
same Program on its own rows of the batch, and the step inserts the
collectives itself (fluid/mesh_step.py), so that a dp=N step computes what
the single-device step computes on the whole batch.

  * `init_distributed` joins the process group; `process_count` and
    `process_index` read it.
  * `make_mesh` builds a `Mesh` of named axes over the world's ranks (row
    major), with this rank's coordinates. Only the data axis may exceed
    size 1: tensor, sequence and pipeline axes wait for ROADMAP.md Queue A,
    "Parallel".
  * A `NamedSharding(mesh, P(...))` names, per dim, the axis a tensor is
    split over. `shard_batch`, `replicate`, `shard_optimizer_states`,
    `fsdp_shard_params` and `shard_params_by_rules` return THIS rank's part
    of each value (its block of every dp-split dim) on the mesh's device
    (`mesh_device`: the card under NCCL, the CPU under gloo), tagged with
    its sharding as the attribute `sharding`.
  * `psum`, `all_gather`, `reduce_scatter` and `ppermute` run over an
    axis's process group and carry gradients (parallel/_comm.py).
"""
import collections
import os
import re
import warnings

import numpy as np
import torch
import torch.distributed as dist

from . import _comm

__all__ = ['fsdp_shard_params',
           'make_mesh', 'data_sharding', 'replicated', 'shard_batch',
           'replicate', 'shard_params_by_rules', 'psum', 'all_gather',
           'reduce_scatter', 'ppermute', 'shard_optimizer_states',
           'init_multihost', 'init_distributed', 'process_count',
           'process_index', 'global_batch', 'Mesh', 'NamedSharding', 'P',
           'moe_apply', 'stack_expert_params', 'LocalSGD', 'LocalRows',
           'full_state', 'mesh_device']
# the JAX names annotate_tp, auto_tp_rules, ring_*, ulysses_*, pipeline_*,
# stack_stage_params, Heartbeat and HostLost wait for the later parts of
# ROADMAP.md Queue A, "Parallel"

_PARALLEL = 'ROADMAP.md Queue A, "Parallel"'


def _not_ported(what):
    raise NotImplementedError(
        '%s waits for the port\'s tensor, sequence and pipeline parallelism '
        '(%s)' % (what, _PARALLEL))


class P(tuple):
    """PartitionSpec: per dim, a mesh axis name, None (whole), or a tuple of
    axis names."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self):
        return 'PartitionSpec%s' % (tuple.__repr__(self),)


class Mesh(object):
    """Named axes over the world's ranks, row major (the JAX Mesh over
    devices): `shape` {axis: size}, `axis_names`, `size`, this rank's
    `coords` {axis: index}, and `devices`, the rank ids laid out as the
    axes. `group(axis)` is the process group along an axis; only a mesh
    whose other axes are all of size 1 has one (the world's group, or None
    for a one-rank mesh without a process group)."""

    def __init__(self, axes, rank=0, group=None):
        self.shape = collections.OrderedDict(
            (str(n), int(s)) for n, s in axes.items())
        self.axis_names = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values()) or [1]))
        self.rank = int(rank)
        self.devices = np.arange(self.size).reshape(
            tuple(self.shape.values()))
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        self.coords = collections.OrderedDict(
            (n, int(i)) for n, i in zip(self.axis_names, idx))
        self._group = group

    def group(self, axis):
        if axis not in self.shape:
            raise ValueError('%r is not a mesh axis (have %r)'
                             % (axis, list(self.shape)))
        if any(s > 1 for n, s in self.shape.items() if n != axis):
            _not_ported('a collective along one axis of the multi-axis mesh '
                        '%r' % (dict(self.shape),))
        return self._group

    def __repr__(self):
        return 'Mesh(%r, rank=%d)' % (dict(self.shape), self.rank)


class NamedSharding(object):
    """A PartitionSpec against a Mesh."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def split_dims(self):
        """[(dim, axis)] of the dims split over an axis of size > 1."""
        out = []
        for d, e in enumerate(self.spec):
            names = e if isinstance(e, tuple) else (e,)
            live = [a for a in names if a is not None
                    and self.mesh.shape.get(a, 1) > 1]
            if len(live) > 1 or (live and len(names) > 1):
                _not_ported('sharding one dim over several axes (%r)' % (e,))
            if live:
                out.append((d, live[0]))
        return out

    def __repr__(self):
        return 'NamedSharding(%r, %r)' % (self.mesh, self.spec)


class LocalRows(object):
    """A feed value that already holds THIS rank's rows of the global batch
    (global_batch's result): the executor takes it as it is."""

    __slots__ = ('value',)

    def __init__(self, value):
        self.value = value


def _world():
    return dist.is_available() and dist.is_initialized()


def process_count():
    """Number of ranks in the process group; 1 without one."""
    return dist.get_world_size() if _world() else 1


def process_index():
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if _world() else 0


def _env_int(*names):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ''):
            return int(v)
    return None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, backend=None,
                     store=None):
    """Join the process group every rank of a mesh runs in (the JAX :45,
    which wraps jax.distributed.initialize).

    Each argument defaults from the environment: the world size from
    WORLD_SIZE, else PADDLE_TRAINERS, else 1; the rank from RANK, else
    PADDLE_TRAINER_ID, else 0; the coordinator from MASTER_ADDR and
    MASTER_PORT, else the first of PADDLE_TRAINER_ENDPOINTS. `store` (a
    torch.distributed Store, e.g. a FileStore) replaces the coordinator;
    a one-rank world needs neither (an in-process HashStore).

    backend: None or 'nccl' joins with NCCL on cuda:<local rank> (the
    LOCAL_RANK environment, else local_device_ids[0], else the rank modulo
    the cards present) and raises without a card; 'gloo' joins on the CPU.
    NCCL's communicator is created here, before any CUDA graph capture: the
    group is bound to the card (`device_id=`) and runs one all_reduce.

    Returns {'num_processes', 'process_id', 'initialized', 'backend',
    'device'}; a second call returns the group already joined."""
    if _world():
        return _describe(dist.get_backend())
    n = num_processes if num_processes is not None else \
        _env_int('WORLD_SIZE', 'PADDLE_TRAINERS')
    n = 1 if n is None else int(n)
    rank = process_id if process_id is not None else \
        _env_int('RANK', 'PADDLE_TRAINER_ID')
    rank = 0 if rank is None else int(rank)
    if not 0 <= rank < n:
        raise ValueError('process_id %d is not in a world of %d'
                         % (rank, n))
    backend = backend or 'nccl'
    if backend not in ('nccl', 'gloo'):
        raise ValueError("backend must be 'nccl' (the card) or 'gloo' (the "
                         "CPU), got %r" % (backend,))
    device = None
    if backend == 'nccl':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'init_distributed: no CUDA device is available for NCCL; '
                "pass backend='gloo' to run the ranks on the CPU")
        local = _env_int('LOCAL_RANK')
        if local is None:
            local = (int(local_device_ids[0]) if local_device_ids
                     else rank % torch.cuda.device_count())
        device = torch.device('cuda', local)
        torch.cuda.set_device(device)
    kw = {}
    if store is not None:
        kw['store'] = store
    elif n == 1:
        kw['store'] = dist.HashStore()
    else:
        if coordinator_address is None:
            addr = os.environ.get('MASTER_ADDR')
            if addr:
                coordinator_address = '%s:%s' % (
                    addr, os.environ.get('MASTER_PORT', '29500'))
            else:
                eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
                if eps:
                    coordinator_address = eps.split(',')[0].strip()
        if coordinator_address is None:
            raise ValueError(
                'init_distributed needs coordinator_address (or a store), '
                'num_processes and process_id for a %r-process cluster '
                '(got %r, %r, %r)' % (n, coordinator_address, n, rank))
        kw['init_method'] = 'tcp://%s' % coordinator_address
    if device is not None:
        kw['device_id'] = device
    dist.init_process_group(backend, rank=rank, world_size=n, **kw)
    if device is not None:
        # the communicator exists before any capture: one collective now
        dist.all_reduce(torch.zeros(1, device=device))
        torch.cuda.synchronize(device)
    return _describe(backend)


def _describe(backend):
    dev = None
    if backend == 'nccl':
        dev = 'cuda:%d' % torch.cuda.current_device()
    return {'num_processes': dist.get_world_size(),
            'process_id': dist.get_rank(), 'initialized': True,
            'backend': backend, 'device': dev or 'cpu'}


_mh_warned = [False]


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, local_device_ids=None, backend=None,
                   store=None):
    """The reference launcher's PADDLE_TRAINER_* environment as a cluster
    (the JAX :126): a deprecated shim over init_distributed that returns
    False, and joins nothing, when neither arguments nor environment
    describe more than one process."""
    if not _mh_warned[0]:
        _mh_warned[0] = True
        warnings.warn(
            'parallel.init_multihost is deprecated: call '
            'parallel.init_distributed(coordinator_address=..., '
            'num_processes=..., process_id=...) — init_multihost remains '
            'only for PADDLE_TRAINER_* env-driven launchers.',
            DeprecationWarning, stacklevel=2)
    if coordinator_address is None:
        eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
        if eps:
            coordinator_address = eps.split(',')[0].strip()
    if num_processes is None and os.environ.get('PADDLE_TRAINERS'):
        num_processes = int(os.environ['PADDLE_TRAINERS'])
    if process_id is None and os.environ.get('PADDLE_TRAINER_ID'):
        process_id = int(os.environ['PADDLE_TRAINER_ID'])
    if ((coordinator_address is None and store is None) or process_id is None
            or num_processes in (None, 0, 1)):
        return False
    init_distributed(coordinator_address, num_processes, process_id,
                     local_device_ids, backend=backend, store=store)
    return True


def make_mesh(axes=None, devices=None):
    """A Mesh from {'dp': 2}-style axis sizes (row major) over the world's
    ranks. The mesh needs a world of exactly its size (the JAX :194-206
    raises when there are too few devices): with no process group the
    world is this one process. `devices` is accepted for the JAX
    signature; the ranks are the devices."""
    world = process_count()
    if axes is None:
        axes = {'dp': world}
    axes = collections.OrderedDict(axes)
    n = int(np.prod(list(axes.values()) or [1]))
    if n > world:
        raise ValueError('mesh needs %d devices, only %d available'
                         % (n, world))
    if n < world:
        raise ValueError('mesh of %d ranks in a world of %d: every rank '
                         'must hold a mesh coordinate' % (n, world))
    return Mesh(axes, rank=process_index(),
                group=dist.group.WORLD if _world() else None)


def data_sharding(mesh, axis='dp', ndim=2):
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh):
    return NamedSharding(mesh, P())


def mesh_device(mesh):
    """The device a mesh's collectives run on, where its values live: the
    current card under an NCCL group, the CPU under gloo; a mesh without a
    process group (one rank) uses the card when there is one."""
    group = mesh._group
    if group is None:
        return torch.device('cuda', torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device('cpu')
    if dist.get_backend(group) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _as_tensor(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    a = np.asarray(value)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _local_block(t, sharding):
    """This rank's block of the global tensor t under `sharding`."""
    mesh = sharding.mesh
    for d, axis in sharding.split_dims():
        n = mesh.shape[axis]
        if t.shape[d] % n:
            raise ValueError('dim %d of size %d does not split over %r=%d'
                             % (d, t.shape[d], axis, n))
        b = t.shape[d] // n
        t = t.narrow(d, mesh.coords[axis] * b, b)
    return t


def _place(value, sharding):
    t = _as_tensor(value, mesh_device(sharding.mesh))
    t = _local_block(t, sharding).contiguous().clone()
    t.sharding = sharding
    return t


def shard_batch(mesh, value, axis='dp'):
    """This rank's rows of a host batch (split along its leading dim), on
    the mesh's device."""
    t = _as_tensor(value, mesh_device(mesh))
    return _place(t, data_sharding(mesh, axis, max(t.ndim, 1)))


def replicate(mesh, value):
    return _place(value, replicated(mesh))


def global_batch(sharding, local_data):
    """Mark `local_data` as THIS rank's rows of the global batch (the JAX
    :104 assembles the global array from each process's rows; here each
    rank keeps its rows): the executor feeds a LocalRows value as it is,
    where it would otherwise take this rank's rows of a global feed."""
    return LocalRows(local_data)


def shard_params_by_rules(values, mesh, rules):
    """Apply shardings by name pattern (the JAX :210): values {name:
    array}, rules [(regex, PartitionSpec)]; unmatched names replicate. A
    spec that does not fit its value warns and replicates, as the JAX
    function does. Returns this rank's block of each value."""
    out = {}
    for name, v in values.items():
        spec = None
        for pat, s in rules:
            if re.search(pat, name):
                spec = s
                break
        try:
            out[name] = _place(v, NamedSharding(
                mesh, spec if spec is not None else P()))
        except ValueError as e:
            warnings.warn(
                'shard_params_by_rules: %s does not fit spec %s (%s); '
                'replicating instead' % (name, spec, e))
            out[name] = replicate(mesh, v)
    return out


def _already_mesh_placed(v):
    sh = getattr(v, 'sharding', None)
    return (isinstance(sh, NamedSharding)
            and any(s is not None for s in sh.spec))


def shard_optimizer_states(values, mesh, axis='dp'):
    """ZeRO sharding of optimizer accumulators over the dp axis (the JAX
    :249): each value whose leading dim divides the axis keeps this rank's
    rows; values a previous pass sharded stay as they are."""
    out = {}
    n = mesh.shape[axis]
    for name, v in values.items():
        if _already_mesh_placed(v):
            out[name] = v
            continue
        t = _as_tensor(v, mesh_device(mesh))
        if t.ndim >= 1 and t.shape[0] % n == 0:
            out[name] = _place(t, NamedSharding(
                mesh, P(axis, *([None] * (t.ndim - 1)))))
        else:
            out[name] = replicate(mesh, t)
    return out


# ZeRO-3's floor: smaller values stay whole (the JAX parallel_executor.py:31)
FSDP_MIN_SIZE = 1024


def fsdp_dim(shape, n, min_size=FSDP_MIN_SIZE):
    """The dim ZeRO-3 splits a value of `shape` over n ranks: the first
    that divides, for values of at least min_size elements; None keeps it
    whole."""
    if not shape or int(np.prod(shape)) < min_size:
        return None
    for d, s in enumerate(shape):
        if s % n == 0:
            return d
    return None


def fsdp_shard_params(values, mesh, axis='dp', min_size=FSDP_MIN_SIZE):
    """ZeRO-3 parameter sharding (the JAX :268): every value of at least
    min_size elements splits over the data axis along its first divisible
    dim; smaller ones replicate. The step gathers such a parameter at use
    and reduce-scatters its gradient."""
    out = {}
    n = mesh.shape[axis]
    for name, v in values.items():
        if _already_mesh_placed(v):
            out[name] = v
            continue
        t = _as_tensor(v, mesh_device(mesh))
        d = fsdp_dim(tuple(t.shape), n, min_size)
        spec = P() if d is None else P(*([None] * d), axis)
        out[name] = _place(t, NamedSharding(mesh, spec))
    return out


def _group_of(axis_name, mesh):
    if mesh is not None:
        return mesh.group(axis_name)
    if not _world():
        raise RuntimeError('no process group: call '
                           'parallel.init_distributed() first')
    return dist.group.WORLD


# -- collectives along a mesh axis (differentiable) --
def psum(x, axis_name, mesh=None):
    """Sum of x over the ranks along `axis_name` (without `mesh`: the whole
    world, a dp-only mesh)."""
    return _comm.all_reduce(x, 'sum', _group_of(axis_name, mesh))


def all_gather(x, axis_name, axis=0, tiled=True, mesh=None):
    """The ranks' x along `axis` (tiled) or stacked on a new `axis`."""
    if not tiled:
        x = x.unsqueeze(axis)
    return _comm.all_gather(x, axis, _group_of(axis_name, mesh))


def reduce_scatter(x, axis_name, scatter_dimension=0, mesh=None):
    return _comm.reduce_scatter(x, scatter_dimension, 'sum',
                                _group_of(axis_name, mesh))


def ppermute(x, axis_name, perm, mesh=None):
    return _comm.ppermute(x, perm, _group_of(axis_name, mesh))


def full_state(program, scope):
    """{name: full tensor} of every scope-initialized persistable of a mesh
    program: a value the executor holds as this rank's block (ZeRO) is
    gathered from the ranks; every rank must call it."""
    from ..fluid import mesh_step
    return mesh_step.full_state(program, scope)


from .moe import moe_apply, stack_expert_params  # noqa: E402
from .local_sgd import LocalSGD  # noqa: E402
