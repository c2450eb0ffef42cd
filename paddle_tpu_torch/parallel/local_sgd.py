"""Local SGD: the analogue of the reference's async training mode.

Parity: the JAX package's parallel/local_sgd.py (LocalSGD :42-140). Each dp
replica owns its own parameter copy, takes `sync_steps` purely local
optimizer steps with no cross-replica traffic, then one average over the
ranks mixes the copies: the regime async pserver training targets
(replica divergence between mixes, periodic consensus) with cheaper
communication.

The port runs one process per rank, so a replica is simply this rank's
parameters: `replicate` returns this rank's copy, `shard_batch` its rows of
a global batch, `step` runs the user's torch step function on them, and
`sync` averages every leaf over the mesh axis with one all_reduce each. The
JAX class keeps the N copies on a leading replica axis of one array, so its
`step` returns one aux value per replica; here `step` returns this rank's.
"""
import numpy as np
import torch

from . import _comm, mesh_device
from .moe import _tree_map

__all__ = ['LocalSGD']


class LocalSGD(object):
    """Drive per-replica optimizer steps with periodic parameter averaging.

    step_fn(params, batch) -> (new_params, aux) is the user's purely local
    update (forward, gradient and optimizer) for ONE replica, on trees
    (dicts, lists, tuples) of torch tensors.

        ls = LocalSGD(step_fn, mesh, axis='dp', sync_steps=4)
        params = ls.replicate(params)       # this rank's copy
        for i, batch in enumerate(stream):
            params, aux = ls.step(params, ls.shard_batch(batch))
            if (i + 1) % ls.sync_steps == 0:
                params = ls.sync(params)    # one average over the ranks
        final = ls.collapse(params)         # the consensus copy, numpy

    sync_steps=1 is synchronous data parallelism (every step averages)."""

    def __init__(self, step_fn, mesh, axis='dp', sync_steps=1):
        self.mesh = mesh
        self.axis = axis
        self.sync_steps = int(sync_steps)
        self.n = mesh.shape[axis]
        self._group = mesh.group(axis)
        self.device = mesh_device(mesh)
        self._step_fn = step_fn

    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def replicate(self, params):
        """This rank's copy of every leaf on the mesh's device (the card
        under NCCL, the CPU under gloo); each rank starts from the same
        values."""
        return _tree_map(lambda x: self._tensor(x).clone(), params)

    def shard_batch(self, batch):
        """This rank's rows of a global batch (split along dim 0) on the
        mesh's device; 0-d leaves replicate."""
        r, n = self.mesh.coords[self.axis], self.n

        def place(x):
            t = self._tensor(x)
            if t.ndim == 0:
                return t
            if t.shape[0] % n:
                raise ValueError('batch of %d rows is not divisible by the '
                                 '%r axis size %d' % (t.shape[0], self.axis,
                                                      n))
            b = t.shape[0] // n
            return t[r * b:(r + 1) * b]
        return _tree_map(place, batch)

    def step(self, params, batch):
        """One purely local step (no collectives)."""
        return self._step_fn(params, batch)

    def sync(self, params):
        """Average every leaf over the ranks."""
        if self._group is None:
            return params
        return _tree_map(lambda x: _comm.all_reduce(x.detach(), 'avg',
                                                    self._group), params)

    def collapse(self, params):
        """The averaged copy as numpy arrays."""
        return _tree_map(lambda x: x.detach().cpu().numpy(),
                         self.sync(params))
