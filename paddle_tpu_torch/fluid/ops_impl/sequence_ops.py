"""Embedding rule.

Parity: the JAX package's fluid/ops_impl/sequence_ops.py:22-50 (reference
paddle/fluid/operators/lookup_table_op.*), dense lookup only: the
row-sharded all_to_all wire and the sequence ops wait for later slices.
"""
import torch
import torch.nn.functional as F

from ..lowering import register, data_of, like


@register('lookup_table')
def _lookup_table(ins, attrs, ctx):
    """The rows of W at Ids, with jnp.take's default mode, as the JAX rule
    gathers: an id in [-V, 0) counts from the end, any other id outside
    [0, V) reads a row of NaN. The id is wrapped, clamped and the NaN
    selected on the device, with no host check."""
    w = data_of(ins['W'][0])
    ids_v = ins['Ids'][0]
    ids = data_of(ids_v).long()
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    n = w.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    out = F.embedding(ids.clamp(0, n - 1), w)
    out = torch.where(valid.unsqueeze(-1), out,
                      torch.full_like(out, float('nan')))
    pad = attrs.get('padding_idx')
    if pad is not None and pad >= 0:
        # rows of the padding id read as zeros (the JAX rule zeroes the
        # table row before the gather; masking the gathered rows gives the
        # same values without copying the table)
        out = out.masked_fill((ids == pad).unsqueeze(-1), 0.0)
    return {'Out': like(ids_v, out)}
