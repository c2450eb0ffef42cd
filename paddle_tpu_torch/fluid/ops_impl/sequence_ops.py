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
    w = data_of(ins['W'][0])
    ids_v = ins['Ids'][0]
    ids = data_of(ids_v).long()
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = F.embedding(ids, w)
    pad = attrs.get('padding_idx')
    if pad is not None and pad >= 0:
        # rows of the padding id read as zeros (the JAX rule zeroes the
        # table row before the gather; masking the gathered rows gives the
        # same values without copying the table)
        out = out.masked_fill((ids == pad).unsqueeze(-1), 0.0)
    return {'Out': like(ids_v, out)}
