"""The sequence rules of the JAX package's fluid/ops_impl/extra_ops.py
(:183-257; reference paddle/fluid/operators/{sequence_concat,
sequence_slice,sequence_erase}_op.cc). The module's other 25 rules (the
extra losses, norms, proximal optimizers, fake quantize, spp, unpool, ...)
wait for the rest of the training surface (ROADMAP.md Queue A, "The rest
of the training surface").

Each rule keeps the padded layout: gathers along the time axis with the
positions computed on the device, so a captured step runs them.
"""
import torch

from ..lowering import register, data_of, SeqValue
from .sequence_ops import _trailing


def _along_time(data, idx):
    """data [B, T, ...] gathered at idx [B, T'] along the time axis."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (data.ndim - 2))
    return torch.take_along_dim(data, idx, dim=1)


@register('sequence_concat')
def _sequence_concat(ins, attrs, ctx):
    """out_i = [a_i; b_i; ...]: corresponding sequences joined along time,
    ragged, in a padded axis of the summed widths."""
    vals = list(ins['X'])
    if not all(isinstance(v, SeqValue) for v in vals):
        raise TypeError('sequence_concat expects lod inputs')
    b = vals[0].data.shape[0]
    total = sum(v.data.shape[1] for v in vals)
    dev = vals[0].data.device
    cols = torch.arange(total, device=dev)[None, :]          # [1, Tt]
    out = vals[0].data.new_zeros((b, total) + tuple(vals[0].data.shape[2:]))
    start = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    for v in vals:
        lens = v.lengths.reshape(b, 1).long()
        local = cols - start                                 # [B, Tt]
        inside = (local >= 0) & (local < lens)
        idx = torch.clamp(local, 0, v.data.shape[1] - 1)
        out = torch.where(_trailing(inside, out.ndim),
                          _along_time(v.data, idx), out)
        start = start + lens
    new_lens = vals[0].lengths.long()
    for v in vals[1:]:
        new_lens = new_lens + v.lengths.long()
    return {'Out': SeqValue(out, new_lens)}


@register('sequence_slice')
def _sequence_slice(ins, attrs, ctx):
    """Each sequence's rows [Offset, Offset + Length), padded to the
    input's time axis."""
    x = ins['X'][0]
    if not isinstance(x, SeqValue):
        raise TypeError('sequence_slice expects a lod input')
    off = data_of(ins['Offset'][0]).reshape(-1).long()
    length = data_of(ins['Length'][0]).reshape(-1).long()
    t = x.data.shape[1]
    cols = torch.arange(t, device=x.data.device)[None, :]
    out = _along_time(x.data, torch.clamp(off[:, None] + cols, 0, t - 1))
    keep = _trailing(cols < length[:, None], out.ndim)
    return {'Out': SeqValue(torch.where(keep, out, 0), length)}


@register('sequence_erase')
def _sequence_erase(ins, attrs, ctx):
    """Every occurrence of the `tokens` removed and each sequence compacted
    to the front, in order (a stable sort on the drop mask)."""
    x = ins['X'][0]
    if not isinstance(x, SeqValue):
        raise TypeError('sequence_erase expects a lod input')
    data = x.data
    flat = data.reshape(data.shape[0], data.shape[1])
    valid = x.mask(torch.bool)
    drop = torch.zeros_like(valid)
    for tok in attrs.get('tokens', []):
        drop = drop | (flat == int(tok))
    keep = valid & ~drop
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compacted = torch.take_along_dim(flat, order, dim=1)
    new_lens = keep.sum(dim=1)
    cols = torch.arange(flat.shape[1], device=flat.device)[None, :]
    compacted = torch.where(cols < new_lens[:, None], compacted, 0)
    return {'Out': SeqValue(compacted.reshape(data.shape), new_lens)}
