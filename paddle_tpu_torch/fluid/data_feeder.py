"""DataFeeder: minibatch rows -> feed dict.

Parity: reference python/paddle/fluid/data_feeder.py and the JAX package's
fluid/data_feeder.py. A sequence slot (lod_level > 0) becomes a padded
lowering.SeqValue whose time axis is bucketed to a power of two, at least
8 (the JAX :14-68), so a captured step sees few distinct shapes: each
bucket is one step artifact and one captured graph. Nested LoD whose
innermost sequences all have length 1 keeps a time axis of 1 (seq_pad).
"""
import numpy as np
import torch

from .framework import Variable, default_main_program

__all__ = ['DataFeeder']


def _bucket(n, minimum=8):
    """The least power-of-two multiple of `minimum` that holds n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def seq_pad(lod):
    """The padded time axis of a sequence feed with recursive sequence
    lengths `lod` (outermost first): the bucket of its longest innermost
    sequence, except 1 for nested LoD whose innermost sequences all have
    length 1. That narrow form is the decode idiom's 2-level init_ids /
    init_scores (one row a group), which the LoD beam decoder recognizes
    by a time axis of 1 as the JAX package does (it pads to the longest
    sequence). Decided on the host from the lengths, so it is part of the
    feed signature."""
    inner = lod[-1] if lod else []
    longest = max(inner, default=1)
    if len(lod) > 1 and longest == 1 and min(inner, default=1) == 1:
        return 1
    return _bucket(longest)


def _flatten_lod(value, lod_level, rows, lod):
    """Walk one sample of a lod_level-deep slot: every innermost entry
    goes to `rows`, each level's sequence length to lod[level]."""
    if lod_level == 0:
        rows.append(value)
        return
    lod[0].append(len(value))
    for each in value:
        _flatten_lod(each, lod_level - 1, rows, lod[1:])


def _seq_slot(samples, lod_level, dtype):
    """One sequence slot of a batch as a SeqValue of CPU tensors: data
    [n_seqs, bucket, ...] (zeros past each length), int64 lengths of the
    innermost level and, for a 2-level slot, the outer level's lengths."""
    from .lowering import SeqValue
    rows, lod = [], [[] for _ in range(lod_level)]
    for value in samples:
        _flatten_lod(value, lod_level, rows, lod)
    flat = np.asarray(rows, dtype=dtype)
    if flat.ndim == 1:
        flat = flat[:, None]
    lens = np.asarray(lod[-1], dtype=np.int64)
    outer = (torch.from_numpy(np.asarray(lod[0], np.int64))
             if lod_level > 1 else None)
    maxlen = seq_pad([[int(n) for n in lv] for lv in lod])
    padded = np.zeros((len(lens), maxlen) + flat.shape[1:], dtype=dtype)
    off = 0
    for i, n in enumerate(lens):
        padded[i, :n] = flat[off:off + n]
        off += n
    return SeqValue(torch.from_numpy(padded), torch.from_numpy(lens), outer)


class DataFeeder(object):
    """Turns an iterable of samples (one entry per feed slot) into
    {name: ndarray}, each slot stacked along a new batch dim and reshaped
    to [-1] + the var's declared shape when the sample's own rank differs
    (a flat 784-float image for a [1, 28, 28] var; a scalar label for
    [1]). A sequence slot comes out as a SeqValue (see _seq_slot). The
    Executor moves the values to its device. A bfloat16 slot (numpy has no
    such dtype) is stacked in float32 and rounded to bf16 by torch: it
    comes out as a CPU bf16 tensor."""

    def __init__(self, feed_list, place, program=None):
        if program is None:
            program = default_main_program()
        self.feed_names, self.feed_dtypes, self.feed_shapes = [], [], []
        self.feed_lod_level = []
        for var in feed_list:
            if isinstance(var, str):
                var = program.global_block().var(var)
            if not isinstance(var, Variable):
                raise TypeError("Feed list should contain Variables or names")
            self.feed_names.append(var.name)
            self.feed_lod_level.append(var.lod_level or 0)
            self.feed_dtypes.append(var.dtype)
            self.feed_shapes.append(
                [d for d in var.shape if d != -1] if var.shape else None)
        self.place = place

    def feed(self, iterable):
        slots = [[] for _ in self.feed_names]
        for sample in iterable:
            if len(sample) != len(slots):
                raise ValueError('feed sample has %d slots, expected %d'
                                 % (len(sample), len(slots)))
            for slot, value in zip(slots, sample):
                slot.append(value)
        out = {}
        for name, dtype, shape, lod, data in zip(
                self.feed_names, self.feed_dtypes, self.feed_shapes,
                self.feed_lod_level, slots):
            if lod:
                out[name] = _seq_slot(data, lod, dtype)
                continue
            half = dtype == 'bfloat16'
            arr = np.array(data, dtype='float32' if half else dtype)
            if shape and arr.ndim != len(shape) + 1:
                arr = arr.reshape([-1] + [abs(int(s)) for s in shape])
            out[name] = torch.from_numpy(arr).to(torch.bfloat16) if half \
                else arr
        return out
