"""DataFeeder: minibatch rows -> feed dict.

Parity: reference python/paddle/fluid/data_feeder.py and the JAX package's
fluid/data_feeder.py:71, dense slots only: a sequence slot (lod_level > 0)
needs the SeqValue the port does not carry yet, and raises.
"""
import numpy as np
import torch

from .framework import Variable, default_main_program

__all__ = ['DataFeeder']


class DataFeeder(object):
    """Turns an iterable of samples (one entry per feed slot) into
    {name: ndarray}, each slot stacked along a new batch dim and reshaped
    to [-1] + the var's declared shape when the sample's own rank differs
    (a flat 784-float image for a [1, 28, 28] var; a scalar label for
    [1]). The Executor moves the arrays to its device. A bfloat16 slot
    (numpy has no such dtype) is stacked in float32 and rounded to bf16 by
    torch: it comes out as a CPU bf16 tensor."""

    def __init__(self, feed_list, place, program=None):
        if program is None:
            program = default_main_program()
        self.feed_names, self.feed_dtypes, self.feed_shapes = [], [], []
        for var in feed_list:
            if isinstance(var, str):
                var = program.global_block().var(var)
            if not isinstance(var, Variable):
                raise TypeError("Feed list should contain Variables or names")
            if var.lod_level:
                raise NotImplementedError(
                    'DataFeeder: %r is a sequence slot (lod_level %d); '
                    'sequence feeds wait for SeqValue in the port'
                    % (var.name, var.lod_level))
            self.feed_names.append(var.name)
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
        for name, dtype, shape, data in zip(
                self.feed_names, self.feed_dtypes, self.feed_shapes, slots):
            half = dtype == 'bfloat16'
            arr = np.array(data, dtype='float32' if half else dtype)
            if shape and arr.ndim != len(shape) + 1:
                arr = arr.reshape([-1] + [abs(int(s)) for s in shape])
            out[name] = torch.from_numpy(arr).to(torch.bfloat16) if half \
                else arr
        return out
