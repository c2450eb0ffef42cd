"""LoDTensor: host-side ragged tensor with recursive sequence lengths.

Parity: reference python/paddle/fluid/lod_tensor.py +
paddle/fluid/framework/lod_tensor.h, and the JAX package's
fluid/lod_tensor.py. The reference stores sequences flattened
[total_tokens, d] plus a level-of-detail offset table; the port computes on
the padded lowering.SeqValue, and this class converts between the two at
the host boundary (numpy in, CPU tensors out; the Executor moves them).
"""
import numpy as np
import torch

__all__ = ['LoDTensor', 'LoDTensorArray', 'create_lod_tensor',
           'create_random_int_lodtensor']


def _lengths_to_offsets(lengths):
    out = [0]
    for n in lengths:
        out.append(out[-1] + n)
    return out


def _tensor(a):
    return torch.from_numpy(np.array(a, copy=True))


class LoDTensor(object):
    def __init__(self, data=None, recursive_seq_lens=None):
        self.data = None if data is None else np.asarray(data)
        self._lengths = recursive_seq_lens or []

    # -- reference API --
    def set(self, data, place=None):
        self.data = np.asarray(data)

    def set_recursive_sequence_lengths(self, lengths):
        self._lengths = lengths

    def recursive_sequence_lengths(self):
        return self._lengths

    def set_lod(self, lod):
        self._lengths = [list(np.diff(level)) for level in lod]

    def lod(self):
        return [_lengths_to_offsets(level) for level in self._lengths]

    def has_valid_recursive_sequence_lengths(self):
        """The reference's CheckLoD: level k's entry count equals the sum
        of level k-1's lengths, and the innermost lengths sum to the
        number of data rows."""
        if not self._lengths:
            return True
        for outer, inner in zip(self._lengths, self._lengths[1:]):
            if len(inner) != sum(outer):
                return False
        total = sum(self._lengths[-1])
        return total == (self.data.shape[0] if self.data is not None else 0)

    def __array__(self, dtype=None, copy=None):
        a = self.data
        return a.astype(dtype) if dtype is not None else a

    def shape(self):
        return list(self.data.shape)

    # -- flattened + lod <-> padded SeqValue --
    def to_seq_value(self, pad_to=None):
        """The padded SeqValue of CPU tensors: data [n_seqs, max_len (or
        pad_to), ...] with each sequence's rows at its front and zeros
        after, int64 lengths, and every level above the innermost as
        outer_lengths (outermost first). A tensor without lod comes back
        as a plain tensor."""
        from .lowering import SeqValue
        if not self._lengths:
            return _tensor(self.data)
        lens = np.asarray(self._lengths[-1], dtype=np.int64)
        b = len(lens)
        maxlen = int(lens.max()) if b else 0
        if pad_to:
            maxlen = pad_to
        trail = self.data.shape[1:]
        padded = np.zeros((b, maxlen) + tuple(trail), dtype=self.data.dtype)
        off = 0
        for i, n in enumerate(lens):
            padded[i, :n] = self.data[off:off + n]
            off += n
        outer = None
        if len(self._lengths) > 1:
            outer = tuple(_tensor(np.asarray(lv, np.int64))
                          for lv in self._lengths[:-1])
        return SeqValue(_tensor(padded), _tensor(lens), outer)

    @staticmethod
    def from_seq_value(sv):
        """The flat LoDTensor of a SeqValue (its valid rows in order),
        read on the host. A capacity-form 2-level value (the LoD beam
        decoder's: each source owns a block of len(lengths) / n_src rows
        of which the first outer[s] are live) is compacted to the
        reference's ragged layout first, as the JAX package does."""
        data = _host(sv.data)
        lens = _host(sv.lengths)
        outer = [_host(lv) for lv in (sv.outer_lengths or ())]
        if len(outer) == 1 and int(outer[0].sum()) < len(lens) \
                and len(lens) % len(outer[0]) == 0:
            n_src = len(outer[0])
            k = len(lens) // n_src
            keep = np.concatenate(
                [np.arange(s * k, s * k + int(outer[0][s]))
                 for s in range(n_src)]).astype(int) \
                if int(outer[0].sum()) else np.zeros((0,), int)
            data = data[keep]
            lens = lens[keep]
        rows = [data[i, :int(n)] for i, n in enumerate(lens)]
        flat = np.concatenate(rows, axis=0) if rows \
            else data.reshape((0,) + data.shape[2:])
        lengths = [[int(n) for n in lens]]
        for lv in reversed(outer):
            lengths = [[int(n) for n in lv]] + lengths
        return LoDTensor(flat, lengths)


def _host(t):
    """A tensor (or array) as a numpy array on the host; bf16 widened to
    float32, which is exact."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(t)


class LoDTensorArray(list):
    """Host-side array of LoDTensor (reference
    paddle/fluid/framework/lod_tensor_array.h): a list whose every
    mutation coerces raw arrays to LoDTensor."""

    @staticmethod
    def _coerce(value):
        if not isinstance(value, LoDTensor):
            value = LoDTensor(np.asarray(value))
        return value

    def __init__(self, iterable=()):
        super(LoDTensorArray, self).__init__(
            self._coerce(v) for v in iterable)

    def append(self, value):
        super(LoDTensorArray, self).append(self._coerce(value))

    def extend(self, iterable):
        super(LoDTensorArray, self).extend(
            self._coerce(v) for v in iterable)

    def insert(self, index, value):
        super(LoDTensorArray, self).insert(index, self._coerce(value))

    def __setitem__(self, index, value):
        if isinstance(index, slice):
            value = [self._coerce(v) for v in value]
        else:
            value = self._coerce(value)
        super(LoDTensorArray, self).__setitem__(index, value)

    def __iadd__(self, iterable):
        self.extend(iterable)
        return self


def _nested_levels(data):
    """Walk a nested list down to its innermost sequences. Returns
    (levels, flat): the recursive_seq_lens the nesting gives (one level per
    list depth above the innermost) and the innermost sequences as
    [len, d] arrays, in order."""
    if isinstance(data[0], list) and data[0] and isinstance(data[0][0],
                                                            list):
        group_lens, sub_levels, flat = [], None, []
        for group in data:
            levels, seqs = _nested_levels(group)
            group_lens.append(len(levels[0]) if levels else len(seqs))
            if sub_levels is None:
                sub_levels = [list(lv) for lv in levels]
            else:
                for acc, lv in zip(sub_levels, levels):
                    acc.extend(lv)
            flat.extend(seqs)
        return [group_lens] + (sub_levels or []), flat
    lens, flat = [], []
    for seq in data:
        seq = np.asarray(seq)
        if seq.ndim == 1:
            seq = seq[:, None]
        lens.append(seq.shape[0])
        flat.append(seq)
    return [lens], flat


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """reference python/paddle/fluid/lod_tensor.py:create_lod_tensor. A
    list `data` is nested sequences of scalars (word ids), each nesting
    level above the innermost one LoD level; an ndarray takes explicit
    `recursive_seq_lens`."""
    if isinstance(data, list):
        levels, flat = _nested_levels(data)
        if recursive_seq_lens is not None:
            given = [list(lv) for lv in recursive_seq_lens]
            if given != [list(lv) for lv in levels]:
                raise ValueError(
                    "data and recursive_seq_lens do not match: the nested "
                    "list derives %r but recursive_seq_lens is %r"
                    % (levels, given))
        arr = np.concatenate(flat, axis=0)
        if arr.dtype.kind in 'iu':
            # the reference flattens list data to int64
            arr = arr.astype(np.int64)
        return LoDTensor(arr, levels)
    arr = np.asarray(data)
    t = LoDTensor(arr, recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError("invalid recursive_seq_lens %s for data of %d rows"
                         % (recursive_seq_lens, arr.shape[0]))
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    total = sum(recursive_seq_lens[-1])
    shape = [total] + list(base_shape)
    data = np.random.randint(low, high + 1, size=shape).astype('int64')
    return LoDTensor(data, recursive_seq_lens)
