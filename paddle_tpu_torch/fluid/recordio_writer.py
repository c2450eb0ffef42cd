"""Convert Python readers into recordio files.

Parity: reference python/paddle/fluid/recordio_writer.py
(convert_reader_to_recordio_file / _files over a DataFeeder) and the JAX
package's fluid/recordio_writer.py, in its record layout: each record
packs one batch's feed slots in feed_order behind a leading int64 schema
array (reader/recordio.py's record format). The files are the JAX
package's byte for byte but for a LoD slot's int64 data, which stays int64
here and is int32 there (its DataFeeder's data with x64 off).
layers.open_recordio_file and layers.open_files read such a file back as
its feed slots (unpack_feed_record), LoD included.
"""
import contextlib

import numpy as np

from ..reader import recordio as _rio

__all__ = [
    'convert_reader_to_recordio_file', 'convert_reader_to_recordio_files',
    'unpack_feed_record'
]


@contextlib.contextmanager
def create_recordio_writer(filename, compressor=None, max_num_records=1000):
    writer = _rio.RecordIOWriter(filename)
    try:
        yield writer
    finally:
        writer.close()


def _append_batch(writer, res, feed_order):
    """Pack one batch self-describingly: a leading int64 schema array
    [n_slots, lod_levels_per_slot...], then per slot the (flattened,
    unpadded) data array followed by one lengths array per LoD level, so
    sequence structure survives the round trip (the reference writes the
    LoDTensor's lod table the same way)."""
    from .lod_tensor import LoDTensor
    from .lowering import SeqValue
    arrays = [None]  # schema placeholder
    schema = []
    for name in feed_order:
        v = res[name]
        if isinstance(v, SeqValue):
            v = LoDTensor.from_seq_value(v)
        if isinstance(v, LoDTensor) and v.recursive_sequence_lengths():
            levels = v.recursive_sequence_lengths()
            schema.append(len(levels))
            arrays.append(np.asarray(v.data))
            arrays.extend(np.asarray(lv, np.int64) for lv in levels)
        else:
            schema.append(0)
            arrays.append(np.asarray(getattr(v, 'data', v)))
    arrays[0] = np.asarray([len(feed_order)] + schema, np.int64)
    writer.write(_rio._pack_sample(arrays))


def feed_record_levels(arrays, lod_levels):
    """True when `arrays` (one unpacked record) is a feed record of
    len(lod_levels) slots with these LoD levels: a leading int64 vector
    [n_slots, lod_levels...] and one array per slot and level after it. A
    sample record of n slots holds n arrays and never passes."""
    lod_levels = [int(n) for n in lod_levels]
    if not arrays:
        return False
    head = arrays[0]
    return (head.dtype == np.int64 and head.ndim == 1
            and len(arrays) == 1 + len(lod_levels) + sum(lod_levels)
            and head.tolist() == [len(lod_levels)] + lod_levels)


def unpack_feed_slots(arrs):
    """The feed slots of one unpacked feed record: a plain ndarray, or a
    LoDTensor where the slot carried sequence structure."""
    from .lod_tensor import LoDTensor
    schema = arrs[0]
    n_slots = int(schema[0])
    out = []
    i = 1
    for s in range(n_slots):
        levels = int(schema[1 + s])
        data = arrs[i]
        i += 1
        if levels == 0:
            out.append(data)
        else:
            lens = [[int(x) for x in arrs[i + j]] for j in range(levels)]
            i += levels
            out.append(LoDTensor(np.asarray(data), lens))
    return out


def unpack_feed_record(payload):
    """Inverse of the record layout written here: one value per feed slot,
    a plain ndarray or a LoDTensor when the slot carried sequence
    structure."""
    return unpack_feed_slots(list(_rio._unpack_sample(payload)))


def convert_reader_to_recordio_file(filename, reader_creator, feeder,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None):
    """Write every batch of `reader_creator` through `feeder` into one
    recordio file; returns the number of records written."""
    if feed_order is None:
        feed_order = feeder.feed_names
    counter = 0
    with create_recordio_writer(filename, compressor,
                                max_num_records) as writer:
        for batch in reader_creator():
            res = feeder.feed(batch)
            _append_batch(writer, res, feed_order)
            counter += 1
    return counter


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder,
                                     compressor=None, max_num_records=1000,
                                     feed_order=None):
    """Same as convert_reader_to_recordio_file but splits the stream into
    files of at most `batch_per_file` records (filename-00000, -00001, ...);
    returns the total number of records."""
    if feed_order is None:
        feed_order = feeder.feed_names
    f_name, f_ext = filename, ''
    if '.' in filename.rsplit('/', 1)[-1]:
        f_name, f_ext = filename.rsplit('.', 1)
        f_ext = '.' + f_ext
    lines = 0
    f_idx = 0
    counter = 0
    writer = None
    try:
        for batch in reader_creator():
            if writer is None or lines == batch_per_file:
                if writer is not None:
                    writer.close()
                writer = _rio.RecordIOWriter(
                    '%s-%05d%s' % (f_name, f_idx, f_ext))
                f_idx += 1
                lines = 0
            res = feeder.feed(batch)
            _append_batch(writer, res, feed_order)
            lines += 1
            counter += 1
    finally:
        if writer is not None:
            writer.close()
    return counter
