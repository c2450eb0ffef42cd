"""Chunked record files (the recordio equivalent).

Parity: reference paddle/fluid/recordio/ (C++ chunked writer and reader
with per-record checksums) and the JAX package's reader/recordio.py, whose
format this module writes byte for byte:

    magic b'PTRIO1\\n' | per record: u32 len | u32 crc32 | payload

A sample record packs its arrays self-describingly (_pack_sample: count,
then per array its dtype string, rank, shape and raw bytes). read_samples
always scans through the native C++ library (utils/native.py), by its
prefetch thread when prefetch_depth > 0. RecordIOReader is the plain
python reader, public API and the version the tests hold the scanner
against; a truncated or corrupted file raises IOError in both.
"""
import struct
import zlib

import numpy as np

__all__ = ['RecordIOWriter', 'RecordIOReader', 'write_samples', 'read_samples',
           'convert_reader_to_recordio_file']

_MAGIC = b'PTRIO1\n'


class RecordIOWriter(object):
    def __init__(self, path):
        self._f = open(path, 'wb')
        self._f.write(_MAGIC)

    def write(self, payload: bytes):
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(struct.pack('<II', len(payload), crc))
        self._f.write(payload)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOReader(object):
    """The record payloads of one file, read and checked in python."""

    def __init__(self, path):
        self.path = path

    def __iter__(self):
        with open(self.path, 'rb') as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError('%s is not a paddle_tpu recordio file'
                                 % self.path)
            while True:
                hdr = f.read(8)
                if not hdr:
                    break
                if len(hdr) < 8:
                    raise IOError('truncated record header in %s (file cut '
                                  'mid-write?)' % self.path)
                ln, crc = struct.unpack('<II', hdr)
                payload = f.read(ln)
                if len(payload) < ln:
                    raise IOError('truncated record payload in %s'
                                  % self.path)
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    raise IOError('checksum mismatch in %s' % self.path)
                yield payload


def _pack_sample(arrays):
    parts = [struct.pack('<I', len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        dt = a.dtype.str.encode()
        parts.append(struct.pack('<I', len(dt)))
        parts.append(dt)
        parts.append(struct.pack('<I', a.ndim))
        parts.append(struct.pack('<%dq' % a.ndim, *a.shape))
        raw = a.tobytes()
        parts.append(struct.pack('<Q', len(raw)))
        parts.append(raw)
    return b''.join(parts)


def _unpack_sample(payload):
    """The arrays of one packed record: read-only views of `payload`."""
    off = 0

    def take(n):
        nonlocal off
        out = payload[off:off + n]
        off += n
        return out

    n_arr, = struct.unpack('<I', take(4))
    out = []
    for _ in range(n_arr):
        dt_len, = struct.unpack('<I', take(4))
        dt = take(dt_len).decode()
        ndim, = struct.unpack('<I', take(4))
        shape = struct.unpack('<%dq' % ndim, take(8 * ndim))
        raw_len, = struct.unpack('<Q', take(8))
        out.append(np.frombuffer(take(raw_len),
                                 dtype=np.dtype(dt)).reshape(shape))
    return tuple(out)


def write_samples(path, samples):
    """Write each sample (a tuple of arrays, or one array) as one record;
    returns the number written."""
    with RecordIOWriter(path) as w:
        n = 0
        for s in samples:
            if not isinstance(s, (list, tuple)):
                s = (s,)
            w.write(_pack_sample([np.asarray(x) for x in s]))
            n += 1
    return n


def read_samples(path, shapes=None, dtypes=None, prefetch_depth=4):
    """The samples of `path` as tuples of arrays, scanned by the native
    library: its prefetch thread `prefetch_depth` records ahead, or the
    plain scanner at 0. `shapes` and `dtypes` are the reference's
    signature; the records describe themselves."""
    from ..utils import native
    it = (native.recordio_prefetch_iter(path, prefetch_depth)
          if prefetch_depth else native.recordio_iter(path))
    for payload in it:
        yield _unpack_sample(payload)


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None):
    """Parity: fluid.recordio_writer.convert_reader_to_recordio_file."""
    return write_samples(filename, reader_creator())
