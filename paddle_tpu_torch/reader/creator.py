"""Reader creators.

Parity: reference python/paddle/reader/creator.py — build sample readers
from in-memory arrays, text files and recordio files; the port's own copy
of the JAX package's reader/creator.py.
"""
__all__ = ['np_array', 'text_file', 'recordio']


def np_array(x):
    """Reader yielding the rows of a numpy array (reference
    creator.py:np_array)."""
    import numpy as np
    arr = np.asarray(x)

    def reader():
        for row in arr:
            yield row

    return reader


def text_file(path):
    """Reader yielding lines of a text file without the trailing newline
    (reference creator.py:text_file)."""

    def reader():
        with open(path, 'r') as f:
            for line in f:
                yield line.rstrip('\n')

    return reader



def recordio(paths, buf_size=100):
    """Reader yielding the raw records (bytes) of recordio file(s); paths
    is a path, a comma-separated list of paths or a list (reference
    creator.py:recordio, less the cloud-reader branch that served the
    retired pserver infrastructure). It reads through the plain python
    RecordIOReader, as the JAX package's does; buf_size is the reference's
    signature."""
    from . import recordio as rio

    if isinstance(paths, str):
        path_list = paths.split(',')
    else:
        path_list = list(paths)

    def reader():
        for p in path_list:
            for rec in rio.RecordIOReader(p):
                yield rec

    return reader
