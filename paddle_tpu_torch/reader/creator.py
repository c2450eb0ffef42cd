"""Reader creators.

Parity: reference python/paddle/reader/creator.py — build sample readers
from in-memory arrays and text files; the port's own copy of the JAX
package's reader/creator.py. Its recordio creator waits for the port's
recordio reader (ROADMAP.md Queue A).
"""
__all__ = ['np_array', 'text_file']


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

