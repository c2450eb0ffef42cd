"""Reader decorators, importable at the reference's module path.

Parity: reference python/paddle/reader/decorator.py. The implementations
live in paddle_tpu_torch.reader (the package __init__, where the reference
re-exports them anyway); this module mirrors the reference layout so
`from paddle.reader.decorator import shuffle`-style imports port verbatim.
"""
from . import (Fake, ComposeNotAligned, PipeReader, buffered, cache, chain,
               compose, fault_tolerant, firstn, map_readers, shuffle,
               xmap_readers)

__all__ = [
    'map_readers', 'buffered', 'compose', 'chain', 'shuffle',
    'ComposeNotAligned', 'firstn', 'xmap_readers', 'Fake', 'cache',
    'PipeReader', 'fault_tolerant',
]
