"""Embedding plumbing of the port (parity: the JAX package's embedding/):
the static-shape dedup that the sparse optimizer merge needs, the int8 row
codec of the delta publisher (quant_rows) and the tier store (tiers:
`HostArena` and `TieredVocabTable`, the host-RAM spill tier behind the
card's table). The sharded lookup wire waits for the parallel slice."""
from . import quant_rows  # noqa: F401
from .lookup import dedup_plan  # noqa: F401
from .tiers import (ArenaCorrupt, ArenaFull, DimShardingUnsupported,  # noqa: F401
                    HostArena, RowRestorer, RowSpiller, TieredVocabTable,
                    host_arena)

__all__ = ['dedup_plan', 'quant_rows',
           'HostArena', 'TieredVocabTable', 'RowSpiller', 'RowRestorer',
           'ArenaFull', 'ArenaCorrupt', 'DimShardingUnsupported',
           'host_arena']
