"""paddle_tpu_torch.streaming — online training over unbounded id streams.

Parity: the JAX package's paddle_tpu.streaming, without its tier store
(embedding.tiers, a later slice). A recommender trains on a click stream
whose id space drifts, while its parameters continuously publish to live
serving. Three legs:

  * :class:`VocabTable` — host-side raw-id -> row indirection with
    frequency admission (cold-row training below the threshold) and
    LRU eviction of unpinned rows, so the captured step's table shape
    never changes as the vocab drifts;
  * `Trainer.train_stream` (fluid/trainer.py) — the unbounded-stream
    hot loop: prefetch, translation, evicted-row zeroing in place
    (:class:`RowResetter`), step/wall-clock checkpoint cadence with the
    vocab serialized into the checkpoint meta;
  * :class:`DeltaPublisher` — touched-row snapshots pushed into
    running `ServingEngine` replicas via `Router.push_deltas`: rows
    written in place into the weights their captured graphs read,
    instead of a full-artifact swap().
"""
from .publish import DeltaPublisher
from .vocab import (Lease, RowPinned, RowResetter, VocabFull, VocabTable,
                    table_state_names)

__all__ = ['VocabTable', 'DeltaPublisher', 'RowResetter', 'Lease',
           'RowPinned', 'VocabFull', 'table_state_names']
