"""Static-shape dedup of an id vector.

Parity: the JAX package's embedding/lookup.py (_PAD_ID :37, dedup_plan
:49-75). Every output has the input's length, whatever the number of
distinct ids, so nothing here waits for the device: torch.unique would
return a data-dependent size, which on the card costs a device-to-host
sync every step. The sharded lookup wire of that module (sharded_lookup,
_pack_queries, _exchange) waits for the parallel slice of the port.
"""
import torch

__all__ = ['dedup_plan']

# sentinel sorted past every real id, so slots past the live unique count
# never hold a real id (int32-safe, as in the JAX package)
_PAD_ID = (2 ** 31 - 1) // 2


def dedup_plan(ids):
    """Collapse duplicate ids onto shared slots (static shapes).

    ids: int [c]. Returns (uids, seg, order, n_unique):
      uids     [c], ids' dtype — unique ids compacted to the front, in
                                 ascending order (slots past n_unique hold
                                 the _PAD_ID sentinel);
      seg      int64 [c] — for each SORTED position, its unique slot;
      order    int64 [c] — the stable argsort of ids: sorted position i
                           holds request position order[i];
      n_unique int64 []  — the live unique count, a device tensor."""
    c = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    is_first = torch.ones((c,), dtype=torch.bool, device=ids.device)
    is_first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(is_first, 0) - 1
    # min-scatter: within a segment every sid is equal, so the minimum is
    # that id; the sentinel fill stays in the slots no segment reaches
    uids = torch.full((c,), _PAD_ID, dtype=ids.dtype, device=ids.device)
    uids = uids.scatter_reduce(0, seg, sid, reduce='amin')
    return uids, seg, order, is_first.sum()
