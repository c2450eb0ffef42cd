"""Dynamic vocab: the host-side id->row indirection in front of a table.

Parity: the JAX package's streaming/vocab.py (VocabTable :91,
table_state_names :433, RowResetter :461). VocabTable, Lease and
table_state_names are copied as they are (host-side Python and numpy): for
the same stream they give every raw id the row the JAX table gives it.
RowResetter is the port's own (see its docstring).

A recommender's id space DRIFTS — new users/items appear mid-stream, old
ones go cold. A captured CUDA step cannot grow anything: the table is a
fixed [capacity, D] persistable whose shape, and address, the graph reads.
:class:`VocabTable` closes the gap entirely on the host, BEFORE the feed:
raw (unbounded, arbitrary int) ids translate to rows of the fixed table,
so the step's signature never changes as the vocab drifts and one capture
serves the whole stream.

  * ADMISSION by frequency: an id below `admit_count` sightings maps to
    the shared COLD ROW (row 0 by default) — it still trains (against
    the shared row), but never steals a private row from the hot set.
    Crossing the threshold claims a free row, or evicts the
    least-recently-used cold resident.
  * EVICTION is safe because the sparse update path touches only the
    rows in the batch: a row no batch references is dead weight on the
    device. Rows referenced by an IN-FLIGHT batch are pinned
    (`translate` returns a :class:`Lease`; release it after the step) —
    a pinned row is never chosen for eviction, and an explicit `evict()`
    of one fails with the typed :class:`RowPinned` instead of tearing the
    update the step is about to scatter.
  * An evicted row's table row AND optimizer moments are stale garbage
    for its next owner; `drain_resets()` hands the trainer the rows to
    zero and :class:`RowResetter` zeroes them in place, between steps.

The refcount+recency bookkeeping is `utils.lru.RefCountedLRU`, shared
with the serving tier's PrefixCache. The table serializes to a JSON-able
`state_dict()` (the JAX format) which the Trainer folds into checkpoint
meta, so exact-step resume holds under vocab drift, in either package.

Thread-safe: `translate` runs on the reader-prefetch worker while the
consumer releases leases and drains resets — one lock covers the map.
"""
import collections
import contextlib
import threading

import numpy as np
import torch

from .. import obs
from ..utils.lru import RefCountedLRU

__all__ = ['VocabTable', 'RowPinned', 'VocabFull', 'Lease',
           'table_state_names', 'RowResetter']

_C_ADMITTED = obs.counter('streaming.rows_admitted')
_C_EVICTED = obs.counter('streaming.rows_evicted')


class RowPinned(RuntimeError):
    """evict() targeted a row some in-flight batch still references —
    evicting it would zero a row whose gradient is about to land (a
    torn update). Release the lease first."""


class VocabFull(RuntimeError):
    """An id crossed the admission threshold but the table has no free
    row, nothing is evictable (everything pinned), and the table was
    built without a cold row to fall back on."""


class Lease(object):
    """Pin on the rows one translated batch references. Hold it while
    the batch's step is in flight; `release()` (idempotent) un-pins.
    The rows stay resident — release only makes them evictable again."""

    __slots__ = ('_vocab', '_ids', '_released')

    def __init__(self, vocab, ids):
        self._vocab = vocab
        self._ids = ids
        self._released = False

    def release(self):
        if self._released:
            return
        self._released = True
        self._vocab._release(self._ids)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False


class VocabTable(object):
    """Host-side raw-id -> row map over a fixed [capacity, D] table.

    capacity:     TOTAL rows of the device table this map fronts
                  (including the cold row).
    table:        name of the table persistable (and, through
                  `table_state_names`, its optimizer moments) — what the
                  trainer zeroes on eviction and the publisher pushes.
    admit_count:  sightings before an id earns a private row. 1 admits
                  on first sight.
    cold_row:     the shared row un-admitted ids train against (default
                  0). None reserves no cold row — then admission
                  pressure with nothing evictable raises VocabFull
                  instead of deferring.
    max_pending:  bound on the not-yet-admitted frequency map (the id
                  universe is unbounded; the counts must not be). On
                  overflow the OLDEST pending count is dropped — an id
                  that went cold before admission restarts its count.
    """

    def __init__(self, capacity, table=None, admit_count=1, cold_row=0,
                 max_pending=None, name=None):
        self.capacity = int(capacity)
        self.table = table
        self.name = name or table or 'vocab'
        self.admit_count = int(admit_count)
        if self.admit_count < 1:
            raise ValueError('admit_count must be >= 1, got %r'
                             % (admit_count,))
        self.cold_row = None if cold_row is None else int(cold_row)
        reserved = 0 if self.cold_row is None else 1
        if self.capacity <= reserved:
            raise ValueError('capacity %d leaves no assignable row past '
                             'the cold row' % self.capacity)
        if self.cold_row is not None and not (
                0 <= self.cold_row < self.capacity):
            raise ValueError('cold_row %d outside [0, %d)'
                             % (self.cold_row, self.capacity))
        self.max_pending = int(max_pending) if max_pending is not None \
            else max(1024, 8 * self.capacity)
        self._lock = threading.Lock()
        self._map = RefCountedLRU()      # raw id -> row
        self._free = [r for r in range(self.capacity - 1, -1, -1)
                      if r != self.cold_row]          # pop() -> low rows first
        self._pending = {}               # raw id -> sighting count
        # FIFO of pending ids (deque: the overflow pop is O(1) under
        # the translate lock — a list's pop(0) would shift max_pending
        # elements per new id once the bound is hit)
        self._pending_order = collections.deque()
        self._resets = []                # evicted rows awaiting zeroing
        # admission/eviction MOVE log for the tier store
        # (embedding.tiers.TieredVocabTable): disabled by default so a
        # plain table never accumulates an undrained list
        self._log_moves = False
        self._moves = []                 # [('admit'|'evict', raw, row)]
        # cumulative stats (the obs counters carry process-wide twins)
        self.rows_admitted = 0
        self.rows_evicted = 0
        self.deferred = 0                # admissions deferred to cold row
        self.cold_hits = 0               # translations routed to cold row
        self.translations = 0

    # -- translation -------------------------------------------------------

    def translate(self, ids, pin=True):
        """Map raw ids (any int array shape) to rows of the fixed table,
        admitting/evicting as the stream demands. Returns (rows, lease):
        rows an int64 array of ids' shape, lease pinning every private
        row the batch references (None when pin=False). Release the
        lease once the step that consumes this batch has completed."""
        arr = np.asarray(ids)
        flat = arr.reshape(-1)
        uniq, inverse, counts = np.unique(flat, return_inverse=True,
                                          return_counts=True)
        urows = np.empty(uniq.shape, np.int64)
        admitted, evicted, pinned = [], [], []
        with self._lock:
            self.translations += 1
            for i, raw in enumerate(uniq):
                raw = int(raw)
                row = self._map.get(raw)
                if row is None:
                    # every OCCURRENCE is a sighting (a batch with the
                    # same id 5 times is 5 votes for admission)
                    row = self._maybe_admit_locked(
                        raw, admitted, evicted, sightings=int(counts[i]))
                else:
                    self._map.touch(raw)
                if row is None:          # below threshold / deferred
                    if self.cold_row is None:
                        raise VocabFull(
                            'vocab %r: id %d needs a row but the table '
                            'is full, nothing is evictable, and no cold '
                            'row was reserved' % (self.name, raw))
                    self.cold_hits += 1
                    urows[i] = self.cold_row
                    continue
                urows[i] = row
                if pin:
                    self._map.ref(raw)
                    pinned.append(raw)
            resident = len(self._map)
        out = urows[inverse]
        if admitted:
            _C_ADMITTED.inc(len(admitted))
            obs.event('streaming.admit', vocab=self.name,
                      rows=len(admitted), sample=admitted[:8],
                      resident=resident)
        if evicted:
            _C_EVICTED.inc(len(evicted))
            obs.event('streaming.evict', vocab=self.name,
                      rows=len(evicted), sample=evicted[:8],
                      resident=resident)
        lease = Lease(self, pinned) if pin else None
        return out.reshape(arr.shape), lease

    def lookup(self, ids):
        """Read-only translation for the SERVING side: resident ids map
        to their rows, everything else to the cold row (or raises when
        no cold row exists). No admission, no counting, no pinning."""
        arr = np.asarray(ids)
        flat = arr.reshape(-1)
        out = np.empty(flat.shape, np.int64)
        with self._lock:
            for i, raw in enumerate(flat):
                row = self._map.get(int(raw))
                if row is None:
                    if self.cold_row is None:
                        raise KeyError('id %d is not resident in vocab %r'
                                       % (int(raw), self.name))
                    row = self.cold_row
                out[i] = row
        return out.reshape(arr.shape)

    def _maybe_admit_locked(self, raw, admitted, evicted, sightings=1):
        """Admission path for an unseen-this-map id. Returns its row, or
        None when it stays cold (below threshold, or deferred because
        every resident row is pinned)."""
        n = self._pending.get(raw)
        if n is None:
            self._pending_order.append(raw)
            if len(self._pending_order) > self.max_pending:
                drop = self._pending_order.popleft()
                self._pending.pop(drop, None)
            n = 0
        n += int(sightings)
        if n < self.admit_count:
            self._pending[raw] = n
            return None
        row = self._claim_row_locked(evicted)
        if row is None:
            # full and nothing evictable: stay cold, keep the count so
            # the very next sighting retries admission
            self._pending[raw] = n
            self.deferred += 1
            return None
        self._pending.pop(raw, None)
        self._map.insert(raw, row)
        self.rows_admitted += 1
        admitted.append(raw)
        if self._log_moves:
            self._moves.append(('admit', raw, row))
        return row

    def _claim_row_locked(self, evicted):
        if self._free:
            return self._free.pop()
        victim = self._map.evict_one()   # LRU among unpinned residents
        if victim is None:
            return None
        old_id, old_row = victim
        self._resets.append(old_row)
        self.rows_evicted += 1
        evicted.append(old_id)
        if self._log_moves:
            self._moves.append(('evict', old_id, old_row))
        return old_row

    def _release(self, raw_ids):
        with self._lock:
            for raw in raw_ids:
                self._map.unref(raw)

    # -- explicit management ----------------------------------------------

    def preload(self, ids):
        """Admit `ids` immediately, in order (rows assigned ascending
        from the free list) — warm-starting a known hot set, and the
        identity mapping the static-vocab A/B drill trains through
        (cold_row=None, ids 0..capacity-1 -> rows 0..capacity-1)."""
        with self._lock:
            for raw in np.asarray(ids).reshape(-1):
                raw = int(raw)
                if raw in self._map:
                    continue
                if not self._free:
                    raise VocabFull(
                        'preload: no free row for id %d (capacity %d)'
                        % (raw, self.capacity))
                row = self._free.pop()
                self._map.insert(raw, row)
                self.rows_admitted += 1
                if self._log_moves:
                    self._moves.append(('admit', raw, row))
        return self

    def evict(self, raw_id):
        """Force one id out (admin/drill surface). Typed failures: a
        pinned row (in-flight gradient) raises RowPinned; an id that is
        not resident raises KeyError. The freed row joins the reset
        queue like any pressure eviction."""
        raw_id = int(raw_id)
        with self._lock:
            if raw_id not in self._map:
                raise KeyError('id %d is not resident in vocab %r'
                               % (raw_id, self.name))
            if self._map.refs(raw_id) > 0:
                raise RowPinned(
                    'id %d (vocab %r) is pinned by an in-flight batch — '
                    'its sparse gradient has not landed; evicting now '
                    'would tear the row. Release the lease first.'
                    % (raw_id, self.name))
            row = self._map.pop(raw_id)
            self._resets.append(row)
            # the freed row re-enters circulation (it used to leak:
            # a forced evict permanently lost one row of capacity)
            self._free.append(row)
            self.rows_evicted += 1
            if self._log_moves:
                self._moves.append(('evict', raw_id, row))
        _C_EVICTED.inc()
        obs.event('streaming.evict', vocab=self.name, rows=1,
                  sample=[raw_id], resident=len(self._map), forced=True)
        return row

    def drain_resets(self):
        """Rows evicted since the last drain — the trainer zeroes these
        (table + optimizer moments, RowResetter) BEFORE dispatching the
        step that trains their new owners."""
        with self._lock:
            out, self._resets = self._resets, []
        return out

    def drain_moves(self):
        """Ordered admission/eviction moves since the last drain —
        empty unless `_log_moves` was switched on by the tier store
        (`embedding.tiers.TieredVocabTable`), which turns evictions
        into SPILLS and warm admissions into RESTORES."""
        with self._lock:
            out, self._moves = self._moves, []
        return out

    def resident_ids(self):
        """Raw ids currently holding a private row, least recently used
        first (the eviction order)."""
        with self._lock:
            return [k for k, _ in self._map.items()]

    def rows_of(self, ids):
        """Resident rows for `ids` (ids not resident are skipped) —
        what the delta publisher pushes for a raw-id batch."""
        out = []
        with self._lock:
            for raw in np.asarray(ids).reshape(-1):
                row = self._map.get(int(raw))
                if row is not None:
                    out.append(row)
        return np.asarray(sorted(set(out)), np.int64)

    # -- checkpoint seam ---------------------------------------------------

    def state_dict(self):
        """JSON-able snapshot: the id->row map in RECENCY order (least
        recent first, so load rebuilds the same eviction order), pending
        counts, free rows, and the cumulative stats. Pins are NOT
        serialized — a checkpoint is taken at a step boundary, where no
        batch is in flight."""
        with self._lock:
            return {
                'capacity': self.capacity,
                'cold_row': self.cold_row,
                'admit_count': self.admit_count,
                'table': self.table,
                'entries': [[int(k), int(v)] for k, v in self._map.items()],
                'pending': [[int(k), int(self._pending[k])]
                            for k in self._pending_order
                            if k in self._pending],
                'free': [int(r) for r in self._free],
                'resets': [int(r) for r in self._resets],
                'stats': {'rows_admitted': self.rows_admitted,
                          'rows_evicted': self.rows_evicted,
                          'deferred': self.deferred,
                          'cold_hits': self.cold_hits,
                          'translations': self.translations},
            }

    def load_state_dict(self, state):
        """Exact-resume restore (the inverse of state_dict). The
        geometry (capacity/cold_row) must match the table this map
        fronts — a checkpoint from a different table shape fails typed
        instead of silently mis-mapping rows."""
        if int(state['capacity']) != self.capacity or \
                state.get('cold_row') != self.cold_row:
            raise ValueError(
                'vocab %r: checkpoint geometry (capacity=%s cold_row=%s) '
                'does not match this table (capacity=%d cold_row=%s)'
                % (self.name, state.get('capacity'), state.get('cold_row'),
                   self.capacity, self.cold_row))
        with self._lock:
            self._map = RefCountedLRU()
            for k, v in state.get('entries', []):
                self._map.insert(int(k), int(v))
            self._pending = {int(k): int(n)
                             for k, n in state.get('pending', [])}
            self._pending_order = collections.deque(
                int(k) for k, _ in state.get('pending', []))
            self._free = [int(r) for r in state.get('free', [])]
            self._resets = [int(r) for r in state.get('resets', [])]
            st = state.get('stats', {})
            self.rows_admitted = int(st.get('rows_admitted', 0))
            self.rows_evicted = int(st.get('rows_evicted', 0))
            self.deferred = int(st.get('deferred', 0))
            self.cold_hits = int(st.get('cold_hits', 0))
            self.translations = int(st.get('translations', 0))
        return self

    def stats(self):
        with self._lock:
            return {'resident': len(self._map), 'free': len(self._free),
                    'capacity': self.capacity,
                    'pending': len(self._pending),
                    'rows_admitted': self.rows_admitted,
                    'rows_evicted': self.rows_evicted,
                    'deferred': self.deferred,
                    'cold_hits': self.cold_hits,
                    'translations': self.translations}

    def __len__(self):
        with self._lock:
            return len(self._map)


def table_state_names(program, table):
    """The persistable names eviction must zero for `table`: the table
    itself plus every same-shape optimizer accumulator its optimizer op
    reads (adam moments, adagrad moment, momentum velocity — anything
    vocab-sized; scalar state like beta pows is excluded by the shape
    filter). Walked from the program so the trainer never hard-codes an
    optimizer's accumulator naming."""
    blk = program.global_block()
    tvar = blk.vars.get(table)
    if tvar is None:
        raise KeyError('no variable %r in the program' % (table,))
    shape = tuple(int(d) for d in tvar.shape)
    names = [table]
    for op in blk.ops:
        params = op.inputs.get('Param') or []
        if not any(v.name == table for v in params):
            continue
        for slot, vs in op.inputs.items():
            if slot in ('Param', 'Grad', 'LearningRate'):
                continue
            for v in vs:
                if (getattr(v, 'persistable', False)
                        and tuple(int(d) for d in v.shape) == shape
                        and v.name not in names):
                    names.append(v.name)
    return names


class RowResetter(object):
    """Zero evicted rows of a table and its optimizer moments IN PLACE.

    The JAX package rebuilds the arrays through a jitted, donated scatter
    and rebinds them. On the card the scope's table and moments are the
    captured step's static tensors, read by address: a rebound array
    would leave the graph reading the old storage. So the rows are zeroed
    with `index_fill_` into the tensors themselves, on the stream the
    step's replays run on (the caller's current stream), after the
    replay before it and before the next. Nothing is captured and
    nothing waits for the card: the row list crosses to the card from
    pinned memory without blocking. The row count may change from call
    to call (the JAX version pads it to a fixed `batch` for its jit
    cache; a fill has no signature to keep)."""

    def reset(self, tensors, rows, lock=None):
        """Zero `rows` of every tensor in `tensors` (same leading dim) in
        place; `lock` (the executor's) serializes the fill with its steps.
        Returns `tensors`, input order."""
        rows = [int(r) for r in rows]
        tensors = list(tensors)
        if not rows:
            return tensors
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                raise TypeError('RowResetter.reset zeroes tensors in place, '
                                'got %r' % type(t).__name__)
        dev = tensors[0].device
        idx = torch.as_tensor(np.asarray(rows, np.int64))
        if dev.type == 'cuda':
            idx = idx.pin_memory().to(dev, non_blocking=True)
        with (lock if lock is not None else contextlib.nullcontext()), \
                torch.no_grad():
            for t in tensors:
                t.index_fill_(0, idx, 0)
        return tensors
