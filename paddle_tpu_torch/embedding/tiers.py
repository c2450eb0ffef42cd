"""Tiered embedding storage: a host-RAM spill tier behind the card's table.

Parity: the JAX package's embedding/tiers.py (HostArena :111, host_arena
:99, RowSpiller :420, RowRestorer :492, TieredVocabTable :556,
apply_step_boundary :741). The host half (HostArena, its typed errors) is
copied as it is, so the on-disk format is the JAX one byte for byte: the
`arena.npy` memmap, the `manifest.json` keys and its `.sum` sidecar with
the CRC32. An arena written by either package is adopted by the other.

At personalization scale the live vocab exceeds device memory, and
`streaming.VocabTable` eviction ZEROES a trained row + its optimizer
moments — a returning user restarts cold. This module turns the card's
table into a CACHE TIER in front of a host-RAM arena:

  * :class:`HostArena` — a preallocated, mmap-backed row store holding
    one slot per spilled id: the table row plus every same-shape
    optimizer accumulator (`table_state_names` order — no optimizer
    hardcoding). Slots recycle free-list style; torn-write safety rides
    the checkpoint idiom: slot data is written and flushed FIRST, the
    manifest (id -> slot + CRC32) commits LAST via tmp + `.sum` sidecar
    + `os.replace` — a SIGKILL mid-spill leaves the slot unreferenced,
    never adoptable as garbage.
  * :class:`TieredVocabTable` — wraps a `VocabTable` so eviction SPILLS
    the row + moments into the arena instead of zeroing, and re-admission
    of a spilled id RESTORES the trained state bit-exactly.
  * IN PLACE — on the card the scope's table and moments are the captured
    step's static tensors, read by address. The JAX spill and restore
    return new arrays that its trainer rebinds; here
    :class:`RowSpiller` gathers the evicted rows (one `index_select` a
    tensor, stacked, and one copy to pinned host memory a boundary) and
    zeroes them with `index_fill_`, and :class:`RowRestorer` writes with
    `index_copy_`, into the tensors themselves, under the executor's lock
    and on the stream the replays run on, between one replay and the
    next. Nothing is captured, so the stream keeps its one capture.
  * ASYNC PREFETCH — `translate` runs on the `_iter_staged` prefetch
    worker (the `post=` hook); a re-admitted id's arena slot is read
    (host RAM, cheap) THERE, so the step-boundary restore never blocks on
    arena IO. Device mutation happens only at step boundaries
    (`apply_step_boundary`, driven by `Trainer.train_stream` alongside the
    plain reset path), where no batch is in flight.

The spill is the one place the tier waits for the card: the gathered rows
must reach the host before `arena.put_many`, so a boundary with evictions
waits once, for the copy queued behind the replay before it
(`RowSpiller.host_waits` counts the waits). The restore does not wait:
its values cross from pinned memory allocated by `pin_memory()` (torch's
caching host allocator keeps the block until the copy's stream has
passed it).

Failure posture: arena-full falls back to the OLD zeroing path LOUDLY
(`streaming.tier.arena_full` event + RuntimeWarning — the id restarts
cold, never serves another row's state); a CRC-mismatched slot is
treated the same way (`streaming.tier.corrupt`), never adopted. Column
(dim) sharding of the table is out of scope and fails typed
(:class:`DimShardingUnsupported`) instead of spilling torn row halves.

Checkpointing: `state_dict()` folds the vocab map, the arena manifest
(spill map), and the not-yet-applied spill/restore ops into the
Trainer's checkpoint meta (the JAX format: a tiered serial of either
package resumes in the other). Slots referenced by the last checkpoint
are NOT recycled until the next one commits (`mark_checkpoint`), so
resume-from-latest always finds its spilled rows intact; older fallback
serials degrade loudly through the CRC check, never silently.

Multi-host: each host owns its arena (`host_arena` appends the process
rank to the path). The port runs one process a card; the row-sharded
tiered table waits for the parallel slice.
"""
import contextlib
import json
import os
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from .. import obs

__all__ = ['HostArena', 'TieredVocabTable', 'RowSpiller', 'RowRestorer',
           'ArenaFull', 'ArenaCorrupt', 'DimShardingUnsupported',
           'host_arena']

_C_SPILLS = obs.counter('streaming.tier.spills')
_C_RESTORES = obs.counter('streaming.tier.restores')
_C_HITS = obs.counter('streaming.tier.hits')
_C_MISSES = obs.counter('streaming.tier.misses')
_C_DROPPED = obs.counter('streaming.tier.dropped')
_G_HIT_RATE = obs.gauge('streaming.tier_hit_rate')
_G_SPILL_MS = obs.gauge('streaming.tier_spill_ms')
_G_RESTORE_MS = obs.gauge('streaming.tier_restore_ms')
_G_OCCUPANCY = obs.gauge('streaming.tier_occupancy')

_DATA_FILE = 'arena.npy'
_MANIFEST = 'manifest.json'


class ArenaFull(RuntimeError):
    """A spill needed a slot but the arena has none free — the caller
    falls back to the zeroing path (loudly) or provisions more slots."""


class ArenaCorrupt(RuntimeError):
    """The arena's on-disk state failed verification: a torn/bit-rotted
    manifest (size/CRC sidecar mismatch), a data file that does not
    match the recorded geometry, or a slot whose bytes no longer match
    their committed CRC32. Never adopted, never served."""


class DimShardingUnsupported(ValueError):
    """The tiered table fronts a table whose EMBEDDING dim is sharded
    over the mesh (e.g. ``sharding=(None, 'model')``). A spill gathers
    whole rows; a dim-sharded row would spill torn halves per host.
    Column sharding for D > device memory is a named leftover (ROADMAP
    "Parallel") — fail typed instead of corrupting silently."""


def host_arena(path, slots, **kwargs):
    """A :class:`HostArena` under ``path/h<rank>`` — each process owns its
    spill tier (rows it gathers are local; spills never cross the
    network). The rank is `torch.distributed.get_rank()` when a process
    group is initialized, else 0 (the JAX `jax.process_index()`)."""
    idx = 0
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        idx = torch.distributed.get_rank()
    return HostArena(os.path.join(path, 'h%d' % idx), slots, **kwargs)


class HostArena(object):
    """Preallocated mmap-backed row store: the host-RAM spill tier.

    path:  directory holding ``arena.npy`` (a real .npy file opened as
           a memmap — preallocated once, rows written in place) and
           ``manifest.json`` (+ ``.sum`` sidecar): the committed
           id -> (slot, crc32) spill map.
    slots: row capacity of the tier — size it at (8-10x the device
           table) minus the device capacity; a full arena fails typed.

    Geometry (arrays per slot, row dim, dtype) binds on the first
    `put`; a dtype mix across the table and its moments is rejected
    (the slot store is one homogeneous memmap — casting would break the
    bit-exact round-trip contract).

    An existing committed manifest in `path` is adopted on construction
    (verified against its sidecar and the data file — failure is the
    typed :class:`ArenaCorrupt`); a data file WITHOUT a manifest is a
    crash before the first commit and adopts as empty: uncommitted
    slots are never adoptable.
    """

    def __init__(self, path, slots, name=None):
        self.path = str(path)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError('arena needs at least 1 slot, got %d'
                             % self.slots)
        self.name = name or os.path.basename(self.path) or 'arena'
        self._lock = threading.RLock()
        self._mm = None                  # np.memmap [slots, n_arrays, D]
        self._geom = None                # (n_arrays, row_dim, dtype str)
        self._entries = {}               # raw id -> (slot, crc32)
        self._free = list(range(self.slots - 1, -1, -1))
        self._limbo = []                 # released since last checkpoint
        self.puts = 0
        self.takes = 0
        os.makedirs(self.path, exist_ok=True)
        mpath = os.path.join(self.path, _MANIFEST)
        if os.path.exists(mpath):
            self._adopt(mpath)

    # -- persistence -------------------------------------------------------

    def _data_path(self):
        return os.path.join(self.path, _DATA_FILE)

    def _ensure(self, n_arrays, row_dim, dtype):
        """Bind geometry + open (or create) the memmap. Idempotent."""
        geom = (int(n_arrays), int(row_dim), str(dtype))
        if self._geom is not None:
            if self._geom != geom:
                raise ValueError(
                    'arena %r holds %r-shaped slots; a spill of %r does '
                    'not fit (the table geometry changed under the '
                    'arena?)' % (self.name, self._geom, geom))
            return
        shape = (self.slots, geom[0], geom[1])
        dp = self._data_path()
        mm = None
        if os.path.exists(dp):
            try:
                mm = np.lib.format.open_memmap(dp, mode='r+')
                if mm.shape != shape or str(mm.dtype) != geom[2]:
                    mm = None            # stale geometry: recreate
            except (ValueError, OSError):
                mm = None
        if mm is None:
            mm = np.lib.format.open_memmap(dp, mode='w+',
                                           dtype=np.dtype(geom[2]),
                                           shape=shape)
        self._mm = mm
        self._geom = geom

    def _commit_locked(self):
        """Commit the manifest ATOMICALLY LAST (slot data is already
        flushed): tmp without the final suffix (scanner safety), `.sum`
        sidecar (size + CRC32 of the staged bytes) FIRST, then the
        rename — the serving/checkpoint atomic-replace idiom."""
        path = os.path.join(self.path, _MANIFEST)
        doc = {'geom': {'n_arrays': self._geom[0] if self._geom else None,
                        'row_dim': self._geom[1] if self._geom else None,
                        'dtype': self._geom[2] if self._geom else None,
                        'slots': self.slots},
               'entries': [[int(k), int(s), int(c)]
                           for k, (s, c) in self._entries.items()]}
        tmp = '%s.tmp%d' % (path, os.getpid())
        with open(tmp, 'w') as f:
            json.dump(doc, f)
        sum_tmp = '%s.sum.tmp%d' % (path, os.getpid())
        with open(sum_tmp, 'w') as f:
            json.dump({'file': _MANIFEST,
                       'bytes': os.path.getsize(tmp),
                       'crc32': _crc32_file(tmp)}, f)
        os.replace(sum_tmp, path + '.sum')
        os.replace(tmp, path)

    def _adopt(self, mpath):
        """Adopt a committed manifest (standalone reopen — the resume
        path overrides this via `load_snapshot` from checkpoint meta).
        Verification failure is typed, never a silent fresh arena."""
        sum_path = mpath + '.sum'
        try:
            with open(sum_path) as f:
                rec = json.load(f)
            want_bytes, want_crc = int(rec['bytes']), int(rec['crc32'])
        except (OSError, ValueError, KeyError) as e:
            raise ArenaCorrupt(
                'arena %r: manifest sidecar %r unreadable (%s: %s) — '
                'torn write or corruption; the spill map is not '
                'trustworthy' % (self.name, sum_path, type(e).__name__, e))
        got_bytes = os.path.getsize(mpath)
        if got_bytes != want_bytes:
            raise ArenaCorrupt(
                'arena %r: manifest is %d bytes, sidecar recorded %d '
                '(truncated write?)' % (self.name, got_bytes, want_bytes))
        if _crc32_file(mpath) != want_crc:
            raise ArenaCorrupt(
                'arena %r: manifest CRC32 does not match its sidecar — '
                'bit rot or a torn write' % self.name)
        with open(mpath) as f:
            doc = json.load(f)
        geom = doc.get('geom') or {}
        if int(geom.get('slots') or 0) != self.slots:
            raise ArenaCorrupt(
                'arena %r: manifest records %s slots, this arena was '
                'built with %d' % (self.name, geom.get('slots'),
                                   self.slots))
        self._load_entries(geom, doc.get('entries') or [])

    def _load_entries(self, geom, entries):
        if geom.get('n_arrays'):
            try:
                self._ensure(geom['n_arrays'], geom['row_dim'],
                             geom['dtype'])
            except (ValueError, OSError) as e:
                raise ArenaCorrupt(
                    'arena %r: data file does not match the recorded '
                    'geometry %r (%s: %s)' % (self.name, geom,
                                              type(e).__name__, e))
        self._entries = {}
        used = set()
        for raw, slot, crc in entries:
            slot = int(slot)
            if not 0 <= slot < self.slots or slot in used:
                raise ArenaCorrupt(
                    'arena %r: manifest references slot %d (slots=%d, '
                    'dup=%s) — not adoptable' % (self.name, slot,
                                                 self.slots, slot in used))
            used.add(slot)
            self._entries[int(raw)] = (slot, int(crc))
        self._free = [s for s in range(self.slots - 1, -1, -1)
                      if s not in used]
        self._limbo = []

    # -- spill / restore ---------------------------------------------------

    def put_many(self, items):
        """Spill `items` = [(raw_id, [row vectors in state-name order])]
        into free slots; ONE manifest commit for the batch. Returns the
        raw ids that did NOT fit (arena full) — the caller owns the loud
        fallback. Slot data flushes before the manifest references it:
        a crash mid-put leaves the old manifest and only unreferenced
        slots touched."""
        if not items:
            return []
        dropped = []
        with self._lock:
            vecs0 = items[0][1]
            dtypes = {str(np.asarray(v).dtype) for v in vecs0}
            if len(dtypes) > 1:
                raise ValueError(
                    'arena %r: mixed dtypes %s across the table and its '
                    'optimizer state — the slot store is one homogeneous '
                    'memmap; a cast would break the bit-exact round trip'
                    % (self.name, sorted(dtypes)))
            self._ensure(len(vecs0), np.asarray(vecs0[0]).shape[-1],
                         dtypes.pop())
            wrote = False
            for raw, vecs in items:
                raw = int(raw)
                old = self._entries.pop(raw, None)
                if old is not None:
                    self._limbo.append(old[0])
                if not self._free:
                    dropped.append(raw)
                    continue
                slot = self._free.pop()
                for i, v in enumerate(vecs):
                    self._mm[slot, i, :] = np.asarray(v).reshape(-1)
                crc = zlib.crc32(self._mm[slot].tobytes()) & 0xFFFFFFFF
                self._entries[raw] = (slot, crc)
                self.puts += 1
                wrote = True
            if wrote:
                self._mm.flush()
            self._commit_locked()
        return dropped

    def put(self, raw_id, vecs):
        """Single-id spill; ArenaFull is typed (put_many reports drops
        instead, for the trainer's loud-fallback path)."""
        if self.put_many([(raw_id, vecs)]):
            raise ArenaFull(
                'arena %r: no free slot for id %d (%d slots, %d limbo '
                'pending the next checkpoint)' % (self.name, int(raw_id),
                                                  self.slots,
                                                  len(self._limbo)))

    def peek(self, raw_id):
        """Read a spilled id's vectors WITHOUT releasing its slot (the
        prefetch leg — release happens at the step boundary through
        `discard_many` once the scatter landed). Returns None when the
        id is not spilled; a CRC mismatch is the typed ArenaCorrupt."""
        with self._lock:
            ent = self._entries.get(int(raw_id))
            if ent is None:
                return None
            slot, want = ent
            buf = np.array(self._mm[slot])    # copy out of the mmap
            got = zlib.crc32(buf.tobytes()) & 0xFFFFFFFF
            if got != want:
                raise ArenaCorrupt(
                    'arena %r: slot %d (id %d) CRC32 %08x does not match '
                    'the committed %08x — torn or bit-rotted; not served'
                    % (self.name, slot, int(raw_id), got, want))
            self.takes += 1
            return [buf[i] for i in range(buf.shape[0])]

    def discard_many(self, raw_ids):
        """Release restored ids' slots into LIMBO (recycled only after
        the next checkpoint commits — the last committed serial may
        still reference them) and commit the manifest once."""
        changed = False
        with self._lock:
            for raw in raw_ids:
                ent = self._entries.pop(int(raw), None)
                if ent is not None:
                    self._limbo.append(ent[0])
                    changed = True
            if changed:
                self._commit_locked()

    def mark_checkpoint(self):
        """A checkpoint committed: slots released since the last mark
        are no longer referenced by any resumable manifest — recycle
        them into the free list."""
        with self._lock:
            self._free.extend(self._limbo)
            self._limbo = []

    # -- checkpoint seam ---------------------------------------------------

    def snapshot(self):
        """JSON-able spill map for checkpoint meta (geometry + entries;
        free/limbo are derivable on load)."""
        with self._lock:
            return {'slots': self.slots,
                    'geom': {'n_arrays': self._geom[0],
                             'row_dim': self._geom[1],
                             'dtype': self._geom[2]}
                    if self._geom else None,
                    'entries': [[int(k), int(s), int(c)]
                                for k, (s, c) in self._entries.items()]}

    def load_snapshot(self, snap):
        """Exact-resume restore: the checkpoint-time spill map becomes
        the arena state (and is re-committed to the directory manifest
        so a later standalone adoption agrees). Slot data is verified
        lazily — a recycled-then-overwritten slot from a pre-checkpoint
        serial fails the CRC on peek, loudly."""
        if int(snap.get('slots') or 0) != self.slots:
            raise ValueError(
                'arena %r: checkpoint spill map is for %s slots, this '
                'arena has %d — geometry mismatch'
                % (self.name, snap.get('slots'), self.slots))
        with self._lock:
            self._load_entries(snap.get('geom') or {},
                               snap.get('entries') or [])
            self._commit_locked()
        return self

    def __contains__(self, raw_id):
        with self._lock:
            return int(raw_id) in self._entries

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def stats(self):
        with self._lock:
            return {'slots': self.slots, 'used': len(self._entries),
                    'free': len(self._free), 'limbo': len(self._limbo),
                    'puts': self.puts, 'takes': self.takes,
                    'bytes': int(self._mm.nbytes) if self._mm is not None
                    else 0}


def _crc32_file(path, chunk=1 << 20):
    crc = 0
    with open(path, 'rb') as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def _row_index(rows, device):
    """The rows as an int64 index on `device`; on the card it crosses from
    pinned memory without blocking."""
    idx = torch.as_tensor(np.asarray(rows, np.int64))
    if device.type == 'cuda':
        idx = idx.pin_memory().to(device, non_blocking=True)
    return idx


def _check_tensors(tensors, what):
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError('%s writes tensors in place, got %r'
                            % (what, type(t).__name__))
    dtypes = sorted({str(t.dtype) for t in tensors})
    if len(dtypes) > 1:
        raise ValueError(
            '%s: mixed dtypes %s across the table and its optimizer state '
            '— the arena is one homogeneous slot store; a cast would break '
            'the bit-exact round trip' % (what, dtypes))


class RowSpiller(object):
    """Gather rows to the host AND zero them, in place (the spill leg).

    The evicted rows' current values (table + moments) come back as host
    arrays for the arena, and the same boundary zeroes them for their
    next owner (`streaming.RowResetter`'s semantics, fused). The JAX
    version is one donated jit a 256-row chunk, padded for its jit cache,
    whose results the trainer rebinds. Here the tensors are the captured
    step's static state: the rows are gathered (`index_select` of each
    tensor, stacked to [rows, arrays, D]), copied to pinned host memory in
    ONE copy, and zeroed with `index_fill_`, all queued on the caller's
    current stream (the one the replays run on) under `lock`. The host
    then waits once for the copy (`host_waits` counts the waits: the spill
    is the tier's one read of the card). A fill has no signature to keep,
    so the row count may change from call to call."""

    def __init__(self):
        self.host_waits = 0

    def spill(self, tensors, rows, lock=None):
        """Returns (tensors, {row: [vec per tensor]}): the same tensors,
        input order, with `rows` zeroed. Empty rows is a no-op."""
        rows = [int(r) for r in rows]
        tensors = list(tensors)
        if not rows:
            return tensors, {}
        _check_tensors(tensors, 'RowSpiller.spill')
        dev = tensors[0].device
        idx = _row_index(rows, dev)
        done = None
        with (lock if lock is not None else contextlib.nullcontext()), \
                torch.no_grad():
            gathered = torch.stack([t.index_select(0, idx)
                                    for t in tensors], 1)
            if dev.type == 'cuda':
                host = torch.empty(gathered.shape, dtype=gathered.dtype,
                                   pin_memory=True)
                host.copy_(gathered, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = gathered
            for t in tensors:
                t.index_fill_(0, idx, 0)
        if done is not None:
            done.synchronize()
            self.host_waits += 1
        arr = host.numpy()
        out = {}
        for j, r in enumerate(rows):
            out[r] = [arr[j, i] for i in range(len(tensors))]
        return tensors, out


class RowRestorer(object):
    """Scatter host row values back into the table + moments, in place
    (the restore leg): the values cross to the card from memory pinned by
    `pin_memory()` with `non_blocking=True` (the caching host allocator
    holds the block until the copy has run), then one `index_copy_` a
    tensor, on the caller's current stream under `lock`. The JAX version
    is one donated scatter jit a 256-row chunk, rebound by its trainer."""

    def restore(self, tensors, rows, values, lock=None):
        """values: per-tensor [len(rows), D] host arrays (state-name
        order). Returns the same tensors, input order."""
        rows = [int(r) for r in rows]
        tensors = list(tensors)
        if not rows:
            return tensors
        _check_tensors(tensors, 'RowRestorer.restore')
        dev = tensors[0].device
        idx = _row_index(rows, dev)
        vals = torch.from_numpy(np.ascontiguousarray(
            np.stack([np.asarray(v) for v in values], 1)))
        if dev.type == 'cuda':
            vals = vals.pin_memory().to(dev, non_blocking=True)
        with (lock if lock is not None else contextlib.nullcontext()), \
                torch.no_grad():
            for i, t in enumerate(tensors):
                t.index_copy_(0, idx, vals[:, i])
        return tensors


class TieredVocabTable(object):
    """A `VocabTable` whose evictions SPILL to a :class:`HostArena` and
    whose re-admissions RESTORE from it — the card's table as a cache
    tier.

    Duck-types the `VocabTable` surface `Trainer.train_stream` and the
    `DeltaPublisher` consume (translate / lookup / state_dict / ... all
    delegate), plus the tier seam the trainer drives:

      * `translate` additionally logs the vocab's admission/eviction
        MOVES and, for a re-admitted spilled id, prefetches its arena
        slot on the calling thread (the prefetch worker under
        double_buffer — the step never blocks on arena IO);
      * `apply_step_boundary(read, write, names, lock=)` applies the
        pending device traffic at the step boundary (where no batch is in
        flight), in place in the tensors `read` returns: one gather+zero
        spills evicted rows into the arena, one scatter restores
        re-admitted rows — and returns {table: rows} it mutated so
        `DeltaPublisher.touched_rows` stays correct across a
        spill/restore cycle.

    Applying pending ops EARLY (at a boundary before the op's batch
    dispatches — the prefetch window) is safe by the lease invariant:
    an evicted row was unpinned, so no in-flight batch references it,
    and a restored row's first reader is the batch that admitted it.
    """

    def __init__(self, vocab, arena, spill_batch=256):
        self.vocab = vocab
        self.arena = arena
        # the JAX chunk size of its padded jits; stored for parity (the
        # port's gather, copy and scatter take every row in one call)
        self.spill_batch = int(spill_batch)
        vocab._log_moves = True
        # one lock serializes translate (worker) against the boundary
        # drain + state_dict (loop thread): a vocab mutation and its
        # move-log entry must never straddle a drain — a reset row
        # zeroed before its spill op is visible would lose the state
        self._lock = threading.RLock()
        self._ops = []        # ordered [('spill'|'restore', raw, row)]
        self._staged = {}     # raw id -> prefetched host vectors
        self._inflight_spill = set()   # ids being put_many'd right now
        self._spiller = RowSpiller()
        self._restorer = RowRestorer()
        # cumulative stats (bench + the obs_report tiers section)
        self.tier_hits = 0        # re-admissions restored from the arena
        self.tier_misses = 0      # admissions with no spilled state
        self.spilled = 0
        self.restored = 0
        self.dropped_full = 0     # loud arena-full fallbacks to zeroing
        self.corrupt_slots = 0    # loud CRC fallbacks to zeroing
        self.last_spill_ms = None
        self.last_restore_ms = None
        self.restore_ms_samples = []   # bounded; bench percentiles
        self.spill_ms_samples = []     # bounded, as restore_ms_samples

    # -- delegated VocabTable surface --------------------------------------

    @property
    def table(self):
        return self.vocab.table

    @property
    def name(self):
        return self.vocab.name

    @property
    def capacity(self):
        return self.vocab.capacity

    @property
    def cold_row(self):
        return self.vocab.cold_row

    def lookup(self, ids):
        return self.vocab.lookup(ids)

    def resident_ids(self):
        return self.vocab.resident_ids()

    def rows_of(self, ids):
        return self.vocab.rows_of(ids)

    def drain_resets(self):
        return self.vocab.drain_resets()

    def __len__(self):
        return len(self.vocab)

    # -- translation + prefetch --------------------------------------------

    def translate(self, ids, pin=True):
        with self._lock:
            out = self.vocab.translate(ids, pin=pin)
            self._log_moves_locked()
        return out

    def preload(self, ids):
        with self._lock:
            self.vocab.preload(ids)
            self._log_moves_locked()
        return self

    def evict(self, raw_id):
        with self._lock:
            row = self.vocab.evict(raw_id)
            self._log_moves_locked()
        return row

    def _log_moves_locked(self):
        """Fold the vocab's admission/eviction moves into the pending op
        log; prefetch a re-admitted spilled id's slot HERE (the calling
        thread is the prefetch worker under double_buffer). Caller holds
        self._lock — the drain of moves is atomic with the vocab
        mutation that produced them."""
        moves = self.vocab.drain_moves()
        if not moves:
            return
        prefetched = []
        pending_spill = {raw for kind, raw, _ in self._ops
                         if kind == 'spill'}
        for kind, raw, row in moves:
            if kind == 'evict':
                self._ops.append(('spill', raw, row))
                pending_spill.add(raw)
                continue
            # admission: warm when the arena (or this window's
            # not-yet-applied / in-flight spills) holds trained state
            if raw in pending_spill or raw in self._inflight_spill:
                self._ops.append(('restore', raw, row))
                self.tier_hits += 1
                _C_HITS.inc()
                continue
            staged = None
            try:
                staged = self.arena.peek(raw)
            except ArenaCorrupt as e:
                self._corrupt_fallback(raw, e)
            if staged is None:
                self.tier_misses += 1
                _C_MISSES.inc()
                continue
            self._staged[raw] = staged
            self._ops.append(('restore', raw, row))
            self.tier_hits += 1
            _C_HITS.inc()
            prefetched.append(raw)
        if prefetched:
            obs.event('streaming.tier.prefetch', vocab=self.name,
                      rows=len(prefetched), sample=prefetched[:8])

    def _corrupt_fallback(self, raw, err):
        """A CRC-mismatched slot is NEVER served: drop it loudly and let
        the id restart cold (the zeroing path) — wrong state would be
        silent corruption, a cold row is just the pre-tier behavior."""
        self.corrupt_slots += 1
        self.arena.discard_many([raw])
        obs.event('streaming.tier.corrupt', vocab=self.name,
                  id=int(raw), error=str(err)[:200])
        warnings.warn(
            'tiered vocab %r: spilled state for id %d failed its CRC '
            'check and was dropped — the id restarts cold (%s)'
            % (self.name, int(raw), err), RuntimeWarning)

    # -- the step-boundary device seam -------------------------------------

    def validate_program(self, program):
        """Typed refusal of a dim-sharded table: spills gather WHOLE
        rows; column sharding is a named ROADMAP leftover ("Parallel").
        The message is the JAX one. Stamps `tiered` on the table var (the
        JAX static sharding pass reads it; the port keeps it as
        metadata that serializes with the program)."""
        blk = program.global_block()
        tvar = blk.vars.get(self.table)
        if tvar is None:
            raise KeyError('no variable %r in the program'
                           % (self.table,))
        tvar.tiered = True
        sh = getattr(tvar, 'sharding', None)
        if sh and any(ax is not None for ax in tuple(sh)[1:]):
            raise DimShardingUnsupported(
                'tiered vocab %r: table %r shards its EMBEDDING dim '
                '(sharding=%r) — a spill would tear rows across hosts. '
                'Column sharding for D > HBM is out of scope for the '
                'tier store (ROADMAP item 3); row-shard the table '
                '(e.g. sharding=(%r, None)) instead.'
                % (self.name, self.table, tuple(sh),
                   tuple(sh)[1] if len(sh) > 1 else 'model'))

    def apply_step_boundary(self, read, write, names, lock=None):
        """Apply pending spills/restores + the reset zeroing, in place.
        `read(name)` is the trainer's scope accessor; `names` the
        `table_state_names` list; `lock` (the executor's) serializes the
        device writes with its steps. `write` keeps the JAX signature
        (the JAX boundary rebinds its new arrays through it) and is not
        called: the tensors `read` returns are written in place, so a
        captured step keeps reading them. Returns {table: sorted row
        array} of every row mutated (zeroed or restored) — fed to the
        publisher so serving replicas converge after a spill/restore
        cycle."""
        with self._lock:
            # the drain is atomic with translate: every reset row's
            # spill op is already in the log (the translate that queued
            # the reset logged the move before releasing the lock)
            ops, self._ops = self._ops, []
            staged, self._staged = self._staged, {}
            rows_to_zero = self.vocab.drain_resets()
            spills = [(raw, row) for kind, raw, row in ops
                      if kind == 'spill']
            restores = [(raw, row) for kind, raw, row in ops
                        if kind == 'restore']
            # a re-admission racing the put_many below must see these
            # ids as warm (their state is in flight to the arena)
            self._inflight_spill = {raw for raw, _ in spills}
        if not rows_to_zero and not restores:
            with self._lock:
                self._inflight_spill = set()
            return None
        tensors = [read(n) for n in names]
        changed = set()

        if rows_to_zero:
            t0 = time.monotonic()
            _, gathered = self._spiller.spill(tensors, rows_to_zero,
                                              lock=lock)
            dropped = self.arena.put_many(
                [(raw, gathered[row]) for raw, row in spills])
            with self._lock:
                self._inflight_spill = set()
            self.last_spill_ms = (time.monotonic() - t0) * 1000.0
            if len(self.spill_ms_samples) < 4096:
                self.spill_ms_samples.append(self.last_spill_ms)
            changed.update(rows_to_zero)
            n_spilled = len(spills) - len(dropped)
            self.spilled += n_spilled
            _C_SPILLS.inc(n_spilled)
            _G_SPILL_MS.set(self.last_spill_ms)
            st = self.arena.stats()
            _G_OCCUPANCY.set(st['used'] / float(st['slots']))
            obs.event('streaming.tier.spill', vocab=self.name,
                      rows=n_spilled, zeroed=len(rows_to_zero),
                      spill_ms=round(self.last_spill_ms, 3),
                      arena_used=st['used'], arena_slots=st['slots'])
            if dropped:
                self._arena_full_fallback(dropped, st)

        if restores:
            t0 = time.monotonic()
            ok_rows, ok_vals, ok_ids = [], [], []
            for raw, row in restores:
                vecs = staged.pop(raw, None)
                if vecs is None:
                    # spilled-and-re-admitted inside one prefetch
                    # window: the arena entry landed just above
                    try:
                        vecs = self.arena.peek(raw)
                    except ArenaCorrupt as e:
                        self._corrupt_fallback(raw, e)
                        continue
                if vecs is None:
                    # arena-full dropped this id's spill: it restarts
                    # cold (already counted loudly above)
                    continue
                ok_rows.append(row)
                ok_vals.append(vecs)
                ok_ids.append(raw)
            if ok_rows:
                values = [np.stack([v[i] for v in ok_vals])
                          for i in range(len(names))]
                self._restorer.restore(tensors, ok_rows, values, lock=lock)
                self.arena.discard_many(ok_ids)
                self.last_restore_ms = (time.monotonic() - t0) * 1000.0
                changed.update(ok_rows)
                self.restored += len(ok_rows)
                _C_RESTORES.inc(len(ok_rows))
                _G_RESTORE_MS.set(self.last_restore_ms)
                if len(self.restore_ms_samples) < 4096:
                    self.restore_ms_samples.append(self.last_restore_ms)
                obs.event('streaming.tier.restore', vocab=self.name,
                          rows=len(ok_rows),
                          restore_ms=round(self.last_restore_ms, 3))
        _G_HIT_RATE.set(self.hit_rate())

        if not changed:
            return None
        return {self.table: np.asarray(sorted(changed), np.int64)}

    def _arena_full_fallback(self, dropped, st):
        """Arena full: the old zeroing path, LOUDLY — the ids restart
        cold (their rows were zeroed by the spill; nothing
        wrong is ever served), typed event + warning, never silent."""
        self.dropped_full += len(dropped)
        _C_DROPPED.inc(len(dropped))
        obs.event('streaming.tier.arena_full', vocab=self.name,
                  dropped=len(dropped), sample=dropped[:8],
                  arena_slots=st['slots'])
        warnings.warn(
            'tiered vocab %r: arena %r is FULL (%d slots) — %d evicted '
            'id(s) fell back to the zeroing path and will re-admit '
            'cold. Provision more slots (or checkpoint more often to '
            'recycle limbo slots).' % (self.name, self.arena.name,
                                       st['slots'], len(dropped)),
            RuntimeWarning)

    def mark_checkpoint(self):
        """Trainer hook: a checkpoint committed — limbo slots recycle."""
        self.arena.mark_checkpoint()

    # -- checkpoint seam ---------------------------------------------------

    def state_dict(self):
        """Vocab map + arena spill map + pending (not-yet-applied) ops.
        Staged prefetch values are NOT serialized: their arena entries
        still exist (slots release only after the scatter lands), so a
        resumed table re-reads them by id."""
        with self._lock:
            # one lock span: the vocab map, its pending resets, the op
            # log, and the spill map must snapshot as ONE instant — a
            # translate landing mid-snapshot would desync them
            ops = [[k, int(r), int(w)] for k, r, w in self._ops]
            vocab_sd = self.vocab.state_dict()
            arena_sd = self.arena.snapshot()
        return {'tiered': True,
                'vocab': vocab_sd,
                'arena': arena_sd,
                'ops': ops,
                'stats': {'tier_hits': self.tier_hits,
                          'tier_misses': self.tier_misses,
                          'spilled': self.spilled,
                          'restored': self.restored,
                          'dropped_full': self.dropped_full,
                          'corrupt_slots': self.corrupt_slots}}

    def load_state_dict(self, state):
        with self._lock:
            return self._load_state_locked(state)

    def _load_state_locked(self, state):
        if not state.get('tiered'):
            # a plain-vocab checkpoint: adoptable (the tier starts
            # empty — pre-tier checkpoints stay resumable)
            self.vocab.load_state_dict(state)
            self.vocab.drain_moves()
            return self
        self.vocab.load_state_dict(state['vocab'])
        self.vocab.drain_moves()
        self.arena.load_snapshot(state['arena'])
        self._ops = [(str(k), int(r), int(w))
                     for k, r, w in state.get('ops', [])]
        self._staged = {}
        st = state.get('stats', {})
        self.tier_hits = int(st.get('tier_hits', 0))
        self.tier_misses = int(st.get('tier_misses', 0))
        self.spilled = int(st.get('spilled', 0))
        self.restored = int(st.get('restored', 0))
        self.dropped_full = int(st.get('dropped_full', 0))
        self.corrupt_slots = int(st.get('corrupt_slots', 0))
        return self

    # -- stats -------------------------------------------------------------

    def hit_rate(self):
        total = self.tier_hits + self.tier_misses
        return self.tier_hits / float(total) if total else 1.0

    def stats(self):
        out = self.vocab.stats()
        out.update(self.arena.stats())
        out.update({'tier_hits': self.tier_hits,
                    'tier_misses': self.tier_misses,
                    'tier_hit_rate': self.hit_rate(),
                    'spilled': self.spilled,
                    'restored': self.restored,
                    'dropped_full': self.dropped_full,
                    'corrupt_slots': self.corrupt_slots,
                    'last_spill_ms': self.last_spill_ms,
                    'last_restore_ms': self.last_restore_ms})
        return out
