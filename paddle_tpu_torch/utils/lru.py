"""Refcounted LRU bookkeeping, shared by every resident-until-evicted map.

Parity: the JAX package's utils/lru.py (RefCountedLRU :33), copied as it
is: the structure is pure Python.

Two subsystems keep the same invariant with the same data structure: a
key stays RESIDENT after its last user lets go (that residency is the
whole point — the next user hits), a live reference pins it against
eviction, and pressure reclaims the least-recently-used unreferenced
entry. `serving.pages.PrefixCache` pins resident encoder pages this way
(refs = slots currently decoding against the prefix) and
`streaming.vocab.VocabTable` pins embedding rows (refs = in-flight
training batches whose sparse gradient will still write the row —
evicting one of those would tear the update). Both ride this class; the
paged decode drills and the streaming drills pin the shared behavior.

The structure is a single OrderedDict: insertion/touch order IS the
recency order (move_to_end on touch, eviction scans from the front), so
there is no separate clock to drift out of sync. Not thread-safe;
callers own their locking.
"""
import collections

__all__ = ['RefCountedLRU']


class _Entry(object):
    __slots__ = ('value', 'refs')

    def __init__(self, value, refs):
        self.value = value
        self.refs = refs


class RefCountedLRU(object):
    """key -> (value, refs) with LRU eviction of refs==0 entries."""

    def __init__(self):
        self._entries = collections.OrderedDict()

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def get(self, key):
        """The entry's value (None when absent). No recency or refcount
        side effects — the peek/probe read."""
        e = self._entries.get(key)
        return None if e is None else e.value

    def refs(self, key):
        e = self._entries.get(key)
        return 0 if e is None else e.refs

    def insert(self, key, value, refs=0):
        """Insert a NEW entry (most-recent position). Raises on a
        duplicate key — the callers' duplicate policies differ (keep
        first copy vs error), so they decide before inserting."""
        if key in self._entries:
            raise KeyError('duplicate LRU key %r' % (key,))
        self._entries[key] = _Entry(value, int(refs))

    def touch(self, key):
        """Mark `key` most recently used."""
        self._entries.move_to_end(key)

    def ref(self, key):
        """Pin: one more live user. Pinned entries are never evicted."""
        self._entries[key].refs += 1

    def unref(self, key):
        """One user let go; the entry STAYS resident (floor at 0 — a
        stray double-unref must not un-pin somebody else's reference).
        Missing keys are tolerated: the entry may have been pop()'d by
        an explicit eviction between ref and unref."""
        e = self._entries.get(key)
        if e is not None and e.refs > 0:
            e.refs -= 1

    def pop(self, key):
        """Remove `key` unconditionally, returning its value."""
        return self._entries.pop(key).value

    def evict_one(self):
        """Evict the least-recently-used UNREFERENCED entry. Returns
        (key, value), or None when everything resident is pinned."""
        victim = None
        for key, e in self._entries.items():   # front = least recent
            if e.refs == 0:
                victim = key
                break
        if victim is None:
            return None
        return victim, self._entries.pop(victim).value

    def evictable(self, weigh=None):
        """Total weight of evictable (refs==0) entries; `weigh(value)`
        defaults to 1 per entry."""
        if weigh is None:
            return sum(1 for e in self._entries.values() if e.refs == 0)
        return sum(weigh(e.value) for e in self._entries.values()
                   if e.refs == 0)

    def items(self):
        """(key, value) pairs in recency order (least recent first)."""
        return [(k, e.value) for k, e in self._entries.items()]
