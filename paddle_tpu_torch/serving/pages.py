"""Paged decode-state memory: the block-pool allocator + prefix cache.

Parity: the JAX package's serving/pages.py (pages_for :61, content_key
:66, PagePool :81, PrefixCache :145), copied as it is: the module is pure
Python and numpy, and decides between dispatches only WHICH physical page
backs which logical page. Its refcounted LRU is the port's
utils/lru.RefCountedLRU, which streaming.VocabTable shares.

The paged engine (``DecodeConfig(page_size=..., pages=...)``) keeps token
history and encoder rows in fixed-size PAGES drawn from two
device-resident pools instead of dense worst-case per-slot buffers:

  * token-history pages ``[pages, page_size, beam]`` (ids + parents),
    indexed per slot through an int32 page table
    ``pt_hist [slots, ceil(max_len/page_size)]``;
  * encoder-row pages ``[enc_pages, page_size, enc_dim]`` (+ the
    attention mask rows), through ``pt_enc``.

:class:`PagePool` is the free-list allocator: admission claims
``ceil(limit/page_size)`` history pages and ``ceil(src_len/page_size)``
encoder pages, release returns them, and a join that cannot get pages
BLOCKS in the admission queue. :class:`PrefixCache` keeps encoder pages
RESIDENT after release, keyed by a content hash of the request's encoder
rows (:func:`content_key`): a request whose prefix is resident joins
without rewriting them, its page table pointing at the shared pages
(refcounted while any slot uses them); under pool pressure unreferenced
entries are evicted least-recently-used.

Encoder page 0 is reserved as the permanent ZERO page: slots whose source
is shorter than ``src_cap`` point their tail page-table entries at it, so
the attention always reads finite zeros under its masked-out rows.
"""
import collections
import hashlib

import numpy as np

from ..utils.lru import RefCountedLRU

__all__ = ['PagePool', 'PrefixCache', 'content_key', 'pages_for']


def pages_for(rows, page_size):
    """Physical pages needed to back `rows` logical rows."""
    return -(-int(rows) // int(page_size))


def content_key(feed):
    """Stable content hash of a request feed (the prefix-cache key):
    sorted keys, each value's dtype/shape/bytes hashed. Two requests
    with bit-identical encoder inputs share resident pages."""
    h = hashlib.sha1()
    for k in sorted(feed):
        v = feed[k]
        h.update(str(k).encode())
        a = np.asarray(v)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class PagePool(object):
    """Free-list allocator over a fixed pool of device-resident pages.

    `reserved` pages (the encoder pool's zero page) are never handed
    out. All methods are called from the decode-loop thread only; the
    integer counters (`free_count`, `total`) are read lock-free by the
    stats surface.
    """

    def __init__(self, total, reserved=0):
        self.total = int(total)
        self.reserved = int(reserved)
        if self.total <= self.reserved:
            raise ValueError('page pool needs > %d page(s), got %d'
                             % (self.reserved, self.total))
        self._free = collections.deque(range(self.reserved, self.total))
        self.free_count = len(self._free)
        self.allocated = 0      # cumulative
        self.freed = 0          # cumulative

    @property
    def usable(self):
        """Pages the pool can ever hand out (total minus reserved)."""
        return self.total - self.reserved

    def alloc(self, n, cache=None):
        """Claim `n` pages; evicts LRU unreferenced prefix-cache entries
        through `cache` when the free list is short. Returns the page
        list, or None when the pool (plus everything evictable) cannot
        cover the request — the caller blocks, it never crashes."""
        n = int(n)
        while cache is not None and len(self._free) < n:
            if not cache.evict_one():
                break
        if len(self._free) < n:
            return None
        out = [self._free.popleft() for _ in range(n)]
        self.free_count = len(self._free)
        self.allocated += n
        return out

    def release(self, pages):
        """Return pages to the free list (slot release / cache evict)."""
        for p in pages:
            self._free.append(p)
        self.free_count = len(self._free)
        self.freed += len(pages)

    def available(self, cache=None):
        """Pages obtainable RIGHT NOW: free plus evictable residents."""
        n = len(self._free)
        if cache is not None:
            n += cache.evictable_pages()
        return n


class _Resident(object):
    __slots__ = ('pages', 'src_len')

    def __init__(self, pages, src_len):
        self.pages = pages
        self.src_len = src_len


class PrefixCache(object):
    """Content-hash -> resident encoder pages, refcounted, LRU-evicted
    through the owning :class:`PagePool`.

    A hit bumps the entry's ref count and its LRU position and returns
    the resident pages + src_len; the joining request points its page
    table at them. `unref` on slot release leaves the entry resident
    (refs may drop to 0); only pool pressure evicts it,
    least-recently-used first. `on_evict(key, pages)` lets the engine
    emit the eviction event.
    """

    def __init__(self, pool, on_evict=None):
        self._pool = pool
        self._lru = RefCountedLRU()                # key -> _Resident
        self._on_evict = on_evict
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self):
        return len(self._lru)

    def peek(self, key):
        """True when `key` is resident — the admission gate's page-need
        probe; no counter or ref-count side effects."""
        return key in self._lru

    def pinnable_pages(self, key):
        """Pages a hit on `key` would take OUT of the evictable budget:
        the entry's page count while it is unreferenced (a referenced
        entry was never evictable, so pinning it costs nothing)."""
        e = self._lru.get(key)
        return len(e.pages) if e is not None and self._lru.refs(key) == 0 \
            else 0

    def lookup(self, key):
        """(pages, src_len) on a hit (ref count bumped), else None."""
        e = self._lru.get(key)
        if e is None:
            self.misses += 1
            return None
        self._lru.ref(key)
        self._lru.touch(key)
        self.hits += 1
        return list(e.pages), e.src_len

    def insert(self, key, pages, src_len, refs=1):
        """Make freshly-written pages resident under `key`. The pages
        stay OUT of the pool's free list until evicted."""
        if key in self._lru:            # racing duplicate miss: keep
            for _ in range(int(refs)):  # the first copy, free ours
                self._lru.ref(key)
            self._pool.release(pages)
            return
        self._lru.insert(key, _Resident(list(pages), int(src_len)),
                         refs=int(refs))

    def unref(self, key):
        """One slot stopped using the entry; it STAYS resident."""
        self._lru.unref(key)

    def evictable_pages(self):
        return self._lru.evictable(weigh=lambda e: len(e.pages))

    def evict_one(self):
        """Evict the least-recently-used unreferenced entry, returning
        its pages to the pool. False when nothing is evictable."""
        victim = self._lru.evict_one()
        if victim is None:
            return False
        key, e = victim
        self._pool.release(e.pages)
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict(key, e.pages)
        return True

    def stats(self):
        return {'entries': len(self._lru), 'hits': self.hits,
                'misses': self.misses, 'evictions': self.evictions,
                'resident_pages': sum(len(e.pages)
                                      for _, e in self._lru.items())}
