"""Continuous batching for autoregressive beam decode.

Parity: the JAX package's serving/decode.py (StreamCancelled :97,
DecodeConfig :104, mt_weights :243, program_prefill :254, LockstepDecoder
:290, DecodeEngine :410), the dense, the paged and the speculative engine,
with token streaming, cancel and checkpoint/resume. An autoregressive
decode request is a SEQUENCE of coupled steps; this module serves one
attention-LSTM beam decoder with iteration-level scheduling:

  * a fixed-capacity SLOT POOL holds per-sequence decode state (beam
    scores, LSTM rows, token history, encoder rows) as persistable device
    tensors of shape [slots, ...];
  * ONE step program (`attention_lstm_beam_decode_step`, or
    `attention_lstm_beam_paged_step` in paged mode) advances every ACTIVE
    slot per call, through `Executor.acquire_step`'s pinned StepHandle;
    where-select masking keeps dead and poisoned slots from perturbing
    live ones;
  * JOIN/LEAVE happens between steps on the host: a finished sequence
    (all beams ended, or its token limit reached) releases its slot and
    resolves its Future at once, and queued requests join free slots
    mid-flight;
  * PAGED state memory (`DecodeConfig(page_size=, pages=)`): token history
    and encoder rows live in fixed-size pages claimed at admission for
    each request's own limit and source length (serving/pages.py), read
    through int32 page tables; on the card the step's attention is the
    hand-written paged_attention kernel. A full pool blocks admission;
  * PREFIX caching: released encoder pages stay resident keyed by the
    request's content, and a request with the same source joins without
    a prefill and without writing its pages again;
  * admission PREFILL (`DecodeEngine(prefill=)`, e.g. `program_prefill`
    over machine_translation's generating program): the encoder runs on
    the joining requests' tokens in batches padded to power-of-two
    buckets, one feed signature (and on the card one captured graph) a
    bucket;
  * SPECULATIVE decoding (`DecodeConfig(spec_k=K)` with
    `DecodeEngine(draft=)`, paged, beam 1): a draft proposes K tokens and
    the target verifies them in one dispatch, accept and rollback on the
    device; every attend of the step is the paged_attention kernel on the
    card;
  * STREAMING (`submit(on_token=)`): every generated beam row is handed
    to the caller, in order, from the decode loop; `cancel(future)` (or a
    raising callback) aborts the slot at the next tick, its pages back in
    the pool; `checkpoint=` / `ckpt_every=` take the slot's whole decode
    state every N tokens, and `submit(resume=state)` continues from it
    token-exact, on this engine or another one (the checkpoint dict has
    the JAX engine's keys, shapes and dtypes, so it crosses packages).

Requests carry source tokens for the prefill, or encoder rows directly,
`submit({'enc': [S, D]})`, when the engine has none. `LockstepDecoder` is
the whole-batch baseline both are held to: the generating program's beam
decode fed encoder rows. The join is a plain function over the handle's
tensors (the JAX engine's
jitted scatter): it writes one row per joining request in place with
index_copy_, whose targets are distinct. On the card those tensors are the
static state of the step's captured CUDA graph, so the next replay reads
the joined rows, and the step's fetches are clones that the next replay
leaves as they are. The step and the join run under torch.no_grad().
Abort, resume and `push_rows` write into the same tensors the same way: in
place (index_copy_, a slice assignment or a fill), on the loop's stream,
under the handle lock, so no tensor is rebound and nothing is captured
again.

Per dispatch the loop reads back one small tensor (each slot's active
flag and step count), and the history pools and scores only when a slot
releases. While a streaming or checkpointing slot is present, the pools,
the scores and the state rows of the slots whose checkpoint may fall due
join that one copy, so a streaming dispatch makes exactly one host sync.
`stats['host_syncs']` counts the copies.

Observability: decode.slots.occupied / decode.queue.depth /
decode.pages.free gauges, decode.step.seconds + decode.ttft.seconds
histograms, join/release/poison/prefix/prefill-error events, token and
speculative proposed/accepted counters.
"""
import collections
import concurrent.futures
import threading
import time

import numpy as np
import torch

from .. import obs
from . import buckets as _buckets
from . import pages as _pages
from .engine import (DeadlineExceeded, ServerClosed, ServerOverloaded,
                     WARMUP_RUNS, _POLL_S)

__all__ = ['DecodeConfig', 'DecodeEngine', 'DecodeSlotPoisoned',
           'LockstepDecoder', 'StreamCancelled', 'mt_weights',
           'program_prefill', 'WEIGHT_KEYS']

WEIGHT_KEYS = ('w_dec', 'u_dec', 'b_dec', 'w_q', 'w_emb', 'w_out', 'b_out')
# a checkpoint's per-slot state rows (besides step, acc and the history)
_CKPT_ROWS = ('h', 'c', 'prev_ids', 'fin')
_DRAFT_STATE = ('draft_h', 'draft_c')     # spec_k with a weights draft


class DecodeSlotPoisoned(RuntimeError):
    """Non-finite values appeared in one slot's beam scores (a poisoned
    feed). Only that slot's future receives this error; the slot is freed
    and every other in-flight sequence is untouched."""


class StreamCancelled(RuntimeError):
    """The request was cancelled before completing: a streaming consumer
    went away (its on_token raised) or `cancel()` was called. The slot and
    its pages are already back in the pool when this resolves the
    future."""


class DecodeConfig(object):
    """Slot-pool / admission policy for a DecodeEngine.

    slots:        fixed capacity of the slot pool (the step's batch
                  dimension). Admission prefill batches are padded to the
                  powers of two up to `slots` (admit_buckets).
    beam_size:    beam width per sequence.
    max_len:      token-buffer capacity per slot; a request's
                  max_new_tokens may not exceed it.
    start_id/end_id: decode vocabulary sentinels.
    src_cap:      encoder-row capacity per slot.
    bundle:       decode steps per dispatch; slots finishing mid-bundle
                  freeze, so results equal bundle=1, and join/leave
                  coarsens to the bundle boundary.
    queue_capacity / overflow / default_deadline_ms: admission control
                  (typed ServerOverloaded / DeadlineExceeded).
    page_size:    switches the engine to PAGED state memory: history and
                  encoder rows in fixed-size pages claimed per request.
    pages:        history-pool size (required with page_size); a request
                  claims ceil(limit/page_size) of them.
    enc_pages:    encoder-pool size (default: one full src_cap window per
                  slot + equal headroom for resident prefixes + the
                  reserved zero page).
    prefix_cache: keep released encoder pages resident keyed by request
                  content (default True when paged).
    spec_k:       speculative decoding (paged, beam_size=1 and bundle=1
                  only): a draft proposes spec_k tokens a dispatch and the
                  target verifies them in one step (DecodeEngine(draft=)).
    """

    def __init__(self, slots=8, beam_size=3, max_len=32, start_id=0,
                 end_id=1, src_cap=16, bundle=1, queue_capacity=256,
                 overflow='block', default_deadline_ms=None,
                 page_size=None, pages=None, enc_pages=None,
                 prefix_cache=None, spec_k=None):
        if overflow not in ('block', 'reject'):
            raise ValueError("overflow must be 'block' or 'reject', got %r"
                             % (overflow,))
        if slots < 1:
            raise ValueError('slots must be >= 1')
        if max_len < 1 or src_cap < 1 or beam_size < 1:
            raise ValueError('beam_size, max_len and src_cap must be >= 1')
        if not 1 <= int(bundle) <= int(max_len):
            raise ValueError('bundle must be in [1, max_len=%d], got %r'
                             % (max_len, bundle))
        self.bundle = int(bundle)
        self.slots = int(slots)
        self.beam_size = int(beam_size)
        self.max_len = int(max_len)
        self.start_id = int(start_id)
        self.end_id = int(end_id)
        self.src_cap = int(src_cap)
        self.queue_capacity = int(queue_capacity)
        self.overflow = overflow
        self.default_deadline_ms = default_deadline_ms
        self.admit_buckets = _buckets.default_buckets(self.slots)
        # -- paged state memory -------------------------------------------
        self.paged = page_size is not None
        self.page_size = int(page_size) if self.paged else 0
        self.spec_k = int(spec_k) if spec_k is not None else 0
        if not self.paged:
            if pages is not None or enc_pages is not None:
                raise ValueError('pages/enc_pages require page_size '
                                 '(the paged engine)')
            if prefix_cache:
                raise ValueError('prefix_cache requires page_size (the '
                                 'cache is resident PAGES)')
            if self.spec_k:
                raise ValueError('spec_k requires page_size (speculative '
                                 'decoding runs on the paged engine)')
            self.pages = self.enc_pages = 0
            self.prefix_cache = False
            self.hist_table_width = self.enc_table_width = 0
            return
        if self.page_size < 1:
            raise ValueError('page_size must be >= 1')
        # per-slot page-table widths (static shapes)
        self.hist_table_width = _pages.pages_for(self.max_len,
                                                 self.page_size)
        self.enc_table_width = _pages.pages_for(self.src_cap,
                                                self.page_size)
        if pages is None:
            raise ValueError('paged mode needs pages=N (the history '
                             'pool size; a request claims '
                             'ceil(limit/page_size) of them)')
        self.pages = int(pages)
        if self.pages < self.hist_table_width:
            raise ValueError(
                'pages=%d cannot back even one max_len=%d request '
                '(needs %d pages of %d rows)'
                % (self.pages, self.max_len, self.hist_table_width,
                   self.page_size))
        # +1: encoder page 0 is the reserved zero page. The default holds
        # one worst-case working set for the live slots PLUS equal
        # headroom, so a released prefix survives the next join
        self.enc_pages = (1 + 2 * self.slots * self.enc_table_width
                          if enc_pages is None else int(enc_pages))
        if self.enc_pages < 1 + self.enc_table_width:
            raise ValueError(
                'enc_pages=%d cannot back one src_cap=%d request plus '
                'the reserved zero page (needs %d)'
                % (self.enc_pages, self.src_cap,
                   1 + self.enc_table_width))
        self.prefix_cache = True if prefix_cache is None \
            else bool(prefix_cache)
        if self.spec_k:
            if self.spec_k < 1:
                raise ValueError('spec_k must be >= 1')
            if self.beam_size != 1:
                raise ValueError(
                    'speculative decoding is greedy: spec_k requires '
                    'beam_size=1 (got %d)' % self.beam_size)
            if self.bundle != 1:
                raise ValueError(
                    'spec_k and bundle>1 are mutually exclusive: the '
                    'verify pass IS the bundled dispatch (spec_k tokens '
                    'per step call)')


def mt_weights(scope, name='mt'):
    """Collect the machine_translation decoder's weights from a scope
    (the JAX package's names: mt_w_dec, mt_u_dec, mt_b_dec, mt_w_attnq,
    mt_trg_emb, mt_w_out, mt_b_out) into the numpy dict DecodeEngine
    takes."""
    def pick(suffix):
        v = scope._chain_get(name + suffix)
        if v is None:
            raise KeyError('scope has no %r' % (name + suffix))
        return v.detach().cpu().numpy().copy() \
            if isinstance(v, torch.Tensor) else np.asarray(v)

    return {'w_dec': pick('_w_dec'), 'u_dec': pick('_u_dec'),
            'b_dec': pick('_b_dec'), 'w_q': pick('_w_attnq'),
            'w_emb': pick('_trg_emb'), 'w_out': pick('_w_out'),
            'b_out': pick('_b_out')}


def program_prefill(executor, program, scope, feed_name, fetch,
                    token_cap):
    """A DecodeEngine prefill callable over an ENCODER Program run by
    `executor` in `scope` (e.g. machine_translation's generating program,
    fetching its encoder output). Each request feed is {feed_name: int
    token array [L] or [L, 1]}, L <= token_cap; the tokens are padded to
    `token_cap` steps, so each admission bucket is one feed signature (and
    on the card one captured graph). Returns (enc [n, token_cap, D] with
    zero rows past each source, src_len [n]); token_cap must not exceed
    the engine's src_cap."""
    from ..fluid.lod_tensor import LoDTensor
    from ..fluid.lowering import SeqValue

    def prefill(feeds):
        toks, lens = [], []
        for f in feeds:
            t = np.asarray(f[feed_name]).reshape(-1)
            if t.shape[0] > token_cap:
                raise ValueError(
                    'source of %d token(s) exceeds the prefill token cap '
                    '%d' % (t.shape[0], token_cap))
            lens.append(t.shape[0])
            toks.append(np.pad(t, (0, token_cap - t.shape[0])))
        data = np.stack(toks).astype(np.int64)[:, :, None]
        sv = SeqValue(data, np.asarray(lens, np.int64))
        out, = executor.run(program, feed={feed_name: sv},
                            fetch_list=[fetch], scope=scope,
                            return_numpy=False)
        if isinstance(out, LoDTensor):
            # the flat valid rows, padded back to the token cap
            enc = out.to_seq_value(pad_to=token_cap).data.numpy()
        else:
            enc = executor._to_numpy(out)
        return enc, np.asarray(lens, np.int32)

    return prefill


class LockstepDecoder(object):
    """The whole-batch baseline over the same decoder weights: the
    generating program's `attention_lstm_beam_decode` op (the whole beam
    search) fed encoder rows. Every request of a batch pays max_len steps;
    the continuous engine must match it token for token.

    place: None means CUDAPlace(0), which raises without a card (the JAX
    class defaults to the CPU); pass fluid.CPUPlace() to run on the
    CPU."""

    def __init__(self, weights, beam_size, max_len, src_cap, start_id=0,
                 end_id=1, place=None):
        from ..fluid import framework
        from ..fluid.executor import Executor, Scope

        self.beam_size = int(beam_size)
        self.max_len = int(max_len)
        self.src_cap = int(src_cap)
        self._scope = Scope()
        self._exe = Executor(place)
        enc_dim = int(np.asarray(weights['w_q']).shape[1])
        prog = framework.Program()
        blk = prog.global_block()
        enc = blk.create_var(name='ls_enc', shape=[-1, self.src_cap, enc_dim],
                             dtype='float32', lod_level=1, is_data=True)
        wvars = {}
        for k in WEIGHT_KEYS:
            a = np.array(weights[k], dtype=np.float32)
            wvars[k] = blk.create_var(name='ls_' + k, shape=list(a.shape),
                                      dtype='float32', persistable=True)
            self._scope.vars['ls_' + k] = torch.from_numpy(a).to(
                self._exe.device)
        ids = blk.create_var(name='ls_sent_ids', shape=None, dtype='int64')
        scores = blk.create_var(name='ls_sent_scores', shape=None,
                                dtype='float32')
        blk.append_op(
            type='attention_lstm_beam_decode',
            inputs={'EncOut': [enc], 'WDec': [wvars['w_dec']],
                    'UDec': [wvars['u_dec']], 'BDec': [wvars['b_dec']],
                    'WAttnQ': [wvars['w_q']], 'WEmb': [wvars['w_emb']],
                    'WOut': [wvars['w_out']], 'BOut': [wvars['b_out']]},
            outputs={'SentenceIds': [ids], 'SentenceScores': [scores]},
            attrs={'beam_size': self.beam_size, 'max_len': self.max_len,
                   'start_id': int(start_id), 'end_id': int(end_id)})
        self._program = prog
        self._fetch = [ids, scores]

    def run(self, enc, src_len):
        """enc [n, S<=src_cap, D] float32, src_len [n] -> (sentence_ids
        [n, beam, max_len] int64, sentence_scores [n, beam] float32)."""
        from ..fluid.lowering import SeqValue
        enc = np.asarray(enc, np.float32)
        if enc.shape[1] < self.src_cap:
            enc = np.pad(enc, ((0, 0), (0, self.src_cap - enc.shape[1]),
                               (0, 0)))
        sv = SeqValue(enc, np.asarray(src_len, np.int64))
        ids, scores = self._exe.run(self._program, feed={'ls_enc': sv},
                                    fetch_list=self._fetch,
                                    scope=self._scope)
        return ids, scores


class _Request(object):
    __slots__ = ('feed', 'limit', 'future', 't_submit', 'deadline',
                 't_join', 'pkey', 'hist_need', 'enc_need', 'on_token',
                 'resume', 'checkpoint', 'ckpt_every', 'aborted')

    def __init__(self, feed, limit, future, t_submit, deadline,
                 pkey=None, hist_need=0, enc_need=0, on_token=None,
                 resume=None, checkpoint=None, ckpt_every=0):
        self.feed = feed
        self.limit = limit
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline
        self.t_join = None
        # paged admission: content key for the prefix cache + the
        # worst-case page claim the admission gate budgets against
        self.pkey = pkey
        self.hist_need = hist_need
        self.enc_need = enc_need
        # streaming: the per-token callback, the checkpoint sink and its
        # cadence, the resume state, and the consumer-gone flag (set from
        # any thread; the loop frees the slot at its next tick)
        self.on_token = on_token
        self.resume = resume
        self.checkpoint = checkpoint
        self.ckpt_every = ckpt_every
        self.aborted = False

    def streams(self):
        """True while the loop must read this slot's tokens every
        dispatch: it streams or checkpoints, and is not aborted."""
        return not self.aborted and (
            self.on_token is not None
            or (self.checkpoint is not None and self.ckpt_every > 0))


# process-wide decode telemetry; per-engine views live in engine.stats /
# stats_window()
_G_SLOTS = obs.gauge('decode.slots.occupied')
_G_QDEPTH = obs.gauge('decode.queue.depth')
_H_STEP = obs.histogram('decode.step.seconds')
_H_TTFT = obs.histogram('decode.ttft.seconds')
_H_REQ_TOKENS = obs.histogram('decode.request.tokens',
                              buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256,
                                       512, 1024))
_C_REQUESTS = obs.counter('decode.requests')
_C_TOKENS = obs.counter('decode.tokens')
_C_JOINS = obs.counter('decode.joins')
_C_RELEASES = obs.counter('decode.releases')
_C_POISONED = obs.counter('decode.poisoned')
_C_SHED = obs.counter('decode.shed')
_C_REJECTED = obs.counter('decode.rejected')
_C_STEPS = obs.counter('decode.steps')
# paged state memory + prefix cache
_G_PAGES_FREE = obs.gauge('decode.pages.free')
_C_PREFIX_HITS = obs.counter('decode.prefix.hits')
_C_PREFIX_MISSES = obs.counter('decode.prefix.misses')
_C_PREFIX_EVICT = obs.counter('decode.prefix.evictions')
_C_SPEC_PROPOSED = obs.counter('decode.spec.proposed')
_C_SPEC_ACCEPTED = obs.counter('decode.spec.accepted')
_C_CANCELLED = obs.counter('decode.cancelled')
_C_RESUMED = obs.counter('decode.resumed')


class DecodeEngine(object):
    """Slot-based continuous-batching front end over one attention-LSTM
    beam decoder (the module docstring has the architecture).

    weights: dict with keys w_dec/u_dec/b_dec/w_q/w_emb/w_out/b_out
    (WEIGHT_KEYS), numpy arrays: the decoder tensors of the JAX package's
    engine (`mt_weights` collects them from a machine_translation scope).

    place: where the slot state and the step run. None means CUDAPlace(0),
    which raises without a card; pass fluid.CPUPlace() to run on the CPU.

    prefill: optional callable(list of request feeds) -> (enc [n, S, D]
    float array with finite padding, src_len [n]), S <= config.src_cap.
    It is called with the batch padded up to a power-of-two bucket of
    config.admit_buckets (the last feed repeated), so it keeps one feed
    signature a bucket; `program_prefill` builds one from an encoder
    Program. Without a prefill, each request carries its encoder rows
    directly: {'enc': [S, D]} with S <= config.src_cap.

    draft: with DecodeConfig(spec_k=K), the speculative draft: a weights
    dict of WEIGHT_KEYS (the target's vocab and encoder width, any hidden
    and embedding size) or a [vocab] int next-token table.

    Requests enter through `submit(feed, max_new_tokens=...)` and resolve
    to (sentence_ids int64 [beam_size, max_new_tokens], sentence_scores
    float32 [beam_size]): the rows the whole-batch LockstepDecoder gives
    at max_len=max_new_tokens for the same encoder rows. `submit` also
    streams (on_token), checkpoints (checkpoint, ckpt_every) and resumes
    (resume); `cancel(future)` aborts a request; `push_rows` writes row
    deltas into the live decoder weights; `export_step_program` saves the
    step Program as an inference artifact.
    """

    def __init__(self, weights, config=None, place=None, prefill=None,
                 draft=None):
        from ..fluid.executor import Executor, Scope

        self.config = config or DecodeConfig()
        self._prefill = prefill
        missing = [k for k in WEIGHT_KEYS if k not in weights]
        if missing:
            raise ValueError('decode weights missing %r (need %r)'
                             % (missing, list(WEIGHT_KEYS)))
        self._scope = Scope()
        self._exe = Executor(place)
        self._hidden = int(np.asarray(weights['u_dec']).shape[0])
        self._enc_dim = int(np.asarray(weights['w_q']).shape[1])
        self._vocab = int(np.asarray(weights['w_out']).shape[1])
        self._draft = self._check_draft(draft)
        # host side of the paged state: the allocator + prefix cache
        # (loop-thread owned) and per-slot page assignments
        cfg = self.config
        self._hist_pool = self._enc_pool = self._prefix = None
        self._slot_pages = [None] * cfg.slots
        self._pages_starved = False
        if cfg.paged:
            self._hist_pool = _pages.PagePool(cfg.pages)
            self._enc_pool = _pages.PagePool(cfg.enc_pages, reserved=1)
            if cfg.prefix_cache:
                self._prefix = _pages.PrefixCache(
                    self._enc_pool, on_evict=self._on_prefix_evict)
        self._build_step_program(weights)
        self._handle = None          # acquired lazily (first step/warmup)
        self._warm = False

        self._lock = threading.Lock()
        self._handle_lock = threading.RLock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._shutdown = False
        self._drain = True
        # slot table: owned by the decode-loop thread only
        self._occupant = [None] * cfg.slots
        self._slot_steps = [0] * cfg.slots
        # cumulative stats (+ the windowed counterparts stats_window()
        # reads and resets)
        self._n = collections.Counter()
        self._win = collections.Counter()
        self._q_high_water = 0

        self._thread = threading.Thread(target=self._loop,
                                        name='decode-loop', daemon=True)
        self._thread.start()

    # -- program build -----------------------------------------------------

    def _check_draft(self, draft):
        """Validate the speculative draft: a weights dict sharing the
        target's vocab and encoder width, or a [vocab] int next-token
        table. Returns ('weights', dict), ('table', int32 array) or
        None."""
        cfg = self.config
        if not cfg.spec_k:
            if draft is not None:
                raise ValueError('draft= needs DecodeConfig(spec_k=K)')
            return None
        if draft is None:
            raise ValueError('DecodeConfig(spec_k=%d) needs a draft: '
                             'DecodeEngine(draft=weights dict or [vocab]'
                             ' next-token table)' % cfg.spec_k)
        if isinstance(draft, dict):
            missing = [k for k in WEIGHT_KEYS if k not in draft]
            if missing:
                raise ValueError('draft weights missing %r' % (missing,))
            d_enc = int(np.asarray(draft['w_q']).shape[1])
            d_vocab = int(np.asarray(draft['w_out']).shape[1])
            if d_enc != self._enc_dim or d_vocab != self._vocab:
                raise ValueError(
                    'draft must share the target vocab (%d) and enc_dim '
                    '(%d); got vocab=%d enc_dim=%d'
                    % (self._vocab, self._enc_dim, d_vocab, d_enc))
            return ('weights', draft)
        table = np.asarray(draft)
        if table.ndim != 1 or table.shape[0] != self._vocab \
                or not np.issubdtype(table.dtype, np.integer):
            raise ValueError(
                'a table draft must be a [vocab=%d] int next-token '
                'array, got %r %r' % (self._vocab, table.dtype,
                                      table.shape))
        return ('table', table.astype(np.int32))

    def _draft_hidden(self):
        """The weights draft's LSTM width, or None."""
        if self._draft and self._draft[0] == 'weights':
            return int(np.asarray(self._draft[1]['u_dec']).shape[0])
        return None

    def _on_prefix_evict(self, key, pages):
        _C_PREFIX_EVICT.inc()
        obs.event('decode.prefix.evict', key=key[:12], pages=len(pages))

    def _build_step_program(self, weights):
        """The step-form decode Program: one decode-step op over
        persistable slot state + the decoder weights (and the draft's),
        their values put in the engine's scope on the executor's
        device."""
        from ..fluid import core, framework

        cfg = self.config
        dev = self._exe.device
        prog = framework.Program()
        blk = prog.global_block()
        C, K, T, S = cfg.slots, cfg.beam_size, cfg.max_len, cfg.src_cap
        H, D = self._hidden, self._enc_dim
        ps, NPH, NPE = (cfg.page_size, cfg.hist_table_width,
                        cfg.enc_table_width)

        def pvar(name, shape, dtype, init):
            v = blk.create_var(name='cbd_' + name, shape=shape,
                               dtype=dtype, persistable=True)
            self._scope.vars['cbd_' + name] = init.to(dev)
            return v

        def weight_vars(prefix, ws):
            out = {}
            for k in WEIGHT_KEYS:
                a = np.array(ws[k], dtype=np.float32)
                out[k] = pvar(prefix + k, list(a.shape), 'float32',
                              torch.from_numpy(a))
            return out

        wvars = weight_vars('', weights)

        spec = {'h': ([C, K, H], 'float32'), 'c': ([C, K, H], 'float32'),
                'prev_ids': ([C, K], 'int32'), 'acc': ([C, K], 'float32'),
                'fin': ([C, K], 'bool'),
                'step': ([C], 'int32'), 'limit': ([C], 'int32'),
                'active': ([C], 'bool')}
        if cfg.paged:
            # pools + per-slot page tables: a slot only claims the pages
            # its OWN limit and source length need. pt_hist defaults to
            # the out-of-range page (writes drop), pt_enc to the reserved
            # zero page (reads stay finite under the mask).
            spec.update({
                'hist_ids': ([cfg.pages, ps, K], 'int32'),
                'hist_par': ([cfg.pages, ps, K], 'int32'),
                'enc_pages': ([cfg.enc_pages, ps, D], 'float32'),
                'mask_pages': ([cfg.enc_pages, ps], 'float32'),
                'pt_hist': ([C, NPH], 'int32'),
                'pt_enc': ([C, NPE], 'int32')})
        else:
            spec.update({
                'enc': ([C, S, D], 'float32'), 'mask': ([C, S], 'float32'),
                'ids_hist': ([C, T, K], 'int32'),
                'par_hist': ([C, T, K], 'int32')})
        Hd = self._draft_hidden()
        if Hd is not None:
            spec.update({'draft_h': ([C, Hd], 'float32'),
                         'draft_c': ([C, Hd], 'float32')})
        svars = {}
        for name, (shape, dtype) in spec.items():
            fill = cfg.pages if name == 'pt_hist' else 0
            svars[name] = pvar(name, shape, dtype, torch.full(
                shape, fill, dtype=core.torch_dtype(dtype)))
        done = blk.create_var(name='cbd_done', shape=[C], dtype='bool')
        bad = blk.create_var(name='cbd_bad', shape=[C], dtype='bool')

        def weight_ins(prefix, vs):
            return {prefix + 'WDec': [vs['w_dec']],
                    prefix + 'UDec': [vs['u_dec']],
                    prefix + 'BDec': [vs['b_dec']],
                    prefix + 'WAttnQ': [vs['w_q']],
                    prefix + 'WEmb': [vs['w_emb']],
                    prefix + 'WOut': [vs['w_out']],
                    prefix + 'BOut': [vs['b_out']]}

        ins = weight_ins('', wvars)
        ins.update({
               'H': [svars['h']], 'C': [svars['c']],
               'PrevIds': [svars['prev_ids']], 'Acc': [svars['acc']],
               'Fin': [svars['fin']], 'Step': [svars['step']],
               'Limit': [svars['limit']], 'Active': [svars['active']]})
        outs = {'HOut': [svars['h']], 'COut': [svars['c']],
                'PrevIdsOut': [svars['prev_ids']], 'AccOut': [svars['acc']],
                'FinOut': [svars['fin']], 'StepOut': [svars['step']],
                'ActiveOut': [svars['active']],
                'Done': [done], 'Bad': [bad]}
        if cfg.paged:
            ins.update({
                'PtHist': [svars['pt_hist']], 'PtEnc': [svars['pt_enc']],
                'HistIds': [svars['hist_ids']],
                'HistPar': [svars['hist_par']],
                'EncPages': [svars['enc_pages']],
                'MaskPages': [svars['mask_pages']]})
            outs.update({'HistIdsOut': [svars['hist_ids']],
                         'HistParOut': [svars['hist_par']]})
        else:
            ins.update({
                'Enc': [svars['enc']], 'Mask': [svars['mask']],
                'IdsHist': [svars['ids_hist']],
                'ParHist': [svars['par_hist']]})
            outs.update({'IdsHistOut': [svars['ids_hist']],
                         'ParHistOut': [svars['par_hist']]})
        if cfg.spec_k:
            accepted = blk.create_var(name='cbd_accepted', shape=[C],
                                      dtype='int32')
            outs['Accepted'] = [accepted]
            if self._draft[0] == 'weights':
                ins.update(weight_ins('Draft', weight_vars(
                    'd_', self._draft[1])))
                ins.update({'DraftH': [svars['draft_h']],
                            'DraftC': [svars['draft_c']]})
                outs.update({'DraftHOut': [svars['draft_h']],
                             'DraftCOut': [svars['draft_c']]})
            else:
                ins['DraftTable'] = [pvar(
                    'd_table', [self._vocab], 'int32',
                    torch.from_numpy(self._draft[1]))]
            blk.append_op(
                type='attention_lstm_spec_decode_step', inputs=ins,
                outputs=outs,
                attrs={'end_id': cfg.end_id, 'spec_k': cfg.spec_k,
                       'page_size': ps, 'src_cap': S,
                       'draft': self._draft[0]})
        else:
            attrs = {'beam_size': cfg.beam_size, 'end_id': cfg.end_id,
                     'bundle': cfg.bundle}
            if cfg.paged:
                attrs.update(page_size=ps, src_cap=S)
            blk.append_op(
                type='attention_lstm_beam_paged_step' if cfg.paged
                else 'attention_lstm_beam_decode_step',
                inputs=ins, outputs=outs, attrs=attrs)
        self._step_program = prog
        # the step fetches the state a release reads, so a release is a
        # numpy slice of one host copy. Releases are LEVEL-triggered off
        # Active (occupied slot now inactive; poisoning detected from NaN
        # in the fetched scores), not off the per-dispatch Done edge: an
        # extra dispatch (warmup's no-op step racing live traffic) can
        # swallow an edge, but a level cannot be lost.
        ids_n, par_n = ('hist_ids', 'hist_par') if cfg.paged \
            else ('ids_hist', 'par_hist')
        self._fetch_vars = [svars['active'], svars[ids_n], svars[par_n],
                            svars['acc'], svars['step']]
        if cfg.spec_k:
            self._fetch_vars.append(accepted)
        self._state_spec = spec

    def _scatter_join(self, slot_idx, enc, mask, limit, pt_hist_rows=None,
                      pt_enc_rows=None, enc_write_pages=None):
        """Write the joining requests' slot state into the handle's
        tensors, in place: host arrays with one row per request, each to
        its own free slot. Paged form: the slots' page-table rows, and the
        encoder content of the freshly claimed pages; write-page entries
        past the pool (prefix hits, duplicates in the batch, tails on the
        zero page) are dropped, so resident pages are never rewritten.
        Serialized with the step under _handle_lock."""
        cfg = self.config
        n = len(slot_idx)
        K, H = cfg.beam_size, self._hidden
        dev = self._exe.device
        acc0 = np.full((n, K), np.finfo(np.float32).min, np.float32)
        acc0[:, 0] = 0.0
        rows = {
            'h': np.zeros((n, K, H), np.float32),
            'c': np.zeros((n, K, H), np.float32),
            'prev_ids': np.full((n, K), cfg.start_id, np.int32),
            'acc': acc0, 'fin': np.zeros((n, K), bool),
            'step': np.zeros(n, np.int32),
            'limit': np.asarray(limit, np.int32),
            'active': np.ones(n, bool)}
        Hd = self._draft_hidden()
        if Hd is not None:
            rows['draft_h'] = np.zeros((n, Hd), np.float32)
            rows['draft_c'] = np.zeros((n, Hd), np.float32)
        pages = None
        if cfg.paged:
            rows['pt_hist'] = np.asarray(pt_hist_rows, np.int32)
            rows['pt_enc'] = np.asarray(pt_enc_rows, np.int32)
            ps, NPE = cfg.page_size, cfg.enc_table_width
            wr = np.asarray(enc_write_pages, np.int64).reshape(-1)
            keep = wr < cfg.enc_pages
            if keep.any():
                pages = (wr[keep], enc.reshape(n * NPE, ps, -1)[keep],
                         mask.reshape(n * NPE, ps)[keep])
        else:
            rows['enc'] = enc
            rows['mask'] = mask
        handle = self._acquire()
        with self._handle_lock, torch.no_grad():
            st = handle.state

            def put(name, idx, values):
                t = st['cbd_' + name]
                t.index_copy_(0, idx, torch.from_numpy(values).to(
                    device=dev, dtype=t.dtype))

            idx = torch.from_numpy(np.asarray(slot_idx, np.int64)).to(dev)
            for name, values in rows.items():
                put(name, idx, values)
            if pages is not None:
                pidx = torch.from_numpy(pages[0]).to(dev)
                put('enc_pages', pidx, pages[1])
                put('mask_pages', pidx, pages[2])

    def _acquire(self):
        # RLock: warmup() runs on the caller thread while the decode loop
        # may be admitting/stepping
        with self._handle_lock:
            if self._handle is None:
                self._handle = self._exe.acquire_step(
                    self._step_program, fetch_list=self._fetch_vars,
                    scope=self._scope)
            return self._handle

    def export_step_program(self, dirname):
        """Save the step-form decode Program with its weight and state
        persistables as an ordinary inference artifact (io.
        save_inference_model's `__model__.json` and `__params__.npz`, the
        JAX package's format). Returns dirname."""
        from ..fluid import io
        # _handle_lock: not in the middle of a dispatch or a join
        with self._handle_lock:
            self._acquire()
            io.save_inference_model(dirname, [], list(self._fetch_vars),
                                    self._exe,
                                    main_program=self._step_program,
                                    scope=self._scope)
        return dirname

    def push_rows(self, deltas):
        """Write trained row deltas into this replica's LIVE decoder
        weights between dispatches (the streaming train->serve freshness
        path on the continuous-batching engine). `deltas` maps a step
        Program persistable name to `(row_ids, rows)`. Returns rows
        applied.

        Only the persistables the step only READS take deltas (the
        decoder weights, and the page tables and pools the join writes);
        the state the step writes (slot carries, histories) raises
        DeltaUnsupported, and a name the step does not have KeyError.
        Every delta is validated before any row is written. The rows are
        written in place (index_copy_ into the tensors the step reads: on
        the card the captured graph's static tensors), under the handle
        lock every dispatch and join holds and on the stream the replays
        run on, so a dispatch sees every table whole before the push or
        whole after it, and nothing is captured again."""
        from .engine import DeltaUnsupported, _validate_delta
        if self._shutdown:
            raise ServerClosed('decode engine is shut down')
        applied = 0
        handle = self._acquire()
        staged = []
        for name in sorted(deltas):
            ids, rows = deltas[name]
            if name in handle._donated:
                raise DeltaUnsupported(
                    'push_rows: %r is donated per-step decode state '
                    '(slot pool), not a weight — row deltas apply only to '
                    'the read-only set %r'
                    % (name, sorted(handle._readonly)))
            w = handle._readonly.get(name)
            if w is None:
                raise KeyError(
                    'push_rows: no read-only persistable %r in the decode '
                    'step (have %r)' % (name, sorted(handle._readonly)))
            ids, rows = _validate_delta(name, w, ids, rows)
            staged.append((name, self._staged(ids), self._staged(rows)))
            applied += int(ids.shape[0])
        with self._handle_lock, torch.no_grad():
            for name, idx, src in staged:
                # the scope's tensor, read under the lock: the one the
                # next dispatch reads
                w = self._scope._chain_get(name)
                w.index_copy_(0, idx, src.to(w.dtype))
            self._n['delta_pushes'] += 1
            self._n['delta_rows'] += applied
        return applied

    def _staged(self, a):
        """A host array as a tensor on the engine's device: on the card
        through pinned memory without waiting for the card (the copy is
        ordered before the writes that read it)."""
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
        if self._exe.device.type == 'cuda':
            return t.pin_memory().to(self._exe.device, non_blocking=True)
        return t

    # -- admission ---------------------------------------------------------

    def submit(self, feed, max_new_tokens=None, deadline_ms=None,
               timeout=None, on_token=None, resume=None, checkpoint=None,
               ckpt_every=0):
        """Enqueue one decode request; returns a Future resolving to
        (sentence_ids [beam, max_new_tokens] int64, sentence_scores [beam]
        float32). Raises ServerClosed after shutdown, ServerOverloaded
        under the 'reject' policy (or a 'block' admission timeout), and
        ValueError for malformed feeds. A deadline sheds the request with
        DeadlineExceeded if it is still QUEUED when it passes.

        Streaming: `on_token(t, ids)` is called from the decode loop for
        every generated token, t = 1.., ids the [beam_size] raw beam
        column of that step (the result is still the backtraced
        history). A callback that RAISES marks the consumer gone: the
        slot is aborted, its pages return to the pool and the future
        fails StreamCancelled. `checkpoint(state)` is called every
        `ckpt_every` tokens with a dict that `resume=` takes as it is;
        `resume` overwrites the slot's state right after its join, so
        generation continues token-exact from state['step'] (a resume at
        max_new_tokens resolves at once from the checkpoint's history).
        Resume writes in place like push_rows: it captures nothing."""
        cfg = self.config
        limit = cfg.max_len if max_new_tokens is None else int(max_new_tokens)
        if not 1 <= limit <= cfg.max_len:
            raise ValueError(
                'max_new_tokens=%d out of range [1, %d] (the slot token '
                'buffer is fixed at engine build)' % (limit, cfg.max_len))
        ckpt_every = int(ckpt_every or 0)
        if on_token is not None and not callable(on_token):
            raise ValueError('on_token must be callable, got %r'
                             % (on_token,))
        if checkpoint is not None and not callable(checkpoint):
            raise ValueError('checkpoint must be callable, got %r'
                             % (checkpoint,))
        if resume is not None:
            resume = {k: np.asarray(v) for k, v in dict(resume).items()}
            need = ('h', 'c', 'prev_ids', 'acc', 'fin', 'step', 'ids',
                    'par')
            missing = [k for k in need if k not in resume]
            if missing:
                raise ValueError('resume state missing %r (need %r)'
                                 % (missing, list(need)))
            t_res = int(resume['step'])
            K = cfg.beam_size
            if not 0 <= t_res <= limit:
                raise ValueError(
                    'resume step=%d out of range [0, max_new_tokens=%d]'
                    % (t_res, limit))
            if tuple(resume['ids'].shape) != (t_res, K) \
                    or tuple(resume['par'].shape) != (t_res, K):
                raise ValueError(
                    'resume ids/par must be [%d, %d] (step x beam), got '
                    '%r / %r' % (t_res, K, tuple(resume['ids'].shape),
                                 tuple(resume['par'].shape)))
            if t_res >= limit:
                # nothing left to generate: the checkpoint already holds
                # the whole history; resolve without taking a slot
                from ..fluid.ops_impl.lod_beam import backtrace_beams
                toks = backtrace_beams(resume['ids'].astype(np.int32),
                                       resume['par'].astype(np.int32))
                fut = concurrent.futures.Future()
                fut.set_running_or_notify_cancel()
                fut.set_result((toks.astype(np.int64),
                                resume['acc'].astype(np.float32)))
                return fut
        if self._prefill is None:
            if 'enc' not in feed:
                raise ValueError(
                    "an engine without a prefill takes encoder rows "
                    "directly: feed must carry 'enc' (got %r)"
                    % sorted(feed))
            enc = np.asarray(feed['enc'], np.float32)
            if enc.ndim != 2 or not 1 <= enc.shape[0] <= cfg.src_cap \
                    or enc.shape[1] != self._enc_dim:
                raise ValueError(
                    "feed['enc'] must be [1<=S<=%d, %d], got %r"
                    % (cfg.src_cap, self._enc_dim, enc.shape))
            feed = {'enc': enc}
        if deadline_ms is None:
            deadline_ms = cfg.default_deadline_ms
        now = time.monotonic()
        deadline = now + deadline_ms / 1000.0 if deadline_ms is not None \
            else None
        pkey, hist_need, enc_need = None, 0, 0
        if cfg.paged:
            hist_need = _pages.pages_for(limit, cfg.page_size)
            if self._prefill is None:
                enc_need = _pages.pages_for(feed['enc'].shape[0],
                                            cfg.page_size)
            else:
                # the source length is known only after the prefill: the
                # admission gate budgets the worst case, and the claim
                # after the prefill takes what the source needs
                enc_need = cfg.enc_table_width
            if cfg.prefix_cache:
                pkey = _pages.content_key(feed)
        fut = concurrent.futures.Future()
        req = _Request(feed, limit, fut, now, deadline, pkey=pkey,
                       hist_need=hist_need, enc_need=enc_need,
                       on_token=on_token, resume=resume,
                       checkpoint=checkpoint, ckpt_every=ckpt_every)
        t_give_up = now + timeout if timeout is not None else None
        with self._lock:
            while True:
                if self._shutdown:
                    raise ServerClosed('decode engine is shut down')
                if len(self._queue) < cfg.queue_capacity:
                    break
                # the queue can be full because joins are blocked on an
                # exhausted page pool: the reject event says which wall
                reason = 'pages' if self._pages_starved else 'queue'
                if cfg.overflow == 'reject':
                    self._reject_locked(reason)
                    raise ServerOverloaded(
                        'decode queue is full (%d request(s), capacity '
                        '%d; blocked on %s) and the overflow policy is '
                        'reject' % (len(self._queue), cfg.queue_capacity,
                                    'free pages' if reason == 'pages'
                                    else 'free slots'))
                remaining = _POLL_S if t_give_up is None else \
                    min(_POLL_S, t_give_up - time.monotonic())
                if t_give_up is not None and remaining <= 0:
                    self._reject_locked(reason, waited_s=timeout)
                    raise ServerOverloaded(
                        'decode queue stayed full for %.3fs (capacity %d)'
                        % (timeout, cfg.queue_capacity))
                self._not_full.wait(remaining)
            self._queue.append(req)
            self._n['submitted'] += 1
            self._win['submitted'] += 1
            depth = len(self._queue)
            self._q_high_water = max(self._q_high_water, depth)
            self._win['queue_high_water'] = max(
                self._win['queue_high_water'], depth)
            _C_REQUESTS.inc()
            _G_QDEPTH.set(depth)
            self._not_empty.notify()
        return fut

    def _reject_locked(self, reason, **fields):
        self._n['rejected'] += 1
        self._win['rejected'] += 1
        _C_REJECTED.inc()
        obs.event('decode.reject', queue_depth=len(self._queue),
                  capacity=self.config.queue_capacity, reason=reason,
                  **fields)

    def predict(self, feed, max_new_tokens=None, deadline_ms=None,
                timeout=None):
        """Synchronous convenience: submit + wait, one wall-clock budget
        for admission and result."""
        t0 = time.monotonic()
        fut = self.submit(feed, max_new_tokens=max_new_tokens,
                          deadline_ms=deadline_ms, timeout=timeout)
        remaining = None if timeout is None else \
            max(0.0, timeout - (time.monotonic() - t0))
        try:
            return fut.result(remaining)
        except concurrent.futures.TimeoutError:
            if fut.done():
                return fut.result()
            if fut.cancel():
                raise DeadlineExceeded(
                    'no result within the %.3fs predict() timeout; the '
                    'queued decode request was cancelled' % timeout)
            raise DeadlineExceeded(
                'no result within the %.3fs predict() timeout; the '
                'sequence is already decoding — it completes but the '
                'result is discarded' % timeout)

    def cancel(self, future):
        """Best-effort cancel of one submitted request by its future (the
        mid-stream-disconnect path). A still-QUEUED request fails
        StreamCancelled at once; one already decoding has its slot
        aborted at the next loop tick, the slot AND its pages back in the
        pool. Returns True if the request was found, False if it already
        completed or was never this engine's."""
        with self._lock:
            found = None
            for i, r in enumerate(self._queue):
                if r.future is future:
                    found = r
                    del self._queue[i]
                    _G_QDEPTH.set(len(self._queue))
                    self._not_full.notify()
                    break
        if found is not None:
            if found.future.set_running_or_notify_cancel():
                found.future.set_exception(StreamCancelled(
                    'decode request cancelled while queued'))
            return True
        for occ in list(self._occupant):
            if occ is not None and occ.future is future:
                occ.aborted = True
                return True
        return False

    # -- warmup ------------------------------------------------------------

    def warmup(self, example_feed=None):
        """Run the step twice with every slot inactive (no-op steps) and,
        with a prefill, the prefill twice at each admission bucket on
        copies of `example_feed` (any one request feed): on the card that
        warms each signature up (kernel build, first-use costs) and
        captures its CUDA graph before any request. Returns the bucket
        list."""
        cfg = self.config
        if self._prefill is not None and example_feed is None:
            raise ValueError(
                'warmup() needs example_feed when the engine owns a '
                'prefill (it cannot make model inputs up)')
        handle = self._acquire()
        with self._handle_lock:
            for _ in range(WARMUP_RUNS):
                handle.step()
        if self._prefill is not None:
            for b in cfg.admit_buckets:
                for _ in range(WARMUP_RUNS):
                    self._prefill([dict(example_feed)] * b)
        self._warm = True
        return list(cfg.admit_buckets)

    # -- decode loop -------------------------------------------------------

    def _pop_live_locked(self, now, shed, cap):
        """Pop up to `cap` still-wanted requests; expired ones collect
        into `shed` (failed by the caller OUTSIDE the lock). In paged mode
        a head whose page claim cannot be covered RIGHT NOW (free +
        evictable) BLOCKS in the queue, FIFO, and the engine marks itself
        page-starved for the reject events' reason field."""
        out = []
        budget = None
        pinned = set()
        if self.config.paged:
            budget = {'hist': self._hist_pool.available(),
                      'enc': self._enc_pool.available(self._prefix)}
        starved = False
        while self._queue and len(out) < cap:
            req = self._queue[0]
            if req.deadline is not None and now > req.deadline:
                self._queue.popleft()
                self._not_full.notify()
                shed.append(req)
                continue
            if budget is not None:
                enc_need = req.enc_need
                if req.pkey is not None and self._prefix.peek(req.pkey):
                    # resident prefix: no NEW pages, but the hit PINS the
                    # entry, taking its pages out of the evictable budget
                    # batch-mates were counting on; charge that once per
                    # key
                    enc_need = 0 if req.pkey in pinned \
                        else self._prefix.pinnable_pages(req.pkey)
                if req.hist_need > budget['hist'] \
                        or enc_need > budget['enc']:
                    starved = True        # head-of-line blocks on pages
                    break
                budget['hist'] -= req.hist_need
                budget['enc'] -= enc_need
                if req.pkey is not None:
                    pinned.add(req.pkey)
            self._queue.popleft()
            self._not_full.notify()
            if not req.future.set_running_or_notify_cancel():
                continue              # cancelled while queued
            out.append(req)
        self._pages_starved = starved
        _G_QDEPTH.set(len(self._queue))
        return out

    def _fail_shed(self, shed):
        now = time.monotonic()
        for req in shed:
            if not req.future.set_running_or_notify_cancel():
                continue
            with self._lock:   # _win races stats_window's copy+reset
                self._n['shed'] += 1
                self._win['shed'] += 1
            _C_SHED.inc()
            waited = now - req.t_submit
            obs.event('decode.shed', waited_s=waited)
            req.future.set_exception(DeadlineExceeded(
                'decode request shed after waiting %.3fs: its deadline '
                'passed before a slot opened' % waited))

    def _encode(self, reqs):
        """(enc [m, S, D] float32, src_len [m] int32) of the requests: one
        prefill batch padded to its admission bucket (the last feed
        repeated), checked for a malformed return, or the feeds' own rows
        without a prefill."""
        cfg = self.config
        m = len(reqs)
        if self._prefill is None:
            src_len = np.asarray([r.feed['enc'].shape[0] for r in reqs],
                                 np.int32)
            enc = np.zeros((m, int(src_len.max()), self._enc_dim),
                           np.float32)
            for j, r in enumerate(reqs):
                enc[j, :src_len[j]] = r.feed['enc']
            return enc, src_len
        b = _buckets.pick_bucket(m, cfg.admit_buckets)
        feeds = [r.feed for r in reqs] + [reqs[-1].feed] * (b - m)
        enc, src_len = self._prefill(feeds)
        enc = np.asarray(enc, np.float32)[:m]
        src_len = np.asarray(src_len, np.int32)[:m]
        # a short or misshapen prefill return fails here, not silently
        # broadcast into the batch assembly
        if enc.ndim != 3 or enc.shape[0] != m:
            raise ValueError(
                'prefill returned enc of shape %r for %d request(s) (want '
                '[n, S, %d])' % (getattr(enc, 'shape', None), m,
                                 self._enc_dim))
        if src_len.shape != (m,):
            raise ValueError('prefill returned src_len of shape %r for %d '
                             'request(s)' % (src_len.shape, m))
        if enc.shape[1] > cfg.src_cap:
            raise ValueError('prefill returned %d encoder rows > src_cap=%d'
                             % (enc.shape[1], cfg.src_cap))
        return enc, src_len

    @staticmethod
    def _fail_joins(joins, e):
        """A prefill or feed fault: only the joining futures fail."""
        for r in joins:
            if not r.future.done():
                r.future.set_exception(e)
        obs.event('decode.prefill.error', requests=len(joins),
                  error='%s: %s' % (type(e).__name__, e))

    def _admit(self, joins):
        """Prefill the joining requests and write their slot state in one
        join (loop thread only). A prefill or feed failure fails only the
        joining futures."""
        if self.config.paged:
            return self._admit_paged(joins)
        cfg = self.config
        n = len(joins)
        try:
            enc_m, src_len = self._encode(joins)
            enc = np.zeros((n, cfg.src_cap, self._enc_dim), np.float32)
            enc[:, :enc_m.shape[1]] = enc_m
            mask = (np.arange(cfg.src_cap)[None, :]
                    < src_len[:, None]).astype(np.float32)
        except Exception as e:  # noqa: BLE001 - the joiners' futures own it
            self._fail_joins(joins, e)
            return
        free = [i for i, occ in enumerate(self._occupant) if occ is None]
        self._scatter_join(free[:n], enc, mask, [r.limit for r in joins])
        now = time.monotonic()
        for i, req in enumerate(joins):
            slot = free[i]
            self._occupant[slot] = req
            self._slot_steps[slot] = 0
            req.t_join = now
            if req.resume is not None:
                self._apply_resume(slot, req)
            with self._lock:
                self._n['joins'] += 1
                self._win['joins'] += 1
            _C_JOINS.inc()
            obs.event('decode.join', slot=slot, limit=req.limit,
                      src_len=int(src_len[i]))
        self._note_occupancy()

    def _note_occupancy(self):
        occ_now = sum(o is not None for o in self._occupant)
        _G_SLOTS.set(occ_now)
        with self._lock:
            self._n['slots_high_water'] = max(
                self._n['slots_high_water'], occ_now)

    def _admit_paged(self, joins):
        """Paged admission (loop thread only): prefix-cache lookups first
        (so a resident entry a batch-mate relies on cannot be evicted by
        this batch's own allocations), then the prefill for the misses
        only (a prefix hit joins without one), then page claims for the
        misses and every request's history, then one join writing page
        tables + fresh page content. The admission gate
        (_pop_live_locked) budgeted the worst case, so the claims cannot
        fail; a prefill or feed failure rolls every claim back and fails
        only the joining futures."""
        cfg = self.config
        ps, NPE, NPH = (cfg.page_size, cfg.enc_table_width,
                        cfg.hist_table_width)
        S_pad = NPE * ps
        n = len(joins)
        # enc plan per join: ('hit', pages, src_len) | ('miss', j), j its
        # row of the prefill batch | ('dup', i_first), a batch-mate's miss
        # with the same content
        plan = [None] * n
        first_by_key = {}
        miss_idx = []
        for i, r in enumerate(joins):
            if r.pkey is not None and self._prefix.peek(r.pkey):
                plan[i] = ('hit',) + tuple(self._prefix.lookup(r.pkey))
                continue
            if r.pkey is not None and r.pkey in first_by_key:
                plan[i] = ('dup', first_by_key[r.pkey])
                continue
            if r.pkey is not None:
                first_by_key[r.pkey] = i
                self._prefix.misses += 1   # cache-level miss
            plan[i] = ('miss', len(miss_idx))
            miss_idx.append(i)
        claimed_enc, claimed_hist = [], []    # the rollback ledger
        try:
            if miss_idx:
                enc_m, len_m = self._encode([joins[i] for i in miss_idx])
            # page claims (cache insertion waits until the content is
            # written)
            miss_pages = []
            for j in range(len(miss_idx)):
                need = _pages.pages_for(int(len_m[j]), ps)
                pages = self._enc_pool.alloc(need, self._prefix)
                if pages is None:
                    raise RuntimeError(
                        'encoder page pool exhausted mid-admit (%d needed, '
                        '%d free)' % (need, self._enc_pool.free_count))
                miss_pages.append(pages)
                claimed_enc.append(pages)
            hist_pages = []
            for r in joins:
                pages = self._hist_pool.alloc(r.hist_need)
                if pages is None:
                    raise RuntimeError(
                        'history page pool exhausted mid-admit (%d needed, '
                        '%d free)' % (r.hist_need,
                                      self._hist_pool.free_count))
                hist_pages.append(pages)
                claimed_hist.append(pages)
            # the join arrays, one row per joining request
            enc = np.zeros((n, S_pad, self._enc_dim), np.float32)
            mask = np.zeros((n, S_pad), np.float32)
            pt_hist = np.full((n, NPH), cfg.pages, np.int32)
            pt_enc = np.zeros((n, NPE), np.int32)        # tail: zero page
            wr_enc = np.full((n, NPE), cfg.enc_pages, np.int32)
            src_len = np.zeros(n, np.int32)
            enc_pages_of = [None] * n
            for i, r in enumerate(joins):
                kind = plan[i][0]
                if kind == 'hit':
                    pages, s_len = plan[i][1], plan[i][2]
                else:
                    j = plan[i][1] if kind == 'miss' \
                        else plan[plan[i][1]][1]
                    pages, s_len = miss_pages[j], int(len_m[j])
                if kind == 'miss':
                    enc[i, :enc_m.shape[1]] = enc_m[j]
                    mask[i, :cfg.src_cap] = np.arange(cfg.src_cap) < s_len
                    wr_enc[i, :len(pages)] = pages
                src_len[i] = s_len
                enc_pages_of[i] = pages
                pt_enc[i, :len(pages)] = pages
                pt_hist[i, :len(hist_pages[i])] = hist_pages[i]
        except Exception as e:  # noqa: BLE001 - the joiners' futures own it
            for pages in claimed_enc:
                self._enc_pool.release(pages)
            for pages in claimed_hist:
                self._hist_pool.release(pages)
            for i, r in enumerate(joins):
                if plan[i][0] == 'hit':
                    self._prefix.unref(r.pkey)
            self._fail_joins(joins, e)
            return
        free = [i for i, occ in enumerate(self._occupant) if occ is None]
        self._scatter_join(free[:n], enc, mask, [r.limit for r in joins],
                           pt_hist, pt_enc, wr_enc)
        # the pages now hold real content: make the miss entries resident
        # (refs = every user in this batch, the first writer plus its
        # dups), so a half-written prefix can never be hit
        for j, i in enumerate(miss_idx):
            key = joins[i].pkey
            if key is not None:
                users = 1 + sum(1 for p in plan
                                if p[0] == 'dup' and p[1] == i)
                self._prefix.insert(key, miss_pages[j], int(len_m[j]),
                                    refs=users)
        now = time.monotonic()
        pages_free = self._pages_free()
        _G_PAGES_FREE.set(pages_free)
        for i, req in enumerate(joins):
            slot = free[i]
            self._occupant[slot] = req
            self._slot_steps[slot] = 0
            hit = plan[i][0] != 'miss'
            self._slot_pages[slot] = {
                'hist': hist_pages[i], 'enc': enc_pages_of[i],
                'pkey': req.pkey}
            req.t_join = now
            if req.resume is not None:
                self._apply_resume(slot, req)
            with self._lock:
                self._n['joins'] += 1
                self._win['joins'] += 1
                key = 'prefix_hits' if hit else 'prefix_misses'
                self._n[key] += 1
                self._win[key] += 1
            _C_JOINS.inc()
            (_C_PREFIX_HITS if hit else _C_PREFIX_MISSES).inc()
            obs.event('decode.join', slot=slot, limit=req.limit,
                      src_len=int(src_len[i]), prefix_hit=hit,
                      pages_hist=len(hist_pages[i]),
                      pages_enc=len(enc_pages_of[i]),
                      pages_free=pages_free)
        self._note_occupancy()

    def _pages_free(self):
        return self._hist_pool.free_count + self._enc_pool.free_count

    def _state(self, name):
        """The slot-state tensor `cbd_<name>` the next dispatch reads (the
        scope's; on the card the captured graph's static tensor)."""
        return self._scope._chain_get('cbd_' + name)

    def _apply_resume(self, slot, req):
        """Overwrite one JUST-JOINED slot's rows with checkpointed state
        (the decode-stream failover resume; loop thread only). The join
        already installed the encoder rows or page tables from the
        request's feed; this restores the generation state on top: carry,
        previous beam ids, scores, finish flags, step counter, the draft's
        carry where there is one, and the token history written into the
        slot's history buffer or its freshly claimed pages. Every write
        is in place under the handle lock, so nothing is captured
        again."""
        cfg = self.config
        st = req.resume
        t = int(st['step'])
        K = cfg.beam_size
        ids = np.asarray(st['ids'], np.int32).reshape(t, K)
        par = np.asarray(st['par'], np.int32).reshape(t, K)
        with self._handle_lock, torch.no_grad():
            self._acquire()

            def put_row(name, rows):
                row = self._state(name)[slot]
                row.copy_(self._staged(rows).reshape(row.shape))

            for name in ('h', 'c', 'prev_ids', 'acc', 'fin'):
                put_row(name, st[name])
            for name in _DRAFT_STATE:
                if name in st and self._state(name) is not None:
                    put_row(name, st[name])
            self._state('step')[slot] = t
            if cfg.paged:
                pages = self._slot_pages[slot]['hist']
                ps = cfg.page_size
                idx = self._staged(np.asarray(pages, np.int64))
                for pool, content in (('hist_ids', ids), ('hist_par', par)):
                    rows = np.zeros((len(pages) * ps, K), np.int32)
                    rows[:t] = content
                    self._state(pool).index_copy_(0, idx, self._staged(
                        rows.reshape(len(pages), ps, K)))
            elif t:
                for hist, content in (('ids_hist', ids), ('par_hist', par)):
                    self._state(hist)[slot, :t] = self._staged(content)
        self._slot_steps[slot] = t
        with self._lock:
            self._n['resumed'] += 1
            self._win['resumed'] += 1
        _C_RESUMED.inc()
        obs.event('decode.resume', slot=slot, step=t, limit=req.limit)

    def _ckpt_parts(self, slots):
        """The state rows a checkpoint of each of `slots` needs, read
        after this dispatch's step: [(slot, name, int32 tensor)] (float
        rows bit-cast, bool rows widened), to join the dispatch's one host
        copy."""
        names = _CKPT_ROWS + tuple(n for n in _DRAFT_STATE
                                   if self._state(n) is not None)
        out = []
        for slot in slots:
            for name in names:
                row = self._state(name)[slot]
                if row.dtype == torch.float32:
                    row = row.contiguous().view(torch.int32)
                else:
                    row = row.to(torch.int32)
                out.append((slot, name, row))
        return out

    def _snapshot_slot(self, slot, t, ids_np, par_np, acc_np, rows):
        """One slot's decode state at token `t`: exactly the dict
        `submit(resume=...)` restores, with the JAX engine's keys, shapes
        and dtypes (step int32, ids and par int32 [t, K], acc, h, c and the
        draft's carry float32, prev_ids int32, fin bool). `rows` are the
        slot's state rows from this dispatch's host copy (_ckpt_parts)
        and the history comes from the copied pools (loop thread only)."""
        snap = {'step': np.asarray(t, np.int32),
                'acc': np.array(acc_np[slot], np.float32)}
        for name, row in rows.items():
            if name == 'fin':
                snap[name] = row != 0
            elif name == 'prev_ids':
                snap[name] = row.copy()
            else:
                snap[name] = row.view(np.float32).copy()
        K = self.config.beam_size
        if self.config.paged:
            sp = self._slot_pages[slot]
            snap['ids'] = ids_np[sp['hist']].reshape(-1, K)[:t].copy()
            snap['par'] = par_np[sp['hist']].reshape(-1, K)[:t].copy()
        else:
            snap['ids'] = ids_np[slot, :t].copy()
            snap['par'] = par_np[slot, :t].copy()
        return snap

    def _token_row(self, slot, s, ids_np):
        """The [beam_size] raw beam column generated at step `s` (1-based)
        of `slot`, from this dispatch's copied history."""
        if self.config.paged:
            sp = self._slot_pages[slot]
            ps = self.config.page_size
            return ids_np[sp['hist'][(s - 1) // ps], (s - 1) % ps]
        return ids_np[slot, s - 1]

    def _abort_slot(self, slot):
        """Free a slot whose stream consumer went away (loop thread only):
        deactivate its row in place, return the slot and its pages to the
        pool, fail the future StreamCancelled. The other in-flight
        sequences never notice: the step's where-select masking isolates
        rows."""
        req = self._occupant[slot]
        taken = self._slot_steps[slot]
        with self._handle_lock, torch.no_grad():
            self._acquire()
            self._state('active')[slot] = False
        self._occupant[slot] = None
        sp = self._slot_pages[slot]
        self._slot_pages[slot] = None
        if sp is not None:
            self._hist_pool.release(sp['hist'])
            if sp['pkey'] is not None:
                self._prefix.unref(sp['pkey'])
            else:
                self._enc_pool.release(sp['enc'])
            _G_PAGES_FREE.set(self._pages_free())
        with self._lock:
            for c in (self._n, self._win):
                c['cancelled'] += 1
                c['releases'] += 1
        _C_CANCELLED.inc()
        _C_RELEASES.inc()
        _G_SLOTS.set(sum(o is not None for o in self._occupant))
        obs.event('decode.cancel', slot=slot, steps=taken)
        if req is not None and not req.future.done():
            try:
                req.future.set_exception(StreamCancelled(
                    'decode slot %d cancelled after %d token(s): the '
                    'stream consumer went away' % (slot, taken)))
            except concurrent.futures.InvalidStateError:
                pass      # a racing cancel() resolved it first

    def _release(self, slot, poisoned, ids_np, par_np, acc_np):
        """Resolve the slot's future from the step's fetched token history
        (host arrays; in paged mode ids_np/par_np are the page POOLS and
        the slot's history is gathered through its page table) and free
        it: pages return to the pool, the prefix entry stays resident with
        its ref count dropped (loop thread only)."""
        from ..fluid.ops_impl.lod_beam import backtrace_beams
        cfg = self.config
        req = self._occupant[slot]
        self._occupant[slot] = None
        taken = self._slot_steps[slot]
        sp = self._slot_pages[slot]
        self._slot_pages[slot] = None
        if sp is not None:
            self._hist_pool.release(sp['hist'])
            if sp['pkey'] is not None:
                self._prefix.unref(sp['pkey'])
            else:
                self._enc_pool.release(sp['enc'])
            _G_PAGES_FREE.set(self._pages_free())
        with self._lock:
            self._n['releases'] += 1
            self._win['releases'] += 1
        _C_RELEASES.inc()
        _G_SLOTS.set(sum(o is not None for o in self._occupant))
        if req is None:
            return
        if poisoned:
            with self._lock:
                self._n['poisoned'] += 1
                self._win['poisoned'] += 1
            _C_POISONED.inc()
            obs.event('decode.poisoned', slot=slot, steps=taken)
            req.future.set_exception(DecodeSlotPoisoned(
                'slot %d produced non-finite beam scores after %d '
                'step(s); the request was aborted (other in-flight '
                'sequences are unaffected)' % (slot, taken)))
            return
        acc = acc_np[slot]
        if cfg.paged:
            K = cfg.beam_size
            ids_seq = ids_np[sp['hist']].reshape(-1, K)[:taken]
            par_seq = par_np[sp['hist']].reshape(-1, K)[:taken]
        else:
            ids_seq = ids_np[slot, :taken]
            par_seq = par_np[slot, :taken]
        toks = backtrace_beams(ids_seq, par_seq)        # [K, taken]
        if taken < req.limit:
            # the whole-sequence decode keeps emitting end_id with
            # identity parents once every beam finished: pad instead of
            # stepping
            pad = np.full((cfg.beam_size, req.limit - taken), cfg.end_id,
                          toks.dtype)
            toks = np.concatenate([toks, pad], axis=1)
        with self._lock:
            self._n['completed'] += 1
            self._win['completed'] += 1
            self._n['tokens'] += taken
            self._win['tokens'] += taken
        _H_REQ_TOKENS.observe(taken)
        obs.event('decode.release', slot=slot, steps=taken,
                  finished=taken < req.limit)
        req.future.set_result((toks.astype(np.int64), acc))

    def _loop(self):
        """Decode-loop thread wrapper: a loop bug fails every in-flight
        and queued future loudly instead of stranding them."""
        try:
            self._loop_body()
        except BaseException as e:  # noqa: BLE001 — resolved into futures
            obs.event('decode.loop.error',
                      error='%s: %s' % (type(e).__name__, e))
            with self._lock:
                self._shutdown = True
                self._drain = False
                doomed = [r for r in self._queue]
                self._queue.clear()
                _G_QDEPTH.set(0)
            doomed += [occ for occ in self._occupant if occ is not None]
            self._occupant = [None] * self.config.slots
            _G_SLOTS.set(0)
            for r in doomed:
                try:
                    # queued futures are PENDING and must be claimed;
                    # in-flight ones are already RUNNING and raise here
                    r.future.set_running_or_notify_cancel()
                except RuntimeError:
                    pass
                if not r.future.done():
                    r.future.set_exception(e)

    def _loop_body(self):
        while True:
            shed, joins, doomed = [], [], []
            with self._lock:
                free = sum(o is None for o in self._occupant)
                if free:
                    joins = self._pop_live_locked(time.monotonic(), shed,
                                                  free)
                pending = len(self._queue)
                closing = self._shutdown
                if closing and not self._drain:
                    # queued requests fail with ServerClosed; active slots
                    # still finish. Futures resolve OUTSIDE the lock
                    while self._queue:
                        doomed.append(self._queue.popleft())
                    doomed += joins     # claimed but not yet admitted
                    joins = []
                    pending = 0
                    _G_QDEPTH.set(0)
            for r in doomed:
                try:
                    r.future.set_running_or_notify_cancel()
                except RuntimeError:
                    pass                # already claimed as a join
                if not r.future.done():
                    r.future.set_exception(ServerClosed(
                        'decode engine shut down without draining'))
            self._fail_shed(shed)
            # consumer-gone streams first: their slots and pages free up
            # before this round's admit and step
            for slot, occ in enumerate(self._occupant):
                if occ is not None and occ.aborted:
                    self._abort_slot(slot)
            if joins:
                self._admit(joins)
            if not any(o is not None for o in self._occupant):
                if closing and pending == 0:
                    break
                with self._lock:
                    if not self._queue and not self._shutdown:
                        self._not_empty.wait(_POLL_S)
                continue
            handle = self._acquire()
            spec_k = self.config.spec_k
            occupied = [slot for slot, occ in enumerate(self._occupant)
                        if occ is not None]
            streaming = [slot for slot in occupied
                         if self._occupant[slot].streams()]
            # the slots whose checkpoint cadence this dispatch may cross
            # (a dispatch advances a slot by at most `adv` tokens)
            adv = spec_k + 1 if spec_k else self.config.bundle
            ckpt_due = []
            for slot in streaming:
                occ, cur = self._occupant[slot], self._slot_steps[slot]
                if occ.checkpoint is not None and occ.ckpt_every and (
                        (cur + adv) // occ.ckpt_every
                        > cur // occ.ckpt_every):
                    ckpt_due.append(slot)
            t0 = time.perf_counter()
            # host copies own their memory (Executor._to_numpy): a CPU
            # tensor's numpy view would alias state the next join updates
            host = self._exe._to_numpy
            ckpt_rows = {}
            with self._handle_lock:   # vs warmup's step
                fetched = handle.step()
                active_v, ids_v, par_v, acc_v, step_v = fetched[:5]
                level_v = torch.stack(
                    [active_v.to(torch.int32), step_v] + list(fetched[5:]))
                if streaming:
                    # the one host sync of a streaming dispatch: the
                    # level, the history pools and the scores (every
                    # emission and release reads them) and the state
                    # rows of the slots whose checkpoint may fall due
                    parts = [level_v, ids_v, par_v,
                             acc_v.contiguous().view(torch.int32)]
                    rows = self._ckpt_parts(ckpt_due)
                    parts += [r for _, _, r in rows]
                    flat = host(torch.cat([t.reshape(-1) for t in parts]))
                    syncs = 1
                    cuts = np.cumsum([t.numel() for t in parts])[:-1]
                    pieces = np.split(flat, cuts)
                    level = pieces[0].reshape(level_v.shape)
                    ids_np = pieces[1].reshape(ids_v.shape)
                    par_np = pieces[2].reshape(par_v.shape)
                    acc_np = pieces[3].view(np.float32).reshape(acc_v.shape)
                    for (slot, name, r), a in zip(rows, pieces[4:]):
                        ckpt_rows.setdefault(slot, {})[name] = a.reshape(
                            tuple(r.shape))
                else:
                    # the one host sync of a dispatch: each slot's active
                    # flag and step count (and accepted proposals)
                    level = host(level_v)
                    syncs = 1
                active_np, steps_np = level[0] != 0, level[1]
                finished = [slot for slot, occ
                            in enumerate(self._occupant)
                            if occ is not None and not active_np[slot]]
                if finished and not streaming:
                    # one more for every release of this dispatch
                    ids_np = host(ids_v)
                    par_np = host(par_v)
                    acc_np = host(acc_v)
                    syncs += 3
            dt = time.perf_counter() - t0
            _H_STEP.observe(dt)
            _C_STEPS.inc()
            with self._lock:
                self._n['steps'] += 1
                self._win['steps'] += 1
                self._n['host_syncs'] += syncs
                if spec_k:
                    # every occupied slot saw spec_k proposals; Accepted
                    # counts the ones the target verified
                    acc_n = int(sum(level[2][s] for s in occupied))
                    for c in (self._n, self._win):
                        c['spec_proposed'] += spec_k * len(occupied)
                        c['spec_accepted'] += acc_n
            if spec_k:
                _C_SPEC_PROPOSED.inc(spec_k * len(occupied))
                _C_SPEC_ACCEPTED.inc(acc_n)
            now = time.monotonic()
            for slot, occ in enumerate(self._occupant):
                if occ is None:
                    continue
                prev_steps = self._slot_steps[slot]
                self._slot_steps[slot] = cur = int(steps_np[slot])
                _C_TOKENS.inc(cur - prev_steps)
                if prev_steps == 0 and cur > 0 and occ.t_join is not None:
                    _H_TTFT.observe(now - occ.t_submit)
                # stream every token this dispatch produced, IN ORDER; a
                # RAISING callback means the consumer is gone and the
                # slot is reaped at the next tick
                if occ.on_token is not None and cur > prev_steps \
                        and not occ.aborted:
                    for t in range(prev_steps + 1, cur + 1):
                        try:
                            occ.on_token(t, self._token_row(slot, t,
                                                            ids_np))
                        except Exception as e:  # noqa: BLE001
                            occ.aborted = True
                            obs.event('decode.stream.abort', slot=slot,
                                      token=t, error='%s: %s'
                                      % (type(e).__name__, e))
                            break
                # checkpoint at every cadence crossing (not for a slot
                # finishing now: its result resolves anyway); a failing
                # sink degrades failover and must not stop the stream
                if slot in ckpt_rows and not occ.aborted \
                        and slot not in finished \
                        and cur // occ.ckpt_every \
                        > prev_steps // occ.ckpt_every:
                    try:
                        occ.checkpoint(self._snapshot_slot(
                            slot, cur, ids_np, par_np, acc_np,
                            ckpt_rows[slot]))
                    except Exception as e:  # noqa: BLE001
                        obs.event('decode.ckpt.error', slot=slot,
                                  step=cur, error='%s: %s'
                                  % (type(e).__name__, e))
                if slot in finished:
                    self._release(slot,
                                  bool(np.isnan(acc_np[slot]).any()),
                                  ids_np, par_np, acc_np)

    # -- lifecycle / stats -------------------------------------------------

    def request_shutdown(self):
        """Signal-safe: flag only."""
        self._shutdown = True

    def shutdown(self, drain=True, timeout=None):
        """Stop admission; with drain=True every queued request still
        decodes, else queued futures fail with ServerClosed (in-flight
        sequences always finish). No future is ever lost."""
        with self._lock:
            self._drain = drain
            self._shutdown = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        self._thread.join(timeout)
        done = not self._thread.is_alive()
        extra = {}
        if self.config.paged:
            extra.update(pages_total=(self._hist_pool.usable
                                      + self._enc_pool.usable),
                         prefix_hits=self._n['prefix_hits'],
                         prefix_misses=self._n['prefix_misses'],
                         prefix_evictions=(self._prefix.evictions
                                           if self._prefix else 0))
        if self.config.spec_k and self._n['spec_proposed']:
            extra['spec_accept_rate'] = round(
                self._n['spec_accepted'] / self._n['spec_proposed'], 4)
        obs.event('decode.shutdown', drained=drain, clean=done,
                  completed=self._n['completed'],
                  tokens=self._n['tokens'], **extra)
        return done

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
        return False

    def _page_fields(self):
        return {'pages_total': self._hist_pool.usable + self._enc_pool.usable,
                'pages_free': self._pages_free()}

    @property
    def stats(self):
        """Cumulative decode statistics + instantaneous depth/occupancy
        (the windowed signal is stats_window())."""
        with self._lock:
            depth = len(self._queue)
        out = {k: self._n.get(k, 0) for k in
               ('submitted', 'completed', 'rejected', 'shed', 'poisoned',
                'joins', 'releases', 'steps', 'tokens', 'cancelled',
                'resumed', 'slots_high_water', 'delta_pushes',
                'delta_rows', 'host_syncs')}
        out['queue_depth'] = depth
        out['queue_high_water'] = self._q_high_water
        out['slots'] = self.config.slots
        out['slots_occupied'] = sum(o is not None for o in self._occupant)
        out['warm'] = self._warm
        if self.config.paged:
            out.update(self._page_fields())
            out['prefix_hits'] = self._n['prefix_hits']
            out['prefix_misses'] = self._n['prefix_misses']
            out['prefix_evictions'] = (self._prefix.evictions
                                       if self._prefix else 0)
        if self.config.spec_k:
            out['spec_proposed'] = self._n['spec_proposed']
            out['spec_accepted'] = self._n['spec_accepted']
            out['spec_accept_rate'] = (
                self._n['spec_accepted'] / self._n['spec_proposed']
                if self._n['spec_proposed'] else None)
        return out

    def stats_window(self):
        """Admission-pressure counters SINCE THE LAST CALL (queue
        high-water mark, shed/reject counts, page occupancy and prefix hit
        rate); reading resets the window."""
        with self._lock:
            win = dict(self._win)
            self._win.clear()
            depth = len(self._queue)
        for k in ('queue_high_water', 'shed', 'rejected', 'submitted',
                  'completed', 'tokens'):
            win.setdefault(k, 0)
        win['queue_depth'] = depth
        win['inflight'] = sum(o is not None for o in self._occupant)
        # 'capacity' is the ADMISSION queue capacity, as on ServingEngine
        win['capacity'] = self.config.queue_capacity
        win['slots'] = self.config.slots
        if self.config.paged:
            win.update(self._page_fields())
            seen = win.get('prefix_hits', 0) + win.get('prefix_misses', 0)
            win['prefix_hit_rate'] = (win.get('prefix_hits', 0) / seen
                                      if seen else None)
        else:
            win['pages_free'] = win['pages_total'] = 0
            win['prefix_hit_rate'] = None
        if self.config.spec_k:
            win['spec_accept_rate'] = (
                win.get('spec_accepted', 0) / win['spec_proposed']
                if win.get('spec_proposed') else None)
        return win

    def cache_stats(self):
        """The step executor's artifact cache counters (Executor.
        cache_stats: hits, misses, entries, captures, replays): after
        warmup() a request stream adds no miss and, on the card, no
        capture."""
        return self._exe.cache_stats

    def state_bytes(self):
        """Total bytes of the per-request decode STATE tensors (slot state
        + history/encoder storage: dense buffers or page pools + page
        tables; weights excluded)."""
        total = 0
        for shape, dtype in self._state_spec.values():
            total += int(np.prod(shape)) * np.dtype(dtype).itemsize
        return total
