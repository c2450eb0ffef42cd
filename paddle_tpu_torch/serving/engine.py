"""In-process serving engine: dynamic micro-batching behind futures.

Parity: the JAX package's serving/engine.py. `ServingEngine` puts an async
request API in front of a `paddle_tpu_torch.inference.Predictor` (or any
object with `feed_names` and `run(feed)`):

  * callers `submit(feed)` and get a `concurrent.futures.Future`; a
    single batcher thread coalesces waiting requests into micro-batches
    under a (max_batch_size, max_queue_delay_ms) policy;
  * each micro-batch is padded up to a configured shape BUCKET
    (serving/buckets.py), so the model sees a small closed set of batch
    shapes and `warmup()` can run every one of them before traffic
    arrives (first-use costs — kernel build, allocator growth, cuBLAS
    heuristics — are paid there, not by the first request);
  * admission control: the request queue is bounded; overflow either
    blocks the submitter or rejects with a typed `ServerOverloaded`;
    per-request deadlines shed already-expired work before it wastes a
    batch slot; `shutdown()` drains in-flight work;
  * everything is observable through paddle_tpu_torch.obs: queue-depth
    gauge, batch-size / queue-wait histograms, per-batch spans, and the
    windowed admission-pressure counters a Router balances on
    (`stats_window`);
  * trained row deltas land in the live weights (`push_rows`, the
    streaming train->serve freshness path): written in place into the
    tensors the model's captured graphs read, serialized with its batches.
"""
import collections
import concurrent.futures
import threading
import time

import numpy as np
import torch

from .. import obs
from . import buckets as _buckets

__all__ = ['ServingConfig', 'ServingEngine', 'ServerOverloaded',
           'ServerClosed', 'DeadlineExceeded', 'DeltaUnsupported']

# How long any internal condition-wait may sleep before re-checking the
# shutdown flag.
_POLL_S = 0.02
# runs of each bucket in warmup(): a step signature's first call is its
# eager warm-up, its second the capture of its CUDA graph
WARMUP_RUNS = 2


class ServerOverloaded(RuntimeError):
    """The bounded request queue is full and the overflow policy is
    'reject' (or a blocking submit hit its admission timeout)."""


class ServerClosed(RuntimeError):
    """The engine is shutting down (or already shut down): the request
    was not admitted, or a queued request was cancelled by a
    non-draining shutdown."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired while it waited in the queue; it
    was shed before execution (its future receives this exception)."""


class DeltaUnsupported(TypeError):
    """push_rows targeted a model that cannot take row deltas: a
    `load_compiled` runner (its weights are part of the exported artifact
    — publish a new artifact and Router.swap() instead) or another model
    with no live parameter scope, a persistable the program writes, which
    is per-step state rather than a weight, or a decode-pool persistable
    (slot state, not a weight)."""


class ServingConfig(object):
    """Batching / admission policy for a ServingEngine.

    max_batch_size:     rows per micro-batch cap (and the largest
                        default bucket).
    max_queue_delay_ms: how long the batcher waits after the FIRST
                        request of a batch for more work to coalesce —
                        the latency price paid for throughput.
    queue_capacity:     bounded queue length, in requests.
    overflow:           'block' (submit waits for space) or 'reject'
                        (raise ServerOverloaded immediately).
    buckets:            batch-dim bucket set; default powers of two up
                        to max_batch_size.
    default_deadline_ms: deadline applied to submits that don't carry
                        their own; None = no deadline.
    max_retries:        per-batch execution retries (utils.retry, site
                        'serving.batch') before the batch's futures see
                        the error; 0 = fail fast.
    """

    def __init__(self, max_batch_size=32, max_queue_delay_ms=5.0,
                 queue_capacity=256, overflow='block', buckets=None,
                 default_deadline_ms=None, max_retries=0,
                 retry_base_delay_ms=10.0, retry_seed=0):
        if overflow not in ('block', 'reject'):
            raise ValueError("overflow must be 'block' or 'reject', got %r"
                             % (overflow,))
        if max_batch_size < 1:
            raise ValueError('max_batch_size must be >= 1')
        if queue_capacity < 1:
            raise ValueError('queue_capacity must be >= 1')
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_ms = float(max_queue_delay_ms)
        self.queue_capacity = int(queue_capacity)
        self.overflow = overflow
        self.buckets = tuple(sorted(int(b) for b in buckets)) if buckets \
            else _buckets.default_buckets(max_batch_size)
        if self.buckets[-1] < self.max_batch_size:
            # a batch can never exceed the largest padded signature
            self.max_batch_size = self.buckets[-1]
        self.default_deadline_ms = default_deadline_ms
        self.max_retries = int(max_retries)
        self.retry_base_delay_ms = float(retry_base_delay_ms)
        self.retry_seed = retry_seed


def _table_np_dtype(w):
    """The numpy dtype pushed rows take for table `w` (a tensor or an
    array): a bf16 table takes float32 rows, rounded to bf16 on the
    device."""
    if isinstance(w, torch.Tensor):
        if w.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return torch.empty((), dtype=w.dtype).numpy().dtype
    return np.dtype(str(w.dtype))


def _validate_delta(name, w, ids, rows):
    """Shared delta validation for the push surfaces: in-range int row
    ids, matching trailing dims, a safely-castable dtype. Returns (ids
    int64 [n], rows [n,...] in the table's dtype) or raises ValueError
    naming the table. The JAX :128 (its ids come back int32)."""
    ids = np.asarray(ids)
    rows = np.asarray(rows)
    if ids.ndim != 1:
        raise ValueError('push_rows: %r row ids must be 1-D, got shape %r'
                         % (name, tuple(ids.shape)))
    if not np.issubdtype(ids.dtype, np.integer):
        raise ValueError('push_rows: %r row ids must be integers, got %s'
                         % (name, ids.dtype))
    cap = int(w.shape[0])
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= cap):
        raise ValueError(
            'push_rows: %r row ids out of range [0, %d) (got min %d '
            'max %d)' % (name, cap, int(ids.min()), int(ids.max())))
    want = (ids.shape[0],) + tuple(int(d) for d in w.shape[1:])
    if tuple(rows.shape) != want:
        raise ValueError(
            'push_rows: %r rows have shape %r, expected %r (one row per '
            'id, trailing dims of the table)'
            % (name, tuple(rows.shape), want))
    wdt = _table_np_dtype(w)
    if rows.dtype != wdt:
        if np.can_cast(rows.dtype, wdt, 'same_kind'):
            rows = rows.astype(wdt)
        else:
            raise ValueError(
                'push_rows: %r rows dtype %s cannot cast to the table '
                'dtype %s' % (name, rows.dtype, wdt))
    return ids.astype(np.int64), rows


class _Request(object):
    __slots__ = ('feed', 'n', 'sig', 'future', 't_submit', 'deadline')

    def __init__(self, feed, n, sig, future, t_submit, deadline):
        self.feed = feed
        self.n = n
        self.sig = sig
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline


# Process-wide serving telemetry (docs/serving.md): unlabeled, like the
# executor's — per-engine views live in engine.stats.
_G_QDEPTH = obs.gauge('serving.queue.depth')
_H_BATCH_SIZE = obs.histogram('serving.batch.size',
                              buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256,
                                       512, 1024))
_H_QWAIT = obs.histogram('serving.queue.wait.seconds')
_C_REQUESTS = obs.counter('serving.requests')
_C_BATCHES = obs.counter('serving.batches')
_C_REJECTED = obs.counter('serving.rejected')
_C_SHED = obs.counter('serving.shed')
_C_BATCH_ERRORS = obs.counter('serving.batch.errors')
_C_PAD_ROWS = obs.counter('serving.padded_rows')


class ServingEngine(object):
    """Async micro-batching front end over one loaded model.

    `model` is a `paddle_tpu_torch.inference.Predictor` or any object
    exposing `feed_names` plus a `run(feed) -> [ndarray]` method (or
    being itself that callable). The engine starts
    its batcher thread immediately and is a context manager
    (`with ServingEngine(p) as eng: ...` drains on exit).

    `per_row_outputs` declares which fetch-list positions are batched
    per-row (everything else replicates whole to each request in the
    batch). Without it the engine falls back to a HEURISTIC — an output
    is per-row iff its leading dim equals the padded bucket size —
    which silently mis-slices a batch-level aggregate whose leading dim
    coincidentally equals the bucket. Declare the set whenever any
    fetch output is not batched on axis 0.
    """

    def __init__(self, model, config=None, per_row_outputs=None):
        self.config = config or ServingConfig()
        self._model = model
        self._model_fn = model.run if hasattr(model, 'run') else model
        self.feed_names = list(model.feed_names)
        self._input_spec = getattr(model, 'input_spec', None)
        self._per_row_outputs = None if per_row_outputs is None \
            else frozenset(int(i) for i in per_row_outputs)
        if self._per_row_outputs is not None:
            fetch_names = getattr(model, 'fetch_names', None)
            n_out = len(fetch_names) if fetch_names is not None else None
            bad = sorted(i for i in self._per_row_outputs
                         if i < 0 or (n_out is not None and i >= n_out))
            if bad:
                raise ValueError(
                    'per_row_outputs %r out of range: indices must be '
                    '>= 0%s' % (bad, '' if n_out is None else
                                ' and < %d fetch output(s)' % n_out))
        self.buckets = self.config.buckets
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._shutdown = False
        self._drain = True
        self._warm = False
        # per-engine counters (process-wide twins live in the registry)
        self._n_submitted = 0
        self._n_completed = 0
        self._n_rejected = 0
        self._n_shed = 0
        self._n_batches = 0
        self._n_batch_errors = 0
        self._n_padded_rows = 0
        self._n_inflight = 0           # rows in the currently-executing batch
        self._q_high_water = 0         # cumulative queue high-water mark
        # row-delta pushes (push_rows): serialized so two publishers'
        # pushes never interleave their tables
        self._push_lock = threading.Lock()
        self._push_write_set = None    # memoized program write set
        self._n_delta_pushes = 0
        self._n_delta_rows = 0
        # the windowed counterparts stats_window() reads-and-resets — the
        # admission-pressure signal the router balances on
        self._win = {'submitted': 0, 'completed': 0, 'shed': 0,
                     'rejected': 0, 'queue_high_water': 0}
        self._thread = threading.Thread(target=self._batcher_loop,
                                        name='serving-batcher', daemon=True)
        self._thread.start()

    # -- request admission -------------------------------------------------

    def _normalize_feed(self, feed):
        """np-ify the feed, check names, and derive (rows, signature).
        The signature — feed names + trailing dims + dtypes — decides
        which requests may share a micro-batch."""
        if set(feed) != set(self.feed_names):
            raise ValueError(
                'feed names %r do not match the model inputs %r'
                % (sorted(feed), sorted(self.feed_names)))
        arrays, n = {}, None
        for name in self.feed_names:
            a = np.asarray(feed[name])
            if a.ndim == 0:
                raise ValueError(
                    'serving feeds are batched on axis 0; input %r is a '
                    'scalar' % name)
            if a.shape[0] == 0:
                raise ValueError(
                    'input %r has 0 rows — an empty request cannot be '
                    'padded to a bucket' % name)
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    'inconsistent leading (batch) dims in one request: '
                    'input %r has %d rows, expected %d'
                    % (name, a.shape[0], n))
            arrays[name] = a
        sig = tuple((name, arrays[name].shape[1:], str(arrays[name].dtype))
                    for name in self.feed_names)
        return arrays, int(n), sig

    def submit(self, feed, deadline_ms=None, timeout=None):
        """Enqueue one request; returns a `concurrent.futures.Future`
        resolving to the model's fetch list, each output sliced back to
        this request's rows. Raises ServerClosed after shutdown,
        ServerOverloaded when the queue is full under the 'reject'
        policy (or when a 'block' submit exceeds `timeout` seconds), and
        ValueError for malformed feeds. `deadline_ms` (default
        config.default_deadline_ms) sheds the request with
        DeadlineExceeded if it is still queued when the deadline
        passes."""
        arrays, n, sig = self._normalize_feed(feed)
        if n > self.config.max_batch_size:
            raise ValueError(
                'request of %d rows exceeds max_batch_size=%d — split it '
                'client-side' % (n, self.config.max_batch_size))
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        now = time.monotonic()
        deadline = now + deadline_ms / 1000.0 if deadline_ms is not None \
            else None
        fut = concurrent.futures.Future()
        req = _Request(arrays, n, sig, fut, now, deadline)
        t_give_up = now + timeout if timeout is not None else None
        with self._lock:
            while True:
                if self._shutdown:
                    raise ServerClosed('serving engine is shut down')
                if len(self._queue) < self.config.queue_capacity:
                    break
                if self.config.overflow == 'reject':
                    self._n_rejected += 1
                    self._win['rejected'] += 1
                    _C_REJECTED.inc()
                    obs.event('serving.reject',
                              queue_depth=len(self._queue),
                              capacity=self.config.queue_capacity)
                    raise ServerOverloaded(
                        'request queue is full (%d request(s), capacity %d) '
                        'and the overflow policy is reject'
                        % (len(self._queue), self.config.queue_capacity))
                remaining = _POLL_S if t_give_up is None else \
                    min(_POLL_S, t_give_up - time.monotonic())
                if t_give_up is not None and remaining <= 0:
                    self._n_rejected += 1
                    self._win['rejected'] += 1
                    _C_REJECTED.inc()
                    obs.event('serving.reject',
                              queue_depth=len(self._queue),
                              capacity=self.config.queue_capacity,
                              timeout_s=timeout)
                    raise ServerOverloaded(
                        'request queue stayed full for %.3fs (capacity %d)'
                        % (timeout, self.config.queue_capacity))
                self._not_full.wait(remaining)
            self._queue.append(req)
            self._n_submitted += 1
            self._win['submitted'] += 1
            depth = len(self._queue)
            self._q_high_water = max(self._q_high_water, depth)
            self._win['queue_high_water'] = max(
                self._win['queue_high_water'], depth)
            _C_REQUESTS.inc()
            _G_QDEPTH.set(depth)
            self._not_empty.notify()
        return fut

    def predict(self, feed, deadline_ms=None, timeout=None):
        """Synchronous convenience: submit + wait. `timeout` is ONE
        wall-clock budget covering both admission (a 'block' overflow
        wait on a full queue) and the result, and its expiry raises the
        typed DeadlineExceeded (never a raw
        concurrent.futures.TimeoutError). A still-queued request is
        cancelled — dropped at dequeue time without consuming a batch
        slot; one already mid-batch cannot be recalled: its batch
        completes and the result is discarded."""
        t0 = time.monotonic()
        fut = self.submit(feed, deadline_ms=deadline_ms, timeout=timeout)
        remaining = None if timeout is None else \
            max(0.0, timeout - (time.monotonic() - t0))
        try:
            return fut.result(remaining)
        except concurrent.futures.TimeoutError:
            if fut.done():
                # the future resolved in the race window after result()
                # expired — return the just-arrived result (or re-raise
                # the model's own exception, including a genuine model
                # TimeoutError) instead of discarding it
                return fut.result()
            if fut.cancel():
                raise DeadlineExceeded(
                    'no result within the %.3fs predict() timeout; the '
                    'queued request was cancelled and will not execute'
                    % timeout)
            raise DeadlineExceeded(
                'no result within the %.3fs predict() timeout; the '
                'request is already executing — its batch completes but '
                'the result is discarded' % timeout)

    def cancel(self, future):
        """Best-effort cancel of one submitted request by its future. A
        still-QUEUED request is cancelled — dropped at dequeue time
        without consuming a batch slot; one already mid-batch completes
        and its result is discarded. Returns True if the future was
        cancelled while queued."""
        return future.cancel()

    # -- warmup ------------------------------------------------------------

    def warmup(self, example_feed=None):
        """Run every bucket's batch shape twice before traffic arrives, so
        first-use costs are not paid by a request: through a Predictor on
        the card the first run of a bucket's signature is its eager
        warm-up (kernel build, allocator growth, library heuristics) and
        the second captures it into a CUDA graph, which every batch of
        that bucket then replays. Builds a feed per bucket by tiling
        `example_feed` (any row count >= 1) — or, when the model publishes
        a fully static `input_spec`, a zeros feed. Returns the bucket
        list."""
        template = {}
        if example_feed is not None:
            arrays, _, _ = self._normalize_feed(example_feed)
            template = {n: a[:1] for n, a in arrays.items()}
        else:
            spec = self._input_spec or {}
            for name in self.feed_names:
                sp = spec.get(name)
                if sp is None or any(int(d) < 0 for d in sp[0][1:]):
                    raise ValueError(
                        'warmup() needs example_feed: input %r has no '
                        'static shape in the model metadata' % name)
                shape, dtype = sp
                template[name] = np.zeros((1,) + tuple(
                    int(d) for d in shape[1:]), dtype=np.dtype(dtype))
        for b in self.buckets:
            feed = {n: _buckets.pad_rows(a, b) for n, a in template.items()}
            with obs.span('serving.warmup', bucket=b):
                for _ in range(WARMUP_RUNS):
                    self._model_fn(feed)
        self._warm = True
        return list(self.buckets)

    # -- row-delta push ----------------------------------------------------

    def push_rows(self, deltas):
        """Write trained row deltas into this replica's LIVE weights — the
        streaming train->serve freshness path: `deltas` maps a persistable
        name to `(row_ids, rows)` where `rows[i]` is the new value of
        `table[row_ids[i]]`. Returns rows applied.

        The JAX engine commits by building each table anew and swapping
        the reference in its scope. Here the Predictor's captured graphs
        read their weights by address (the scope's tensors ARE the
        graphs' static state), so a rebound table would never be seen by
        a replay. The rows are written IN PLACE instead (`index_copy_`
        into the tensor the scope holds), every table of the push under
        the model executor's lock, which serializes its runs, and on the
        stream its replays run on: a batch executing concurrently reads
        every table whole before the push or whole after it, never a
        torn row, and no graph is captured again. Every delta is
        validated before any row is written. Only Predictor-backed models
        take deltas (a `load_compiled` runner carries its weights in the
        artifact: typed DeltaUnsupported; publish an artifact and
        Router.swap() instead), and only into variables the program does
        not WRITE (per-step state, which the step itself rewrites)."""
        scope = getattr(self._model, '_scope', None)
        prog = getattr(self._model, '_program', None)
        exe = getattr(self._model, '_exe', None)
        if scope is None or prog is None or exe is None:
            raise DeltaUnsupported(
                'this replica serves a compiled artifact (or a bare '
                'callable) with no live parameter scope — row deltas '
                'need a Predictor-backed engine; swap() a new artifact '
                'instead')
        if self._shutdown:
            raise ServerClosed('serving engine is shut down')
        # the program never changes for the life of the engine: walk
        # its write set once, not once per publisher cadence
        write_set = self._push_write_set
        if write_set is None:
            from ..fluid.passes import memory_plan
            write_set = self._push_write_set = memory_plan(prog).write_set
        applied = 0
        with self._push_lock:
            staged = []
            for name in sorted(deltas):
                ids, rows = deltas[name]
                w = scope._chain_get(name)
                if w is None:
                    raise KeyError(
                        'push_rows: no persistable %r in the model scope'
                        % (name,))
                if name in write_set:
                    raise DeltaUnsupported(
                        'push_rows: %r is WRITTEN by the serving program '
                        '(per-step state) — pushing rows into it would '
                        'race the step\'s own update' % (name,))
                ids, rows = _validate_delta(name, w, ids, rows)
                dev = w.device
                idx = torch.from_numpy(ids)
                src = torch.from_numpy(np.ascontiguousarray(rows))
                if dev.type == 'cuda':
                    # staged from pinned memory without waiting for the
                    # card; the copies are ordered before the writes
                    idx = idx.pin_memory().to(dev, non_blocking=True)
                    src = src.pin_memory().to(dev, non_blocking=True)
                staged.append((name, idx, src))
                applied += int(ids.shape[0])
            with exe._lock, torch.no_grad():
                for name, idx, src in staged:
                    # read under the lock: the first capture may have
                    # rebound the scope to the graph's static tensor
                    w = scope._chain_get(name)
                    w.index_copy_(0, idx, src.to(w.dtype))
        self._n_delta_rows += applied
        self._n_delta_pushes += 1
        return applied

    # -- shutdown ----------------------------------------------------------

    def request_shutdown(self):
        """Signal-safe shutdown request (the Trainer preemption pattern:
        flag only, NO locks — safe from a SIGTERM handler). Admission
        closes immediately; the batcher drains queued and in-flight
        requests, then exits."""
        self._shutdown = True

    def shutdown(self, drain=True, timeout=None):
        """Stop admission and wait for the batcher to finish. With
        drain=True (default) every queued request still executes; with
        drain=False queued futures fail with ServerClosed. Either way no
        future is ever lost. Returns True when the batcher exited within
        `timeout`."""
        with self._lock:
            self._drain = drain
            self._shutdown = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        self._thread.join(timeout)
        done = not self._thread.is_alive()
        obs.event('serving.shutdown', drained=drain, clean=done,
                  completed=self._n_completed, shed=self._n_shed,
                  batches=self._n_batches)
        return done

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
        return False

    @property
    def stats(self):
        """This engine's CUMULATIVE serving statistics (process-wide
        aggregates of the same series live in the obs registry). The
        windowed admission-pressure signal a router balances on is
        `stats_window()`."""
        with self._lock:
            depth = len(self._queue)
        return {'submitted': self._n_submitted,
                'completed': self._n_completed,
                'rejected': self._n_rejected,
                'shed': self._n_shed,
                'batches': self._n_batches,
                'batch_errors': self._n_batch_errors,
                'padded_rows': self._n_padded_rows,
                'queue_depth': depth,
                'queue_high_water': self._q_high_water,
                'inflight': self._n_inflight,
                'delta_pushes': self._n_delta_pushes,
                'delta_rows': self._n_delta_rows,
                'warm': self._warm}

    def stats_window(self):
        """Admission-pressure counters SINCE THE LAST CALL — the queue
        high-water mark plus shed/reject/submit/complete counts of the
        window, with the instantaneous depth and in-flight rows
        appended. Instantaneous depth alone is a useless balancing
        signal (a bursty replica reads 0 between bursts; one that shed
        work a moment ago looks idle); the router (serving/router.py)
        is the intended single consumer — reading resets the window."""
        with self._lock:
            win = dict(self._win)
            for k in self._win:
                self._win[k] = 0
            depth = len(self._queue)
        win['queue_depth'] = depth
        win['inflight'] = self._n_inflight
        win['capacity'] = self.config.queue_capacity
        return win

    # -- batcher -----------------------------------------------------------

    def _pop_live_locked(self, now, shed):
        """Pop the next request that is still wanted, collecting expired
        ones into `shed`. Caller holds the lock — the shed futures are
        FAILED BY THE CALLER after releasing it (set_exception runs
        done-callbacks synchronously; a callback that re-enters the
        engine, e.g. a client-side retry submit, would deadlock on the
        non-reentrant lock)."""
        while self._queue:
            req = self._queue.popleft()
            _G_QDEPTH.set(len(self._queue))
            self._not_full.notify()
            if req.deadline is not None and now > req.deadline:
                shed.append(req)
                continue
            return req
        return None

    def _fail_shed(self, shed):
        """Resolve shed requests' futures (lock NOT held)."""
        now = time.monotonic()
        for req in shed:
            # a request can be cancelled while queued (its caller's
            # Future.cancel()) and ALSO pass its deadline before the
            # batcher reaches it: set_exception on a cancelled future
            # raises InvalidStateError, which would kill the batcher
            # thread. This transition claims the future atomically —
            # False means cancelled, and nobody is waiting for it.
            if not req.future.set_running_or_notify_cancel():
                continue
            self._n_shed += 1
            with self._lock:   # _win races stats_window's copy+reset
                self._win['shed'] += 1
            _C_SHED.inc()
            waited = now - req.t_submit
            obs.event('serving.shed', waited_s=waited, rows=req.n)
            req.future.set_exception(DeadlineExceeded(
                'request shed after waiting %.3fs: its deadline passed '
                'before a batch slot opened' % waited))

    def _collect(self):
        """Block for the next micro-batch: the first live request opens
        a max_queue_delay_ms window; compatible requests (same feed
        signature) join until the window closes or max_batch_size rows
        are reached. Returns [] transiently, None when shut down and
        fully drained. Future resolution (shed, cancel) always happens
        OUTSIDE the lock — see _pop_live_locked."""
        while True:
            shed = []
            with self._lock:
                while not self._queue:
                    if self._shutdown:
                        return None
                    self._not_empty.wait(_POLL_S)
                first = self._pop_live_locked(time.monotonic(), shed)
            self._fail_shed(shed)
            if first is None:
                return []
            if first.future.set_running_or_notify_cancel():
                break  # cancelled-while-queued requests are dropped
        batch, rows = [first], first.n
        horizon = time.monotonic() + self.config.max_queue_delay_ms / 1000.0
        while rows < self.config.max_batch_size:
            shed, req, closed, sealed = [], None, False, False
            with self._lock:
                if self._queue:
                    req = self._pop_live_locked(time.monotonic(), shed)
                    if req is not None and (
                            req.sig != first.sig or
                            rows + req.n > self.config.max_batch_size):
                        # expired heads are shed INSIDE the pop, so the
                        # request it returns need not be the head that
                        # was visible beforehand — compatibility must be
                        # checked after popping, never before. A request
                        # with a different signature (np.concatenate
                        # would fail or promote dtypes) or one that
                        # overflows the row budget (pick_bucket would
                        # raise) goes back to the front and opens the
                        # NEXT batch instead.
                        self._queue.appendleft(req)
                        _G_QDEPTH.set(len(self._queue))
                        req, sealed = None, True
                elif self._shutdown:
                    closed = True  # draining: don't wait for more traffic
            self._fail_shed(shed)
            if sealed or closed:
                break
            if req is not None:
                if req.future.set_running_or_notify_cancel():
                    batch.append(req)
                    rows += req.n
                continue
            remaining = horizon - time.monotonic()
            if remaining <= 0:
                break
            with self._lock:
                if not self._queue and not self._shutdown:
                    self._not_empty.wait(min(_POLL_S, remaining))
        return batch

    def _batcher_loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                break
            if not batch:
                continue
            if self._shutdown and not self._drain:
                for req in batch:
                    req.future.set_exception(ServerClosed(
                        'serving engine shut down without draining'))
                continue
            try:
                self._execute(batch)
            except BaseException as e:  # noqa: BLE001 — thread last resort
                # _execute routes model/assembly errors to the batch's
                # futures itself; anything escaping it is an engine bug.
                # Fail the batch rather than letting the exception kill
                # the batcher thread silently — a dead batcher strands
                # every queued future and blocks all later submits.
                self._n_batch_errors += 1
                self._n_inflight = 0   # _execute died before its reset
                _C_BATCH_ERRORS.inc()
                obs.event('serving.batch.error', requests=len(batch),
                          error='batcher guard: %s: %s'
                                % (type(e).__name__, e))
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _run_with_retry(self, feed):
        if self.config.max_retries <= 0:
            return self._model_fn(feed)
        from ..utils import retry as retry_mod
        return retry_mod.retry_call(
            self._model_fn, args=(feed,),
            retries=self.config.max_retries,
            base_delay=self.config.retry_base_delay_ms / 1000.0,
            retry_on=(Exception,), seed=self.config.retry_seed,
            site='serving.batch')

    def _execute(self, batch):
        now = time.monotonic()
        rows = sum(r.n for r in batch)
        self._n_inflight = rows
        waits = [now - r.t_submit for r in batch]
        # batch ASSEMBLY failures (bucket lookup, concat, padding) must
        # resolve the futures exactly like model failures do — an
        # exception escaping here would kill the batcher thread
        try:
            bucket = _buckets.pick_bucket(rows, self.buckets)
            for w in waits:
                _H_QWAIT.observe(w)
            _H_BATCH_SIZE.observe(rows)
            self._n_batches += 1
            self._n_padded_rows += bucket - rows
            _C_BATCHES.inc()
            _C_PAD_ROWS.inc(bucket - rows)
            feed = {}
            for name in self.feed_names:
                merged = np.concatenate(
                    [r.feed[name] for r in batch], axis=0) \
                    if len(batch) > 1 else batch[0].feed[name]
                feed[name] = _buckets.pad_rows(merged, bucket)
            with obs.span('serving.batch', requests=len(batch),
                          batch_size=rows, bucket=bucket,
                          padded=bucket - rows,
                          wait_max_s=max(waits)) as sp:
                # through a Predictor: numpy views of the pinned host
                # buffers the step's fetches were copied into; the slices
                # each request gets keep them alive
                outs = self._run_with_retry(feed)
                sp.fields['warm'] = self._warm
            outs = [np.asarray(o) for o in outs]
            if self._per_row_outputs is not None:
                bad = sorted(i for i in self._per_row_outputs
                             if i >= len(outs))
                if bad:
                    raise ValueError(
                        'per_row_outputs %r out of range: the model '
                        'returned %d output(s)' % (bad, len(outs)))
        except Exception as e:  # noqa: BLE001 — the batch's futures own it
            self._n_batch_errors += 1
            _C_BATCH_ERRORS.inc()
            obs.event('serving.batch.error', requests=len(batch),
                      batch_size=rows,
                      error='%s: %s' % (type(e).__name__, e))
            for req in batch:
                req.future.set_exception(e)
            self._n_inflight = 0
            return
        per_row = self._per_row_outputs
        off = 0
        for req in batch:
            # declared per-row outputs scatter back to their request's
            # rows; undeclared engines fall back to the leading-dim
            # heuristic (see the class docstring for its failure mode);
            # everything else (batch-level aggregates) replicates whole
            req.future.set_result([
                o[off:off + req.n]
                if (i in per_row if per_row is not None
                    else (o.ndim and o.shape[0] == bucket))
                else o for i, o in enumerate(outs)])
            off += req.n
            self._n_completed += 1
            with self._lock:
                self._win['completed'] += 1
        self._n_inflight = 0
