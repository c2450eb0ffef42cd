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
    gauge, batch-size / queue-wait histograms, per-batch spans.

Row-delta pushes into live weights (push_rows) and per-batch retries wait
for a later slice of the port.
"""
import collections
import concurrent.futures
import threading
import time

import numpy as np

from .. import obs
from . import buckets as _buckets

__all__ = ['ServingConfig', 'ServingEngine', 'ServerOverloaded',
           'ServerClosed', 'DeadlineExceeded']

# How long any internal condition-wait may sleep before re-checking the
# shutdown flag.
_POLL_S = 0.02


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
    """

    def __init__(self, max_batch_size=32, max_queue_delay_ms=5.0,
                 queue_capacity=256, overflow='block', buckets=None,
                 default_deadline_ms=None):
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

    An output is sliced back per request when its leading dim equals the
    padded bucket size; any other output (a batch-level aggregate)
    replicates whole to each request in the batch.
    """

    def __init__(self, model, config=None):
        self.config = config or ServingConfig()
        self._model_fn = model.run if hasattr(model, 'run') else model
        self.feed_names = list(model.feed_names)
        self._input_spec = getattr(model, 'input_spec', None)
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
            depth = len(self._queue)
            self._q_high_water = max(self._q_high_water, depth)
            _C_REQUESTS.inc()
            _G_QDEPTH.set(depth)
            self._not_empty.notify()
        return fut

    # -- warmup ------------------------------------------------------------

    def warmup(self, example_feed=None):
        """Run every bucket's batch shape once before traffic arrives, so
        first-use costs (kernel build, allocator growth, library
        heuristics) are not paid by a request. Builds a feed per bucket
        by tiling `example_feed` (any row count >= 1) — or, when the model
        publishes a fully static `input_spec`, a zeros feed. Returns the
        bucket list."""
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
                self._model_fn(feed)
        self._warm = True
        return list(self.buckets)

    # -- shutdown ----------------------------------------------------------

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
        aggregates of the same series live in the obs registry)."""
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
                'warm': self._warm}

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
                outs = self._model_fn(feed)
                sp.fields['warm'] = self._warm
            outs = [np.asarray(o) for o in outs]
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
        off = 0
        for req in batch:
            # per-row outputs scatter back to their request's rows;
            # batch-level aggregates replicate whole
            req.future.set_result([
                o[off:off + req.n] if o.ndim and o.shape[0] == bucket else o
                for o in outs])
            off += req.n
            self._n_completed += 1
        self._n_inflight = 0
