"""Multi-replica serving router: least-loaded dispatch + hot swap.

Parity: the JAX package's serving/router.py (TokenStream :190, Router
:339, stream :626, swap :672, push_deltas :740). One process, N model
replicas (`ServingEngine`s over Predictors or `load_compiled` runners,
`DecodeEngine`s for continuous-batching decode, or anything with
submit()/stats_window()/shutdown()). The router is the single front door:

  * LEAST-LOADED dispatch: each replica's admission pressure is sampled
    from its `stats_window()` — the queue high-water mark and shed/
    reject counts since the last sample, not just instantaneous depth
    (a bursty replica reads depth 0 between bursts; the window does
    not) — plus a same-window count of requests this router already
    sent it, so consecutive submits spread instead of dogpiling the
    replica that looked idle a moment ago;
  * PER-MODEL ADMISSION QUOTAS: a cap on outstanding (queued +
    in-flight) work per model id; exceeding it raises the typed
    `ModelOverloaded` BEFORE any replica queue is touched, and a
    replica's own `ServerOverloaded` is caught and retried on the next
    least-loaded replica — overload propagates to the caller typed, as
    `ModelOverloaded(model_id)`, only when every replica refused;
  * VERSIONED HOT SWAP (`swap`): load the incoming artifact through
    `inference.load_compiled` (or build it with `builder=`), `warmup()` it
    off to the side (every bucket warmed up and captured), then cut
    traffic over atomically while the OLD replicas drain in the
    background (no future is lost);
  * TOKEN STREAMING (`stream`): a `TokenStream` over a decode replica's
    per-token callback, in order and each index once, with `cancel()`
    freeing the slot and its pages;
  * ROW-DELTA PUSH (`push_deltas`): trained rows into every live replica
    under the swap lock, so a push lands entirely on one generation.

Every request is traced (obs.trace): `submit` opens a `serving.request`
span at node `router` under the caller's trace context (or a new trace)
and dispatches with it current.

Not ported (ROADMAP.md Queue A): `estimate_state_bytes` raises
NotImplementedError (it prices an artifact through
fluid.analysis.cost_report), and the pod's host/key seam, `replicas()`
and `sample_windows()` (serving/pod.py).
"""
import concurrent.futures
import threading
import time

import numpy as np

from .. import obs
from ..obs import trace
from .engine import (DeadlineExceeded, ServerClosed, ServerOverloaded,
                     ServingEngine)

__all__ = ['Router', 'ModelOverloaded', 'TokenStream', 'UnknownModel',
           'estimate_state_bytes']


def estimate_state_bytes(artifact, mesh_axes=None, batch=1):
    """The JAX :48: the static byte footprint of a model never loaded,
    priced by fluid.analysis.cost_report; not ported yet."""
    raise NotImplementedError(
        'estimate_state_bytes waits for fluid.analysis.cost_report, the '
        'port\'s "Analysis and tooling" slice (ROADMAP.md Queue A)')


class UnknownModel(KeyError):
    """submit()/swap() named a model id the router does not serve."""


class ModelOverloaded(ServerOverloaded):
    """The model's admission quota is exhausted, or every replica
    refused the request (typed overload propagation: callers catch
    ServerOverloaded and get the model id via .model_id)."""

    def __init__(self, model_id, message):
        super(ModelOverloaded, self).__init__(message)
        self.model_id = model_id


_C_ROUTED = obs.counter('router.routed')
_C_OVERLOADED = obs.counter('router.overloaded')
_G_REPLICAS = obs.gauge('router.replicas')
_C_STREAM_TOKENS = obs.counter('serving.stream.tokens')
# END-TO-END time to first token: stream() call (before admission, before
# any queueing) to the first token reaching the client's buffer
_H_STREAM_TTFT = obs.histogram('serving.stream.ttft.seconds')

# process-wide replica-id sequence: ids stay unique across routers
_RID_LOCK = threading.Lock()
_RID = [0]


def _next_rid():
    with _RID_LOCK:
        _RID[0] += 1
        return _RID[0]


def _end_request_span(h, fut):
    """Close a serving.request trace span from its future's done
    callback. end() merges: a stream's _on_done adds its ttft fields to
    the same record in whichever order the callbacks fire."""
    try:
        err = fut.exception()
    except concurrent.futures.CancelledError as e:
        err = e
    except Exception:
        err = None
    h.end(error=type(err).__name__ if err is not None else None)


class _Replica(object):
    """One replica slot of a model entry: the engine, its last-sampled
    admission window, the requests routed to it since that sample, and
    a router-unique `rid` (`add_replica` returns it; `remove_replica`
    addresses it). The JAX replica's `host`/`key` coordinates belong to
    its pod registry (serving/pod.py), not ported."""

    __slots__ = ('engine', 'window', 'routed_since', 'sampled_at', 'rid')

    def __init__(self, engine):
        self.engine = engine
        self.window = {}
        self.routed_since = 0
        self.sampled_at = None    # None = never sampled: refresh first
        self.rid = _next_rid()

    def score(self):
        """Admission-pressure score (lower = less loaded): live queue
        depth + in-flight work + the windowed high-water mark, with
        shed/reject counts weighted heavily (a replica that had to
        refuse work is the last place to send more), plus requests this
        router routed to it since the sample. A paged decode replica
        additionally reports page-pool occupancy (pages_free /
        pages_total in the window): a nearly-exhausted pool blocks the
        next join even when slots look free, so it scores as slot-worth
        of pressure as it fills."""
        w = self.window
        pages_total = w.get('pages_total', 0)
        page_pressure = 0.0
        if pages_total:
            occupancy = 1.0 - w.get('pages_free', 0) / pages_total
            page_pressure = occupancy * w.get('slots', 1)
        return (w.get('queue_depth', 0) + w.get('inflight', 0)
                + w.get('queue_high_water', 0)
                + 4 * (w.get('shed', 0) + w.get('rejected', 0))
                + self.routed_since + page_pressure)

    def outstanding(self):
        return (self.window.get('queue_depth', 0)
                + self.window.get('inflight', 0) + self.routed_since)


class _ModelEntry(object):
    __slots__ = ('replicas', 'quota', 'version', 'path')

    def __init__(self, replicas, quota):
        self.replicas = replicas
        self.quota = quota
        self.version = 1
        self.path = None


class TokenStream(object):
    """Client handle for one per-token streamed decode request
    (`Router.stream`): iterate it for `(t, ids)` pairs (t the 1-based
    generated-token index, ids the [beam_size] token row of that step) in
    strictly increasing t order, then call `result()` for the final
    (tokens, scores) exactly as a plain submit() future returns them.

    Ordering is enforced HERE, at the consumer edge: `_on_token` drops any
    token with t <= the last t delivered, so a producer's replay (a stream
    resumed from a checkpoint re-sending tokens 1..ckpt) is seen once.

    The producer (the decode loop) never blocks on the consumer: tokens
    buffer here (at most max_new_tokens rows). `cancel()` drops a queued
    request, or aborts a decoding one at the next loop tick (the slot and
    its pages freed, StreamCancelled on the future)."""

    def __init__(self, model_id=None):
        self.model_id = model_id
        self._cv = threading.Condition()
        self._buf = []
        self._last_t = 0
        self._future = None
        self._cancel_cb = None
        self._t_open = time.monotonic()
        self._ttft_s = None
        self._tspan = None        # trace.SpanHandle of the request span

    # -- producer edge (the decode loop) -----------------------------------

    def _on_token(self, t, ids):
        t = int(t)
        with self._cv:
            if t <= self._last_t:
                return            # a resumed stream's replay
            self._last_t = t
            first = self._ttft_s is None
            if first:
                self._ttft_s = time.monotonic() - self._t_open
            self._buf.append((t, None if ids is None
                              else np.asarray(ids).copy()))
            self._cv.notify_all()
        _C_STREAM_TOKENS.inc()
        if first:
            _H_STREAM_TTFT.observe(self._ttft_s)
            h = self._tspan
            if h is not None:
                h.mark('trace.first_token', ttft_s=round(self._ttft_s, 6))
            obs.event('serving.stream.first_token',
                      model=str(self.model_id),
                      ttft_s=round(self._ttft_s, 6))

    def _attach(self, future):
        self._future = future
        future.add_done_callback(self._on_done)

    def _on_done(self, fut):
        with self._cv:
            self._cv.notify_all()
        try:
            err = fut.exception()
        except concurrent.futures.CancelledError as e:
            err = e
        h = self._tspan
        if h is not None:
            h.end(tokens=self._last_t, ttft_s=self._ttft_s)
        obs.event('serving.stream.close', model=str(self.model_id),
                  tokens=self._last_t, ttft_s=self._ttft_s,
                  error=type(err).__name__ if err is not None else None)

    # -- consumer edge -----------------------------------------------------

    @property
    def ttft_s(self):
        """End-to-end time to first token (None until it arrives): the
        stream() call to the token reaching this buffer."""
        return self._ttft_s

    @property
    def last_t(self):
        """Highest token index delivered so far."""
        return self._last_t

    def __iter__(self):
        """Yield (t, ids) in order until the request completes; a failed
        request raises its error from `result()` AFTER the tokens that did
        arrive have been yielded."""
        while True:
            with self._cv:
                while not self._buf and not (self._future is not None
                                             and self._future.done()):
                    self._cv.wait(0.05)
                if self._buf:
                    t, ids = self._buf.pop(0)
                else:
                    return
            yield t, ids

    def result(self, timeout=None):
        """Final (tokens, scores); blocks like a submit() future."""
        return self._future.result(timeout)

    def done(self):
        return self._future is not None and self._future.done()

    def cancel(self):
        """Stop the stream: a queued request is dropped, a decoding one is
        aborted at the next loop tick (slot and pages freed,
        StreamCancelled on the future). Returns True if a cancel was
        delivered."""
        if self._future is not None and self._future.done():
            return False
        cb = self._cancel_cb
        if cb is not None:
            try:
                return bool(cb())
            except Exception:
                pass
        return self._future.cancel() if self._future is not None else False


class Router(object):
    """Least-loaded request router over named models (module docstring).

    window_s: minimum seconds between stats_window() samples per
    replica — the windowed counters reset on read, so the router is
    their single consumer and rations the reads."""

    def __init__(self, window_s=0.25):
        self._lock = threading.Lock()
        self._swap_lock = threading.Lock()   # one swap at a time
        self._models = {}
        self._window_s = float(window_s)
        self._drainers = []

    # -- registry ----------------------------------------------------------

    def add_model(self, model_id, replicas, quota=None):
        """Register `model_id` served by `replicas` (a list of engines).
        `quota` caps outstanding (queued + in-flight) requests across
        the model's replicas; None = no cap."""
        if not replicas:
            raise ValueError('a model needs at least one replica')
        with self._lock:
            if model_id in self._models:
                raise ValueError('model %r is already registered; use '
                                 'swap() or add_replica()' % (model_id,))
            self._models[model_id] = _ModelEntry(
                [_Replica(e) for e in replicas],
                int(quota) if quota is not None else None)
            self._update_gauge_locked()
        return self

    def add_replica(self, model_id, engine):
        """Register one more replica for `model_id`; returns its rid —
        the registration handle `remove_replica` addresses."""
        r = _Replica(engine)
        with self._lock:
            self._entry(model_id).replicas.append(r)
            self._update_gauge_locked()
        return r.rid

    def remove_replica(self, model_id, rid, drain=True, timeout=None,
                       reason='removed'):
        """Deregister the replica `rid` of `model_id`. With drain=True
        (default) its engine drains in a background thread exactly like
        a swapped-out generation (queued + in-flight work completes, no
        future is lost); drain=False detaches without touching the
        engine. Returns the detached engine, or None when the rid is not
        registered."""
        with self._lock:
            entry = self._entry(model_id)
            match = [r for r in entry.replicas if r.rid == rid]
            if not match:
                return None
            entry.replicas = [r for r in entry.replicas if r.rid != rid]
            self._update_gauge_locked()
        r = match[0]
        obs.event('serving.replica.drain', model=str(model_id),
                  rid=r.rid, drain=bool(drain), reason=str(reason))
        if drain:
            self._drain_async(r.engine)
        return r.engine

    def models(self):
        with self._lock:
            return {m: {'replicas': len(e.replicas), 'quota': e.quota,
                        'version': e.version, 'path': e.path}
                    for m, e in self._models.items()}

    def _entry(self, model_id):
        try:
            return self._models[model_id]
        except KeyError:
            raise UnknownModel(
                'no model %r (serving %r)'
                % (model_id, sorted(self._models)))

    def _update_gauge_locked(self):
        _G_REPLICAS.set(sum(len(e.replicas)
                            for e in self._models.values()))

    def _drain_async(self, engine):
        """Drain an outgoing engine in the background — the swap()
        cutover machinery, shared by remove_replica and autoscaling:
        queued + in-flight work completes, no future is lost."""
        t = threading.Thread(
            target=lambda e=engine: e.shutdown(drain=True),
            name='router-drain', daemon=True)
        t.start()
        self._drainers.append(t)
        return t

    # -- dispatch ----------------------------------------------------------

    def _refresh_locked(self, entry, now):
        for r in entry.replicas:
            if r.sampled_at is None or now - r.sampled_at >= self._window_s:
                try:
                    r.window = r.engine.stats_window()
                except Exception:
                    r.window = {}
                r.routed_since = 0
                r.sampled_at = now

    def submit(self, model_id, feed, **kwargs):
        """Route one request to the least-loaded replica of `model_id`;
        extra keyword arguments (deadline_ms, timeout, max_new_tokens,
        on_token, ...) pass through to the replica's submit(). Raises
        UnknownModel for an unregistered id and ModelOverloaded when the
        model quota is exhausted or every replica refused.

        Every request is traced: the admission point opens the
        `serving.request` span under the caller's active trace context
        (or a fresh trace), and dispatch runs with that span current."""
        ctx = trace.current()
        if ctx is None:
            ctx = trace.new_trace()
        h = trace.begin('serving.request', ctx=ctx, node='router',
                        model=str(model_id))
        try:
            with trace.activate(h.ctx):
                fut = self._dispatch(model_id, feed, kwargs)
        except Exception as e:
            h.end(error=type(e).__name__)
            raise
        fut.add_done_callback(lambda f, _h=h: _end_request_span(_h, f))
        fut._trace_span = h       # stream() picks the handle up here
        return fut

    def _dispatch(self, model_id, feed, kwargs):
        last_err = None
        # one admission budget for the WHOLE dispatch: trying N blocking
        # replicas in sequence must not multiply the caller's timeout
        t_end = None
        if kwargs.get('timeout') is not None:
            t_end = time.monotonic() + kwargs['timeout']
        for attempt in (0, 1):
            now = time.monotonic()
            with self._lock:
                entry = self._entry(model_id)
                self._refresh_locked(entry, now)
                if entry.quota is not None:
                    outstanding = sum(r.outstanding()
                                      for r in entry.replicas)
                    if outstanding >= entry.quota:
                        _C_OVERLOADED.inc()
                        obs.event('router.overloaded',
                                  model=str(model_id),
                                  outstanding=outstanding,
                                  quota=entry.quota)
                        raise ModelOverloaded(
                            model_id,
                            'model %r admission quota exhausted (%d '
                            'outstanding >= quota %d)'
                            % (model_id, outstanding, entry.quota))
                order = sorted(entry.replicas, key=lambda r: r.score())
            all_closed = True
            fut = picked = bumped = None
            try:
                for r in order:
                    if t_end is not None:
                        kwargs['timeout'] = max(0.0,
                                                t_end - time.monotonic())
                    # bump ONLY the replica being attempted (bumping the
                    # whole order up front inflated outstanding() by N-1
                    # phantoms for the duration of a blocking submit,
                    # spuriously tripping the quota for other callers);
                    # a successful dispatch keeps its bump
                    with self._lock:
                        r.routed_since += 1
                    bumped = r
                    try:
                        fut = r.engine.submit(feed, **kwargs)
                    except (ServerOverloaded, ServerClosed) as e:
                        with self._lock:
                            # max(): a concurrent _refresh_locked may
                            # have reset the counter since the bump
                            r.routed_since = max(0, r.routed_since - 1)
                        bumped = None
                        last_err = e
                        all_closed = (all_closed
                                      and isinstance(e, ServerClosed))
                        continue
                    picked = r
                    break
            finally:
                # an UNEXPECTED submit error (bad feed ValueError, ...)
                # must not leave a phantom routed_since eating the quota
                if bumped is not None and picked is None:
                    with self._lock:
                        bumped.routed_since = max(
                            0, bumped.routed_since - 1)
            if picked is not None:
                _C_ROUTED.inc()
                return fut
            if attempt == 0 and last_err is not None and all_closed:
                # every replica in our snapshot raised ServerClosed: we
                # raced a swap() cutover and held the drained OLD
                # generation — re-resolve entry.replicas once and retry
                # against the warmed-up incoming generation (zero
                # downtime for callers)
                continue
            break
        if last_err is not None and all_closed:
            # still all closed after the re-resolve: the model is DOWN,
            # not overloaded — don't hand retry-forever clients a
            # transient-overload signal for a dead backend
            obs.event('router.closed', model=str(model_id),
                      replicas=len(order))
            raise ServerClosed(
                'every replica of model %r is shut down (last: %s)'
                % (model_id, last_err))
        _C_OVERLOADED.inc()
        obs.event('router.overloaded', model=str(model_id),
                  replicas=len(order))
        raise ModelOverloaded(
            model_id, 'every replica of model %r refused the request '
            '(last: %s)' % (model_id, last_err))

    def predict(self, model_id, feed, timeout=None, **kwargs):
        """Synchronous convenience: one wall-clock budget covering both
        admission and the result wait, with the engines' typed-timeout
        contract (DeadlineExceeded, never a raw TimeoutError; a still-
        queued request is cancelled so it stops holding quota)."""
        t0 = time.monotonic()
        fut = self.submit(model_id, feed, timeout=timeout, **kwargs)
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
                    'queued request was cancelled' % timeout)
            raise DeadlineExceeded(
                'no result within the %.3fs predict() timeout; the '
                'request is already executing — it completes but the '
                'result is discarded' % timeout)

    def stream(self, model_id, feed, **kwargs):
        """Per-token streamed decode through the least-loaded replica:
        returns a `TokenStream` yielding (t, ids) as tokens are generated,
        with `result()` for the final (tokens, scores). Rides the ordinary
        submit() path, the stream's on_token callback in kwargs, so
        admission, quota and overload-retry are those of submit(). TTFT
        is measured end to end: the stream() call to the first token in
        the client's buffer."""
        s = TokenStream(model_id=model_id)
        kwargs['on_token'] = s._on_token
        ctx = trace.current()
        if ctx is None:
            ctx = trace.new_trace()
        with trace.activate(ctx):
            fut = self.submit(model_id, feed, **kwargs)
            obs.event('serving.stream.open', model=str(model_id))
        s._tspan = getattr(fut, '_trace_span', None)
        s._cancel_cb = lambda: self._cancel_request(model_id, s._future)
        s._attach(fut)
        return s

    def _cancel_request(self, model_id, fut):
        """Best-effort cancel of an accepted request: ask each replica
        engine that knows the future (only its owner returns True)."""
        if fut is None:
            return False
        with self._lock:
            engines = [r.engine for r in self._entry(model_id).replicas]
        for e in engines:
            cancel = getattr(e, 'cancel', None)
            if cancel is None:
                continue
            try:
                if cancel(fut):
                    return True
            except Exception:
                pass
        return fut.cancel()

    # -- hot swap ----------------------------------------------------------

    def swap(self, model_id, path, config=None, warmup_feed=None,
             builder=None):
        """Zero-downtime versioned hot-swap: build one NEW replica per
        current replica from the `load_compiled` artifact at `path`, run
        `warmup(warmup_feed)` on each incoming replica (every bucket
        warmed up and captured — the cutover never serves a cold bucket),
        then atomically cut traffic over and drain the old replicas in
        the background (queued + in-flight work completes; no future is
        lost). Admission stays open throughout. Returns the new version
        number.

        `builder(path)` overrides replica construction (e.g. a
        ServingEngine over a Predictor, or a DecodeEngine); the default
        is ServingEngine(load_compiled(path), config or the old replica's
        config), the artifact on the card. Swaps serialize on one
        router-wide lock (a second swap waits, it is not lost), and a
        replica added concurrently via add_replica survives the
        cutover."""
        with self._swap_lock:
            return self._swap_locked(model_id, path, config, warmup_feed,
                                     builder)

    def _swap_locked(self, model_id, path, config, warmup_feed, builder):
        with self._lock:
            entry = self._entry(model_id)
            n, old_replicas = len(entry.replicas), list(entry.replicas)
        if builder is None:
            from .. import inference

            def builder(p):
                cfg = config
                if cfg is None:
                    cfg = getattr(old_replicas[0].engine, 'config', None)
                return ServingEngine(inference.load_compiled(p), cfg)

        incoming = []
        try:
            for _ in range(n):
                eng = builder(path)
                with obs.span('router.swap.warmup', model=str(model_id)):
                    eng.warmup(warmup_feed)
                incoming.append(eng)
        except Exception:
            for eng in incoming:       # half-built generation: tear down
                try:
                    eng.shutdown(drain=False, timeout=5)
                except Exception:
                    pass
            raise
        with self._lock:
            # replace ONLY the snapshotted generation; replicas added
            # concurrently via add_replica keep serving (they are
            # neither drained below nor silently dropped)
            old_set = set(old_replicas)
            kept = [r for r in entry.replicas if r not in old_set]
            entry.replicas = [_Replica(e) for e in incoming] + kept
            entry.version += 1
            entry.path = path
            version = entry.version
            self._update_gauge_locked()
        obs.event('router.swap', model=str(model_id), version=version,
                  replicas=n, path=str(path))
        for old in old_replicas:
            self._drain_async(old.engine)
        return version

    # -- row-delta push ----------------------------------------------------

    def push_deltas(self, model_id, deltas):
        """Push trained row deltas into EVERY live replica of
        `model_id` — the streaming train->serve freshness path:
        `deltas` maps a persistable name to `(row_ids, rows)`, applied
        through each engine's
        `push_rows` (rows written in place into the weights the
        replica's captured graphs read, under its executor's lock).

        Generation discipline: the push holds the router's SWAP lock,
        so it can never interleave a `swap()` cutover — a delta lands
        entirely on one generation, and a swap waits for an in-flight
        push (and vice versa). A push that raced just AHEAD of a swap
        is superseded by the incoming artifact; the publisher's next
        cadence re-freshens the new generation (its pending set only
        clears on success). A replica that is independently shut down
        raises ServerClosed: if
        every replica is closed the typed error propagates (the model
        is down, there is nothing to freshen); a partial failure
        freshens the survivors and reports the failures in the
        router.delta_push event. Typed errors (DeltaUnsupported,
        ValueError on malformed deltas) propagate immediately — they
        mean the push itself is wrong, not the replica.

        Returns the number of replicas updated."""
        from .engine import DeltaUnsupported
        with self._swap_lock:
            with self._lock:
                entry = self._entry(model_id)
                replicas = list(entry.replicas)
                version = entry.version
            pushed, rows, closed = 0, 0, []
            for r in replicas:
                try:
                    rows = r.engine.push_rows(deltas)
                    pushed += 1
                except ServerClosed as e:
                    closed.append(e)
                except (DeltaUnsupported, ValueError, KeyError):
                    raise
            obs.event('router.delta_push', model=str(model_id),
                      version=version, replicas=pushed,
                      closed=len(closed), rows=rows,
                      tables=sorted(str(k) for k in deltas))
            if closed and pushed == 0:
                raise ServerClosed(
                    'every replica of model %r is shut down — no live '
                    'generation to push deltas into (last: %s)'
                    % (model_id, closed[-1]))
            return pushed

    # -- lifecycle ---------------------------------------------------------

    def stats(self):
        """Per-model routing view: replica count, version, and each
        replica's last-sampled window (no reset — the dispatch path owns
        the sampling)."""
        with self._lock:
            return {m: {'version': e.version, 'quota': e.quota,
                        'replicas': [dict(r.window,
                                          routed_since=r.routed_since)
                                     for r in e.replicas]}
                    for m, e in self._models.items()}

    def shutdown(self, drain=True, timeout=None):
        """Shut every replica down (draining by default) and join the
        background drainers from past swaps."""
        with self._lock:
            engines = [r.engine for e in self._models.values()
                       for r in e.replicas]
            drainers = list(self._drainers)
        ok = True
        for e in engines:
            ok = bool(e.shutdown(drain=drain, timeout=timeout)) and ok
        for t in drainers:
            t.join(timeout)
            ok = ok and not t.is_alive()
        return ok

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
        return False
