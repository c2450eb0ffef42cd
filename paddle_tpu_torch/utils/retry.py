"""Retry/backoff primitives for transient-failure tolerance.

The port's own copy of the JAX package's utils/retry.py (stdlib only):
the reader fault-tolerance decorator (paddle_tpu_torch.reader.
fault_tolerant) re-opens its source on this schedule. One implementation
so every retry has the same shape: bounded attempts, exponential backoff
with DETERMINISTIC (seedable) jitter, and an optional wall-clock deadline
— a long-running training job must never spin forever on a dead
filesystem, and a seeded fault-injection test must see the exact same
retry schedule on every run.
"""
import random
import time

__all__ = ['RetryError', 'backoff_delays', 'retry_call', 'retrying']


class RetryError(RuntimeError):
    """All attempts failed (or the deadline expired). `last_exception`
    carries the final underlying error; it is also chained as __cause__."""

    def __init__(self, message, last_exception=None, attempts=0):
        super(RetryError, self).__init__(message)
        self.last_exception = last_exception
        self.attempts = attempts


def backoff_delays(retries, base_delay=0.1, factor=2.0, max_delay=30.0,
                   jitter=0.5, seed=None):
    """Yield `retries` sleep durations: base * factor**i, capped at
    max_delay, each multiplied by a jitter factor drawn uniformly from
    [1 - jitter, 1 + jitter]. With a seed the sequence is reproducible
    (the fault-injection tests assert on it)."""
    if not 0.0 <= jitter <= 1.0:
        raise ValueError('jitter must be in [0, 1], got %r' % (jitter,))
    rng = random.Random(seed)
    for i in range(retries):
        d = min(base_delay * (factor ** i), max_delay)
        if jitter:
            d *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
        yield max(d, 0.0)


def _obs():
    # Lazy: the success path pays nothing, and utils.retry stays
    # importable standalone (paddle_tpu_torch.obs is stdlib-only at import).
    from .. import obs
    return obs


def retry_call(fn, args=(), kwargs=None, retries=3, base_delay=0.1,
               factor=2.0, max_delay=30.0, jitter=0.5, deadline=None,
               retry_on=(OSError, IOError), seed=None, sleep=time.sleep,
               on_retry=None, describe=None, site=None):
    """Call fn(*args, **kwargs), retrying on `retry_on` exceptions.

    retries:   additional attempts after the first (so retries=3 means at
               most 4 calls).
    deadline:  wall-clock budget in seconds measured from the first call;
               once spent, no further attempt is made and RetryError
               raises immediately (a bounded-time guarantee the backoff
               schedule alone cannot give).
    sleep:     injectable for tests (the fault suite passes a recorder so
               no real time is spent).
    on_retry:  on_retry(attempt_index, exception, delay) observer hook.
    site:      LOW-CARDINALITY call-site tag for telemetry — the
               retry.attempts / retry.backoff.seconds /
               retry.deadline_exceeded / retry.exhausted counters are
               labeled with it (docs/observability.md). Unlike
               `describe`, which may embed paths, `site` must be a stable
               name like 'checkpoint.write_shard'. Defaults to the
               callable's __name__.
    Raises RetryError (chaining the last exception) when attempts or the
    deadline are exhausted. Non-retryable exceptions propagate untouched.
    A first-try success records no telemetry at all.
    """
    kwargs = kwargs or {}
    t0 = time.monotonic()
    delays = backoff_delays(retries, base_delay=base_delay, factor=factor,
                            max_delay=max_delay, jitter=jitter, seed=seed)
    last = None
    attempts = 0
    site = site or getattr(fn, '__name__', 'call')
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            last = e
            attempts = attempt + 1
            delay = next(delays, None)
            if delay is None:
                break
            if deadline is not None \
                    and time.monotonic() - t0 + delay > deadline:
                obs = _obs()
                obs.counter('retry.deadline_exceeded', site=site).inc()
                obs.event('retry.deadline_exceeded', site=site,
                          attempts=attempts, deadline_s=deadline,
                          error=repr(e))
                raise RetryError(
                    '%s: deadline of %.3fs would be exceeded after %d '
                    'attempt(s): %r'
                    % (describe or getattr(fn, '__name__', 'call'),
                       deadline, attempts, e),
                    last_exception=e, attempts=attempts) from e
            obs = _obs()
            obs.counter('retry.attempts', site=site).inc()
            obs.counter('retry.backoff.seconds', site=site).inc(delay)
            obs.event('retry.attempt', site=site, attempt=attempt,
                      delay_s=delay, error=repr(e))
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
    obs = _obs()
    obs.counter('retry.exhausted', site=site).inc()
    obs.event('retry.exhausted', site=site, attempts=attempts,
              error=repr(last))
    raise RetryError(
        '%s: all %d attempt(s) failed: %r'
        % (describe or getattr(fn, '__name__', 'call'), attempts, last),
        last_exception=last, attempts=attempts) from last


def retrying(**cfg):
    """Decorator form of retry_call:

        @retrying(retries=5, retry_on=(IOError,), seed=0)
        def fetch(...): ...
    """
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, args=args, kwargs=kwargs, **cfg)
        return wrapper
    return deco
