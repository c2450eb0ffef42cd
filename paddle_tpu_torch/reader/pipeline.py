"""Background prefetch pipeline.

The port's counterpart of the reference's C++ double_buffer reader
(paddle/fluid/operators/reader/create_double_buffer_reader_op.cc) and
the JAX package's reader/pipeline.py: a daemon thread stages upcoming
batches so the step never waits on host IO.

Contract (tests/test_torch_reader.py holds it against the JAX package):
  * a reader exception is RE-RAISED in the consumer — not swallowed into
    a silent short epoch;
  * a consumer that stops early (break, generator close) unblocks the
    worker thread, which would otherwise sit in q.put forever;
  * `transform` runs in the worker thread — the hook for feed staging
    (DataFeeder.feed, then Executor._place_feed: the feed coerced into
    pinned host memory), so that cost overlaps the consumer's step. `bundle` groups batches
    into the K-step lists Executor.run_bundle consumes.
"""
import sys
from queue import Empty, Full, Queue
from threading import Event, Thread

__all__ = ['prefetch', 'bundle']

_END = object()
# how long the worker's q.put may block before re-checking whether the
# consumer has gone away (early break/close sets the stop event)
_PUT_POLL_S = 0.05


class _WorkerError(object):
    """Carries the worker's exc_info across the queue so the consumer
    re-raises the ORIGINAL exception with its traceback."""

    __slots__ = ('exc_info',)

    def __init__(self, exc_info):
        self.exc_info = exc_info


def prefetch(reader, depth=2, transform=None):
    """Wrap a generator-factory with an N-deep background prefetch queue.

    transform(item), when given, runs IN THE WORKER THREAD on every item
    before it is queued — e.g. a DataFeeder.feed and Executor._place_feed
    composition stages upcoming batches while the previous step still
    runs (Trainer(double_buffer=True) does so)."""

    def wrapped():
        q = Queue(maxsize=depth)
        stop = Event()

        def _put(item):
            """Blocking put that gives up when the consumer is gone.
            Returns False when the stop event fired first."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=_PUT_POLL_S)
                    return True
                except Full:
                    continue
            return False

        def worker():
            try:
                for item in reader():
                    if transform is not None:
                        item = transform(item)
                    if not _put(item):
                        return
            except BaseException:
                # propagate to the consumer — the old `finally: put(_END)`
                # shape turned a reader crash into a silent short epoch
                _put(_WorkerError(sys.exc_info()))
                return
            _put(_END)

        t = Thread(target=worker)
        t.daemon = True
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, _WorkerError):
                    _tp, exc, tb = item.exc_info
                    raise exc.with_traceback(tb)
                yield item
        finally:
            # consumer done (exhausted, break, or close()): release the
            # worker — set the stop flag, then drain so a put blocked
            # between polls returns immediately
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except Empty:
                pass

    return wrapped


def bundle(reader, steps, drop_last=False):
    """Group a batch reader into lists of `steps` consecutive batches —
    the per-step feed lists `Executor.run_bundle` / a
    `Trainer(bundle_steps=K)` loop consume. The final short group is
    yielded unless drop_last (a short group still runs; it just compiles
    its own scan length once)."""
    if steps < 1:
        raise ValueError('bundle steps must be >= 1, got %r' % (steps,))

    def wrapped():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == steps:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return wrapped
