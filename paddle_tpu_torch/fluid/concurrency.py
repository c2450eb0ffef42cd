"""Go-style CSP primitives: channels, send/recv, select, goroutines.

Parity: the JAX package's fluid/concurrency.py and the reference
python/paddle/fluid/concurrency.py (make_channel, channel_send,
channel_recv, channel_close, Select; Go). The reference lowers these to C++
channel ops run by concurrent scope threads inside the Fluid program, a
model that maps onto no captured step, and which the reference itself
retired soon after v0.14.

As in the JAX package, channels here are HOST-side pipeline primitives
(thread-safe rendezvous or buffered queues) for composing data producers,
prefetchers and trainers around the step, kept out of the step itself.
`Go` runs a Python callable on a daemon thread; `Select` blocks on the
first ready case, Go-style.
"""
import queue
import threading

__all__ = [
    'Go', 'make_channel', 'channel_send', 'channel_recv', 'channel_close',
    'Select'
]

_CLOSED = object()


class Channel(object):
    """Typed FIFO channel. capacity=0 gives Go's unbuffered rendezvous
    (send blocks until a receiver takes the value)."""

    def __init__(self, dtype=None, capacity=0):
        self.dtype = dtype
        self.capacity = capacity
        # rendezvous: a 1-slot queue + handshake event per send
        self._q = queue.Queue(maxsize=capacity if capacity > 0 else 1)
        self._unbuffered = capacity == 0
        self._closed = threading.Event()
        self._taken = threading.Condition()
        self._pending = 0

    def send(self, value):
        if self._closed.is_set():
            return False
        with self._taken:
            self._pending += 1
        self._q.put(value)
        if self._unbuffered:
            with self._taken:
                while self._pending > 0 and not self._closed.is_set():
                    self._taken.wait(timeout=0.05)
        return not self._closed.is_set()

    def recv(self):
        while True:
            try:
                v = self._q.get(timeout=0.05)
                with self._taken:
                    self._pending -= 1
                    self._taken.notify_all()
                if v is _CLOSED:
                    self._q.put(_CLOSED)  # keep draining receivers unblocked
                    return None, False
                return v, True
            except queue.Empty:
                if self._closed.is_set():
                    return None, False

    def poll(self):
        """Non-blocking readiness check for Select."""
        return not self._q.empty() or self._closed.is_set()

    def close(self):
        self._closed.set()
        try:
            self._q.put_nowait(_CLOSED)
        except queue.Full:
            pass
        with self._taken:
            self._taken.notify_all()


def make_channel(dtype, capacity=0):
    return Channel(dtype=dtype, capacity=capacity)


def channel_send(channel, value, is_copy=False):
    if is_copy:
        import copy as _copy
        value = _copy.deepcopy(value)
    return channel.send(value)


def channel_recv(channel, return_value=None):
    value, ok = channel.recv()
    if not ok:
        return return_value, False
    return value, True


def channel_close(channel):
    channel.close()


class Go(object):
    """Run `target(*args)` concurrently (reference Go block -> goroutine).

    Usage::

        with Go() as g:
            g.run(producer, ch)
    or  Go(target=producer, args=(ch,)).start()
    """

    def __init__(self, target=None, args=(), name=None):
        self._threads = []
        if target is not None:
            self.run(target, *args)

    def run(self, target, *args, **kwargs):
        t = threading.Thread(target=target, args=args, kwargs=kwargs)
        t.daemon = True
        t.start()
        self._threads.append(t)
        return t

    def start(self):
        return self

    def join(self, timeout=None):
        for t in self._threads:
            t.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Select(object):
    """Block until one case is ready, then run its body (reference Select).

    Cases are (channel, 'recv'|'send', value_or_callback)::

        sel = Select()
        sel.case(ch_a, 'recv', on_a)          # on_a(value)
        sel.case(ch_b, 'send', 42, on_sent)   # optional post-send callback
        sel.default(on_idle)                  # optional, makes it non-blocking
        idx = sel()                           # index of the fired case
    """

    def __init__(self, name=None):
        self._cases = []
        self._default = None

    def case(self, channel, action, *payload):
        if action not in ('recv', 'send'):
            raise ValueError("Select case action must be 'recv' or 'send'")
        self._cases.append((channel, action, payload))
        return self

    def default(self, callback=None):
        self._default = callback or (lambda: None)
        return self

    def __call__(self, timeout=None):
        import time
        deadline = None if timeout is None else time.time() + timeout
        while True:
            for i, (ch, action, payload) in enumerate(self._cases):
                if action == 'recv':
                    if ch.poll():
                        v, ok = ch.recv()
                        if payload and callable(payload[0]):
                            payload[0](v) if ok else None
                        return i
                else:  # send
                    if not ch._q.full() and not ch._closed.is_set():
                        ch.send(payload[0])
                        if len(payload) > 1 and callable(payload[1]):
                            payload[1]()
                        return i
            if self._default is not None:
                self._default()
                return -1
            if deadline is not None and time.time() > deadline:
                raise TimeoutError('Select timed out')
            time.sleep(0.001)
