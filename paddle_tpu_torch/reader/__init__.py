"""Reader decorators. Parity: reference python/paddle/reader/decorator.py
and the JAX package's reader/__init__.py (map_readers :19, shuffle :26,
buffered :111, firstn :135, xmap_readers :149), the port's own copy of the
ones its models and datasets read through."""
import itertools
import random
from queue import Queue
from threading import Condition, Thread

__all__ = ['map_readers', 'shuffle', 'buffered', 'firstn', 'xmap_readers']


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for e in map(func, *rs):
            yield e
    return reader


def shuffle(reader, buf_size):
    """Block shuffle: consume the stream in blocks of up to buf_size
    samples and yield each block in random order (the `random` module's
    generator). buf_size >= dataset size gives a full shuffle."""
    def data_reader():
        it = iter(reader())
        while True:
            block = list(itertools.islice(it, buf_size))
            if not block:
                return
            random.shuffle(block)
            yield from block
    return data_reader


def buffered(reader, size):
    """Decouple production from consumption: a daemon thread runs the
    source reader up to `size` samples ahead of the consumer; a source
    error is raised at the consumer."""
    def data_reader():
        done = object()
        q = Queue(maxsize=size)
        failure = []

        def pump():
            try:
                for sample in reader():
                    q.put(sample)
            except BaseException as e:   # re-raised at the consumer
                failure.append(e)
            finally:
                q.put(done)

        Thread(target=pump, daemon=True).start()
        yield from iter(q.get, done)
        if failure:
            raise failure[0]
    return data_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item
    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool map over a reader. A feeder thread enumerates the source
    into a bounded feed queue as (seq, sample); process_num workers apply
    `mapper` and push results to a bounded output queue. With order=True a
    Condition holds each push until the worker's seq is next. A mapper or
    source exception is raised at the consumer instead of hanging the
    stream."""
    def xreader():
        stop = object()
        feed_q = Queue(buffer_size)
        out_q = Queue(buffer_size)
        turn = Condition()
        state = {'next_seq': 0, 'error': None}

        def feeder():
            try:
                for item in enumerate(reader()):
                    feed_q.put(item)
            except BaseException as e:   # source errors forward too
                with turn:
                    state['error'] = e
                    turn.notify_all()
            finally:
                for _ in range(process_num):
                    feed_q.put(stop)

        def worker():
            while True:
                item = feed_q.get()
                if item is stop:
                    out_q.put(stop)
                    return
                seq, sample = item
                try:
                    result = mapper(sample)
                except BaseException as e:   # forwarded, not swallowed
                    with turn:
                        state['error'] = e
                        turn.notify_all()
                    out_q.put(stop)
                    return
                if order:
                    with turn:
                        turn.wait_for(
                            lambda: state['next_seq'] == seq
                            or state['error'] is not None)
                        if state['error'] is not None:
                            out_q.put(stop)
                            return
                        out_q.put(result)
                        state['next_seq'] += 1
                        turn.notify_all()
                else:
                    out_q.put(result)

        Thread(target=feeder, daemon=True).start()
        for _ in range(process_num):
            Thread(target=worker, daemon=True).start()

        # every worker flushes its results before its stop marker, so the
        # stream is complete once all process_num markers are seen
        finished = 0
        while finished < process_num:
            item = out_q.get()
            if item is stop:
                finished += 1
                if state['error'] is not None:
                    raise state['error']
            else:
                yield item
    return xreader
