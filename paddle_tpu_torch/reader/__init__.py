"""Reader decorators. Parity: reference python/paddle/reader/decorator.py;
the port's own copy of the JAX package's reader/__init__.py (stdlib
only), with its submodules pipeline (prefetch, bundle), creator
(np_array, text_file, recordio), decorator and recordio (the record file
writer and readers; the scanner is native C++, utils/native.py)."""
import itertools
import random
from queue import Queue
from threading import Condition, Thread

__all__ = [
    'map_readers', 'buffered', 'compose', 'chain', 'shuffle',
    'ComposeNotAligned', 'firstn', 'xmap_readers', 'Fake', 'cache',
    'PipeReader', 'fault_tolerant', 'shard',
]

from . import pipeline  # noqa: F401
from . import creator  # noqa: F401
from . import recordio  # noqa: F401


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for e in map(func, *rs):
            yield e
    return reader


def shuffle(reader, buf_size):
    """Block shuffle: consume the stream in blocks of up to buf_size
    samples and yield each block in random order. buf_size >= dataset
    size gives a full shuffle; smaller sizes trade memory for locality."""
    def data_reader():
        it = iter(reader())
        while True:
            block = list(itertools.islice(it, buf_size))
            if not block:
                return
            random.shuffle(block)
            yield from block
    return data_reader


def shard(reader, num_shards, shard_id):
    """Per-host reader sharding for the multi-process GSPMD runtime
    (docs/parallel.md): host `shard_id` of `num_shards` sees every
    num_shards-th sample (round-robin by stream index), so the hosts'
    slices partition the stream without coordination and — batched with
    the same batch size — reassemble into the global batch the Executor
    builds via `parallel.global_batch`. Deterministic over a
    deterministic source; compose as
    ``paddle.batch(reader.shard(base, n_hosts, host_id), bs_per_host)``.

    Samples beyond the last complete round are DROPPED (not yielded to
    any shard): an uneven tail would give the hosts different step
    counts, deadlocking the collective at the shorter host's last step.
    """
    num_shards = int(num_shards)
    shard_id = int(shard_id)
    if num_shards < 1:
        raise ValueError('num_shards must be >= 1, got %d' % num_shards)
    if not 0 <= shard_id < num_shards:
        raise ValueError('shard_id %d out of range for %d shard(s)'
                         % (shard_id, num_shards))

    def sharded_reader():
        it = iter(reader())
        while True:
            block = list(itertools.islice(it, num_shards))
            if len(block) < num_shards:
                return   # incomplete round: dropped on every host
            yield block[shard_id]
    return sharded_reader


def chain(*readers):
    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e
    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip several readers into one, concatenating their samples into a
    flat tuple per step. With check_alignment (default), a reader ending
    before the others raises ComposeNotAligned; without it, the stream
    silently stops at the shortest reader."""
    check_alignment = kwargs.pop('check_alignment', True)
    _missing = object()

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
            return
        for outputs in itertools.zip_longest(*rs, fillvalue=_missing):
            if any(o is _missing for o in outputs):
                raise ComposeNotAligned(
                    "outputs of composed readers are not aligned: one "
                    "reader ended before the others")
            yield sum(map(make_tuple, outputs), ())
    return reader


def buffered(reader, size):
    """Decouple production from consumption: a daemon thread runs the
    source reader up to `size` samples ahead of the consumer."""
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


class XmapEndSignal():
    """Kept for API compat with code that imported it; the pool below uses
    private sentinels."""


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool map over a reader (API parity with the reference's
    xmap_readers; the pool itself is a from-scratch design).

    A feeder thread enumerates the source into a bounded feed queue as
    (seq, sample); process_num workers apply `mapper` concurrently and
    push results to a bounded output queue. With order=True a Condition
    gates each push until the worker's seq is next — workers sleep on the
    condition rather than spinning, so a slow mapper never busy-waits the
    (single-core) host. A mapper exception is forwarded to the consumer
    and re-raised there instead of hanging the stream."""
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


def fault_tolerant(reader, max_retries=3, retry_on=(IOError, OSError),
                   base_delay=0.05, max_delay=2.0, seed=None,
                   sleep=None):
    """Make a reader survive transient source failures (flaky NFS / GCS /
    preempted sidecar): when iterating the stream raises a `retry_on`
    exception, the source reader is re-opened (with utils.retry's
    exponential-backoff schedule) and fast-forwarded past the samples
    already emitted, so the consumer sees no duplicates and no gaps.
    After `max_retries` re-opens the stream DEGRADES instead of dying: a
    loud RuntimeWarning reports how many samples were delivered and the
    epoch ends early — a multi-hour training job keeps its progress and
    checkpoints rather than crashing on a bad input shard.

    REQUIRES a deterministic source: the fast-forward skips the first
    `emitted` samples of the re-opened stream by INDEX, which only
    reproduces the already-delivered prefix if the reader yields the same
    order every time. Wrap the deterministic base reader and put
    nondeterministic decorators (shuffle) OUTSIDE:
    `shuffle(fault_tolerant(base), buf)` — wrapping `shuffle` itself
    would silently duplicate/drop samples across a retry.

    sleep is injectable for tests (None = time.sleep).

    Telemetry (docs/observability.md): every source re-open bumps the
    reader.retries counter and records a reader.retry event; a degrade
    bumps reader.degraded and records reader.degrade with how many
    samples survived; per-sample production latency feeds the
    reader.batch.seconds histogram — a slow input pipeline shows up in
    obs_report next to the step times it is starving."""
    import time as _time
    import warnings

    from .. import obs
    from ..utils.retry import backoff_delays

    def fault_tolerant_reader():
        emitted = 0
        delays = backoff_delays(max_retries, base_delay=base_delay,
                                max_delay=max_delay, seed=seed)
        do_sleep = _time.sleep if sleep is None else sleep
        latency = obs.histogram('reader.batch.seconds')
        while True:
            try:
                src = enumerate(reader())
                while True:
                    t0 = _time.perf_counter()
                    try:
                        i, sample = next(src)
                    except StopIteration:
                        return
                    if i < emitted:
                        continue  # fast-forward past a replayed prefix
                    # observed only for DELIVERED samples: replayed
                    # prefixes (usually page-cache fast) would skew the
                    # latency histogram low after a retry
                    latency.observe(_time.perf_counter() - t0)
                    yield sample
                    emitted += 1
            except retry_on as e:
                delay = next(delays, None)
                if delay is None:
                    obs.counter('reader.degraded').inc()
                    obs.event('reader.degrade', emitted=emitted,
                              attempts=max_retries + 1, error=repr(e))
                    warnings.warn(
                        'fault_tolerant reader: source failed %d times '
                        '(last: %r); degrading to skip — stream ends '
                        'after %d sample(s) instead of raising'
                        % (max_retries + 1, e, emitted), RuntimeWarning)
                    return
                obs.counter('reader.retries').inc()
                obs.event('reader.retry', emitted=emitted,
                          delay_s=delay, error=repr(e))
                do_sleep(delay)

    return fault_tolerant_reader


def cache(reader):
    all_data = []

    def __impl__():
        if not all_data:
            for d in reader():
                all_data.append(d)
                yield d
        else:
            for d in all_data:
                yield d
    return __impl__


class PipeReader(object):
    """Stream data from a shell command's stdout (reference
    decorator.py:PipeReader) — e.g. ``hadoop fs -cat ...``, ``curl ...``.
    file_type 'gzip' transparently inflates; get_line() yields decoded
    lines (or raw buffers with cut_lines=False). Unlike the reference,
    commands are shlex-split (quoted paths with spaces work), multi-byte
    characters may straddle buffer boundaries, a failing command raises
    instead of silently truncating the dataset, and abandoning the
    generator early terminates the child (no leaked processes)."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        import shlex
        import subprocess
        import zlib
        if not isinstance(command, str):
            raise TypeError("command must be a string")
        if file_type not in ("plain", "gzip"):
            raise TypeError("file_type %s is not allowed" % file_type)
        self.command = command
        self.file_type = file_type
        if file_type == "gzip":
            # wbits offset 32: auto-detect the gzip header
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        self.bufsize = bufsize
        self.process = subprocess.Popen(
            shlex.split(command), bufsize=bufsize, stdout=subprocess.PIPE)

    def close(self):
        """Terminate + reap the child (idempotent; safe mid-stream)."""
        p = self.process
        if p.poll() is None:
            p.terminate()
        if p.stdout is not None:
            p.stdout.close()
        p.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def get_line(self, cut_lines=True, line_break="\n"):
        import codecs
        decoder = codecs.getincrementaldecoder('utf-8')()
        remained = ""
        finished = False
        try:
            while True:
                buff = self.process.stdout.read(self.bufsize)
                if buff:
                    if self.file_type == "gzip":
                        buff = self.dec.decompress(buff)
                    # incremental: multi-byte chars may straddle chunks
                    decomp_buff = decoder.decode(buff)
                    if cut_lines:
                        lines = decomp_buff.split(line_break)
                        lines[0] = remained + lines[0]
                        remained = lines.pop()  # possibly-partial tail
                        for line in lines:
                            yield line
                    else:
                        if decomp_buff:
                            yield decomp_buff
                else:
                    remained += decoder.decode(b'', final=True)
                    if remained:
                        yield remained
                    finished = True
                    break
        finally:
            if finished:
                rc = self.process.wait()
                if rc != 0:
                    raise IOError(
                        "PipeReader command %r exited with %d — dataset "
                        "stream is incomplete" % (self.command, rc))
            else:
                self.close()  # consumer abandoned the stream


class Fake(object):
    """Cache the first sample and replay it n times (reference
    decorator.py:Fake) — for IO-free benchmarking."""

    def __init__(self):
        self.data = None
        self.yield_num = 0

    def _read_into_memory(self, reader):
        self.data = next(reader())

    def __call__(self, reader, n):
        def fake_reader():
            if self.data is None:
                self._read_into_memory(reader)
            while self.yield_num < n:
                yield self.data
                self.yield_num += 1
            self.yield_num = 0
        return fake_reader
