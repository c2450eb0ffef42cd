"""Deterministic fault injection for the robustness test suite.

Every fault-tolerance behavior in the runtime — NaN-step skip (executor
anomaly guard), checkpoint CRC fallback, reader retry-then-degrade,
preemption-safe Trainer shutdown — is TESTED through this harness rather
than asserted in prose. All randomness flows from one seeded RandomState,
so a failing fault drill reproduces bit-for-bit from its seed.

The injectors deliberately operate at the host boundary (file bytes,
Python callables, OS signals, feed batches, sockets): the captured step
stays the same with and without the harness, so the tests exercise the
SAME code paths production hits.

Parity: the JAX package's utils/faults.py, copied as it is (numpy and the
stdlib only): the same seed makes the same faults in both packages.
"""
import os
import signal
import socket
import threading
import time

import numpy as np

__all__ = ['ChaosProxy', 'FaultInjector', 'send_preemption']


def send_preemption(sig=signal.SIGTERM, pid=None):
    """Deliver a preemption signal to this process (default SIGTERM — what
    a VM maintenance event or k8s eviction sends). The Trainer's
    preemption handler finishes the in-flight step, flushes an emergency
    checkpoint, and returns from train() cleanly."""
    os.kill(os.getpid() if pid is None else pid, sig)


class FaultInjector(object):
    """Seeded source of faults. One instance per test; every choice
    (which byte to flip, which call to fail, where to poison) derives from
    `seed`, so drills are reproducible."""

    def __init__(self, seed=0):
        self.seed = int(seed)
        self.rng = np.random.RandomState(self.seed)

    # -- callable faults ---------------------------------------------------

    def flaky(self, fn, fail_times=1, exc_factory=None):
        """Wrap fn to raise on its first `fail_times` calls, then succeed.
        Models transient I/O: the retry layer should absorb exactly
        `fail_times` failures."""
        if exc_factory is None:
            exc_factory = lambda i: IOError('injected transient failure #%d'
                                            % (i + 1))
        state = {'calls': 0}

        def wrapper(*args, **kwargs):
            i = state['calls']
            state['calls'] += 1
            if i < fail_times:
                raise exc_factory(i)
            return fn(*args, **kwargs)

        wrapper.calls = lambda: state['calls']
        return wrapper

    def flaky_reader(self, reader, fail_at, fail_times=1, exc_factory=None):
        """Decorate a paddle-style reader creator: each of the first
        `fail_times` iterations raises just before yielding sample index
        `fail_at`. With reader.fault_tolerant around it, the
        stream should heal without duplicating or dropping samples (until
        retries are exhausted, when it degrades to skip-with-warning)."""
        if exc_factory is None:
            exc_factory = lambda i: IOError('injected reader failure #%d'
                                            % (i + 1))
        state = {'iters': 0}

        def creator():
            it = state['iters']
            state['iters'] += 1
            def gen():
                for i, sample in enumerate(reader()):
                    if it < fail_times and i == fail_at:
                        raise exc_factory(it)
                    yield sample
            return gen()

        return creator

    # -- numeric faults ----------------------------------------------------

    def poison_nan(self, batch, rate=1.0):
        """Return a copy of a feed batch (ndarray, or nested list/tuple/
        dict of ndarrays) with a seeded fraction of float entries replaced
        by NaN — the canonical way to force an unhealthy training step
        through the REAL compiled path (the NaN propagates into loss and
        gradients; the anomaly guard must skip the step)."""
        if isinstance(batch, dict):
            return {k: self.poison_nan(v, rate) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self.poison_nan(v, rate) for v in batch)
        arr = np.array(batch, copy=True)
        if not np.issubdtype(arr.dtype, np.floating):
            return arr
        mask = self.rng.rand(*arr.shape) < rate if arr.shape else \
            np.asarray(self.rng.rand() < rate)
        flat = arr.reshape(-1)
        flat[np.asarray(mask).reshape(-1)] = np.nan
        return flat.reshape(arr.shape)

    # -- file faults -------------------------------------------------------

    def truncate_file(self, path, keep_fraction=None, keep_bytes=None):
        """Truncate a file in place (a torn write / crashed writer). By
        default keeps a seeded fraction in [0.25, 0.75) of the bytes."""
        size = os.path.getsize(path)
        if keep_bytes is None:
            frac = (0.25 + 0.5 * self.rng.rand()) if keep_fraction is None \
                else keep_fraction
            keep_bytes = int(size * frac)
        keep_bytes = max(0, min(size - 1, keep_bytes))
        with open(path, 'r+b') as f:
            f.truncate(keep_bytes)
        return keep_bytes

    def corrupt_file(self, path, n_bytes=4):
        """Flip `n_bytes` seeded bytes in place WITHOUT changing the file
        size — the case only a content checksum (manifest CRC32) catches;
        a size check alone passes."""
        size = os.path.getsize(path)
        offsets = self.rng.randint(0, size, size=n_bytes)
        with open(path, 'r+b') as f:
            for off in offsets:
                f.seek(int(off))
                b = f.read(1)
                f.seek(int(off))
                f.write(bytes([b[0] ^ 0xFF]))
        return sorted(int(o) for o in offsets)

    def pick_file(self, directory, suffix='.npy'):
        """Seeded choice of one file (sorted listing, so the same seed
        picks the same shard on every run)."""
        names = sorted(n for n in os.listdir(directory)
                       if n.endswith(suffix))
        if not names:
            raise ValueError('no %r files under %r' % (suffix, directory))
        return os.path.join(directory, names[self.rng.randint(len(names))])

    # -- checkpoint faults -------------------------------------------------

    def torn_checkpoint(self, ckpt_dir, what=None):
        """Tear a sharded checkpoint dir the way a crash mid-save (or
        bit rot after it) would, for the elastic drills:

          'drop_manifest'     — delete manifest.json (+ its .sum): the
                                serial can never verify;
          'truncate_manifest' — cut the manifest short (a torn write the
                                .sum sidecar exposes as a typed failure);
          'corrupt_manifest'  — same-size bit rot in the manifest (only
                                the sidecar CRC catches it);
          'drop_shard'        — delete one seeded shard file;
          'truncate_shard'    — truncate one seeded shard file.

        Default: a seeded choice among all five. Returns (what, path)."""
        modes = ('drop_manifest', 'truncate_manifest', 'corrupt_manifest',
                 'drop_shard', 'truncate_shard')
        if what is None:
            what = modes[self.rng.randint(len(modes))]
        if what not in modes:
            raise ValueError('unknown torn_checkpoint mode %r (one of %s)'
                             % (what, modes))
        if what.endswith('_manifest'):
            path = os.path.join(ckpt_dir, 'manifest.json')
            if what == 'drop_manifest':
                os.remove(path)
                for side in (path + '.sum',):
                    if os.path.exists(side):
                        os.remove(side)
            elif what == 'truncate_manifest':
                self.truncate_file(path)
            else:
                self.corrupt_file(path)
            return what, path
        path = self.pick_file(ckpt_dir, suffix='.npy')
        if what == 'drop_shard':
            os.remove(path)
        else:
            self.truncate_file(path)
        return what, path

    # -- network faults ----------------------------------------------------

    def chaos_proxy(self, target):
        """Stand a `ChaosProxy` between a client and `target` ('host',
        port): traffic forwards transparently until the test calls
        sever()/delay()/garble(). Byte choices for garbling come from
        this injector's seeded RNG, so a corrupted-frame drill
        reproduces bit-for-bit. Point the client at `proxy.addr`."""
        return ChaosProxy(target, rng=self.rng)

    # -- process faults ----------------------------------------------------

    def preempt(self, sig=signal.SIGTERM):
        """Simulated preemption of THIS process (see send_preemption)."""
        send_preemption(sig)

    def kill_process(self, proc, sig=signal.SIGKILL):
        """SIGKILL a child process mid-step — the host-failure fault: no
        handlers run, no flush happens, beats stop. `proc` is a
        subprocess.Popen (or anything with .pid) or a raw pid. Returns
        the pid killed."""
        pid = int(getattr(proc, 'pid', proc))
        if pid == os.getpid():
            raise ValueError(
                'kill_process targets a CHILD (SIGKILL to self would '
                'take the test runner down); use preempt() for '
                'self-delivered signals')
        os.kill(pid, sig)
        return pid


class ChaosProxy(object):
    """A TCP forwarding proxy that misbehaves ON COMMAND — the network-
    fault primitive for the RPC pod-wire drills (serving/transport.py).
    Listens on an ephemeral local port; each accepted client connection
    is paired with a fresh connection to the real target and pumped in
    both directions until a fault is injected:

      sever()       close every live pairing mid-stream (the client
                    sees a reset/EOF; its Channel must reconnect — a
                    NEW pairing through the proxy works again);
      delay(s)      sleep `s` seconds before forwarding each chunk
                    (latency, not loss — nothing may time out wrongly);
      garble(n=8)   corrupt `n` seeded bytes of the NEXT forwarded
                    chunk (a torn/garbled frame: the reader must fail
                    typed, never hang); direction= picks which half of
                    the wire rots — 'up' (client->server), 'down'
                    (server->client), or 'both'.

    Faults are one-shot where that is the honest physics (garble) and
    latching where it is (delay persists until delay(0)). The proxy is
    deliberately L4-dumb: it never parses frames, so it cannot
    accidentally re-align a corrupted stream."""

    def __init__(self, target, rng=None):
        self.target = (str(target[0]), int(target[1]))
        self._rng = rng if rng is not None else np.random.RandomState(0)
        self._delay_s = 0.0
        self._garble = {'up': 0, 'down': 0}
        self._lock = threading.Lock()
        self._closed = False
        self._pairs = []          # [(client_sock, upstream_sock), ...]
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(('127.0.0.1', 0))
        self._sock.listen(16)
        self.addr = self._sock.getsockname()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name='chaos-proxy', daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                client, _ = self._sock.accept()
            except OSError:
                return
            try:
                upstream = socket.create_connection(self.target,
                                                    timeout=2.0)
                upstream.settimeout(None)
            except OSError:
                client.close()
                continue
            with self._lock:
                if self._closed:
                    client.close()
                    upstream.close()
                    return
                self._pairs.append((client, upstream))
            for src, dst, way in ((client, upstream, 'up'),
                                  (upstream, client, 'down')):
                t = threading.Thread(target=self._pump,
                                     args=(src, dst, way),
                                     name='chaos-pump', daemon=True)
                t.start()

    def _pump(self, src, dst, way):
        while True:
            try:
                chunk = src.recv(65536)
            except OSError:
                break
            if not chunk:
                break
            d = self._delay_s
            if d > 0:
                time.sleep(d)
            with self._lock:
                n = self._garble[way]
                if n and chunk:
                    buf = bytearray(chunk)
                    offs = self._rng.randint(0, len(buf),
                                             size=min(n, len(buf)))
                    for off in offs:
                        buf[int(off)] ^= 0xFF
                    chunk = bytes(buf)
                    self._garble[way] = 0
            try:
                dst.sendall(chunk)
            except OSError:
                break
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass

    def sever(self):
        """Cut every live pairing NOW (mid-stream, not at a frame
        boundary). New connections still pair up — this is a network
        blip, not a dead host."""
        with self._lock:
            pairs, self._pairs = self._pairs, []
        for client, upstream in pairs:
            for s in (client, upstream):
                try:
                    s.close()
                except OSError:
                    pass

    def delay(self, seconds):
        """Latch `seconds` of added one-way latency per forwarded
        chunk; delay(0) restores normal forwarding."""
        self._delay_s = float(seconds)

    def garble(self, n_bytes=8, direction='both'):
        """Corrupt `n_bytes` seeded bytes of the next forwarded chunk —
        the in-flight-frame bit-rot case only the frame codec's typed
        failure catches. `direction` aims the rot: 'up' hits the next
        client->server chunk (the server's reader fails typed and drops
        the connection), 'down' the next server->client chunk (the
        client Channel surfaces a typed TransportError), 'both' arms
        each half once."""
        if direction not in ('up', 'down', 'both'):
            raise ValueError("direction must be 'up', 'down' or 'both'")
        with self._lock:
            if direction in ('up', 'both'):
                self._garble['up'] = int(n_bytes)
            if direction in ('down', 'both'):
                self._garble['down'] = int(n_bytes)

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        self.sever()
