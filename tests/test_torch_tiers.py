"""The port's tiered embedding storage (embedding/tiers.py: HostArena,
RowSpiller, RowRestorer, TieredVocabTable, and Trainer.train_stream's tier
seam) against the JAX package's tests/test_tiers.py, on the CPU, at its
tiny sizes (the JAX tests/test_streaming.py net: 3 ids into a sparse
table of width 4, an fc, Adam):

  * the arena: bit-exact put/peek round trip, free-list recycling gated
    on checkpoint marks, the typed full and mixed-dtype refusals, the
    snapshot seam, reopen adoption, and an arena written by either
    package adopted by the other with every file byte-identical;
  * the fault drills through the port's utils.faults (marker `faults`):
    torn and dropped manifests, a truncated data file, and a real SIGKILL
    between a slot write and its manifest commit, in a subprocess; the
    harness itself making the JAX harness's faults from one seed, and its
    ChaosProxy on localhost;
  * the regression the tier fixes (plain eviction zeroes a trained row
    and its moments) and its tiered twin restoring both bit-exactly, in
    place (the tensors keep their storage), also when the eviction and
    the re-admission fall in one prefetch window;
  * the loud fallbacks: arena full (event + RuntimeWarning, rows still
    zeroed) and the dim-sharded table refused with the JAX message;
  * the trainer seam: checkpoint/resume carrying the spill map, a tiered
    serial written by either package resumed in the other, the publisher
    seeing every row a boundary zeroed or restored, no new step artifact
    in the steady leg and the `-- tiers --` report section;
  * the acceptance drill: a Zipf stream over an id space 8x the table,
    the tiered loss trajectory bitwise a no-eviction reference, the plain
    leg diverging, and the port's tiered leg within 1e-6 relative of the
    JAX tiered leg from the same start weights with the same spill,
    restore and hit counts.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest pins it to the CPU)

from paddle_tpu import obs as jobs

from test_torch_streaming import (NET_DIM as DIM, NET_FIELDS as FIELDS, PKG,
                                  _carry, _net, _np, _state)

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch import streaming as tstreaming
from paddle_tpu_torch.embedding import tiers as ttiers
from paddle_tpu_torch.utils.faults import FaultInjector

pytestmark = pytest.mark.tiered

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the two packages sum the fc and the loss in other orders: 1e-6 relative,
# the bound tests/test_torch_training.py holds the same small nets to
REL = 1e-6


def _vecs(k, n_arrays=3, dim=DIM):
    """Distinct, reproducible per-id row vectors."""
    return [np.full((dim,), k * 10.0 + i, np.float32)
            for i in range(n_arrays)]


def _arena(tmp_path, slots=8, sub='arena', pkg='port'):
    return PKG[pkg]['streaming'].HostArena(str(tmp_path / sub), slots)


def _train_func(pkg):
    fluid = PKG[pkg]['fluid']
    return lambda: [_net(fluid)[3]]


def _trainer(pkg, train_func=None, **kw):
    fluid = PKG[pkg]['fluid']
    if pkg == 'port':
        kw.setdefault('place', fluid.CPUPlace())
    return fluid.Trainer(train_func or _train_func(pkg),
                         lambda: fluid.optimizer.Adam(learning_rate=0.05),
                         **kw)


def _reader(batches):
    return lambda: iter(batches)


def _phase(ids_seq):
    """One batch per id in ids_seq (the eviction-drill shape)."""
    return [[(np.full((FIELDS, 1), i, 'int64'), np.ones((1,), 'float32'))]
            for i in ids_seq]


def _train_phase(t, vt, ids_seq):
    t.train_stream(_reader(_phase(ids_seq)), vocabs={'ids': vt})


def _rows(t, names, row):
    return {n: _np(t.scope._chain_get(n))[row].copy() for n in names}


# ---------------------------------------------------------------------------
# HostArena: the slot store
# ---------------------------------------------------------------------------

def test_arena_roundtrip_bit_exact_and_checkpoint_gated_recycle(tmp_path):
    a = _arena(tmp_path, slots=4)
    assert a.put_many([(42, _vecs(42))]) == []
    got = a.peek(42)
    for x, y in zip(got, _vecs(42)):
        np.testing.assert_array_equal(x, y)
    assert 42 in a and len(a) == 1
    a.discard_many([42])
    assert 42 not in a
    # the released slot sits in LIMBO until a checkpoint mark
    assert a.put_many([(i, _vecs(i)) for i in range(3)]) == []
    assert a.put_many([(99, _vecs(99))]) == [99]
    a.mark_checkpoint()
    assert a.put_many([(99, _vecs(99))]) == []
    st = a.stats()
    assert st['used'] == 4 and st['free'] == 0 and st['limbo'] == 0
    assert st['bytes'] == 4 * 3 * DIM * 4


def test_arena_full_typed_and_mixed_dtype_rejected(tmp_path):
    a = _arena(tmp_path, slots=1)
    a.put(7, _vecs(7))
    with pytest.raises(tstreaming.ArenaFull, match='no free slot'):
        a.put(8, _vecs(8))
    b = _arena(tmp_path, slots=2, sub='b')
    with pytest.raises(ValueError, match='mixed dtypes'):
        b.put(1, [np.zeros(DIM, np.float32), np.zeros(DIM, np.float64)])
    with pytest.raises(ValueError, match='at least 1 slot'):
        _arena(tmp_path, slots=0, sub='c')


def test_arena_snapshot_roundtrip_and_geometry_mismatch(tmp_path):
    a = _arena(tmp_path, slots=4)
    a.put_many([(5, _vecs(5)), (6, _vecs(6))])
    snap = a.snapshot()
    json.dumps(snap)                       # checkpoint-meta JSON-able
    b = tstreaming.HostArena(a.path, slots=4)
    b.discard_many([5, 6])                 # drift b away from the snap
    b.load_snapshot(snap)                  # ...then restore it exactly
    assert sorted(b._entries) == [5, 6]
    for x, y in zip(b.peek(6), _vecs(6)):
        np.testing.assert_array_equal(x, y)
    c = _arena(tmp_path, slots=9, sub='c')
    with pytest.raises(ValueError, match='geometry mismatch'):
        c.load_snapshot(snap)


def test_arena_reopen_adopts_committed_manifest_bit_exact(tmp_path):
    a = _arena(tmp_path, slots=4)
    a.put_many([(5, _vecs(5)), (6, _vecs(6))])
    b = tstreaming.HostArena(a.path, slots=4)
    assert sorted(b._entries) == [5, 6]
    for x, y in zip(b.peek(5), _vecs(5)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(tstreaming.ArenaCorrupt, match='slots'):
        tstreaming.HostArena(a.path, slots=5)


def test_host_arena_path_is_per_process(tmp_path):
    a = tstreaming.host_arena(str(tmp_path / 'tier'), slots=2)
    assert os.path.basename(a.path) == 'h0'   # no process group: rank 0


_RANK_CHILD = r'''
import sys
import torch.distributed as dist
from paddle_tpu_torch.streaming import host_arena
rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group('gloo', init_method='tcp://localhost:' + port,
                        world_size=2, rank=rank)
try:
    print(host_arena(root, slots=2).path)
finally:
    dist.destroy_process_group()
'''


def test_host_arena_path_is_the_process_groups_rank(tmp_path):
    """Under an initialized process group each rank owns its arena:
    path/h<rank> (the JAX jax.process_index())."""
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = str(sock.getsockname()[1])
    root = str(tmp_path / 'tier')
    procs = [subprocess.Popen([sys.executable, '-c', _RANK_CHILD, str(r),
                               port, root], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == [os.path.join(root, 'h0'),
                                            os.path.join(root, 'h1')]


def _arena_script(a):
    """One sequence of arena operations; returns what it observed."""
    a.put_many([(5, _vecs(5)), (6, _vecs(6)), (9, _vecs(9))])
    a.discard_many([6])
    a.put_many([(11, _vecs(11))])
    a.mark_checkpoint()
    a.put_many([(12, _vecs(12)), (5, _vecs(55))])
    return a.stats(), sorted(a._entries.items()), a.snapshot()


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
def test_an_arena_written_by_one_package_is_adopted_by_the_other(
        writer, reader, tmp_path):
    """The on-disk format is the JAX one byte for byte: the same
    operations give identical files in both packages, and a reopen in the
    other package adopts the map and serves every row bitwise."""
    ours = _arena(tmp_path, slots=6, sub='w', pkg=writer)
    theirs = _arena(tmp_path, slots=6, sub='r', pkg=reader)
    assert _arena_script(ours) == _arena_script(theirs)
    for f in ('arena.npy', 'manifest.json', 'manifest.json.sum'):
        with open(os.path.join(ours.path, f), 'rb') as fa, \
                open(os.path.join(theirs.path, f), 'rb') as fb:
            assert fa.read() == fb.read(), f
    adopted = PKG[reader]['streaming'].HostArena(ours.path, slots=6)
    assert sorted(adopted._entries.items()) == sorted(ours._entries.items())
    for raw, want in ((5, _vecs(55)), (9, _vecs(9)), (11, _vecs(11)),
                      (12, _vecs(12))):
        for x, y in zip(adopted.peek(raw), want):
            np.testing.assert_array_equal(x, y)
    assert adopted.peek(6) is None


# ---------------------------------------------------------------------------
# fault drills: torn writes against the arena (the port's utils.faults)
# ---------------------------------------------------------------------------

@pytest.mark.faults
@pytest.mark.parametrize('what', ['truncate_manifest', 'corrupt_manifest'])
def test_arena_torn_manifest_typed_on_reopen(tmp_path, what):
    """A torn/bit-rotted manifest NEVER adopts silently: the .sum sidecar
    exposes it as the typed ArenaCorrupt (FaultInjector's checkpoint tear
    modes work unmodified against the arena dir)."""
    a = _arena(tmp_path, slots=4)
    a.put_many([(5, _vecs(5))])
    FaultInjector(seed=0).torn_checkpoint(a.path, what=what)
    with pytest.raises(tstreaming.ArenaCorrupt):
        tstreaming.HostArena(a.path, slots=4)


@pytest.mark.faults
def test_arena_dropped_manifest_adopts_empty_never_torn_slots(tmp_path):
    a = _arena(tmp_path, slots=4)
    a.put_many([(5, _vecs(5))])
    FaultInjector(seed=0).torn_checkpoint(a.path, what='drop_manifest')
    b = tstreaming.HostArena(a.path, slots=4)
    assert len(b) == 0 and b.peek(5) is None


@pytest.mark.faults
def test_arena_truncated_data_file_fails_crc_loudly(tmp_path):
    a = _arena(tmp_path, slots=4)
    a.put_many([(5, _vecs(5))])
    FaultInjector(seed=0).torn_checkpoint(a.path, what='truncate_shard')
    b = tstreaming.HostArena(a.path, slots=4)   # manifest itself verifies
    with pytest.raises(tstreaming.ArenaCorrupt, match='CRC32'):
        b.peek(5)


_SIGKILL_CHILD = r'''
import os, signal, sys
import numpy as np
from paddle_tpu_torch.embedding import tiers
a = tiers.HostArena(sys.argv[1], 4)
a.put_many([(5, [np.full(4, 50.0 + i, np.float32) for i in range(3)])])
def die():
    # the slot bytes of id 6 are written and flushed; the manifest that
    # would reference them is not committed yet
    os.kill(os.getpid(), signal.SIGKILL)
a._commit_locked = die
a.put_many([(6, [np.full(4, 777.0, np.float32)] * 3)])
'''


@pytest.mark.faults
def test_arena_sigkill_mid_spill_uncommitted_slot_not_adopted(tmp_path):
    """A process SIGKILLed between a slot write and the manifest commit: a
    reopen adopts the committed map only — the torn slot is unreferenced,
    the committed entry intact."""
    path = str(tmp_path / 'arena')
    out = subprocess.run([sys.executable, '-c', _SIGKILL_CHILD, path],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == -9, out.stderr
    mm = np.lib.format.open_memmap(os.path.join(path, 'arena.npy'), 'r')
    assert (np.asarray(mm) == 777.0).any()  # the torn bytes are on disk
    del mm
    b = tstreaming.HostArena(path, slots=4)
    assert sorted(b._entries) == [5]
    for i, x in enumerate(b.peek(5)):
        np.testing.assert_array_equal(x, np.full(4, 50.0 + i, np.float32))


def _fault_script(faults, root):
    """One seeded sequence of the harness's host-boundary faults; returns
    what each observed (file bytes included)."""
    fi = faults.FaultInjector(seed=11)
    out = []
    calls = fi.flaky(lambda x: x * 2, fail_times=2)
    for _ in range(3):
        try:
            out.append(calls(21))
        except IOError as e:
            out.append(str(e))
    out.append(calls.calls())
    batch = {'x': np.arange(12, dtype='float32').reshape(3, 4),
             'ids': np.arange(3), 'pair': (np.ones(5, 'float32'),)}
    poisoned = fi.poison_nan(batch, rate=0.4)
    out.append((np.isnan(poisoned['x']).tolist(), poisoned['ids'].tolist(),
                np.isnan(poisoned['pair'][0]).tolist()))

    def reader():
        return iter(range(6))
    got = []
    for _ in range(2):
        try:
            got.extend(fi.flaky_reader(lambda: reader(), fail_at=3)())
        except IOError as e:
            got.append(str(e))
    out.append(got)
    os.makedirs(root)
    for name in ('a.npy', 'b.npy', 'c.npy'):
        with open(os.path.join(root, name), 'wb') as f:
            f.write(bytes(range(200)))
    out.append(os.path.basename(fi.pick_file(root)))
    out.append(fi.corrupt_file(os.path.join(root, 'a.npy'), n_bytes=3))
    out.append(fi.truncate_file(os.path.join(root, 'b.npy')))
    with open(os.path.join(root, 'manifest.json'), 'w') as f:
        f.write(json.dumps({'entries': list(range(40))}))
    out.append(fi.torn_checkpoint(root)[0])
    out.append({n: open(os.path.join(root, n), 'rb').read()
                for n in sorted(os.listdir(root))})
    return out


@pytest.mark.faults
def test_the_fault_harness_makes_the_jax_faults_from_one_seed(tmp_path):
    """The port's utils.faults is the JAX harness: from one seed, the same
    flaky calls and readers, the same NaN positions, the same files
    picked, bytes flipped and truncated, the same torn-checkpoint mode."""
    from paddle_tpu.utils import faults as jfaults
    from paddle_tpu_torch.utils import faults as tfaults
    got = _fault_script(tfaults, str(tmp_path / 'port'))
    want = _fault_script(jfaults, str(tmp_path / 'jax'))
    assert got == want
    with pytest.raises(ValueError, match='CHILD'):
        tfaults.FaultInjector().kill_process(os.getpid())


@pytest.mark.faults
def test_chaos_proxy_forwards_garbles_and_severs():
    """ChaosProxy on localhost in front of an echo server: traffic passes
    unchanged, garble() flips the seeded bytes of the next chunk, sever()
    drops the live pairing and a new connection pairs up."""
    import socket
    import threading
    srv = socket.socket()
    srv.bind(('127.0.0.1', 0))
    srv.listen(4)

    def echo():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return

            def serve(c=conn):
                with c:
                    while True:
                        try:
                            data = c.recv(4096)
                        except OSError:
                            return
                        if not data:
                            return
                        c.sendall(data)
            threading.Thread(target=serve, daemon=True).start()

    threading.Thread(target=echo, daemon=True).start()
    proxy = FaultInjector(seed=5).chaos_proxy(srv.getsockname())
    try:
        c = socket.create_connection(proxy.addr, timeout=10)
        c.sendall(b'hello tier')
        assert c.recv(64) == b'hello tier'
        proxy.garble(n_bytes=2, direction='up')
        c.sendall(b'abcdefgh')
        back = c.recv(64)
        assert back != b'abcdefgh' and len(back) == 8
        assert sum(a != b for a, b in zip(back, b'abcdefgh')) <= 2
        proxy.sever()
        assert proxy._pairs == []
        c.close()
        c2 = socket.create_connection(proxy.addr, timeout=10)
        c2.sendall(b'again')
        assert c2.recv(64) == b'again'
        c2.close()
        with pytest.raises(ValueError, match='direction'):
            proxy.garble(direction='sideways')
    finally:
        proxy.close()
        srv.close()


# ---------------------------------------------------------------------------
# the regression the tier fixes, and its tiered twin
# ---------------------------------------------------------------------------

def test_regression_plain_vocab_evict_readmit_loses_trained_state():
    vt = tstreaming.VocabTable(capacity=4, table='emb_w', admit_count=1)
    t = _trainer('port')
    _train_phase(t, vt, (1, 2, 3))
    names = tstreaming.table_state_names(t.train_program, 'emb_w')
    row1 = int(vt.lookup([1])[0])
    saved = _rows(t, names, row1)
    assert any(np.abs(saved[n]).max() > 0 for n in names)
    _train_phase(t, vt, (9,))              # evicts LRU id 1
    assert vt.rows_evicted == 1
    rows, lease = vt.translate([1])
    lease.release()
    tstreaming.RowResetter().reset(
        [t.scope._chain_get(n) for n in names], vt.drain_resets())
    new_row = int(vt.lookup([1])[0])
    for n in names:                        # the trained state is LOST
        assert np.abs(_np(t.scope._chain_get(n))[new_row]).max() == 0


def test_tiered_evict_readmit_restores_row_and_moments_bit_exact(tmp_path):
    """Eviction SPILLS the row + every optimizer moment into the arena;
    re-admission restores all of them bit-exactly, in place: the scope's
    tensors keep their storage through both."""
    vt = tstreaming.VocabTable(capacity=4, table='emb_w', admit_count=1)
    tt = tstreaming.TieredVocabTable(vt, _arena(tmp_path, slots=16))
    t = _trainer('port')
    _train_phase(t, tt, (1, 2, 3))
    names = tstreaming.table_state_names(t.train_program, 'emb_w')
    assert len(names) == 3                 # table + adam moments
    ptrs = [t.scope._chain_get(n).data_ptr() for n in names]
    row1 = int(vt.lookup([1])[0])
    saved = _rows(t, names, row1)
    assert any(np.abs(saved[n]).max() > 0 for n in names if n != 'emb_w')
    _train_phase(t, tt, (9,))              # evicts id 1 -> spilled
    assert vt.rows_evicted == 1 and 1 in tt.arena
    assert not t.scope._chain_get('emb_w')[row1].any() or \
        int(vt.lookup([9])[0]) == row1     # zeroed, then trained by 9
    rows, lease = tt.translate(np.full((FIELDS, 1), 1, 'int64'))
    lease.release()
    ch = tt.apply_step_boundary(t.scope._chain_get, t.scope._chain_set,
                                names)
    new_row = int(vt.lookup([1])[0])
    for n in names:                        # restored bit-exact
        np.testing.assert_array_equal(_np(t.scope._chain_get(n))[new_row],
                                      saved[n])
    assert [t.scope._chain_get(n).data_ptr() for n in names] == ptrs
    assert new_row in ch['emb_w'].tolist()
    assert 1 not in tt.arena               # slot released (to limbo)
    assert tt.tier_hits >= 1 and tt.restored >= 1


def _same_window(pkg, tmp_path):
    st = PKG[pkg]['streaming']
    vt = st.VocabTable(capacity=4, table='w', admit_count=1)
    tt = st.TieredVocabTable(vt, _arena(tmp_path, slots=8, sub=pkg,
                                        pkg=pkg))
    w = np.arange(16, dtype=np.float32).reshape(4, 4)
    m = np.arange(16, 32, dtype=np.float32).reshape(4, 4)
    if pkg == 'port':
        store = {'w': torch.from_numpy(w), 'm': torch.from_numpy(m)}
    else:
        store = {'w': w, 'm': m}

    def write(n, v):
        if pkg == 'port':
            raise AssertionError('the port writes in place, never rebinds')
        store[n] = np.asarray(v)

    out = []
    for ids in ([1, 2, 3], [9], [1]):
        r, lease = tt.translate(ids)
        lease.release()
        if ids != [9]:                     # no boundary between 9 and 1
            ch = tt.apply_step_boundary(store.__getitem__, write,
                                        ['w', 'm'])
            out.append((r.tolist(), None if ch is None
                        else ch['w'].tolist()))
    out.append((_np(store['w']).tolist(), _np(store['m']).tolist(),
                tt.tier_hits, tt.tier_misses, tt.spilled, tt.restored,
                sorted(tt.arena._entries)))
    return out, store


def test_tiered_same_window_evict_and_readmit_restores_exact(tmp_path):
    """Evict + re-admit inside ONE prefetch window (no boundary between):
    the restore resolves against the spill that lands in the same
    apply_step_boundary call — state survives exactly, the store's
    tensors are written in place, and every step equals the JAX tier."""
    got, store = _same_window('port', tmp_path)
    want, _ = _same_window('jax', tmp_path)
    assert got == want
    w0 = np.arange(16, dtype=np.float32).reshape(4, 4)
    row1 = got[0][0][0]
    new_row = got[1][0][0]
    np.testing.assert_array_equal(store['w'].numpy()[new_row], w0[row1])
    assert new_row in got[1][1] and got[-1][2] >= 1


# ---------------------------------------------------------------------------
# loud fallbacks: arena full, dim sharding
# ---------------------------------------------------------------------------

def test_tiered_arena_full_falls_back_to_zeroing_loudly(tmp_path):
    tobs.enable(str(tmp_path / 'obs'))
    try:
        vt = tstreaming.VocabTable(capacity=4, table='w', admit_count=1)
        tt = tstreaming.TieredVocabTable(vt, _arena(tmp_path, slots=1))
        store = {'w': torch.arange(16, dtype=torch.float32).reshape(4, 4)}
        r, lease = tt.translate([1, 2, 3])
        lease.release()
        tt.apply_step_boundary(store.__getitem__, None, ['w'])
        r, lease = tt.translate([7, 8])    # two evictions, one slot
        lease.release()
        with pytest.warns(RuntimeWarning, match='FULL'):
            tt.apply_step_boundary(store.__getitem__, None, ['w'])
        assert tt.dropped_full == 1 and len(tt.arena) == 1
        for raw in (7, 8):                 # both evicted rows zeroed
            row = int(vt.lookup([raw])[0])
            assert not store['w'][row].any()
        events, errors = tobs.report.load_events(tobs.run_log_path())
        assert errors == []
        names = [e['name'] for e in events]
        assert 'streaming.tier.arena_full' in names
        assert 'ARENA FULL: 1 evicted id(s)' in tobs.report.summarize(events)
    finally:
        tobs._reset()


def _corrupt_and_evict(pkg, tmp_path):
    """Spill ids 1 and 2 (a forced evict and a pressure eviction), flip a
    byte of id 1's slot on disk, re-admit both: id 1 fails its CRC and
    restarts cold, id 2 restores warm. Returns what was observed."""
    st = PKG[pkg]['streaming']
    tobs_or_j = tobs if pkg == 'port' else jobs
    tobs_or_j.enable(str(tmp_path / pkg / 'obs'))
    try:
        vt = st.VocabTable(capacity=4, table='w', admit_count=1)
        tt = st.TieredVocabTable(vt, st.HostArena(
            str(tmp_path / pkg / 'arena'), 8))
        w = np.arange(16, dtype=np.float32).reshape(4, 4) + 1.0
        store = {'w': torch.from_numpy(w) if pkg == 'port' else w}
        run = lambda: tt.apply_step_boundary(  # noqa: E731
            store.__getitem__, store.__setitem__, ['w'])
        tt.translate([1, 2, 3])[1].release()
        run()
        row1 = tt.evict(1)
        tt.translate([7])[1].release()      # evicts id 2 (LRU)
        run()
        slot = tt.arena._entries[1][0]
        mm = np.lib.format.open_memmap(os.path.join(tt.arena.path,
                                                    'arena.npy'), 'r+')
        mm[slot, 0, 0] += 1.0
        mm.flush()
        del mm
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            tt.translate([1, 2])[1].release()
        run()
        names = [e['name'] for e in tobs_or_j.report.load_events(
            tobs_or_j.run_log_path())[0]]
        return dict(
            row1=row1, w=_np(store['w']).tolist(), stats=tt.stats(),
            warned=[str(x.message).split(' (')[0] for x in caught],
            corrupt_events=names.count('streaming.tier.corrupt'),
            rows={i: int(vt.lookup([i])[0]) for i in (1, 2, 3, 7)})
    finally:
        tobs_or_j._reset()


def test_corrupt_slot_and_forced_evict_are_the_jax_tiers(tmp_path):
    """TieredVocabTable.evict spills like a pressure eviction; a slot
    whose bytes fail their CRC32 is never served: a streaming.tier.corrupt
    event, a RuntimeWarning, and the id re-admits cold — the same
    observations as the JAX tier."""
    got = _corrupt_and_evict('port', tmp_path)
    want = _corrupt_and_evict('jax', tmp_path)
    got['stats'].pop('last_spill_ms')
    got['stats'].pop('last_restore_ms')
    want['stats'].pop('last_spill_ms')
    want['stats'].pop('last_restore_ms')
    assert got == want
    assert got['stats']['corrupt_slots'] == 1 and got['corrupt_events'] == 1
    assert got['stats']['restored'] == 1
    assert any('failed its CRC' in m for m in got['warned'])


def test_tiered_dim_sharded_table_refused_typed_with_the_jax_message(
        tmp_path):
    """A dim-sharded annotation (inert metadata in the port) is refused
    TYPED at train_stream entry, with the JAX message (but the ROADMAP
    pointer, by the item's title in the port); row sharding is
    accepted; the table var is stamped tiered and serializes so."""
    msgs = []
    for pkg in ('jax', 'port'):
        st = PKG[pkg]['streaming']
        vt = st.VocabTable(capacity=4, table='emb_w', admit_count=1)
        tt = st.TieredVocabTable(vt, _arena(tmp_path, slots=2, sub=pkg,
                                            pkg=pkg))
        t = _trainer(pkg)
        t.train_stream(_reader([]), vocabs={'ids': tt})
        tvar = t.train_program.global_block().vars['emb_w']
        assert tvar.tiered
        assert tvar._to_dict()['tiered'] is True
        tvar.sharding = (None, 'model')
        with pytest.raises(st.DimShardingUnsupported,
                           match='EMBEDDING dim') as e:
            t.train_stream(_reader(_phase((1,))), vocabs={'ids': tt})
        msgs.append(str(e.value))
        tvar.sharding = ('model', None)
        tt.validate_program(t.train_program)
    # the port's message points at the ROADMAP item by its title
    assert msgs[1] == msgs[0].replace('ROADMAP item 3', 'ROADMAP "Parallel"')
    assert 'ROADMAP item 3' in msgs[0]
    from paddle_tpu_torch.fluid import framework
    assert framework.normalize_sharding('model') == ('model',)
    assert framework.normalize_sharding([['a', 'b'], None]) == \
        (('a', 'b'), None)
    with pytest.raises(ValueError, match='bad sharding entry'):
        framework.normalize_sharding([3])


# ---------------------------------------------------------------------------
# trainer seam: checkpoint/resume, publisher, the steady leg, obs
# ---------------------------------------------------------------------------

def test_tiered_checkpoint_resume_preserves_arena_and_spill_map(tmp_path):
    """The spill map rides the checkpoint meta; a resumed trainer (fresh
    vocab + fresh arena object over the same dir) re-admits a pre-crash
    spilled id BIT-exactly."""
    ck, ar = str(tmp_path / 'ck'), str(tmp_path / 'tier')
    cfg = dict(checkpoint_config=tfluid.CheckpointConfig(
        checkpoint_dir=ck, step_interval=1))
    vt = tstreaming.VocabTable(capacity=4, table='emb_w', admit_count=1)
    tt = tstreaming.TieredVocabTable(vt, tstreaming.HostArena(ar, 16))
    t = _trainer('port', **cfg)
    _train_phase(t, tt, (1, 2, 3))
    names = tstreaming.table_state_names(t.train_program, 'emb_w')
    saved = _rows(t, names, int(vt.lookup([1])[0]))
    _train_phase(t, tt, (9, 9))            # evicts + spills id 1
    assert 1 in tt.arena
    spill_map = sorted(tt.arena._entries.items())

    t2 = _trainer('port', checkpoint_config=tfluid.CheckpointConfig(
        checkpoint_dir=ck, step_interval=1))
    assert t2.checkpoint_cfg.load_serial
    vt2 = tstreaming.VocabTable(capacity=4, table='emb_w', admit_count=1)
    tt2 = tstreaming.TieredVocabTable(vt2, tstreaming.HostArena(ar, 16))
    t2.train_stream(_reader([]), vocabs={'ids': tt2})
    assert sorted(tt2.arena._entries.items()) == spill_map
    assert vt2.resident_ids() == vt.resident_ids()
    rows, lease = tt2.translate(np.full((FIELDS, 1), 1, 'int64'))
    lease.release()
    tt2.apply_step_boundary(t2.scope._chain_get, t2.scope._chain_set, names)
    new_row = int(vt2.lookup([1])[0])
    for n in names:
        np.testing.assert_array_equal(_np(t2.scope._chain_get(n))[new_row],
                                      saved[n])


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
def test_a_tiered_serial_resumes_in_the_other_package(writer, reader,
                                                      tmp_path):
    """A tiered checkpoint serial (vocab map, spill map, pending ops in the
    meta; the arena directory beside it) written by either package
    resumes in the other: the same map and spill map, every persistable
    bitwise, and a spilled id restored bitwise its pre-spill state."""
    ck, ar = str(tmp_path / 'ck'), str(tmp_path / 'tier')
    wf = PKG[writer]['fluid']
    ws = PKG[writer]['streaming']
    w = _trainer(writer, checkpoint_config=wf.CheckpointConfig(
        checkpoint_dir=ck, step_interval=1))
    vt = ws.VocabTable(capacity=4, table='emb_w', admit_count=1)
    tt = ws.TieredVocabTable(vt, ws.HostArena(ar, 16))
    _train_phase(w, tt, (1, 2, 3))
    names = ws.table_state_names(w.train_program, 'emb_w')
    before = _rows(w, names, int(vt.lookup([1])[0]))
    _train_phase(w, tt, (9, 9))            # the serial of step 1 holds it
    assert 1 in tt.arena
    sd = tt.state_dict()
    state = _state(w)

    rf = PKG[reader]['fluid']
    rs = PKG[reader]['streaming']
    r = _trainer(reader, checkpoint_config=rf.CheckpointConfig(
        checkpoint_dir=ck, step_interval=1))
    assert r.checkpoint_cfg.load_serial
    vt2 = rs.VocabTable(capacity=4, table='emb_w', admit_count=1)
    tt2 = rs.TieredVocabTable(vt2, rs.HostArena(ar, 16))
    r.train_stream(_reader([]), vocabs={'ids': tt2})
    assert tt2.state_dict() == sd
    got = _state(r)
    assert sorted(got) == sorted(state)
    for n in state:
        np.testing.assert_array_equal(got[n], state[n], err_msg=n)
    rows, lease = tt2.translate(np.full((FIELDS, 1), 1, 'int64'))
    lease.release()
    store = {}

    def write(n, v):
        store[n] = v
        if reader == 'jax':
            r.scope._chain_set(n, v)

    tt2.apply_step_boundary(r.scope._chain_get, write, names)
    row = int(vt2.lookup([1])[0])
    for n in names:
        np.testing.assert_array_equal(_np(r.scope._chain_get(n))[row],
                                      before[n], err_msg=n)


def _pending_ops_tier(pkg, arena_dir):
    """A tier with ops pending (a translated window whose boundary has not
    run: spills, a warm restore staged from the arena) and its store."""
    st = PKG[pkg]['streaming']
    tt = st.TieredVocabTable(st.VocabTable(capacity=4, table='w',
                                           admit_count=1),
                             st.HostArena(arena_dir, 8))
    store = {'w': np.arange(16, dtype=np.float32).reshape(4, 4),
             'm': np.arange(16, 32, dtype=np.float32).reshape(4, 4)}
    if pkg == 'port':
        store = {k: torch.from_numpy(v) for k, v in store.items()}
    for ids in ([1, 2, 3], [9]):
        tt.translate(ids)[1].release()
        tt.apply_step_boundary(store.__getitem__, store.__setitem__,
                               ['w', 'm'])
    tt.translate([1])[1].release()         # warm: staged, not applied
    tt.translate([5])[1].release()
    return tt, store


def _boundary(tt, store):
    ch = tt.apply_step_boundary(store.__getitem__, store.__setitem__,
                                ['w', 'm'])
    sd = json.loads(json.dumps(tt.state_dict()))
    return ({k: _np(v) for k, v in store.items()}, ch['w'].tolist(),
            sd['vocab'], sorted((r, c) for r, _, c in sd['arena']['entries']),
            sd['ops'])


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax'),
                                           ('port', 'port')])
def test_pending_ops_resume_in_either_package(writer, reader, tmp_path):
    """A tier state with pending spills and a staged restore (the window a
    checkpoint can land in) loads in a fresh table over the same arena in
    either package. Its first boundary, which reads the restore from the
    arena, equals the writer's own boundary, which applies the staged
    rows: the same tensors bitwise, changed rows and tier state."""
    arena = str(tmp_path / 'arena')
    tt, store = _pending_ops_tier(writer, arena)
    sd = json.loads(json.dumps(tt.state_dict()))
    kinds = [k for k, _, _ in sd['ops']]
    assert kinds.count('restore') >= 1 and kinds.count('spill') >= 1
    start = {k: _np(v).copy() for k, v in store.items()}
    want = _boundary(tt, store)
    st = PKG[reader]['streaming']
    tt2 = st.TieredVocabTable(st.VocabTable(capacity=4, table='w',
                                            admit_count=1),
                              st.HostArena(arena, 8))
    tt2.load_state_dict(sd)
    assert json.loads(json.dumps(tt2.state_dict())) == sd
    store2 = ({k: torch.from_numpy(v) for k, v in start.items()}
              if reader == 'port' else start)
    got = _boundary(tt2, store2)
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    assert got[1:] == want[1:]


class _SinkEngine(object):
    def __init__(self):
        self.pushed = []

    def push_rows(self, deltas):
        self.pushed.append({k: (np.array(v[0]), np.array(v[1]))
                            for k, v in deltas.items()})
        return sum(len(v[0]) for v in deltas.values())


def test_tiered_publisher_sees_every_device_mutated_row(tmp_path):
    """Every row apply_step_boundary mutates (zeroed OR restored) lands in
    that step's delta push, also when the mutation came from a PREFETCHED
    batch's translation (double_buffer). Capacity 8 keeps evictions
    deterministic under the double buffer (at most 2 in-flight leases pin
    6 rows)."""
    vt = tstreaming.VocabTable(capacity=8, table='emb_w', admit_count=1)
    tt = tstreaming.TieredVocabTable(vt, _arena(tmp_path, slots=64))
    boundary_rows = []
    orig = tt.apply_step_boundary

    def spy(read, write, names, lock=None):
        out = orig(read, write, names, lock=lock)
        boundary_rows.append(
            sorted(int(r) for r in out['emb_w']) if out else [])
        return out

    tt.apply_step_boundary = spy
    sink = _SinkEngine()
    pub = tstreaming.DeltaPublisher(sink, interval_steps=1)
    t = _trainer('port', double_buffer=True)
    seq = (1, 2, 3, 4, 5, 6, 7, 11, 12, 1, 2, 3, 4, 5)
    t.train_stream(_reader(_phase(seq)), vocabs={'ids': tt}, publisher=pub)
    assert tt.spilled >= 1 and tt.restored >= 1
    assert len(sink.pushed) == len(seq)
    table = _np(t.scope._chain_get('emb_w'))
    for rows, push in zip(boundary_rows, sink.pushed):
        pushed = set(np.asarray(push['emb_w'][0]).tolist())
        assert set(rows) <= pushed, (rows, pushed)
    # the last push carries the table's live rows
    last_rows, last_vals = sink.pushed[-1]['emb_w']
    np.testing.assert_array_equal(last_vals, table[last_rows])


def test_tiered_steady_leg_adds_no_artifact_and_renders_the_report(
        tmp_path):
    """Churny eviction/restore traffic leaves the step alone: no new step
    artifact in the steady leg, the tables never rebound — and the obs
    run log validates and renders the `-- tiers --` report section."""
    tobs.enable(str(tmp_path / 'obs'))
    try:
        vt = tstreaming.VocabTable(capacity=8, table='emb_w',
                                   admit_count=1)
        tt = tstreaming.TieredVocabTable(vt, _arena(tmp_path, slots=64))
        t = _trainer('port', double_buffer=True)
        _train_phase(t, tt, [1, 2, 3, 4, 5, 6, 7, 11, 12, 13,
                             1, 2, 3, 4, 5, 6, 7])
        misses0 = t.exe.cache_stats['misses']
        names = tstreaming.table_state_names(t.train_program, 'emb_w')
        ptrs = [t.scope._chain_get(n).data_ptr() for n in names]
        assert tt.spilled >= 1 and tt.restored >= 1
        _train_phase(t, tt, [21, 22, 23, 1, 2, 3, 4, 5, 6, 7])
        assert t.exe.cache_stats['misses'] == misses0
        assert [t.scope._chain_get(n).data_ptr() for n in names] == ptrs
        assert tt._spiller.host_waits == 0     # the CPU never waits
        events, errors = tobs.report.load_events(tobs.run_log_path())
        assert errors == []
        names = [e['name'] for e in events]
        for n in ('streaming.tier.spill', 'streaming.tier.restore',
                  'streaming.tier.prefetch'):
            assert n in names, n
        text = tobs.report.summarize(events)
        assert '-- tiers --' in text and 'restored warm' in text
        st = tt.stats()
        assert st['tier_hit_rate'] == tt.hit_rate() > 0
        assert len(tt.spill_ms_samples) == len(
            [e for e in events if e['name'] == 'streaming.tier.spill'])
        assert len(tt.restore_ms_samples) == len(
            [e for e in events if e['name'] == 'streaming.tier.restore'])
    finally:
        tobs._reset()


# ---------------------------------------------------------------------------
# acceptance: a Zipf stream over an id space 8x the table
# ---------------------------------------------------------------------------

BUDGET = 4                                 # vocab capacity (3 + cold)
UNIVERSE = 8 * BUDGET                      # id space: 8x the budget


def _zero_init_net(pkg):
    """The A/B net: a Constant(0) table makes a freshly-zeroed row
    IDENTICAL to a never-trained one, so the only divergence lever left is
    trained state lost (or kept) across evict/re-admit."""
    fluid = PKG[pkg]['fluid']

    def train_func():
        fluid.default_main_program().random_seed = 7
        fluid.default_startup_program().random_seed = 7
        ids = fluid.layers.data(name='ids', shape=[FIELDS, 1],
                                dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='float32')
        emb = fluid.layers.embedding(
            ids, size=[UNIVERSE + 1, DIM], is_sparse=True,
            param_attr=fluid.ParamAttr(
                name='emb_w', initializer=fluid.initializer.Constant(0.0)))
        pred = fluid.layers.fc(input=emb, size=1, num_flatten_dims=2,
                               param_attr=fluid.ParamAttr(name='fc_w'))
        score = fluid.layers.reduce_sum(pred, dim=1)
        return [fluid.layers.mean(fluid.layers.square(score - label))]
    return train_func


def _zipf_batches(n, seed=3):
    """Zipf-weighted draws over the 8x universe with a drifting hot set:
    plenty of evictions AND warm re-admissions."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, UNIVERSE + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    out = []
    for k in range(n):
        shift = (k // 4) % UNIVERSE
        ids = (rng.choice(UNIVERSE, size=FIELDS, replace=False, p=p)
               + shift) % UNIVERSE
        lbl = rng.randn(1).astype('float32')
        out.append([(ids.reshape(FIELDS, 1).astype('int64'), lbl)])
    return out


def _leg(pkg, vocab, batches, start=None):
    """Two train_stream calls (warm, steady) over `batches`; returns the
    losses, the step artifacts the steady half added, the trainer."""
    t = _trainer(pkg, train_func=_zero_init_net(pkg), double_buffer=False)
    if start is not None:
        _carry(start, t)
    losses = []

    def on_event(ev):
        if getattr(ev, 'metrics', None):
            losses.append(np.asarray(ev.metrics[0]).copy())

    half = len(batches) // 2
    t.train_stream(_reader(batches[:half]), vocabs={'ids': vocab},
                   event_handler=on_event)
    misses0 = t.exe.cache_stats['misses']
    t.train_stream(_reader(batches[half:]), vocabs={'ids': vocab},
                   event_handler=on_event)
    return losses, t.exe.cache_stats['misses'] - misses0, t


def test_e2e_zipf_8x_budget_tiered_bit_exact_plain_diverges(tmp_path):
    """Three legs over the SAME Zipf stream, a table 8x smaller than the
    id space: reference (capacity covers the universe), tiered (capacity
    4 + host arena), plain (capacity 4, zeroing eviction). The tiered
    losses are BIT-exact the reference's, the plain leg diverges once a
    trained id re-admits zeroed, and the steady half adds no artifact."""
    st = tstreaming
    batches = _zipf_batches(24)
    ref, _, _ = _leg('port', st.VocabTable(UNIVERSE + 1, table='emb_w',
                                           admit_count=1), batches)
    tt = st.TieredVocabTable(
        st.VocabTable(BUDGET, table='emb_w', admit_count=1),
        _arena(tmp_path, slots=4 * UNIVERSE))
    tier, tier_misses, _ = _leg('port', tt, batches)
    plain, _, _ = _leg('port', st.VocabTable(BUDGET, table='emb_w',
                                             admit_count=1), batches)
    assert len(ref) == len(tier) == len(plain) == len(batches)
    assert tt.spilled >= 3 and tt.tier_hits >= 1, tt.stats()
    assert tt.hit_rate() > 0
    for a, b in zip(ref, tier):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(ref, plain)), \
        'plain leg never diverged — the drill admitted no trained id?'
    assert tier_misses == 0, 'the tiered steady leg built a new artifact'


def test_tiered_train_stream_matches_jax(tmp_path):
    """The same Zipf stream through the JAX tiered leg and the port's from
    the JAX start weights: losses within 1e-6 relative, the same spill,
    restore, hit and miss counts, the same vocab and spill maps, and the
    table and both moments within 1e-6 relative at the end."""
    batches = _zipf_batches(24)
    legs = {}
    jstart = _trainer('jax', train_func=_zero_init_net('jax'))
    for pkg in ('jax', 'port'):
        st = PKG[pkg]['streaming']
        tt = st.TieredVocabTable(
            st.VocabTable(BUDGET, table='emb_w', admit_count=1),
            _arena(tmp_path, slots=4 * UNIVERSE, sub=pkg, pkg=pkg))
        losses, _, t = _leg(pkg, tt, batches,
                            start=jstart if pkg == 'port' else None)
        legs[pkg] = (np.concatenate([np.reshape(x, -1) for x in losses]),
                     tt, _state(t))
    (jl, jt, js), (pl, pt, ps) = legs['jax'], legs['port']
    np.testing.assert_allclose(pl, jl, rtol=REL, atol=REL)
    for k in ('tier_hits', 'tier_misses', 'spilled', 'restored',
              'dropped_full', 'corrupt_slots'):
        assert getattr(pt, k) == getattr(jt, k), k
    assert pt.spilled >= 3 and pt.restored >= 1
    assert pt.vocab.state_dict() == jt.vocab.state_dict()
    assert sorted(pt.arena._entries) == sorted(jt.arena._entries)
    for n in ('emb_w', 'moment1_emb_w_0', 'moment2_emb_w_0', 'fc_w'):
        np.testing.assert_allclose(ps[n], js[n], rtol=REL, atol=REL,
                                   err_msg=n)


def test_row_spiller_and_restorer_refuse_what_they_cannot_write():
    t = torch.zeros(4, 2)
    with pytest.raises(TypeError, match='in place'):
        ttiers.RowSpiller().spill([np.zeros((4, 2), np.float32)], [1])
    with pytest.raises(ValueError, match='mixed dtypes'):
        ttiers.RowRestorer().restore(
            [t, torch.zeros(4, 2, dtype=torch.float64)], [1],
            [np.ones((1, 2), np.float32)] * 2)
    assert ttiers.RowSpiller().spill([t], []) == ([t], {})
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert ttiers.RowRestorer().restore([t], [], []) == [t]
