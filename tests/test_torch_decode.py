"""The port's DecodeEngine (serving/decode.py) against the JAX package's, on
the CPU, at the small shapes of tests/test_decode.py:41-43 (V, E, D, H, K =
20, 8, 6, 8, 3; src_cap 5; max_len 8; page_size 3):

  * the paged engine against the JAX LockstepDecoder, the whole-batch
    decode both engines are built to equal, under randomized join and
    leave (seeds 0 and 1) and with bundle 3 and 8: tokens equal, scores
    within 1e-5 (the two packages' fp32 CPU arithmetic differs in its
    last bits);
  * the paged against the dense engine of the port: bit-identical (the
    paged plain attention gathers the same rows into the same function);
  * one beam step against the JAX step, finished beams included, where
    the top-k sees ties at finfo.min and must keep the lower index;
  * the JAX paged drills (test_decode.py:355, 466, 515, 623): page-table
    invariants and recycling, pool exhaustion that blocks and never
    strands, a prefix hit that pins its pages, a poisoned slot that frees
    its pages; a prefix hit joining without claiming or writing pages;
  * DecodeConfig's validation, state_bytes() against the JAX engine's,
    PagePool and PrefixCache against the JAX classes under one scripted
    sequence of calls, mt_weights from a port Scope loaded with the JAX
    names, and Executor.acquire_step.
"""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.fluid.ops_impl import lod_beam as jbeam
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import LockstepDecoder
from paddle_tpu.serving import pages as jpages

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.fluid.ops_impl import lod_beam as tbeam
from paddle_tpu_torch.serving import pages as tpages
from paddle_tpu_torch.serving.engine import ServerOverloaded

V, E, D, H, K = 20, 8, 6, 8, 3
SRC = 5          # src_cap
MAXLEN = 8
TOL = 1e-5


def _weights(rng):
    return {
        'w_dec': (rng.randn(E + D, 4 * H) * 0.3).astype(np.float32),
        'u_dec': (rng.randn(H, 4 * H) * 0.3).astype(np.float32),
        'b_dec': (rng.randn(1, 4 * H) * 0.1).astype(np.float32),
        'w_q': (rng.randn(H, D) * 0.3).astype(np.float32),
        'w_emb': (rng.randn(V, E) * 0.3).astype(np.float32),
        'w_out': (rng.randn(H, V) * 0.3).astype(np.float32),
        'b_out': (rng.randn(1, V) * 0.1).astype(np.float32),
    }


WEIGHTS = _weights(np.random.RandomState(7))
_LS = {}


def _lockstep_ref(encs, max_len):
    """The JAX whole-batch decode of [S, D] encoder row-sets: (ids [n, K,
    max_len], scores [n, K])."""
    if max_len not in _LS:
        _LS[max_len] = LockstepDecoder(WEIGHTS, beam_size=K,
                                       max_len=max_len, src_cap=SRC)
    lens = np.asarray([e.shape[0] for e in encs], np.int32)
    enc = np.zeros((len(encs), SRC, D), np.float32)
    for i, e in enumerate(encs):
        enc[i, :e.shape[0]] = e
    return _LS[max_len].run(enc, lens)


def _refs(encs, lims):
    refs = {}
    for L in sorted(set(lims)):
        grp = [i for i in range(len(encs)) if lims[i] == L]
        ids, sc = _lockstep_ref([encs[i] for i in grp], L)
        for j, i in enumerate(grp):
            refs[i] = (ids[j], sc[j])
    return refs


def _encs(rng, n, lo=2):
    return [(rng.randn(rng.randint(lo, SRC + 1), D) * 0.5)
            .astype(np.float32) for _ in range(n)]


def _engine(slots=4, max_len=MAXLEN, paged=True, page_size=3, pages=None,
            weights=WEIGHTS, **kw):
    """A port engine on the CPU; paged with the dense-equivalent history
    pool unless told otherwise."""
    if paged:
        kw['page_size'] = page_size
        kw['pages'] = pages if pages is not None \
            else slots * -(-max_len // page_size)
    return serving.DecodeEngine(weights, serving.DecodeConfig(
        slots=slots, beam_size=K, max_len=max_len, src_cap=SRC, **kw),
        place=fluid.CPUPlace())


def _wait(cond, timeout=60.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, 'condition never held'
        time.sleep(0.002)


def _assert_matches(got, ref, what):
    toks, acc = got
    assert toks.dtype == np.int64 and acc.dtype == np.float32
    assert np.array_equal(toks, ref[0]), what
    np.testing.assert_allclose(acc, ref[1], rtol=TOL, atol=TOL,
                               err_msg=str(what))


# -- against the JAX package's lockstep decode ------------------------------

@pytest.mark.parametrize('seed', [0, 1])
def test_paged_matches_jax_lockstep_under_join_and_leave(seed):
    """Mixed limits submitted in random order with staggered timing over
    a 2-slot pool: slot and page assignment must be invisible."""
    rng = np.random.RandomState(seed)
    encs = _encs(rng, 10)
    lims = [(4, MAXLEN)[rng.randint(2)] for _ in encs]
    refs = _refs(encs, lims)
    eng = _engine(slots=2)
    try:
        eng.warmup()
        futs = {}
        for i in rng.permutation(len(encs)):
            futs[i] = eng.submit({'enc': encs[i]}, max_new_tokens=lims[i])
            if rng.rand() < 0.5:
                time.sleep(rng.rand() * 0.01)
        for i, f in futs.items():
            got = f.result(60)
            assert got[0].shape == (K, lims[i])
            _assert_matches(got, refs[i], i)
        st = eng.stats
        assert st['completed'] == 10 and st['slots_occupied'] == 0
    finally:
        eng.shutdown()


@pytest.mark.parametrize('bundle', [3, 8])
def test_paged_bundle_matches_jax_lockstep(bundle):
    """bundle steps per dispatch, limits that do not divide the bundle:
    finished slots freeze mid-bundle."""
    rng = np.random.RandomState(11)
    encs = _encs(rng, 7)
    lims = [3, MAXLEN, 5, MAXLEN, 1, 7, MAXLEN]
    refs = _refs(encs, lims)
    eng = _engine(slots=2, bundle=bundle)
    try:
        eng.warmup()
        futs = [eng.submit({'enc': e}, max_new_tokens=n)
                for e, n in zip(encs, lims)]
        for i, f in enumerate(futs):
            _assert_matches(f.result(60), refs[i], (bundle, i))
        assert eng.stats['steps'] < eng.stats['tokens']
    finally:
        eng.shutdown()


@pytest.mark.parametrize('bundle', [1, 3])
def test_paged_and_dense_engines_are_bit_identical(bundle):
    rng = np.random.RandomState(5)
    encs = _encs(rng, 9, lo=1)
    lims = [int(rng.randint(1, MAXLEN + 1)) for _ in encs]
    out = {}
    for paged in (True, False):
        eng = _engine(slots=3, paged=paged, bundle=bundle)
        try:
            eng.warmup()
            futs = [eng.submit({'enc': e}, max_new_tokens=n)
                    for e, n in zip(encs, lims)]
            out[paged] = [f.result(60) for f in futs]
        finally:
            eng.shutdown()
    for (tp, sp), (td, sd) in zip(out[True], out[False]):
        assert np.array_equal(tp, td)
        assert np.array_equal(sp, sd)


# -- one beam step, ties included -------------------------------------------

def test_top_k_keeps_the_lower_index_on_ties():
    x = np.full((2, 6), np.finfo(np.float32).min, np.float32)
    x[0] = [1.0, 3.0, 3.0, -1.0, 3.0, 0.0]
    x[1, 2] = 2.0
    import jax
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tbeam.top_k_lower_index(torch.from_numpy(x), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 4], [2, 0, 1]]


@pytest.mark.parametrize('finished', ['none', 'some', 'all'])
def test_beam_step_matches_the_jax_step(finished):
    """attention_beam_step from the same carry in both packages. With all
    beams finished each row offers one candidate (end_id at its score)
    and beam * V - beam candidates tied at finfo.min."""
    rng = np.random.RandomState(4)
    B = 2
    keys = ('w_dec', 'u_dec', 'b_dec', 'w_q', 'w_emb', 'w_out', 'b_out')
    h = (rng.randn(B * K, H) * 0.5).astype(np.float32)
    c = (rng.randn(B * K, H) * 0.5).astype(np.float32)
    prev = rng.randint(0, V, B * K).astype(np.int32)
    acc = np.sort(rng.randn(B, K).astype(np.float32), 1)[:, ::-1]
    acc = np.ascontiguousarray(acc).reshape(-1)
    fin = {'none': np.zeros(B * K, bool),
           'some': np.array([1, 0, 1, 0, 0, 1], bool),
           'all': np.ones(B * K, bool)}[finished]
    enc = (rng.randn(B * K, SRC, D) * 0.5).astype(np.float32)
    mask = (np.arange(SRC)[None] < 3).astype(np.float32).repeat(B * K, 0)
    jout = jbeam.attention_beam_step(
        tuple(jnp.asarray(WEIGHTS[k]) for k in keys), jnp.asarray(enc),
        jnp.asarray(mask), tuple(jnp.asarray(a) for a in (h, c, prev, acc,
                                                          fin)), K, 1)
    tout = tbeam.attention_beam_step(
        tuple(torch.from_numpy(WEIGHTS[k]) for k in keys),
        torch.from_numpy(enc), torch.from_numpy(mask),
        tuple(torch.from_numpy(a) for a in (h, c, prev, acc, fin)), K, 1)
    (jc, (jids, jpar, jtop)), (tc, (tids, tpar, ttop)) = jout, tout
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(tpar.numpy(), np.asarray(jpar))
    np.testing.assert_allclose(ttop.numpy(), np.asarray(jtop), rtol=TOL,
                               atol=TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   rtol=TOL, atol=TOL)
    if finished == 'all':     # each beam carried on with end_id, in order
        assert (tids.numpy() == 1).all()
        assert tpar.numpy().tolist() == [[0, 1, 2], [0, 1, 2]]


def test_backtrace_matches_jax():
    rng = np.random.RandomState(2)
    ids = rng.randint(0, V, (6, K)).astype(np.int32)
    par = rng.randint(0, K, (6, K)).astype(np.int32)
    assert np.array_equal(tbeam.backtrace_beams(ids, par),
                          jbeam.backtrace_beams(ids, par))
    carry = tbeam.beam_init_carry(2, K, H, 0)
    jcarry = jbeam.beam_init_carry(2, K, H, 0)
    for a, b in zip(carry, jcarry):
        assert np.array_equal(a.numpy(), np.asarray(b))


# -- the paged drills -------------------------------------------------------

def test_page_table_invariants_and_recycling():
    """No history page is referenced by two live slots at once (sampled
    from the host page tables under churn), and freed pages are
    recycled: total allocations exceed the pool."""
    eng = _engine(slots=3, page_size=2)
    try:
        eng.warmup()
        rng = np.random.RandomState(3)
        futs = [eng.submit({'enc': e},
                           max_new_tokens=int(rng.randint(1, MAXLEN + 1)))
                for e in _encs(rng, 12)]
        pending = list(futs)
        deadline = time.monotonic() + 120
        while pending and time.monotonic() < deadline:
            live = [sp for sp in list(eng._slot_pages) if sp is not None]
            hist = [p for sp in live for p in sp['hist']]
            assert len(hist) == len(set(hist)), hist
            owned = [p for sp in live if sp['pkey'] is None
                     for p in sp['enc']]
            assert len(owned) == len(set(owned))
            pending = [f for f in pending if not f.done()]
            time.sleep(0.001)
        for f in futs:
            f.result(60)
        _wait(lambda: eng._hist_pool.free_count == eng._hist_pool.usable)
        assert eng._hist_pool.allocated > eng._hist_pool.usable
        assert eng._hist_pool.freed == eng._hist_pool.allocated
    finally:
        eng.shutdown()


def test_page_pool_exhaustion_blocks_never_strands():
    """With every history page held, later requests block in the queue;
    a poisoned occupant is released with its pages and the blocked
    requests join and complete. Under the reject policy a queue full
    because of page starvation says reason=pages."""
    encs = _encs(np.random.RandomState(1), 3)
    refs = _refs(encs, [MAXLEN] * 3)
    bad = encs[0].copy()
    bad[0, 0] = np.nan
    # 2 history pages of MAXLEN rows: 2 concurrent requests on 4 slots
    eng = _engine(slots=4, page_size=MAXLEN, pages=2)
    try:
        eng.warmup()
        poisoned = eng.submit({'enc': bad})
        blocked = [eng.submit({'enc': e}) for e in encs]
        with pytest.raises(serving.DecodeSlotPoisoned):
            poisoned.result(60)
        for i, f in enumerate(blocked):
            _assert_matches(f.result(60), refs[i], i)
        assert eng.stats['slots_high_water'] <= 2
        _wait(lambda: eng._hist_pool.free_count == 2)
    finally:
        eng.shutdown()
    # end_id past the vocabulary: the one page stays held for all 256
    # steps of the first request
    eng2 = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(
        slots=4, beam_size=K, max_len=256, src_cap=SRC, end_id=V,
        page_size=256, pages=1, queue_capacity=1, overflow='reject'),
        place=fluid.CPUPlace())
    try:
        e = np.zeros((2, D), np.float32)
        eng2.submit({'enc': e})           # takes the only page
        _wait(lambda: eng2.stats['joins'] == 1)
        eng2.submit({'enc': e})           # queued, starved on pages
        _wait(lambda: eng2._pages_starved)
        with pytest.raises(ServerOverloaded, match='pages'):
            eng2.submit({'enc': e})
        assert eng2.stats['rejected'] == 1
    finally:
        eng2.shutdown()


def test_prefix_hit_pins_pages_against_batchmate_claims():
    """One usable encoder page: A completes (resident), then an A hit and
    a B miss submitted together must both complete; B evicts A later."""
    eng = _engine(slots=2, page_size=SRC, pages=4, enc_pages=2)
    try:
        eng.warmup()
        encs = _encs(np.random.RandomState(17), 2, lo=3)
        refs = _refs(encs, [MAXLEN] * 2)
        eng.submit({'enc': encs[0]}).result(60)
        fa = eng.submit({'enc': encs[0]})             # hit: pins A
        fb = eng.submit({'enc': encs[1]})             # miss: needs A's page
        _assert_matches(fa.result(60), refs[0], 'a')
        _assert_matches(fb.result(60), refs[1], 'b')
        st = eng.stats
        assert st['completed'] == 3 and st['prefix_hits'] >= 1
        assert st['prefix_evictions'] >= 1
    finally:
        eng.shutdown()


def test_poisoned_slot_frees_pages_and_spares_the_others():
    encs = _encs(np.random.RandomState(1), 3)
    refs = _refs(encs, [MAXLEN] * 3)
    bad = np.full((3, D), np.nan, np.float32)
    eng = _engine(slots=4)
    try:
        eng.warmup()
        free0 = eng._hist_pool.free_count
        good = [eng.submit({'enc': e}) for e in encs]
        with pytest.raises(serving.DecodeSlotPoisoned):
            eng.submit({'enc': bad}).result(60)
        for i, f in enumerate(good):
            _assert_matches(f.result(60), refs[i], i)
        _wait(lambda: eng._hist_pool.free_count == free0)
        assert eng.stats['poisoned'] == 1
    finally:
        eng.shutdown()


def test_prefix_cache_joins_without_prefill():
    """A request whose encoder rows are resident joins on the cached
    pages: it claims and writes no encoder page, and its result equals
    the first one's. In-batch duplicates share their first's pages."""
    encs = _encs(np.random.RandomState(5), 2, lo=3)
    eng = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(
        slots=2, beam_size=K, max_len=MAXLEN, src_cap=SRC, page_size=3,
        pages=12), place=fluid.CPUPlace())
    try:
        eng.warmup()
        ra = [f.result(60) for f in
              [eng.submit({'enc': encs[0]}) for _ in range(3)]]
        rb = eng.submit({'enc': encs[1]}).result(60)
        ra2 = eng.submit({'enc': encs[0]}).result(60)
        for t, s in ra[1:] + [ra2]:
            assert np.array_equal(t, ra[0][0])
            assert np.array_equal(s, ra[0][1])
        assert not np.array_equal(rb[0], ra[0][0])
        st = eng.stats
        assert st['prefix_hits'] == 3 and st['prefix_misses'] == 2
        # encoder pages were claimed for the two distinct sources only
        assert eng._enc_pool.allocated == sum(
            tpages.pages_for(e.shape[0], 3) for e in encs)
        assert st['prefix_evictions'] == 0
        w = eng.stats_window()
        assert w['prefix_hit_rate'] == 0.6 and w['pages_total'] > 0
    finally:
        eng.shutdown()


# -- config, state size, allocator, weights, the executor handle ------------

def test_decode_config_validates():
    for kw, match in (
            (dict(pages=8), 'page_size'),
            (dict(page_size=4), 'pages=N'),
            (dict(max_len=32, page_size=4, pages=7), 'cannot back'),
            (dict(src_cap=16, page_size=4, pages=8, enc_pages=4),
             'cannot back'),
            (dict(max_len=8, bundle=9), 'bundle'),
            (dict(bundle=0), 'bundle'),
            (dict(overflow='drop'), 'overflow'),
            (dict(prefix_cache=True), 'page_size')):
        with pytest.raises(ValueError, match=match):
            serving.DecodeConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JDecodeConfig(**kw)
    # speculative decoding is ported (its validation cases are in
    # test_torch_spec_decode.py): a paged beam-1 config takes spec_k
    assert serving.DecodeConfig(beam_size=1, page_size=4, pages=8,
                                spec_k=2).spec_k == 2
    cfg = serving.DecodeConfig(slots=16, max_len=50, src_cap=32,
                               page_size=16, pages=64)
    assert (cfg.hist_table_width, cfg.enc_table_width, cfg.enc_pages) \
        == (4, 2, 65)
    with pytest.raises(ValueError, match='missing'):
        serving.DecodeEngine({'w_dec': WEIGHTS['w_dec']},
                             place=fluid.CPUPlace())


@pytest.mark.parametrize('paged', [False, True])
def test_state_bytes_equal_the_jax_engine(paged):
    kw = dict(slots=5, beam_size=K, max_len=MAXLEN, src_cap=SRC)
    if paged:
        kw.update(page_size=3, pages=7)
    j = JDecodeEngine(WEIGHTS, JDecodeConfig(**kw))
    t = serving.DecodeEngine(WEIGHTS, serving.DecodeConfig(**kw),
                             place=fluid.CPUPlace())
    try:
        assert t.state_bytes() == j.state_bytes()
        st = t._acquire().state
        assert sum(v.numel() * v.element_size() for n, v in st.items()
                   if not n[4:] in serving.decode.WEIGHT_KEYS) \
            == t.state_bytes()
    finally:
        j.shutdown()
        t.shutdown()


def test_page_pool_and_prefix_cache_match_the_jax_classes():
    """One scripted sequence of calls on both packages' allocator and
    cache: every return value and counter equal."""
    trace = {}
    for name, mod in (('jax', jpages), ('torch', tpages)):
        evicted = []
        pool = mod.PagePool(9, reserved=1)
        cache = mod.PrefixCache(pool, on_evict=lambda k, p: evicted.append(
            (k, list(p))))
        log = [mod.pages_for(7, 3), mod.content_key({'enc': np.ones(2)}),
               pool.usable]
        a = pool.alloc(3, cache)
        cache.insert('a', a, 7)
        b = pool.alloc(2, cache)
        cache.insert('b', b, 5, refs=2)
        log += [a, b, pool.available(cache), cache.peek('a'),
                cache.pinnable_pages('a')]
        cache.unref('a')
        log += [pool.available(cache), cache.pinnable_pages('a'),
                cache.lookup('a'), cache.lookup('zz')]
        cache.unref('a')
        cache.unref('b')
        cache.unref('b')
        log += [pool.alloc(5, cache), pool.alloc(6, cache), list(evicted),
                cache.stats(), pool.free_count, pool.allocated, pool.freed]
        cache.insert('b', [1], 2)                   # duplicate: freed
        log += [cache.stats(), pool.free_count, pool.available(cache)]
        pool.release([1, 2])
        log += [pool.free_count, pool.freed, len(cache), cache.evict_one(),
                cache.evict_one(), cache.evict_one()]
        trace[name] = log
    assert trace['torch'] == trace['jax']


def test_mt_weights_reads_a_scope_with_the_jax_names():
    names = {'w_dec': 'mt_w_dec', 'u_dec': 'mt_u_dec', 'b_dec': 'mt_b_dec',
             'w_q': 'mt_w_attnq', 'w_emb': 'mt_trg_emb',
             'w_out': 'mt_w_out', 'b_out': 'mt_b_out'}
    scope = fluid.Scope()
    scope.load_numpy({names[k]: v for k, v in WEIGHTS.items()},
                     fluid.CPUPlace())
    got = serving.mt_weights(scope)
    assert sorted(got) == sorted(WEIGHTS)
    for k, v in WEIGHTS.items():
        assert isinstance(got[k], np.ndarray)
        assert np.array_equal(got[k], v)
    with pytest.raises(KeyError, match='nmt_w_dec'):
        serving.mt_weights(scope, name='nmt')


def test_acquire_step_pins_the_state_and_refuses_feeds():
    main = fluid.Program()
    blk = main.global_block()
    x = blk.create_var(name='x', shape=[3], dtype='float32',
                       persistable=True)
    blk.create_var(name='y', shape=[3], dtype='float32', persistable=True)
    blk.append_op(type='scale', inputs={'X': [x]}, outputs={'Out': [x]},
                  attrs={'scale': 2.0})
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with pytest.raises(ValueError, match='no scope value'):
        exe.acquire_step(main, fetch_list=[x], scope=scope)
    scope.vars['x'] = torch.ones(3)
    scope.vars['y'] = torch.zeros(3)
    h = exe.acquire_step(main, fetch_list=[x], scope=scope)
    # a feedless handle refuses a feed: it is not the acquired signature
    with pytest.raises(ValueError, match='feed signature'):
        h.step(feed={'x': np.ones(3, np.float32)})
    out, = h.step()
    out2, = h.step()
    assert out2.tolist() == [4.0] * 3 and h.steps == 2
    assert scope.vars['x'] is out2 and h.state['x'] is out2
    with torch.no_grad():
        h.state['x'].fill_(5.0)        # in place, as the engine's join
    assert scope.vars['x'].tolist() == [5.0] * 3
    assert h.step()[0].tolist() == [10.0] * 3
    assert h.state['y'] is scope.vars['y'] and sorted(h.state) == ['x', 'y']
