"""The port's LoD beam search (fluid/ops_impl/lod_beam.py, its capacity
form, and the beam_search / beam_search_decode rules of sampled_ops.py)
against the JAX package's, on the CPU.

Every capacity-form function runs in both packages on the same seeded
numpy inputs: ids, LoD and parent rows equal, scores within TOL = 1e-6.
The cases cover ended beams, a source whose live rows have all ended
(PruneEndBeams), dead rows (fewer live rows than the capacity), integer
valued scores (ties, which both break toward the lower index) and a
backtrace over steps a pruned source stops taking part in. The dense
beam_search and beam_search_decode rules run the cases of the JAX
tests/test_ops_sampled.py:78-124 in both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.fluid import lowering as jlow
from paddle_tpu.fluid.ops_impl import lod_beam as jbeam
from paddle_tpu.fluid.ops_impl import sampled_ops as jsampled

from paddle_tpu_torch.fluid import lowering as tlow
from paddle_tpu_torch.fluid.ops_impl import lod_beam as tbeam
from paddle_tpu_torch.fluid.ops_impl import sampled_ops  # noqa: F401

TOL = 1e-6
END = 10


def _jctx():
    import jax
    return jlow.Ctx(jax.random.key(0))


def _tctx():
    return tlow.Ctx(torch.device('cpu'), torch.Generator())


def _seq(pkg, data, lengths, outer, beam_cap=True):
    if pkg == 'jax':
        return jlow.SeqValue(jnp.asarray(data), jnp.asarray(lengths, jnp.int32),
                             tuple(jnp.asarray(o, jnp.int32) for o in outer),
                             beam_cap=beam_cap)
    return tlow.SeqValue(torch.as_tensor(np.asarray(data)),
                         torch.as_tensor(np.asarray(lengths, np.int64)),
                         tuple(torch.as_tensor(np.asarray(o, np.int64))
                               for o in outer), beam_cap=beam_cap)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same(got, want, what=''):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == 'f':
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)


def _same_seq(got, want, what=''):
    assert got.beam_cap == want.beam_cap, what
    _same(got.data, want.data, what + ' data')
    _same(got.lengths, want.lengths, what + ' lengths')
    assert len(got.outer_lengths or ()) == len(want.outer_lengths or ())
    for g, w in zip(got.outer_lengths or (), want.outer_lengths or ()):
        _same(g, w, what + ' outer')


def _step_inputs(seed, B, K, topk, end_frac, ties=False, prune=None):
    """A capacity-form beam step's inputs: per source 1..K live rows (the
    rest dead), pre_ids END with probability end_frac (source `prune`:
    every live row ended), scores normal or integer valued (ties)."""
    rng = np.random.RandomState(seed)
    src_rows = rng.randint(1, K + 1, size=B)
    R = B * K
    live = np.zeros(R, bool)
    for s, n in enumerate(src_rows):
        live[s * K:s * K + n] = True
    pre_ids = np.where(rng.rand(R) < end_frac, END,
                       rng.randint(0, 9, size=R)).astype(np.int64)
    if prune is not None:
        pre_ids[prune * K:(prune + 1) * K] = END
    pre_ids = np.where(live, pre_ids, 0)
    if ties:
        pre_sc = rng.randint(-3, 3, size=R).astype(np.float32)
        sc = rng.randint(-4, 4, size=(R, topk)).astype(np.float32)
    else:
        pre_sc = rng.randn(R).astype(np.float32)
        sc = rng.randn(R, topk).astype(np.float32)
    pre_sc = np.where(live, pre_sc, 0).astype(np.float32)
    ids = rng.randint(0, 30, size=(R, topk)).astype(np.int64)
    l1 = live.astype(np.int64)
    return pre_ids, pre_sc, ids, sc, l1, src_rows


CASES = [
    *[dict(seed=s, B=2, K=3, topk=3, end_frac=0.3) for s in range(6)],
    dict(seed=11, B=3, K=2, topk=4, end_frac=0.0),
    dict(seed=12, B=1, K=4, topk=2, end_frac=0.5),
    dict(seed=13, B=4, K=3, topk=3, end_frac=0.9),
    dict(seed=14, B=2, K=5, topk=5, end_frac=0.3, ties=True),
    dict(seed=15, B=3, K=3, topk=4, end_frac=0.2, ties=True, prune=1),
    dict(seed=16, B=2, K=2, topk=6, end_frac=0.0, ties=True),
    dict(seed=17, B=3, K=4, topk=3, end_frac=0.4, prune=0),
]


def _step_both(case):
    pre_ids, pre_sc, ids, sc, l1, src_rows = _step_inputs(**case)
    K = case['K']
    out = {}
    for pkg, mod in (('jax', jbeam), ('torch', tbeam)):
        conv = jnp.asarray if pkg == 'jax' else torch.as_tensor
        out[pkg] = mod.beam_search_step(
            _seq(pkg, pre_ids[:, None], l1, [src_rows]),
            _seq(pkg, pre_sc[:, None], l1, [src_rows]),
            conv(ids), conv(sc), K, END)
    return out


@pytest.mark.parametrize('case', CASES)
def test_beam_search_step(case):
    out = _step_both(case)
    (jid, jsc, jpar), (tid, tsc, tpar) = out['jax'], out['torch']
    _same_seq(tid, jid, 'selected_ids')
    _same_seq(tsc, jsc, 'selected_scores')
    _same(tpar, jpar, 'parent_rows')
    for v in (tid, tsc):
        assert tbeam.is_beam_form(v)
    _same(tbeam.rows_live(tid), jbeam.rows_live(jid), 'rows_live')
    _same(tbeam.is_empty_beam(tid), jbeam.is_empty_beam(jid), 'is_empty')


@pytest.mark.parametrize('case', CASES[:4] + CASES[-3:])
def test_sequence_expand_beam(case):
    """A parent state [B*K, 1, H] replicated over each parent's children."""
    out = _step_both(case)
    H = 5
    x = np.random.RandomState(case['seed'] + 100).randn(
        case['B'] * case['K'], 1, H).astype(np.float32)
    want = jbeam.sequence_expand_beam(jnp.asarray(x), out['jax'][0])
    got = tbeam.sequence_expand_beam(torch.as_tensor(x), out['torch'][0])
    _same_seq(got, want, 'sequence_expand')


@pytest.mark.parametrize('B,K,topk', [(2, 3, 4), (3, 2, 2), (1, 4, 5)])
def test_normalize_capacity(B, K, topk):
    """Narrow pre-loop inputs (one row a source, the padded feed form
    [B, 1, 1]) brought to capacity form, then stepped."""
    rng = np.random.RandomState(B * 10 + K)
    pre_ids = np.ones((B, 1, 1), np.int64)
    pre_sc = rng.randn(B, 1, 1).astype(np.float32)
    ids = rng.randint(0, 30, size=(B, 1, topk)).astype(np.int64)
    sc = rng.randn(B, 1, topk).astype(np.float32)
    ones = np.ones(B, np.int64)
    got = {}
    for pkg, mod in (('jax', jbeam), ('torch', tbeam)):
        conv = jnp.asarray if pkg == 'jax' else torch.as_tensor
        got[pkg] = mod.normalize_capacity(
            _seq(pkg, pre_ids, ones, [ones], beam_cap=False),
            _seq(pkg, pre_sc, ones, [ones], beam_cap=False),
            conv(ids), conv(sc), K)
    j, t = got['jax'], got['torch']
    _same_seq(t[0], j[0], 'pre_ids')
    _same_seq(t[1], j[1], 'pre_scores')
    _same(t[2], j[2], 'ids')
    _same(t[3], j[3], 'scores')
    js = jbeam.beam_search_step(*j, K, END)
    ts = tbeam.beam_search_step(*t, K, END)
    for a, b in zip(ts[:2], js[:2]):
        _same_seq(a, b, 'step')
    _same(ts[2], js[2], 'parents')


def _array(pkg, steps, length):
    """An ArrayValue over per-step capacity SeqValues (data [R, 1], lod[1],
    lod[0]), padded to capacity T_cap with zero slots."""
    if pkg == 'jax':
        stack = lambda xs: jnp.stack([jnp.asarray(x) for x in xs])
        return jlow.ArrayValue(
            tuple(stack(leaves) for leaves in zip(*steps)),
            jnp.asarray(length, jnp.int32), 1, beam=True)
    stack = lambda xs: torch.stack([torch.as_tensor(np.array(x))
                                    for x in xs])
    return tlow.ArrayValue(tuple(stack(leaves) for leaves in zip(*steps)),
                           torch.tensor(length), 1, beam=True)


def _decode_case(seed, B, K, topk, n_steps, T_cap, end_frac, ties):
    """Steps of the reference algorithm run forward from one row a source
    (beam_search_step in the JAX package), stored as the decoder's arrays
    hold them, with T_cap - n_steps empty slots past the live length."""
    rng = np.random.RandomState(seed)
    R = B * K
    ids0 = np.zeros((R, 1), np.int64)
    ids0[::K] = 1
    sc0 = np.zeros((R, 1), np.float32)
    l1 = np.zeros(R, np.int32)
    l1[::K] = 1
    l0 = np.ones(B, np.int32)
    pre_ids = jlow.SeqValue(jnp.asarray(ids0), jnp.asarray(l1),
                            (jnp.asarray(l0),), beam_cap=True)
    pre_sc = jlow.SeqValue(jnp.asarray(sc0), jnp.asarray(l1),
                           (jnp.asarray(l0),), beam_cap=True)
    ids_steps = [(ids0, l1.astype(np.int64), l0.astype(np.int64))]
    sc_steps = [(sc0, l1.astype(np.int64), l0.astype(np.int64))]
    for _ in range(n_steps - 1):
        cand = np.where(rng.rand(R, topk) < end_frac, END,
                        rng.randint(0, 30, size=(R, topk))).astype(np.int64)
        if ties:
            s = rng.randint(-3, 0, size=(R, topk)).astype(np.float32)
        else:
            s = -rng.rand(R, topk).astype(np.float32)
        s = s + np.asarray(pre_sc.data).reshape(R, 1)
        pre_ids, pre_sc, _ = jbeam.beam_search_step(
            pre_ids, pre_sc, jnp.asarray(cand), jnp.asarray(s), K, END)
        lv = np.asarray(pre_ids.lengths).astype(np.int64)
        ov = np.asarray(pre_ids.outer_lengths[0]).astype(np.int64)
        ids_steps.append((np.asarray(pre_ids.data), lv, ov))
        sc_steps.append((np.asarray(pre_sc.data), lv, ov))
    pad = lambda steps: steps + [tuple(np.zeros_like(x) for x in steps[0])
                                 for _ in range(T_cap - len(steps))]
    return pad(ids_steps), pad(sc_steps), len(ids_steps)


@pytest.mark.parametrize('seed,B,K,topk,n_steps,T_cap,end_frac,ties', [
    (0, 2, 3, 4, 5, 8, 0.2, False),
    (1, 3, 2, 3, 6, 6, 0.5, False),
    (2, 1, 4, 4, 4, 9, 0.0, False),
    (3, 2, 3, 3, 7, 8, 0.6, True),
    (4, 4, 2, 2, 5, 7, 0.9, False),
    (5, 2, 4, 5, 6, 10, 0.3, True),
])
def test_beam_search_decode_arrays(seed, B, K, topk, n_steps, T_cap,
                                   end_frac, ties):
    ids_steps, sc_steps, length = _decode_case(seed, B, K, topk, n_steps,
                                               T_cap, end_frac, ties)
    want = jbeam.beam_search_decode_arrays(
        _array('jax', ids_steps, length), _array('jax', sc_steps, length),
        K, END)
    got = tbeam.beam_search_decode_arrays(
        _array('torch', ids_steps, length),
        _array('torch', sc_steps, length), K, END)
    _same_seq(got[0], want[0], 'sentence_ids')
    _same_seq(got[1], want[1], 'sentence_scores')


def test_backtrace_of_the_jax_hand_built_case():
    """The JAX test_lod_beam.py backtrace case: two sources, three steps,
    uneven beams, source 1 finished and pruned at step 2."""
    B, K = 2, 2

    def cap(data, l1, l0, dt):
        d = np.zeros((B * K, 1), dt)
        lv = np.zeros(B * K, np.int64)
        off = 0
        for s in range(B):
            n = sum(l1[s])
            d[s * K:s * K + n, 0] = data[off:off + n]
            lv[s * K:s * K + len(l1[s])] = l1[s]
            off += n
        return d, lv, np.asarray(l0, np.int64)

    steps = [([1, 1], [0.0, 0.0], [[1], [1]], [1, 1]),
             ([4, 5, 6, 10], [0.1, 0.2, 0.3, 0.4], [[2], [2]], [1, 1]),
             ([10, 7], [0.5, 0.6], [[1, 1], [0, 0]], [2, 2])]
    ids_steps = [cap(np.array(i), l1, l0, np.int64) for i, _, l1, l0 in steps]
    sc_steps = [cap(np.array(s), l1, l0, np.float32)
                for _, s, l1, l0 in steps]
    T_cap = 4
    pad = lambda st: st + [tuple(np.zeros_like(x) for x in st[0])
                           for _ in range(T_cap - len(st))]
    want = jbeam.beam_search_decode_arrays(
        _array('jax', pad(ids_steps), 3), _array('jax', pad(sc_steps), 3),
        K, END)
    got = tbeam.beam_search_decode_arrays(
        _array('torch', pad(ids_steps), 3),
        _array('torch', pad(sc_steps), 3), K, END)
    _same_seq(got[0], want[0], 'sentence_ids')
    _same_seq(got[1], want[1], 'sentence_scores')


def test_is_beam_form_needs_the_flag():
    """Ordinary 2-level data of capacity-like shapes (2 sources x 3 groups
    = 6 rows) is not the beam form without the flag, in either package."""
    data = np.zeros((6, 1), np.float32)
    lens = np.ones(6)
    outer = [np.array([3, 3])]
    for flag in (False, True):
        assert tbeam.is_beam_form(_seq('torch', data, lens, outer, flag)) \
            == jbeam.is_beam_form(_seq('jax', data, lens, outer, flag)) \
            == flag
    assert tbeam.blocks(_seq('torch', data, lens, outer)) == (2, 3)


def test_compact_order():
    rng = np.random.RandomState(0)
    sel = rng.rand(3, 7) < 0.5
    key = np.arange(7)[None, :]
    _same(tbeam._compact_order(torch.as_tensor(sel), torch.as_tensor(key)),
          jbeam._compact_order(jnp.asarray(sel), jnp.asarray(key)))


# ---------------------------------------------------------------------------
# the dense beam_search / beam_search_decode rules
# ---------------------------------------------------------------------------

def _rule_both(op, ins, attrs):
    from paddle_tpu_torch.fluid import lowering as tl
    j = getattr(jsampled, op)({k: [jnp.asarray(v)] for k, v in ins.items()},
                              attrs, _jctx())
    t = tl.get_rule(op.lstrip('_'))(
        {k: [torch.as_tensor(v)] for k, v in ins.items()}, attrs, _tctx())
    assert set(t) == set(j)
    for k in j:
        _same(t[k], j[k], k)
    return t


def test_dense_beam_search_step():
    out = _rule_both('_beam_search', {
        'pre_ids': np.array([[4], [5]], np.int64),
        'pre_scores': np.array([[0.0], [0.0]], np.float32),
        'ids': np.array([[10, 11, 12], [20, 21, 22]], np.int64),
        'scores': np.array([[0.1, 0.9, 0.3], [0.8, 0.2, 0.7]], np.float32)},
        {'beam_size': 2, 'end_id': 1})
    assert list(out['selected_ids'][:, 0]) == [11, 20]
    assert list(out['parent_idx']) == [0, 1]


def test_dense_beam_search_finished_beam_carries_score():
    out = _rule_both('_beam_search', {
        'pre_ids': np.array([[1], [5]], np.int64),
        'pre_scores': np.array([[2.0], [0.0]], np.float32),
        'ids': np.array([[10, 11], [20, 21]], np.int64),
        'scores': np.array([[9.9, 9.8], [0.5, 0.4]], np.float32)},
        {'beam_size': 2, 'end_id': 1})
    assert out['selected_ids'][0, 0] == 1
    assert abs(float(out['selected_scores'][0, 0]) - 2.0) < 1e-6


@pytest.mark.parametrize('seed,ties', [(0, False), (1, True), (2, True)])
def test_dense_beam_search_random(seed, ties):
    rng = np.random.RandomState(seed)
    B, beam, K = 3, 3, 4
    pre = np.where(rng.rand(B * beam, 1) < 0.3, 1,
                   rng.randint(2, 9, size=(B * beam, 1))).astype(np.int64)
    sc = (rng.randint(-3, 3, size=(B * beam, K)) if ties
          else rng.randn(B * beam, K)).astype(np.float32)
    _rule_both('_beam_search', {
        'pre_ids': pre,
        'pre_scores': rng.randn(B * beam, 1).astype(np.float32),
        'ids': rng.randint(0, 30, size=(B * beam, K)).astype(np.int64),
        'scores': sc}, {'beam_size': beam, 'end_id': 1})


def test_dense_beam_search_decode_backtrace():
    ids = np.array([[[7, 8]], [[9, 10]], [[11, 12]]], np.int64)
    parents = np.array([[[0, 1]], [[1, 0]], [[0, 1]]], np.int64)
    scores = np.zeros((3, 1, 2), np.float32)
    scores[-1] = [[5.0, 3.0]]
    out = _rule_both('_beam_search_decode',
                     {'Ids': ids, 'Scores': scores, 'Parents': parents}, {})
    assert list(out['SentenceIds'][0, 0]) == [8, 9, 11]
    assert list(out['SentenceIds'][0, 1]) == [7, 10, 12]


@pytest.mark.parametrize('with_parents', [False, True])
def test_dense_beam_search_decode_end_id(with_parents):
    rng = np.random.RandomState(3)
    T, B, beam = 5, 2, 3
    ins = {'Ids': rng.randint(0, 4, size=(T, B, beam)).astype(np.int64),
           'Scores': rng.randn(T, B, beam).astype(np.float32)}
    if with_parents:
        ins['Parents'] = rng.randint(0, B * beam,
                                     size=(T, B, beam)).astype(np.int64)
    _rule_both('_beam_search_decode', ins, {'end_id': 1})
