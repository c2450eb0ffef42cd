"""The CRF, CTC, edit-distance and chunk-eval rules of the PyTorch port
(ops_impl/crf_ctc_ops.py) against the JAX package's rule for the same op
type, called directly in both packages on the same seeded numpy inputs
(the helpers of test_torch_sequence_ops.py): forward values within
VALUE_TOL (1e-6, rtol and atol), the VJPs of linear_chain_crf (Emission
and Transition) and warpctc (Logits) within GRAD_TOL (1e-5).

Every batch is ragged, with a length-1 row and a row as long as the padded
axis. Ties are exact (integer-valued emissions and transitions): the
Viterbi path and ctc_align's argmax take the first maximum in both. Labels
past C and negative labels give JAX's values (a gather along the class
axis reads NaN past C, a plain index wraps once and clamps) with no raise.
Ids, paths, SequenceNum and the chunk counts are int64 in the port and
int32 in the JAX package (x64 off); every output's dtype is stated.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import lowering as tlow

from test_torch_sequence_ops import (Seq, _compare_value, _run_jax,
                                     _run_port, check)

B, T, C = 4, 6, 5
LENS = np.array([3, 1, T, 4])             # a length-1 and a full row


def _seq(rng, *trail, lengths=LENS, t=T, scale=1.0):
    x = (rng.randn(len(lengths), t, *trail) * scale).astype('float32')
    for i, n in enumerate(lengths):
        x[i, n:] = 0
    return Seq(x, lengths)


def _ids(rng, hi, lengths=LENS, t=T, lo=0):
    x = rng.randint(lo, hi, (len(lengths), t, 1)).astype('int64')
    for i, n in enumerate(lengths):
        x[i, n:] = 0
    return Seq(x, lengths)


def _crf_ins(seed=0, label=None, ties=False):
    rng = np.random.RandomState(seed)
    if ties:
        em = _seq(rng, C)
        em.data[:] = np.round(em.data * 1.5)
        trans = np.round(rng.randn(C + 2, C)).astype('float32')
    else:
        em = _seq(rng, C)
        trans = (rng.randn(C + 2, C) * 0.5).astype('float32')
    return {'Emission': [em], 'Transition': [trans],
            'Label': [label if label is not None else _ids(rng, C)]}


# -- linear_chain_crf ---------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1])
def test_linear_chain_crf_values_and_vjp(seed):
    ins = _crf_ins(seed)
    out = check('linear_chain_crf', ins, {},
                ['LogLikelihood', 'Alpha', 'EmissionExps', 'TransitionExps'],
                'LogLikelihood')
    assert out['LogLikelihood'].shape == (B, 1)
    assert np.isfinite(out['LogLikelihood'].detach().numpy()).all()


def test_linear_chain_crf_on_a_dense_emission():
    """A dense [B, T, C] emission: every row is full length."""
    ins = _crf_ins(2)
    ins['Emission'] = [ins['Emission'][0].data]
    ins['Label'] = [ins['Label'][0].data]
    check('linear_chain_crf', ins, {}, ['LogLikelihood', 'Alpha'],
          'LogLikelihood')


def test_linear_chain_crf_one_step_batch():
    """T 1: no transition step, alpha is the start row."""
    rng = np.random.RandomState(3)
    ins = {'Emission': [_seq(rng, C, lengths=np.array([1, 1]), t=1)],
           'Transition': [(rng.randn(C + 2, C)).astype('float32')],
           'Label': [_ids(rng, C, lengths=np.array([1, 1]), t=1)]}
    check('linear_chain_crf', ins, {}, ['LogLikelihood', 'Alpha'],
          'LogLikelihood')


@pytest.mark.parametrize('bad', [C, C + 3, -1, -4, -C - 2])
def test_linear_chain_crf_out_of_range_labels(bad):
    """A label past C or below 0 at the start, inside and at the end of a
    row: JAX's values (NaN where the emission gather reads past C, the
    clamped transition rows elsewhere), with no raise; the VJP too."""
    rng = np.random.RandomState(4)
    label = _ids(rng, C)
    label.data[0, 0, 0] = bad                 # a start label
    label.data[2, 3, 0] = bad                 # inside the full row
    label.data[3, 3, 0] = bad                 # the last label of row 3
    ins = _crf_ins(4, label=label)
    out = check('linear_chain_crf', ins, {}, ['LogLikelihood', 'Alpha'],
                'LogLikelihood')
    nll = out['LogLikelihood'].detach().numpy()[:, 0]
    if bad >= C:
        assert np.isnan(nll[[0, 2, 3]]).all() and np.isfinite(nll[1])
    elif bad >= -C:
        assert np.isfinite(nll).all()


def test_linear_chain_crf_jax_index_modes_at_minus_four():
    """-4 with C = 3 reads row 0 of the start weights, as JAX's a[label]
    does (wrap once to -1, clamp to 0)."""
    rng = np.random.RandomState(5)
    em = _seq(rng, 3, lengths=np.array([2]), t=2)
    label = Seq(np.array([[[-4], [1]]], 'int64'), np.array([2]))
    trans = rng.randn(5, 3).astype('float32')
    ins = {'Emission': [em], 'Transition': [trans], 'Label': [label]}
    out = check('linear_chain_crf', ins, {}, ['LogLikelihood'])
    zero = dict(ins, Label=[Seq(np.array([[[0], [1]]], 'int64'),
                                np.array([2]))])
    want = _run_port('linear_chain_crf', zero, {})['LogLikelihood']
    # the emission gather wraps -4 + 3 = -1 to NaN, the start row to 0
    assert np.isnan(out['LogLikelihood'].item())
    assert np.isfinite(want.item())


# -- crf_decoding -------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_crf_decoding_path(seed):
    ins = _crf_ins(seed)
    del ins['Label']
    out = check('crf_decoding', ins, {}, ['ViterbiPath'])['ViterbiPath']
    assert out.data.dtype == torch.int64 and out.data.shape == (B, T, 1)


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_crf_decoding_at_exact_ties(seed):
    """Integer-valued emissions and transitions: many exact ties in the
    Viterbi maxima and the last argmax; both take the first."""
    ins = _crf_ins(seed, ties=True)
    del ins['Label']
    check('crf_decoding', ins, {}, ['ViterbiPath'])
    zeros = dict(ins, Emission=[Seq(np.zeros((B, T, C), 'float32'), LENS)],
                 Transition=[np.zeros((C + 2, C), 'float32')])
    out = check('crf_decoding', zeros, {}, ['ViterbiPath'])
    assert not out['ViterbiPath'].data.any()


def test_crf_decoding_with_a_label():
    """With Label: the 0/1 match mask, zero past each length."""
    ins = _crf_ins(6)
    path = _run_port('crf_decoding', {k: v for k, v in ins.items()
                                      if k != 'Label'}, {})['ViterbiPath']
    label = ins['Label'][0]
    label.data[:, :2] = path.data[:, :2].numpy()   # some tokens right
    out = check('crf_decoding', ins, {}, ['ViterbiPath'])['ViterbiPath']
    mask = out.data.numpy()[:, :, 0]
    assert set(np.unique(mask)) <= {0, 1} and mask[:, :1].all()
    for i, n in enumerate(LENS):
        assert not mask[i, n:].any()


def test_crf_decoding_one_step_batch():
    rng = np.random.RandomState(7)
    ins = {'Emission': [_seq(rng, C, lengths=np.array([1, 1, 1]), t=1)],
           'Transition': [rng.randn(C + 2, C).astype('float32')]}
    check('crf_decoding', ins, {}, ['ViterbiPath'])


# -- ctc_align ----------------------------------------------------------------

@pytest.mark.parametrize('merge', [True, False])
@pytest.mark.parametrize('blank', [0, 2])
def test_ctc_align_from_ids(merge, blank):
    rng = np.random.RandomState(8)
    ids = _ids(rng, 4)
    ids.data[2, :4, 0] = [1, 1, blank, 1]     # a repeat across a blank
    check('ctc_align', {'Input': [ids]},
          {'blank': blank, 'merge_repeated': merge}, ['Output'])


def test_ctc_align_from_probabilities_at_exact_ties():
    """Probabilities with tied maxima: the first class wins in both."""
    rng = np.random.RandomState(9)
    x = Seq(np.round(rng.rand(B, T, C) * 2).astype('float32'), LENS)
    out = check('ctc_align', {'Input': [x]}, {'blank': 0},
                ['Output'])['Output']
    assert out.data.dtype == torch.int64 and out.lengths.dtype == torch.int64


def test_ctc_align_dense_ids():
    rng = np.random.RandomState(10)
    ids = rng.randint(0, 3, (B, T)).astype('int64')
    check('ctc_align', {'Input': [ids]}, {'blank': 0}, ['Output'])


def test_compact_is_stable():
    """Left compaction keeps the kept tokens' order (a stable argsort)."""
    from paddle_tpu_torch.fluid.ops_impl.crf_ctc_ops import _compact
    ids = torch.tensor([[5, 6, 7, 8, 9, 4]])
    keep = torch.tensor([[False, True, False, True, True, False]])
    packed, n = _compact(ids, keep)
    assert packed[0, :3].tolist() == [6, 8, 9] and n.tolist() == [3]
    assert packed[0, 3:].tolist() == [5, 7, 4]


# -- warpctc ------------------------------------------------------------------

def _ctc_ins(seed, n_lab=3, lab_lens=(2, 1, 3, 0), bad=None):
    rng = np.random.RandomState(seed)
    logits = _seq(rng, C)
    label = _ids(rng, C, lengths=np.array(lab_lens), t=n_lab, lo=1)
    if bad is not None:
        label.data[2, 1, 0] = bad
    return {'Logits': [logits], 'Label': [label]}


@pytest.mark.parametrize('norm', [False, True])
@pytest.mark.parametrize('blank', [0, 3])
def test_warpctc_values_and_vjp(norm, blank):
    out = check('warpctc', _ctc_ins(11), {'blank': blank,
                                          'norm_by_times': norm},
                ['Loss'], 'Loss')
    assert out['WarpCTCGrad'] is None and out['Loss'].shape == (B, 1)


def test_warpctc_repeated_labels():
    ins = _ctc_ins(12)
    ins['Label'][0].data[2, :3, 0] = [2, 2, 2]
    check('warpctc', ins, {}, ['Loss'], 'Loss')


@pytest.mark.parametrize('bad', [C, -2])
def test_warpctc_out_of_range_labels(bad):
    out = check('warpctc', _ctc_ins(13, bad=bad), {}, ['Loss'], 'Loss')
    loss = out['Loss'].detach().numpy()[:, 0]
    assert np.isnan(loss[2]) == (bad >= C)


# -- edit_distance ------------------------------------------------------------

def _ed_ins(seed, hl=(3, 1, T, 4), rl=(2, 1, 5, 4)):
    rng = np.random.RandomState(seed)
    hyp = _ids(rng, 4, lengths=np.array(hl))
    ref = _ids(rng, 4, lengths=np.array(rl))
    return {'Hyps': [hyp], 'Refs': [ref]}


@pytest.mark.parametrize('ignored', [[], [0], [0, 3]])
@pytest.mark.parametrize('normalized', [True, False])
def test_edit_distance(normalized, ignored):
    out = check('edit_distance', _ed_ins(14),
                {'normalized': normalized, 'ignored_tokens': ignored},
                ['Out', 'SequenceNum'])
    assert out['SequenceNum'].dtype == torch.int64
    assert out['SequenceNum'].item() == B


def test_edit_distance_known_values():
    hyp = Seq(np.array([[[1], [2], [3]], [[4], [0], [0]]], 'int64'),
              np.array([3, 1]))
    ref = Seq(np.array([[[1], [3], [0]], [[5], [6], [4]]], 'int64'),
              np.array([2, 3]))
    out = check('edit_distance', {'Hyps': [hyp], 'Refs': [ref]},
                {'normalized': False}, ['Out'])
    assert out['Out'][:, 0].tolist() == [1.0, 2.0]


def test_edit_distance_dense():
    rng = np.random.RandomState(15)
    ins = {'Hyps': [rng.randint(0, 3, (B, 4)).astype('int64')],
           'Refs': [rng.randint(0, 3, (B, 5)).astype('int64')]}
    check('edit_distance', ins, {}, ['Out', 'SequenceNum'])


# -- chunk_eval ---------------------------------------------------------------

_TAG_NUM = {'plain': 1, 'IOB': 2, 'IOE': 2, 'IOBES': 4}
_CHUNK_OUTS = ['Precision', 'Recall', 'F1-Score', 'NumInferChunks',
               'NumLabelChunks', 'NumCorrectChunks']


@pytest.mark.parametrize('excluded', [[], [1]])
@pytest.mark.parametrize('scheme', ['plain', 'IOB', 'IOE', 'IOBES'])
def test_chunk_eval(scheme, excluded):
    rng = np.random.RandomState(16)
    n_types = 3
    hi = n_types * _TAG_NUM[scheme] + 1       # the O tag included
    lens = np.array([7, 1, 12, 9])
    lab = _ids(rng, hi, lengths=lens, t=12)
    inf = Seq(lab.data.copy(), lens)
    flip = rng.rand(*inf.data.shape) < 0.3
    inf.data[flip] = rng.randint(0, hi, flip.sum())
    for i, n in enumerate(lens):
        inf.data[i, n:] = 0
    out = check('chunk_eval', {'Inference': [inf], 'Label': [lab]},
                {'chunk_scheme': scheme, 'num_chunk_types': n_types,
                 'excluded_chunk_types': excluded}, _CHUNK_OUTS)
    assert out['NumLabelChunks'].item() > 0
    for k in _CHUNK_OUTS[3:]:
        assert out[k].dtype == torch.int64 and out[k].ndim == 0


def test_chunk_eval_no_chunks():
    """All O tags: precision, recall and F1 are 0, no division by 0."""
    o = Seq(np.full((2, 4, 1), 6, 'int64'), np.array([4, 2]))
    out = check('chunk_eval', {'Inference': [o], 'Label': [o]},
                {'chunk_scheme': 'IOB', 'num_chunk_types': 3}, _CHUNK_OUTS)
    assert out['F1-Score'].item() == 0.0


# -- dtypes -------------------------------------------------------------------

DTYPES = {
    # op: {output: (the port's dtype, the JAX package's dtype)}
    'linear_chain_crf': {'LogLikelihood': ('float32', 'float32'),
                         'Alpha': ('float32', 'float32'),
                         'EmissionExps': ('float32', 'float32'),
                         'TransitionExps': ('float32', 'float32')},
    'crf_decoding': {'ViterbiPath': ('int64', 'int32')},
    'ctc_align': {'Output': ('int64', 'int32')},
    'warpctc': {'Loss': ('float32', 'float32')},
    'edit_distance': {'Out': ('float32', 'float32'),
                      'SequenceNum': ('int64', 'int32')},
    'chunk_eval': {'Precision': ('float32', 'float32'),
                   'Recall': ('float32', 'float32'),
                   'F1-Score': ('float32', 'float32'),
                   'NumInferChunks': ('int64', 'int32'),
                   'NumLabelChunks': ('int64', 'int32'),
                   'NumCorrectChunks': ('int64', 'int32')},
}


def _dtype_ins(op):
    if op in ('linear_chain_crf', 'crf_decoding'):
        ins = _crf_ins(0)
        if op == 'crf_decoding':
            del ins['Label']
        return ins, {}
    if op == 'ctc_align':
        return {'Input': [_ids(np.random.RandomState(0), 3)]}, {}
    if op == 'warpctc':
        return _ctc_ins(0), {}
    if op == 'edit_distance':
        return _ed_ins(0), {}
    lab = _ids(np.random.RandomState(0), 7)
    return {'Inference': [lab], 'Label': [lab]}, {'num_chunk_types': 3}


@pytest.mark.parametrize('op', sorted(DTYPES))
def test_output_dtypes(op):
    ins, attrs = _dtype_ins(op)
    j, t = _run_jax(op, ins, attrs), _run_port(op, ins, attrs)
    for slot, (tdt, jdt) in DTYPES[op].items():
        jv, tv = j[slot], t[slot]
        jd = jv.data if hasattr(jv, 'lengths') else jv
        td = tv.data if isinstance(tv, tlow.SeqValue) else tv
        assert str(np.asarray(jd).dtype) == jdt, (op, slot)
        assert str(td.dtype) == 'torch.' + tdt, (op, slot)
        if isinstance(tv, tlow.SeqValue):
            assert tv.lengths.dtype == torch.int64
        _compare_value(jv, tv, '%s.%s' % (op, slot))


def test_rules_run_under_shape_inference():
    """Build-time shape inference (meta tensors, the time axis stood in by
    DYN_DIM) runs every rule: the layers declare the JAX shapes."""
    from paddle_tpu_torch.fluid import framework, unique_name
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        em = tfluid.layers.data('em', shape=[C], dtype='float32',
                                lod_level=1)
        lab = tfluid.layers.data('lab', shape=[1], dtype='int64',
                                 lod_level=1)
        nll = tfluid.layers.linear_chain_crf(
            em, lab, param_attr=tfluid.ParamAttr(name='crfw'))
        path = tfluid.layers.crf_decoding(
            em, param_attr=tfluid.ParamAttr(name='crfw'))
        dec = tfluid.layers.ctc_greedy_decoder(em, blank=0)
        loss = tfluid.layers.warpctc(em, lab)
        dist, num = tfluid.layers.edit_distance(dec, lab)
        chunk = tfluid.layers.chunk_eval(path, lab, 'IOB', 2)
    assert nll.shape == (-1, 1) and loss.shape == (-1, 1)
    assert path.dtype == 'int64' and path.lod_level == 1
    assert dist.shape == (-1, 1) and num.dtype == 'int64'
    assert [v.dtype for v in chunk] == ['float32'] * 3 + ['int64'] * 3


# -- through the Executor -----------------------------------------------------

def _ctc_program(pkg):
    """A per-step fc over a sequence feed into warpctc, with the greedy
    decode and its edit distance to the label fetched beside the loss;
    Adam."""
    fluid, framework, unique_name = pkg
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[8], dtype='float32',
                              lod_level=1)
        lab = fluid.layers.data(name='lab', shape=[1], dtype='int64',
                                lod_level=1)
        logits = fluid.layers.fc(input=x, size=C)
        loss = fluid.layers.mean(fluid.layers.warpctc(logits, lab, blank=0))
        dec = fluid.layers.ctc_greedy_decoder(
            fluid.layers.softmax(logits), blank=0)
        dist, _ = fluid.layers.edit_distance(dec, lab, normalized=False)
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss, dist


def test_warpctc_trains_through_the_executor():
    """Three Adam steps of a CTC program in both packages from the JAX
    startup weights: the losses within 1e-5, the decodes' edit distances
    equal. warpctc's WarpCTCGrad output is None in both."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid import framework as jframework
    from paddle_tpu.fluid import unique_name as junique
    from paddle_tpu.fluid.executor import Scope as JScope
    from paddle_tpu_torch.fluid import framework as tframework
    from paddle_tpu_torch.fluid import unique_name as tunique
    rng = np.random.RandomState(17)
    batches = []
    for _ in range(3):
        lens = rng.randint(3, 9, 4)
        batches.append([(rng.randn(n, 8).astype('float32').tolist(),
                         rng.randint(1, C, max(1, n // 2)).tolist())
                        for n in lens])
    jmain, jstart, jloss, jdist = _ctc_program((jfluid, jframework,
                                                junique))
    scope = JScope()
    with jfluid.scope_guard(scope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.array(v) for n, v in scope.vars.items()}
        feeder = jfluid.DataFeeder(['x', 'lab'], jfluid.CPUPlace(),
                                   program=jmain)
        want = [jexe.run(jmain, feed=feeder.feed(b),
                         fetch_list=[jloss, jdist]) for b in batches]
    tmain, _, tloss, tdist = _ctc_program((tfluid, tframework, tunique))
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.load_state_dict(init, program=tmain, scope=tscope)
    feeder = tfluid.DataFeeder(['x', 'lab'], tfluid.CPUPlace(),
                               program=tmain)
    got = [texe.run(tmain, feed=feeder.feed(b), fetch_list=[tloss, tdist],
                    scope=tscope) for b in batches]
    np.testing.assert_allclose([float(np.asarray(g[0]).reshape(()))
                                for g in got],
                               [float(np.asarray(w[0]).reshape(()))
                                for w in want], rtol=0, atol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g[1]), np.asarray(w[1]))
    assert got[0][0] != got[-1][0]
