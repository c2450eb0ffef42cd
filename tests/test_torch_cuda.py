"""The PyTorch port's CUDA kernels on the card, against their plain torch
versions. A CUDA kernel has no interpret mode, so these tests need a card:
they carry the `cuda` marker and skip without one. On a machine with a
card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(the conftest only sets JAX up; these tests import no JAX).

Tolerance 1e-4 in fp32 for the forward: the kernel sums in tile order
(3xTF32 products) with an online softmax, the plain version in one product
and one softmax. 3e-4
for the backward kernels, the Pallas backward's own tolerance
(tests/test_flash_attention.py:64). 1e-6 for the sparse optimizer kernels,
the Pallas kernels' (tests/test_kernels.py:182): kernel and plain version
evaluate the same fp32 expression; the rows form, which sums each id's
rows in the CPU's order, is held bitwise against its plain version with
the merge on the CPU. 1e-5 + 1e-5*|plain| for the paged
decode attention, the Pallas kernel's (tests/test_kernels.py:127): an
online softmax against one softmax over the gathered rows. The image rules
(conv2d, pool2d, batch_norm, softmax, cross_entropy, top_k, accuracy,
momentum: cuDNN and torch library calls, no kernel of the port) on the
card against the CPU at 1e-5 of each output's max |x| (conv 1e-4, the CPU
tests' tolerances against the JAX rules), top_k's ids exactly with ties;
a bottleneck stage's training step at 1e-4 of each gradient's max |g|.
The captured step (fluid/step_artifact.py): a replay against the eager
walk, bitwise, for a small Transformer, DeepFM and the paged decode step;
captured dropout against eager dropout and run_bundle's inner steps,
bitwise; launch counts under replay; a held device fetch unchanged by the
next replay; Scope.load_numpy seen by the next replay; a step that cannot
be captured raising with its op's name. The sequence rules on the card
under sync debug against the CPU (1e-5), and a small stacked-LSTM step
captured in two time buckets, its replays bitwise the eager walk. The
speculative decode step under sync debug against the CPU (1e-5, every
attend a paged_attention launch), the speculative engine token-exact
against the beam-1 engine on the card, and machine_translation's
generating program captured, its replays bitwise the eager walk. The six
CRF/CTC rules under sync debug against the CPU (1e-5; out-of-range labels
give the CPU's NaNs and leave the card usable), and a small
label_semantic_roles step captured, its replays bitwise the eager walk.
The high-level Trainer: double_buffer through warm-up, capture and replay
bitwise the inline feed, Executor._place_feed staging into pinned host
memory only, each checkpoint with async steps in flight equal to the scope
after a synchronize, a load_checkpoint between replays reaching the next
replay, and a preempted Trainer resumed bitwise. Online training: push_rows
into a Predictor whose bucket is captured reaching the next replay with no
capture (1e-6 against a fresh Predictor given the rows), and RowResetter
zeroing the captured DeepFM step's static tables in place, the stream on
the card against the CPU at 1e-5. Token streaming and the compiled
artifact: the flash-attention forward operator against its plain version
(fp32 1e-4, bf16 within 2 bf16 ulps of the largest |O|), one launch a
call; a Transformer artifact exported and loaded on the card against the
same one exported on the CPU (1e-4 of max(1, |logit|)), captured once;
abort, resume and decode push_rows reaching the next replay with the
captures unchanged. Tiered embedding storage: the spill and restore on CUDA
tensors in place and bitwise the CPU path, a pinned restore buffer
surviving a non_blocking copy, and a tiered stream keeping its one
capture, against the same stream on the CPU (1e-5). The pass pipeline and
int8: dequantize and quant_lookup_table under sync debug bitwise the CPU
(out-of-range ids and padding_idx included); a mark_quant program captured
and replayed against the CPU (1e-6); the AMP pass's step with ctx.amp off
launching only the bf16 attention kernels, its loss within one bf16 ulp of
runtime AMP's on the card. The rest of the training surface: the extra
and sampled rules under sync debug against the CPU (1e-5, the index
outputs exactly), nce and sampling_id captured in one graph drawing anew
each replay (Cost against nce_cost at the drawn negatives, 1e-5), and the
bilinear resize to an output dim of 1, forward and VJP (1e-5). Data
parallelism on a one-rank NCCL group: set_mesh, ParallelExecutor and
ZeRO-3 steps captured, bitwise the plain step, an NCCL kernel in the
replay.
"""
import contextlib
import importlib
import os
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

tfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
TOL = 1e-4
BWD_TOL = 3e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernels run only there)')
    return torch.device('cuda', 0)


def _fwd_case(card, B, H, Tq, Tk, D, seed):
    """Forward inputs: randn q, k, v; batch row 0 padded from Tk // 2 on,
    key 0 live. Returns (q, k, v, kb)."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    q, k, v = [torch.randn((B, H, T, D), generator=g, device=card)
               for T in (Tq, Tk, Tk)]
    kb = torch.zeros((B, Tk), device=card)
    kb[0, Tk // 2:] = -1e9          # one padded sequence, key 0 live
    return q, k, v, kb


def _fwd_matches_plain(q, k, v, kb, causal):
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_attention_lse(q, k, v, key_bias=kb, causal=causal)
    torch.cuda.synchronize()
    assert tfa.KERNEL.launches == before + 1
    o_ref, lse_ref = tfa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                   causal=causal)
    torch.testing.assert_close(o, o_ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL, atol=TOL)
    return o, lse


# D 6 and 20: no 16-byte copies (D not a multiple of 4); D 20 and 40: the
# summation over d zero-padded to 32 and 64; D 128: q split at each use;
# without causal masking (D <= 64) two strips a warp
@pytest.mark.parametrize('D', [6, 16, 20, 40, 64, 128])
@pytest.mark.parametrize('Tq,Tk,causal', [(64, 64, False), (64, 64, True),
                                          (100, 37, False), (130, 130, True),
                                          (1, 70, False)])
def test_flash_attention_kernel_matches_plain(card, D, Tq, Tk, causal):
    _fwd_matches_plain(*_fwd_case(card, 2, 3, Tq, Tk, D,
                                  Tq * 1000 + Tk + D), causal)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [64, 128])
def test_flash_attention_kernel_long_sequences(card, D, causal):
    """T = 1000: up to 16 key tiles a block, many more than the copy ring's
    2 stages, and a ragged last tile; 128-row blocks (two strips a warp)
    without causal masking at D = 64, 64-row blocks otherwise."""
    _fwd_matches_plain(*_fwd_case(card, 1, 2, 1000, 1000, D, 1000 + D),
                       causal)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_kernel_is_deterministic(card, causal):
    """Each block owns the rows it writes and sums in a fixed order: two
    launches on the same inputs are bitwise equal, O and lse."""
    q, k, v, kb = _fwd_case(card, 2, 4, 200, 200, 64, 13)
    first = tfa._flash_lse_cuda(q, k, v, kb, causal, 0.125)
    second = tfa._flash_lse_cuda(q, k, v, kb, causal, 0.125)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [20, 64])
def test_flash_attention_kernel_takes_unaligned_views(card, D, causal):
    """Contiguous q, k and v views that start one float into their
    storage: not 16-byte aligned, so the kernel must take its 4-byte
    copies (a misaligned 16-byte cp.async would fault the context)."""
    q, k, v, kb = _fwd_case(card, 2, 3, 100, 90, D, 17)

    def shifted(t):
        base = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = base[1:].view(t.shape)
        view.copy_(t)
        return view

    q, k, v = map(shifted, (q, k, v))
    assert all(t.is_contiguous() and t.data_ptr() % 16 != 0
               for t in (q, k, v))
    _fwd_matches_plain(q, k, v, kb, causal)


# -- the bf16 variants ---------------------------------------------------------

def bf16_tol(ref):
    """Two bf16 ulps of the tensor's largest magnitude: the kernel and its
    plain version round the same fp32 function to bf16 once, from sums
    taken in other orders (and the kernel's P and dS carried to 2^-16 by
    their hi/lo split)."""
    m = float(ref.detach().abs().max().float())
    return 2.0 * 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _bf16(*ts):
    return [t.to(torch.bfloat16).contiguous() for t in ts]


def _bf16_fwd_matches_plain(q, k, v, kb, causal):
    before = (tfa.KERNEL_BF16.launches, tfa.KERNEL.launches)
    o, lse = tfa.flash_attention_lse(q, k, v, key_bias=kb, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.KERNEL_BF16.launches, tfa.KERNEL.launches) == \
        (before[0] + 1, before[1])
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o_ref, lse_ref = tfa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                   causal=causal)
    tol = bf16_tol(o_ref)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL, atol=TOL)
    return o, lse


# D 6 and 20: 4-byte copies (D not a multiple of 8); D 7: element copies
# and odd stores; D 20 and 40: the summation over d zero-padded
@pytest.mark.parametrize('D', [6, 7, 16, 20, 40, 64, 128])
@pytest.mark.parametrize('Tq,Tk,causal', [(64, 64, False), (64, 64, True),
                                          (100, 37, False), (130, 130, True),
                                          (1, 70, False)])
def test_flash_attention_bf16_kernel_matches_plain(card, D, Tq, Tk, causal):
    q, k, v, kb = _fwd_case(card, 2, 3, Tq, Tk, D, Tq * 1000 + Tk + D)
    _bf16_fwd_matches_plain(*_bf16(q, k, v), kb, causal)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [64, 128])
def test_flash_attention_bf16_kernel_long_sequences(card, D, causal):
    q, k, v, kb = _fwd_case(card, 1, 2, 1000, 1000, D, 1000 + D)
    _bf16_fwd_matches_plain(*_bf16(q, k, v), kb, causal)


def _bwd_bf16_case(card, B, H, Tq, Tk, D, causal, seed):
    """_bwd_case's inputs in bf16: q, k, v and dO bf16, O from the bf16
    forward, lse and delta fp32."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    q, k, v = _bf16(*[torch.randn((B, H, T, D), generator=g, device=card)
                      for T in (Tq, Tk, Tk)])
    kb = torch.zeros((B, Tk), device=card)
    kb[0, Tk // 2:] = -1e9
    o, lse = tfa.flash_attention_lse(q, k, v, key_bias=kb, causal=causal)
    do = torch.randn(o.shape, generator=g, device=card).to(torch.bfloat16)
    dlse = torch.randn(lse.shape, generator=g, device=card)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    return q, k, v, kb, do, lse, delta


def _bwd_bf16_matches_plain(args, causal, D):
    fp32 = (tfa.KERNEL_BWD_DQ.launches, tfa.KERNEL_BWD_DKV.launches)
    before = (tfa.KERNEL_BWD_DQ_BF16.launches,
              tfa.KERNEL_BWD_DKV_BF16.launches)
    dq, dk, dv = tfa._flash_bwd_cuda(*args, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert (tfa.KERNEL_BWD_DQ_BF16.launches,
            tfa.KERNEL_BWD_DKV_BF16.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert (tfa.KERNEL_BWD_DQ.launches,
            tfa.KERNEL_BWD_DKV.launches) == fp32
    want = tfa.flash_attention_bwd_plain(*args, causal, D ** -0.5)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=bf16_tol(ref))
    return dq, dk, dv


@pytest.mark.parametrize('D', [6, 7, 16, 20, 40, 64, 128])
@pytest.mark.parametrize('Tq,Tk,causal', [(64, 64, False), (64, 64, True),
                                          (100, 37, False), (130, 130, True),
                                          (37, 100, True), (1, 70, False)])
def test_flash_attention_bf16_bwd_kernels_match_plain(card, D, Tq, Tk,
                                                      causal):
    args = _bwd_bf16_case(card, 2, 3, Tq, Tk, D, causal,
                          Tq * 1000 + Tk + D + 7)
    _bwd_bf16_matches_plain(args, causal, D)


def test_flash_attention_bf16_bwd_kernels_long_causal(card):
    args = _bwd_bf16_case(card, 1, 2, 1024, 1024, 64, True, 1024)
    _bwd_bf16_matches_plain(args, True, 64)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_bf16_kernels_are_deterministic(card, causal):
    """Two launches of each bf16 kernel on the same inputs are bitwise
    equal."""
    args = _bwd_bf16_case(card, 2, 4, 200, 200, 64, causal, 19)
    q, k, v, kb = args[:4]
    outs = [tfa._flash_lse_cuda(q, k, v, kb, causal, 0.125)
            + tfa._flash_bwd_cuda(*args, causal, 0.125) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(_bits(a), _bits(b))


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize('shift', [1, 2])
@pytest.mark.parametrize('D', [20, 64])
def test_flash_attention_bf16_kernels_take_unaligned_views(card, D, shift):
    """Contiguous bf16 views that start 2 or 4 bytes into their storage:
    the kernels must take their element or 4-byte copies."""
    q, k, v, kb, do, lse, delta = _bwd_bf16_case(card, 2, 3, 100, 90, D,
                                                 True, 5 + shift)

    def shifted(t):
        base = torch.empty(t.numel() + shift, dtype=t.dtype, device=card)
        view = base[shift:].view(t.shape)
        view.copy_(t)
        return view

    q, k, v, do = map(shifted, (q, k, v, do))
    assert all(t.is_contiguous() and t.data_ptr() % 16 != 0
               for t in (q, k, v, do))
    _bf16_fwd_matches_plain(q, k, v, kb, True)
    _bwd_bf16_matches_plain((q, k, v, kb, do, lse, delta), True, D)


def _shifted(t, shift):
    """A contiguous copy of t that starts `shift` elements into its
    storage."""
    base = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = base[shift:].view(t.shape)
    view.copy_(t)
    return view


def _bf16_kernel_matches_plain(kernel, args, causal, D):
    """The bf16 forward ('fwd') or backward pair ('bwd') on _bwd_bf16_case's
    operands against its plain version; returns its outputs."""
    if kernel == 'fwd':
        return _bf16_fwd_matches_plain(*args[:4], causal)
    return _bwd_bf16_matches_plain(args, causal, D)


def _copy_mode(kernel, args):
    """The copy mode the kernel's launch takes: the forward passes q in
    dO's place."""
    q, k, v, _, do = args[:5]
    return tfa._bf16_copy_mode(q, k, v, q if kernel == 'fwd' else do)


BF16_KERNELS = ['fwd', 'bwd']


@pytest.mark.parametrize('kernel', BF16_KERNELS)
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [16, 64, 128])
def test_flash_attention_bf16_takes_the_tma(card, D, causal, kernel):
    """D a multiple of 8 on fresh (16-byte aligned) tensors: the kernels
    fill their tiles by TMA, and agree with the plain version."""
    args = _bwd_bf16_case(card, 2, 3, 130, 100, D, causal, 31 + D)
    assert _copy_mode(kernel, args) == 'tma'
    _bf16_kernel_matches_plain(kernel, args, causal, D)


@pytest.mark.parametrize('kernel', BF16_KERNELS)
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [6, 20, 64])
def test_flash_attention_bf16_takes_4_byte_copies(card, D, causal, kernel):
    """Views 4 bytes into their storage (D even): not 16-byte aligned, so
    the kernels write their swizzled tiles with 4-byte copies, and agree
    with the plain version."""
    q, k, v, kb, do, lse, delta = _bwd_bf16_case(card, 2, 3, 100, 90, D,
                                                 causal, 41 + D)
    q, k, v, do = (_shifted(t, 2) for t in (q, k, v, do))
    args = (q, k, v, kb, do, lse, delta)
    assert _copy_mode(kernel, args) == '4-byte'
    _bf16_kernel_matches_plain(kernel, args, causal, D)


@pytest.mark.parametrize('kernel', BF16_KERNELS)
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_bf16_kernels_span_waves(card, causal, kernel):
    """B * H = 512 at T = 256: 2048 blocks of 64 rows (1024 of 128), more
    than two waves over the card's SMs."""
    args = _bwd_bf16_case(card, 64, 8, 256, 256, 64, causal, 512)
    assert _copy_mode(kernel, args) == 'tma'
    _bf16_kernel_matches_plain(kernel, args, causal, 64)


@pytest.mark.parametrize('kernel', BF16_KERNELS)
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_bf16_kernels_are_deterministic_at_d128(card, causal,
                                                                kernel):
    """Two launches of the bf16 kernels at D = 128 (two column blocks a
    tile; dK/dV takes its queries 32 at a time) are bitwise equal."""
    args = _bwd_bf16_case(card, 2, 4, 200, 200, 128, causal, 23)
    if kernel == 'fwd':
        outs = [tfa._flash_lse_cuda(*args[:4], causal, 128 ** -0.5)
                for _ in range(2)]
    else:
        outs = [tfa._flash_bwd_cuda(*args, causal, 128 ** -0.5)
                for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize('kernel', BF16_KERNELS)
def test_flash_attention_bf16_kernels_take_fully_masked_rows(card, kernel):
    """Batch row 1's bias masks every key (-1e9): its scores, running max
    and lse sit near -1e9, where fp32 steps by 64, and only their
    differences are small. The outputs stay finite and agree with the plain
    version."""
    args = _bwd_bf16_case(card, 2, 3, 128, 128, 64, False, 59)
    kb = args[3]
    kb[1] = -1e9
    q, k, v = args[:3]
    o, lse = tfa.flash_attention_lse(q, k, v, key_bias=kb)
    do = args[4]
    delta = (do.float() * o.float()).sum(-1).contiguous()
    outs = _bf16_kernel_matches_plain(kernel, (q, k, v, kb, do, lse, delta),
                                      False, 64)
    assert all(bool(torch.isfinite(x.float()).all()) for x in outs)


def test_flash_attention_bf16_refuses_mixed_dtypes(card):
    q, k, v, kb = _fwd_case(card, 1, 2, 64, 64, 64, 3)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.to(torch.bfloat16), k, v, key_bias=kb)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), k.half(), v.half(), key_bias=kb)


def test_transformer_on_the_card_matches_the_cpu(card, tmp_path):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import transformer as T
    cfg = dict(src_vocab_size=100, trg_vocab_size=100, max_length=40,
               n_layer=2, d_model=64, n_head=4, d_inner=128)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    scope = fluid.Scope()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        T.transformer(**cfg)
    blk = main.global_block()
    lg = [op.input('Logits')[0] for op in blk.ops
          if op.type == 'softmax_with_cross_entropy'][0]
    logits = [op.input('X')[0] for op in blk.ops
              if op.type == 'reshape' and op.output('Out')[0] == lg][0]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(tmp_path), ['src_word', 'trg_word'],
                                  [blk.var(logits)], exe, main_program=main,
                                  scope=scope)
    r = np.random.RandomState(0)
    feed = {n: r.randint(1, 100, (3, 40)).astype('int64')
            for n in ('src_word', 'trg_word')}
    feed['trg_word'][1, 17:] = 0
    before = tfa.KERNEL.launches
    got = inference.Predictor(str(tmp_path)).run(feed)[0]
    assert tfa.KERNEL.launches == before + 3 * cfg['n_layer']
    want = inference.Predictor(str(tmp_path),
                               place=fluid.CPUPlace()).run(feed)[0]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _bwd_case(card, B, H, Tq, Tk, D, causal, seed):
    """Backward inputs as the autograd Function makes them: the forward
    kernel's O and lse, random cotangents dO and dlse, delta =
    rowsum(dO * O) - dlse. Batch row 0 is padded from Tk // 2 on, key 0
    live. Returns (q, k, v, kb, do, lse, delta)."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    q, k, v = [torch.randn((B, H, T, D), generator=g, device=card)
               for T in (Tq, Tk, Tk)]
    kb = torch.zeros((B, Tk), device=card)
    kb[0, Tk // 2:] = -1e9          # one padded sequence, key 0 live
    o, lse = tfa.flash_attention_lse(q, k, v, key_bias=kb, causal=causal)
    do = torch.randn(o.shape, generator=g, device=card)
    dlse = torch.randn(lse.shape, generator=g, device=card)
    delta = ((do * o).sum(-1) - dlse).contiguous()
    return q, k, v, kb, do, lse, delta


def _bwd_matches_plain(args, causal, D):
    before = (tfa.KERNEL_BWD_DQ.launches, tfa.KERNEL_BWD_DKV.launches)
    dq, dk, dv = tfa._flash_bwd_cuda(*args, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert (tfa.KERNEL_BWD_DQ.launches, tfa.KERNEL_BWD_DKV.launches) == \
        (before[0] + 1, before[1] + 1)
    want = tfa.flash_attention_bwd_plain(*args, causal, D ** -0.5)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=BWD_TOL, atol=BWD_TOL)
    return dq, dk, dv


# D 6: no 16-byte copies (D not a multiple of 4); D 20 and 40: the
# summation over d zero-padded to 32 and 64
@pytest.mark.parametrize('D', [6, 16, 20, 40, 64, 128])
@pytest.mark.parametrize('Tq,Tk,causal', [(64, 64, False), (64, 64, True),
                                          (100, 37, False), (130, 130, True),
                                          (37, 100, True), (1, 70, False)])
def test_flash_attention_bwd_kernels_match_plain(card, D, Tq, Tk, causal):
    args = _bwd_case(card, 2, 3, Tq, Tk, D, causal, Tq * 1000 + Tk + D + 7)
    _bwd_matches_plain(args, causal, D)


def test_flash_attention_bwd_kernels_long_causal(card):
    """T = 1024, causal: 16 tiles a block at most, many more than the
    copy ring's 2 stages."""
    args = _bwd_case(card, 1, 2, 1024, 1024, 64, True, 1024)
    _bwd_matches_plain(args, True, 64)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_bwd_kernels_are_deterministic(card, causal):
    """Each block owns the rows it writes and sums in a fixed order: two
    launches on the same inputs are bitwise equal."""
    args = _bwd_case(card, 2, 4, 200, 200, 64, causal, 11)
    first = tfa._flash_bwd_cuda(*args, causal, 0.125)
    second = tfa._flash_bwd_cuda(*args, causal, 0.125)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize('D', [20, 64])
def test_flash_attention_bwd_kernels_take_unaligned_views(card, D):
    """Contiguous q, k, v and dO views that start one float into their
    storage: not 16-byte aligned, so the kernels must take their 4-byte
    copies (a misaligned 16-byte cp.async would fault the context)."""
    q, k, v, kb, do, lse, delta = _bwd_case(card, 2, 3, 100, 90, D, True, 5)

    def shifted(t):
        base = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = base[1:].view(t.shape)
        view.copy_(t)
        return view

    q, k, v, do = map(shifted, (q, k, v, do))
    assert all(t.is_contiguous() and t.data_ptr() % 16 != 0
               for t in (q, k, v, do))
    _bwd_matches_plain((q, k, v, kb, do, lse, delta), True, D)


def test_autograd_on_the_card_matches_the_cpu(card):
    """The Function on CUDA tensors (both kernels, launched once each)
    against the same Function on the CPU (both plain versions)."""
    r = np.random.RandomState(3)
    arrays = [r.randn(2, 4, 96, 64).astype('float32') for _ in range(3)]
    kb = np.zeros((2, 96), 'float32')
    kb[1, 50:] = -1e9
    wo = r.randn(2, 4, 96, 64).astype('float32')
    wl = r.randn(2, 4, 96).astype('float32')
    grads = {}
    for dev in ('cpu', card):
        q, k, v = [torch.tensor(a, device=dev, requires_grad=True)
                   for a in arrays]
        o, lse = tfa.flash_attention_lse(
            q, k, v, key_bias=torch.tensor(kb, device=dev), causal=True)
        loss = (o * torch.tensor(wo, device=dev)).sum() + \
            (lse * torch.tensor(wl, device=dev)).sum()
        grads[str(dev)] = [t.cpu() for t in torch.autograd.grad(
            loss, [q, k, v])]
    for got, want in zip(grads[str(card)], grads['cpu']):
        torch.testing.assert_close(got, want, rtol=BWD_TOL, atol=BWD_TOL)


def test_sources_build_once_and_bind_every_entry(card):
    """ops/_cuda.py builds each source once, with its kernels bound from
    the one library: the backward's two entry points share it."""
    from paddle_tpu_torch import ops
    ops.build_all()
    libs = {k.library.library_path() for k in ops.KERNELS.values()}
    assert len(libs) == len({k.source for k in ops.KERNELS.values()})
    assert all(os.path.exists(p) for p in libs)
    assert tfa.KERNEL_BWD_DQ.library is tfa.KERNEL_BWD_DKV.library
    assert tfa.KERNEL_BWD_DQ._load() is not tfa.KERNEL_BWD_DKV._load()


def test_training_step_on_the_card_matches_the_cpu(card):
    """A small Transformer's training step (dropout off, Adam) from the same
    weights on the card and on the CPU: loss and every gradient, 3
    launches of each attention kernel per layer pair and step, and none
    of any other kernel."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import transformer as T
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _, _ = T.transformer(100, 100, 40, n_layer=2, d_model=64,
                                       n_head=4, d_inner=128,
                                       dropout_rate=0.0)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    gnames = [op for op in main.global_block().ops
              if op.type == 'autodiff'][0].attrs['grad_names']
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    r = np.random.RandomState(1)
    feed = {n: r.randint(1, 100, (3, 40)).astype('int64')
            for n in ('src_word', 'trg_word', 'lbl_word')}
    feed['trg_word'][1, 17:] = 0
    feed['lbl_word'][1, 17:] = 0
    outs = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        scope.load_numpy(cpu_scope.to_numpy(), place)
        before = {n: k.launches for n, k in ops.KERNELS.items()}
        outs[type(place).__name__] = fluid.Executor(place).run(
            main, feed=feed, fetch_list=[avg_cost] + gnames, scope=scope)
        launched = {n: k.launches - before[n]
                    for n, k in ops.KERNELS.items()}
        per_kernel = 3 * 2 if isinstance(place, fluid.CUDAPlace) else 0
        # the fp32 attention kernels; their bf16 variants (AMP's) and the
        # sparse optimizer kernels never run here (no AMP, no is_sparse
        # table)
        want = {n: per_kernel if n.startswith('flash_attention')
                and not n.endswith('_bf16') else 0 for n in launched}
        assert launched == want
    for got, ref in zip(outs['CUDAPlace'], outs['CPUPlace']):
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * scale)


# -- the fused sparse optimizer kernels --------------------------------------

tso = importlib.import_module('paddle_tpu_torch.ops.kernels.sparse_optim')
SPARSE_TOL = 1e-6      # the Pallas kernel test's (tests/test_kernels.py:182)


def _sparse_case(card, kind, D, V=1000, n=600):
    """A merge as _merge_sparse makes it, on the card: 'random' ids from
    the whole table, 'dups' from 0..63 (most slots invalid and clamped to
    row 0), 'invalid' none valid."""
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.ops_impl.optim_ops import _merge_sparse
    g = torch.Generator(device=card)
    g.manual_seed(V + n + D)
    high = 64 if kind == 'dups' else V
    ids = torch.randint(0, high, (n,), generator=g, device=card)
    ids[:2] = 0
    rows = torch.randn((n, D), generator=g, device=card)
    uids, gm, valid = _merge_sparse(lowering.SparseRows(ids, rows, (V, D)))
    if kind == 'invalid':
        valid = torch.zeros_like(valid)
        gm = torch.zeros_like(gm)
    tables = [torch.randn((V, D), generator=g, device=card) * 0.5,
              torch.rand((V, D), generator=g, device=card),
              torch.rand((V, D), generator=g, device=card) * 0.1]
    return uids, gm, valid, tables


@pytest.mark.parametrize('kind', ['random', 'dups', 'invalid'])
@pytest.mark.parametrize('D', [1, 10, 33])
@pytest.mark.parametrize('opt', ['adagrad', 'adam'])
def test_sparse_kernels_match_plain(card, opt, D, kind):
    uids, gm, valid, tables = _sparse_case(card, kind, D)
    lr = torch.tensor(0.05, device=card)
    if opt == 'adagrad':
        kernel, n_tables = tso.KERNEL_ADAGRAD, 2
        call = lambda fn, ts: fn(*ts, uids, gm, valid, lr, 1e-6)
        fns = (tso.fused_sparse_adagrad, tso.fused_sparse_adagrad_plain)
    else:
        kernel, n_tables = tso.KERNEL_ADAM, 3
        call = lambda fn, ts: fn(*ts, uids, gm, valid, lr, 0.9, 0.999, 1e-8)
        fns = (tso.fused_sparse_adam, tso.fused_sparse_adam_plain)
    before = tables[:n_tables]
    got_in = [t.clone() for t in before]
    want_in = [t.clone() for t in before]
    launches = kernel.launches
    got = call(fns[0], got_in)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert all(o is t for o, t in zip(got, got_in))
    want = call(fns[1], want_in)
    for g, w, b in zip(got, want, before):
        torch.testing.assert_close(g, w, rtol=0, atol=SPARSE_TOL)
        if kind == 'invalid':
            assert torch.equal(g.view(torch.int32), b.view(torch.int32))


def test_sparse_kernel_wrapper_refuses_what_it_does_not_take(card):
    uids, gm, valid, tables = _sparse_case(card, 'random', 4)
    lr = torch.tensor(0.05, device=card)
    with pytest.raises(ValueError, match='lr'):
        tso.fused_sparse_adagrad(tables[0], tables[1], uids, gm, valid,
                                 torch.tensor(0.05), 1e-6)
    with pytest.raises(ValueError, match='gm'):
        tso.fused_sparse_adagrad(tables[0], tables[1], uids, gm.double(),
                                 valid, lr, 1e-6)
    with pytest.raises(ValueError, match='table'):
        tso.fused_sparse_adagrad(tables[0], tables[1].t(), uids, gm, valid,
                                 lr, 1e-6)
    with pytest.raises(ValueError, match='uids'):
        tso.fused_sparse_adagrad(tables[0], tables[1], uids.int(), gm, valid,
                                 lr, 1e-6)


def _rows_ids(card, kind, n, V):
    """'random' ids from the whole table, 'dups' from 0..63, 'skewed' one
    id n // 8 times and four n // 32 times among random ones, 'single' one
    id; id 0 among the first two."""
    g = torch.Generator(device=card)
    g.manual_seed(n + V)
    ids = torch.randint(0, 64 if kind == 'dups' else V, (n,), generator=g,
                        device=card)
    ids[:2] = 0
    if kind == 'skewed':
        ids[2:2 + n // 8] = 17
        for k in range(4):
            lo = 2 + n // 8 + k * (n // 32)
            ids[lo:lo + n // 32] = 100 + k
        ids = ids[torch.randperm(n, generator=g, device=card)]
    elif kind == 'single':
        ids[:] = 17
    return ids


def _rows_call(opt, fn, tables, ids, rows, lr):
    if opt == 'adagrad':
        return fn(*tables[:2], ids, rows, lr, 1e-6)
    return fn(*tables, ids, rows, lr, 0.9, 0.999, 1e-8)


def _rows_case_on(card, kind, D, V=1000, n=600):
    ids = _rows_ids(card, kind, n, V)
    g = torch.Generator(device=card)
    g.manual_seed(V + n + D)
    rows = torch.randn((n, D), generator=g, device=card) * 0.05
    tables = [torch.randn((V, D), generator=g, device=card) * 0.5,
              torch.rand((V, D), generator=g, device=card),
              torch.rand((V, D), generator=g, device=card) * 0.1]
    return ids, rows, tables


_ROWS = {'adagrad': (tso.fused_sparse_adagrad_rows,
                     tso.fused_sparse_adagrad_rows_plain, tso.KERNEL_ADAGRAD,
                     2),
         'adam': (tso.fused_sparse_adam_rows, tso.fused_sparse_adam_rows_plain,
                  tso.KERNEL_ADAM, 3)}


def _cpu_order_plain(opt, tables, ids, rows, lr):
    """The rows form's plain version with its merge on the CPU, whose
    index_add_ adds each id's rows in ascending sorted position (on the
    card its atomics add them in run-to-run order, which moves a sum of
    hundreds of rows by more than 1e-6), then the plain update on the
    card, whose elementwise operations round as the kernel's intrinsics
    do."""
    uids, gm, valid = [t.to(ids.device) for t in tso.merge_rows(
        ids.cpu(), rows.cpu())]
    if opt == 'adagrad':
        return tso.fused_sparse_adagrad_plain(*tables, uids, gm, valid, lr,
                                              1e-6)
    return tso.fused_sparse_adam_plain(*tables, uids, gm, valid, lr, 0.9,
                                       0.999, 1e-8)


@pytest.mark.parametrize('kind', ['random', 'dups', 'skewed', 'single'])
@pytest.mark.parametrize('D', [1, 10, 33])
@pytest.mark.parametrize('opt', ['adagrad', 'adam'])
def test_sparse_rows_kernel_matches_plain(card, opt, D, kind):
    """The rows form (sort, then one launch that sums each id's rows and
    updates its row) against its plain version with the merge in the
    CPU's order: bitwise equal, so within SPARSE_TOL; within SPARSE_TOL of
    the plain version wholly on the card where no id repeats more than
    the random ids do. One launch a call, the very tables returned,
    untouched rows bitwise kept, a second launch bitwise equal."""
    fused, plain, kernel, nt = _ROWS[opt]
    ids, rows, tables = _rows_case_on(card, kind, D)
    tables = tables[:nt]
    lr = torch.tensor(0.05, device=card)
    got_in = [t.clone() for t in tables]
    launches = kernel.launches
    got = _rows_call(opt, fused, got_in, ids, rows, lr)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert all(o is t for o, t in zip(got, got_in))
    again = _rows_call(opt, fused, [t.clone() for t in tables], ids, rows,
                       lr)
    want = _cpu_order_plain(opt, [t.clone() for t in tables], ids, rows, lr)
    on_card = _rows_call(opt, plain, [t.clone() for t in tables], ids, rows,
                         lr)
    untouched = torch.ones(tables[0].shape[0], dtype=torch.bool, device=card)
    untouched[ids] = False
    for g, a, w, c, b in zip(got, again, want, on_card, tables):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        assert torch.equal(g[untouched].view(torch.int32),
                           b[untouched].view(torch.int32))
        if kind == 'random':
            torch.testing.assert_close(g, c, rtol=0, atol=SPARSE_TOL)


@pytest.mark.parametrize('opt', ['adagrad', 'adam'])
def test_sparse_sorted_kernel_takes_int64_ids(card, opt):
    """launch_sorted on int64 sorted ids (a vocabulary past int32) gives
    the int32 route's tables bitwise."""
    _, _, kernel, nt = _ROWS[opt]
    ids, rows, tables = _rows_case_on(card, 'skewed', 10)
    lr = torch.tensor(0.05, device=card)
    hyper = (1e-6,) if nt == 2 else (0.9, 0.999, 1e-8)
    outs = []
    for vocab in (tables[0].shape[0], 2 ** 31):
        sids, order = tso.sort_ids(ids, vocab)
        ts = [t.clone() for t in tables[:nt]]
        tso.launch_sorted(ts, sids, order, rows, lr, *hyper)
        outs.append((sids.dtype, ts))
    assert outs[0][0] == torch.int32 and outs[1][0] == torch.int64
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_sparse_rows_wrapper_refuses_what_it_does_not_take(card):
    ids, rows, tables = _rows_case_on(card, 'random', 4)
    lr = torch.tensor(0.05, device=card)
    p, m = tables[:2]
    with pytest.raises(ValueError, match='rows'):
        tso.fused_sparse_adagrad_rows(p, m, ids, rows.double(), lr, 1e-6)
    with pytest.raises(ValueError, match='ids'):
        tso.fused_sparse_adagrad_rows(p, m, ids.float(), rows, lr, 1e-6)
    with pytest.raises(ValueError, match='ids'):
        tso.fused_sparse_adagrad_rows(p, m, ids.cpu(), rows, lr, 1e-6)
    with pytest.raises(ValueError, match='lr'):
        tso.fused_sparse_adagrad_rows(p, m, ids, rows, torch.tensor(0.05),
                                      1e-6)
    with pytest.raises(ValueError, match='table'):
        tso.fused_sparse_adam_rows(p, m, tables[2].t(), ids, rows, lr, 0.9,
                                   0.999, 1e-8)
    with pytest.raises(ValueError, match='order'):
        sids, order = tso.sort_ids(ids, p.shape[0])
        tso.launch_sorted([p, m], sids, order.int(), rows, lr, 1e-6)


@pytest.mark.parametrize('opt', ['adam', 'adagrad'])
def test_sparse_deepfm_step_on_the_card_matches_the_cpu(card, opt):
    """A small deepfm(is_sparse=True) for 3 steps from the same weights on
    the card and on the CPU: losses, tables and moments, and 2 launches
    per step of the optimizer's sparse kernel (one per FM table). The
    kernel sums duplicate rows in the CPU's order (no atomics); the fc
    products and the CPU's sqrt round differently."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import deepfm
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feat = fluid.layers.data(name='feat_ids', shape=[6], dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        cost, _, _ = deepfm.deepfm(feat, label, num_fields=6, vocab_size=64,
                                   embed_dim=4, hidden=[16], is_sparse=True)
        (fluid.optimizer.Adam(learning_rate=1e-2) if opt == 'adam' else
         fluid.optimizer.Adagrad(learning_rate=0.05)).minimize(cost)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    r = np.random.RandomState(2)
    feeds = [{'feat_ids': r.randint(0, 64, (16, 6)).astype('int64'),
              'label': r.randint(0, 2, (16, 1)).astype('int64')}
             for _ in range(3)]
    kernel = tso.KERNEL_ADAM if opt == 'adam' else tso.KERNEL_ADAGRAD
    runs = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        scope.load_numpy(init.to_numpy(), place)
        exe = fluid.Executor(place)
        launches = kernel.launches
        losses = [exe.run(main, feed=f, fetch_list=[cost], scope=scope)[0]
                  for f in feeds]
        want = 2 * len(feeds) if isinstance(place, fluid.CUDAPlace) else 0
        assert kernel.launches - launches == want
        runs[type(place).__name__] = (losses, scope.to_numpy())
    (gl, gs), (wl, ws) = runs['CUDAPlace'], runs['CPUPlace']
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-6)
    for n, w in ws.items():
        np.testing.assert_allclose(gs[n], w, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


# -- the paged decode attention kernel ---------------------------------------

tpa = importlib.import_module('paddle_tpu_torch.ops.kernels.paged_attention')


def _paged_case(seed, C, beam, ps, npe, src_cap, D, lo=1, masked_slot=None):
    """A paged encoder pool as the engine lays it out: page 0 the zero
    page, each slot's pages drawn from a permutation of the rest, a length
    in [lo, src_cap] setting the mask, tail entries on page 0; the
    `masked_slot` owns no page (an inactive slot)."""
    r = np.random.RandomState(seed)
    n_pages = 1 + C * npe
    enc = (r.randn(n_pages, ps, D) * 0.5).astype('float32')
    enc[0] = 0.0
    mask = np.zeros((n_pages, ps), 'float32')
    free = list(r.permutation(np.arange(1, n_pages)))
    pt = np.zeros((C, npe), 'int32')
    for c in range(C):
        ln = 0 if c == masked_slot else int(r.randint(lo, src_cap + 1))
        for j in range(-(-ln // ps)):
            pt[c, j] = free.pop()
            mask[pt[c, j], :max(0, min(ps, ln - j * ps))] = 1.0
    q = (r.randn(C * beam, D) * 0.3).astype('float32')
    return q, enc, mask, pt


@pytest.mark.parametrize('C,beam,ps,npe,src_cap,D,masked', [
    (16, 3, 16, 2, 32, 1024, None),     # the main decode path
    (16, 3, 16, 2, 29, 1024, None),     # src_cap not a multiple of ps
    (16, 3, 16, 2, 32, 1024, 5),        # one fully masked slot
    (64, 1, 16, 2, 32, 1024, None),     # beam 1, the speculative shape
    (4, 3, 3, 2, 5, 6, 1),              # the test decoder's width
    (3, 2, 4, 3, 10, 200, None),        # D not a multiple of 128
    (16, 3, 16, 16, 250, 1024, None),   # a long source: 4 chunks of 64
    (3, 2, 4, 3, 10, 20, None),         # D 20, one block a slot
    (8, 3, 16, 2, 32, 1000, None),      # D 1000: 4 blocks of 252, 244
    (4, 3, 16, 2, 32, 1001, None),      # D 1001: 4-byte copies, 4 blocks
    (8, 3, 16, 2, 32, 2048, None),      # D 2048: 8 blocks of 256
    (2, 20, 4, 3, 10, 64, None),        # beam 20: two groups of rows
])
def test_paged_attention_kernel_matches_plain(card, C, beam, ps, npe,
                                              src_cap, D, masked):
    args = [torch.from_numpy(a).to(card) for a in _paged_case(
        C * 100 + D + src_cap, C, beam, ps, npe, src_cap, D,
        masked_slot=masked)]
    before = tpa.KERNEL.launches
    got = tpa.paged_attention(*args, src_cap)
    torch.cuda.synchronize()
    assert tpa.KERNEL.launches == before + 1
    want = tpa.paged_attention_plain(*args, src_cap)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all(), \
        float((got - want).abs().max())


def test_paged_attention_kernel_reads_pages_shared_across_slots(card):
    """Prefix-cache hits: slots whose tables name the same pages."""
    r = np.random.RandomState(11)
    C, beam, ps, npe, D = 6, 3, 16, 4, 1024
    enc = (r.randn(1 + C * npe, ps, D) * 0.5).astype('float32')
    enc[0] = 0.0
    mask = (r.rand(1 + C * npe, ps) > 0.2).astype('float32')
    mask[0] = 0.0
    pt = (1 + r.permutation(C * npe)).reshape(C, npe).astype('int32')
    pt[1::2, :2] = pt[0, :2]            # odd slots share slot 0's prefix
    pt[2, 3] = pt[3, 3] = pt[4, 1]
    q = (r.randn(C * beam, D) * 0.3).astype('float32')
    args = [torch.from_numpy(a).to(card) for a in (q, enc, mask, pt)]
    for src_cap in (64, 50):
        got = tpa.paged_attention(*args, src_cap)
        want = tpa.paged_attention_plain(*args, src_cap)
        assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all(), \
            float((got - want).abs().max())


@pytest.mark.parametrize('npe,src_cap,D', [(2, 32, 1024), (16, 250, 1024),
                                           (2, 32, 1001)])
def test_paged_attention_kernel_is_deterministic(card, npe, src_cap, D):
    """Every block of a cluster sums the partial scores in rank order:
    two launches are bitwise equal."""
    args = [torch.from_numpy(a).to(card) for a in _paged_case(
        5, 16, 3, 16, npe, src_cap, D)]
    a = tpa.paged_attention(*args, src_cap)
    b = tpa.paged_attention(*args, src_cap)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_paged_attention_launcher_refuses_a_bad_plan(card):
    """The C entry point checks the plan it is given and the wrapper
    raises on its error: a cluster of 3, a slice that leaves a block
    empty, a chunk past 64."""
    q, enc, mask, pt = [torch.from_numpy(a).to(card) for a in _paged_case(
        1, 2, 3, 4, 2, 8, 16)]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(card).cuda_stream
    for n, width, chunk in ((3, 8, 8), (4, 8, 8), (1, 16, 65)):
        with pytest.raises(RuntimeError, match='paged_attention'):
            tpa.KERNEL.launch(q.data_ptr(), enc.data_ptr(), mask.data_ptr(),
                              pt.data_ptr(), out.data_ptr(), 6, 3, 2, 4, 16,
                              8, n, width, chunk, 3, stream)


def test_paged_attention_wrapper_refuses_what_it_does_not_take(card):
    q, enc, mask, pt = [torch.from_numpy(a).to(card) for a in _paged_case(
        1, 2, 3, 4, 2, 8, 16)]
    with pytest.raises(ValueError, match='pt_enc'):
        tpa.paged_attention(q, enc, mask, pt.long(), 8)
    with pytest.raises(ValueError, match='src_cap'):
        tpa.paged_attention(q, enc, mask, pt, 9)
    with pytest.raises(ValueError, match='q'):
        tpa.paged_attention(q[:5], enc, mask, pt, 8)


def test_paged_attention_takes_unaligned_contiguous_views(card):
    """Contiguous views that start one float into their storage: the pool
    is not 16-byte aligned, so the kernel must not take its float4 loads
    (a misaligned vector load would fault the context)."""
    args = [torch.from_numpy(a).to(card) for a in _paged_case(
        3, 4, 3, 16, 2, 32, 1024)]

    def shifted(t):
        base = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        v = base[1:].view(t.shape)
        v.copy_(t)
        return v

    q, enc = shifted(args[0]), shifted(args[1])
    assert enc.is_contiguous() and enc.data_ptr() % 16 != 0
    got = tpa.paged_attention(q, enc, args[2], args[3], 32)
    want = tpa.paged_attention_plain(*args, 32)
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all(), \
        float((got - want).abs().max())


@pytest.mark.parametrize('bundle', [1, 3])
def test_paged_decode_on_the_card_matches_the_dense_engine(card, bundle):
    """The paged DecodeEngine on the card (the kernel, one launch per step
    dispatch and bundled step) against the dense engine on the card (no
    kernel): equal tokens, scores within 1e-5."""
    from paddle_tpu_torch import serving
    r = np.random.RandomState(7)
    V, E, D, H, K, SRC, T = 20, 8, 6, 8, 3, 5, 8
    w = {'w_dec': r.randn(E + D, 4 * H) * 0.3,
         'u_dec': r.randn(H, 4 * H) * 0.3,
         'b_dec': r.randn(1, 4 * H) * 0.1, 'w_q': r.randn(H, D) * 0.3,
         'w_emb': r.randn(V, E) * 0.3, 'w_out': r.randn(H, V) * 0.3,
         'b_out': r.randn(1, V) * 0.1}
    encs = [(r.randn(r.randint(2, SRC + 1), D) * 0.5).astype('float32')
            for _ in range(8)]
    lims = [int(r.randint(1, T + 1)) for _ in encs]
    out, launched = {}, {}
    for paged in (True, False):
        kw = dict(page_size=3, pages=8) if paged else {}
        eng = serving.DecodeEngine(w, serving.DecodeConfig(
            slots=3, beam_size=K, max_len=T, src_cap=SRC, bundle=bundle,
            **kw))
        before = tpa.KERNEL.launches
        try:
            eng.warmup()
            futs = [eng.submit({'enc': e}, max_new_tokens=n)
                    for e, n in zip(encs, lims)]
            out[paged] = [f.result(120) for f in futs]
            steps = eng._handle.steps
        finally:
            eng.shutdown()
        launched[paged] = (tpa.KERNEL.launches - before, steps)
    assert launched[True][0] == bundle * launched[True][1]
    assert launched[False][0] == 0
    for (tp, sp), (td, sd) in zip(out[True], out[False]):
        assert np.array_equal(tp, td)
        np.testing.assert_allclose(sp, sd, rtol=1e-5, atol=1e-5)


# -- the image rules (cuDNN and torch library calls) --------------------------

IMAGE_TOL = 1e-5        # of each output's max |x|; conv 1e-4, as on the CPU
CONV_TOL = 1e-4


def _rule_on(device, op_type, ins, attrs, is_test=False):
    from paddle_tpu_torch.fluid import lowering
    ctx = lowering.Ctx(device, torch.Generator(device=device),
                       is_test=is_test)
    outs = lowering.get_rule(op_type)(
        {s: [torch.from_numpy(np.array(a)).to(device) for a in vs]
         for s, vs in ins.items()}, attrs, ctx)
    return {k: v for k, v in outs.items() if isinstance(v, torch.Tensor)}


def _card_matches_cpu(card, op_type, ins, attrs, tol=IMAGE_TOL,
                      is_test=False):
    got = _rule_on(card, op_type, ins, attrs, is_test)
    want = _rule_on(torch.device('cpu'), op_type, ins, attrs, is_test)
    for slot, w in want.items():
        g = got[slot]
        assert g.device.type == 'cuda', slot
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-12) if w.dtype.kind == 'f' \
            else 0
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                   atol=tol * scale, err_msg=slot)
    return got, want


def _nhwc(x, fmt):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1)) if fmt == 'NHWC' \
        else x


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('strides,paddings,dilations,groups', [
    (1, 0, 1, 1), (2, 3, 1, 1), (1, 2, 2, 1), (2, 1, 1, 2)])
def test_conv2d_on_the_card_matches_the_cpu(card, fmt, strides, paddings,
                                            dilations, groups):
    r = np.random.RandomState(3)
    ins = {'Input': [_nhwc(r.randn(4, 8, 20, 18).astype('float32'), fmt)],
           'Filter': [r.randn(16, 8 // groups, 3, 3).astype('float32')]}
    _card_matches_cpu(card, 'conv2d', ins, dict(
        strides=[strides] * 2, paddings=[paddings] * 2,
        dilations=[dilations] * 2, groups=groups, data_format=fmt),
        tol=CONV_TOL)


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('attrs', [
    dict(pooling_type='max', ksize=[2, 2], strides=[2, 2]),
    dict(pooling_type='avg', ksize=[3, 3], strides=[2, 2]),
    dict(pooling_type='avg', ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
         exclusive=True, ceil_mode=True),
    dict(pooling_type='max', ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
         ceil_mode=True),
    dict(pooling_type='avg', ksize=[1, 1], global_pooling=True)])
def test_pool2d_on_the_card_matches_the_cpu(card, fmt, attrs):
    r = np.random.RandomState(4)
    x = _nhwc(r.randn(4, 8, 15, 14).astype('float32'), fmt)
    _card_matches_cpu(card, 'pool2d', {'X': [x]},
                      dict(attrs, data_format=fmt))


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('is_test', [False, True])
def test_batch_norm_on_the_card_matches_the_cpu(card, fmt, is_test):
    r = np.random.RandomState(5)
    ins = {'X': [_nhwc(r.randn(8, 6, 7, 7).astype('float32') * 2 + 1, fmt)],
           'Scale': [r.randn(6).astype('float32')],
           'Bias': [r.randn(6).astype('float32')],
           'Mean': [r.randn(6).astype('float32') * 0.1],
           'Variance': [np.abs(r.randn(6)).astype('float32') + 0.5]}
    _card_matches_cpu(card, 'batch_norm', ins, dict(
        momentum=0.9, epsilon=1e-5, is_test=is_test, data_layout=fmt))


def test_softmax_cross_entropy_and_momentum_on_the_card(card):
    r = np.random.RandomState(6)
    logits = r.randn(16, 1000).astype('float32') * 3
    prob, _ = _card_matches_cpu(card, 'softmax', {'X': [logits]}, {})
    label = r.randint(0, 1000, (16, 1)).astype('int64')
    _card_matches_cpu(card, 'cross_entropy',
                      {'X': [prob['Out'].cpu().numpy()], 'Label': [label]},
                      {'soft_label': False})
    for nesterov in (False, True):
        _card_matches_cpu(card, 'momentum', {
            'Param': [r.randn(64, 9).astype('float32')],
            'Grad': [r.randn(64, 9).astype('float32')],
            'Velocity': [r.randn(64, 9).astype('float32')],
            'LearningRate': [np.array([0.01], 'float32')]},
            {'mu': 0.9, 'use_nesterov': nesterov})


@pytest.mark.parametrize('k', [1, 5])
def test_top_k_and_accuracy_keep_the_lower_index_on_ties(card, k):
    r = np.random.RandomState(7)
    x = np.round(r.randn(64, 1000), 0).astype('float32')
    x[0] = 1.0
    x[1, [10, 500, 999]] = 9.0
    x[2, :20] = [-0.0, 0.0] * 10
    got, want = _card_matches_cpu(card, 'top_k', {'X': [x]}, {'k': k})
    np.testing.assert_array_equal(got['Indices'].cpu().numpy(),
                                  want['Indices'].numpy())
    label = r.randint(0, 1000, (64, 1)).astype('int64')
    label[1, 0] = 500
    got, want = _card_matches_cpu(
        card, 'accuracy', {'Out': [want['Out'].numpy()],
                           'Indices': [want['Indices'].numpy()],
                           'Label': [label]}, {})
    assert int(got['Correct']) == int(want['Correct'])


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
def test_resnet_block_step_on_the_card_matches_the_cpu(card, fmt):
    """One Momentum step of a bottleneck stage (stride 2, projection
    shortcut) from the same weights on the card and on the CPU: the loss,
    every gradient and the running stats, and no kernel of the port
    launched."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        shape = [16, 28, 28] if fmt == 'NCHW' else [28, 28, 16]
        x = fluid.layers.data(name='x', shape=shape)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        y = resnet.bottleneck(x, 8, 2, data_format=fmt)
        pool = fluid.layers.pool2d(y, pool_type='avg', global_pooling=True,
                                   data_format=fmt)
        prob = fluid.layers.fc(pool, size=10, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    gnames = [op for op in main.global_block().ops
              if op.type == 'autodiff'][0].attrs['grad_names']
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    state = init.to_numpy()
    stats = [n for n in state if 'batch_norm' in n
             and ('.w_1' in n or '.w_2' in n)]
    r = np.random.RandomState(2)
    feed = {'x': r.randn(*([4] + shape)).astype('float32'),
            'label': r.randint(0, 10, (4, 1)).astype('int64')}
    outs, after = {}, {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        scope.load_numpy(state, place)
        before = {n: k.launches for n, k in ops.KERNELS.items()}
        outs[type(place).__name__] = fluid.Executor(place).run(
            main, feed=feed, fetch_list=[loss] + gnames, scope=scope)
        assert {n: k.launches for n, k in ops.KERNELS.items()} == before
        after[type(place).__name__] = scope.to_numpy(stats)
    assert len(gnames) == 14 and len(stats) == 8
    for name, got, ref in zip(['loss'] + gnames, outs['CUDAPlace'],
                              outs['CPUPlace']):
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    for n in stats:
        assert not np.array_equal(after['CPUPlace'][n], state[n]), n
        np.testing.assert_allclose(after['CUDAPlace'][n],
                                   after['CPUPlace'][n], rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(
                                       after['CPUPlace'][n]).max())),
                                   err_msg=n)


# -- the captured step (fluid/step_artifact.py) -------------------------------
# A replay must equal the eager walk bitwise where two eager walks are
# bitwise equal: the port's kernels, cuBLAS and the sparse updates are
# deterministic at these shapes, so every comparison here is bitwise.


def _small_transformer(fluid, dropout=0.0):
    from paddle_tpu_torch.models import transformer as T
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _, _ = T.transformer(100, 100, 40, n_layer=2, d_model=64,
                                       n_head=4, d_inner=128,
                                       dropout_rate=dropout)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    r = np.random.RandomState(1)
    feeds = []
    for _ in range(4):
        f = {n: r.randint(1, 100, (3, 40)).astype('int64')
             for n in ('src_word', 'trg_word', 'lbl_word')}
        f['trg_word'][1, 17:] = 0
        f['lbl_word'][1, 17:] = 0
        feeds.append(f)
    return main, startup, avg_cost, feeds


def _small_deepfm(fluid):
    from paddle_tpu_torch.models import deepfm
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feat = fluid.layers.data(name='feat_ids', shape=[6], dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        cost, _, _ = deepfm.deepfm(feat, label, num_fields=6, vocab_size=64,
                                   embed_dim=4, hidden=[16], is_sparse=True)
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    r = np.random.RandomState(2)
    feeds = [{'feat_ids': r.randint(0, 64, (16, 6)).astype('int64'),
              'label': r.randint(0, 2, (16, 1)).astype('int64')}
             for _ in range(4)]
    return main, startup, cost, feeds


def _captured_and_eager(fluid, main, startup, cost, feeds):
    """The same steps from the same weights through a captured executor
    and through the eager walk (check_nan_inf); returns (captured losses,
    state), (eager losses, state), the captured executor."""
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    runs = []
    for eager in (False, True):
        scope = fluid.Scope()
        scope.load_numpy(init.to_numpy(), fluid.CUDAPlace(0))
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with (fluid.debugger.check_nan_inf() if eager
              else contextlib.nullcontext()):
            losses = [exe.run(main, feed=f, fetch_list=[cost],
                              scope=scope)[0] for f in feeds]
        runs.append((losses, scope.to_numpy(), exe))
    return runs


@pytest.mark.parametrize('model', ['transformer', 'deepfm'])
def test_captured_training_matches_the_eager_walk(card, model):
    """Four training steps (warm-up, capture and replay, two replays)
    against four eager steps: losses and every persistable bitwise; one
    capture, three replays; the attention and sparse kernels' launches
    per step as the eager walk counts them."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import ops
    main, startup, cost, feeds = (_small_transformer if model ==
                                  'transformer' else _small_deepfm)(fluid)
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    (cl, cs, cexe), (el, es, _) = _captured_and_eager(fluid, main, startup,
                                                      cost, feeds)
    after = {n: k.launches for n, k in ops.KERNELS.items()}
    for a, b in zip(cl, el):
        np.testing.assert_array_equal(a, b)
    assert sorted(cs) == sorted(es)
    for n in cs:
        np.testing.assert_array_equal(cs[n], es[n], err_msg=n)
    stats = cexe.cache_stats
    assert stats['captures'] == 1 and stats['replays'] == 3, stats
    per_step = {'transformer': {'flash_attention_fwd': 6,
                                'flash_attention_bwd_dq': 6,
                                'flash_attention_bwd_dkv': 6},
                'deepfm': {'sparse_adam': 2}}[model]
    got = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    # both executors' steps: 4 captured or replayed, 4 eager
    assert got == {n: 8 * v for n, v in per_step.items()}


def test_captured_dropout_draws_the_eager_masks(card):
    """Captured run j draws the masks of eager run j, and run_bundle's
    inner step j those of run j."""
    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[64], dtype='float32')
        out = fluid.layers.dropout(x, dropout_prob=0.5)
    feed = {'x': np.ones((8, 64), 'float32')}
    masks = {}
    for mode in ('captured', 'eager', 'bundle'):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        if mode == 'bundle':
            masks[mode] = list(exe.run_bundle(main, feeds=[feed] * 4,
                                              fetch_list=[out],
                                              scope=scope)[0])
            continue
        with (fluid.debugger.check_nan_inf() if mode == 'eager'
              else contextlib.nullcontext()):
            masks[mode] = [exe.run(main, feed=feed, fetch_list=[out],
                                   scope=scope)[0] for _ in range(4)]
        if mode == 'captured':
            assert exe.cache_stats['replays'] == 3
    for j in range(4):
        np.testing.assert_array_equal(masks['captured'][j],
                                      masks['eager'][j])
        np.testing.assert_array_equal(masks['bundle'][j],
                                      masks['eager'][j])
    assert not np.array_equal(masks['eager'][2], masks['eager'][3])
    assert (masks['eager'][3] == 0).any()


def test_held_device_fetch_survives_the_next_replay(card):
    import paddle_tpu_torch.fluid as fluid
    main, startup, cost, feeds = _small_deepfm(fluid)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    held = [exe.run(main, feed=f, fetch_list=[cost], scope=scope,
                    return_numpy=False)[0] for f in feeds]
    assert exe.cache_stats['replays'] == 3
    copies = [h.clone() for h in held]
    exe.run(main, feed=feeds[0], fetch_list=[cost], scope=scope)
    torch.cuda.synchronize()
    for h, c in zip(held, copies):
        assert torch.equal(h, c)
    assert not torch.equal(held[2], held[3])


def test_load_numpy_is_seen_by_the_next_replay(card):
    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        out = fluid.layers.fc(input=x, size=3,
                              param_attr=fluid.ParamAttr(name='w'),
                              bias_attr=fluid.ParamAttr(name='b'))
    r = np.random.RandomState(3)
    feed = {'x': r.randn(4, 8).astype('float32')}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    for _ in range(3):
        scope.load_numpy({'w': r.randn(8, 3).astype('float32'),
                          'b': r.randn(3).astype('float32')},
                         fluid.CUDAPlace(0))
        got = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
        want = feed['x'] @ scope.vars['w'].cpu().numpy() \
            + scope.vars['b'].cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert exe.cache_stats['captures'] == 1
    assert exe.cache_stats['replays'] == 2
    # weights of another shape: the step is captured again
    scope.load_numpy({'w': r.randn(8, 5).astype('float32'),
                      'b': r.randn(5).astype('float32')}, fluid.CUDAPlace(0))
    got = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
    np.testing.assert_allclose(
        got, feed['x'] @ scope.vars['w'].cpu().numpy()
        + scope.vars['b'].cpu().numpy(), rtol=1e-5, atol=1e-5)
    assert exe.cache_stats['captures'] == 2


def _register_test_rules():
    from paddle_tpu_torch.fluid import lowering
    if lowering.has_rule('test_waits_for_the_card'):
        return

    @lowering.register('test_waits_for_the_card')
    def _waits(ins, attrs, ctx):
        x = ins['X'][0]
        if x.device.type == 'meta':
            return {'Out': x}
        return {'Out': x * float(x.sum())}

    @lowering.register('test_refuses_capture')
    def _refuses(ins, attrs, ctx):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError('refused under capture')
        return {'Out': ins['X'][0] * 2.0}


@pytest.mark.parametrize('op_type,when', [
    ('test_waits_for_the_card', 'warm-up'), ('test_refuses_capture',
                                             'capture')])
def test_a_step_that_cannot_be_captured_names_its_op(card, op_type, when):
    """No eager fallback: a host sync is found in the warm-up (sync debug
    mode), a failure under capture at the capture; both name the op.
    The executor captures other steps afterwards."""
    import paddle_tpu_torch.fluid as fluid
    _register_test_rules()
    main = fluid.Program()
    blk = main.global_block()
    x = blk.create_var(name='x', shape=[-1, 4], dtype='float32')
    y = blk.create_var(name='y', shape=[-1, 4], dtype='float32')
    z = blk.create_var(name='z', shape=[-1, 4], dtype='float32')
    blk.append_op(type='scale', inputs={'X': [x]}, outputs={'Out': [y]},
                  attrs={'scale': 2.0})
    blk.append_op(type=op_type, inputs={'X': [y]}, outputs={'Out': [z]},
                  infer_shape=False)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = {'x': np.ones((2, 4), 'float32')}
    scope = fluid.Scope()
    if when == 'capture':
        exe.run(main, feed=feed, fetch_list=[z], scope=scope)
    with pytest.raises(RuntimeError, match="op #1 %r" % op_type):
        exe.run(main, feed=feed, fetch_list=[z], scope=scope)
    fmain, _, fcost, ffeeds = _small_deepfm(fluid)
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(_small_deepfm(fluid)[1],
                                            scope=scope)
    for f in ffeeds:
        exe.run(fmain, feed=f, fetch_list=[fcost], scope=scope)
    assert exe.cache_stats['captures'] == 1


def test_captured_paged_decode_step_matches_the_eager_walk(card):
    """The paged DecodeEngine's step with live slots: a replay of its
    captured graph against debug_step's eager walk from the same state,
    fetches and state bitwise; one paged_attention launch a replay.

    The three slots decode T = 300 steps (no end id is reachable), far
    more than run between two polls, and the condition is read under the
    engine's handle lock, so the decode loop cannot move on between the
    check and the compared step."""
    from paddle_tpu_torch import serving
    r = np.random.RandomState(7)
    V, E, D, H, K, SRC, T = 20, 8, 6, 8, 3, 5, 300
    w = {'w_dec': r.randn(E + D, 4 * H) * 0.3,
         'u_dec': r.randn(H, 4 * H) * 0.3,
         'b_dec': r.randn(1, 4 * H) * 0.1, 'w_q': r.randn(H, D) * 0.3,
         'w_emb': r.randn(V, E) * 0.3, 'w_out': r.randn(H, V) * 0.3,
         'b_out': r.randn(1, V) * 0.1}
    eng = serving.DecodeEngine(w, serving.DecodeConfig(
        slots=3, beam_size=K, max_len=T, src_cap=SRC, page_size=3,
        pages=3 * (T // 3) + 10, end_id=V + 1))
    try:
        eng.warmup()
        futs = [eng.submit({'enc': (r.randn(4, D) * 0.5).astype('float32')},
                           max_new_tokens=T) for _ in range(3)]
        deadline = time.monotonic() + 60
        while True:
            with eng._handle_lock:
                if (eng.stats['slots_occupied'] == 3
                        and eng._handle.steps >= 6):
                    break
            assert time.monotonic() < deadline, eng.stats
            time.sleep(0.001)
        with eng._handle_lock:
            assert eng.stats['slots_occupied'] == 3, eng.stats
            h = eng._handle
            art = h._compiled
            snap = {n: t.clone() for n, t in h.state.items()}
            before = tpa.KERNEL.launches
            fetched = h.step()
            assert tpa.KERNEL.launches == before + 1
            replayed = {n: t.clone() for n, t in h.state.items()}
            g = torch.Generator(device='cuda')
            e_fetch, e_new, _ = art.debug_step(
                {n: t.clone() for n, t in snap.items()}, {}, 0,
                generator=g)
            for a, b in zip(fetched, e_fetch):
                assert torch.equal(a, b)
            for n, t in e_new.items():
                assert torch.equal(replayed[n], t), n
            # back to the state before the compared step
            with torch.no_grad():
                for n, t in h.state.items():
                    t.copy_(snap[n])
        for f in futs:
            f.result(120)
    finally:
        eng.shutdown()


# -- out-of-range labels and ids, AMP on the card -----------------------------

@pytest.mark.parametrize('op_type', ['cross_entropy',
                                     'softmax_with_cross_entropy'])
def test_out_of_range_labels_give_nan_on_the_card(card, op_type):
    """No device-side assert: labels past the classes give NaN, negative
    ones count from the end, card and CPU alike; the context stays usable
    (a later launch runs)."""
    x_slot = 'X' if op_type == 'cross_entropy' else 'Logits'
    probs = np.array([[0.2, 0.3, 0.5]] * 5, 'float32')
    label = np.array([[0], [3], [-1], [-4], [7]], 'int64')
    got = _rule_on(card, op_type, {x_slot: [probs], 'Label': [label]}, {})
    want = _rule_on(torch.device('cpu'), op_type,
                    {x_slot: [probs], 'Label': [label]}, {})
    slot = 'Y' if op_type == 'cross_entropy' else 'Loss'
    g, w = got[slot].cpu().numpy(), want[slot].numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isnan(g[[1, 3, 4]]).all() and np.isfinite(g[[0, 2]]).all()
    np.testing.assert_allclose(g, w, rtol=1e-6)
    assert float(torch.ones(3, device=card).sum()) == 3.0


def test_out_of_range_ids_read_nan_rows_on_the_card(card):
    w = np.arange(12, dtype='float32').reshape(4, 3)
    ids = np.array([[5], [-1], [2], [-5]], 'int64')
    got = _rule_on(card, 'lookup_table', {'W': [w], 'Ids': [ids]},
                   {'padding_idx': -1})['Out'].cpu().numpy()
    assert np.isnan(got[[0, 3]]).all()
    np.testing.assert_array_equal(got[[1, 2]], w[[3, 2]])


def test_an_out_of_range_label_in_a_captured_step_is_skipped(card):
    """A guarded training step replayed from its graph, fed a label past
    the classes: a NaN loss and a skipped step, not a device assert; the
    next healthy replay trains."""
    import warnings
    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[4])
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        prob = fluid.layers.fc(input=x, size=3, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    fluid.anomaly_guard(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    good = {'x': np.ones((2, 4), 'float32'), 'label': np.array([[1], [2]])}
    bad = dict(good, label=np.array([[1], [3]]))
    for _ in range(2):
        exe.run(main, feed=good, fetch_list=[loss], scope=scope)
    before = {n: t.clone() for n, t in scope.vars.items()}
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        out = exe.run(main, feed=bad, fetch_list=[loss], scope=scope)[0]
    assert np.isnan(out).all() and exe.skipped_steps == 1
    assert all(torch.equal(t, before[n]) for n, t in scope.vars.items())
    out = exe.run(main, feed=good, fetch_list=[loss], scope=scope)[0]
    assert np.isfinite(out).all() and exe.cache_stats['replays'] >= 2


def _amp_rule_on(device, op_type, ins, attrs):
    from paddle_tpu_torch.fluid import lowering
    ctx = lowering.Ctx(device, torch.Generator(device=device), amp=True)
    return lowering.get_rule(op_type)(
        {s: [t.to(device) for t in vs] for s, vs in ins.items()}, attrs, ctx)


@pytest.mark.parametrize('op_type,attrs,shapes', [
    ('mul', {'x_num_col_dims': 2}, ((8, 12, 96), (96, 40))),
    ('matmul', {'transpose_Y': True, 'alpha': 0.5},
     ((4, 3, 20, 32), (3, 24, 32))),
])
def test_amp_products_on_the_card_match_the_cpu(card, op_type, attrs,
                                                 shapes):
    """Under AMP the card's product (cuBLAS bf16, fp32 result, fp32
    accumulation) against the CPU's exact form (the bf16 operands widened,
    an fp32 product): 1e-5 of max |out|, sums in other orders. The
    gradients: the card takes the fp32 cotangent as bf16 hi + lo
    (_Bf16Product), 2^-17 relative, then both round to bf16: at most 1% of
    the elements on the other bf16 neighbour, each within one bf16 ulp of
    max |g|."""
    r = np.random.RandomState(8)
    arrays = [torch.tensor(r.randn(*s).astype('float32')) for s in shapes]
    outs, grads = {}, {}
    for dev in (torch.device('cpu'), card):
        leaves = [a.to(dev).requires_grad_() for a in arrays]
        out = _amp_rule_on(dev, op_type, {'X': [leaves[0]],
                                          'Y': [leaves[1]]}, attrs)['Out']
        assert out.dtype == torch.float32
        wo = torch.tensor(r.randn(*out.shape).astype('float32')
                          if dev.type == 'cpu' else grads['w']).to(dev)
        grads['w'] = wo.cpu().numpy()
        outs[dev.type] = out.detach().cpu()
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(
            (out * wo).sum(), leaves)]
    ref = outs['cpu']
    torch.testing.assert_close(outs['cuda'], ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    for g, w in zip(grads['cuda'], grads['cpu']):
        assert float((g != w).float().mean()) <= 0.01
        torch.testing.assert_close(g, w, rtol=0, atol=bf16_tol(w) / 2)


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
def test_amp_conv2d_on_the_card_matches_the_cpu(card, fmt):
    """A bf16 convolution (cuDNN on channels_last memory for NHWC) against
    the CPU's bf16 convolution: two bf16 ulps of max |out|."""
    r = np.random.RandomState(9)
    x = torch.tensor(_nhwc(r.randn(4, 16, 20, 20).astype('float32'), fmt))
    w = torch.tensor(r.randn(32, 16, 3, 3).astype('float32'))
    attrs = dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1],
                 groups=1, data_format=fmt)
    got = _amp_rule_on(card, 'conv2d', {'Input': [x], 'Filter': [w]},
                       attrs)['Output']
    want = _amp_rule_on(torch.device('cpu'), 'conv2d',
                        {'Input': [x], 'Filter': [w]}, attrs)['Output']
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=bf16_tol(want))


@pytest.mark.parametrize('k', [1, 4])
def test_bf16_top_k_keeps_the_total_order_on_the_card(card, k):
    x = torch.tensor([[0.0, -0.0, 1.0, 1.0, float('nan'), -float('inf'),
                       0.5, -0.0],
                      [-0.0, 0.0, -1.0, float('inf'), -1.0, 2.0, 2.0, 0.0]]
                     ).to(torch.bfloat16)
    from paddle_tpu_torch.fluid.ops_impl.lod_beam import top_k_lower_index
    got = top_k_lower_index(x.to(card), k)[1].cpu()
    want = top_k_lower_index(x, k)[1]
    assert torch.equal(got, want)


def test_amp_training_step_on_the_card_matches_the_cpu(card):
    """A small Transformer's AMP training step from the same weights on the
    card and on the CPU: the bf16 attention kernels (3 a layer pair, no
    fp32 attention kernel), the loss within 1e-3 and every gradient within
    3e-2 of its L2 norm (bf16 activations rounded in other places: cuBLAS
    and the kernels sum in other orders, and the card's products round
    their cotangents to bf16)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer as T
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _, _ = T.transformer(100, 100, 40, n_layer=2, d_model=64,
                                       n_head=4, d_inner=128,
                                       dropout_rate=0.0)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    fluid.amp.decorate_program(main)
    gnames = [op for op in main.global_block().ops
              if op.type == 'autodiff'][0].attrs['grad_names']
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    init = cpu_scope.to_numpy()
    r = np.random.RandomState(1)
    feed = {n: r.randint(1, 100, (3, 40)).astype('int64')
            for n in ('src_word', 'trg_word', 'lbl_word')}
    outs = {}
    counts = [(k.name, k.launches) for k in (
        tfa.KERNEL, tfa.KERNEL_BWD_DQ, tfa.KERNEL_BWD_DKV, tfa.KERNEL_BF16,
        tfa.KERNEL_BWD_DQ_BF16, tfa.KERNEL_BWD_DKV_BF16)]
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        s = fluid.Scope()
        s.load_numpy(init, place)
        outs[str(place)] = fluid.Executor(place).run(
            main, feed=feed, fetch_list=[avg_cost] + list(gnames), scope=s)
    launched = {n: k.launches - c for (n, c), k in zip(counts, (
        tfa.KERNEL, tfa.KERNEL_BWD_DQ, tfa.KERNEL_BWD_DKV, tfa.KERNEL_BF16,
        tfa.KERNEL_BWD_DQ_BF16, tfa.KERNEL_BWD_DKV_BF16))}
    assert launched == {'flash_attention_fwd': 0,
                        'flash_attention_bwd_dq': 0,
                        'flash_attention_bwd_dkv': 0,
                        'flash_attention_fwd_bf16': 6,
                        'flash_attention_bwd_dq_bf16': 6,
                        'flash_attention_bwd_dkv_bf16': 6}
    gpu, cpu = outs['CUDAPlace(0)'], outs['CPUPlace(0)']
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-3)
    for name, g, w in zip(gnames, gpu[1:], cpu[1:]):
        assert g.dtype == np.float32, name
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 3e-2, (name, err)


# -- the dense training surface's rules on the card ------------------------------

def _surface_cases():
    """(op, inputs as numpy, attrs, output slot, float inputs to
    differentiate) for the rules whose card path differs from a plain
    elementwise call: ties, gathers and scatters with out-of-range
    indices, sorts, and the random draws."""
    r = np.random.RandomState(3)
    x = r.uniform(-5, 5, (4, 12)).astype('float32')
    x[0] = [0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0, 2.5, -2.5, 6.0, 0.0, 3.0]
    ints = r.randint(-2, 3, (5, 6)).astype('float32')
    ints[2, 3] = np.nan
    return [
        ('relu', {'X': [x]}, {}, 'Out', 'X'),
        ('clip', {'X': [x]}, {'min': -1.0, 'max': 2.0}, 'Out', 'X'),
        ('abs', {'X': [x]}, {}, 'Out', 'X'),
        ('relu6', {'X': [x]}, {'threshold': 1.0}, 'Out', 'X'),
        ('elu', {'X': [x * 30]}, {}, 'Out', 'X'),
        ('softshrink', {'X': [x]}, {}, 'Out', 'X'),
        ('hard_sigmoid', {'X': [x]}, {}, 'Out', 'X'),
        ('sigmoid_cross_entropy_with_logits',
         {'X': [x], 'Label': [(x > 0).astype('float32')]}, {}, 'Out', 'X'),
        ('reduce_max', {'X': [np.round(x)]}, {'dim': [1]}, 'Out', 'X'),
        # a few factors: a product in another order moves the last bits
        ('reduce_prod', {'X': [x[:2, :3]]}, {'dim': [0, 1]}, 'Out', 'X'),
        ('reduce_prod', {'X': [x[:, :3]]}, {'dim': [1]}, 'Out', 'X'),
        ('clip_by_norm', {'X': [x]}, {'max_norm': 1.0}, 'Out', 'X'),
        ('less_than', {'X': [x], 'Y': [x[:1]]}, {}, 'Out', None),
        ('gather', {'X': [x], 'Index': [np.array([5, -1, -5, 1, 1])]}, {},
         'Out', 'X'),
        ('scatter', {'X': [np.zeros((3, 2), 'float32')],
                     'Ids': [np.array([1, 1, 5, -1])],
                     'Updates': [x[:4, :2].copy()]}, {}, 'Out', 'Updates'),
        ('multiplex', {'X': [x, x * 2, x * 3],
                       'Ids': [np.array([[-1], [5], [0], [1]])]}, {},
         'Out', 'X'),
        ('arg_max', {'X': [ints]}, {'axis': 1}, 'Out', None),
        ('argsort', {'X': [ints]}, {'axis': -1}, 'Indices', None),
        ('crop', {'X': [x]}, {'offsets': [3, 11], 'shape': [2, 3]}, 'Out',
         'X'),
        ('pad', {'X': [x]}, {'paddings': [1, 0, 2, 3]}, 'Out', 'X'),
        ('shape', {'Input': [x]}, {}, 'Out', None),
        ('split', {'X': [x]}, {'axis': 1, 'sections': [5, 7]}, 'Out', 'X'),
    ]


@pytest.mark.parametrize('case', range(len(_surface_cases())))
def test_surface_rule_on_the_card_matches_the_cpu_without_a_sync(card, case):
    """Each rule on the card (forward and, where it is differentiable, the
    VJP of a seeded cotangent) under set_sync_debug_mode('error'), which
    raises on a host sync (torch.prod's own backward syncs, so
    reduce_prod's does not use it), against the same rule on the CPU:
    within 1e-6 (1e-6 of max |g| for the gradients a gather or a scatter
    accumulates with atomics)."""
    from paddle_tpu_torch.fluid import lowering
    op, ins, attrs, slot, wrt = _surface_cases()[case]
    outs = {}
    for dev in (card, torch.device('cpu')):
        tins = {k: [torch.from_numpy(np.array(a)).to(dev) for a in v]
                for k, v in ins.items()}
        if wrt:
            tins[wrt] = [t.requires_grad_(True) for t in tins[wrt]]
        ctx = lowering.Ctx(dev, torch.Generator(device=dev))
        # the cotangent copied in before the check: a copy from pageable
        # host memory waits for the card
        shape = lowering.get_rule(op)(
            {k: [t.detach() for t in v] for k, v in tins.items()}, attrs,
            ctx)[slot]
        shape = (shape[0] if isinstance(shape, list) else shape).shape
        cot = torch.from_numpy(np.asarray(np.random.RandomState(5).randn(
            *shape), dtype='float32')).to(dev)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        if dev.type == 'cuda':
            torch.cuda.set_sync_debug_mode('error')
        try:
            out = lowering.get_rule(op)(tins, attrs, ctx)[slot]
            out = out[0] if isinstance(out, list) else out
            grads = torch.autograd.grad(out, tins[wrt], cot) if wrt else []
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        outs[dev.type] = [t.detach().cpu().numpy() for t in [out, *grads]]
    for got, want in zip(outs['cuda'], outs['cpu']):
        scale = max(float(np.nanmax(np.abs(want))) if want.size else 0.0,
                    1.0) if op in ('gather', 'scatter', 'multiplex') else 1.0
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=op)


def test_random_surface_rules_draw_on_the_card_inside_a_capture(card):
    """random_crop, truncated_gaussian_random and the *_batch_size_like
    draws captured in one CUDA graph: each replay draws anew from the
    graph's generator, within their bounds."""
    from paddle_tpu_torch.fluid import lowering
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    ctx = lowering.Ctx(card, gen)
    x = torch.arange(2 * 5 * 6, dtype=torch.float32,
                     device=card).reshape(2, 5, 6)
    ref = torch.zeros(64, 3, device=card)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        crop = lowering.get_rule('random_crop')(
            {'X': [x]}, {'shape': [3, 2]}, ctx)['Out']
        tn = lowering.get_rule('truncated_gaussian_random')(
            {}, {'shape': [64, 128], 'mean': 0.0, 'std': 1.0}, ctx)['Out']
        un = lowering.get_rule('uniform_random_batch_size_like')(
            {'Input': [ref]}, {'shape': [-1, 128], 'min': 2.0, 'max': 3.0},
            ctx)['Out']
    draws = []
    for _ in range(8):
        graph.replay()
        torch.cuda.synchronize()
        draws.append((crop.cpu().numpy().copy(), tn.cpu().numpy().copy(),
                      un.cpu().numpy().copy()))
        c = draws[-1][0]
        r0, c0 = divmod(int(c[0, 0, 0]), 6)
        np.testing.assert_array_equal(
            c, x.cpu().numpy()[:, r0:r0 + 3, c0:c0 + 2])
        assert np.abs(draws[-1][1]).max() <= 2.0
        assert draws[-1][2].min() >= 2.0 and draws[-1][2].max() <= 3.0
    assert not np.array_equal(draws[0][1], draws[1][1])
    assert len({int(d[0][0, 0, 0]) for d in draws}) > 1


def test_captured_shape_reads_its_value_after_other_pinned_copies(card):
    """layers.shape inside a captured step: each replay, after pinned host
    blocks of the shape value's size were taken and filled with other
    bytes, still reads the input's shape."""
    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[6, 5], dtype='float32')
        shape = fluid.layers.shape(x)
        scaled = fluid.layers.scale(fluid.layers.cast(shape, 'float32'),
                                    scale=2.0)
    feed = {'x': np.ones((4, 6, 5), 'float32')}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    held = []
    for _ in range(4):
        got, twice = exe.run(main, feed=feed, fetch_list=[shape, scaled],
                             scope=scope)
        np.testing.assert_array_equal(got, [4, 6, 5])
        np.testing.assert_array_equal(twice, [8.0, 12.0, 10.0])
        held += [torch.full((3,), -7, dtype=torch.int32).pin_memory()
                 for _ in range(64)]
    assert exe.cache_stats['captures'] == 1
    assert exe.cache_stats['replays'] == 3


# -- sequences (SeqValue) ------------------------------------------------------

def _seq_cases():
    """(op, inputs, attrs, output slot, float inputs to differentiate) for
    the sequence rules; a sequence input is ('seq', data, lengths[,
    outer]), ragged with a zero-length and a full row."""
    r = np.random.RandomState(4)
    lens = np.array([3, 0, 6, 1])

    def seq(*trail, t=6, lengths=lens):
        x = r.randn(len(lengths), t, *trail).astype('float32')
        for i, n in enumerate(lengths):
            x[i, n:] = 0
        return ('seq', x, lengths)

    D = 4
    lstm = {'Input': [seq(4 * D)],
            'Weight': [r.randn(D, 4 * D).astype('float32') * 0.5],
            'Bias': [r.randn(1, 7 * D).astype('float32') * 0.5]}
    nested = seq(3)[:2] + (lens, np.array([2, 0, 2]))
    ids = r.randint(0, 5, (4, 6, 1)).astype('int64')
    return [
        ('sequence_pool', {'X': [seq(3)]}, {'pooltype': p}, 'Out', 'X')
        for p in ('SUM', 'AVERAGE', 'SQRT', 'MAX', 'FIRST', 'LAST')] + [
        ('sequence_pool', {'X': [nested]}, {'pooltype': 'MAX'}, 'Out', 'X'),
        ('sequence_softmax', {'X': [seq(1)]}, {}, 'Out', 'X'),
        ('sequence_expand', {'X': [r.randn(4, 3).astype('float32')],
                             'Y': [seq(2)]}, {}, 'Out', 'X'),
        ('sequence_reshape', {'X': [seq(4)]}, {'new_dim': 8}, 'Out', 'X'),
        ('sequence_mask', {'X': [lens]}, {'maxlen': 6}, 'Y', None),
        ('lod_reset', {'X': [seq(2)]}, {'target_lod': [0, 2, 2, 7, 10]},
         'Out', 'X'),
        ('sequence_conv', {'X': [seq(3)],
                           'Filter': [r.randn(9, 5).astype('float32')]},
         {'contextLength': 3, 'contextStart': -1}, 'Out', 'X'),
        ('row_conv', {'X': [seq(3)],
                      'Filter': [r.randn(2, 3).astype('float32')]}, {},
         'Out', 'X'),
        ('lstm', lstm, {'use_peepholes': True, 'is_reverse': False},
         'Hidden', 'Input'),
        ('lstm', lstm, {'use_peepholes': True, 'is_reverse': True,
                        'candidate_activation': 'relu'}, 'Cell', 'Input'),
        ('gru', {'Input': [seq(3 * D)],
                 'Weight': [r.randn(D, 3 * D).astype('float32') * 0.5],
                 'Bias': [r.randn(1, 3 * D).astype('float32')]},
         {'is_reverse': True}, 'Hidden', 'Input'),
        ('attention_lstm_decoder',
         {'TrgEmb': [seq(3)], 'EncOut': [seq(4, t=5,
                                              lengths=np.array([2, 0, 5, 3]))],
          'WDec': [r.randn(7, 8).astype('float32') * 0.5],
          'UDec': [r.randn(2, 8).astype('float32') * 0.5],
          'BDec': [r.randn(1, 8).astype('float32') * 0.5],
          'WAttnQ': [r.randn(2, 4).astype('float32') * 0.5]}, {}, 'Hidden',
         'EncOut'),
        ('sequence_concat', {'X': [seq(2), seq(2, t=3,
                                                 lengths=np.array([1, 3, 0,
                                                                   2]))]},
         {}, 'Out', 'X'),
        ('sequence_erase', {'X': [('seq', ids, lens)]}, {'tokens': [2, 4]},
         'Out', None),
    ]


def _seq_in(v, dev):
    from paddle_tpu_torch.fluid import lowering
    if isinstance(v, tuple) and v[0] == 'seq':
        return lowering.SeqValue(
            torch.from_numpy(v[1].copy()).to(dev),
            torch.from_numpy(np.asarray(v[2], 'int64')).to(dev),
            tuple(torch.from_numpy(np.asarray(o, 'int64')).to(dev)
                  for o in v[3:]) or None)
    return torch.from_numpy(np.array(v)).to(dev)


@pytest.mark.parametrize('case', range(len(_seq_cases())))
def test_sequence_rule_on_the_card_matches_the_cpu_without_a_sync(card,
                                                                   case):
    """Each sequence rule on the card (forward, and the VJP of a seeded
    cotangent with respect to the data of its first input) under
    set_sync_debug_mode('error'), against the same rule on the CPU within
    1e-5 (the products of the recurrences in other orders)."""
    from paddle_tpu_torch.fluid import lowering
    op, ins, attrs, slot, wrt = _seq_cases()[case]
    outs = {}
    for dev in (card, torch.device('cpu')):
        tins = {k: [_seq_in(a, dev) for a in v] for k, v in ins.items()}
        leaf = None
        if wrt:
            leaf = lowering.data_of(tins[wrt][0]).requires_grad_(True)
        ctx = lowering.Ctx(dev, torch.Generator(device=dev))
        shape = lowering.data_of(lowering.get_rule(op)(
            tins, attrs, ctx)[slot]).shape
        cot = torch.from_numpy(np.asarray(np.random.RandomState(5).randn(
            *shape), dtype='float32')).to(dev)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        if dev.type == 'cuda':
            torch.cuda.set_sync_debug_mode('error')
        try:
            out = lowering.get_rule(op)(tins, attrs, ctx)[slot]
            res = [lowering.data_of(out)]
            if isinstance(out, lowering.SeqValue):
                res.append(out.lengths)
            if leaf is not None:
                res += list(torch.autograd.grad(res[0], [leaf], cot))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        outs[dev.type] = [t.detach().cpu().numpy() for t in res]
    for got, want in zip(outs['cuda'], outs['cpu']):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=op)


def _small_lstm(fluid, longest):
    """stacked_dynamic_lstm's net at lstm 16, emb 8 (Adam), and batches of
    4 sequences whose longest has `longest` ids."""
    from paddle_tpu_torch.models import stacked_dynamic_lstm
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data(name='words', shape=[1], dtype='int64',
                                  lod_level=1)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        prob = stacked_dynamic_lstm.lstm_net(words, 100, 16, 8)
        cost = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam().minimize(cost)
    feeder = fluid.DataFeeder(['words', 'label'], fluid.CPUPlace(),
                              program=main)
    r = np.random.RandomState(6)

    def batch(n):
        return feeder.feed([(r.randint(0, 100, m).tolist(), [m % 2])
                            for m in (n, 1, n - 2, 3)])
    return main, startup, cost, batch


def test_captured_lstm_step_matches_the_eager_walk_in_two_buckets(card):
    """Four steps in the 8 bucket (warm-up under sync debug, capture,
    replays) against the eager walk from the same weights: losses and every
    persistable bitwise, one capture and three replays; then three steps
    in the 16 bucket: a second capture and two replays. No kernel of the
    port launches."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import ops
    main, startup, cost, batch = _small_lstm(fluid, 8)
    feeds = [batch(n) for n in (7, 8, 5, 6)]
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    (cl, cs, cexe), (el, es, _) = _captured_and_eager(fluid, main, startup,
                                                      cost, feeds)
    for a, b in zip(cl, el):
        np.testing.assert_array_equal(a, b)
    for n in cs:
        np.testing.assert_array_equal(cs[n], es[n], err_msg=n)
    assert cexe.cache_stats['captures'] == 1
    assert cexe.cache_stats['replays'] == 3
    scope = fluid.Scope()
    scope.load_numpy(cs, fluid.CUDAPlace(0))
    for n in (12, 16, 11):
        cexe.run(main, feed=batch(n), fetch_list=[cost], scope=scope)
    stats = cexe.cache_stats
    assert stats['captures'] == 2 and stats['replays'] == 5, stats
    assert {n: k.launches for n, k in ops.KERNELS.items()} == before


# -- MT generation and speculative decode ---------------------------------------

def _spec_inputs(draft, C=4, V=20, E=8, D=6, H=8, ps=3, src=5, T=8,
                 spec_k=3):
    """One mid-flight beam-1 slot pool of the speculative step: a slot near
    its limit, an inactive one, a finished one, a fresh one; page 0 the
    zero page; a weights draft of width 4 or a next-token table."""
    r = np.random.RandomState(31)
    npe, nph = -(-src // ps), -(-T // ps)

    def w(e, h):
        return {'WDec': r.randn(e + D, 4 * h) * 0.3,
                'UDec': r.randn(h, 4 * h) * 0.3,
                'BDec': r.randn(1, 4 * h) * 0.1, 'WAttnQ': r.randn(h, D) * 0.3,
                'WEmb': r.randn(V, e) * 0.3, 'WOut': r.randn(h, V) * 0.3,
                'BOut': r.randn(1, V) * 0.1}

    enc_pages = r.randn(1 + C * npe, ps, D) * 0.5
    enc_pages[0] = 0
    mask_pages = np.ones((1 + C * npe, ps))
    mask_pages[0] = 0
    mask_pages[2, 1:] = 0
    pt_hist = np.arange(C * nph).reshape(C, nph)
    pt_hist[1] = C * nph
    ins = {k: v.astype('float32') for k, v in w(E, H).items()}
    ins.update({
        'H': r.randn(C, 1, H).astype('float32') * 0.5,
        'C': r.randn(C, 1, H).astype('float32') * 0.5,
        'PrevIds': r.randint(0, V, (C, 1)).astype('int32'),
        'Acc': (-r.rand(C, 1) * 3).astype('float32'),
        'Fin': np.array([[0], [0], [1], [0]], bool),
        'Step': np.array([6, 0, 3, 0], 'int32'),
        'Limit': np.array([T, T, 5, T], 'int32'),
        'Active': np.array([1, 0, 1, 1], bool),
        'PtHist': pt_hist.astype('int32'),
        'PtEnc': (1 + np.arange(C * npe)).reshape(C, npe).astype('int32'),
        'HistIds': r.randint(0, V, (C * nph, ps, 1)).astype('int32'),
        'HistPar': np.zeros((C * nph, ps, 1), 'int32'),
        'EncPages': enc_pages.astype('float32'),
        'MaskPages': mask_pages.astype('float32')})
    if draft == 'table':
        ins['DraftTable'] = r.randint(0, V, V).astype('int32')
    else:
        ins.update({'Draft' + k: v.astype('float32')
                    for k, v in w(4, 4).items()})
        ins['DraftH'] = r.randn(C, 4).astype('float32') * 0.5
        ins['DraftC'] = r.randn(C, 4).astype('float32') * 0.5
    return ins, {'end_id': 1, 'spec_k': spec_k, 'page_size': ps,
                 'src_cap': src,
                 'draft': 'table' if draft == 'table' else 'weights'}


@pytest.mark.parametrize('draft', ['weights', 'table'])
def test_spec_decode_rule_on_the_card_matches_the_cpu_without_a_sync(
        card, draft):
    """One dispatch of attention_lstm_spec_decode_step on the card under
    set_sync_debug_mode('error') against the CPU's (1e-5; ints equal):
    every attend is a paged_attention launch, 2 (spec_k + 1) with a
    weights draft and spec_k + 1 with a table, none on the CPU."""
    from paddle_tpu_torch.fluid import lowering
    ins, attrs = _spec_inputs(draft)
    rule = lowering.get_rule('attention_lstm_spec_decode_step')
    outs = {}
    for dev in (card, torch.device('cpu')):
        tins = {k: [torch.from_numpy(np.array(v)).to(dev)]
                for k, v in ins.items()}
        ctx = lowering.Ctx(dev, torch.Generator(device=dev))
        torch.cuda.synchronize()
        before = tpa.KERNEL.launches
        mode = torch.cuda.get_sync_debug_mode()
        if dev.type == 'cuda':
            torch.cuda.set_sync_debug_mode('error')
        try:
            out = rule(tins, attrs, ctx)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        want = (2 if draft == 'weights' else 1) * (attrs['spec_k'] + 1) \
            if dev.type == 'cuda' else 0
        assert tpa.KERNEL.launches - before == want, dev
        outs[dev.type] = {k: v.cpu().numpy() for k, v in out.items()}
    assert 'Accepted' in outs['cuda']
    for k, want in outs['cpu'].items():
        got = outs['cuda'][k]
        if want.dtype.kind in 'iub':
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_spec_engine_on_the_card_is_token_exact_against_greedy(card):
    """DecodeConfig(spec_k=3) with the target as its draft against the
    beam-1 paged engine, both on the card: equal tokens, scores within
    1e-5; 2 (spec_k + 1) paged_attention launches a dispatch."""
    from paddle_tpu_torch import serving
    r = np.random.RandomState(7)
    V, E, D, H, SRC, T = 20, 8, 6, 8, 5, 8
    w = {'w_dec': r.randn(E + D, 4 * H) * 0.3,
         'u_dec': r.randn(H, 4 * H) * 0.3,
         'b_dec': r.randn(1, 4 * H) * 0.1, 'w_q': r.randn(H, D) * 0.3,
         'w_emb': r.randn(V, E) * 0.3, 'w_out': r.randn(H, V) * 0.3,
         'b_out': r.randn(1, V) * 0.1}
    encs = [(r.randn(r.randint(2, SRC + 1), D) * 0.5).astype('float32')
            for _ in range(6)]
    lims = [3, T, 5, 1, 7, T]
    out = {}
    for spec_k in (None, 3):
        eng = serving.DecodeEngine(w, serving.DecodeConfig(
            slots=2, beam_size=1, max_len=T, src_cap=SRC, page_size=3,
            pages=12, spec_k=spec_k), draft=w if spec_k else None)
        try:
            eng.warmup()
            before = tpa.KERNEL.launches
            futs = [eng.submit({'enc': e}, max_new_tokens=n)
                    for e, n in zip(encs, lims)]
            out[spec_k] = [f.result(120) for f in futs]
            per = 2 * (spec_k + 1) if spec_k else 1
            assert tpa.KERNEL.launches - before == \
                per * (eng._handle.steps - 2)
            if spec_k:
                assert 0 < eng.stats['spec_accept_rate'] <= 1
        finally:
            eng.shutdown()
    for (ts, ss), (tg, sg) in zip(out[3], out[None]):
        np.testing.assert_array_equal(ts, tg)
        np.testing.assert_allclose(ss, sg, rtol=1e-5, atol=1e-5)


def test_captured_generating_program_matches_the_eager_walk(card):
    """machine_translation's generating program (emb, encoder and decoder
    16, vocab 12, beam 2, max_length 6): four batches of one time bucket
    (warm-up under sync debug, capture, two replays) against the eager
    walk from the same weights, sentence ids and scores bitwise; one
    capture and three replays; against the CPU, ids equal and scores
    within 1e-5. No kernel of the port launches."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import machine_translation as mt
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids, scores = mt.seq_to_seq_net(16, 16, 16, 12, 12,
                                        is_generating=True, beam_size=2,
                                        max_length=6)
    feeder = fluid.DataFeeder(['source_sequence'], fluid.CPUPlace(),
                              program=main)
    r = np.random.RandomState(8)
    feeds = [feeder.feed([(r.randint(2, 12, m).tolist(),)
                          for m in (n, 1, n - 2, 3)]) for n in (7, 8, 5, 6)]
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    runs = []
    for place, eager in ((fluid.CUDAPlace(0), False),
                         (fluid.CUDAPlace(0), True),
                         (fluid.CPUPlace(), False)):
        scope = fluid.Scope()
        scope.load_numpy(init.to_numpy(), place)
        exe = fluid.Executor(place)
        with (fluid.debugger.check_nan_inf() if eager
              else contextlib.nullcontext()):
            runs.append([exe.run(main, feed=f, fetch_list=[ids, scores],
                                 scope=scope) for f in feeds])
        if place == fluid.CUDAPlace(0) and not eager:
            stats = exe.cache_stats
            assert stats['captures'] == 1 and stats['replays'] == 3, stats
    for cap, eag, cpu in zip(*runs):
        assert cap[0].shape == (4, 2, 6) and cap[0].dtype == np.int64
        np.testing.assert_array_equal(cap[0], eag[0])
        np.testing.assert_array_equal(cap[1], eag[1])
        np.testing.assert_array_equal(cap[0], cpu[0])
        np.testing.assert_allclose(cap[1], cpu[1], rtol=1e-5, atol=1e-5)
    assert {n: k.launches for n, k in ops.KERNELS.items()} == before


# -- the CRF and CTC rules, label_semantic_roles ------------------------------

def _crf_ctc_cases():
    """(op, inputs, attrs, output slots, float input slots to
    differentiate) for the six CRF/CTC rules; sequences ragged with a
    length-1 and a full row; out-of-range labels (past C, below 0) in the
    CRF and CTC cases; exact ties (integer-valued emissions) in the
    Viterbi and greedy CTC cases."""
    r = np.random.RandomState(9)
    C, T = 5, 6
    lens = np.array([3, 1, T, 4])

    def seq(*trail, t=T, lengths=lens, ints=None):
        if ints is None:
            x = r.randn(len(lengths), t, *trail).astype('float32')
        else:
            x = r.randint(0, ints, (len(lengths), t, 1)).astype('int64')
        for i, n in enumerate(lengths):
            x[i, n:] = 0
        return ('seq', x, lengths)

    em = seq(C)
    tie = ('seq', np.round(em[1] * 1.5).astype('float32'), lens)
    trans = (r.randn(C + 2, C) * 0.5).astype('float32')
    label = seq(ints=C)
    bad = ('seq', label[1].copy(), lens)
    bad[1][0, 0, 0], bad[1][2, 3, 0], bad[1][3, 3, 0] = C + 3, -1, -4
    ctc_lab = seq(t=3, lengths=np.array([2, 1, 3, 0]), ints=C)
    ctc_bad = ('seq', ctc_lab[1].copy(), ctc_lab[2])
    ctc_bad[1][2, 1, 0] = C
    ids = seq(ints=4)
    tags = seq(t=12, lengths=np.array([7, 1, 12, 9]), ints=4 * 3 + 1)
    return [
        ('linear_chain_crf', {'Emission': [em], 'Transition': [trans],
                              'Label': [label]}, {},
         ['LogLikelihood', 'Alpha', 'EmissionExps', 'TransitionExps'],
         ['Emission', 'Transition']),
        ('linear_chain_crf', {'Emission': [em], 'Transition': [trans],
                              'Label': [bad]}, {}, ['LogLikelihood'],
         ['Emission', 'Transition']),
        ('crf_decoding', {'Emission': [tie],
                          'Transition': [np.round(trans * 2)]}, {},
         ['ViterbiPath'], []),
        ('crf_decoding', {'Emission': [em], 'Transition': [trans],
                          'Label': [label]}, {}, ['ViterbiPath'], []),
        ('ctc_align', {'Input': [('seq', np.round(r.rand(4, T, C) * 2)
                                  .astype('float32'), lens)]},
         {'blank': 0}, ['Output'], []),
        ('warpctc', {'Logits': [em], 'Label': [ctc_lab]},
         {'norm_by_times': True}, ['Loss'], ['Logits']),
        ('warpctc', {'Logits': [em], 'Label': [ctc_bad]}, {}, ['Loss'],
         ['Logits']),
        ('edit_distance', {'Hyps': [ids], 'Refs': [seq(ints=4)]},
         {'ignored_tokens': [0]}, ['Out', 'SequenceNum'], []),
        ('chunk_eval', {'Inference': [tags], 'Label': [tags]},
         {'chunk_scheme': 'IOBES', 'num_chunk_types': 3,
          'excluded_chunk_types': [1]},
         ['Precision', 'Recall', 'F1-Score', 'NumInferChunks',
          'NumLabelChunks', 'NumCorrectChunks'], []),
    ]


@pytest.mark.parametrize('case', range(len(_crf_ctc_cases())))
def test_crf_ctc_rule_on_the_card_matches_the_cpu_without_a_sync(card, case):
    """Each CRF/CTC rule on the card under set_sync_debug_mode('error')
    (forward, and the VJP of a seeded cotangent of its first output with
    respect to its float inputs) against the same rule on the CPU: floats
    within 1e-5 (NaN where the CPU has NaN: a label past C), ids, paths
    and counts equal, dtypes equal. Out-of-range labels raise no
    device-side assert: a later launch on the card still runs."""
    from paddle_tpu_torch.fluid import lowering
    op, ins, attrs, slots, wrt = _crf_ctc_cases()[case]
    outs = {}
    for dev in (card, torch.device('cpu')):
        tins = {k: [_seq_in(a, dev) for a in v] for k, v in ins.items()}
        leaves = [lowering.data_of(tins[k][0]).requires_grad_(True)
                  for k in wrt]
        ctx = lowering.Ctx(dev, torch.Generator(device=dev))
        # the cotangent goes to the card before the checked run
        shape = lowering.data_of(lowering.get_rule(op)(
            tins, attrs, ctx)[slots[0]]).shape
        cot = torch.from_numpy(np.asarray(np.random.RandomState(5).randn(
            *shape), dtype='float32')).to(dev)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        if dev.type == 'cuda':
            torch.cuda.set_sync_debug_mode('error')
        try:
            got = lowering.get_rule(op)(tins, attrs, ctx)
            res = []
            for slot in slots:
                v = got[slot]
                res.append(lowering.data_of(v))
                if isinstance(v, lowering.SeqValue):
                    res.append(v.lengths)
            if leaves:
                res += list(torch.autograd.grad(res[0], leaves, cot))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        outs[dev.type] = [t.detach().cpu() for t in res]
    for got, want in zip(outs['cuda'], outs['cpu']):
        assert got.dtype == want.dtype, op
        if got.is_floating_point():
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=op)
        else:
            np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                          err_msg=op)
    x = torch.ones(4, device=card) * 2
    torch.cuda.synchronize()
    assert x.sum().item() == 8.0


def test_captured_srl_step_matches_the_eager_walk(card):
    """label_semantic_roles at word_dim 16, hidden 32, depth 2 (SGD under
    the book's staircase exponential_decay), its pretrained `emb` loaded
    on the card through scope.find_var(...).get_tensor().set(...): four
    steps of nine sequence slots in one time bucket (warm-up under sync
    debug, capture, two replays) against the eager walk from the same
    weights, losses and every persistable bitwise; one capture, three
    replays; `emb` unchanged; no kernel of the port launches."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.dataset import conll05
    from paddle_tpu_torch.models import label_semantic_roles as srl
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        cost, decode, _, names = srl.get_model(word_dim=16, mark_dim=4,
                                               hidden_dim=32, depth=2)
        lr = fluid.layers.exponential_decay(0.01, 100000, 0.5,
                                            staircase=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
    feeder = fluid.DataFeeder(names, fluid.CPUPlace(), program=main)
    # sequences of 9-16 ids: the 16 bucket
    samples = [s for s in conll05.test()() if 8 < len(s[0]) <= 16]
    feeds = [feeder.feed(samples[4 * i:4 * i + 4]) for i in range(4)]
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    runs = []
    for eager in (False, True):
        scope = fluid.Scope()
        scope.load_numpy(init.to_numpy(), fluid.CUDAPlace(0))
        srl.load_pretrained_embedding(scope=scope)
        assert scope.vars['emb'].device.type == 'cuda'
        emb = scope.vars['emb'].clone()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with (fluid.debugger.check_nan_inf() if eager
              else contextlib.nullcontext()):
            losses = [exe.run(main, feed=f, fetch_list=[cost, decode],
                              scope=scope) for f in feeds]
        assert torch.equal(scope.vars['emb'], emb)
        runs.append((losses, scope.to_numpy(), exe))
    (cl, cs, cexe), (el, es, _) = runs
    for a, b in zip(cl, el):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for n in cs:
        np.testing.assert_array_equal(cs[n], es[n], err_msg=n)
    stats = cexe.cache_stats
    assert stats['captures'] == 1 and stats['replays'] == 3, stats
    assert {n: k.launches for n, k in ops.KERNELS.items()} == before


def _cf_book_decoder(fluid, V=40, E=8, H=8, beam=2, max_len=6, end_id=1):
    """The book's While-loop LoD beam decoder (decode_main) at tiny
    widths, as tests/test_torch_control_flow.py builds it."""
    layers = fluid.layers
    src = layers.data(name='src_word_id', shape=[1], dtype='int64',
                      lod_level=1)
    emb = layers.embedding(input=src, size=[V, E], dtype='float32',
                           param_attr=fluid.ParamAttr(name='vemb'))
    fc1 = layers.fc(input=emb, size=H * 4, act='tanh')
    h, _ = layers.dynamic_lstm(input=fc1, size=H * 4)
    context = layers.sequence_last_step(input=h)
    array_len = layers.fill_constant(shape=[1], dtype='int64', value=max_len)
    counter = layers.zeros(shape=[1], dtype='int64', force_cpu=True)
    state_array = layers.create_array('float32')
    layers.array_write(context, array=state_array, i=counter)
    ids_array = layers.create_array('int64')
    scores_array = layers.create_array('float32')
    init_ids = layers.data(name='init_ids', shape=[1], dtype='int64',
                           lod_level=2)
    init_scores = layers.data(name='init_scores', shape=[1],
                              dtype='float32', lod_level=2)
    layers.array_write(init_ids, array=ids_array, i=counter)
    layers.array_write(init_scores, array=scores_array, i=counter)
    cond = layers.less_than(x=counter, y=array_len)
    w = layers.While(cond=cond)
    with w.block():
        pre_ids = layers.array_read(array=ids_array, i=counter)
        pre_state = layers.array_read(array=state_array, i=counter)
        pre_score = layers.array_read(array=scores_array, i=counter)
        expanded = layers.sequence_expand(pre_state, pre_score)
        ids_emb = layers.embedding(input=pre_ids, size=[V, E],
                                   dtype='float32')
        state = layers.fc(input=[expanded, ids_emb], size=H, act='tanh')
        score = layers.fc(input=layers.lod_reset(x=state, y=pre_score),
                          size=V, act='softmax')
        tk_sc, tk_idx = layers.topk(score, k=beam)
        accu = layers.elementwise_add(
            x=layers.log(tk_sc), y=layers.reshape(pre_score, shape=[-1]),
            axis=0)
        sel_ids, sel_sc = layers.beam_search(pre_ids, pre_score, tk_idx,
                                             accu, beam, end_id=end_id,
                                             level=0)
        layers.increment(x=counter, value=1, in_place=True)
        layers.array_write(state, array=state_array, i=counter)
        layers.array_write(sel_ids, array=ids_array, i=counter)
        layers.array_write(sel_sc, array=scores_array, i=counter)
        layers.logical_and(
            x=layers.less_than(x=counter, y=array_len),
            y=layers.logical_not(layers.is_empty(x=sel_ids)), out=cond)
    ids, scores = layers.beam_search_decode(ids=ids_array,
                                            scores=scores_array,
                                            beam_size=beam, end_id=end_id)
    return [ids, scores, counter]


def _cf_feed(fluid, sources):
    n = len(sources)
    return {'src_word_id': fluid.LoDTensor(
                np.concatenate(sources).reshape(-1, 1).astype('int64'),
                [[len(s) for s in sources]]),
            'init_ids': fluid.LoDTensor(np.zeros((n, 1), 'int64'),
                                        [[1] * n, [1] * n]),
            'init_scores': fluid.LoDTensor(np.ones((n, 1), 'float32'),
                                           [[1] * n, [1] * n])}


def test_captured_book_decoder_matches_the_eager_walk(card):
    """The book's While-loop LoD beam decoder captured on the card (warm-up
    under sync debug, capture, two replays): every call's sentences (2-level
    LoD, ids, scores) and live iterations bitwise those of the eager walk
    (check_nan_inf), ids and LoD equal to the CPU's and scores within 1e-5;
    one capture, three replays; no kernel of the port launches."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import ops
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = _cf_book_decoder(fluid)
    sources = [[5, 9, 3, 7], [12, 4], [30, 31, 32, 2, 6, 8], [17]]
    feed = _cf_feed(fluid, sources)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    runs = {}
    for where in ('captured', 'eager', 'cpu'):
        place = fluid.CPUPlace() if where == 'cpu' else fluid.CUDAPlace(0)
        scope = fluid.Scope()
        scope.load_numpy(init.to_numpy(), place)
        exe = fluid.Executor(place)
        with (fluid.debugger.check_nan_inf() if where == 'eager'
              else contextlib.nullcontext()):
            runs[where] = [exe.run(main, feed=feed, fetch_list=fetch,
                                   scope=scope, return_numpy=False)
                           for _ in range(4 if where == 'captured' else 1)]
        if where == 'captured':
            assert exe.cache_stats['captures'] == 1
            assert exe.cache_stats['replays'] == 3
    eager, = runs['eager']
    cpu, = runs['cpu']
    for call in runs['captured']:
        for got, want in zip(call[:2], eager[:2]):
            assert got.recursive_sequence_lengths() == \
                want.recursive_sequence_lengths()
            np.testing.assert_array_equal(np.asarray(got.data),
                                          np.asarray(want.data))
        assert torch.equal(call[2].cpu(), eager[2].cpu())
    got = runs['captured'][-1]
    assert got[0].recursive_sequence_lengths() == \
        cpu[0].recursive_sequence_lengths()
    np.testing.assert_array_equal(np.asarray(got[0].data),
                                  np.asarray(cpu[0].data))
    np.testing.assert_allclose(np.asarray(got[1].data),
                               np.asarray(cpu[1].data), rtol=0, atol=1e-5)
    assert {n: k.launches for n, k in ops.KERNELS.items()} == before


def _cf_counter_loop(fluid, max_iters):
    layers = fluid.layers
    limit = layers.data(name='limit', shape=[1], dtype='int64',
                        append_batch_size=False)
    i = layers.zeros(shape=[1], dtype='int64')
    cond = layers.less_than(x=i, y=limit)
    w = layers.While(cond=cond, max_iters=max_iters)
    with w.block():
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=limit, cond=cond)
    return [i]


def test_while_past_its_bound_raises_on_the_card(card):
    """A while of bound 5 runs 3 iterations captured (warm-up, capture,
    replay), then a feed that asks for 20 makes the next replay raise,
    naming the op and the bound; so does a warm-up that overruns."""
    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = _cf_counter_loop(fluid, 5)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    for _ in range(3):
        out, = exe.run(main, feed={'limit': np.array([3], 'int64')},
                       fetch_list=fetch, scope=scope)
        assert int(out[0]) == 3
    assert exe.cache_stats['captures'] == 1
    with pytest.raises(RuntimeError, match='bound of 5'):
        exe.run(main, feed={'limit': np.array([20], 'int64')},
                fetch_list=fetch, scope=scope)
    with pytest.raises(RuntimeError, match=r'while op #\d+ of block 0'):
        fluid.Executor(fluid.CUDAPlace(0)).run(
            main, feed={'limit': np.array([20], 'int64')},
            fetch_list=fetch, scope=fluid.Scope())


def test_while_max_iters_backward_card_against_cpu(card):
    """A bounded While on the loss path (an fc tanh recurrence, 3 live of
    max_iters 6 iterations) trained 3 SGD steps captured on the card
    against the CPU: losses and parameters within 1e-5."""
    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data(name='x', shape=[8], dtype='float32')
        limit = layers.fill_constant(shape=[1], dtype='int64', value=3)
        i = layers.zeros(shape=[1], dtype='int64')
        acc = layers.fc(input=x, size=8, act='tanh')
        cond = layers.less_than(x=i, y=limit)
        loop = layers.While(cond=cond, max_iters=6)
        with loop.block():
            nxt = layers.fc(input=acc, size=8, act='tanh',
                            param_attr=fluid.ParamAttr(name='loop_w'))
            layers.assign(nxt, output=acc)
            layers.increment(x=i, in_place=True)
            layers.less_than(x=i, y=limit, cond=cond)
        loss = layers.reduce_mean(layers.square(acc))
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    xv = np.random.RandomState(0).randn(4, 8).astype('float32')
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    outs = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        scope.load_numpy(init.to_numpy(), place)
        exe = fluid.Executor(place)
        losses = [float(np.asarray(exe.run(main, feed={'x': xv},
                                           fetch_list=[loss],
                                           scope=scope)[0]).reshape(-1)[0])
                  for _ in range(3)]
        outs[type(place).__name__] = (losses, scope.to_numpy())
    (cl, cs), (pl, ps) = outs['CUDAPlace'], outs['CPUPlace']
    np.testing.assert_allclose(cl, pl, rtol=0, atol=1e-5)
    assert pl[-1] < pl[0]
    for n in ps:
        np.testing.assert_allclose(cs[n], ps[n], rtol=0, atol=1e-5,
                                   err_msg=n)


# -- the high-level Trainer on the card --------------------------------------

def _hl_conv_trainer(fluid, **kw):
    """The conv MNIST net of tests/test_book_high_level_api.py (8 filters)
    under Adam, as a Trainer on the card."""
    def train_func():
        img = fluid.layers.data(name='img', shape=[1, 28, 28],
                                dtype='float32')
        conv = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act='relu')
        predict = fluid.layers.fc(input=conv, size=10, act='softmax')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        avg = fluid.layers.mean(
            fluid.layers.cross_entropy(input=predict, label=label))
        return [avg, fluid.layers.accuracy(input=predict, label=label)]
    return fluid.Trainer(
        train_func=train_func,
        optimizer_func=lambda: fluid.optimizer.Adam(learning_rate=0.005),
        place=fluid.CUDAPlace(0), **kw)


def _hl_reader(steps=6, batch=32, seed=0):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(steps):
            imgs = rng.rand(batch, 1, 28, 28).astype('float32')
            labels = rng.randint(0, 10, size=(batch, 1)).astype('int64')
            yield [(imgs[i], labels[i]) for i in range(batch)]
    return r


@pytest.fixture
def cudnn_deterministic():
    """cuDNN's default convolution algorithms are not deterministic: a
    bitwise comparison of conv nets captures under deterministic ones."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


def _hl_state(trainer):
    return {v.name: trainer.scope.vars[v.name].detach().cpu().clone()
            for v in trainer.train_program.list_vars()
            if v.persistable and v.name in trainer.scope.vars}


def test_trainer_double_buffer_through_capture_is_bitwise_inline(
        card, cudnn_deterministic, tmp_path):
    """3 epochs with double_buffer=True: the prefetch worker stages batches
    (pinned host memory) while the step warms up, captures and replays;
    every persistable is bitwise the inline-feed run's."""
    import paddle_tpu_torch.fluid as fluid
    start = str(tmp_path / 'start')
    _hl_conv_trainer(fluid).save_params(start)
    runs = {}
    for db in (False, True):
        t = _hl_conv_trainer(fluid, param_path=start, double_buffer=db)
        losses = []
        t.train(num_epochs=3, event_handler=lambda ev: losses.append(
            float(np.asarray(ev.metrics[0]).reshape(-1)[0]))
            if isinstance(ev, fluid.EndStepEvent) else None,
            reader=_hl_reader(), feed_order=['img', 'label'])
        torch.cuda.synchronize()
        assert t.exe.cache_stats['captures'] == 1
        # call 1 warms up, call 2 captures and replays
        assert t.exe.cache_stats['replays'] == 3 * 6 - 1
        runs[db] = (losses, _hl_state(t), t.batches_fed)
    assert runs[True][0] == runs[False][0]
    assert runs[True][2] == runs[False][2] == 18
    for n, a in runs[False][1].items():
        assert torch.equal(runs[True][1][n], a), n


def test_place_feed_stages_pinned_host_memory_only(card):
    """Executor._place_feed (the prefetch worker's stage) leaves every
    value on the host, pinned, and allocates nothing on the card."""
    import paddle_tpu_torch.fluid as fluid
    t = _hl_conv_trainer(fluid)
    feeder = fluid.DataFeeder(feed_list=['img', 'label'],
                              place=fluid.CUDAPlace(0),
                              program=t.train_program)
    fed = feeder.feed(next(_hl_reader()()))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    staged = t.exe._place_feed(t.train_program, fed)
    assert torch.cuda.memory_allocated() == before
    for n, v in staged.items():
        assert v.device.type == 'cpu' and v.is_pinned(), n
        assert np.array_equal(v.numpy(), fed[n].astype(v.numpy().dtype))


def test_checkpoint_with_async_steps_in_flight_reads_after_them(card,
                                                                tmp_path):
    """sync='async' with step_interval=1: each serial the Trainer writes
    equals the scope after a full synchronize (the save reads the static
    tensors after the replay that wrote them)."""
    import paddle_tpu_torch.fluid as fluid
    ckpt = str(tmp_path / 'ckpt')
    cfg = fluid.CheckpointConfig(checkpoint_dir=ckpt, step_interval=1,
                                 max_num_checkpoints=2)
    t = _hl_conv_trainer(fluid, sync='async', async_window=3,
                         checkpoint_config=cfg)
    checked = []

    def handler(ev):
        if not isinstance(ev, fluid.EndStepEvent):
            return
        torch.cuda.synchronize()
        serial = fluid.io.list_checkpoint_serials(ckpt)[-1]
        path = os.path.join(ckpt, 'checkpoint_%d' % serial, '__params__.npz')
        with np.load(path) as saved:
            for n, v in _hl_state(t).items():
                assert np.array_equal(saved[n], v.numpy()), (ev.step, n)
        checked.append(ev.step)

    t.train(num_epochs=1, event_handler=handler, reader=_hl_reader(),
            feed_order=['img', 'label'])
    assert checked == list(range(6))
    assert t.exe.cache_stats['replays'] == 5


def test_load_between_captured_steps_reaches_the_next_replay(
        card, cudnn_deterministic, tmp_path):
    """io.load_checkpoint between two replays rebinds the scope; the next
    replay copies the loaded values into the graph's static tensors and
    computes from them: it repeats the step taken from that state."""
    import paddle_tpu_torch.fluid as fluid
    t = _hl_conv_trainer(fluid)
    feeder = fluid.DataFeeder(feed_list=['img', 'label'],
                              place=fluid.CUDAPlace(0),
                              program=t.train_program)
    feeds = [feeder.feed(b) for b in _hl_reader(steps=5)()]
    fetch = t.train_func_outputs
    ckpt = str(tmp_path / 'ckpt')
    with fluid.scope_guard(t.scope):
        for f in feeds[:3]:
            t.exe.run(t.train_program, feed=f, fetch_list=fetch)
        fluid.io.save_checkpoint(t.exe, ckpt, main_program=t.train_program,
                                 step=1)
        a = t.exe.run(t.train_program, feed=feeds[3], fetch_list=fetch)
        after_a = _hl_state(t)
        t.exe.run(t.train_program, feed=feeds[4], fetch_list=fetch)
        fluid.io.load_checkpoint(t.exe, ckpt, main_program=t.train_program)
        b = t.exe.run(t.train_program, feed=feeds[3], fetch_list=fetch)
        after_b = _hl_state(t)
    assert t.exe.cache_stats['captures'] == 1
    assert t.exe.cache_stats['replays'] == 5
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for n, v in after_a.items():
        assert torch.equal(after_b[n], v), n


def test_trainer_preempted_on_the_card_resumes_bitwise(card, tmp_path):
    """request_preemption at (1, 2): the emergency serial holds the state
    at preemption bitwise, and a fresh Trainer resumes at (1, 3) from it."""
    import paddle_tpu_torch.fluid as fluid
    ckpt = str(tmp_path / 'ckpt')

    def cfg():
        return fluid.CheckpointConfig(checkpoint_dir=ckpt, step_interval=100)

    t = _hl_conv_trainer(fluid, checkpoint_config=cfg())

    def handler(ev):
        if isinstance(ev, fluid.BeginStepEvent) and (ev.epoch, ev.step) \
                == (1, 2):
            t.request_preemption()

    t.train(num_epochs=3, event_handler=handler, reader=_hl_reader(),
            feed_order=['img', 'label'])
    assert t.preempted
    torch.cuda.synchronize()
    state = _hl_state(t)
    t2 = _hl_conv_trainer(fluid, checkpoint_config=cfg())
    resumed = _hl_state(t2)
    for n, v in state.items():
        assert torch.equal(resumed[n], v), n
    steps = []
    t2.train(num_epochs=3, event_handler=lambda ev: steps.append(
        (ev.epoch, ev.step)) if isinstance(ev, fluid.BeginStepEvent)
        else None, reader=_hl_reader(), feed_order=['img', 'label'])
    assert steps[0] == (1, 3)


def _stream_deepfm(fluid, deepfm, held=None):
    """A sparse DeepFM of 4 fields, vocab 32, embed_dim 4, hidden [8]."""
    feat = fluid.layers.data(name='feat_ids', shape=[4], dtype='int64')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    cost, prob, _ = deepfm.deepfm(feat, label, num_fields=4, vocab_size=32,
                                  embed_dim=4, hidden=[8], is_sparse=True)
    if held is not None:
        held['prob'] = prob
    return cost


def test_push_rows_reaches_the_next_replay_without_a_capture(card, tmp_path):
    """push_rows into a Predictor whose bucket is captured: the rows land in
    the graph's static tables (the scope's tensors, not rebound), the next
    replay answers with them, equal to a fresh Predictor given the same
    rows, and no graph is captured again."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import deepfm
    main, startup = framework.Program(), framework.Program()
    held = {}
    with unique_name.guard(), framework.program_guard(main, startup):
        _stream_deepfm(fluid, deepfm, held)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup)
            d = str(tmp_path / 'scorer')
            fluid.io.save_inference_model(d, ['feat_ids'], [held['prob']],
                                          exe, main_program=main)
    feed = {'feat_ids': np.array([[3, 5, 7, 9], [1, 3, 5, 31]], 'int64')}
    pred = inference.Predictor(d)
    eng = serving.ServingEngine(pred, serving.ServingConfig(
        max_batch_size=2, buckets=[2]))
    try:
        eng.warmup(example_feed=feed)
        before = eng.predict(feed)[0]
        stats = pred._exe.cache_stats
        assert stats['captures'] == 1 and stats['replays'] >= 1
        table = pred._scope.vars['fm_embed']
        ptr = table.data_ptr()
        rng = np.random.RandomState(0)
        ids = np.array([3, 5, 31])
        deltas = {'fm_embed': (ids, rng.randn(3, 4).astype('float32')),
                  'fm_first_w': (ids, rng.randn(3, 1).astype('float32'))}
        assert eng.push_rows(deltas) == 6
        after = eng.predict(feed)[0]
        assert pred._scope.vars['fm_embed'] is table
        assert table.data_ptr() == ptr
        assert pred._exe.cache_stats['captures'] == 1
        assert pred._exe.cache_stats['replays'] > stats['replays']
        assert not np.array_equal(after, before)
        fresh = inference.Predictor(d)
        for name, (rows, vals) in deltas.items():
            fresh._scope.vars[name][torch.as_tensor(rows, device=card)] = \
                torch.as_tensor(vals, device=card)
        want = fresh.run(feed)[0]
        np.testing.assert_allclose(after, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            table[torch.as_tensor(ids, device=card)].cpu().numpy(),
            deltas['fm_embed'][1])
    finally:
        eng.shutdown()


def test_row_resetter_zeroes_the_captured_deepfm_steps_static_tables(card):
    """train_stream on the card with a small VocabTable (every step admits
    and evicts): one capture for the whole stream, the tables and moments
    stay the graph's static tensors (never rebound), each evicted row is
    zero in fm_embed and both moments after its boundary, and the losses
    and every persistable match the same stream on the CPU (1e-5), so
    every replay read the zeroed rows."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import streaming
    from paddle_tpu_torch.models import deepfm

    def trainer(place):
        return fluid.Trainer(
            train_func=lambda: [_stream_deepfm(fluid, deepfm)],
            optimizer_func=lambda: fluid.optimizer.Adam(learning_rate=1e-2),
            place=place)

    def reader():
        rng = np.random.RandomState(1)
        for t in range(12):
            ids = (t * 7 + rng.zipf(1.5, size=(8, 4))).astype('int64')
            lab = rng.randint(0, 2, size=(8, 1)).astype('int64')
            yield [(ids[i], lab[i]) for i in range(8)]

    names = ['fm_embed', 'moment1_fm_embed_0', 'moment2_fm_embed_0']
    gpu, cpu = trainer(fluid.CUDAPlace(0)), trainer(fluid.CPUPlace())
    cpu.scope.load_numpy({n: t.detach().cpu().numpy()
                          for n, t in gpu.scope.vars.items()},
                         fluid.CPUPlace())
    out = {}
    for tag, tr in (('gpu', gpu), ('cpu', cpu)):
        vt = streaming.VocabTable(32, table='fm_embed', admit_count=1)
        drained, losses, ptrs = [], [], set()
        drain = vt.drain_resets

        def record(drain=drain, drained=drained):
            rows = drain()
            drained.extend(rows)
            return rows

        vt.drain_resets = record

        def handler(ev, tr=tr, drained=drained, losses=losses, ptrs=ptrs):
            if isinstance(ev, fluid.BeginStepEvent):
                for r in drained:
                    for n in names:
                        assert not tr.scope.vars[n][r].any(), (n, r)
                del drained[:]
                ptrs.add(tuple(tr.scope.vars[n].data_ptr() for n in names))
            else:
                losses.append(float(np.asarray(ev.metrics[0]).reshape(-1)[0]))

        tr.train_stream(reader, event_handler=handler,
                        vocabs={'feat_ids': vt})
        out[tag] = (losses, {n: t.detach().cpu().numpy()
                             for n, t in tr.scope.vars.items()}, vt)
        if tag == 'gpu':
            assert tr.exe.cache_stats['captures'] == 1
            assert len(ptrs) <= 2     # the startup tensors, pinned once
            assert vt.rows_evicted > 0
    np.testing.assert_allclose(out['gpu'][0], out['cpu'][0], rtol=1e-5,
                               atol=1e-5)
    for n, v in out['cpu'][1].items():
        np.testing.assert_allclose(out['gpu'][1][n], v, rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    assert out['gpu'][2].state_dict() == out['cpu'][2].state_dict()


# -- token streaming and the compiled serving artifact ------------------------

def _bf16_ulps_close(got, want, ulps=2):
    """Within `ulps` bf16 ulps of want's largest magnitude."""
    m = float(want.abs().max())
    tol = ulps * 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_operator_launches_the_kernel_once_a_call(card, dtype, causal):
    """torch.ops.paddle_tpu_torch.flash_attention_lse on CUDA tensors is
    the forward kernel of q's dtype: one launch a call, counted by the
    kernel's counter, against the plain version."""
    q, k, v, kb = _fwd_case(card, 2, 3, 64, 70, 64, 23)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kern = tfa.KERNEL if dtype == torch.float32 else tfa.KERNEL_BF16
    other = tfa.KERNEL_BF16 if dtype == torch.float32 else tfa.KERNEL
    before, before_other = kern.launches, other.launches
    o, lse = torch.ops.paddle_tpu_torch.flash_attention_lse(
        q, k, v, kb, causal, 0.125)
    torch.cuda.synchronize()
    assert kern.launches == before + 1 and other.launches == before_other
    o_ref, lse_ref = tfa.flash_attention_lse_plain(q, k, v, kb, causal,
                                                   0.125)
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_ref, rtol=TOL, atol=TOL)
    else:
        _bf16_ulps_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL, atol=TOL)
    # the autograd path goes through the same operator
    o2, _ = tfa.flash_attention_lse(q, k, v, key_bias=kb, causal=causal,
                                    sm_scale=0.125)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert torch.equal(o2, o)


def test_a_loaded_artifact_on_the_card_matches_the_cpu_export(card,
                                                              tmp_path):
    """A small Transformer exported on the CPU and on the card from one
    startup state: each artifact loads on its device, the card's logits
    within 1e-4 of max(1, |logit|) of the CPU's; on the card its calls warm
    up, capture once and replay, 3 x n_layer flash-attention forward
    launches a call."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import transformer as T
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        T.transformer(100, 100, 40, n_layer=2, d_model=64, n_head=4,
                      d_inner=128)
    blk = main.global_block()
    lg = [op.input('Logits')[0] for op in blk.ops
          if op.type == 'softmax_with_cross_entropy'][0]
    logits = blk.var([op.input('X')[0] for op in blk.ops
                      if op.type == 'reshape'
                      and op.output('Out')[0] == lg][0])
    r = np.random.RandomState(3)
    feed = {n: r.randint(1, 100, (4, 40)).astype('int64')
            for n in ('src_word', 'trg_word')}
    feed['trg_word'][2, 11:] = 0
    cpu_scope = fluid.Scope()
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_exe.run(startup, scope=cpu_scope)
    card_scope = fluid.Scope()
    card_scope.load_numpy(cpu_scope.to_numpy(), fluid.CUDAPlace(0))
    dirs = {}
    for tag, exe, scope in (('cpu', cpu_exe, cpu_scope),
                            ('cuda', fluid.Executor(fluid.CUDAPlace(0)),
                             card_scope)):
        dirs[tag] = str(tmp_path / tag)
        inference.export_compiled(dirs[tag], feed, [logits], exe,
                                  main_program=main, scope=scope)
    want = inference.load_compiled(dirs['cpu'], fluid.CPUPlace())(feed)[0]
    with pytest.raises(ValueError, match='exported for cpu.*on cuda'):
        inference.load_compiled(dirs['cpu'])
    run = inference.load_compiled(dirs['cuda'])
    outs = []
    for i in range(3):
        before = tfa.KERNEL.launches
        outs.append(run(feed)[0])
        assert tfa.KERNEL.launches - before == 6, i
    stats = run.cache_stats()
    assert stats['captures'] == 1 and stats['replays'] == 2
    for got in outs:
        assert np.array_equal(got, outs[-1]) or np.allclose(
            got, outs[-1], rtol=0, atol=1e-6)
        assert (np.abs(got - want)
                <= 1e-4 * np.maximum(1.0, np.abs(want))).all()


def test_abort_resume_and_push_rows_reach_the_next_replay(card):
    """The paged engine on the card, warmed up (its step captured): a
    stream cancelled after 3 tokens frees its slot and pages, a
    checkpoint resumes token-exact, and push_rows reaches the next
    dispatch (equal to a fresh engine given the rows), with the captures
    unchanged by all three and one host copy a streaming dispatch."""
    from paddle_tpu_torch import serving
    r = np.random.RandomState(11)
    V, E, D, H, SRC, T = 20, 8, 6, 8, 5, 12
    w = {'w_dec': r.randn(E + D, 4 * H) * 0.3,
         'u_dec': r.randn(H, 4 * H) * 0.3,
         'b_dec': r.randn(1, 4 * H) * 0.1, 'w_q': r.randn(H, D) * 0.3,
         'w_emb': r.randn(V, E) * 0.3, 'w_out': r.randn(H, V) * 0.3,
         'b_out': r.randn(1, V) * 0.1}
    w = {k: v.astype('float32') for k, v in w.items()}
    enc = (r.randn(4, D) * 0.5).astype('float32')
    cfg = dict(slots=2, beam_size=3, max_len=T, src_cap=SRC, page_size=3,
               pages=16, prefix_cache=False)
    eng = serving.DecodeEngine(w, serving.DecodeConfig(**cfg))
    try:
        eng.warmup()
        caps = eng.cache_stats()['captures']
        base = eng.stats
        want = eng.submit({'enc': enc}, max_new_tokens=T).result(60)
        ckpts, seen = [], []
        s0 = eng.stats
        got = eng.submit({'enc': enc}, max_new_tokens=T,
                         on_token=lambda t, ids: seen.append(t),
                         checkpoint=ckpts.append, ckpt_every=4).result(60)
        s1 = eng.stats
        assert s1['host_syncs'] - s0['host_syncs'] == s1['steps'] - s0['steps']
        assert seen == list(range(1, T + 1))
        np.testing.assert_array_equal(got[0], want[0])
        for c in ckpts:
            res = eng.submit({'enc': enc}, max_new_tokens=T,
                             resume=c).result(60)
            np.testing.assert_array_equal(res[0], want[0])
            np.testing.assert_allclose(res[1], want[1], rtol=1e-6,
                                       atol=1e-6)

        def consumer(t, ids):
            if t == 3:
                raise IOError('gone')

        fut = eng.submit({'enc': enc}, max_new_tokens=T, on_token=consumer)
        with pytest.raises(serving.StreamCancelled):
            fut.result(60)
        deadline = time.monotonic() + 10
        while eng.stats['pages_free'] != base['pages_free'] \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.stats['pages_free'] == base['pages_free']
        ids = np.array([0, 3, 5])
        rows = (r.randn(3, E) * 0.5).astype('float32')
        eng.push_rows({'cbd_w_emb': (ids, rows)})
        pushed = eng.submit({'enc': enc}, max_new_tokens=T).result(60)
        assert eng.cache_stats()['captures'] == caps
    finally:
        eng.shutdown()
    w2 = dict(w, w_emb=w['w_emb'].copy())
    w2['w_emb'][ids] = rows
    fresh = serving.DecodeEngine(w2, serving.DecodeConfig(**cfg))
    try:
        want2 = fresh.submit({'enc': enc}, max_new_tokens=T).result(60)
    finally:
        fresh.shutdown()
    np.testing.assert_array_equal(pushed[0], want2[0])
    np.testing.assert_allclose(pushed[1], want2[1], rtol=1e-6, atol=1e-6)


# -- tiered embedding storage ---------------------------------------------------

def _tier_tensors(device, seed=0, cap=64, dim=10):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(cap, dim).astype('float32')).to(device)
            for _ in range(3)]


def test_tier_spill_and_restore_act_in_place_bitwise_the_cpu(card):
    """RowSpiller on CUDA tensors: the gathered rows bitwise the CPU
    path's, the rows zeroed in the same tensors (data_ptr unchanged), one
    host wait for the one copy; RowRestorer writes other values back in
    place, bitwise the CPU path."""
    from paddle_tpu_torch.embedding import tiers
    rows = [3, 17, 40, 5, 63, 0, 17]
    gpu, cpu = _tier_tensors(card), _tier_tensors('cpu')
    ptrs = [t.data_ptr() for t in gpu]
    sp_g, sp_c = tiers.RowSpiller(), tiers.RowSpiller()
    _, got = sp_g.spill(gpu, rows, lock=contextlib.nullcontext())
    _, want = sp_c.spill(cpu, rows)
    assert sp_g.host_waits == 1 and sp_c.host_waits == 0
    assert sorted(got) == sorted(want) == sorted(set(rows))
    for r in want:
        for g, w in zip(got[r], want[r]):
            np.testing.assert_array_equal(g, w)
    assert [t.data_ptr() for t in gpu] == ptrs
    for g, c in zip(gpu, cpu):
        np.testing.assert_array_equal(g.cpu().numpy(), c.numpy())
        assert not g[torch.as_tensor(rows, device=card)].any()
    back = [1, 17, 33]
    vals = [np.random.RandomState(9 + i).randn(3, 10).astype('float32')
            for i in range(3)]
    tiers.RowRestorer().restore(gpu, back, vals)
    tiers.RowRestorer().restore(cpu, back, vals)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in gpu] == ptrs
    for g, c in zip(gpu, cpu):
        np.testing.assert_array_equal(g.cpu().numpy(), c.numpy())


def test_tier_restore_pinned_buffer_survives_a_non_blocking_copy(card):
    """The restore's values cross from memory pinned by pin_memory() with
    non_blocking=True while the stream is still busy: pinned blocks taken
    and scribbled on right after (the caching host allocator must not hand
    the restore's block out before its copy ran) do not reach the table."""
    from paddle_tpu_torch.embedding import tiers
    t = torch.zeros(4096, 10, device=card)
    rows = list(range(0, 4096, 2))
    vals = np.random.RandomState(4).randn(len(rows), 10).astype('float32')
    torch.cuda._sleep(200_000_000)         # the stream is busy ~0.1 s
    tiers.RowRestorer().restore([t], rows, [vals])
    held = []
    for _ in range(16):
        p = torch.empty(len(rows), 1, 10, pin_memory=True)
        p.fill_(-7.0)
        held.append(p)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(t[rows].cpu().numpy(), vals)
    assert not t[1::2].any()


def test_tiered_boundary_in_a_captured_stream_adds_no_capture(card,
                                                              tmp_path):
    """train_stream on the card over a TieredVocabTable (capacity 32, a
    stream that cycles through three windows: every step spills, most
    re-admit warm): one capture for the whole stream, the tables and
    moments never rebound, and the losses, every persistable (1e-5), the
    tier counts and the tier state (map, ops, spill slots) equal to the
    same stream on the CPU."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import streaming
    from paddle_tpu_torch.models import deepfm

    def trainer(place):
        return fluid.Trainer(
            train_func=lambda: [_stream_deepfm(fluid, deepfm)],
            optimizer_func=lambda: fluid.optimizer.Adam(learning_rate=1e-2),
            place=place)

    def reader():
        rng = np.random.RandomState(2)
        for t in range(15):
            ids = ((t % 3) * 50 + rng.zipf(1.5, size=(8, 4)) % 40).astype(
                'int64')
            lab = rng.randint(0, 2, size=(8, 1)).astype('int64')
            yield [(ids[i], lab[i]) for i in range(8)]

    names = ['fm_embed', 'moment1_fm_embed_0', 'moment2_fm_embed_0']
    gpu, cpu = trainer(fluid.CUDAPlace(0)), trainer(fluid.CPUPlace())
    cpu.scope.load_numpy({n: t.detach().cpu().numpy()
                          for n, t in gpu.scope.vars.items()},
                         fluid.CPUPlace())
    out = {}
    for tag, tr in (('gpu', gpu), ('cpu', cpu)):
        tt = streaming.TieredVocabTable(
            streaming.VocabTable(32, table='fm_embed', admit_count=1),
            streaming.HostArena(str(tmp_path / tag), 512))
        losses, ptrs = [], set()

        def handler(ev, tr=tr, losses=losses, ptrs=ptrs):
            if isinstance(ev, fluid.BeginStepEvent):
                ptrs.add(tuple(tr.scope.vars[n].data_ptr() for n in names))
            else:
                losses.append(float(np.asarray(ev.metrics[0]).reshape(-1)[0]))

        tr.train_stream(reader, event_handler=handler,
                        vocabs={'feat_ids': tt})
        out[tag] = (losses, {n: t.detach().cpu().numpy()
                             for n, t in tr.scope.vars.items()}, tt)
        if tag == 'gpu':
            assert tr.exe.cache_stats['captures'] == 1
            assert len(ptrs) <= 2     # the startup tensors, pinned once
            assert tt.spilled > 0 and tt.restored > 0
            assert tt._spiller.host_waits > 0
    np.testing.assert_allclose(out['gpu'][0], out['cpu'][0], rtol=1e-5,
                               atol=1e-5)
    for n, v in out['cpu'][1].items():
        np.testing.assert_allclose(out['gpu'][1][n], v, rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    g, c = out['gpu'][2], out['cpu'][2]
    assert (g.spilled, g.restored, g.tier_hits, g.tier_misses) == \
        (c.spilled, c.restored, c.tier_hits, c.tier_misses)
    # the same map, ops and spill slots; the slots' CRC32s differ with the
    # rows' last bits (the card and the CPU sum in other orders)
    gs, cs = g.state_dict(), c.state_dict()
    for sd in (gs, cs):
        sd['arena']['entries'] = [e[:2] for e in sd['arena']['entries']]
    assert gs == cs


# -- the pass pipeline and int8 weight quantization --------------------------

def test_quant_rules_on_the_card_match_the_cpu(card):
    """dequantize and quant_lookup_table on CUDA tensors under sync debug
    (no host read): bitwise the CPU, an id past V and below -V reading NaN
    rows, a negative id wrapping, padding_idx through its scale."""
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.ops_impl.quant_ops import quantize_array
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(50, 24).astype('float32'))
    q, s = quantize_array(w, axis=0)
    ids = torch.tensor([[0], [7], [50], [-1], [-51], [49], [3], [7]])
    cases = [('dequantize', {'X': [q], 'Scale': [s]}, {}),
             ('quant_lookup_table', {'W': [q], 'Scale': [s], 'Ids': [ids]},
              {}),
             ('quant_lookup_table', {'W': [q], 'Scale': [s], 'Ids': [ids]},
              {'padding_idx': 7})]
    for op_type, ins, attrs in cases:
        rule = lowering.get_rule(op_type)
        want = rule(ins, attrs, lowering.Ctx(torch.device('cpu')))['Out']
        dev = {k: [t.to(card) for t in vs] for k, vs in ins.items()}
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode('error')
        try:
            got = rule(dev, attrs, lowering.Ctx(card))['Out']
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        got = got.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want)), op_type
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=op_type)
    gq, gs = quantize_array(w.to(card), axis=1)
    cq, cs = quantize_array(w, axis=1)
    assert torch.equal(gq.cpu(), cq) and torch.equal(gs.cpu(), cs)


def _quant_net(fluid):
    layers = fluid.layers
    ids = layers.data(name='ids', shape=[3, 1], dtype='int64')
    emb = layers.embedding(ids, size=[200, 32],
                           param_attr=fluid.ParamAttr(name='emb_w'))
    return layers.fc(input=emb, size=16, num_flatten_dims=2,
                     param_attr=fluid.ParamAttr(name='fc_w'))


def test_a_mark_quant_program_runs_captured_on_the_card(card):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.passes import quant_pass
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = _quant_net(fluid)
    quant_pass.mark_quant(main)
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    init = cpu_scope.to_numpy()
    rng = np.random.RandomState(2)
    feeds = [{'ids': rng.randint(0, 200, (8, 3, 1)).astype('int64')}
             for _ in range(3)]
    gscope = fluid.Scope()
    gscope.load_numpy(init, fluid.CUDAPlace(0))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    got = [exe.run(main, feed=f, fetch_list=[out], scope=gscope)[0]
           for f in feeds]
    assert exe.cache_stats['captures'] == 1
    assert exe.cache_stats['replays'] == 2
    art = exe.step_artifact(main, feeds[0], [out], scope=gscope)
    types = [op.type for op in art.program.global_block().ops]
    assert 'quant_lookup_table' in types and 'dequantize' in types
    cexe = fluid.Executor(fluid.CPUPlace())
    for f, g in zip(feeds, got):
        want, = cexe.run(main, feed=f, fetch_list=[out], scope=cpu_scope)
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)


def test_amp_pass_step_launches_the_bf16_attention_kernels(card):
    """A small Transformer under decorate_program at PADDLE_TPU_OPT=default:
    the step runs the AMP pass's explicit casts with ctx.amp off, launches
    the three bf16 attention kernels 3 a layer pair and no fp32 one, and
    its loss is within one bf16 ulp of runtime AMP's on the card."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer as T
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _, _ = T.transformer(100, 100, 40, n_layer=2, d_model=64,
                                       n_head=4, d_inner=128,
                                       dropout_rate=0.0)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    fluid.amp.decorate_program(main)
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    init = cpu_scope.to_numpy()
    r = np.random.RandomState(1)
    feed = {n: r.randint(1, 100, (3, 40)).astype('int64')
            for n in ('src_word', 'trg_word', 'lbl_word')}
    kernels = (tfa.KERNEL, tfa.KERNEL_BWD_DQ, tfa.KERNEL_BWD_DKV,
               tfa.KERNEL_BF16, tfa.KERNEL_BWD_DQ_BF16,
               tfa.KERNEL_BWD_DKV_BF16)
    losses = {}
    prev = os.environ.get('PADDLE_TPU_OPT')
    try:
        for mode in ('off', 'default'):
            os.environ['PADDLE_TPU_OPT'] = mode
            s = fluid.Scope()
            s.load_numpy(init, fluid.CUDAPlace(0))
            exe = fluid.Executor(fluid.CUDAPlace(0))
            before = [k.launches for k in kernels]
            losses[mode] = exe.run(main, feed=feed, fetch_list=[avg_cost],
                                   scope=s)[0]
            launched = {k.name: k.launches - b
                        for k, b in zip(kernels, before)}
            art = exe.step_artifact(main, feed, [avg_cost], scope=s)
            if mode == 'default':
                assert art.program._amp_ir and not art.amp
                assert 'cast' in [op.type for op in
                                  art.program.global_block().ops]
            else:
                assert art.amp
            assert launched == {'flash_attention_fwd': 0,
                                'flash_attention_bwd_dq': 0,
                                'flash_attention_bwd_dkv': 0,
                                'flash_attention_fwd_bf16': 6,
                                'flash_attention_bwd_dq_bf16': 6,
                                'flash_attention_bwd_dkv_bf16': 6}, mode
    finally:
        if prev is None:
            os.environ.pop('PADDLE_TPU_OPT', None)
        else:
            os.environ['PADDLE_TPU_OPT'] = prev
    a = float(np.asarray(losses['off']).reshape(()))
    b = float(np.asarray(losses['default']).reshape(()))
    ulp = 2.0 ** (np.floor(np.log2(abs(a))) - 7)
    assert abs(a - b) <= ulp, (a, b)


# -- detection ----------------------------------------------------------------

def _det_rule(op_type, ins, attrs, device):
    """The rule on `device` (on the card under sync debug: no host read);
    a lod input is a (data, lengths) pair."""
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.lowering import SeqValue

    def put(a):
        if isinstance(a, tuple):
            return SeqValue(put(a[0]), put(a[1]))
        return a.to(device)

    dev = {k: [put(a) for a in vs] for k, vs in ins.items()}
    if device.type != 'cuda':
        return dev, lowering.get_rule(op_type)(dev, attrs,
                                               lowering.Ctx(device))
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        return dev, lowering.get_rule(op_type)(dev, attrs,
                                               lowering.Ctx(device))
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _boxes_t(g, *shape):
    xy = torch.rand(shape + (2,), generator=g) * 0.75
    wh = 0.05 + torch.rand(shape + (2,), generator=g) * 0.3
    return torch.cat([xy, xy + wh], -1)


def _nms_case(tied):
    """The served MobileNet-SSD's NMS input: 8 images, 2,278 decoded boxes,
    21 classes' softmax scores [B, M, C]; tied: repeated boxes and
    scores."""
    g = torch.Generator().manual_seed(25)
    boxes = _boxes_t(g, 8, 2278)
    scores = torch.softmax(4 * torch.randn(8, 2278, 21, generator=g), -1)
    if tied:
        boxes[:, 1::7] = boxes[:, ::7][:, :boxes[:, 1::7].shape[1]]
        scores[:, 1::7] = scores[:, ::7][:, :scores[:, 1::7].shape[1]]
        scores[:, 100:140, 3] = scores[:, 99:100, 3]
    return {'BBoxes': [boxes], 'Scores': [scores]}


NMS_ATTRS = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                 score_threshold=0.01, scores_layout='BMC')


@pytest.mark.parametrize('tied', [False, True])
def test_multiclass_nms_card_against_cpu(card, tied):
    """At the served SSD's sizes, under sync debug: rows equal to the CPU
    rule's (ties included: stable sorts, first-max argmaxes)."""
    ins = _nms_case(tied)
    _, want = _det_rule('multiclass_nms', ins, NMS_ATTRS,
                        torch.device('cpu'))
    _, got = _det_rule('multiclass_nms', ins, NMS_ATTRS, card)
    assert torch.equal(got['Out'].cpu(), want['Out'])
    assert (want['Out'][..., 0] >= 1).sum() > 100


def test_multiclass_nms_replay_is_bitwise_its_eager_walk(card):
    """The rule captured in a CUDA graph and replayed on new inputs copied
    into its static ones: bitwise an eager call on those inputs."""
    from paddle_tpu_torch.fluid import lowering
    rule = lowering.get_rule('multiclass_nms')
    ctx = lowering.Ctx(card)
    static = {k: [t.to(card) for t in vs]
              for k, vs in _nms_case(False).items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rule(static, NMS_ATTRS, ctx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = rule(static, NMS_ATTRS, ctx)['Out']
    fresh = _nms_case(True)
    for k in static:
        static[k][0].copy_(fresh[k][0])
    graph.replay()
    torch.cuda.synchronize()
    eager = rule({k: [t.to(card) for t in vs] for k, vs in fresh.items()},
                 NMS_ATTRS, ctx)['Out']
    assert torch.equal(out, eager)


def _ssd_loss_case():
    """The trained SSD's ssd_loss input at batch 32: 2,278 priors, 21
    classes, gt in the 16 bucket, one image with none, one with 16."""
    g = torch.Generator().manual_seed(26)
    b, p, c, w = 32, 2278, 21, 16
    lens = torch.randint(1, 9, (b,), generator=g)
    lens[0], lens[1] = 0, 16
    priors = _boxes_t(g, p)
    priors[1] = priors[0]
    gt = _boxes_t(g, b, w)
    gt[2, 0] = priors[0]
    return {'Loc': [torch.randn(b, p, 4, generator=g)],
            'Conf': [torch.randn(b, p, c, generator=g)],
            'GtBox': [(gt, lens)],
            'GtLabel': [(torch.randint(1, c, (b, w, 1), generator=g), lens)],
            'PriorBox': [priors],
            'PriorBoxVar': [torch.tensor([[0.1, 0.1, 0.2, 0.2]]).repeat(p, 1)]}


def test_ssd_loss_card_against_cpu(card):
    """At the trained SSD's sizes, under sync debug: the loss and its VJP
    on Loc and Conf within 1e-5 of their max."""
    ins = _ssd_loss_case()
    cot = torch.randn(32, 1, generator=torch.Generator().manual_seed(27))
    res = []
    for dev in (torch.device('cpu'), card):
        d_ins, out = _det_rule('ssd_loss', {
            k: [a if isinstance(a, tuple) else a.clone().requires_grad_()
                if k in ('Loc', 'Conf') else a for a in vs]
            for k, vs in ins.items()}, {}, dev)
        loss = out['Loss']
        grads = torch.autograd.grad((loss * cot.to(dev)).sum(),
                                    [d_ins['Loc'][0], d_ins['Conf'][0]])
        res.append([loss.detach().cpu()] + [t.cpu() for t in grads])
    for want, got in zip(*res):
        scale = max(float(want.abs().max()), 1e-12)
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_detection_map_card_against_cpu(card):
    """At the served batch's sizes (8 images, 200 rows, 21 classes; tied
    scores, gt in the 8 bucket, an image without gt): within 1e-5."""
    g = torch.Generator().manual_seed(28)
    det = torch.zeros(8, 200, 6)
    det[..., 0] = torch.randint(-1, 21, (8, 200), generator=g).float()
    det[..., 1] = torch.round(torch.rand(8, 200, generator=g) * 10) / 10
    det[..., 2:] = _boxes_t(g, 8, 200)
    lens = torch.randint(1, 9, (8,), generator=g)
    lens[3] = 0
    lab = torch.zeros(8, 8, 5)
    lab[..., 0] = torch.randint(1, 21, (8, 8), generator=g).float()
    lab[..., 1:] = _boxes_t(g, 8, 8)
    det[:, :8, 0], det[:, :8, 2:] = lab[..., 0], lab[..., 1:]
    ins = {'DetectRes': [det], 'Label': [(lab, lens)]}
    attrs = {'class_num': 21, 'overlap_threshold': 0.5}
    _, want = _det_rule('detection_map', ins, attrs, torch.device('cpu'))
    _, got = _det_rule('detection_map', ins, attrs, card)
    assert 0 < float(want['MAP']) <= 1
    assert abs(float(got['MAP']) - float(want['MAP'])) <= 1e-5


def test_rpn_target_assign_and_ties_card_against_cpu(card):
    """rpn_target_assign at the RPN head's sizes (16 images, 3,249 anchors,
    two identical) under sync debug: labels and gathers equal to the
    CPU's (argmax's first maximum and the scatter-max on the card)."""
    g = torch.Generator().manual_seed(29)
    anchors = _boxes_t(g, 3249) * 300
    anchors[1] = anchors[0]
    lens = torch.randint(1, 9, (16,), generator=g)
    lens[0] = 0
    gt = _boxes_t(g, 16, 8) * 300
    gt[1, 0] = anchors[0]
    ins = {'Loc': [torch.randn(16, 3249, 4, generator=g)],
           'Score': [torch.randn(16, 3249, 1, generator=g)],
           'AnchorBox': [anchors], 'GtBox': [(gt, lens)]}
    _, want = _det_rule('rpn_target_assign', ins, {}, torch.device('cpu'))
    _, got = _det_rule('rpn_target_assign', ins, {}, card)
    for k in ('PredScore', 'PredLoc', 'TargetLabel'):
        assert torch.equal(got[k].cpu(), want[k]), k
    assert float((got['TargetBox'].cpu() - want['TargetBox']).abs().max()) \
        <= 1e-5 * float(want['TargetBox'].abs().max())


# -- the rest of the training surface -------------------------------------------

def _training_surface_cases():
    """(op, ins, attrs, exact output slots) of the extra and sampled rules
    the card runs without a host read."""
    g = torch.Generator().manual_seed(31)

    def f(*s):
        return torch.randn(*s, generator=g)

    x_pool = f(2, 3, 9, 8)
    pool_attrs = {'ksize': [3, 3], 'strides': [1, 2], 'paddings': [1, 1]}
    from paddle_tpu_torch.fluid import lowering
    pooled = lowering.get_rule('max_pool2d_with_index')(
        {'X': [x_pool]}, pool_attrs, lowering.Ctx(torch.device('cpu')))
    match = torch.where(torch.rand(4, 300, generator=g) < 0.1,
                        torch.randint(0, 5, (4, 300), generator=g),
                        -1).int()
    return [
        # the softplus rule: logaddexp on the card, where a CPU-scalar
        # operand raises
        ('softplus', {'X': [f(8, 16) * 30]}, {}, ()),
        ('cumsum', {'X': [f(8, 33)]}, {'axis': 1, 'exclusive': True,
                                       'reverse': True}, ()),
        ('norm', {'X': [f(4, 6, 5)]}, {'axis': 1}, ()),
        ('conv_shift', {'X': [f(8, 40)], 'Y': [f(8, 5)]}, {}, ()),
        ('bilinear_tensor_product', {'X': [f(8, 6)], 'Y': [f(8, 7)],
                                     'Weight': [f(3, 6, 7)],
                                     'Bias': [f(1, 3)]}, {}, ()),
        ('max_pool2d_with_index', {'X': [x_pool]}, pool_attrs, ('Mask',)),
        ('unpool', {'X': [pooled['Out']], 'Indices': [pooled['Mask']]},
         dict(pool_attrs, unpooling_type='max', output_size=[9, 8]), ()),
        ('spp', {'X': [f(2, 3, 7, 9)]}, {'pyramid_height': 3}, ()),
        ('positive_negative_pair', {
            'Score': [torch.round(f(40, 2) * 4) / 4],
            'Label': [torch.randint(0, 3, (40, 1), generator=g).float()],
            'QueryID': [torch.randint(0, 5, (40, 1), generator=g)]},
         {'column': 0}, ()),
        ('precision_recall', {
            'Indices': [torch.randint(0, 6, (50, 1), generator=g)],
            'Labels': [torch.randint(0, 6, (50, 1), generator=g)],
            'StatesInfo': [f(6, 4).abs()]}, {'class_number': 6}, ()),
        ('fake_quantize', {'X': [f(8, 16)]}, {'bit_length': 8}, ()),
        ('mine_hard_examples', {
            'ClsLoss': [torch.round(f(4, 300).abs() * 2) / 2],
            'MatchIndices': [match], 'MatchDist': [torch.rand(
                4, 300, generator=g)]}, {}, ('NegIndices',
                                          'UpdatedMatchIndices')),
        ('proximal_adagrad', {
            'Param': [f(8, 9)], 'Grad': [f(8, 9)],
            'Moment': [f(8, 9).abs() + 0.1],
            'LearningRate': [torch.tensor([0.1])]}, {'l1': 0.1, 'l2': 0.2},
         ()),
        ('hierarchical_sigmoid', {
            'X': [f(16, 12)], 'W': [f(99, 12)], 'Bias': [f(1, 99)],
            'Label': [torch.randint(0, 100, (16, 1), generator=g)]},
         {'num_classes': 100}, ()),
    ]


@pytest.mark.parametrize('case', range(len(_training_surface_cases())))
def test_training_surface_rule_on_the_card_matches_the_cpu_without_a_sync(
        card, case):
    """Under sync debug (no host read): every output within 1e-5 of max(1,
    |cpu|), the index outputs exactly."""
    from paddle_tpu_torch.fluid.lowering import SeqValue
    op, ins, attrs, exact = _training_surface_cases()[case]
    _, want = _det_rule(op, ins, attrs, torch.device('cpu'))
    _, got = _det_rule(op, ins, attrs, card)
    for slot, w in want.items():
        if w is None:
            continue
        gt = got[slot]
        if isinstance(w, SeqValue):
            assert torch.equal(gt.lengths.cpu(), w.lengths), slot
            w, gt = w.data, gt.data
        if slot in exact or not w.is_floating_point():
            assert torch.equal(gt.cpu(), w), (op, slot)
        else:
            scale = max(1.0, float(w.abs().max()))
            assert float((gt.cpu() - w).abs().max()) <= 1e-5 * scale, \
                (op, slot)


def test_nce_and_sampling_id_draw_afresh_in_each_replay(card):
    """nce and sampling_id captured in one CUDA graph: each replay draws
    new negatives and ids from the graph's generator, and the replay's Cost
    is nce_cost on the CPU at its negatives within 1e-5."""
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.ops_impl import sampled_ops
    g = torch.Generator().manual_seed(32)
    x, w, b = (torch.randn(16, 8, generator=g),
               torch.randn(300, 8, generator=g),
               torch.randn(300, 1, generator=g))
    label = torch.randint(0, 300, (16, 1), generator=g)
    probs = torch.full((64, 10), 0.1, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    ctx = lowering.Ctx(card, gen)
    ins = {'Input': [x.to(card)], 'Label': [label.to(card)],
           'Weight': [w.to(card)], 'Bias': [b.to(card)]}
    attrs = {'num_total_classes': 300, 'num_neg_samples': 7}
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = lowering.get_rule('nce')(ins, attrs, ctx)
        ids = lowering.get_rule('sampling_id')(
            {'X': [probs]}, {}, ctx)['Out']
    draws = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        labels = out['SampleLabels'].cpu()
        neg = labels[0, 1:]
        assert (labels[:, 1:] == neg).all()
        cost = sampled_ops.nce_cost(x, label, w, b, neg, 300)[0]
        assert float((out['Cost'].cpu() - cost).abs().max()) <= 1e-5 * max(
            1.0, float(cost.abs().max()))
        draws.append((neg.clone(), ids.cpu().clone()))
    assert not torch.equal(draws[0][0], draws[1][0])
    assert not torch.equal(draws[0][1], draws[1][1])


@pytest.mark.parametrize('size', [(2, 1, 3, 1), (1, 2, 1, 3), (5, 4, 1, 1),
                                  (1, 1, 4, 4), (7, 5, 1, 9)])
def test_bilinear_resize_to_a_dim_of_1_card_against_cpu(card, size):
    """The width-1 fault's shapes: forward and VJP within 1e-5."""
    from paddle_tpu_torch.fluid.ops_impl.nn_ops import _resize
    h, w, oh, ow = size
    g = torch.Generator().manual_seed(33)
    x = torch.randn(3, 4, h, w, generator=g)
    cot = torch.randn(3, 4, oh, ow, generator=g)
    res = []
    for dev in (torch.device('cpu'), card):
        xi = x.to(dev).requires_grad_()
        y = _resize(xi, oh, ow, 'bilinear')
        gx, = torch.autograd.grad((y * cot.to(dev)).sum(), xi)
        res.append((y.detach().cpu(), gx.cpu()))
    for a, b in zip(res[0], res[1]):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0,
                                                       float(a.abs().max()))


def _dp_net():
    from paddle_tpu_torch import fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[16], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        h = fluid.layers.fc(input=x, size=128, act='relu')
        pred = fluid.layers.fc(input=h, size=1)
        cost = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(cost)
    return main, startup, cost


@pytest.mark.parametrize('way', ['set_mesh', 'parallel_executor', 'reduce'])
def test_one_rank_nccl_step_captured_equals_the_plain_step(card, way):
    """A one-rank NCCL group (parallel.init_distributed): a data-parallel
    step (set_mesh({'dp': 1}), ParallelExecutor(use_cuda=True), and with
    BuildStrategy.Reduce) captured on the card gives the plain Executor's
    losses and parameters bitwise over 4 steps (a one-rank average
    multiplies by 1.0), and its replay holds an NCCL kernel."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import fluid, parallel
    joined = not dist.is_initialized()
    parallel.init_distributed()
    try:
        rng = np.random.RandomState(0)
        feeds = [{'x': rng.rand(16, 16).astype('float32'),
                  'y': rng.rand(16, 1).astype('float32')} for _ in range(4)]
        main, startup, cost = _dp_net()
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        init = scope.to_numpy()
        plain = [exe.run(main, feed=f, fetch_list=[cost], scope=scope)[0]
                 for f in feeds]
        want = scope.to_numpy([p.name for p in main.all_parameters()])
        main, _, cost = _dp_net()
        scope = fluid.Scope()
        scope.load_numpy(init, fluid.CUDAPlace(0))
        if way == 'set_mesh':
            main.set_mesh({'dp': 1})
            exe = fluid.Executor()

            def step(f):
                return exe.run(main, feed=f, fetch_list=[cost],
                               scope=scope)[0]
        else:
            bs = fluid.BuildStrategy()
            if way == 'reduce':
                bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
            pe = fluid.ParallelExecutor(use_cuda=True, loss_name=cost.name,
                                        main_program=main, scope=scope,
                                        build_strategy=bs)
            exe = pe._exe

            def step(f):
                return pe.run([cost.name], feed=f)[0]
        got = [step(f) for f in feeds]
        assert exe.cache_stats['captures'] == 1
        assert exe.cache_stats['replays'] == 3
        state = {n: v.detach().cpu().numpy()
                 for n, v in parallel.full_state(main, scope).items()}
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a, b)
        for n, w in want.items():
            np.testing.assert_array_equal(state[n], w)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(feeds[0])
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any('nccl' in n.lower() or 'onerank' in n.lower()
                   for n in names), sorted(set(names))
    finally:
        if joined:
            dist.destroy_process_group()


def test_one_rank_nccl_helpers_and_local_sgd_place_on_the_card(card):
    """On a one-rank NCCL group the sharding helpers and LocalSGD put numpy
    inputs on the card, and LocalSGD's step and sync run there: its copy
    after 2 local steps and one sync equals the plain update."""
    import torch.distributed as dist
    from paddle_tpu_torch import parallel
    joined = not dist.is_initialized()
    parallel.init_distributed()
    try:
        mesh = parallel.make_mesh({'dp': 1})
        dev = torch.device('cuda', torch.cuda.current_device())
        assert parallel.mesh_device(mesh) == dev
        rng = np.random.RandomState(0)
        w = rng.rand(8, 128).astype('float32')
        vals = {'w': w, 'b': rng.rand(8).astype('float32')}
        placed = [parallel.shard_batch(mesh, w), parallel.replicate(mesh, w)]
        for fn in (parallel.shard_optimizer_states,
                   parallel.fsdp_shard_params):
            placed.extend(fn(vals, mesh).values())
        placed.extend(parallel.shard_params_by_rules(
            vals, mesh, [('w', parallel.P('dp', None))]).values())
        for t in placed:
            assert t.device == dev
        np.testing.assert_array_equal(placed[0].cpu().numpy(), w)

        def step_fn(params, batch):
            x, y = batch
            assert x.device == dev and params['w'].device == dev
            g = 2.0 * x.t() @ (x @ params['w'] - y) / x.shape[0]
            return {'w': params['w'] - 0.1 * g}, None

        xs = rng.rand(2, 16, 4).astype('float32')
        ys = rng.rand(2, 16, 1).astype('float32')
        w0 = rng.rand(4, 1).astype('float32')
        ls = parallel.LocalSGD(step_fn, mesh, axis='dp', sync_steps=2)
        params = ls.replicate({'w': w0})
        assert params['w'].device == dev
        for i in range(2):
            batch = ls.shard_batch((xs[i], ys[i]))
            assert all(t.device == dev for t in batch)
            params, _ = ls.step(params, batch)
        params = ls.sync(params)
        assert params['w'].device == dev
        want = torch.as_tensor(w0, device=dev)
        for i in range(2):
            x = torch.as_tensor(xs[i], device=dev)
            y = torch.as_tensor(ys[i], device=dev)
            want = want - 0.1 * (2.0 * x.t() @ (x @ want - y) / 16)
        np.testing.assert_array_equal(ls.collapse(params)['w'],
                                      want.cpu().numpy())
    finally:
        if joined:
            dist.destroy_process_group()
