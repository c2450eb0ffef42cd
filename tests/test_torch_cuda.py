"""The PyTorch port's CUDA kernels on the card, against their plain torch
versions. A CUDA kernel has no interpret mode, so these tests need a card:
they carry the `cuda` marker and skip without one. On a machine with a
card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(the conftest only sets JAX up; these tests import no JAX).

Tolerance 1e-4 in fp32 for the forward: the kernel sums in tile order with
an online softmax, the plain version in one product and one softmax. 3e-4
for the backward kernels, the Pallas backward's own tolerance
(tests/test_flash_attention.py:64).
"""
import importlib
import os

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


@pytest.mark.parametrize('D', [16, 40, 64, 128])
@pytest.mark.parametrize('Tq,Tk,causal', [(64, 64, False), (64, 64, True),
                                          (100, 37, False), (130, 130, True),
                                          (1, 70, False)])
def test_flash_attention_kernel_matches_plain(card, D, Tq, Tk, causal):
    g = torch.Generator(device=card)
    g.manual_seed(Tq * 1000 + Tk + D)
    B, H = 2, 3
    q = torch.randn((B, H, Tq, D), generator=g, device=card)
    k = torch.randn((B, H, Tk, D), generator=g, device=card)
    v = torch.randn((B, H, Tk, D), generator=g, device=card)
    kb = torch.zeros((B, Tk), device=card)
    kb[0, Tk // 2:] = -1e9          # one padded sequence, key 0 live
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_attention_lse(q, k, v, key_bias=kb, causal=causal)
    torch.cuda.synchronize()
    assert tfa.KERNEL.launches == before + 1
    o_ref, lse_ref = tfa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                   causal=causal)
    torch.testing.assert_close(o, o_ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL, atol=TOL)


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


@pytest.mark.parametrize('D', [16, 40, 64, 128])
@pytest.mark.parametrize('Tq,Tk,causal', [(64, 64, False), (64, 64, True),
                                          (100, 37, False), (130, 130, True),
                                          (37, 100, True), (1, 70, False)])
def test_flash_attention_bwd_kernels_match_plain(card, D, Tq, Tk, causal):
    g = torch.Generator(device=card)
    g.manual_seed(Tq * 1000 + Tk + D + 7)
    B, H = 2, 3
    q, k, v = [torch.randn((B, H, T, D), generator=g, device=card)
               for T in (Tq, Tk, Tk)]
    kb = torch.zeros((B, Tk), device=card)
    kb[0, Tk // 2:] = -1e9          # one padded sequence, key 0 live
    o, lse = tfa.flash_attention_lse(q, k, v, key_bias=kb, causal=causal)
    do = torch.randn(o.shape, generator=g, device=card)
    dlse = torch.randn(lse.shape, generator=g, device=card)
    delta = ((do * o).sum(-1) - dlse).contiguous()
    before = (tfa.KERNEL_BWD_DQ.launches, tfa.KERNEL_BWD_DKV.launches)
    dq, dk, dv = tfa._flash_bwd_cuda(q, k, v, kb, do, lse, delta, causal,
                                     D ** -0.5)
    torch.cuda.synchronize()
    assert (tfa.KERNEL_BWD_DQ.launches, tfa.KERNEL_BWD_DKV.launches) == \
        (before[0] + 1, before[1] + 1)
    want = tfa.flash_attention_bwd_plain(q, k, v, kb, do, lse, delta,
                                         causal, D ** -0.5)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=BWD_TOL, atol=BWD_TOL)


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
    weights on the card and on the CPU: loss and every gradient, and 3
    launches of each attention kernel per layer pair and step."""
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
        want = 3 * 2 if isinstance(place, fluid.CUDAPlace) else 0
        assert launched == {n: want for n in launched}
    for got, ref in zip(outs['CUDAPlace'], outs['CPUPlace']):
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * scale)
