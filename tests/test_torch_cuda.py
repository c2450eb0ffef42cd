"""The PyTorch port's CUDA kernels on the card, against their plain torch
versions. A CUDA kernel has no interpret mode, so these tests need a card:
they carry the `cuda` marker and skip without one. On a machine with a
card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(the conftest only sets JAX up; these tests import no JAX).

Tolerance 1e-4 in fp32: the kernel sums in tile order with an online
softmax, the plain version in one product and one softmax.
"""
import importlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

tfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
TOL = 1e-4


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
