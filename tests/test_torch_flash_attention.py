"""The PyTorch port's flash attention (paddle_tpu_torch.ops) against the JAX
package's Pallas kernel (interpret mode on the CPU) and its XLA oracle.

On the CPU the port's wrapper runs its plain torch version — the CUDA
kernel's arithmetic (scale on q, additive key bias, causal positions set
to -1e9, one softmax) — so these tests pin the function the kernel must
compute to the TPU kernel's, at fp32 tolerance 2e-5 (different summation
orders), as tests/test_flash_attention.py does for the TPU kernel. Rows
whose every key is masked are excluded (paddle_tpu/ops/flash_attention.py
module docstring: ill-conditioned in every implementation)."""
import importlib

import numpy as np
import pytest
import torch

from paddle_tpu import ops as jops

# the module, not the function of the same name that ops/__init__ exports
tfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')

TOL = 2e-5


def _inputs(B=2, H=2, Tq=20, Tk=20, D=16, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(B, H, Tq, D).astype('float32')
    k = r.randn(B, H, Tk, D).astype('float32')
    v = r.randn(B, H, Tk, D).astype('float32')
    kb = np.where(r.rand(B, Tk) < 0.25, -1e9, 0.0).astype('float32')
    return q, k, v, kb


def _live_rows(kb, Tq, causal):
    """[B, 1, Tq] True where the query row sees at least one unmasked key."""
    Tk = kb.shape[1]
    visible = np.ones((Tq, Tk), bool)
    if causal:
        visible = np.arange(Tq)[:, None] >= np.arange(Tk)[None, :]
    live = (kb > -1e8)[:, None, :] & visible[None]
    return live.any(-1)[:, None, :]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


SHAPES = [(8, 8), (20, 20), (8, 20), (20, 8)]


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('Tq,Tk', SHAPES)
def test_lse_matches_pallas_kernel(Tq, Tk, causal):
    q, k, v, kb = _inputs(Tq=Tq, Tk=Tk, seed=Tq * 31 + Tk)
    o_j, lse_j = jops.flash_attention_lse(q, k, v, key_bias=kb,
                                          causal=causal, interpret=True)
    o_t, lse_t = tfa.flash_attention_lse(*_torch(q, k, v, kb),
                                         causal=causal)
    live = _live_rows(kb, Tq, causal)
    assert live.any()
    np.testing.assert_allclose(
        np.where(live[..., None], o_t.numpy(), 0),
        np.where(live[..., None], np.asarray(o_j), 0), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.where(live, lse_t.numpy(), 0),
                               np.where(live, np.asarray(lse_j), 0),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('with_bias', [False, True])
def test_forward_matches_pallas_and_oracle(causal, with_bias):
    q, k, v, kb = _inputs(Tq=20, Tk=20, seed=3)
    kb[:, 0] = 0.0      # one live key per row, as real pad masks have
    bias = kb if with_bias else None
    got = tfa.flash_attention(*_torch(q, k, v),
                              key_bias=None if bias is None
                              else torch.from_numpy(bias),
                              causal=causal, sm_scale=0.3)
    kern = jops.flash_attention(q, k, v, key_bias=bias, causal=causal,
                                sm_scale=0.3, interpret=True)
    oracle = jops.reference_attention(q, k, v, key_bias=bias,
                                      causal=causal, sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v, kb = _torch(*_inputs(Tq=8, Tk=12))
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_attention_lse(q, k, v, key_bias=kb, causal=True)
    o_p, lse_p = tfa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                               causal=True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert tfa.KERNEL.launches == before


def test_meta_tensors_give_shapes_for_build_time_inference():
    q = torch.empty((5, 2, 7, 16), device='meta')
    k = torch.empty((5, 2, 9, 16), device='meta')
    kb = torch.empty((5, 9), device='meta')
    o, lse = tfa.flash_attention_lse(q, k, k, key_bias=kb)
    assert o.shape == (5, 2, 7, 16) and lse.shape == (5, 2, 7)
    assert o.device.type == 'meta'


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, kb = _torch(*_inputs(Tq=8, Tk=8))
    with pytest.raises(TypeError):
        tfa._check(q.double(), k, v, kb)
    with pytest.raises(ValueError, match='contiguous'):
        tfa._check(q.transpose(2, 3), k, v, kb)
    with pytest.raises(ValueError, match='do not match'):
        tfa._check(q, k[:, :, :4].contiguous(), v, kb)
    with pytest.raises(ValueError, match='head dim'):
        big = torch.zeros((1, 1, 4, 256))
        tfa._check(big, big, big, torch.zeros((1, 4)))
    with pytest.raises(ValueError, match='key bias'):
        tfa._check(q, k, v, kb[:, :4])
