"""The gradient of the PyTorch port's flash attention against jax.grad of the
JAX package's Pallas kernel (interpret mode on the CPU).

On the CPU the port's autograd Function runs the plain versions of both
kernels: flash_attention_lse_plain forward, flash_attention_bwd_plain
backward, which repeats the CUDA backward kernels' arithmetic (P recomputed
from the saved lse, delta = rowsum(dO * O) - dlse). These tests pin that
arithmetic to the TPU kernels' at 3e-4, the tolerance of
tests/test_flash_attention.py for the Pallas backward (fp32, different
summation orders, and the TPU kernel scales s after the product where the
port scales q before it). The losses weigh both outputs, O and lse, so the
lse cotangent is exercised. Rows whose every key is masked are excluded by
giving them zero cotangents (paddle_tpu/ops/flash_attention.py module
docstring: ill-conditioned in every implementation)."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import ops as jops

tfa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')

TOL = 3e-4


def _inputs(B, H, Tq, Tk, D, seed, dead_rows=False):
    r = np.random.RandomState(seed)
    q = r.randn(B, H, Tq, D).astype('float32')
    k = r.randn(B, H, Tk, D).astype('float32')
    v = r.randn(B, H, Tk, D).astype('float32')
    kb = np.where(r.rand(B, Tk) < 0.3, -1e9, 0.0).astype('float32')
    if dead_rows:
        kb[0, :] = -1e9          # batch row 0: every key masked
        kb[1, 0] = 0.0
    else:
        kb[:, 0] = 0.0           # key 0 live, as real pad masks have
    wo = r.randn(B, H, Tq, D).astype('float32')
    wl = r.randn(B, H, Tq).astype('float32')
    return q, k, v, kb, wo, wl


def _live(kb, Tq, causal):
    """[B, 1, Tq] True where the query row sees at least one live key."""
    Tk = kb.shape[1]
    visible = np.ones((Tq, Tk), bool)
    if causal:
        visible = np.arange(Tq)[:, None] >= np.arange(Tk)[None, :]
    return ((kb > -1e8)[:, None, :] & visible[None]).any(-1)[:, None, :]


def _jax_grads(q, k, v, kb, wo, wl, causal, sm_scale=None):
    def loss(q, k, v):
        o, lse = jops.flash_attention_lse(q, k, v, key_bias=kb,
                                          causal=causal, sm_scale=sm_scale,
                                          interpret=True)
        return jnp.sum(o * wo) + jnp.sum(lse * wl)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, kb, wo, wl, causal, sm_scale=None):
    qt, kt, vt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tfa.flash_attention_lse(qt, kt, vt,
                                     key_bias=torch.from_numpy(kb),
                                     causal=causal, sm_scale=sm_scale)
    loss = (o * torch.from_numpy(wo)).sum() + (lse * torch.from_numpy(wl)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, [qt, kt, vt])]


CASES = [(16, 16), (20, 20), (8, 20), (20, 8), (70, 70)]


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('Tq,Tk', CASES)
def test_autograd_matches_jax_grad_of_the_pallas_kernel(Tq, Tk, causal):
    """Causal and not, Tq != Tk, ragged T (20, 70: neither a multiple of a
    kernel tile), with the lse in the loss."""
    q, k, v, kb, wo, wl = _inputs(2, 2, Tq, Tk, 16, seed=Tq * 7 + Tk)
    want = _jax_grads(q, k, v, kb, wo, wl, causal)
    got = _port_grads(q, k, v, kb, wo, wl, causal)
    for name, g, w in zip('qkv', got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize('causal', [False, True])
def test_rows_with_every_key_masked_are_excluded(causal):
    q, k, v, kb, wo, wl = _inputs(2, 2, 12, 12, 8, seed=5, dead_rows=True)
    live = _live(kb, 12, causal)
    assert not live.all() and live.any()
    wo = np.where(live[..., None], wo, 0).astype('float32')
    wl = np.where(live, wl, 0).astype('float32')
    want = _jax_grads(q, k, v, kb, wo, wl, causal)
    got = _port_grads(q, k, v, kb, wo, wl, causal)
    np.testing.assert_allclose(np.where(live[..., None], got[0], 0),
                               np.where(live[..., None], want[0], 0),
                               rtol=TOL, atol=TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_bwd_plain_with_an_explicit_lse_cotangent(causal):
    """flash_attention_bwd_plain called as the wrapper calls the kernels:
    delta = rowsum(dO * O) - dlse from the forward's own O and lse."""
    B, H, Tq, Tk, D = 2, 3, 13, 13, 8
    q, k, v, kb, wo, wl = _inputs(B, H, Tq, Tk, D, seed=11)
    want = _jax_grads(q, k, v, kb, wo, wl, causal, sm_scale=0.3)
    qt, kt, vt, kbt, do, dlse = map(torch.from_numpy, (q, k, v, kb, wo, wl))
    o, lse = tfa.flash_attention_lse_plain(qt, kt, vt, kbt, causal, 0.3)
    delta = (do * o).sum(-1) - dlse
    got = tfa.flash_attention_bwd_plain(qt, kt, vt, kbt, do, lse, delta,
                                        causal, 0.3)
    for name, g, w in zip('qkv', got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)
    dq = tfa.flash_attention_bwd_dq_plain(qt, kt, vt, kbt, do, lse, delta,
                                          causal, 0.3)
    dk, dv = tfa.flash_attention_bwd_dkv_plain(qt, kt, vt, kbt, do, lse,
                                               delta, causal, 0.3)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)


def test_flash_attention_gradient_is_the_classic_one():
    """flash_attention (O only) through the same Function: the lse gets no
    cotangent, and the gradient equals jax.grad of the Pallas kernel's O."""
    q, k, v, kb, wo, _ = _inputs(2, 2, 10, 10, 8, seed=2)

    def jloss(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, key_bias=kb,
                                            causal=True, interpret=True) * wo)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(qt, kt, vt, key_bias=torch.from_numpy(kb),
                              causal=True)
    got = torch.autograd.grad((out * torch.from_numpy(wo)).sum(),
                              [qt, kt, vt])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_key_bias_gets_no_gradient_and_cpu_backward_launches_nothing():
    q, k, v, kb, wo, wl = _inputs(1, 2, 9, 9, 8, seed=4)
    qt, kt, vt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    kbt = torch.from_numpy(kb).requires_grad_()
    before = {n: kern.launches for n, kern in
              (('fwd', tfa.KERNEL), ('dq', tfa.KERNEL_BWD_DQ),
               ('dkv', tfa.KERNEL_BWD_DKV))}
    o, lse = tfa.flash_attention_lse(qt, kt, vt, key_bias=kbt)
    (o.sum() + lse.sum()).backward()
    assert kbt.grad is None
    assert all(g is not None for g in (qt.grad, kt.grad, vt.grad))
    assert tfa.KERNEL.launches == before['fwd']
    assert tfa.KERNEL_BWD_DQ.launches == before['dq']
    assert tfa.KERNEL_BWD_DKV.launches == before['dkv']


def test_backward_wrapper_rejects_what_the_kernels_do_not_take():
    q = torch.zeros((1, 2, 4, 8))
    lse = torch.zeros((1, 2, 4))
    tfa._check_bwd(q, q, lse, lse)
    with pytest.raises(ValueError, match='dO'):
        tfa._check_bwd(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                       lse, lse)
    with pytest.raises(ValueError, match='lse'):
        tfa._check_bwd(q, q, lse[:, :, :3], lse)
    with pytest.raises(ValueError, match='delta'):
        tfa._check_bwd(q, q, lse, lse.double())


def test_backward_entry_points_share_one_library_build():
    """Both backward kernels bind from one build of one source, so building
    every kernel starts one nvcc per source and no two write the same
    file."""
    from paddle_tpu_torch.ops import _cuda
    assert tfa.KERNEL_BWD_DQ.library is tfa.KERNEL_BWD_DKV.library
    assert tfa.KERNEL.library is not tfa.KERNEL_BWD_DQ.library
    assert {k.library for k in _cuda.KERNELS.values()} == \
        set(_cuda._LIBRARIES.values())
    paths = {k.library.library_path() for k in _cuda.KERNELS.values()}
    assert sorted(p.rsplit('/', 1)[1].rsplit('-', 1)[0] for p in paths) == \
        ['libflash_attention_bwd', 'libflash_attention_fwd',
         'libpaged_attention', 'libsparse_optim']
