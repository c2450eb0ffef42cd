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


def _tf32(x):
    """fp32 -> TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties away from
    zero, 10 explicit mantissa bits. The int32 view holds sign and
    magnitude apart, so adding half of the dropped 13 bits' unit and
    clearing them rounds the magnitude half up, whatever the sign."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1fff).view(torch.float32)


def _tf32_toward_zero(x):
    """fp32 -> TF32 as the tensor core reads an fp32 register given as a
    .tf32 operand: the 13 low bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1fff).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the attention kernels compute it: each fp32 operand split
    into big = tf32(x) and small = x - big, which the tensor core reads
    rounded toward zero; the three products small.big + big.small +
    big.big summed in fp32, small terms first."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32_toward_zero(a - ab), _tf32_toward_zero(b - bb)
    return (torch.matmul(as_, bb) + torch.matmul(ab, bs)) \
        + torch.matmul(ab, bb)


def _mm_1xtf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _bwd_with(mm, q, k, v, kb, do, lse, delta, causal, scale):
    """The backward kernels' function with every tile product through mm:
    s = (q.k^T) * scale + bias, causal positions set to NEG_BIG, P =
    exp(s - lse), dS' = P (dO.V^T - delta); dQ, dK, dV."""
    s = mm(q, k.transpose(-1, -2)) * scale + kb[:, None, None, :]
    if causal:
        Tq, Tk = s.shape[-2:]
        visible = torch.arange(Tq)[:, None] >= torch.arange(Tk)[None, :]
        s = torch.where(visible, s, torch.full_like(s, tfa.NEG_BIG))
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None])
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), do))


def test_tf32_emulation_rounds_as_the_kernels_do():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 3.0, -0.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0,
                                 -0.0]
    assert _tf32_toward_zero(x).tolist() == [1.0, -1.0, 1.0, 1.0, 3.0, -0.0]


@pytest.mark.parametrize('causal', [False, True])
def test_3xtf32_products_keep_the_backward_within_tolerance(causal):
    """The numerical design of csrc/flash_attention_bwd.cu on the CPU: dQ,
    dK and dV with every tile product in 3xTF32 lie within the kernels'
    3e-4 of a float64 reference, and with plain (1xTF32) products they do
    not: the split is what keeps fp32 accuracy. B=1, H=2, T=256, D=64,
    randn inputs, 30% of the keys padded (key 0 live); lse and delta as
    the forward and the wrapper hand them over, in fp32."""
    B, H, T, D = 1, 2, 256, 64
    r = np.random.RandomState(7)
    q, k, v, do = [torch.from_numpy(r.randn(B, H, T, D).astype('float32'))
                   for _ in range(4)]
    kb = np.where(r.rand(B, T) < 0.3, -1e9, 0.0).astype('float32')
    kb[:, 0] = 0.0
    kb = torch.from_numpy(kb)
    dlse = torch.from_numpy(r.randn(B, H, T).astype('float32'))
    scale = D ** -0.5
    o, lse = tfa.flash_attention_lse_plain(q, k, v, kb, causal, scale)
    delta = (do * o).sum(-1) - dlse
    args = (q, k, v, kb, do, lse, delta)
    ref = _bwd_with(torch.matmul, *[t.double() for t in args], causal, scale)

    def within(got):
        return all(bool(((g.double() - w).abs()
                         <= TOL + TOL * w.abs()).all())
                   for g, w in zip(got, ref))

    assert within(_bwd_with(_mm_3xtf32, *args, causal, scale))
    assert not within(_bwd_with(_mm_1xtf32, *args, causal, scale))


def _fwd_with(mm, q, k, v, kb, causal, scale):
    """The forward kernel's function with both tile products through mm:
    s = (q * scale).k^T + bias, causal positions set to NEG_BIG, one
    softmax over all keys; (O, lse)."""
    s = mm(q * scale, k.transpose(-1, -2)) + kb[:, None, None, :]
    if causal:
        Tq, Tk = s.shape[-2:]
        visible = torch.arange(Tq)[:, None] >= torch.arange(Tk)[None, :]
        s = torch.where(visible, s, torch.full_like(s, tfa.NEG_BIG))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize('causal', [False, True])
def test_3xtf32_products_keep_the_forward_within_tolerance(causal):
    """The numerical design of csrc/flash_attention_fwd.cu on the CPU: O
    and lse with both tile products (s and P.V) in 3xTF32 lie within the
    card's 1e-4 (chip_smoke.KERNEL_TOL) of a float64 reference, and with
    plain (1xTF32) products they do not. B=1, H=2, T=256, D=64, randn
    inputs, 30% of the keys padded (key 0 live)."""
    B, H, T, D = 1, 2, 256, 64
    r = np.random.RandomState(7)
    q, k, v = [torch.from_numpy(r.randn(B, H, T, D).astype('float32'))
               for _ in range(3)]
    kb = np.where(r.rand(B, T) < 0.3, -1e9, 0.0).astype('float32')
    kb[:, 0] = 0.0
    kb = torch.from_numpy(kb)
    scale = D ** -0.5
    ref = _fwd_with(torch.matmul, *[t.double() for t in (q, k, v, kb)],
                    causal, scale)

    def within(got):
        return all(bool(((g.double() - w).abs()
                         <= 1e-4 + 1e-4 * w.abs()).all())
                   for g, w in zip(got, ref))

    assert within(_fwd_with(_mm_3xtf32, q, k, v, kb, causal, scale))
    assert not within(_fwd_with(_mm_1xtf32, q, k, v, kb, causal, scale))


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
