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
import importlib.util
import os

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


# the head dims the card tests give the CUDA kernel: D 6 and 20 take its
# 4-byte copies (D not a multiple of 4), D 20 and 40 pad the summation over
# d to 32 and 64, D 128 splits q at each use
@pytest.mark.parametrize('D', [6, 20, 40, 128])
@pytest.mark.parametrize('Tq,Tk,causal', [(20, 20, True), (12, 30, True),
                                          (30, 12, True), (20, 33, False)])
def test_lse_matches_pallas_kernel_at_the_card_tests_head_dims(D, Tq, Tk,
                                                                causal):
    q, k, v, kb = _inputs(Tq=Tq, Tk=Tk, D=D, seed=D * 7 + Tq + Tk)
    o_j, lse_j = jops.flash_attention_lse(q, k, v, key_bias=kb,
                                          causal=causal, interpret=True)
    o_t, lse_t = tfa.flash_attention_lse_plain(*_torch(q, k, v, kb),
                                               causal=causal)
    live = _live_rows(kb, Tq, causal)
    assert live.any()
    np.testing.assert_allclose(
        np.where(live[..., None], o_t.numpy(), 0),
        np.where(live[..., None], np.asarray(o_j), 0), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.where(live, lse_t.numpy(), 0),
                               np.where(live, np.asarray(lse_j), 0),
                               rtol=TOL, atol=TOL)


def _chip_smoke():
    """chip_smoke.py as a module (it imports only numpy at its top)."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_counts_the_forward_at_the_3xtf32_rate():
    """The forward runs both products in 3xTF32 on the tensor cores, so its
    least time counts 4 * B * H * D * pairs FLOPs at 495 / 3 TFLOP/s, not
    at the 67 TFLOP/s of fp32 FFMA: encoder self-attention at B=16, H=8,
    T=256, D=64 takes 2.147e9 FLOPs, 0.0130 ms."""
    cs = _chip_smoke()
    ms, by = cs._attention_bound(16, 8, 256, 256, 64, False)
    flops = 4.0 * 16 * 8 * 256 * 256 * 64
    assert by == 'operations'
    assert ms == pytest.approx(flops / (495e12 / 3) * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.0130, abs=5e-5)
    # the causal triangles do about half the work, and at this rate their
    # bytes (q, k, v, O, bias, lse) bound them
    for T in (256, 200):
        causal_ms, causal_by = cs._attention_bound(16, 8, T, T, 64, True)
        nbytes = 4.0 * (16 * 8 * T * 64 * 4 + 16 * T + 16 * 8 * T)
        assert causal_by == 'bytes'
        assert causal_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
        assert causal_ms > 4.0 * 16 * 8 * 64 * T * (T + 1) / 2 / 165e12 * 1e3
    assert cs.TF32X3_OPS_RATE == '3xTF32: 495 / 3 TFLOP/s'


def test_chip_smoke_counts_the_bf16_backward_sass():
    """chip_smoke's build check reads cuobjdump -sass: per bf16 kernel (the
    forward and the backward pair), the count of each checked opcode
    (predicated instructions too), other functions left out: the fp32
    forward `fwd_kernel`, which shares the bf16 forward's library and runs
    mma.sync by design, is not counted."""
    cs = _chip_smoke()
    sass = '''
	code for sm_90a
		Function : _ZN12_GLOBAL__N_118bwd_dq_bf16_kernelILi64EEEvPKf
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0020*/              @!P0 HGMMA.64x32x16.F32.BF16 R88, gdesc[UR8], R88 ;
        /*0030*/                   LDS.U16 R3, [R2] ;
        /*0040*/                   LDS R4, [R2+0x4] ;
		..........
		Function : _ZN12_GLOBAL__N_110fwd_kernelILi64ELi2EEEvPKfS2_S2_S2_Pfi
        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
		Function : _ZN12_GLOBAL__N_115fwd_bf16_kernelILi64EEEv14CUtensorMap_st
        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, R120, gdesc[UR8], R24 ;
        /*0020*/              @P1 SYNCS.ARRIVE.TRANS64.A1T0 RZ, [UR5], RZ ;
		Function : _ZN12_GLOBAL__N_119bwd_dkv_bf16_kernelILi64EEEvPKf
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   REDG.E.ADD.F32.FTZ.RN.STRONG.GPU [R2], R5 ;
        /*0020*/                   ATOMS.ADD R6, [R7], R8 ;
'''
    names = [n for fns in cs.SASS_BF16.values() for n in fns]
    assert sorted(names) == ['bwd_dkv_bf16_kernel', 'bwd_dq_bf16_kernel',
                             'fwd_bf16_kernel']
    counts = cs.sass_counts(sass, names)
    zero = dict.fromkeys(cs.SASS_COUNTED, 0)
    assert counts == {
        '_ZN12_GLOBAL__N_118bwd_dq_bf16_kernelILi64EEEvPKf':
            dict(zero, HGMMA=2, **{'LDS.U16': 1}),
        '_ZN12_GLOBAL__N_115fwd_bf16_kernelILi64EEEv14CUtensorMap_st':
            dict(zero, HGMMA=2),
        '_ZN12_GLOBAL__N_119bwd_dkv_bf16_kernelILi64EEEvPKf':
            dict(zero, HMMA=1, REDG=1, ATOMS=1)}
    # each library's check reads its own functions: the forward's library
    # holds fwd_kernel and fwd_bf16_kernel, and only the second counts
    fwd = cs.sass_counts(sass, cs.SASS_BF16['KERNEL_BF16'])
    assert list(fwd) == [
        '_ZN12_GLOBAL__N_115fwd_bf16_kernelILi64EEEv14CUtensorMap_st']
