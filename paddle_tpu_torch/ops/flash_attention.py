"""Flash attention, forward: a hand-written CUDA kernel for Hopper beside its
plain torch version.

Parity: the JAX package's ops/flash_attention.py (flash_attention,
flash_attention_lse), forward only. The TPU kernel it replaces is
`_fwd_call` (its rectangular and causal-triangle Pallas grids); the CUDA
source and its design note are paddle_tpu_torch/csrc/flash_attention_fwd.cu.

Dispatch is by the device of the tensors, with no fallback and no switch:
  * CUDA tensors -> the kernel (built at first use), or an exception;
  * CPU or meta tensors -> the plain torch version (meta is what build-time
    shape inference passes).

Rows whose every key is masked (key_bias -1e9 on every visible key) give
ill-conditioned outputs in every implementation, the JAX kernel and its
oracle included; real pad masks never build them (a sequence's first key
is live).
"""
import ctypes

import torch

from ._cuda import CudaKernel

__all__ = ['flash_attention', 'flash_attention_lse',
           'flash_attention_lse_plain', 'KERNEL']

NEG_BIG = -1e9   # finite causal mask value, as in the TPU kernel

KERNEL = CudaKernel(
    name='flash_attention_fwd',
    source='csrc/flash_attention_fwd.cu',
    entry='flash_attention_fwd',
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    # _fwd_call; its pallas_calls are at :342 (rectangular grid) and :328
    # (causal triangle)
    replaces='paddle_tpu/ops/flash_attention.py:311')

MAX_HEAD_DIM = 128


def _key_bias(key_bias, B, Tk, device):
    if key_bias is None:
        return torch.zeros((B, Tk), dtype=torch.float32, device=device)
    return key_bias.reshape(B, Tk).to(torch.float32)


def flash_attention_lse_plain(q, k, v, key_bias=None, causal=False,
                              sm_scale=None):
    """The kernel's arithmetic in plain torch: scale on q first, additive
    key bias, causal positions SET to NEG_BIG, one softmax over all keys.
    Returns (O [B,H,Tq,D] in q's dtype, lse [B,H,Tq] fp32)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = D ** -0.5 if sm_scale is None else float(sm_scale)
    kb = _key_bias(key_bias, B, Tk, q.device)
    s = torch.matmul(q.to(torch.float32) * scale,
                     k.to(torch.float32).transpose(-1, -2))
    s = s + kb[:, None, None, :]
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_BIG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.to(torch.float32)) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _check(q, k, v, kb):
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.dtype != torch.float32:
            raise TypeError('flash_attention kernel: %s must be float32, '
                            'got %s' % (name, t.dtype))
        if t.dim() != 4:
            raise ValueError('flash_attention kernel: %s must be '
                             '[B, H, T, D], got %s' % (name, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('flash_attention kernel: %s must be '
                             'contiguous' % name)
        if t.device != q.device:
            raise ValueError('flash_attention kernel: %s is on %s, q on %s'
                             % (name, t.device, q.device))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != (B, H, Tk, D):
        raise ValueError('flash_attention kernel: k %s / v %s do not match '
                         'q %s' % (tuple(k.shape), tuple(v.shape),
                                   tuple(q.shape)))
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError('flash_attention kernel: head dim %d outside '
                         '(0, %d]' % (D, MAX_HEAD_DIM))
    if Tk == 0 or B > 65535 or H > 65535:
        raise ValueError('flash_attention kernel: unsupported shape q %s '
                         'k %s' % (tuple(q.shape), tuple(k.shape)))
    if kb.shape != (B, Tk) or not kb.is_contiguous() \
            or kb.device != q.device:
        raise ValueError('flash_attention kernel: key bias must be a '
                         'contiguous [B, Tk] tensor on %s' % q.device)


def _flash_lse_cuda(q, k, v, key_bias, causal, sm_scale):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = D ** -0.5 if sm_scale is None else float(sm_scale)
    kb = _key_bias(key_bias, B, Tk, q.device).contiguous()
    _check(q, k, v, kb)
    o = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if Tq == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D, scale,
                  int(bool(causal)), stream)
    return o, lse


def flash_attention_lse(q, k, v, key_bias=None, causal=False, sm_scale=None):
    """Flash attention over [B, H, T, D] tensors that ALSO returns the
    per-query logsumexp [B, H, Tq] (fp32) — the statistic the backward and
    ring attention consume.

    key_bias: optional additive [B, Tk] bias (e.g. -1e9 on padded keys).
    causal:   lower-triangular masking (decoder self-attention).
    sm_scale: softmax scale, default D ** -0.5."""
    if q.is_cuda:
        return _flash_lse_cuda(q, k, v, key_bias, causal, sm_scale)
    return flash_attention_lse_plain(q, k, v, key_bias, causal, sm_scale)


def flash_attention(q, k, v, key_bias=None, causal=False, sm_scale=None):
    """Flash attention over [B, H, T, D] tensors; returns [B, H, Tq, D]."""
    return flash_attention_lse(q, k, v, key_bias=key_bias, causal=causal,
                               sm_scale=sm_scale)[0]

