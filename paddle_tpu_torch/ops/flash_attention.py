"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper beside their plain torch versions, joined by one
torch.autograd.Function.

Parity: the JAX package's ops/flash_attention.py (flash_attention,
flash_attention_lse and their custom_vjp, _flash_lse_fwd/_flash_lse_bwd
:466-488). The TPU kernels replaced are `_fwd_call` (its rectangular and
causal-triangle Pallas grids), whose CUDA source and design note are
paddle_tpu_torch/csrc/flash_attention_fwd.cu, and `_bwd_call` /
`_bwd_call_tri` (the dQ and dK/dV grids, rectangular and triangular), whose
source is paddle_tpu_torch/csrc/flash_attention_bwd.cu.

Each kernel has two variants, built from the same source: fp32 (3xTF32
products) and bf16 (q, k, v, dO and the outputs O, dQ, dK, dV in bf16; lse,
delta and every accumulator fp32), which AMP's flash_attention rule feeds
(fluid/lowering.amp_cast), as the TPU kernel takes bf16 tiles. The dtype of
q, k and v decides the variant; there is no switch.

Dispatch is by the device of the tensors, with no fallback and no switch:
  * CUDA tensors -> the kernels (built at first use), or an exception;
  * CPU tensors -> the plain torch versions;
  * meta and fake tensors (build-time shape inference, torch.export's
    trace) -> the output shapes alone.
The forward is one torch operator, `torch.ops.paddle_tpu_torch.
flash_attention_lse(q, k, v, key_bias, causal, scale) -> (O, lse)`
(torch.library.custom_op): its CUDA implementation is the forward kernel,
its CPU implementation the plain version, and its fake implementation gives
O's and lse's shapes and dtypes. So torch.export keeps the operator in the
graph it writes (inference/export_compiled), and a loaded artifact launches
the same kernel that serving and training do. The backward kernels stay
ctypes launches inside the autograd.Function: an exported graph is for
inference.
Both directions go through _FlashAttentionLse, whose backward takes both
cotangents (dO and dlse) as _flash_lse_bwd does: the lse cotangent is folded
into delta = rowsum(dO * O) - dlse, in plain torch as in the JAX package,
so the backward kernels serve the lse output unchanged. The key bias is a
mask constant and gets no gradient.

Rows whose every key is masked (key_bias -1e9 on every visible key) give
ill-conditioned outputs and gradients in every implementation, the JAX
kernel and its oracle included; real pad masks never build them (a
sequence's first key is live).
"""
import ctypes

import torch

from ._cuda import CudaKernel

__all__ = ['flash_attention', 'flash_attention_lse',
           'flash_attention_lse_plain', 'flash_attention_bwd_plain',
           'flash_attention_bwd_dq_plain', 'flash_attention_bwd_dkv_plain',
           'KERNEL', 'KERNEL_BWD_DQ', 'KERNEL_BWD_DKV', 'KERNEL_BF16',
           'KERNEL_BWD_DQ_BF16', 'KERNEL_BWD_DKV_BF16']

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

# the backward: two entry points of one source (dQ, then dK/dV)
KERNEL_BWD_DQ = CudaKernel(
    name='flash_attention_bwd_dq',
    source='csrc/flash_attention_bwd.cu',
    entry='flash_attention_bwd_dq',
    argtypes=[ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    # _bwd_call's dQ pallas_call (_bwd_dq_kernel :200); its causal triangle
    # is _bwd_call_tri's at :370 (_bwd_dq_kernel_tri :209)
    replaces='paddle_tpu/ops/flash_attention.py:412')
KERNEL_BWD_DKV = CudaKernel(
    name='flash_attention_bwd_dkv',
    source='csrc/flash_attention_bwd.cu',
    entry='flash_attention_bwd_dkv',
    argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    # _bwd_call's dK/dV pallas_call (_bwd_dkv_kernel :258); its causal
    # triangle is _bwd_call_tri's at :384 (_bwd_dkv_kernel_tri :269)
    replaces='paddle_tpu/ops/flash_attention.py:430')

# the bf16 variants: the same C signatures, bf16 for q, k, v, dO, O and the
# gradients
KERNEL_BF16 = CudaKernel(
    name='flash_attention_fwd_bf16',
    source='csrc/flash_attention_fwd.cu',
    entry='flash_attention_fwd_bf16',
    argtypes=KERNEL.argtypes,
    replaces=KERNEL.replaces)
KERNEL_BWD_DQ_BF16 = CudaKernel(
    name='flash_attention_bwd_dq_bf16',
    source='csrc/flash_attention_bwd.cu',
    entry='flash_attention_bwd_dq_bf16',
    argtypes=KERNEL_BWD_DQ.argtypes,
    replaces=KERNEL_BWD_DQ.replaces)
KERNEL_BWD_DKV_BF16 = CudaKernel(
    name='flash_attention_bwd_dkv_bf16',
    source='csrc/flash_attention_bwd.cu',
    entry='flash_attention_bwd_dkv_bf16',
    argtypes=KERNEL_BWD_DKV.argtypes,
    replaces=KERNEL_BWD_DKV.replaces)

# (forward, dQ, dK/dV) kernels by the dtype of q, k and v
_VARIANTS = {
    torch.float32: (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV),
    torch.bfloat16: (KERNEL_BF16, KERNEL_BWD_DQ_BF16, KERNEL_BWD_DKV_BF16),
}

MAX_HEAD_DIM = 128


def _key_bias(key_bias, B, Tk, device):
    if key_bias is None:
        return torch.zeros((B, Tk), dtype=torch.float32, device=device)
    return key_bias.reshape(B, Tk).to(torch.float32)


def _scores(q, k, kb, causal, scale):
    """The kernels' scores: scale on q first, additive key bias, causal
    positions SET to NEG_BIG. fp32 [B, H, Tq, Tk]."""
    Tq, Tk = q.shape[2], k.shape[2]
    s = torch.matmul(q.to(torch.float32) * scale,
                     k.to(torch.float32).transpose(-1, -2))
    s = s + kb[:, None, None, :]
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_BIG))
    return s


def _scale_of(D, sm_scale):
    return D ** -0.5 if sm_scale is None else float(sm_scale)


def flash_attention_lse_plain(q, k, v, key_bias=None, causal=False,
                              sm_scale=None):
    """The forward kernel's arithmetic in plain torch: one softmax over all
    keys. Returns (O [B,H,Tq,D] in q's dtype, lse [B,H,Tq] fp32)."""
    B, H, Tq, D = q.shape
    kb = _key_bias(key_bias, B, k.shape[2], q.device)
    s = _scores(q, k, kb, causal, _scale_of(D, sm_scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.to(torch.float32)) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_dq_plain(q, k, v, key_bias, do, lse, delta,
                                 causal=False, sm_scale=None):
    """The dQ kernel's arithmetic in plain torch: P recomputed from the
    saved lse, dP = dO.V^T, dS' = P*(dP - delta), dQ = scale * dS'.K."""
    B, H, Tq, D = q.shape
    scale = _scale_of(D, sm_scale)
    kb = _key_bias(key_bias, B, k.shape[2], q.device)
    p = torch.exp(_scores(q, k, kb, causal, scale) - lse[..., None])
    dp = torch.matmul(do.to(torch.float32),
                      v.to(torch.float32).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    return (torch.matmul(ds, k.to(torch.float32)) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta,
                                  causal=False, sm_scale=None):
    """The dK/dV kernel's arithmetic in plain torch: dV = P^T.dO and
    dK = dS'^T.(q * scale). Returns (dK, dV)."""
    B, H, Tq, D = q.shape
    scale = _scale_of(D, sm_scale)
    kb = _key_bias(key_bias, B, k.shape[2], q.device)
    p = torch.exp(_scores(q, k, kb, causal, scale) - lse[..., None])
    do32 = do.to(torch.float32)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    ds = p * (torch.matmul(do32, v.to(torch.float32).transpose(-1, -2))
              - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), q.to(torch.float32) * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, key_bias, do, lse, delta,
                              causal=False, sm_scale=None):
    """The backward kernels' arithmetic in plain torch: (dQ, dK, dV) from
    the forward's saved lse and delta = rowsum(dO * O) - dlse."""
    dq = flash_attention_bwd_dq_plain(q, k, v, key_bias, do, lse, delta,
                                      causal, sm_scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta,
                                           causal, sm_scale)
    return dq, dk, dv


def _check(q, k, v, kb):
    if q.dtype not in _VARIANTS:
        raise TypeError('flash_attention kernel: q must be float32 or '
                        'bfloat16, got %s' % q.dtype)
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.dtype != q.dtype:
            raise TypeError('flash_attention kernel: %s is %s, q %s: q, k '
                            'and v must share one dtype'
                            % (name, t.dtype, q.dtype))
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


def _check_bwd(q, do, lse, delta):
    """What the backward kernels take beyond _check's operands: dO like q
    (its dtype too), lse and delta contiguous fp32 [B, H, Tq] on q's
    device."""
    for name, t, shape, dtype in (
            ('dO', do, q.shape, q.dtype),
            ('lse', lse, q.shape[:3], torch.float32),
            ('delta', delta, q.shape[:3], torch.float32)):
        if t.dtype != dtype or t.shape != shape \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError('flash_attention backward kernel: %s must be a '
                             'contiguous %s %s tensor on %s, got %s %s'
                             % (name, dtype, tuple(shape), q.device, t.dtype,
                                tuple(t.shape)))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_lse_cuda(q, k, v, kb, causal, scale):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _check(q, k, v, kb)
    o = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if Tq == 0:
        return o, lse
    _VARIANTS[q.dtype][0].launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D, scale,
                  int(bool(causal)), _stream(q))
    return o, lse


def _bwd_dq_cuda(q, k, v, kb, do, lse, delta, causal, scale):
    B, H, Tq, D = q.shape
    dq = torch.empty_like(q)
    _VARIANTS[q.dtype][1].launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         kb.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), B, H, Tq,
                         k.shape[2], D, scale, int(bool(causal)), _stream(q))
    return dq


def _bwd_dkv_cuda(q, k, v, kb, do, lse, delta, causal, scale):
    B, H, Tq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _VARIANTS[q.dtype][2].launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          kb.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
                          H, Tq, k.shape[2], D, scale, int(bool(causal)),
                          _stream(q))
    return dk, dv


# flash_attention_bf16_copy_mode's answers
_BF16_COPY_MODES = {3: 'tma', 1: '4-byte', 0: 'element'}


def _bf16_copy_mode(q, k, v, do):
    """How the bf16 kernels, the forward (pass q as `do`) and the backward
    pair, fill their shared tiles for these CUDA operands: 'tma' (D a
    multiple of 8, every base 16-byte aligned), '4-byte' (D even, bases
    4-byte aligned) or 'element' copies. The C launchers make the same
    choice; the tests ask it which one a launch takes."""
    fn = KERNEL_BWD_DQ_BF16.library.load().flash_attention_bf16_copy_mode
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return _BF16_COPY_MODES[fn(q.shape[-1], q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), do.data_ptr())]


def _flash_bwd_cuda(q, k, v, kb, do, lse, delta, causal, scale):
    _check(q, k, v, kb)
    _check_bwd(q, do, lse, delta)
    if q.shape[2] == 0:     # no query rows: nothing reaches k or v
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq = _bwd_dq_cuda(q, k, v, kb, do, lse, delta, causal, scale)
    dk, dv = _bwd_dkv_cuda(q, k, v, kb, do, lse, delta, causal, scale)
    return dq, dk, dv


@torch.library.custom_op('paddle_tpu_torch::flash_attention_lse',
                         mutates_args=(), device_types='cpu')
def _flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, key_bias: torch.Tensor,
                            causal: bool, scale: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator (module docstring); this body is its
    CPU implementation, the plain version."""
    o, lse = flash_attention_lse_plain(q, k, v, key_bias, causal, scale)
    return o.contiguous(), lse.contiguous()


@_flash_attention_lse_op.register_kernel('cuda')
def _(q, k, v, key_bias, causal, scale):
    return _flash_lse_cuda(q, k, v, key_bias, causal, scale)


@_flash_attention_lse_op.register_fake
def _(q, k, v, key_bias, causal, scale):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:3], dtype=torch.float32))


class _FlashAttentionLse(torch.autograd.Function):
    """(O, lse) = flash attention of (q, k, v); differentiable in q, k and
    v through both outputs (the JAX package's _flash_lse custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, kb, causal, scale):
        o, lse = torch.ops.paddle_tpu_torch.flash_attention_lse(
            q, k, v, kb, causal, scale)
        ctx.save_for_backward(q, k, v, kb, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)    # an unused output gives None
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, kb, o, lse = ctx.saved_tensors
        # autograd may hand in a strided dO (the head-merge transpose) or
        # None for an output the loss does not use
        do = torch.zeros_like(o) if do is None else do.contiguous()
        delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
        if dlse is not None:
            delta = delta - dlse.to(torch.float32)
        delta = delta.contiguous()
        if q.is_cuda:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, kb, do, lse, delta,
                                         ctx.causal, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, kb, do, lse,
                                                   delta, ctx.causal,
                                                   ctx.scale)
        # the key bias is a mask constant (stop_gradient in the JAX package)
        return dq, dk, dv, None, None, None


def flash_attention_lse(q, k, v, key_bias=None, causal=False, sm_scale=None):
    """Flash attention over [B, H, T, D] tensors that ALSO returns the
    per-query logsumexp [B, H, Tq] (fp32) — the statistic the backward and
    ring attention consume. Differentiable in q, k and v through both
    outputs; key_bias gets no gradient.

    key_bias: optional additive [B, Tk] bias (e.g. -1e9 on padded keys).
    causal:   lower-triangular masking (decoder self-attention).
    sm_scale: softmax scale, default D ** -0.5."""
    B, H, Tq, D = q.shape
    kb = _key_bias(key_bias, B, k.shape[2], q.device).detach().contiguous()
    return _FlashAttentionLse.apply(q, k, v, kb, bool(causal),
                                    _scale_of(D, sm_scale))


def flash_attention(q, k, v, key_bias=None, causal=False, sm_scale=None):
    """Flash attention over [B, H, T, D] tensors; returns [B, H, Tq, D].
    The unused lse output gets no cotangent, so the backward is the
    classic one."""
    return flash_attention_lse(q, k, v, key_bias=key_bias, causal=causal,
                               sm_scale=sm_scale)[0]
