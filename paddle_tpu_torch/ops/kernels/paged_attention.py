"""Paged decode attention: a hand-written CUDA kernel for Hopper beside its
plain torch version.

Parity: the JAX package's ops/kernels/paged_attention.py. The TPU kernel
replaced is its pallas_call (:127, body `_kernel` :72); the oracle is
`paged_attention_reference` :48. The CUDA source and its design note are
paddle_tpu_torch/csrc/paged_attention.cu.

The contract is the JAX one. q [B, D] fp32 with B = slots * beam (the beam
rows of one slot contiguous); enc_pages [Pe, ps, D] and mask_pages [Pe, ps]
fp32, the encoder pools; pt_enc [slots, NPE] int32, each slot's page
table, every entry a page of the pools; src_cap, the static number of
encoder rows a slot attends over (positions at or past it are sliced
off). Returns the context rows [B, D] fp32: softmax over the slot's
positions of q·k, masked positions (mask <= 0) scoring finfo(f32).min, so
a fully masked slot degrades to the uniform average instead of NaN.

`attend` is the inline attention of the JAX package's lod_beam.py:353-356
(scores, where-mask, softmax, context) on rows already repeated per beam.
The dense decode step calls it directly and `paged_attention_plain` calls
it on the gathered pages, so on the CPU the paged and the dense engines
compute the same operations on the same values, bit for bit.

Dispatch is by q's device, with no fallback and no switch: a CUDA tensor
launches the kernel (built at first use) or raises; a CPU or meta tensor
takes the plain version. `launch_plan` chooses the kernel's cluster size,
column slice, chunk length and beam group from the shapes.
"""
import collections
import ctypes
import functools

import torch

from .._cuda import CudaKernel

__all__ = ['paged_attention', 'paged_attention_plain', 'attend', 'KERNEL',
           'NEG_MASKED', 'launch_plan', 'smem_bytes', 'Plan']

KERNEL = CudaKernel(
    name='paged_attention',
    source='csrc/paged_attention.cu',
    entry='paged_attention',
    argtypes=([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
              + [ctypes.c_void_p]),
    # paged_attention's pallas_call (_kernel :72)
    replaces='paddle_tpu/ops/kernels/paged_attention.py:127')

# the masked-position score of the JAX oracle and kernel (jnp.finfo min)
NEG_MASKED = float(torch.finfo(torch.float32).min)
# the widest row the kernel takes: 8 blocks of 256 columns
_MAX_D = 8 * 256
# the launcher's limits (csrc/paged_attention.cu): positions a chunk, beam
# rows a cluster, dynamic shared memory a block (the H100's 227 KB)
MAX_CHUNK = 64
MAX_GROUP = 16
MAX_SMEM = 232448

Plan = collections.namedtuple('Plan',
                              'n width chunk group chunks col_parts smem')
# threads a block (csrc/paged_attention.cu THREADS)
_THREADS = 256
# the card's SMs when the wrapper does not ask (the H100 SXM's)
_SMS = 132


def _round4(x):
    return (x + 3) // 4 * 4


def _pow2_floor(x):
    return 1 << (max(1, x).bit_length() - 1)


def col_parts(group, chunk):
    """The runs of columns each block's score pass cuts its slice into, so
    that every warp has a (32 positions, four beam rows, run) to score: 1
    to 8, as col_parts in the CUDA source."""
    items = -(-chunk // 32) * -(-group // 4)
    return min(8, _pow2_floor(_THREADS // 32 // items))


def smem_bytes(n, width, chunk, group, chunks):
    """One block's dynamic shared memory, as smem_floats in the CUDA
    source lays it out: the page rows (two stages when there is more than
    one chunk), the q slice and the P.V accumulators between chunks at a
    row pitch of the width rounded up to 8 plus 4; the exchange buffers
    (every block's partial scores, a stage each), the column runs' partial
    scores, exp(s - m), the masks, the softmax state and the positions'
    pool rows (int64)."""
    kp, gp = (width + 7) // 8 * 8 + 4, _round4(group)
    stages = 2 if chunks > 1 else 1
    floats = (stages * chunk * kp + gp * kp + (gp * kp if chunks > 1 else 0)
              + stages * n * chunk * gp + col_parts(group, chunk) * chunk * gp
              + chunk * gp + _round4(stages * chunk)
              + 3 * gp + _round4(2 * stages * chunk))
    return 4 * floats


def slice_width(D, n):
    """The columns each of a cluster's n blocks holds: D / n rounded up
    to a multiple of 4 (the last block holds the rest)."""
    return _round4(-(-D // n))


def _chunk(n, width, group, src_cap):
    """The longest chunk, 64 or else 32 positions (src_cap if shorter),
    whose blocks fit the shared memory; None if neither does."""
    for chunk in (min(MAX_CHUNK, src_cap), min(32, src_cap)):
        if smem_bytes(n, width, chunk, group, -(-src_cap // chunk)) \
                <= MAX_SMEM:
            return chunk
    return None


@functools.lru_cache(maxsize=None)
def launch_plan(slots, D, beam, src_cap, sms=_SMS):
    """How the kernel is launched for these shapes: a cluster of `n`
    blocks for each slot and group of beam rows, each holding `width`
    columns (D / n rounded up to a multiple of 4; the last block the
    rest, at least 1); positions `chunk` at a time (src_cap, at most 64,
    or 32 where 64 would not fit the shared memory; `chunks` of them);
    `group` beam rows a cluster (at most 16); the score pass's
    `col_parts`; and `smem` bytes of shared memory a block.

    n gives slices of 256 to 511 columns (8 at D 2048, 4 from 1024, 2
    from 512, else 1), doubled while a block would not fit the shared
    memory, and halved while the clusters would need more blocks than the
    card has SMs (`sms`) and the wider slices still fit."""
    group = min(MAX_GROUP, beam)
    clusters = slots * -(-beam // group)
    n = 8 if D >= 2048 else 4 if D >= 1024 else 2 if D >= 512 else 1
    while n < 8 and not _chunk(n, slice_width(D, n), group, src_cap):
        n *= 2                             # wide slices of many beam rows
    while n > 1 and clusters * n > sms and \
            _chunk(n // 2, slice_width(D, n // 2), group, src_cap):
        n //= 2
    width = slice_width(D, n)
    chunk = _chunk(n, width, group, src_cap)
    chunks = -(-src_cap // chunk)
    return Plan(n, width, chunk, group, chunks, col_parts(group, chunk),
                smem_bytes(n, width, chunk, group, chunks))


def attend(q, enc_t, mask_t):
    """ctx [Bb, D] from q [Bb, D] against enc_t [Bb, S, D] with mask_t
    [Bb, S] (1 live, 0 masked): the inline attend of lod_beam.py:353-356."""
    scores = torch.bmm(enc_t, q.unsqueeze(-1)).squeeze(-1)
    scores = torch.where(mask_t > 0, scores, NEG_MASKED)
    alpha = torch.softmax(scores, dim=-1)
    return torch.bmm(alpha.unsqueeze(1), enc_t).squeeze(1)


def paged_attention_plain(q, enc_pages, mask_pages, pt_enc, src_cap):
    """The oracle in plain torch: gather each slot's pages through its
    table, slice to src_cap, repeat per beam, attend."""
    pt = pt_enc.long()
    C, NPE = pt.shape
    ps, D = enc_pages.shape[1], enc_pages.shape[2]
    enc = enc_pages[pt].reshape(C, NPE * ps, D)[:, :src_cap]
    mask = mask_pages[pt].reshape(C, NPE * ps)[:, :src_cap]
    beam = q.shape[0] // C
    return attend(q, enc.repeat_interleave(beam, dim=0),
                  mask.repeat_interleave(beam, dim=0))


def _check(q, enc_pages, mask_pages, pt_enc, src_cap):
    """What the kernel takes: contiguous fp32 q [C*beam, D], enc_pages
    [Pe, ps, D], mask_pages [Pe, ps] and int32 pt_enc [C, NPE] on one card,
    1 <= src_cap <= NPE*ps, D <= 2048. Page ids are not checked (a read of
    the card would wait for it): every entry must be a page of the pools,
    as the engine's tables are."""
    dev = q.device

    def bad(what):
        raise ValueError('paged_attention kernel: %s' % what)

    if enc_pages.dim() != 3 or mask_pages.dim() != 2 or pt_enc.dim() != 2 \
            or q.dim() != 2:
        bad('want q [B, D], enc_pages [Pe, ps, D], mask_pages [Pe, ps], '
            'pt_enc [C, NPE]; got %s %s %s %s'
            % (tuple(q.shape), tuple(enc_pages.shape),
               tuple(mask_pages.shape), tuple(pt_enc.shape)))
    Pe, ps, D = enc_pages.shape
    C, NPE = pt_enc.shape
    for name, t, dtype, shape in (
            ('q', q, torch.float32, None),
            ('enc_pages', enc_pages, torch.float32, None),
            ('mask_pages', mask_pages, torch.float32, (Pe, ps)),
            ('pt_enc', pt_enc, torch.int32, None)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev \
                or (shape is not None and tuple(t.shape) != shape):
            bad('%s must be a contiguous %s tensor%s on %s, got %s %s on %s'
                % (name, dtype, '' if shape is None else ' of %s' % (shape,),
                   dev, t.dtype, tuple(t.shape), t.device))
    B = q.shape[0]
    if q.shape[1] != D or C < 1 or B % C or B == 0:
        bad('q %s does not hold beam rows of %d slots of width %d'
            % (tuple(q.shape), C, D))
    if not 1 <= src_cap <= NPE * ps:
        bad('src_cap %d outside [1, %d]' % (src_cap, NPE * ps))
    if D > _MAX_D:
        bad('D %d exceeds %d' % (D, _MAX_D))


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_attention(q, enc_pages, mask_pages, pt_enc, src_cap):
    """Fused page-gather attention: ctx [B, D] from q [B, D] against the
    paged encoder pools. Same contract as `paged_attention_plain`."""
    if not q.is_cuda:
        return paged_attention_plain(q, enc_pages, mask_pages, pt_enc,
                                     src_cap)
    src_cap = int(src_cap)
    _check(q, enc_pages, mask_pages, pt_enc, src_cap)
    out = torch.empty_like(q)
    B, D = q.shape
    C, NPE = pt_enc.shape
    plan = launch_plan(C, D, B // C, src_cap, _sm_count(q.device))
    KERNEL.launch(q.data_ptr(), enc_pages.data_ptr(), mask_pages.data_ptr(),
                  pt_enc.data_ptr(), out.data_ptr(), B, B // C, NPE,
                  enc_pages.shape[1], D, src_cap, plan.n, plan.width,
                  plan.chunk, plan.group,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
