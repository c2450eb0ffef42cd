"""The port's paged decode attention (ops/kernels/paged_attention.py)
against the JAX package's, on the CPU, on the same numpy inputs:

  * the plain version (what the CUDA kernel computes) against the oracle
    `paged_attention_reference` and against the Pallas kernel run in
    interpret mode, on the three `_paged_case` shapes of
    tests/test_kernels.py:111-115, a fully masked slot, tables whose tails
    point at the zero page (the engine's layout) and a src_cap that is not
    a multiple of the page size. Tolerance 1e-5 + 1e-5*|ref|, the Pallas
    kernel test's (tests/test_kernels.py:127): one softmax here, an online
    one there;
  * `attend`, the dense step's attention, against the JAX step's inline
    attend lines (lod_beam.py:353-356);
  * the wrapper on CPU tensors takes the plain version and launches
    nothing;
  * the CUDA kernel's order of operations, emulated in torch fp32 (D cut
    into the cluster's column slices, their partial scores summed in rank
    order, a chunked online softmax with the finfo.min mask and the
    src_cap cut), against the oracle and the Pallas kernel at the same
    tolerance; and `launch_plan`, the wrapper's choice of cluster size,
    slices, chunk and beam group, over every D the kernel takes.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the modules (each package's ops/kernels exports a function of the name)
jpa = importlib.import_module('paddle_tpu.ops.kernels.paged_attention')
tpa = importlib.import_module('paddle_tpu_torch.ops.kernels.paged_attention')

TOL = 1e-5


def _kernels_case(rng, C, beam, ps, npe, src_cap, D, masked_slot=None):
    """tests/test_kernels.py's _paged_case: each slot owns `npe` distinct
    pages of a permuted pool, a length in [1, src_cap] sets the mask (0
    for `masked_slot`)."""
    n_pages = C * npe + 2
    enc_pages = (rng.randn(n_pages, ps, D) * 0.5).astype(np.float32)
    mask_pages = np.zeros((n_pages, ps), np.float32)
    pt = rng.permutation(n_pages)[:C * npe].reshape(C, npe).astype(np.int32)
    for c in range(C):
        ln = 0 if masked_slot == c else int(rng.randint(1, src_cap + 1))
        for j in range(npe):
            for k in range(ps):
                if j * ps + k < ln:
                    mask_pages[pt[c, j], k] = 1.0
    q = (rng.randn(C * beam, D) * 0.7).astype(np.float32)
    return q, enc_pages, mask_pages, pt


def _engine_case(rng, C, beam, ps, npe, src_cap, D):
    """The engine's layout: page 0 the zero page, each slot holding only
    the pages its length needs, tail entries on page 0, one slot with no
    page at all (an inactive slot)."""
    n_pages = 1 + C * npe
    enc_pages = (rng.randn(n_pages, ps, D) * 0.5).astype(np.float32)
    enc_pages[0] = 0.0
    mask_pages = np.zeros((n_pages, ps), np.float32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    pt = np.zeros((C, npe), np.int32)
    for c in range(C):
        ln = 0 if c == C - 1 else int(rng.randint(1, src_cap + 1))
        for j in range(-(-ln // ps)):
            pt[c, j] = free.pop()
            mask_pages[pt[c, j], :min(ps, ln - j * ps)] = 1.0
    q = (rng.randn(C * beam, D) * 0.7).astype(np.float32)
    return q, enc_pages, mask_pages, pt


def _check(case, src_cap, jax_fn):
    q, enc_pages, mask_pages, pt = case
    ref = np.asarray(jax_fn(jnp.asarray(q), jnp.asarray(enc_pages),
                            jnp.asarray(mask_pages), jnp.asarray(pt),
                            src_cap))
    before = tpa.KERNEL.launches
    got = tpa.paged_attention(torch.from_numpy(q),
                              torch.from_numpy(enc_pages),
                              torch.from_numpy(mask_pages),
                              torch.from_numpy(pt), src_cap).numpy()
    assert tpa.KERNEL.launches == before       # CPU: the plain version
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert (err <= TOL + TOL * np.abs(ref)).all(), 'max err %.3g' % err.max()


_ORACLES = {
    'reference': jpa.paged_attention_reference,
    'interpret': lambda *a: jpa.paged_attention(*a, interpret=True),
}


@pytest.mark.parametrize('oracle', sorted(_ORACLES))
@pytest.mark.parametrize('C,beam,ps,npe,src_cap,D', [
    (2, 3, 3, 2, 5, 16),
    (1, 1, 4, 3, 10, 8),
    (3, 2, 4, 2, 7, 8),
])
def test_plain_matches_jax(oracle, C, beam, ps, npe, src_cap, D):
    rng = np.random.RandomState(C * 100 + D)
    _check(_kernels_case(rng, C, beam, ps, npe, src_cap, D), src_cap,
           _ORACLES[oracle])


@pytest.mark.parametrize('oracle', sorted(_ORACLES))
def test_fully_masked_slot_is_the_uniform_average(oracle):
    rng = np.random.RandomState(9)
    case = _kernels_case(rng, 2, 3, 3, 2, 5, 8, masked_slot=1)
    _check(case, 5, _ORACLES[oracle])
    q, enc_pages, mask_pages, pt = case
    got = tpa.paged_attention_plain(*[torch.from_numpy(a) for a in case], 5)
    rows = enc_pages[pt[1]].reshape(-1, 8)[:5]
    np.testing.assert_allclose(got[3:].numpy(),
                               np.repeat(rows.mean(0)[None], 3, 0),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('oracle', sorted(_ORACLES))
@pytest.mark.parametrize('src_cap', [8, 7])      # 7: not a multiple of ps
def test_zero_page_tails_and_ragged_src_cap(oracle, src_cap):
    rng = np.random.RandomState(src_cap)
    _check(_engine_case(rng, 4, 3, 4, 2, src_cap, 6), src_cap,
           _ORACLES[oracle])


def test_attend_is_the_jax_step_attend():
    """`attend` against lod_beam.py:353-356 written out in jnp."""
    import jax
    rng = np.random.RandomState(3)
    q = (rng.randn(6, 5) * 0.7).astype(np.float32)
    enc = (rng.randn(6, 4, 5) * 0.5).astype(np.float32)
    mask = (rng.rand(6, 4) > 0.3).astype(np.float32)
    mask[2] = 0.0                                   # a fully masked row
    s = jnp.einsum('bd,bsd->bs', q, enc)
    s = jnp.where(mask > 0, s, jnp.finfo(jnp.float32).min)
    ref = np.asarray(jnp.einsum('bs,bsd->bd', jax.nn.softmax(s, -1), enc))
    got = tpa.attend(torch.from_numpy(q), torch.from_numpy(enc),
                     torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


# -- the CUDA kernel's order of operations -----------------------------------

def _emulate(q, enc_pages, mask_pages, pt, src_cap, n, chunk):
    """csrc/paged_attention.cu's arithmetic in torch fp32: each of n
    blocks scores its column slice (slice_width) in col_parts runs of
    4-column pieces, the partials are summed in rank order 0..n-1 and run
    order within a rank, masked positions score finfo.min, and positions
    go `chunk` at a time through an online softmax; out = acc / max(l,
    1e-30)."""
    q, enc_pages, mask_pages = (torch.from_numpy(a) for a in
                                (q, enc_pages, mask_pages))
    C, _ = pt.shape
    B, D = q.shape
    beam, ps = B // C, enc_pages.shape[1]
    width = tpa.slice_width(D, n)
    slices = [(r * width, min(D, (r + 1) * width)) for r in range(n)]
    assert all(a < b for a, b in slices) and slices[-1][1] == D
    parts = tpa.col_parts(min(beam, tpa.MAX_GROUP), chunk)
    cuts = []
    for a, b in slices:
        per = 4 * -(-(-(-(b - a) // 4)) // parts)      # columns a run
        cuts += [(min(b, a + i * per), min(b, a + (i + 1) * per))
                 for i in range(parts)]
    out = torch.empty_like(q)
    for c in range(C):
        qc = q[c * beam:(c + 1) * beam]
        m = torch.full((beam,), -float('inf'))
        l = torch.zeros(beam)
        acc = torch.zeros(beam, D)
        for k0 in range(0, src_cap, chunk):
            pos = np.arange(k0, min(src_cap, k0 + chunk))
            pages = torch.from_numpy(pt[c, pos // ps].astype(np.int64))
            rows = torch.from_numpy(pos % ps)
            k = enc_pages[pages, rows]
            parts = [qc[:, a:b] @ k[:, a:b].T for a, b in cuts]
            s = parts[0]
            for p in parts[1:]:
                s = s + p
            s = torch.where(mask_pages[pages, rows] > 0, s, tpa.NEG_MASKED)
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.exp(s - m_new[:, None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p @ k
            m = m_new
        out[c * beam:(c + 1) * beam] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.numpy()


def _shared_pages_case(rng, beam, ps, npe, src_cap, D):
    """Three slots whose tables share pages, as prefix-cache hits do:
    slots 0 and 2 hold the same first page, slot 1 repeats slot 0's last
    page; page 0 the zero page under the tails."""
    n_pages = 2 + 3 * npe
    enc_pages = (rng.randn(n_pages, ps, D) * 0.5).astype(np.float32)
    enc_pages[0] = 0.0
    mask_pages = np.ones((n_pages, ps), np.float32)
    mask_pages[0] = 0.0
    pt = (1 + rng.permutation(n_pages - 1)[:3 * npe]).reshape(3, npe)
    pt = pt.astype(np.int32)
    pt[2, 0] = pt[0, 0]
    pt[1, -1] = pt[0, -1]
    pt[2, -1] = 0
    q = (rng.randn(3 * beam, D) * 0.7).astype(np.float32)
    return q, enc_pages, mask_pages, pt


def _emulation_case(kind, rng):
    """(arrays, src_cap, n, chunk) for one named case."""
    if kind == 'chunks_cross_src_cap':         # 3 chunks of 4, src_cap 10
        return _engine_case(rng, 3, 2, 3, 4, 10, 16), 10, 2, 4
    if kind == 'module_chunk_cut_at_70':       # launch_plan's 64, then 6
        return _engine_case(rng, 2, 2, 4, 20, 70, 8), 70, 1, \
            tpa.launch_plan(2, 8, 2, 70).chunk
    if kind == 'fully_masked_slot':
        return _kernels_case(rng, 3, 3, 4, 3, 11, 12, masked_slot=1), 11, \
            2, 4
    if kind == 'shared_pages':
        return _shared_pages_case(rng, 3, 4, 3, 12, 24), 12, 2, 5
    if kind == 'D6':
        return _engine_case(rng, 4, 3, 3, 2, 5, 6), 5, 1, 2
    if kind == 'D20_uneven_slices':            # slices of 12 and 8
        return _kernels_case(rng, 3, 2, 4, 3, 9, 20), 9, 2, 4
    if kind == 'D100_four_slices':             # 28, 28, 28, 16
        return _kernels_case(rng, 2, 3, 4, 2, 8, 100), 8, 4, 3
    if kind == 'beam1':
        return _kernels_case(rng, 5, 1, 4, 3, 12, 16), 12, 2, 5
    if kind == 'beam20_two_groups':
        return _kernels_case(rng, 2, 20, 3, 2, 6, 8), 6, 1, 6
    raise KeyError(kind)


_EMULATION_CASES = ['chunks_cross_src_cap', 'module_chunk_cut_at_70',
                    'fully_masked_slot', 'shared_pages', 'D6',
                    'D20_uneven_slices', 'D100_four_slices', 'beam1',
                    'beam20_two_groups']


@pytest.mark.parametrize('oracle', sorted(_ORACLES))
@pytest.mark.parametrize('kind', _EMULATION_CASES)
def test_kernel_order_of_operations_matches_jax(oracle, kind):
    rng = np.random.RandomState(len(kind))
    arrays, src_cap, n, chunk = _emulation_case(kind, rng)
    ref = np.asarray(_ORACLES[oracle](*[jnp.asarray(a) for a in arrays],
                                      src_cap))
    got = _emulate(*arrays, src_cap, n, chunk)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert (err <= TOL + TOL * np.abs(ref)).all(), 'max err %.3g' % err.max()


def test_emulated_masked_slot_is_the_uniform_average():
    rng = np.random.RandomState(4)
    q, enc_pages, mask_pages, pt = _engine_case(rng, 4, 3, 4, 3, 11, 8)
    got = _emulate(q, enc_pages, mask_pages, pt, 11, 2, 4)[9:]  # slot 3
    rows = enc_pages[pt[3]].reshape(-1, 8)[:11]
    np.testing.assert_allclose(got, np.repeat(rows.mean(0)[None], 3, 0),
                               rtol=1e-6, atol=1e-6)


def test_launch_plan_at_the_decode_shape():
    """16 slots x beam 3 at D 1024, src_cap 32: clusters of 4 blocks of
    256 columns, the whole source one chunk, the slot's 3 rows one group;
    64 slots x beam 1 take clusters of 2, so that the blocks still fit
    the H100's 132 SMs."""
    plan = tpa.launch_plan(16, 1024, 3, 32)
    assert (plan.n, plan.width, plan.chunk, plan.chunks, plan.group) == \
        (4, 256, 32, 1, 3)
    assert tpa.launch_plan(64, 1024, 1, 32)[:2] == (2, 512)
    assert tpa.launch_plan(4, 6, 3, 5)[:5] == (1, 8, 5, 3, 1)


@pytest.mark.parametrize('src_cap', [1, 5, 32, 64, 65, 250, 1000])
def test_launch_plan_covers_every_width(src_cap):
    """For every D the kernel takes: n in {1, 2, 4, 8}, no more blocks
    than SMs where a smaller n fits; the slices cover D exactly with no
    empty block; chunks cover src_cap; the group fits the beam; shared
    memory within the H100's 227 KB a block."""
    for slots, beam in ((1, 1), (16, 3), (4, 16), (2, 17), (64, 1),
                        (200, 2)):
        clusters = slots * -(-beam // min(beam, tpa.MAX_GROUP))
        for D in range(1, tpa._MAX_D + 1):
            plan = tpa.launch_plan(slots, D, beam, src_cap)
            n, w = plan.n, plan.width
            assert n in (1, 2, 4, 8) and w % 4 == 0, (D, plan)
            assert n == 1 or clusters * n <= 132 or \
                tpa.smem_bytes(n // 2, tpa.slice_width(D, n // 2),
                               min(32, src_cap), plan.group,
                               -(-src_cap // min(32, src_cap))) \
                > tpa.MAX_SMEM, (D, plan)
            assert (n - 1) * w < D <= n * w, (D, plan)
            assert 1 <= plan.chunk <= tpa.MAX_CHUNK
            assert (plan.chunks - 1) * plan.chunk < src_cap \
                <= plan.chunks * plan.chunk, (D, plan)
            assert 1 <= plan.group <= min(beam, tpa.MAX_GROUP)
            assert plan.col_parts in (1, 2, 4, 8)
            assert plan.smem <= tpa.MAX_SMEM, (D, beam, plan)
