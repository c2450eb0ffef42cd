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
    nothing.
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
