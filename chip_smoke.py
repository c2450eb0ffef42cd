#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It imports nothing of JAX or of the JAX package.

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. build    — compile every hand-written kernel of the port from the
                sources in the checkout (one nvcc per source, all started
                together); print the build time, ptxas' resource lines and
                the card's name and power limit.
  2. kernels  — each kernel's wrapper against its plain torch version on
                the card, at the shapes the main paths give it (batch 16:
                the training batch and serving's largest bucket), within a
                stated tolerance; time kernel, plain version and the
                PyTorch library call computing the same function (for the
                two backward kernels, which no library call computes one
                at a time: the pair against SDPA's backward).
  3. serving  — full-width Transformer-base (6+6 layers, d_model 512, 8
                heads, d_inner 2048, vocab 10000, max_length 256) built
                with the port's layers, initialized on the card from a seed,
                saved with save_inference_model, loaded by Predictor (the
                default place: the card) behind a ServingEngine that answers
                concurrent requests. Every answer is checked against
                Predictor.run on the same rows, one against the same
                artifact run on the CPU, and the kernel launch counts
                against what the path must launch.
  4. training — full-width Transformer-base from models.transformer.
                get_model (noam_decay, Adam) at batch 16, max_length 256,
                trained TRAIN_STEPS steps through Executor(CUDAPlace(0)) on
                its wmt16 reader: finite losses that fall, 18 launches per
                step of each attention kernel (forward, backward dQ,
                backward dK/dV), step-1 gradients on the card against the
                same step on the CPU, and the trained program's inference
                artifact answering a request through Predictor on the card.
  5. a JSON line {"kernels": [...]} with each kernel's parity, launches,
     times and bound; then the card's name and power limit; then the last
     line {"ok": true, "device": {...}}.
"""
import concurrent.futures
import importlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 2024
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the fp32 rate outside the tensor cores (the kernel runs fp32
# FFMA; TF32 is off on the port's GPU path)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# kernel vs plain torch, fp32 on the card: the kernel sums q.k over D and
# p.v over keys in tile order with an online softmax, the plain version in
# one cuBLAS product and one softmax — different summation orders
KERNEL_TOL = 1e-4
# the backward kernels vs their plain versions: the same orders again, over
# products of depth 64 (dP, dQ, dK, dV) fed by P recomputed from the lse;
# the tolerance of the Pallas backward's own test
# (tests/test_flash_attention.py:64)
KERNEL_BWD_TOL = 3e-4
# the same artifact on the card and on the CPU: 12 layers of fp32 products
# and reductions summed in different orders on two devices
CROSS_DEVICE_TOL = 1e-3
# step-1 gradients on the card and on the CPU, each tensor's difference in
# L2 norm held to this fraction of its own norm. A ReLU unit whose
# pre-activation lies within rounding of 0 takes the other branch on the
# other device, which moves a few elements of the gradients upstream of it
# by their full size: measured at 1.2e-3 at most over Transformer-base's
# 183 gradients on an H100, where most agree within 1e-6 (PERF.md §6)
GRAD_TOL = 1e-2

TRANSFORMER_BASE = dict(src_vocab_size=10000, trg_vocab_size=10000,
                        max_length=256, n_layer=6, d_model=512, n_head=8,
                        d_inner=2048)
ATTENTION_OPS_PER_FORWARD = 18   # 6 encoder self, 6 decoder causal, 6 cross
TRAIN_BATCH = 16
TRAIN_STEPS = 20
# get_model's noam_decay lr, 2 * 512^-0.5 * step * WARMUP^-1.5, climbs from
# 3.1e-5 to 6.3e-4 over the 20 steps: a usable Adam lr from the start (the
# default 4000 would keep it under 1e-5). With 100 it passed 1e-3 at step
# 12 and the loss of this post-norm model rose from there.
TRAIN_WARMUP = 200


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters=50, warmup=5, rounds=3):
    """Device ms per call: CUDA events around `iters` back-to-back calls,
    the median of `rounds` such runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


# -- phase 1 ----------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch import ops
    t0 = time.perf_counter()
    logs = ops.build_all()
    secs = time.perf_counter() - t0
    log('[build] %d source(s) built in %.3f s, kernels: %s'
        % (len(logs), secs, ', '.join(sorted(ops.KERNELS))))
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                log('[build] %s: %s' % (name, line.strip()))
    log('[build] card: %s' % nvidia_smi_line())


# -- phase 2 ----------------------------------------------------------------

def _attention_case(name, B, H, Tq, Tk, D, causal, gen):
    import torch
    dev = torch.device('cuda', 0)
    q = torch.randn((B, H, Tq, D), generator=gen, device=dev)
    k = torch.randn((B, H, Tk, D), generator=gen, device=dev)
    v = torch.randn((B, H, Tk, D), generator=gen, device=dev)
    # pad bias as the Transformer builds it: -1e9 past each row's length;
    # the first key is always live, so no row is fully masked
    lens = torch.randint(Tk // 2, Tk + 1, (B,), generator=gen, device=dev)
    bias = torch.where(torch.arange(Tk, device=dev)[None, :] < lens[:, None],
                       0.0, -1e9).to(torch.float32).contiguous()
    return dict(name=name, q=q, k=k, v=v, bias=bias, causal=causal,
                scale=D ** -0.5, shape=[B, H, Tq, Tk, D])


def _pairs(Tq, Tk, causal):
    """(query, key) pairs the kernels compute: under causal masking only
    those on or below the diagonal."""
    if causal:
        return sum(min(i + 1, Tk) for i in range(Tq))
    return Tq * Tk


def _bound(flops, nbytes):
    """Least time for the work, ms, and what bounds it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def _attention_bound(B, H, Tq, Tk, D, causal):
    """Forward: 2 tile products (s, P.V) of depth D per pair; q, k, v, bias
    read once, O and lse written once."""
    flops = 4.0 * B * H * D * _pairs(Tq, Tk, causal)
    nbytes = 4.0 * (B * H * Tq * D * 2 + B * H * Tk * D * 2 + B * Tk
                    + B * H * Tq)
    return _bound(flops, nbytes)


def _attention_bwd_bound(B, H, Tq, Tk, D, causal, which):
    """Backward: dQ ('dq') does 3 tile products per pair (s, dP, dQ), dK/dV
    ('dkv') 4 (s, dP, dV, dK), the two ('both') 14 * B * H * D * pairs
    FLOPs. Each reads q, k, v, dO, bias, lse and delta once and writes its
    outputs once."""
    products = {'dq': 3, 'dkv': 4, 'both': 7}[which]
    flops = 2.0 * products * B * H * D * _pairs(Tq, Tk, causal)
    reads = B * H * Tq * D * 2 + B * H * Tk * D * 2 + B * Tk + 2 * B * H * Tq
    writes = (B * H * Tq * D * (which != 'dkv')
              + 2 * B * H * Tk * D * (which != 'dq'))
    return _bound(flops, 4.0 * (reads + writes))


def _sdpa_mask(c):
    """The additive [B, 1, Tq, Tk] mask SDPA needs for the same function:
    the key bias, and NEG_BIG above the diagonal under causal masking."""
    import torch
    from paddle_tpu_torch.ops.flash_attention import NEG_BIG
    B, H, Tq, Tk, D = c['shape']
    mask = c['bias'][:, None, None, :].expand(B, 1, Tq, Tk)
    if c['causal']:
        tri = torch.ones((Tq, Tk), dtype=torch.bool, device='cuda').tril()
        mask = mask.masked_fill(~tri, NEG_BIG)
    return mask.contiguous()


def _max_err(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def _allclose(got, want, tol):
    import torch
    return all(torch.allclose(g, w, atol=tol, rtol=tol)
               for g, w in zip(got, want))


def phase_kernels():
    """Every kernel against its plain version in four cases; returns
    {kernel name: [case result, ...]}."""
    import torch
    import torch.nn.functional as F
    # the module (ops/__init__ exports a function of the same name)
    fa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    # the batch the training path gives every kernel, and the largest
    # bucket serving gives the forward
    B, H, T, D = TRAIN_BATCH, 8, 256, 64
    cases = [
        _attention_case('encoder self, pad bias', B, H, T, T, D, False, gen),
        _attention_case('decoder self, causal', B, H, T, T, D, True, gen),
        _attention_case('cross, Tq != Tk', B, H, T, 160, D, False, gen),
        _attention_case('ragged T=200, causal', B, H, 200, 200, D, True,
                        gen),
    ]
    results = {'flash_attention_fwd': [], 'flash_attention_bwd_dq': [],
               'flash_attention_bwd_dkv': []}
    for c in cases:
        q, k, v, kb = c['q'], c['k'], c['v'], c['bias']
        causal, scale = c['causal'], c['scale']
        Bq, Hq, Tq, Tk, Dq = c['shape']
        head = dict(case=c['name'], shape_B_H_Tq_Tk_D=c['shape'],
                    causal=causal)
        mask = _sdpa_mask(c)

        # forward
        kw = dict(key_bias=kb, causal=causal, sm_scale=scale)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_lse_plain(q, k, v, **kw)
        ok = _allclose((o, lse), want, KERNEL_TOL)
        bound_ms, bound_by = _attention_bound(Bq, Hq, Tq, Tk, Dq, causal)
        r = dict(head, max_abs_err=_max_err((o, lse), want), ok=ok,
                 tol=KERNEL_TOL,
                 ms=time_ms(lambda: fa._flash_lse_cuda(q, k, v, kb, causal,
                                                       scale)),
                 plain_ms=time_ms(
                     lambda: fa.flash_attention_lse_plain(q, k, v, **kw)),
                 library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=mask, scale=scale)),
                 bound_ms=bound_ms, bound_by=bound_by)
        log('[kernels] flash_attention_fwd %s' % json.dumps(r))
        results['flash_attention_fwd'].append(r)

        # backward: both cotangents, delta = rowsum(dO * O) - dlse as the
        # autograd Function makes it
        do = torch.randn(o.shape, generator=gen, device='cuda')
        dlse = torch.randn(lse.shape, generator=gen, device='cuda')
        delta = ((do * o).sum(-1) - dlse).contiguous()
        bwd = (q, k, v, kb, do, lse, delta, causal, scale)
        fa._check_bwd(q, do, lse, delta)
        dq = fa._bwd_dq_cuda(*bwd)
        dk, dv = fa._bwd_dkv_cuda(*bwd)
        torch.cuda.synchronize()
        want_dq = fa.flash_attention_bwd_dq_plain(*bwd)
        want_dkv = fa.flash_attention_bwd_dkv_plain(*bwd)
        # no library call computes dQ alone or dK/dV alone: SDPA's
        # backward (autograd through it with the same additive mask; the
        # dlse cotangent has no counterpart there) computes all three, so
        # it stands beside the pair of kernels, timed together
        qr, kr, vr = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                             scale=scale)
        pair_bound, pair_by = _attention_bwd_bound(Bq, Hq, Tq, Tk, Dq,
                                                   causal, 'both')
        pair = dict(
            kernels=['flash_attention_bwd_dq', 'flash_attention_bwd_dkv'],
            ms=time_ms(lambda: (fa._bwd_dq_cuda(*bwd),
                                fa._bwd_dkv_cuda(*bwd))),
            bound_ms=pair_bound, bound_by=pair_by,
            library='torch.autograd.grad through scaled_dot_product_'
                    'attention: dQ, dK and dV in one backward',
            library_ms=time_ms(lambda: torch.autograd.grad(
                out, (qr, kr, vr), do, retain_graph=True)))
        for name, which, got, want, kern, plain in (
                ('flash_attention_bwd_dq', 'dq', (dq,), (want_dq,),
                 fa._bwd_dq_cuda, fa.flash_attention_bwd_dq_plain),
                ('flash_attention_bwd_dkv', 'dkv', (dk, dv), want_dkv,
                 fa._bwd_dkv_cuda, fa.flash_attention_bwd_dkv_plain)):
            bound_ms, bound_by = _attention_bwd_bound(Bq, Hq, Tq, Tk, Dq,
                                                      causal, which)
            r = dict(head, max_abs_err=_max_err(got, want),
                     ok=_allclose(got, want, KERNEL_BWD_TOL),
                     tol=KERNEL_BWD_TOL,
                     ms=time_ms(lambda: kern(*bwd)),
                     plain_ms=time_ms(lambda: plain(*bwd)),
                     library_ms=None, bound_ms=bound_ms,
                     bound_by=bound_by, backward_pair=pair)
            log('[kernels] %s %s' % (name, json.dumps(r)))
            results[name].append(r)
    for name, rs in results.items():
        bad = [r['case'] for r in rs if not r['ok']]
        if bad:
            raise AssertionError('%s disagrees with its plain version '
                                 'beyond %g in: %s'
                                 % (name, rs[0]['tol'], bad))
    return results


# -- phase 3 ----------------------------------------------------------------

def logits_var(program):
    """The decoder logits [B, T, V]: the X input of the reshape whose
    output is the Logits input of softmax_with_cross_entropy."""
    blk = program.global_block()
    lg = [op.input('Logits')[0] for op in blk.ops
          if op.type == 'softmax_with_cross_entropy'][0]
    return blk.var([op.input('X')[0] for op in blk.ops
                    if op.type == 'reshape' and op.output('Out')[0] == lg][0])


def build_artifact(dirname, config, place):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import transformer as T
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    scope = fluid.Scope()
    with unique_name.guard(), framework.program_guard(main, startup):
        T.transformer(**config)
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ['src_word', 'trg_word'],
                                  [logits_var(main)], exe,
                                  main_program=main, scope=scope)


def make_requests(n_requests, max_rows, max_length, vocab, rng):
    reqs = []
    for _ in range(n_requests):
        rows = int(rng.randint(1, max_rows + 1))
        feed = {}
        for name in ('src_word', 'trg_word'):
            ids = np.zeros((rows, max_length), dtype='int64')
            for r in range(rows):
                n = int(rng.randint(8, max_length + 1))
                ids[r, :n] = rng.randint(1, vocab, n)
            feed[name] = ids
        reqs.append(feed)
    return reqs


def phase_serving():
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        return _serve(tmp)


def _serve(tmp):
    import torch
    from paddle_tpu_torch import fluid, inference, obs, ops, serving
    cfg = TRANSFORMER_BASE
    t0 = time.perf_counter()
    build_artifact(tmp, cfg, fluid.CUDAPlace(0))
    log('[serving] built, initialized on the card and saved Transformer-'
        'base in %.3f s' % (time.perf_counter() - t0))
    pred = inference.Predictor(tmp)
    engine = serving.ServingEngine(pred, serving.ServingConfig(
        max_batch_size=16, max_queue_delay_ms=20.0))
    reqs = make_requests(8, 4, cfg['max_length'], cfg['trg_vocab_size'],
                         np.random.RandomState(SEED))
    batch_hist = obs.histogram('serving.batch.seconds')
    n_before = batch_hist.count
    try:
        # the main path: warmup over every bucket, then concurrent traffic
        for k in ops.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        buckets = engine.warmup()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            futs = list(pool.map(engine.submit, reqs))
        answers = [f.result(timeout=600)[0] for f in futs]
        serve_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in ops.KERNELS.items()}
        stats = engine.stats
    finally:
        engine.shutdown()
    batches = stats['batches']
    runs = len(buckets) + batches
    want = ATTENTION_OPS_PER_FORWARD * runs
    if launches['flash_attention_fwd'] != want:
        raise AssertionError(
            'flash_attention_fwd launched %d times for %d forward(s) '
            '(%d warmup + %d batches); the path must launch it %d times '
            'per forward' % (launches['flash_attention_fwd'], runs,
                             len(buckets), batches,
                             ATTENTION_OPS_PER_FORWARD))
    rows = sum(r['src_word'].shape[0] for r in reqs)
    real_tokens = sum(int((r['trg_word'] != 0).sum()) for r in reqs)
    n_b = batch_hist.count - n_before
    log('[serving] warmup over buckets %s: %.3f s' % (buckets, warm_s))
    log('[serving] %d requests, %d rows in %d batch(es) in %.4f s; '
        'per-batch latency mean %.4f s min %.4f s max %.4f s; '
        '%.1f target positions/s (%d real target tokens: %.1f tokens/s)'
        % (len(reqs), rows, batches, serve_s,
           (batch_hist.sum / batch_hist.count) if n_b else float('nan'),
           batch_hist.min, batch_hist.max,
           rows * cfg['max_length'] / serve_s, real_tokens,
           real_tokens / serve_s))
    log('[serving] flash_attention_fwd launches: %d = %d x %d forwards'
        % (launches['flash_attention_fwd'], ATTENTION_OPS_PER_FORWARD, runs))

    # correctness: every answer against Predictor.run on the same rows
    worst = 0.0
    for req, ans in zip(reqs, answers):
        n = req['src_word'].shape[0]
        if ans.shape != (n, cfg['max_length'], cfg['trg_vocab_size']):
            raise AssertionError('answer shape %r' % (ans.shape,))
        if not np.isfinite(ans).all():
            raise AssertionError('non-finite logits in an answer')
        direct = pred.run(req)[0]
        worst = max(worst, float(np.abs(ans - direct).max()))
        np.testing.assert_allclose(ans, direct, atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)
    log('[serving] engine answers vs Predictor.run: max abs diff %.3g '
        '(tol %g)' % (worst, KERNEL_TOL))
    # the whole card path (kernel included) against the plain CPU path
    cpu = inference.Predictor(tmp, place=fluid.CPUPlace())
    small = {k: v[:1] for k, v in reqs[0].items()}
    ref = cpu.run(small)[0]
    diff = float(np.abs(answers[0][:1] - ref).max())
    np.testing.assert_allclose(answers[0][:1], ref, atol=CROSS_DEVICE_TOL,
                               rtol=CROSS_DEVICE_TOL)
    log('[serving] card vs CPU on one request row: max abs diff %.3g '
        '(tol %g, |logits| max %.3g)' % (diff, CROSS_DEVICE_TOL,
                                         float(np.abs(ref).max())))
    torch.cuda.synchronize()
    return launches


# -- phase 4 ----------------------------------------------------------------

def build_trainer(dropout=True):
    """get_model at full width in fresh programs; with dropout=False its
    training program without the dropout ops (the same parameter and
    accumulator names), for comparing two devices step for step. Returns
    (main, startup, avg_cost, feed names, train_reader or None)."""
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import transformer as T
    cfg = TRANSFORMER_BASE
    width = dict(max_length=cfg['max_length'], n_layer=cfg['n_layer'],
                 d_model=cfg['d_model'], n_head=cfg['n_head'],
                 d_inner=cfg['d_inner'], warmup_steps=TRAIN_WARMUP)
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    reader = None
    with unique_name.guard(), framework.program_guard(main, startup):
        if dropout:
            avg_cost, _, reader, _, feeds = T.get_model(
                batch_size=TRAIN_BATCH, dict_size=cfg['src_vocab_size'],
                **width)
        else:
            avg_cost, _, feeds = T.training_program(
                cfg['src_vocab_size'], dropout_rate=0.0, **width)
    return main, startup, avg_cost, feeds, reader


def as_feed(batch, names):
    """A padded get_model batch -> {name: [B, T] int64}."""
    return {n: np.stack([row[i] for row in batch])
            for i, n in enumerate(names)}


def grad_names(program):
    ad = [op for op in program.global_block().ops if op.type == 'autodiff']
    return list(ad[0].attrs['grad_names'])


def phase_training():
    import torch
    from paddle_tpu_torch import fluid, ops
    cfg = TRANSFORMER_BASE
    t0 = time.perf_counter()
    main, startup, avg_cost, names, reader = build_trainer()
    scope = fluid.Scope()
    exe = fluid.Executor()                      # the default place: the card
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    it = reader()
    feeds = [as_feed(next(it), names) for _ in range(TRAIN_STEPS)]
    log('[training] built get_model (batch %d, max_length %d, warmup_steps '
        '%d), initialized on the card and read %d wmt16 batches in %.3f s'
        % (TRAIN_BATCH, cfg['max_length'], TRAIN_WARMUP, TRAIN_STEPS,
           time.perf_counter() - t0))

    # the main path: TRAIN_STEPS steps, each ending in its loss fetch
    for k in ops.KERNELS.values():
        k.launches = 0
    losses, step_s = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(loss).reshape(())))
    launches = {n: k.launches for n, k in ops.KERNELS.items()}

    want = ATTENTION_OPS_PER_FORWARD * TRAIN_STEPS
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        if launches[name] != want:
            raise AssertionError(
                '%s launched %d times in %d training steps; the path must '
                'launch it %d times per step' % (
                    name, launches[name], TRAIN_STEPS,
                    ATTENTION_OPS_PER_FORWARD))
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite training loss: %r' % (losses,))
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError('the loss did not fall: %r' % (losses,))
    med = float(np.median(step_s[1:]))
    positions = TRAIN_BATCH * cfg['max_length'] * 2     # source + target
    log('[training] losses %s' % ', '.join('%.4f' % x for x in losses))
    log('[training] step seconds %s' % ', '.join('%.4f' % x
                                                 for x in step_s))
    log('[training] median step (steps 2-%d) %.4f s: %.1f source+target '
        'positions/s; launches per step: %s'
        % (TRAIN_STEPS, med, positions / med,
           {n: v // TRAIN_STEPS for n, v in sorted(launches.items())}))

    _check_grads_against_cpu(initial)
    _serve_trained(main, scope, exe)
    torch.cuda.synchronize()
    return launches


def _check_grads_against_cpu(state):
    """Step 1 of the dropout-free twin program from the startup weights
    `state`, on the card and on the CPU, for a 2-row batch: the loss and
    every @GRAD. The wmt16 corpus starts each target with id 0, also the
    pad id, which leaves the decoder's first query row no live key
    (ill-conditioned everywhere, and the forward kernel only sums that row
    over its diagonal tile): that position gets a live id here."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dataset import wmt16
    from paddle_tpu_torch.models.transformer import pad_batch
    cfg = TRANSFORMER_BASE
    main, _, avg_cost, names, _ = build_trainer(dropout=False)
    rows = itertools.islice(wmt16.train(cfg['src_vocab_size'],
                                        cfg['trg_vocab_size'])(), 2)
    feed = as_feed(pad_batch(list(rows), cfg['max_length']), names)
    feed['trg_word'][:, 0] = 2
    fetch = [avg_cost] + grad_names(main)
    outs = {}
    for where, place in (('card', fluid.CUDAPlace(0)),
                         ('cpu', fluid.CPUPlace())):
        s = fluid.Scope()
        s.load_numpy(state, place)
        outs[where] = fluid.Executor(place).run(main, feed=feed,
                                                fetch_list=fetch, scope=s)
    loss, loss_cpu = float(outs['card'][0]), float(outs['cpu'][0])
    if not abs(loss - loss_cpu) <= CROSS_DEVICE_TOL * abs(loss_cpu):
        raise AssertionError('step-1 loss %r on the card, %r on the CPU'
                             % (loss, loss_cpu))
    errs = []
    for name, g, w in zip(fetch[1:], outs['card'][1:], outs['cpu'][1:]):
        norm = float(np.linalg.norm(w))
        err = float(np.linalg.norm(g - w)) / norm if norm else \
            float(np.abs(g).max())
        errs.append((err, name))
        if not np.isfinite(g).all() or err > GRAD_TOL:
            raise AssertionError('%s on the card differs from the CPU by '
                                 '%.3g of its L2 norm (tol %g)'
                                 % (name, err, GRAD_TOL))
    errs.sort(reverse=True)
    log('[training] step 1 from the startup weights, card vs CPU (2 rows, '
        'dropout off): loss %.6f vs %.6f; %d gradients, |diff| / |grad| '
        '(L2) median %.3g, worst %s (tol %g)'
        % (loss, loss_cpu, len(errs), errs[len(errs) // 2][0],
           ', '.join('%s %.3g' % (n, e) for e, n in errs[:3]), GRAD_TOL))


def _serve_trained(main, scope, exe):
    """The trained program's for_test clone, saved and answered through
    Predictor on the card; one row against the same artifact on the
    CPU."""
    from paddle_tpu_torch import fluid, inference
    cfg = TRANSFORMER_BASE
    test_prog = main.clone(for_test=True)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_train_') as tmp:
        fluid.io.save_inference_model(
            tmp, ['src_word', 'trg_word'], [logits_var(test_prog)], exe,
            main_program=test_prog, scope=scope)
        req = make_requests(1, 2, cfg['max_length'], cfg['trg_vocab_size'],
                            np.random.RandomState(SEED + 1))[0]
        got = inference.Predictor(tmp).run(req)[0]
        rows = req['src_word'].shape[0]
        if got.shape != (rows, cfg['max_length'], cfg['trg_vocab_size']) \
                or not np.isfinite(got).all():
            raise AssertionError('trained model answered %r' % (got.shape,))
        ref = inference.Predictor(tmp, place=fluid.CPUPlace()).run(
            {k: v[:1] for k, v in req.items()})[0]
    np.testing.assert_allclose(got[:1], ref, atol=CROSS_DEVICE_TOL,
                               rtol=CROSS_DEVICE_TOL)
    log('[training] the trained model served %d row(s) through Predictor on '
        'the card; card vs CPU on one row: max abs diff %.3g (tol %g)'
        % (rows, float(np.abs(got[:1] - ref).max()), CROSS_DEVICE_TOL))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    from paddle_tpu_torch import ops
    log('[env] python %s, torch %s, CUDA %s, %d card(s): %s'
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.device_count(), torch.cuda.get_device_name(0)))
    phase_build()
    cases = phase_kernels()
    by_path = {'serving': phase_serving(), 'training': phase_training()}
    if 'jax' in sys.modules or any(
            m == 'paddle_tpu' or m.startswith('paddle_tpu.')
            for m in sys.modules):
        raise AssertionError('the smoke run imported JAX or the JAX package')
    kernels = []
    for name, k in sorted(ops.KERNELS.items()):
        rs = cases[name]
        head = rs[0]
        paths = {p: n[name] for p, n in by_path.items() if n[name]}
        if not paths:
            raise AssertionError('%s was launched on no main path' % name)
        kernels.append(dict(
            name=name, route='cuda', source='paddle_tpu_torch/' + k.source,
            replaces=k.replaces, launches=sum(paths.values()),
            launches_by_path=paths,
            max_abs_err=max(r['max_abs_err'] for r in rs),
            ms=head['ms'], plain_ms=head['plain_ms'],
            bound_ms=head['bound_ms'], bound_by=head['bound_by'],
            library_ms=head['library_ms'], shape=head['shape_B_H_Tq_Tk_D'],
            **({'backward_pair': head['backward_pair']}
               if 'backward_pair' in head else {}),
            cases=rs))
    log(json.dumps({'kernels': kernels}))
    log(nvidia_smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
