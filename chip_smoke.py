#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It imports nothing of JAX or of the JAX package.

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. build   — compile every hand-written kernel of the port from the
               sources in the checkout (one nvcc per source, all started
               together); print the build time, ptxas' resource lines and
               the card's name and power limit.
  2. kernels — each kernel's wrapper against its plain torch version on
               the card, at the shapes the serving path gives it, within a
               stated tolerance; time kernel, plain version and the
               PyTorch library call computing the same function.
  3. serving — full-width Transformer-base (6+6 layers, d_model 512, 8
               heads, d_inner 2048, vocab 10000, max_length 256) built
               with the port's layers, initialized on the card from a seed,
               saved with save_inference_model, loaded by Predictor (the
               default place: the card) behind a ServingEngine that answers
               concurrent requests. Every answer is checked against
               Predictor.run on the same rows, one against the same
               artifact run on the CPU, and the kernel launch counts
               against what the path must launch.
  4. a JSON line {"kernels": [...]} with each kernel's parity, launches,
     times and bound; then the card's name and power limit; then the last
     line {"ok": true, "device": {...}}.
"""
import concurrent.futures
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
# the same artifact on the card and on the CPU: 12 layers of fp32 products
# and reductions summed in different orders on two devices
CROSS_DEVICE_TOL = 1e-3

TRANSFORMER_BASE = dict(src_vocab_size=10000, trg_vocab_size=10000,
                        max_length=256, n_layer=6, d_model=512, n_head=8,
                        d_inner=2048)
ATTENTION_OPS_PER_FORWARD = 18   # 6 encoder self, 6 decoder causal, 6 cross


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 ----------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch import ops
    t0 = time.perf_counter()
    logs = ops.build_all()
    secs = time.perf_counter() - t0
    log('[build] %d kernel(s) built in %.3f s: %s'
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


def _attention_bound(B, H, Tq, Tk, D, causal):
    """Least time for the work this call needs: FLOPs of the keys each
    query row attends to (the kernel skips tiles above the diagonal) and
    the bytes of q, k, v, bias read once and O, lse written once."""
    if causal:
        keys = sum(min(i + 1, Tk) for i in range(Tq))
    else:
        keys = Tq * Tk
    flops = 4.0 * B * H * D * keys
    nbytes = 4.0 * (B * H * Tq * D * 2 + B * H * Tk * D * 2 + B * Tk
                    + B * H * Tq)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import (
        NEG_BIG, flash_attention_lse, flash_attention_lse_plain)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    B, H, T, D = 8, 8, 256, 64
    cases = [
        _attention_case('encoder self, pad bias', B, H, T, T, D, False, gen),
        _attention_case('decoder self, causal', B, H, T, T, D, True, gen),
        _attention_case('cross, Tq != Tk', B, H, T, 160, D, False, gen),
        _attention_case('ragged T=200, causal', B, H, 200, 200, D, True,
                        gen),
    ]
    results = []
    for c in cases:
        args = (c['q'], c['k'], c['v'])
        kw = dict(key_bias=c['bias'], causal=c['causal'],
                  sm_scale=c['scale'])
        o, lse = flash_attention_lse(*args, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_lse_plain(*args, **kw)
        err = max((o - o_ref).abs().max().item(),
                  (lse - lse_ref).abs().max().item())
        ok = (torch.allclose(o, o_ref, atol=KERNEL_TOL, rtol=KERNEL_TOL)
              and torch.allclose(lse, lse_ref, atol=KERNEL_TOL,
                                 rtol=KERNEL_TOL))
        Bq, Hq, Tq, Tk, Dq = c['shape']
        mask = c['bias'][:, None, None, :].expand(Bq, 1, Tq, Tk)
        if c['causal']:
            tri = torch.ones((Tq, Tk), dtype=torch.bool,
                             device='cuda').tril()
            mask = mask.masked_fill(~tri, NEG_BIG)
        mask = mask.contiguous()
        ms = time_ms(lambda: flash_attention_lse(*args, **kw))
        plain_ms = time_ms(lambda: flash_attention_lse_plain(*args, **kw))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *args, attn_mask=mask, scale=c['scale']))
        bound_ms, bound_by = _attention_bound(Bq, Hq, Tq, Tk, Dq,
                                              c['causal'])
        r = dict(case=c['name'], shape_B_H_Tq_Tk_D=c['shape'],
                 causal=c['causal'], max_abs_err=err, ok=ok, ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                 bound_by=bound_by)
        log('[kernels] flash_attention_fwd %s' % json.dumps(r))
        results.append(r)
    bad = [r['case'] for r in results if not r['ok']]
    if bad:
        raise AssertionError('flash_attention_fwd disagrees with its plain '
                             'version beyond %g in: %s' % (KERNEL_TOL, bad))
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
    launches = phase_serving()
    if 'jax' in sys.modules or any(
            m == 'paddle_tpu' or m.startswith('paddle_tpu.')
            for m in sys.modules):
        raise AssertionError('the smoke run imported JAX or the JAX package')
    head = cases[0]
    kernels = []
    for name, k in sorted(ops.KERNELS.items()):
        kernels.append(dict(
            name=name, route='cuda', source='paddle_tpu_torch/' + k.source,
            replaces=k.replaces, launches=launches[name],
            max_abs_err=max(c['max_abs_err'] for c in cases),
            ms=head['ms'], plain_ms=head['plain_ms'],
            bound_ms=head['bound_ms'], bound_by=head['bound_by'],
            library_ms=head['library_ms'], shape=head['shape_B_H_Tq_Tk_D'],
            cases=cases))
    log(json.dumps({'kernels': kernels}))
    log(nvidia_smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
