#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving paths, on one card.

    python3 tools/torch_serving_profile.py [--batch 16 1] [--runs 5]
                                           [--bf16]
    python3 tools/torch_serving_profile.py --model decode [--runs 3]

Each path is measured two ways, side by side: `captured`, as users call
it (on the card a replay of the step's captured CUDA graph), and `eager`,
the same step artifact's eager walk (StepArtifact.debug_step, its fetches
copied to the host through pinned memory as Executor.run copies them).

--model transformer (the default) builds full-width Transformer-base with
the port (the artifact chip_smoke.py serves), loads it with Predictor on
CUDAPlace(0), and for each batch size times Predictor.run on the host
clock (each run ends in its device-to-host fetch, so the wall time is the
request's) and traces the same runs with torch.profiler: device time by
kernel, grouped into classes (matmul, flash attention, elementwise/
normalization, copies), and the device's idle share of the wall time.
Prints one JSON line per batch size. --bf16 transpiles the loaded
artifact with fluid.contrib.Float16Transpiler in the Predictor's scope
(bf16 weights, AMP, fp32 fetches), as chip_smoke.py's amp phase serves it.

--model decode builds chip_smoke.py's phase 6 engine (the paged
DecodeEngine at the machine_translation decoder's full width) on the card,
fills all 16 slots with requests of the longest limit, then holds the
decode loop and runs `--runs` dispatches itself as the loop runs them (the
step, then the one host sync of the slots' active flags and step counts):
first timed on the host clock, then traced. Device ms per dispatch by
class (matmul, top-k sort, paged_attention, elementwise and gathers,
copies), the busy time and the idle share of the traced dispatches. One
JSON line. Both modes are timed before either is traced.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (builds the artifact it serves)


def _kernel_class(name):
    """The Transformer forward's classes."""
    n = name.lower()
    if 'fwd_bf16_kernel' in n:
        return 'flash_attention_fwd_bf16'
    if 'flash_attention' in n or 'fwd_kernel' in n:
        return 'flash_attention_fwd'
    # cuBLAS's Hopper GEMMs (bf16 among them) are named nvjet_*
    if 'gemm' in n or 'sgemm' in n or 'cutlass' in n or 'xmma' in n \
            or 'nvjet' in n:
        return 'matmul'
    if 'memcpy' in n:
        return 'copy'
    return 'elementwise/norm/other'


def _decode_class(name):
    """The decode step's classes: its sort and its gathers have their
    own, and memsets count as copies."""
    n = name.lower()
    if 'paged_attention' in n:
        return 'paged_attention'
    if 'gemm' in n or 'sgemm' in n or 'cutlass' in n or 'xmma' in n:
        return 'matmul'
    if 'memcpy' in n or 'memset' in n:
        return 'copy'
    if 'sort' in n or 'radix' in n:
        return 'top-k sort'
    return 'elementwise/gather/other'


def profile_modes(modes, runs, classify=_kernel_class):
    """{mode: profile_runs(...)} over [(mode, run)]: every mode timed on
    the host clock before any is traced (a trace leaves the profiler's
    hooks behind)."""
    walls = {mode: time_runs(run, runs) for mode, run in modes}
    return {mode: dict(wall_ms_per_run=walls[mode],
                       median_wall_ms=float(np.median(walls[mode])),
                       **profile_runs(run, runs, classify))
            for mode, run in modes}


def time_runs(run, runs):
    """Host ms of `runs` calls of run() (each ends in a host sync), after
    two untimed ones."""
    import torch
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def profile_runs(run, runs, classify=_kernel_class):
    """Trace `runs` calls of run() with torch.profiler: device time by
    class and by kernel, busy time and idle share, per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    classes, kernels, n_device = {}, {}, 0
    for evt in prof.events():
        # device-side records only (kernels, memcpys): the host ops that
        # launched them carry the same time again in their totals, and so
        # do the ops' projections onto the device timeline (user
        # annotations such as `aten::copy_`, `aten::mm`)
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.is_user_annotation:
            continue
        dev_us = evt.time_range.elapsed_us()
        n_device += 1
        kernels[evt.name] = kernels.get(evt.name, 0.0) + dev_us
        c = classify(evt.name)
        classes[c] = classes.get(c, 0.0) + dev_us
    busy_s = sum(classes.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {
        'traced_wall_ms_per_run': traced_wall * 1e3 / runs,
        'device_busy_ms_per_run': busy_s * 1e3 / runs,
        'device_idle_share': 1.0 - busy_s / traced_wall,
        'device_ms_per_run_by_class': {
            k: v / 1e3 / runs for k, v in sorted(classes.items())},
        'device_records_per_run': n_device / runs,
        'top_kernels_ms_per_run': [[k[:90], v / 1e3 / runs]
                                   for k, v in top],
    }


def profile_decode(card, runs):
    """chip_smoke.py's phase 6 engine with all slots decoding: `runs`
    dispatches timed, then traced, from this thread while it holds the
    decode loop off (the engine's handle lock)."""
    import torch
    from paddle_tpu_torch import serving
    cfg = chip_smoke.DECODE_CONFIG
    eng = serving.DecodeEngine(chip_smoke.mt_decoder_weights(),
                               serving.DecodeConfig(**cfg))
    reqs = chip_smoke.decode_requests()[:cfg['slots']]
    try:
        eng.warmup()
        futs = [eng.submit({'enc': e}, max_new_tokens=cfg['max_len'])
                for e, _ in reqs]
        t_end = time.monotonic() + 600
        while eng.stats['joins'] < cfg['slots']:
            if time.monotonic() > t_end:
                raise SystemExit('torch_serving_profile: the requests did '
                                 'not join (%r)' % (eng.stats,))
            time.sleep(0.001)
        with eng._handle_lock:
            if eng.stats['slots_occupied'] != cfg['slots']:
                raise SystemExit('torch_serving_profile: the slots did not '
                                 'fill (%r)' % (eng.stats,))
            handle = eng._acquire()
            art = handle._compiled
            state = {n: t.clone() for n, t in handle.state.items()}
            gen = torch.Generator(device='cuda')

            def dispatch(step):
                # what one turn of the decode loop runs: the step, then
                # one host copy of the active flags and step counts
                active, _, _, _, steps = step()
                torch.stack([active.to(torch.int32), steps]).cpu()

            r = profile_modes(
                [('captured', lambda: dispatch(handle.step)),
                 ('eager', lambda: dispatch(lambda: art.debug_step(
                     state, {}, 0, generator=gen)[0]))], runs, _decode_class)
            # 2 warm + runs timed + runs traced dispatches: every slot
            # must still be decoding (none reached max_len)
            live = int(handle.state['cbd_active'].sum())
            if live != cfg['slots']:
                raise SystemExit('torch_serving_profile: a slot finished '
                                 'inside the profiled dispatches')
        for f in futs:
            f.result(timeout=600)
    finally:
        eng.shutdown()
    return dict(card=card, model='decode', config=cfg,
                decoder=chip_smoke.MT_DECODER, slots_active=cfg['slots'],
                dispatches=runs, cache_stats=eng._exe.cache_stats, **r)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', choices=('transformer', 'decode'),
                    default='transformer')
    ap.add_argument('--batch', type=int, nargs='+', default=[16, 1])
    ap.add_argument('--bf16', action='store_true',
                    help='serve the artifact transpiled to bf16')
    ap.add_argument('--runs', type=int, default=None,
                    help='runs per batch size (default 5) or dispatches '
                    '(default 3)')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_serving_profile: needs a CUDA card')
    from paddle_tpu_torch import fluid, inference
    card = chip_smoke.nvidia_smi_line()
    if args.model == 'decode':
        print(json.dumps(profile_decode(card, args.runs or 3)), flush=True)
        return
    cfg = chip_smoke.TRANSFORMER_BASE
    with tempfile.TemporaryDirectory(prefix='torch_serving_profile_') as tmp:
        chip_smoke.build_artifact(tmp, cfg, fluid.CUDAPlace(0))
        pred = chip_smoke.transpiled_predictor(tmp) if args.bf16 \
            else inference.Predictor(tmp)
    rng = np.random.RandomState(chip_smoke.SEED)
    exe, scope = pred._exe, pred._scope
    gen = torch.Generator(device='cuda')
    for b in args.batch:
        reqs = chip_smoke.make_requests(1, 1, cfg['max_length'],
                                        cfg['trg_vocab_size'], rng)[0]
        feed = {n: np.repeat(a, b, axis=0) for n, a in reqs.items()}
        art = exe.step_artifact(pred._program, feed=feed,
                                fetch_list=pred._fetch_vars, scope=scope)
        state = art.state_dict(scope)
        dev = {n: torch.from_numpy(v).cuda() for n, v in feed.items()}

        def eager():
            chip_smoke._to_host(art.debug_step(state, dev, 0,
                                               generator=gen)[0])

        r = dict(card=card, batch=b, max_length=cfg['max_length'],
                 bf16=args.bf16,
                 **profile_modes([('captured', lambda: pred.run(feed)),
                                  ('eager', eager)], args.runs or 5))
        r['cache_stats'] = exe.cache_stats
        print(json.dumps(r), flush=True)


if __name__ == '__main__':
    main()
