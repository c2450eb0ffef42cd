#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving forward, on one card.

    python3 tools/torch_serving_profile.py [--batch 16 1] [--runs 5]

Builds full-width Transformer-base with the port (the artifact
chip_smoke.py serves), loads it with Predictor on CUDAPlace(0), and for
each batch size times Predictor.run on the host clock (each run ends in
its device-to-host fetch, so the wall time is the request's) and traces
the same runs with torch.profiler: device time by kernel, grouped into
classes (matmul, flash attention, elementwise/normalization, copies), and
the device's idle share of the wall time. Prints one JSON line per batch
size.
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
    n = name.lower()
    if 'flash_attention' in n or 'fwd_kernel' in n:
        return 'flash_attention_fwd'
    if 'gemm' in n or 'sgemm' in n or 'cutlass' in n or 'xmma' in n:
        return 'matmul'
    if 'memcpy' in n:
        return 'copy'
    return 'elementwise/norm/other'


def profile_batch(pred, feed, runs):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        pred.run(feed)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        pred.run(feed)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            pred.run(feed)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    classes, kernels = {}, {}
    for evt in prof.events():
        # device-side records only (kernels, memcpys): the host ops that
        # launched them carry the same time again in their totals, and so
        # do the ops' projections onto the device timeline (user
        # annotations such as `aten::copy_`, `aten::mm`)
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.is_user_annotation:
            continue
        dev_us = evt.time_range.elapsed_us()
        kernels[evt.name] = kernels.get(evt.name, 0.0) + dev_us
        c = _kernel_class(evt.name)
        classes[c] = classes.get(c, 0.0) + dev_us
    busy_s = sum(classes.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {
        'wall_ms_per_run': [w * 1e3 for w in walls],
        'traced_wall_ms_per_run': traced_wall * 1e3 / runs,
        'device_busy_ms_per_run': busy_s * 1e3 / runs,
        'device_idle_share': 1.0 - busy_s / traced_wall,
        'device_ms_per_run_by_class': {
            k: v / 1e3 / runs for k, v in sorted(classes.items())},
        'top_kernels_ms_per_run': [[k[:90], v / 1e3 / runs]
                                   for k, v in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, nargs='+', default=[16, 1])
    ap.add_argument('--runs', type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_serving_profile: needs a CUDA card')
    from paddle_tpu_torch import fluid, inference
    card = chip_smoke.nvidia_smi_line()
    cfg = chip_smoke.TRANSFORMER_BASE
    with tempfile.TemporaryDirectory(prefix='torch_serving_profile_') as tmp:
        chip_smoke.build_artifact(tmp, cfg, fluid.CUDAPlace(0))
        pred = inference.Predictor(tmp)
    rng = np.random.RandomState(chip_smoke.SEED)
    for b in args.batch:
        reqs = chip_smoke.make_requests(1, 1, cfg['max_length'],
                                        cfg['trg_vocab_size'], rng)[0]
        feed = {n: np.repeat(a, b, axis=0) for n, a in reqs.items()}
        r = dict(card=card, batch=b, max_length=cfg['max_length'],
                 **profile_batch(pred, feed, args.runs))
        print(json.dumps(r), flush=True)


if __name__ == '__main__':
    main()
