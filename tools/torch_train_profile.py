#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one card.

    python3 tools/torch_train_profile.py [--batch 16] [--steps 20]

Builds full-width Transformer-base with models.transformer.get_model (its
defaults: 6+6 layers, d_model 512, 8 heads, d_inner 2048, vocab 10000;
noam_decay, Adam, dropout 0.1) at max_length 256 and warmup_steps 200, as
chip_smoke.py trains it, initializes it on CUDAPlace(0) from a seed and
trains it on its wmt16 reader.
It times each step on the host clock (each step ends in its loss fetch),
then traces a few more with torch.profiler: device time by class (matmul,
the flash-attention forward and backward kernels, the optimizer update,
other elementwise/normalization kernels, copies) and the device's idle
share, both of the traced wall time (the profiler slows the host's op
walk) and of the untraced median step. The optimizer's device time is that
of the kernels launched inside the Executor's `executor.update` range.
Prints one JSON line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 2024
MAX_LENGTH = 256
WARMUP_STEPS = 200
PROFILE_STEPS = 3
CLASSES = ('matmul', 'flash_attention_fwd', 'flash_attention_bwd_dq',
           'flash_attention_bwd_dkv', 'optimizer', 'elementwise/norm/other',
           'copy')


def _kernel_class(name):
    n = name.lower()
    if 'bwd_dq_kernel' in n:
        return 'flash_attention_bwd_dq'
    if 'bwd_dkv_kernel' in n:
        return 'flash_attention_bwd_dkv'
    if 'fwd_kernel' in n:
        return 'flash_attention_fwd'
    if 'gemm' in n or 'cutlass' in n or 'xmma' in n:
        return 'matmul'
    if 'memcpy' in n or 'memset' in n:
        return 'copy'
    return 'elementwise/norm/other'


def profile_steps(exe, main, scope, avg_cost, feeds):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for feed in feeds:
            exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    classes = dict.fromkeys(CLASSES, 0.0)
    update_us = 0.0
    for evt in prof.events():
        if evt.name == 'executor.update' \
                and evt.device_type != torch.autograd.DeviceType.CUDA:
            update_us += evt.device_time_total
            continue
        # device-side records only (kernels, memcpys): the host ops that
        # launched them carry the same time again in their totals, and so
        # do the ops' projections onto the device timeline
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.is_user_annotation:
            continue
        classes[_kernel_class(evt.name)] += evt.time_range.elapsed_us()
    # the update's kernels are elementwise: move their time to its class
    classes['optimizer'] = update_us
    classes['elementwise/norm/other'] -= update_us
    n = len(feeds)
    busy_s = sum(classes.values()) / 1e6
    attention_us = sum(v for k, v in classes.items()
                       if k.startswith('flash_attention'))
    return {
        'traced_wall_ms_per_step': traced_wall * 1e3 / n,
        'device_busy_ms_per_step': busy_s * 1e3 / n,
        'device_idle_share': 1.0 - busy_s / traced_wall,
        'attention_share_of_device_time': attention_us / 1e6 / busy_s,
        'attention_share_of_step': attention_us / 1e6 / traced_wall,
        'device_ms_per_step_by_class': {k: v / 1e3 / n
                                        for k, v in classes.items()},
    }


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--steps', type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_train_profile: needs a CUDA card')
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import transformer
    main_prog, startup = framework.Program(), framework.Program()
    main_prog.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main_prog, startup):
        avg_cost, _, reader, _, names = transformer.get_model(
            batch_size=args.batch, max_length=MAX_LENGTH,
            warmup_steps=WARMUP_STEPS)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    it = reader()
    feeds = [{n: np.stack([row[i] for row in batch])
              for i, n in enumerate(names)}
             for batch in (next(it)
                           for _ in range(args.steps + PROFILE_STEPS))]
    step_s, losses = [], []
    for feed in feeds[:args.steps]:
        t0 = time.perf_counter()
        loss, = exe.run(main_prog, feed=feed, fetch_list=[avg_cost],
                        scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(loss).reshape(())))
    med = float(np.median(step_s[1:]))
    positions = args.batch * MAX_LENGTH * 2      # source + target
    torch.cuda.reset_peak_memory_stats()
    prof = profile_steps(exe, main_prog, scope, avg_cost,
                         feeds[args.steps:])
    r = dict(card=card_line(), batch=args.batch,
             max_length=MAX_LENGTH, steps=args.steps,
             step_s=step_s, median_step_s=med,
             source_target_positions_per_s=positions / med,
             losses=losses,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             profiled_steps=PROFILE_STEPS,
             device_idle_share_of_median_step=(
                 1.0 - prof['device_busy_ms_per_step'] / 1e3 / med),
             **prof)
    print(json.dumps(r), flush=True)


if __name__ == '__main__':
    main()
