#!/usr/bin/env python3
"""The card's rate for the warp-level tensor-core instructions the port's
attention kernels are built on, measured.

    python3 tools/torch_mma_peak.py

Builds tools/mma_peak.cu with nvcc for sm_90a (the port's flags) into
paddle_tpu_torch/build/, then times back-to-back mma.sync instructions with
fixed operands over a full grid: m16n8k8 tf32 (what csrc/tf32_mma.cuh
issues; 3xTF32 needs three per fp32-accurate product) and m16n8k16 bf16
for comparison, at 4 and 8 independent accumulators a warp and 4 to 16
warps an SM. Prints one JSON line: each configuration's TFLOP/s, the
largest per instruction, and the card's name and power limit. The data
sheet's dense peaks (495 TF32, 989 bf16) are for wgmma; this says what
mma.sync reaches. Needs one card.
"""
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_mma_peak: no CUDA device')
    from paddle_tpu_torch.ops import _cuda
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'mma_peak.cu')
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_cuda.BUILD_DIR, 'libmma_peak.so')
    subprocess.run([_cuda.nvcc_path()] + list(_cuda.NVCC_FLAGS)
                   + ['-o', lib_path, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    fn = lib.mma_peak_tflops
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_double
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for kind, name in ((0, 'mma.sync.m16n8k8 tf32'),
                       (1, 'mma.sync.m16n8k16 bf16')):
        for chains in (4, 8):
            for warps_per_sm in (4, 8, 16):
                threads = 128
                blocks = sms * warps_per_sm // 4
                tflops = fn(kind, chains, blocks, threads, 20000)
                if tflops < 0:
                    raise SystemExit('mma_peak failed (%g)' % tflops)
                rows.append(dict(instruction=name, chains=chains,
                                 warps_per_sm=warps_per_sm, tflops=tflops))
    best = {}
    for r in rows:
        best[r['instruction']] = max(best.get(r['instruction'], 0.0),
                                     r['tflops'])
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({'mma_peak': rows, 'best_tflops': best, 'sms': sms,
                      'card': card}), flush=True)


if __name__ == '__main__':
    main()
