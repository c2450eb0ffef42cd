#!/usr/bin/env python3
"""Time the attention kernels of one or more checkouts on one card, in
turns, with chip_smoke.py's own cases and timing.

    python3 tools/torch_attention_bench.py
        [--cases flash|flash-bf16|paged|sparse]
        [--head-dim D] [--paged-n N] [ROOT ...]

Each ROOT is the root of a checkout of the repo (default: this one). For
the roots in the order given and then in reverse (A B B A), a fresh process
puts that ROOT's paddle_tpu_torch first on its path, builds its kernels
(chip_smoke.phase_build: ptxas' resource lines and the bf16 attention
kernels' SASS counts; spills are reported in the run's line, not fatal,
since an older checkout may have them) and
runs one set of chip_smoke's phase-2 cases: `flash` (the default),
chip_smoke._attention_cases, the forward and the backward pair against
their plain versions at B=16, H=8, T=256, D=64 in the four cases, timed by
CUDA graph replay beside SDPA; `flash-bf16`, the same with the bf16
kernels (AMP's) on the same draws rounded to bf16 (`--head-dim D` runs
both at another head dim, D padded to 64 or 128 inside the bf16
kernels); `paged`,
chip_smoke._paged_attention_cases, the paged decode attention against its
plain version in its six cases, timed by CUDA graph replay beside SDPA over
gathered rows; `sparse`,
chip_smoke._sparse_optim_cases and _sparse_rows_cases, sparse_adam and
sparse_adagrad in their four merged-form cases and five rows-form cases
(the rows-form route against the parent's _merge_sparse route and the
sorts alone, by graph replay; a checkout without the rows form gets the
parent's route and the sorts only), with each route's device kernels
counted. The
chip_smoke.py used is always THIS checkout's, so every root is timed by
the same code. Prints one JSON line per run, then a summary line: per root
and case, the median over the root's runs of each time, the largest error,
whether every launch pair was bitwise equal, and (flash cases) whether
each root's outputs are bitwise those of the first root. `--paged-n N`
times the paged kernel with clusters of N blocks in every case that can
take them (the slices and the chunk follow from N), to hold launch_plan's
choice against others; a checkout whose wrapper has no launch_plan
ignores it.
Needs one card.
"""
import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def force_cluster(pa, n):
    """Make pa.launch_plan take clusters of n blocks where D gives every
    block columns and the blocks fit the shared memory."""
    chosen = pa.launch_plan

    def plan(slots, D, beam, src_cap, sms=pa._SMS):
        p = chosen(slots, D, beam, src_cap, sms)
        width = pa.slice_width(D, n)
        chunk = pa._chunk(n, width, p.group, src_cap)
        if (n - 1) * width >= D or chunk is None:
            return p
        chunks = -(-src_cap // chunk)
        return p._replace(n=n, width=width, chunk=chunk, chunks=chunks,
                          col_parts=pa.col_parts(p.group, chunk),
                          smem=pa.smem_bytes(n, width, chunk, p.group,
                                             chunks))
    pa.launch_plan = plan


def worker(root, cases, paged_n=None, head_dim=64):
    """Build ROOT's kernels and time its `cases` (flash, flash-bf16,
    paged or sparse; the flash cases at head dim `head_dim`); prints one
    JSON line."""
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_attention_bench: no CUDA device')
    import paddle_tpu_torch
    where = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
    if os.path.dirname(where) != os.path.abspath(root):
        raise SystemExit('imported paddle_tpu_torch from %s, not %s'
                         % (where, root))
    cs = load_chip_smoke()
    spills = cs.phase_build(strict=False)
    pa = importlib.import_module(
        'paddle_tpu_torch.ops.kernels.paged_attention')
    if paged_n and hasattr(pa, 'launch_plan'):
        force_cluster(pa, paged_n)
    if cases == 'paged':
        results = {'paged_attention': cs._paged_attention_cases()}
    elif cases == 'sparse':
        results = cs._sparse_optim_cases()
        for name, rs in cs._sparse_rows_cases().items():
            results[name].extend(rs)
    else:
        results = cs._attention_cases(bf16=cases == 'flash-bf16',
                                      D=head_dim)
    rows = []
    for name, rs in sorted(results.items()):
        for r in rs:
            row = dict(kernel=name, case=r['case'])
            for key, value in r.items():
                if key in ('ok', 'deterministic', 'max_abs_err', 'digest') \
                        or key.endswith('ms'):
                    row[key] = value
                elif key.endswith('_kernels') and isinstance(value, dict):
                    # a route's device kernels: their launches in all
                    row['n_' + key] = sum(value.values())
            if name.startswith('flash_attention_bwd_dq'):
                pair = r['backward_pair']
                row['pair_ms'] = pair['ms']
                row['pair_library_ms'] = pair['library_ms']
            rows.append(row)
    print(json.dumps({'root': root, 'card': cs.nvidia_smi_line(),
                      'spills': spills, 'rows': rows}), flush=True)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('roots', nargs='*', default=[HERE])
    ap.add_argument('--cases', choices=('flash', 'flash-bf16', 'paged',
                                        'sparse'),
                    default='flash')
    ap.add_argument('--paged-n', type=int, choices=(1, 2, 4, 8))
    ap.add_argument('--head-dim', type=int, default=64)
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.cases, args.paged_n, args.head_dim)
        return
    roots = [os.path.abspath(r) for r in args.roots]
    runs = []
    for root in roots + roots[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), '--cases',
               args.cases, '--head-dim', str(args.head_dim), '--worker',
               root]
        if args.paged_n:
            cmd += ['--paged-n', str(args.paged_n)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        for line in out.stdout.splitlines():
            print(line, flush=True)
        if out.returncode != 0:
            raise SystemExit('worker for %s failed (rc %d)'
                             % (root, out.returncode))
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    summary = {}
    for root in roots:
        mine = [r for r in runs if r['root'] == root]
        by = {}
        for run in mine:
            for row in run['rows']:
                by.setdefault((row['kernel'], row['case']), []).append(row)
        cases = []
        for (kernel, case), rows in sorted(by.items()):
            entry = dict(kernel=kernel, case=case)
            for key, value in sorted(rows[0].items()):
                if key in ('ok', 'deterministic'):
                    entry[key] = all(r[key] for r in rows)
                elif key == 'max_abs_err':
                    entry[key] = max(r[key] for r in rows)
                elif key == 'digest':
                    entry[key] = sorted({r[key] for r in rows})
                elif key.endswith('ms') and value is not None:
                    entry[key] = _median([r[key] for r in rows])
                elif key.startswith('n_'):
                    # device kernels counted in each run (a profile that
                    # caught nothing shows as 0)
                    entry[key] = [r[key] for r in rows]
            cases.append(entry)
        summary[root] = dict(card=mine[0]['card'], runs=len(mine),
                             spills=mine[0]['spills'], cases=cases)
    # per kernel and case: the roots whose outputs are bitwise those of
    # the first root (the same draws on the same card)
    first = {(c['kernel'], c['case']): c.get('digest')
             for c in summary[roots[0]]['cases']}
    same = {}
    for root in roots[1:]:
        for c in summary[root]['cases']:
            key = '%s / %s' % (c['kernel'], c['case'])
            if c.get('digest') is not None:
                same.setdefault(key, {})[root] = \
                    c['digest'] == first.get((c['kernel'], c['case']))
    print(json.dumps({'summary': summary,
                      'bitwise_as_first_root': same}), flush=True)


if __name__ == '__main__':
    main()
