"""fluid.passes — Program -> Program optimization ahead of execution.

Parity: the JAX package's fluid/passes (optimize :234, PassReport, the
purity proofs :106-143, OP_SEQ_ATTR :73, opt_mode :79). Every execution
path of the port — `Executor.run`, `run_bundle`, `StepHandle.step`, the
Predictor and the serving engines — builds its step artifact through
`Executor._prepare`, so a pipeline of Program -> Program transforms
applied there reaches all of them at once. On the card a step is a
captured CUDA graph whose replay costs its kernel count, so what a pass
removes is launches per replay, not host time.

Passes:

  amp   — AMP as an IR rewrite (amp_pass.py): explicit `cast` ops around
          the mul / matmul / conv2d / flash_attention operands that
          `lowering.amp_cast` casts inside the rules; the rewritten
          program (`_amp_ir`) runs with `ctx.amp` off, and its bf16
          operands reach the bf16 kernels by their dtype.
  quant — int8 weight quantization as explicit quantize / dequantize ops
          (quant_pass.py), armed by `quant_pass.mark_quant`.
  fold  — constant folding (fold.py): ops whose inputs are all constants
          are evaluated through their own rules, on the executor's
          device, and replaced by `assign_value`.
  cse   — common subexpression elimination over the top-level block
          (cse.py), pure ops only.
  dce   — dead-op elimination (dce.py) by `analysis.live_mask`.

Equivalence: DCE, CSE and folding are bit-exact against the unoptimized
program. The JAX package keeps a random op's stream where DCE removes
another op by stamping `op_seq` (each random rule folds it into its key);
the port's random rules draw one after another from the executor's
torch.Generator, which a captured graph registers, so DCE keeps every op
whose rule draws from it (dce.py; ROADMAP.md Queue C). The AMP rewrite
is within one bf16 rounding of each rewritten op's output against
runtime AMP.

Wiring: `PADDLE_TPU_OPT={off,default,aggressive}` gates the executor,
once per step-artifact cache key; a program marked by `mark_quant` is
optimized at every level. `Program.optimize()` is the manual surface.
Telemetry: each pass runs under a `passes.<name>` span and bumps its
`passes.<name>.*` counters; the pipeline records a `passes.optimize` span
with the op counts before and after, which obs/report.py's "optimizer
passes" section reads, and the executor emits `passes.error` when it
falls back to the unoptimized program.
"""
import functools
import inspect
import os
import types

from ... import obs
from .. import lowering
from ..analysis.dataflow import sub_block_indices

from .memplan import MemoryPlan, memory_plan, executor_write_set  # noqa: F401

__all__ = ['optimize', 'opt_mode', 'is_pure', 'is_foldable', 'uses_rng',
           'PassReport', 'written_names', 'write_counts', 'MemoryPlan',
           'memory_plan', 'executor_write_set', 'ENV_OPT', 'LEVELS',
           'OP_SEQ_ATTR']

# PADDLE_TPU_OPT wires optimize() into Executor._prepare, once per
# step-artifact cache key:
#   off        (default) — run the program exactly as built;
#   default    — amp rewrite, constant folding, CSE, DCE (bit-exact or
#                documented-tolerance transforms only);
#   aggressive — the same passes with a larger constant-folding budget.
ENV_OPT = 'PADDLE_TPU_OPT'
LEVELS = ('off', 'default', 'aggressive')

# Original top-level op index, stamped on every op of the optimized clone
# before any structural change (the JAX package's random rules derive
# their stream from it; the port keeps it for parity and provenance).
OP_SEQ_ATTR = 'op_seq'

_C_PROGRAMS = obs.counter('passes.programs_optimized')
_C_REMOVED = obs.counter('passes.ops_removed')


def opt_mode():
    v = os.environ.get(ENV_OPT, 'off').strip().lower()
    if v in ('', '0', 'off', 'false', 'no', 'none'):
        return 'off'
    if v in ('default', '1', 'on', 'true'):
        return 'default'
    if v == 'aggressive':
        return 'aggressive'
    raise ValueError(
        '%s must be one of off|default|aggressive, got %r' % (ENV_OPT, v))


# -- purity ------------------------------------------------------------------
# A pass may only touch ops it can PROVE are pure functions of their
# inputs. The proof is mechanical, from the rule's source: the op has a
# plain rule (no block rule, no sub-blocks), and neither the rule nor any
# function of the port it calls by name draws from the executor's
# generator (the port's random rules pass `generator=ctx.generator` to a
# torch draw, some through a helper such as tensor_ops._uniform). Folding
# is stricter: the rule must not read the run's context (the test flag,
# AMP, a loop's predicate), because folding evaluates it outside the step.

_EFFECTFUL = frozenset(['print', 'autodiff', 'py_func'])
_PORT = __name__.split('.')[0]


def _called_functions(code, namespace):
    """The functions of the port a code object names (its globals and
    attributes, nested code included), looked up in `namespace`."""
    out = []
    for name in code.co_names:
        f = namespace.get(name)
        if isinstance(f, types.FunctionType) and \
                (f.__module__ or '').startswith(_PORT):
            out.append(f)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            out.extend(_called_functions(const, namespace))
    return out


@functools.lru_cache(maxsize=None)
def _rule_source(op_type):
    """The source of op_type's rule and of every port function it reaches
    by name, or None when it cannot be read."""
    try:
        rule = lowering.get_rule(op_type)
    except lowering.NoRuleError:
        return None
    seen, parts, todo = set(), [], [rule]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        try:
            parts.append(inspect.getsource(f))
        except (OSError, TypeError):
            return None
        ns = dict(f.__globals__)
        if f.__closure__:
            ns.update((n, c.cell_contents) for n, c in zip(
                f.__code__.co_freevars, f.__closure__)
                if _cell_filled(c))
        todo.extend(_called_functions(f.__code__, ns))
    return '\n'.join(parts)


def _cell_filled(cell):
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


@functools.lru_cache(maxsize=None)
def _rule_uses_rng(op_type):
    src = _rule_source(op_type)
    return src is None or 'generator' in src


@functools.lru_cache(maxsize=None)
def _rule_uses_context(op_type):
    src = _rule_source(op_type)
    return src is None or any(m in src for m in (
        'ctx.is_test', 'ctx.amp', 'amp_cast', 'ctx.pred', 'ctx.loops',
        'ctx.inplace'))


def uses_rng(op):
    """True when the op's rule (or a port function it calls) draws from
    the executor's generator; DCE keeps such ops so every later draw
    sees the stream it sees unoptimized."""
    return lowering.has_rule(op.type) and _rule_uses_rng(op.type)


def is_pure(op):
    """True when the op is a deterministic pure function of its inputs:
    safe to deduplicate (CSE) and to drop when dead (DCE)."""
    if op.type in _EFFECTFUL or op.type in lowering._BLOCK_RULES:
        return False
    if not lowering.has_rule(op.type):
        return False
    if sub_block_indices(op):
        return False
    return not _rule_uses_rng(op.type)


def is_foldable(op):
    """Pure AND context-free: the rule can be evaluated eagerly at
    optimization time with the result the step would produce."""
    return is_pure(op) and not _rule_uses_context(op.type)


def written_names(program, op, cache=None):
    """Every name `op` writes at its position in a top-level walk: the
    declared outputs PLUS every name its sub-blocks write (while/ifelse
    bodies legally update outer names without listing them as the parent
    op's outputs). A pass keeping a name -> version map over the walk
    bumps with THIS set. `cache` memoizes the sub-block walk."""
    from ..analysis.dataflow import _block_writes
    names = set(op.output_arg_names)
    for bi in sub_block_indices(op, program):
        names |= _block_writes(program, program.block(bi), cache=cache)
    return names


def write_counts(program):
    """name -> number of writes program-wide (all blocks), counting the
    names `autodiff` defines by attr (grad_names) as writes: the
    written-exactly-once test fold and cse both build on."""
    counts = {}
    for blk in program.blocks:
        for op in blk.ops:
            for n in op.output_arg_names:
                counts[n] = counts.get(n, 0) + 1
            if op.type == 'autodiff':
                for n in op.attrs.get('grad_names', ()):
                    counts[n] = counts.get(n, 0) + 1
    return counts


# -- report ------------------------------------------------------------------

# the one number per pass the passes.optimize span (and obs/report.py's
# per-pass line) carries: the work done
_PRIMARY_STAT = {'dce': 'ops_removed', 'fold': 'ops_folded',
                 'cse': 'ops_merged', 'amp': 'ops_rewritten',
                 'quant': 'ops_rewritten'}


class PassReport(object):
    """What one optimize() run did: per-pass numbers and the top-level op
    count before and after. Attached to the optimized program as
    `_opt_report`."""

    def __init__(self, level):
        self.level = level
        self.passes = {}       # name -> {stat: int}
        self.ops_before = 0
        self.ops_after = 0
        self.skipped = None    # reason string when nothing ran

    def note(self, name, **stats):
        d = self.passes.setdefault(name, {})
        for k, v in stats.items():
            d[k] = d.get(k, 0) + int(v)

    def to_dict(self):
        return {'level': self.level, 'ops_before': self.ops_before,
                'ops_after': self.ops_after, 'skipped': self.skipped,
                'passes': {k: dict(v) for k, v in self.passes.items()}}

    def __repr__(self):
        if self.skipped:
            return 'PassReport(skipped=%r)' % self.skipped
        per = ', '.join('%s=%s' % (k, v)
                        for k, v in sorted(self.passes.items()))
        return 'PassReport(level=%s, ops %d -> %d%s)' % (
            self.level, self.ops_before, self.ops_after,
            '; ' + per if per else '')


# -- the pipeline ------------------------------------------------------------

def _clone_for_opt(program):
    """A deep copy the passes may mutate freely, carrying every execution
    flag a run consults (clone() moves _amp, _fetch_f32 and the quant
    flags; the anomaly guard travels here), each op stamped with its
    original index."""
    p = program.clone(for_test=False)
    for flag in ('_anomaly_guard', '_anomaly_guard_max_skips'):
        if hasattr(program, flag):
            setattr(p, flag, getattr(program, flag))
    for i, op in enumerate(p.global_block().ops):
        op.attrs.setdefault(OP_SEQ_ATTR, i)
    return p


def optimize(program, feeds=None, fetches=None, level='default',
             where=None, device=None):
    """Run the pass pipeline over `program`; returns (optimized_program,
    PassReport). The input program is never mutated: the result is an
    optimized clone (the input itself when level is 'off').

    feeds / fetches: the execution context. `fetches` gates CSE and DCE
    (one run's fetch set is dead-code evidence here, because the executor
    caches the optimized clone per fetch set). `device`: where constant
    folding evaluates the rules, the executor's device, so a folded value
    is the one the step computes there (default: the CPU)."""
    if level not in LEVELS:
        raise ValueError('optimize level must be one of %s, got %r'
                         % ('|'.join(LEVELS), level))
    report = PassReport(level)
    if level == 'off':
        report.skipped = 'level=off'
        return program, report

    from . import amp_pass, cse, dce, fold, quant_pass
    from .. import amp as amp_mod

    with obs.span('passes.optimize', level=level,
                  where=where or 'api') as sp:
        p = _clone_for_opt(program)
        report.ops_before = len(p.global_block().ops)
        if amp_mod.is_amp(program):
            with obs.span('passes.amp'):
                amp_pass.run(p, report)
        if quant_pass.is_quant(program):
            with obs.span('passes.quant'):
                quant_pass.run(p, report)
        with obs.span('passes.fold'):
            fold.run(p, report, level=level, device=device)
        if fetches is not None:
            # CSE and DCE both eliminate output names; without the fetch
            # set any terminal output may be fetched later, so only the
            # name-preserving amp / quant / fold rewrites run blind
            with obs.span('passes.cse'):
                cse.run(p, report, feeds=feeds, fetches=fetches)
            with obs.span('passes.dce'):
                dce.run(p, report, fetches=fetches)
        # self-check: a pass bug surfaces here, where the executor's
        # fallback catches it, not as a KeyError in the step
        from ..analysis import dataflow as _dataflow
        from ..analysis.findings import SEV_ERROR
        errs = [f for f in _dataflow.run_pass(p, feeds=feeds,
                                              fetches=fetches,
                                              dead_ops=False)
                if f.severity == SEV_ERROR]
        if errs:
            raise RuntimeError(
                'optimizer produced an invalid program (%d error '
                'finding(s)):\n%s'
                % (len(errs), '\n'.join('  %s' % f for f in errs)))
        report.ops_after = len(p.global_block().ops)
        sp.fields.update(ops_before=report.ops_before,
                         ops_after=report.ops_after,
                         **{k: v.get(_PRIMARY_STAT.get(k),
                                     sum(v.values()))
                            for k, v in report.passes.items()})
    _C_PROGRAMS.inc()
    if report.ops_before > report.ops_after:
        _C_REMOVED.inc(report.ops_before - report.ops_after)
    p._opt_report = report
    p._bump_version()
    return p, report
