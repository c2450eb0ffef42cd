"""Structured analyzer findings.

Parity: the JAX package's fluid/analysis/findings.py, copied as it is (it
is pure Python). Every pass reports through the same Finding shape: the
op (block + index + type), the variables involved and, where the op
carries one, the user-code callsite that built it. In the port the
passes' def-use self-check (passes.optimize) reads these; the verifier
gate, `Program.verify` and program_lint wait in ROADMAP.md Queue A,
"Analysis and tooling".
"""

__all__ = [
    'Finding', 'ProgramVerifyError',
    'SEV_ERROR', 'SEV_WARNING',
    'DANGLING_INPUT', 'WRITE_TO_FEED', 'DEAD_OP', 'UNREACHABLE_FETCH',
    'USE_BEFORE_WRITE', 'SHAPE_MISMATCH', 'DTYPE_MISMATCH',
    'DONATION_UNSAFE', 'SCOPE_RACE', 'SHARDING_INVALID',
    'SHARDING_UNTILEABLE', 'SHARDING_RESHARD', 'EMBEDDING_UNTILEABLE',
    'HBM_OVER_BUDGET', 'IMPLICIT_RESHARD', 'COLLECTIVE_DIVERGENCE',
    'CONCURRENT_COLLECTIVES', 'DIM_SHARDING',
]

SEV_ERROR = 'error'       # the program cannot run correctly as lowered
SEV_WARNING = 'warning'   # suspicious but executable (a dead op still runs)

# finding kinds (one per checkable contract; the catalog lives in
# docs/analysis.md)
DANGLING_INPUT = 'DanglingInput'        # op input never defined at its use
WRITE_TO_FEED = 'WriteToFeed'           # op output overwrites a feed var
DEAD_OP = 'DeadOp'                      # op's outputs reach no fetch/persist
UNREACHABLE_FETCH = 'UnreachableFetch'  # fetch name nothing defines
USE_BEFORE_WRITE = 'UseBeforeWrite'     # persistable read before any write
SHAPE_MISMATCH = 'ShapeMismatch'        # declared vs inferred shape conflict
DTYPE_MISMATCH = 'DtypeMismatch'        # declared vs inferred dtype conflict
DONATION_UNSAFE = 'DonationUnsafe'      # write-set vs donation decision
SCOPE_RACE = 'ScopeRace'                # persistable writes + shared scope
SHARDING_INVALID = 'ShardingInvalid'        # annotation vs mesh spec
SHARDING_UNTILEABLE = 'ShardingUntileable'  # mesh cannot tile the dim
SHARDING_RESHARD = 'ShardingReshard'        # resharding implied mid-pipeline
# a row-sharded EMBEDDING TABLE whose vocab dim the mesh axis cannot tile:
# the untileable class specialized for lookup_table weights, where the fix
# is concrete (pad the vocab — embedding.pad_vocab) and the runtime cost
# of the fallback is a silent replicate of the one tensor the annotation
# existed to shard (docs/embedding.md)
EMBEDDING_UNTILEABLE = 'EmbeddingShardUntileable'
# cost-model pass (analysis/costmodel.py — docs/analysis.md#pass-6):
# per-device persistable residency exceeds a declared --hbm-budget, or a
# var is re-placed mid-program (a sharding transition GSPMD satisfies
# with a hidden all-gather/all-to-all at the edge)
HBM_OVER_BUDGET = 'HbmOverBudget'
IMPLICIT_RESHARD = 'ImplicitReshard'
# collective-safety pass (analysis/collectives.py — docs/analysis.md
# #pass-7): a collective issued under divergent control flow (the
# rendezvous-hang class), or a concurrent-declared program issuing
# collectives at all (today survived only by serving/pod.py's
# process-wide _MESH_DISPATCH_LOCK)
COLLECTIVE_DIVERGENCE = 'CollectiveDivergence'
CONCURRENT_COLLECTIVES = 'ConcurrentCollectives'
# a dim-sharded TIERED table: spills gather whole rows, so the tier
# store statically refuses the embedding-dim sharding the runtime guard
# (embedding/tiers.py validate_program) would reject at train start
DIM_SHARDING = 'DimSharding'

_SEV_ORDER = {SEV_ERROR: 0, SEV_WARNING: 1}


class Finding(object):
    """One analyzer verdict: what is wrong, where in the program, and where
    in the user's code the offending op was built."""

    __slots__ = ('kind', 'severity', 'message', 'block', 'op_index',
                 'op_type', 'var_names', 'callsite')

    def __init__(self, kind, severity, message, block=0, op_index=None,
                 op_type=None, var_names=(), callsite=None):
        self.kind = kind
        self.severity = severity
        self.message = message
        self.block = block
        self.op_index = op_index
        self.op_type = op_type
        self.var_names = tuple(var_names)
        self.callsite = callsite

    @classmethod
    def for_op(cls, kind, severity, message, op, var_names=()):
        """Finding anchored on an Operator: block/index/type/provenance are
        derived from the op itself."""
        blk = op.block
        try:
            idx = blk.ops.index(op)
        except ValueError:
            idx = None
        return cls(kind, severity, message, block=blk.idx, op_index=idx,
                   op_type=op.type, var_names=var_names,
                   callsite=getattr(op, 'callsite', None))

    def to_dict(self):
        return {'kind': self.kind, 'severity': self.severity,
                'message': self.message, 'block': self.block,
                'op_index': self.op_index, 'op_type': self.op_type,
                'var_names': list(self.var_names), 'callsite': self.callsite}

    def _where(self):
        parts = []
        if self.op_index is not None:
            parts.append('block %d op #%d (%s)'
                         % (self.block, self.op_index, self.op_type))
        elif self.op_type is not None:
            parts.append('op %s' % self.op_type)
        if self.callsite:
            parts.append('built at %s' % self.callsite)
        return ', '.join(parts)

    def __repr__(self):
        where = self._where()
        return '[%s] %s: %s%s' % (self.severity, self.kind, self.message,
                                  ' [%s]' % where if where else '')

    __str__ = __repr__


def sort_findings(findings):
    """Errors first, then by (block, op index) program order."""
    return sorted(findings, key=lambda f: (
        _SEV_ORDER.get(f.severity, 9), f.block,
        -1 if f.op_index is None else f.op_index))


class ProgramVerifyError(ValueError):
    """Raised by Program.verify(level='error') / PADDLE_TPU_VERIFY=error
    when the analyzer reports error-severity findings. `.findings` carries
    every finding (including warnings) for programmatic inspection."""

    def __init__(self, message, findings):
        super(ProgramVerifyError, self).__init__(message)
        self.findings = list(findings)
