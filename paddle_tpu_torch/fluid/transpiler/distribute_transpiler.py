"""Distributed training transpiler.

Parity: reference python/paddle/fluid/transpiler/distribute_transpiler.py,
which splits the program into trainer programs (send/recv gradient ops over
gRPC) and parameter-server programs (optimizer ops moved server-side), and
the JAX package's fluid/transpiler/distribute_transpiler.py, a deprecated
shim that annotates the program with the mesh geometry (`_dist_config`).

There are no parameter servers: the gradients are averaged across the ranks
of the process group inside the step (fluid/mesh_step.py), and every rank
is both a trainer and the owner of its ZeRO block of the optimizer state.
transpile() records the annotation; the Executor consumes it: it builds the
dp mesh (trainers, capped at the world's size), holds the optimizer
accumulators as each rank's block (slice_var_up=True, the reference's
splitting of large vars across pservers) and, with
`DistributeTranspilerConfig.shard_parameters`, the parameters themselves
(ZeRO-3). get_trainer_program() returns the annotated program;
get_pserver_program(endpoint) returns the SAME program with that
endpoint's shard coordinate recorded, so reference launcher scripts that
start one pserver per endpoint launch mesh participants.
"""
from ..framework import Program, default_main_program

__all__ = ['DistributeTranspiler', 'DistributeTranspilerConfig']


class DistributeTranspilerConfig(object):
    """Transpile knobs (reference distribute_transpiler.py:116).

    slice_var_up: reference splits large vars across pservers; here it maps
        to ZeRO-sharding optimizer state over the dp mesh axis.
    shard_parameters: ZeRO-3 — hold the parameters THEMSELVES as each
        rank's block (parallel.fsdp_shard_params' rule; the step gathers
        them at use). The closest analogue of the reference splitting
        parameter blocks across pservers. Off by default (replicated).
    split_method: pserver load-balancing dispatcher (RoundRobin/HashName) —
        kept for API compat; the sharding decides placement.
    min_block_size: minimum split block size — advisory only here.
    """

    slice_var_up = True
    shard_parameters = False
    split_method = None
    min_block_size = 8192


class DistributeTranspiler(object):
    def __init__(self, config=None):
        self._config = config if config is not None \
            else DistributeTranspilerConfig()
        self._trainers = 1
        self._trainer_id = 0
        self._program = None
        self._sync_mode = True

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=True, startup_program=None,
                  slice_var_up=True, split_method=None):
        """Record the topology and annotate the program with the dp mesh
        size (trainers, capped at the world's size when the program runs;
        the process group decides each rank's coordinate).

        DEPRECATED shim (docs/migration.md, docs/embedding.md): the
        pserver topology this API described is now two first-class
        Program concerns — `Program.set_mesh({...})` for the mesh and
        `ParamAttr(sharding=...)` for per-tensor placement. This call still
        arms the legacy dp-mesh executor path AND translates its embedding
        intent forward: any table read by an `is_distributed=True` lookup
        gets the row-sharding annotation ('dp', None) stamped here, which
        a set_mesh() program then holds as each rank's block of rows
        (gathered at use; the all_to_all lookup wire of the JAX package
        waits for ROADMAP.md Queue A, "Parallel")."""
        import warnings
        warnings.warn(
            'DistributeTranspiler is deprecated: declare the mesh with '
            "Program.set_mesh({'dp': N, ...}) and shard huge embedding "
            "tables with ParamAttr(sharding=('dp', None)) + "
            'embedding(is_sparse=True, is_distributed=True) — the '
            'sharded-embedding subsystem (docs/embedding.md) replaces '
            'the pserver row split; see the migration table in '
            'docs/migration.md.', DeprecationWarning, stacklevel=2)
        if program is None:
            program = default_main_program()
        self._annotate_distributed_tables(program)
        if isinstance(pservers, str):
            pserver_endpoints = [e for e in pservers.split(",") if e]
        else:
            pserver_endpoints = list(pservers)
        self._trainer_id = trainer_id
        self._trainers = trainers
        self._program = program
        self._startup_program = startup_program
        self._sync_mode = sync_mode
        self._pserver_endpoints = pserver_endpoints
        # MERGE into any existing annotation (SequenceParallelTranspiler /
        # PipelineTranspiler may have run first — clobbering would silently
        # drop their axes) and force the mesh to rebuild
        base = dict(getattr(program, '_dist_config', None) or {})
        base.update({
            'dp_size': trainers,
            'trainer_id': trainer_id,
            'sync_mode': sync_mode,
            # reference slice_var_up split big vars across pservers; the
            # equivalent here is ZeRO-sharding optimizer state over dp
            'shard_optimizer_states': bool(
                slice_var_up and getattr(self._config, 'slice_var_up', True)),
            'shard_parameters': bool(
                getattr(self._config, 'shard_parameters', False)),
        })
        # recompute from the MERGED sizes so an earlier pipeline/sp/tp
        # transpile keeps its axis in the annotation instead of being
        # clobbered to a dp-only claim
        from ._mesh_axes import rebuild_mesh_axes
        base['mesh_axes'] = rebuild_mesh_axes(base)
        program._dist_config = base
        return self

    @staticmethod
    def _annotate_distributed_tables(program, axis='dp'):
        """Translate the pserver embedding intent into the first-class
        surface: every table read by an `is_distributed=True`
        lookup_table gets `sharding=(axis, None)` stamped (and the op its
        `dist_axis` routing attr, as in the JAX package). Already-annotated
        tables are left alone; the legacy `_dist_config` executor path
        ignores the annotation."""
        from ..framework import normalize_sharding
        ops = [op for blk in program.blocks for op in blk.ops]
        for op in ops:
            # every block: the decode idiom puts lookups inside While
            # sub-blocks
            if op.type != 'lookup_table' \
                    or not op.attrs.get('is_distributed'):
                continue
            w = op.inputs['W'][0]
            if getattr(w, 'sharding', None) is None:
                ndim = len(w.shape) if w.shape is not None else 2
                w.sharding = normalize_sharding(
                    (axis,) + (None,) * (ndim - 1))
            row = w.sharding[0]
            if op.attrs.get('dist_axis') is None \
                    and row is not None and not isinstance(row, tuple):
                op.attrs['dist_axis'] = row

    def get_trainer_program(self):
        """The trainer program IS the original program: every rank runs it
        on its rows (no send/recv op rewriting)."""
        return self._program

    def get_pserver_program(self, endpoint):
        """Every rank is both a trainer and the 'parameter server' of its
        own ZeRO optimizer-state block. Launcher scripts that start one
        pserver process per endpoint therefore get the SAME mesh-annotated
        program back, with this endpoint's shard coordinate recorded —
        running it joins the mesh as the owner of that block (the reference
        rewrites the program into recv/optimize/send blocks,
        distribute_transpiler.py:471)."""
        if self._program is None:
            raise RuntimeError('call transpile() before get_pserver_program')
        try:
            idx = self._pserver_endpoints.index(endpoint)
        except ValueError:
            raise ValueError('unknown pserver endpoint %r (transpiled with '
                             '%r)' % (endpoint, self._pserver_endpoints))
        prog = self._program.clone()
        prog._dist_config = dict(self._program._dist_config,
                                 shard_owner=idx,
                                 n_shard_owners=len(self._pserver_endpoints))
        return prog

    def get_pserver_programs(self, endpoint):
        return self.get_pserver_program(endpoint), self.get_startup_program(
            endpoint)

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        """The mesh participant runs the ordinary startup program (each rank
        cuts its blocks at first use): the one passed here, else the one
        recorded at transpile() time, else the thread default."""
        if startup_program is not None:
            return startup_program
        if getattr(self, '_startup_program', None) is not None:
            return self._startup_program
        from ..framework import default_startup_program
        return default_startup_program()
