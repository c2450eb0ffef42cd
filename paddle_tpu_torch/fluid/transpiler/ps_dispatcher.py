"""PS dispatchers: deprecated shims. Parity: reference
transpiler/ps_dispatcher.py (HashName / RoundRobin decide which pserver owns
a var) and the JAX package's fluid/transpiler/ps_dispatcher.py. There are no
parameter servers: the ranks of a dp mesh average the gradients
themselves, and a sharded table's row owner is fixed by its sharding. These
classes translate old launcher code only: `dispatch()` still round-robins or
hashes endpoint strings, and construction warns with the migration
pointer."""
import warnings

__all__ = ['PSDispatcher', 'HashName', 'RoundRobin']


class PSDispatcher(object):
    def __init__(self, pserver_endpoints):
        warnings.warn(
            '%s is deprecated: pserver var dispatch is replaced by mesh '
            "sharding specs — row-shard embedding tables with "
            "ParamAttr(sharding=('dp', None)) + embedding(is_sparse=True, "
            'is_distributed=True) on a Program.set_mesh() program '
            '(docs/embedding.md, migration table in docs/migration.md).'
            % type(self).__name__, DeprecationWarning, stacklevel=2)
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError("Interface has not been implemented.")


class HashName(PSDispatcher):
    def _hash_block(self, block_str, total):
        return hash(block_str) % total

    def dispatch(self, varlist):
        eplist = []
        for var in varlist:
            server_id = self._hash_block(var.name, len(self._eps))
            eplist.append(self._eps[server_id])
        return eplist


class RoundRobin(PSDispatcher):
    def dispatch(self, varlist):
        eplist = []
        for var in varlist:
            server = self._eps[self._step]
            eplist.append(server)
            self._step = (self._step + 1) % len(self._eps)
        return eplist
