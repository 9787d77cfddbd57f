"""``name`` (the port of ``mxnet_tpu/name.py``): the NameManager scope
assigning default names to symbols, and ``Prefix``."""
from .symbol.symbol import NameManager as _BaseNameManager

__all__ = ["NameManager", "Prefix"]


class NameManager(_BaseNameManager):
    """Context-manager name scope with fresh counters (``with
    NameManager():`` restarts the default names within the scope)."""

    def __enter__(self):
        self._old = _BaseNameManager._current
        _BaseNameManager._current = self
        return self

    def __exit__(self, *exc):
        _BaseNameManager._current = self._old



class Prefix(NameManager):
    """A name scope prepending ``prefix`` to every name made in it
    (reference: name.py Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
