"""``name`` (the port of ``mxnet_tpu/name.py``): the NameManager scope
assigning default names to symbols."""
from .symbol.symbol import NameManager as _BaseNameManager

__all__ = ["NameManager"]


class NameManager(_BaseNameManager):
    """Context-manager name scope with fresh counters (``with
    NameManager():`` restarts the default names within the scope)."""

    def __enter__(self):
        self._old = _BaseNameManager._current
        _BaseNameManager._current = self
        return self

    def __exit__(self, *exc):
        _BaseNameManager._current = self._old

