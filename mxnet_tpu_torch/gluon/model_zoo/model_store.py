"""Pretrained-weight files: the port of
``mxnet_tpu/gluon/model_zoo/model_store.py``.

The same catalog, order and checks (``model_store.py:41-68``): a
catalog-named ``{name}-{short_hash}.params`` in the model root, SHA-1
verified; then a plain ``{name}.params`` there; then the catalog file
from the repo URL (``MXNET_GLUON_REPO``), verified.  The port fetches
only ``file://`` URLs (``gluon.utils.download``): neither this package
nor the hosts it runs on reach the network.
"""
from __future__ import annotations

import os

__all__ = ["get_model_file", "get_model_root", "purge",
           "register_model_sha1", "short_hash"]

# name -> SHA-1 of the whole .params file; empty as shipped, filled by
# register_model_sha1 (a private repo, or a file:// one)
_model_sha1 = {}


def register_model_sha1(name, sha1):
    """Add or replace a catalog entry."""
    _model_sha1[name] = sha1


def short_hash(name):
    """The first 8 hex digits of the file's SHA-1, the file name's
    suffix."""
    if name not in _model_sha1:
        raise ValueError("pretrained model for %s is not available" % name)
    return _model_sha1[name][:8]


def get_model_root():
    """``$MXNET_HOME``, else ``~/.mxnet_tpu`` (the reference's)."""
    return os.path.expanduser(
        os.environ.get("MXNET_HOME", os.path.join("~", ".mxnet_tpu")))


def get_model_file(name, root=None):
    """The path of ``name``'s ``.params`` file, in the order of the module
    docstring; ``root`` defaults to ``get_model_root()/models``.  Raises
    ``FileNotFoundError`` for a name with no file and no catalog entry,
    ``IOError`` where the repo's file is missing or fails its SHA-1."""
    root = os.path.expanduser(root or os.path.join(get_model_root(),
                                                   "models"))
    plain = os.path.join(root, name + ".params")
    if name in _model_sha1:
        from ..utils import check_sha1, download, get_repo_url
        sha1 = _model_sha1[name]
        fname = "%s-%s.params" % (name, short_hash(name))
        path = os.path.join(root, fname)
        if os.path.exists(path) and check_sha1(path, sha1):
            return path
        if os.path.exists(plain):
            return plain
        return download(get_repo_url() + "gluon/models/" + fname, path,
                        sha1_hash=sha1)
    if os.path.exists(plain):
        return plain
    raise FileNotFoundError(
        "pretrained weights for %r not found at %s and %r has no catalog "
        "entry; place a %s.params file there or register_model_sha1 + "
        "MXNET_GLUON_REPO for a file:// repo" % (name, plain, name, name))


def purge(root=None):
    """Remove every ``.params`` file under ``root``."""
    root = os.path.expanduser(root or os.path.join(get_model_root(),
                                                   "models"))
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
