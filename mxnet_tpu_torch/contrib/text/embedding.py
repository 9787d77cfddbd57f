"""Pretrained token embeddings: GloVe / fastText / custom / composite,
the port of ``mxnet_tpu/contrib/text/embedding.py`` (reference:
python/mxnet/contrib/text/embedding.py).

The token -> vector table is assembled on the host in one numpy buffer
(kept as a host mirror for lookups) and made one NDArray on the caller's
device (the card unless ``context.use`` names the CPU): ``idx_to_vec``,
to copy into ``gluon.nn.Embedding``'s weight.  Catalog files resolve
through ``gluon.utils.download`` (SHA-1 checked, retried), which copies
``file://`` URLs only: set ``MXNET_GLUON_REPO`` to a local
``file://`` mirror of the hosted layout, or place the files under
``embedding_root`` yourself.  Nothing is fetched over a network.
"""
from __future__ import annotations

import io
import logging
import os
import tarfile
import warnings
import zipfile

import numpy as np

from ... import ndarray as nd
from ...base import MXNetError
from . import _constants as C
from . import vocab

__all__ = ["register", "create", "get_pretrained_file_names",
           "TokenEmbedding", "GloVe", "FastText", "CustomEmbedding",
           "CompositeEmbedding"]

class _Registry:
    """Name (lower case) -> embedding class (reference:
    ``mxnet_tpu/base.py`` ``Registry``)."""

    def __init__(self, nickname):
        self._nickname = nickname
        self._registry = {}

    def register(self, klass, name=None):
        self._registry[(name or klass.__name__).lower()] = klass
        return klass

    def create(self, name, *args, **kwargs):
        key = name.lower()
        if key not in self._registry:
            raise MXNetError("Cannot find %s %r. Registered: %s"
                             % (self._nickname, name,
                                sorted(self._registry)))
        return self._registry[key](*args, **kwargs)

    def find(self, name):
        return self._registry[name.lower()]

    def keys(self):
        return sorted(self._registry)


_REG = _Registry("token embedding")


def register(embedding_cls):
    """Register a subclass of ``_TokenEmbedding`` for ``create``
    (reference: embedding.py:39)."""
    _REG.register(embedding_cls)
    return embedding_cls


def create(embedding_name, **kwargs):
    """Instantiate a registered embedding by name, e.g.
    ``create("glove", pretrained_file_name="glove.6B.50d.txt")``
    (reference: embedding.py:62)."""
    return _REG.create(embedding_name, **kwargs)


def get_pretrained_file_names(embedding_name=None):
    """Catalog of pretrained files, per embedding or all
    (reference: embedding.py:89)."""
    if embedding_name is not None:
        cls = _REG.find(embedding_name)
        return list(cls.pretrained_file_name_sha1.keys())
    return {name: list(_REG.find(name).pretrained_file_name_sha1.keys())
            for name in _REG.keys()}


class _TokenEmbedding(vocab.Vocabulary):
    """Base: a Vocabulary whose indices also map to embedding vectors.

    Semantics kept from the reference (embedding.py:132):
    - index 0 (unknown) takes the file's ``unknown_token`` vector if the
      file has one, else ``init_unknown_vec``
    - first-encountered duplicate token wins; later ones are skipped
      with a warning
    - 1-dimensional rows (fastText headers) are skipped with a warning
    - with a ``vocabulary``, only its tokens get vectors
    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._vec_len = 0
        self._idx_to_vec = None
        self._table_np = None  # host mirror: lookups read no device copy

    def _set_table(self, table_np):
        self._table_np = table_np
        self._idx_to_vec = nd.array(table_np)

    # -- acquisition -------------------------------------------------------
    @classmethod
    def _get_download_file_name(cls, pretrained_file_name):
        return pretrained_file_name

    @classmethod
    def _get_pretrained_file_url(cls, pretrained_file_name):
        from ...gluon.utils import get_repo_url
        return "{}gluon/embeddings/{}/{}".format(
            get_repo_url(), cls.__name__.lower(),
            cls._get_download_file_name(pretrained_file_name))

    @classmethod
    def _get_pretrained_file(cls, embedding_root, pretrained_file_name):
        """Resolve (download + sha1-verify + extract) a catalog file
        (reference: embedding.py:199)."""
        from ...gluon.utils import check_sha1, download
        embedding_root = os.path.expanduser(embedding_root)
        url = cls._get_pretrained_file_url(pretrained_file_name)
        embedding_dir = os.path.join(embedding_root, cls.__name__.lower())
        pretrained_file_path = os.path.join(embedding_dir,
                                            pretrained_file_name)
        downloaded_file = os.path.basename(url)
        downloaded_file_path = os.path.join(embedding_dir, downloaded_file)
        expected_file_hash = \
            cls.pretrained_file_name_sha1[pretrained_file_name]
        archive_sha1 = getattr(cls, "pretrained_archive_name_sha1", None)
        expected_download_hash = archive_sha1[downloaded_file] \
            if archive_sha1 else expected_file_hash
        if not os.path.exists(pretrained_file_path) \
                or not check_sha1(pretrained_file_path,
                                  expected_file_hash):
            download(url, downloaded_file_path,
                     sha1_hash=expected_download_hash)
            ext = os.path.splitext(downloaded_file)[1]
            if ext == ".zip":
                with zipfile.ZipFile(downloaded_file_path, "r") as zf:
                    zf.extractall(embedding_dir)
            elif ext == ".gz":
                with tarfile.open(downloaded_file_path, "r:gz") as tar:
                    tar.extractall(path=embedding_dir)
        return pretrained_file_path

    # -- loading -----------------------------------------------------------
    def _load_embedding(self, pretrained_file_path, elem_delim,
                        init_unknown_vec, encoding="utf8"):
        pretrained_file_path = os.path.expanduser(pretrained_file_path)
        if not os.path.isfile(pretrained_file_path):
            raise ValueError("`pretrained_file_path` must be a valid path "
                             "to the pre-trained token embedding file")
        logging.getLogger(__name__).info(
            "loading embedding vectors from %s", pretrained_file_path)
        vec_len = None
        rows = []
        seen = set()
        loaded_unknown_vec = None
        # indices below this (unknown + any reserved_tokens) already
        # exist in the vocabulary; file tokens append after them
        base = len(self._idx_to_token)
        with io.open(pretrained_file_path, "r", encoding=encoding) as f:
            for line_num, line in enumerate(f, 1):
                elems = line.rstrip().split(elem_delim)
                if len(elems) <= 1:
                    raise ValueError(
                        "line %d of %s: unexpected data format"
                        % (line_num, pretrained_file_path))
                token, values = elems[0], elems[1:]
                if token == self.unknown_token and \
                        loaded_unknown_vec is None:
                    loaded_unknown_vec = np.asarray(values, np.float32)
                    seen.add(token)
                elif token in seen:
                    warnings.warn(
                        "line %d: duplicate embedding for token %r "
                        "skipped (first occurrence wins)"
                        % (line_num, token))
                elif len(values) == 1:
                    warnings.warn("line %d: token %r with 1-dimensional "
                                  "vector %r is likely a header, skipped"
                                  % (line_num, token, values))
                else:
                    if vec_len is None:
                        vec_len = len(values)
                    elif len(values) != vec_len:
                        raise ValueError(
                            "line %d: dimension %d != previous dimension "
                            "%d; all vectors must agree"
                            % (line_num, len(values), vec_len))
                    rows.append(np.asarray(values, np.float32))
                    self._idx_to_token.append(token)
                    self._token_to_idx[token] = len(self._idx_to_token) - 1
                    seen.add(token)
        if vec_len is None:
            raise ValueError("no embedding vectors loaded from %s"
                             % pretrained_file_path)
        self._vec_len = vec_len
        table = np.empty((base + len(rows), vec_len), np.float32)
        # unknown + reserved tokens all take the init vector (the
        # reference docstring's "initialized embedding vector for every
        # reserved token"); a file-provided <unk> row overrides index 0
        table[:base] = init_unknown_vec(shape=vec_len).asnumpy()
        if loaded_unknown_vec is not None:
            table[C.UNKNOWN_IDX] = loaded_unknown_vec
        if rows:
            table[base:] = np.stack(rows)
        self._set_table(table)

    def _index_tokens_from_vocabulary(self, vocabulary):
        self._token_to_idx = vocabulary.token_to_idx.copy() \
            if vocabulary.token_to_idx is not None else None
        self._idx_to_token = vocabulary.idx_to_token[:] \
            if vocabulary.idx_to_token is not None else None
        self._unknown_token = vocabulary.unknown_token
        self._reserved_tokens = vocabulary.reserved_tokens[:] \
            if vocabulary.reserved_tokens is not None else None

    def _set_idx_to_vec_by_embeddings(self, token_embeddings, vocab_len,
                                      vocab_idx_to_token):
        """Concatenate per-token vectors from one or more embeddings
        into this instance's table (reference: embedding.py:313)."""
        new_vec_len = sum(e.vec_len for e in token_embeddings)
        table = np.zeros((vocab_len, new_vec_len), np.float32)
        col = 0
        for emb in token_embeddings:
            end = col + emb.vec_len
            table[0, col:end] = emb._table_np[C.UNKNOWN_IDX]
            if vocab_len > 1:
                table[1:, col:end] = emb._host_vecs(vocab_idx_to_token[1:])
            col = end
        self._vec_len = new_vec_len
        self._set_table(table)

    def _build_embedding_for_vocabulary(self, vocabulary):
        if vocabulary is not None:
            if not isinstance(vocabulary, vocab.Vocabulary):
                raise TypeError("`vocabulary` must be a "
                                "contrib.text.vocab.Vocabulary")
            self._set_idx_to_vec_by_embeddings(
                [self], len(vocabulary), vocabulary.idx_to_token)
            self._index_tokens_from_vocabulary(vocabulary)

    # -- access ------------------------------------------------------------
    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def _host_vecs(self, tokens, lower_case_backup=False):
        """The host mirror's rows of ``tokens`` (a list)."""
        if not lower_case_backup:
            indices = [self.token_to_idx.get(t, C.UNKNOWN_IDX)
                       for t in tokens]
        else:
            indices = [self.token_to_idx[t] if t in self.token_to_idx
                       else self.token_to_idx.get(t.lower(), C.UNKNOWN_IDX)
                       for t in tokens]
        return self._table_np[np.asarray(indices, np.int64)]

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """Vectors for token(s); unknown tokens get the index-0 vector
        (reference: embedding.py:365)."""
        single = not isinstance(tokens, list)
        vecs = nd.array(self._host_vecs([tokens] if single else tokens,
                                        lower_case_backup))
        return vecs[0] if single else vecs

    def update_token_vectors(self, tokens, new_vectors):
        """Overwrite vectors for known tokens; unknown tokens error so a
        typo can't silently write the wrong row (reference:
        embedding.py:404)."""
        if self._idx_to_vec is None:
            raise ValueError("`idx_to_vec` has not been set")
        single = not isinstance(tokens, list)
        if single:
            tokens = [tokens]
        arr = new_vectors.asnumpy() if hasattr(new_vectors, "asnumpy") \
            else np.asarray(new_vectors, np.float32)
        if arr.ndim == 1:
            arr = arr[None]
        if arr.shape != (len(tokens), self.vec_len):
            raise ValueError(
                "new_vectors shape %s must be (%d, %d)"
                % (arr.shape, len(tokens), self.vec_len))
        indices = []
        for token in tokens:
            if token in self.token_to_idx:
                indices.append(self.token_to_idx[token])
            else:
                raise ValueError(
                    "token %r is unknown; to update the unknown vector, "
                    "name the unknown token %r explicitly"
                    % (token, self.idx_to_token[C.UNKNOWN_IDX]))
        # rebuild the device table once
        table = np.array(self._table_np)
        table[np.asarray(indices)] = arr
        self._set_table(table)

    @classmethod
    def _check_pretrained_file_names(cls, pretrained_file_name):
        if pretrained_file_name not in cls.pretrained_file_name_sha1:
            raise KeyError(
                "cannot find pretrained file %s for embedding %s; valid "
                "files: %s" % (pretrained_file_name, cls.__name__.lower(),
                               ", ".join(cls.pretrained_file_name_sha1)))


# public alias for subclassing custom embeddings (the reference keeps the
# base private but registers subclasses of it; exposing the alias lets
# user code @register its own without reaching into privates)
TokenEmbedding = _TokenEmbedding


@register
class GloVe(_TokenEmbedding):
    """GloVe embeddings (reference: embedding.py:468).  Files extract
    from family zips; both are sha1-checked."""

    pretrained_archive_name_sha1 = C.GLOVE_ARCHIVE_SHA1
    pretrained_file_name_sha1 = C.GLOVE_FILE_SHA1

    @classmethod
    def _get_download_file_name(cls, pretrained_file_name):
        # glove.6B.50d.txt -> glove.6B.zip (the family archive)
        src = {a.split(".")[1]: a
               for a in cls.pretrained_archive_name_sha1}
        return src[pretrained_file_name.split(".")[1]]

    def __init__(self, pretrained_file_name="glove.840B.300d.txt",
                 embedding_root=os.path.join("~", ".mxnet_tpu",
                                             "embeddings"),
                 init_unknown_vec=nd.zeros, vocabulary=None, **kwargs):
        GloVe._check_pretrained_file_names(pretrained_file_name)
        super().__init__(**kwargs)
        path = GloVe._get_pretrained_file(embedding_root,
                                          pretrained_file_name)
        self._load_embedding(path, " ", init_unknown_vec)
        self._build_embedding_for_vocabulary(vocabulary)


@register
class FastText(_TokenEmbedding):
    """fastText .vec embeddings (reference: embedding.py:558); the .vec
    header row is auto-skipped by the 1-dimensional-row rule."""

    pretrained_archive_name_sha1 = C.FAST_TEXT_ARCHIVE_SHA1
    pretrained_file_name_sha1 = C.FAST_TEXT_FILE_SHA1

    @classmethod
    def _get_download_file_name(cls, pretrained_file_name):
        return ".".join(pretrained_file_name.split(".")[:-1]) + ".zip"

    def __init__(self, pretrained_file_name="wiki.simple.vec",
                 embedding_root=os.path.join("~", ".mxnet_tpu",
                                             "embeddings"),
                 init_unknown_vec=nd.zeros, vocabulary=None, **kwargs):
        FastText._check_pretrained_file_names(pretrained_file_name)
        super().__init__(**kwargs)
        path = FastText._get_pretrained_file(embedding_root,
                                             pretrained_file_name)
        self._load_embedding(path, " ", init_unknown_vec)
        self._build_embedding_for_vocabulary(vocabulary)


class CustomEmbedding(_TokenEmbedding):
    """Embedding from a user file of ``token<delim>v1<delim>...``
    (reference: embedding.py:658)."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", init_unknown_vec=nd.zeros,
                 vocabulary=None, **kwargs):
        super().__init__(**kwargs)
        self._load_embedding(pretrained_file_path, elem_delim,
                             init_unknown_vec, encoding)
        self._build_embedding_for_vocabulary(vocabulary)


class CompositeEmbedding(_TokenEmbedding):
    """Concatenate one or more embeddings over a vocabulary's tokens
    (reference: embedding.py:719)."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(vocabulary, vocab.Vocabulary):
            raise TypeError("`vocabulary` must be a "
                            "contrib.text.vocab.Vocabulary")
        if not isinstance(token_embeddings, list):
            token_embeddings = [token_embeddings]
        for emb in token_embeddings:
            if not isinstance(emb, _TokenEmbedding):
                raise TypeError("`token_embeddings` must be "
                                "_TokenEmbedding instance(s)")
        self._index_tokens_from_vocabulary(vocabulary)
        self._set_idx_to_vec_by_embeddings(
            token_embeddings, len(self), self.idx_to_token)
