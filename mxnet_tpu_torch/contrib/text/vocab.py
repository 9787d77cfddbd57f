"""Indexed vocabulary (reference: python/mxnet/contrib/text/vocab.py)."""
from __future__ import annotations

from . import _constants as C


class Vocabulary:
    """Maps tokens to indices, index 0 reserved for ``unknown_token``,
    then any ``reserved_tokens``, then counter keys by descending
    frequency / ascending token (reference: vocab.py:33 Vocabulary)."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("`min_freq` must be set to a positive value")
        if reserved_tokens is not None:
            reserved_set = set(reserved_tokens)
            if unknown_token in reserved_set:
                raise ValueError("`reserved_tokens` cannot contain "
                                 "`unknown_token`")
            if len(reserved_set) != len(reserved_tokens):
                raise ValueError("`reserved_tokens` cannot contain "
                                 "duplicate tokens")
        self._unknown_token = unknown_token
        self._reserved_tokens = list(reserved_tokens) if reserved_tokens \
            else None
        self._idx_to_token = [unknown_token] + (self._reserved_tokens or [])
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        pairs = sorted(counter.items(), key=lambda x: (-x[1], x[0]))
        if most_freq_count is not None:
            pairs = pairs[:most_freq_count]
        for token, freq in pairs:
            if freq < min_freq:
                break
            if token not in self._token_to_idx:
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        single = isinstance(tokens, str)
        if single:
            tokens = [tokens]
        out = [self._token_to_idx.get(t, C.UNKNOWN_IDX) for t in tokens]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        if single:
            indices = [indices]
        out = []
        for i in indices:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError("token index %d out of range [0, %d)"
                                 % (i, len(self._idx_to_token)))
            out.append(self._idx_to_token[i])
        return out[0] if single else out
