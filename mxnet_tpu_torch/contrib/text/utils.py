"""Text helpers (reference: python/mxnet/contrib/text/utils.py)."""
from __future__ import annotations

import collections
import re

__all__ = ["count_tokens_from_str"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Token frequency counter (reference: utils.py:40
    count_tokens_from_str)."""
    source_str = re.split(token_delim + "|" + seq_delim, source_str)
    tokens = [t for t in source_str if t]
    if to_lower:
        tokens = [t.lower() for t in tokens]
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    counter.update(tokens)
    return counter
