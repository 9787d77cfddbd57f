"""contrib ops of the port: the CTC loss of ``mxnet_tpu/ops/contrib.py``
(``:27-116``).  The file's other ops (MultiBox, NMS, ROI, deformable
convolution and the rest) are ROADMAP.md queue A, items 10(b) and 10(d).

The reference runs the log-space forward recursion under ``lax.scan`` and
differentiates through it; the port calls ``F.ctc_loss`` (torch's native
CTC on the CPU and on the card).  The reference's semantics are kept:

- the softmax runs inside the op: ``data`` are activations, and the
  gradient is the one with respect to them (torch's CTC backward is the
  true gradient only through ``log_softmax``'s, so the op never hands out
  the log-probabilities);
- ``blank_label="first"``: blank 0, labels padded with 0; ``"last"``:
  blank ``A - 1``, labels padded with -1 (a negative label indexes from
  the end, as the reference's gather does);
- label lengths are counted from the padding unless
  ``use_label_lengths``; data lengths default to ``T``;
- a row whose labels need more frames than it has (its length plus one
  per repeated neighbour) has no alignment: the reference's ``-1e30``
  sentinel gives it a loss of ``1e30``, and so does the port, with a zero
  gradient (the reference's gradient there is an artifact of its
  sentinel, ROADMAP.md C7);
- the output is ``(batch,)`` losses.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .registry import register

__all__ = ["ctc_loss", "ctc_infeasible"]

# the loss of a row with no alignment: the reference's -(-1e30)
NO_ALIGNMENT_LOSS = 1e30


def ctc_infeasible(labels, label_lengths, data_lengths):
    """Rows whose first ``label_lengths`` labels need more frames than
    ``data_lengths``: one per label, one more between equal neighbours."""
    L = labels.shape[1]
    steps = torch.arange(1, L, device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (steps[None, :] < label_lengths[:, None])).sum(-1)
    return label_lengths + repeats > data_lengths


def _ctc_optional(params):
    opt = []
    if not params.get("use_data_lengths", False):
        opt.append("data_lengths")
    if not params.get("use_label_lengths", False):
        opt.append("label_lengths")
    return opt


@register("_contrib_ctc_loss",
          arg_names=["data", "label", "data_lengths", "label_lengths"],
          aliases=("ctc_loss", "CTCLoss", "_contrib_CTCLoss"),
          optional_args=_ctc_optional)
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC loss (reference: src/operator/contrib/ctc_loss.cc).

    data: (seq_len, batch, alphabet) activations; label: (batch,
    label_len) padded.  Returns (batch,) losses."""
    T, B, A = data.shape
    if data.device.type == "meta":
        return data.new_empty((B,))
    blank = 0 if blank_label == "first" else A - 1
    labels = label.long()
    if use_label_lengths and label_lengths is not None:
        lab_lens = label_lengths.long()
    else:
        pad = 0 if blank_label == "first" else -1
        lab_lens = (labels != pad).sum(-1)
    if use_data_lengths and data_lengths is not None:
        dat_lens = data_lengths.long()
    else:
        dat_lens = torch.full((B,), T, dtype=torch.long, device=data.device)
    targets = torch.remainder(labels, A)
    log_probs = torch.log_softmax(data, dim=-1)
    loss = TF.ctc_loss(log_probs, targets, dat_lens, lab_lens, blank=blank,
                       reduction="none", zero_infinity=True)
    return torch.where(ctc_infeasible(targets, lab_lens, dat_lens),
                       torch.full((), NO_ALIGNMENT_LOSS, dtype=loss.dtype,
                                  device=loss.device), loss)
