"""``gluon.contrib.rnn`` of the port (reference:
``mxnet_tpu/gluon/contrib/rnn.py``): ``VariationalDropoutCell``, which
applies one dropout mask at every timestep of an unroll (Gal &
Ghahramani), under training only."""
from __future__ import annotations

import torch

from ..rnn.rnn_cell import BidirectionalCell, ModifierCell

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        assert not drop_states or not isinstance(base_cell,
                                                 BidirectionalCell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        super().__init__(base_cell)
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    @staticmethod
    def _mask_like(F, p, like):
        # drawn once per unroll, reused at every step
        return F.Dropout(torch.ones_like(like), p=p, mode="always")

    def hybrid_forward(self, F, inputs, states):
        if not self._train_flag():
            return self.base_cell(inputs, states)
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask_like(F, self.drop_inputs,
                                                   inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            if self._state_masks is None:
                self._state_masks = [
                    self._mask_like(F, self.drop_states, s) for s in states]
            states = [s * m for s, m in zip(states, self._state_masks)]
        out, new_states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask_like(F, self.drop_outputs,
                                                    out)
            out = out * self._output_mask
        return out, new_states
