"""Post-training quantization (PTQ) for serving: the Module route of
``mxnet_tpu/serving/quantize.py``.

- :func:`ptq_quantize_module` — the contrib graph rewrite
  (``contrib.quantization.quantize_model``) driven by a real calibration
  iterator, never synthetic data, with every weight code and range
  digested (sha256) for the serving provenance;
- :func:`per_channel_scales` — symmetric per-output-channel int8 codes
  and scales of a weight.

The Gluon route (``ptq_quantize_net``, ``build_quantized_net``,
``quantized_runner_from_checkpoint``) needs Gluon serving and the mlops
checkpoint tier: ROADMAP.md queue A, items 2 and 11.
"""
from __future__ import annotations

import hashlib

import numpy as _np

from ..base import MXNetError

__all__ = ["ptq_quantize_module", "per_channel_scales"]


def per_channel_scales(w):
    """Symmetric per-output-channel int8 scales of an ``(O, ...)`` weight:
    ``scales[c] = amax(|w[c]|) / 127`` (floored so an all-zero channel
    quantizes to code 0).  Returns ``(codes int8, scales f32 (O,))``."""
    w = _np.asarray(w, _np.float32)
    flat = w.reshape(w.shape[0], -1)
    scales = _np.abs(flat).max(axis=1) / 127.0
    scales = _np.maximum(scales, 1e-12).astype(_np.float32)
    codes = _np.clip(_np.round(flat / scales[:, None]), -127, 127) \
        .astype(_np.int8)
    return codes.reshape(w.shape), scales


def ptq_quantize_module(sym, arg_params, aux_params, calib_data,
                        data_names=("data",), num_calib_examples=None,
                        calib_mode="naive", excluded_sym_names=None):
    """PTQ for Module/symbol checkpoints: ``quantize_model`` over a REAL
    calibration iterator, per-tensor scales (the reference's triple ABI).
    Returns ``(qsym, qarg, aux, report)``; ``report["digest"]`` is the
    sha256 over every ``*_quantized`` / ``*_min`` / ``*_max`` array in
    name order, the same bytes the reference digests."""
    from ..contrib.quantization import quantize_model

    if calib_data is None:
        raise MXNetError(
            "ptq_quantize_module needs a real calibration iterator; "
            "quantizing against synthetic data is the path this pipeline "
            "retires")
    qsym, qarg, aux = quantize_model(
        sym, arg_params, aux_params, data_names=tuple(data_names),
        calib_mode=calib_mode, calib_data=calib_data,
        num_calib_examples=num_calib_examples,
        excluded_sym_names=excluded_sym_names)
    h = hashlib.sha256()
    for name in sorted(qarg):
        if name.endswith(("_quantized", "_min", "_max")):
            h.update(name.encode())
            h.update(_np.ascontiguousarray(qarg[name].asnumpy()).tobytes())
    report = {"digest": h.hexdigest(), "calib_mode": str(calib_mode),
              "kind": "ptq_per_tensor_module"}
    return qsym, qarg, aux, report


def _gluon_route(*args, **kwargs):
    raise NotImplementedError(
        "the Gluon PTQ route (per-channel QuantizedDense) needs Gluon "
        "serving: ROADMAP.md queue A, items 2 and 11")


ptq_quantize_net = build_quantized_net = _gluon_route
quantized_runner_from_checkpoint = _gluon_route
