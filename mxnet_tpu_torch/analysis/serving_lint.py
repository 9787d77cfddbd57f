"""Serving lint: can this Symbol be served recompile-free from buckets?
The port of SRV001/SRV002 of ``mxnet_tpu/analysis/serving_lint.py``
(``:60-133``), which need only shape inference.

- **SRV001** (error): shape inference fails when the batch axis is
  scaled, or an output's batch axis does not follow the input's.  The
  runner refuses such a symbol.
- **SRV002** (warning): a ``Reshape`` whose target bakes the batch
  dimension.

SRV003/SRV004 price memory with mxcost and SRV006 scans decode sources:
they are ROADMAP.md queue A, item 13.
"""
from __future__ import annotations

from ..ops import registry as _reg

__all__ = ["Finding", "ERROR", "WARNING", "lint_serving", "render_text"]

ERROR = "error"
WARNING = "warning"
_SEVERITY = {"SRV001": ERROR, "SRV002": WARNING}
_RESHAPE_OPS = frozenset({"Reshape", "reshape"})


class Finding:
    """One lint finding: ``(rule_id, severity, subject, message)``."""
    __slots__ = ("rule_id", "severity", "subject", "message")

    def __init__(self, rule_id, subject, message):
        self.rule_id = rule_id
        self.severity = _SEVERITY[rule_id]
        self.subject = subject
        self.message = message

    def __str__(self):
        return "%s %s [%s] %s" % (self.rule_id, self.severity, self.subject,
                                  self.message)


def render_text(findings, title="serving lint"):
    if not findings:
        return "%s: clean (0 findings)" % title
    return "\n".join(["%s: %d finding(s)" % (title, len(findings))]
                     + ["  %s" % f for f in findings])


def _scaled(shapes, factor):
    return {name: (int(s[0]) * factor,) + tuple(s[1:])
            for name, s in shapes.items()}


def _infer(symbol, shapes):
    try:
        arg_shapes, out_shapes, _aux = symbol.infer_shape(**shapes)
    except Exception as e:  # a graph that cannot take these shapes
        return None, str(e)
    if arg_shapes is None or out_shapes is None:
        return None, "shape inference is underdetermined"
    return out_shapes, None


def _lint_batch_polymorphism(symbol, data_shapes):
    """Scale the data batch axis and require every output batch axis to
    follow proportionally (the padded-bucket execution model)."""
    base = {name: tuple(s) for name, s in data_shapes.items()}
    if not base or any(len(s) == 0 for s in base.values()):
        return []
    subject = symbol.name or "<graph>"
    out0, err = _infer(symbol, base)
    if err is not None:
        return [Finding("SRV001", subject,
                        "shape inference fails at the declared data "
                        "shapes %r: %s" % (base, err))]
    factor = 2
    out1, err = _infer(symbol, _scaled(base, factor))
    if err is not None:
        return [Finding("SRV001", subject,
                        "scaling the batch axis by %d breaks shape "
                        "inference (%s) — requests of different sizes "
                        "cannot share padded buckets" % (factor, err))]
    findings = []
    names = symbol.list_outputs()
    for i, (s0, s1) in enumerate(zip(out0, out1)):
        if not s0:
            continue
        want = (int(s0[0]) * factor,) + tuple(s0[1:])
        if tuple(s1) != want:
            findings.append(Finding(
                "SRV001", names[i] if i < len(names) else subject,
                "output %d has shape %r at batch %r but %r at batch x%d "
                "(expected %r): the batch axis is baked or data-"
                "dependent, so bucket padding would mix rows or "
                "recompile per request size"
                % (i, tuple(s0), {k: v[0] for k, v in base.items()},
                   tuple(s1), factor, want)))
    return findings


def _lint_static_batch_reshape(symbol):
    out = []
    for n in symbol._nodes():
        if n.op not in _RESHAPE_OPS:
            continue
        shape = _reg.canonicalize(n.attrs.get("shape", ()))
        if not isinstance(shape, (tuple, list)) or not shape:
            continue
        lead = shape[0]
        if isinstance(lead, int) and lead > 0:
            out.append(Finding(
                "SRV002", n.name,
                "Reshape target %r bakes the batch dimension to %d; each "
                "serving bucket traces its own program (or fails) — use "
                "dim code 0 (copy) or -1 (infer) for the batch axis"
                % (tuple(shape), lead)))
    return out


def lint_serving(symbol, data_shapes=None, disable=()):
    """SRV002 over ``symbol``, and SRV001 when ``data_shapes`` ({data
    name: full shape with the batch axis}) are given."""
    findings = _lint_static_batch_reshape(symbol)
    if data_shapes:
        findings += _lint_batch_polymorphism(symbol, data_shapes)
    return [f for f in findings if f.rule_id not in set(disable)]
