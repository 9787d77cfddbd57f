"""Finding records and rule metadata of the port's static checks: the
counterpart of ``mxnet_tpu/analysis/findings.py`` for the rules the port
runs — the serving rules SRV001/SRV002 (``serving_lint.py``) and the
mxgen rules GEN001/GEN002 (``codegen.py``), with the reference's
wording.  The other rule families are ROADMAP.md queue A, item 13."""
from __future__ import annotations

__all__ = ["Finding", "ERROR", "WARNING", "RULES", "filter_findings"]

ERROR = "error"
WARNING = "warning"

# rule_id -> (default severity, one-line description)
RULES = {
    "SRV001": (ERROR, "symbol is not batch-polymorphic: shapes are "
                      "data-dependent or baked, so padded-bucket serving "
                      "cannot be recompile-free"),
    "SRV002": (WARNING, "Reshape bakes a static batch dimension; every "
                        "serving bucket compiles (or breaks) separately"),
    "GEN001": (ERROR, "fusion chain contains an op outside the "
                      "provable-lowering set: mxgen cannot emit a "
                      "kernel whose semantics it can prove against the "
                      "tape interpreter — the chain stays a "
                      "hand-written-kernel candidate"),
    "GEN002": (ERROR, "generated kernel registered without a passing "
                      "auto-equivalence check: emitted source and tape "
                      "interpreter were never compared at the 1e-5 "
                      "fused-vs-unfused tolerance — an unproven "
                      "lowering must not ship"),
}


class Finding:
    """One lint finding: ``(rule_id, severity, subject, message)``."""
    __slots__ = ("rule_id", "severity", "subject", "message")

    def __init__(self, rule_id, subject, message, severity=None):
        if rule_id not in RULES:
            raise ValueError("unknown rule_id %r" % (rule_id,))
        self.rule_id = rule_id
        self.severity = severity or RULES[rule_id][0]
        self.subject = subject
        self.message = message

    def as_dict(self):
        return {"rule": self.rule_id, "severity": self.severity,
                "subject": self.subject, "message": self.message}

    def __repr__(self):
        return "Finding(%s, %s, %s)" % (self.rule_id, self.subject,
                                        self.severity)

    def __str__(self):
        return "%s %s [%s] %s" % (self.rule_id, self.severity, self.subject,
                                  self.message)


def filter_findings(findings, disable=()):
    """Drop findings whose rule_id is in ``disable``."""
    disable = set(disable)
    return [f for f in findings if f.rule_id not in disable]
