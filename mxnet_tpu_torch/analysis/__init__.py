"""Static checks of the port: the serving rules SRV001/SRV002
(``serving_lint.py``).  The rest of ``mxnet_tpu/analysis`` (mxlint,
mxcost, mxshard, mxgen) is ROADMAP.md queue A, item 13."""
from .serving_lint import ERROR, WARNING, Finding, lint_serving, render_text

__all__ = ["ERROR", "WARNING", "Finding", "lint_serving", "render_text"]
