"""Static checks of the port: the serving rules SRV001/SRV002
(``serving_lint.py``), the mxgen back end that lowers fusion chains to
CUDA kernels with its GEN001/GEN002 lint (``codegen.py``), and the
kernel cost registry (``cost.py``).  The rest of ``mxnet_tpu/analysis``
(mxlint, mxcost, mxshard, the chain miner) is ROADMAP.md queue A, item
13."""
from .findings import filter_findings
from .serving_lint import ERROR, WARNING, Finding, lint_serving, render_text

__all__ = ["ERROR", "WARNING", "Finding", "filter_findings", "lint_serving",
           "render_text"]
