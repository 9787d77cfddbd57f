"""``LogMetricsCallback``: metrics to TensorBoard (reference:
python/mxnet/contrib/tensorboard.py).  It takes the summary writer of
``torch.utils.tensorboard`` or of ``tensorboardX``; with neither
importable, constructing one raises ``ImportError``."""
from __future__ import annotations

__all__ = ["LogMetricsCallback"]


def _writer(logging_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logging_dir)
    except ImportError:
        pass
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(logging_dir)
    except ImportError as e:
        raise ImportError(
            "LogMetricsCallback requires torch.utils.tensorboard or "
            "tensorboardX") from e


class LogMetricsCallback:
    """A batch-end callback writing each metric as a scalar."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = _writer(logging_dir)

    def __call__(self, param):
        self.step += 1
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
