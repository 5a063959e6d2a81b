"""Training callbacks (port of ``mxnet_tpu/callback.py``; parity:
python/mxnet/callback.py)."""
from __future__ import annotations

import logging
import math
import time

from .base import MXNetError

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "log_train_metric",
           "module_checkpoint", "resilient_checkpoint"]


def do_checkpoint(prefix, period=1):
    """An epoch-end callback writing ``save_checkpoint(prefix, epoch + 1,
    ...)`` every ``period`` epochs."""
    from .model import save_checkpoint

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def resilient_checkpoint(manager, net, trainer=None, period=1,
                         async_=False):
    """``mxnet_tpu``'s crash-safe checkpoint callback needs its
    ``resilience.CheckpointManager``: ROADMAP Queue 1 item 12."""
    raise MXNetError("resilient_checkpoint needs resilience/ "
                     "(CheckpointManager), ROADMAP Queue 1 item 12, which "
                     "is not ported")


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()

    return _callback


class Speedometer:
    """Logs samples/s every ``frequent`` batches over the window since the
    last line, with the metric's values; a batch count that goes back (a
    new epoch) restarts the window. ``rates`` keeps every rate logged."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.rates = []
        self._window_start = None
        self._prev_nbatch = 0

    def __call__(self, param):
        nbatch = param.nbatch
        if nbatch < self._prev_nbatch:
            self._window_start = None
        self._prev_nbatch = nbatch
        if self._window_start is None:
            self._window_start = time.monotonic()
            return
        if nbatch % self.frequent != 0:
            return
        elapsed = time.monotonic() - self._window_start
        rate = (self.frequent * self.batch_size / elapsed) if elapsed > 0 \
            else float("inf")
        self.rates.append(rate)
        parts = ["Epoch[%d] Batch [%d-%d]  speed=%.2f samples/sec"
                 % (param.epoch, nbatch - self.frequent, nbatch, rate)]
        if param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                parts.append("%s=%f" % (name, value))
            if self.auto_reset:
                param.eval_metric.reset_local()
        logging.info("  ".join(parts))
        self._window_start = time.monotonic()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s", prog_bar, percents, "%")
