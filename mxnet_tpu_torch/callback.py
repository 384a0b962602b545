"""Training callbacks: the counterpart of mxnet_tpu/callback.py (reference
python/mxnet/callback.py)."""
import logging
import math
import time


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (role of reference callback.py
    do_checkpoint): saves `prefix-symbol.json` + `prefix-NNNN.params`
    every `period` epochs."""
    from .model import save_checkpoint
    stride = max(1, int(period))

    def _callback(epoch, symbol, arg_params, aux_params):
        completed = epoch + 1
        if completed % stride:
            return
        save_checkpoint(prefix, completed, symbol, arg_params,
                        aux_params)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end metric logger (role of reference callback.py
    log_train_metric)."""
    def _callback(param):
        if param.nbatch % period or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info('Iter[%d] Batch[%d] Train-%s=%f',
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()
    return _callback


class Speedometer:
    """Batch-end throughput logger (role of reference callback.py
    Speedometer): every ``frequent`` batches, report samples/sec for the
    window just ended, folding the running metric values into the same
    line.  With ``auto_reset`` the metric is cleared after each report so
    every line reflects only its own window.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = max(1, int(frequent))
        self.auto_reset = auto_reset
        self._window_start = None  # wall-clock when the current window opened
        self._prev_batch = -1

    def __call__(self, param):
        nbatch = param.nbatch
        if nbatch < self._prev_batch:
            # The batch counter rewound: a new epoch began, so any open
            # timing window spans the epoch boundary and must be dropped.
            self._window_start = None
        self._prev_batch = nbatch
        if self._window_start is None:
            self._window_start = time.time()
            return
        if nbatch % self.frequent:
            return
        elapsed = max(time.time() - self._window_start, 1e-12)
        rate = self.frequent * self.batch_size / elapsed
        metric = param.eval_metric
        if metric is None:
            logging.info('Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec',
                         param.epoch, nbatch, rate)
        else:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            extras = ''.join('\t%s=%f' % pair for pair in pairs)
            logging.info('Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s',
                         param.epoch, nbatch, rate, extras)
        self._window_start = time.time()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = min(max(param.nbatch / float(self.total), 0.0), 1.0)
        done = round(frac * self.bar_len)
        bar = ('=' * done).ljust(self.bar_len, '-')
        logging.info('[%s] %d%%\r', bar, math.ceil(frac * 100))


class LogValidationMetricsCallback:
    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info('Epoch[%d] Validation-%s=%f', param.epoch, name,
                         value)
