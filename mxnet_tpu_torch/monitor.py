"""Per-layer numeric tracing (`mx.mon.Monitor`), the counterpart of
mxnet_tpu/monitor.py (reference python/mxnet/monitor.py): a callback on
executors that receives every node's output of each monitored forward
(`Executor.set_monitor_callback`), and the arguments and aux states at
`toc`.
"""
import logging
import re

from . import ndarray as nd


class Monitor(object):
    """Collects per-layer output statistics every `interval` batches."""

    def __init__(self, interval, stat_func=None, pattern='.*', sort=False):
        if stat_func is None:
            def stat_func(x):
                """mean absolute value (reference default: sum(|x|)/size)"""
                return nd.sum(nd.abs(x)) / x.size
        self.stat_func = stat_func
        self.interval = interval
        self.activated, self.sort = False, sort
        self.queue, self.exes = [], []
        self.step = 0
        self.re_pattern = re.compile(pattern)

        def stat_helper(name, array):
            if not self.activated or not self.re_pattern.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        # the executor reads .active to decide whether a forward collects
        # every node's outputs
        stat_helper.active = False
        self.stat_helper = stat_helper

    def install(self, exe):
        """Attach to an executor."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch if it is due."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
            self.stat_helper.active = True
        self.step += 1

    def toc(self):
        """Stop collecting; also record the arguments and aux states.
        Returns [(step, name, stat string)]."""
        if not self.activated:
            return []
        for exe in self.exes:
            for name, array in list(exe.arg_dict.items()) + \
                    list(exe.aux_dict.items()):
                if self.re_pattern.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        self.stat_helper.active = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, nd.NDArray):
                v_list = [v_list]
            if not isinstance(v_list, list):
                raise TypeError('stat_func must return an NDArray or a '
                                'list of them, got %r' % (v_list,))
            s = ''
            for v in v_list:
                if v.shape == (1,) or v.shape == ():
                    s += str(v.asnumpy().reshape(-1)[0]) + '\t'
                else:
                    s += str(v.asnumpy()) + '\t'
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """Collect and log the stats."""
        res = self.toc()
        for n, k, v in res:
            logging.info('Batch: %7d %30s %s', n, k, v)
        return res
