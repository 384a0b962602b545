"""Learning-rate schedulers: the counterpart of mxnet_tpu/lr_scheduler.py
(reference python/mxnet/lr_scheduler.py).

Pure Python, the JAX package's code: each scheduler is stateful
(`__call__` advances base_lr and logs each change, the reference's
semantics), and `lr_at(num_update)` gives the same schedule as a pure
function of the step index, without touching that state.
"""
import logging
import math


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError

    def lr_at(self, num_update):
        """Pure value of the schedule at `num_update` (no state
        mutation); subclasses override."""
        raise NotImplementedError

    def _orig(self):
        """The base lr as first assigned (the optimizer sets base_lr
        right after construction; __call__ mutates it afterwards, so
        the original is snapshotted at first evaluation)."""
        if getattr(self, '_base_lr_orig', None) is None:
            self._base_lr_orig = self.base_lr
        return self._base_lr_orig


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (reference lr_scheduler.py:44)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError('Schedule step must be greater or equal than 1')
        if factor > 1.0:
            raise ValueError('Factor must be no more than 1 to make lr reduce')
        self.step, self.factor = step, factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def lr_at(self, num_update):
        """Stateless FactorScheduler: the number of crossed step
        boundaries determines the decay count; the decays replay
        ITERATIVELY (lr *= factor, not factor**d) so the value is
        bit-identical to the stateful loop's repeated multiplication,
        including the stop_factor_lr pin."""
        d = 0
        if num_update > self.step:
            d = (num_update - self.step - 1) // self.step + 1
        lr = self._orig()
        for _ in range(d):
            decayed = lr * self.factor
            if decayed < self.stop_factor_lr:
                return self.stop_factor_lr
            lr = decayed
        return lr

    def __call__(self, num_update):
        self._orig()
        # Catch up: every crossed step boundary decays the rate once.
        while num_update > self.count + self.step:
            self.count += self.step
            decayed = self.base_lr * self.factor
            if decayed < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info('Update[%d]: now learning rate arrived at %0.5e,'
                             ' will not change in the future', num_update,
                             self.base_lr)
            else:
                self.base_lr = decayed
                logging.info('Update[%d]: Change learning rate to %0.5e',
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given update milestones (reference
    lr_scheduler.py:99)."""

    def __init__(self, step, factor=1):
        super().__init__()
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError('Schedule step must be an increasing list')
            if _step < 1:
                raise ValueError('Schedule step must be greater or equal than 1')
        if factor > 1.0:
            raise ValueError('Factor must be no more than 1 to make lr reduce')
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def lr_at(self, num_update):
        """Stateless MultiFactorScheduler: one iterative decay per
        milestone strictly below `num_update`."""
        lr = self._orig()
        for s in self.step:
            if num_update > s:
                lr *= self.factor
            else:
                break
        return lr

    def __call__(self, num_update):
        self._orig()
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info('Update[%d]: Change learning rate to %0.5e',
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero over max_update steps."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        self.max_update = max_update
        self.base_lr_orig = base_lr
        self.power = pwr

    def lr_at(self, num_update):
        n = min(num_update, self.max_update)
        return self.base_lr_orig * pow(
            1.0 - float(n) / self.max_update, self.power)

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * pow(
                1.0 - float(num_update) / self.max_update, self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay with an optional linear warm-up (no reference
    counterpart)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0,
                 warmup_steps=0, warmup_begin_lr=0.0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.base_lr_orig = base_lr

    def lr_at(self, num_update):
        if num_update < self.warmup_steps:
            return self.warmup_begin_lr + \
                (self.base_lr_orig - self.warmup_begin_lr) * \
                num_update / max(self.warmup_steps, 1)
        n = min(num_update, self.max_update)
        frac = (n - self.warmup_steps) / \
            max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr_orig - self.final_lr) * \
            (1 + math.cos(math.pi * frac)) / 2

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.warmup_begin_lr + \
                (self.base_lr_orig - self.warmup_begin_lr) * \
                num_update / max(self.warmup_steps, 1)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / \
                max(self.max_update - self.warmup_steps, 1)
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * frac)) / 2
        return self.base_lr
