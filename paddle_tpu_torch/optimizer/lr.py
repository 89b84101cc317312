"""LR schedulers (port of ``paddle_tpu/optimizer/lr.py``, whole).

Host-only Python: every scheduler returns a Python float from
``__call__``; the optimizer reads it once a step and hands it to its
kernel as a host f32 argument. Parity with the reference's
``fluid/layers/learning_rate_scheduler.py`` (noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup) and
the ``paddle.optimizer.lr`` scheduler classes. ``ReduceOnPlateau.step``
takes a float or a tensor (read on the host).
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * self.warmup_steps ** -1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * \
            (1 - step / decay_steps) ** self.power + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * \
                self.last_epoch / self.warmup_steps + self.start_lr
        if isinstance(self.lr, LRScheduler):
            self.lr.step(self.last_epoch - self.warmup_steps)
            return self.lr()
        return float(self.lr)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            return
        if hasattr(metrics, "item"):     # a tensor: read it on the host
            metrics = float(metrics.item())
        better = (self.best is None or
                  (self.mode == "min" and metrics < self.best - self._thr()) or
                  (self.mode == "max" and metrics > self.best + self._thr()))
        if better:
            self.best = metrics
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    def _thr(self):
        if self.best is None:
            return 0.0
        if self.threshold_mode == "rel":
            return abs(self.best) * self.threshold
        return self.threshold


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        up = int(self.total_steps * self.phase_pct)
        step = min(self.last_epoch, self.total_steps)
        if step <= up and up > 0:
            pct = step / up
            return self.initial_lr + (self.max_lr - self.initial_lr) * \
                (1 - math.cos(math.pi * pct)) / 2
        down = self.total_steps - up
        pct = (step - up) / max(down, 1)
        return self.end_lr + (self.max_lr - self.end_lr) * \
            (1 + math.cos(math.pi * pct)) / 2


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = self.last_epoch // total
        pos = self.last_epoch % total
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        amp = (self.max_lr - self.base_lr) * pct
        if self.mode == "triangular2":
            amp = amp / (2 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp


# legacy function-style decays (fluid.layers.*) returning schedulers
def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    return NoamDecay(d_model, warmup_steps, learning_rate)


def _staircase_decay(learning_rate, decay_steps, staircase, fn):
    """Shared scaffold for the step/decay_steps (+optional floor) decays
    (reference learning_rate_scheduler.py exponential/natural_exp/
    inverse_time family)."""
    class _Decay(LRScheduler):
        def get_lr(self):
            t = self.last_epoch / decay_steps
            if staircase:
                t = math.floor(t)
            return fn(self.base_lr, t)

    return _Decay(learning_rate)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _staircase_decay(learning_rate, decay_steps, staircase,
                            lambda lr, t: lr * decay_rate ** t)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _staircase_decay(learning_rate, decay_steps, staircase,
                            lambda lr, t: lr * math.exp(-decay_rate * t))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    return _staircase_decay(learning_rate, decay_steps, staircase,
                            lambda lr, t: lr / (1.0 + decay_rate * t))


def piecewise_decay(boundaries, values):
    return PiecewiseDecay(boundaries, values)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    class _Cos(LRScheduler):
        def get_lr(self):
            cur_epoch = math.floor(self.last_epoch / step_each_epoch)
            return self.base_lr * 0.5 * (
                math.cos(cur_epoch * math.pi / epochs) + 1)

    return _Cos(learning_rate)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    return PolynomialDecay(learning_rate, decay_steps, end_learning_rate,
                           power, cycle)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    return LinearWarmup(learning_rate, warmup_steps, start_lr, end_lr)


# fluid/dygraph/learning_rate_scheduler.py era names
class CosineDecay(LRScheduler):
    """fluid.dygraph.CosineDecay(learning_rate, step_each_epoch, epochs):
    lr = 0.5 * lr0 * (cos(pi * epoch / epochs) + 1), with epoch =
    step // step_each_epoch. NOT the same signature as
    CosineAnnealingDecay (learning_rate, T_max, eta_min)."""

    def __init__(self, learning_rate, step_each_epoch, epochs,
                 last_epoch=-1, verbose=False):
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        cur_epoch = math.floor(self.last_epoch / self.step_each_epoch)
        return self.base_lr * 0.5 * (
            math.cos(cur_epoch * math.pi / self.epochs) + 1)


LinearLrWarmup = LinearWarmup
ReduceLROnPlateau = ReduceOnPlateau
