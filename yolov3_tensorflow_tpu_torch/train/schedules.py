"""Learning-rate schedules (counterpart of
`yolov3_tensorflow_tpu/train/schedules.py`).

fixed, staircase exponential with a floor, cosine with a lower bound, cosine
with warm restarts (t_mul 2), piecewise constant, and the linear warm-up
wrapper. Each schedule is a function of the integer step that returns a
Python float: the trainer knows the step on the host, so reading the
learning rate never waits on the device. (The JAX schedules compute in
float32 on the device; the values agree to float32 rounding.)
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def fixed(lr: float) -> Schedule:
    return lambda step: float(lr)


def exponential(lr_init: float, decay_steps: int, decay_factor: float,
                lower_bound: float = 0.0) -> Schedule:
    """Staircase exponential decay with a floor."""
    def fn(step):
        p = math.floor(step / decay_steps)
        return max(lr_init * decay_factor ** p, lower_bound)
    return fn


def cosine(lr_init: float, total_steps: int, lower_bound: float = 0.0
           ) -> Schedule:
    """lower + 0.5*(init-lower)*(1+cos(pi*step/total)); step/total is not
    clamped at 1."""
    def fn(step):
        t = step / float(total_steps)
        return lower_bound + 0.5 * (lr_init - lower_bound) * (
            1.0 + math.cos(t * math.pi))
    return fn


def cosine_restarts(lr_init: float, first_decay_steps: int,
                    t_mul: float = 2.0, m_mul: float = 1.0,
                    alpha: float = 0.0) -> Schedule:
    """SGDR warm restarts (tf.train.cosine_decay_restarts semantics)."""
    def fn(step):
        s = step / float(first_decay_steps)
        if t_mul == 1.0:
            i_restart = math.floor(s)
            frac = s - i_restart
        else:
            # number of completed cycles n solves sum_{k<n} t_mul^k <= s
            i_restart = math.floor(
                math.log1p(s * (t_mul - 1.0)) / math.log(t_mul))
            sum_r = (t_mul ** i_restart - 1.0) / (t_mul - 1.0)
            frac = (s - sum_r) / t_mul ** i_restart
        m_fac = m_mul ** i_restart
        cosine_decayed = 0.5 * m_fac * (1.0 + math.cos(math.pi * frac))
        return lr_init * ((1 - alpha) * cosine_decayed + alpha)
    return fn


def piecewise(boundaries: Sequence[float], values: Sequence[float]
              ) -> Schedule:
    """Piecewise constant: values[i] from boundaries[i-1] (inclusive)."""
    if len(values) != len(boundaries) + 1:
        raise ValueError(f"piecewise needs one more value than boundaries, "
                         f"got {len(values)} and {len(boundaries)}")
    bs = [float(b) for b in boundaries]
    vs = [float(v) for v in values]

    def fn(step):
        return vs[sum(1 for b in bs if step >= b)]
    return fn


def with_warmup(schedule: Schedule, lr_init: float, warmup_steps: int
                ) -> Schedule:
    """Linear warm-up for the first `warmup_steps`, then `schedule` applied
    to (step - warmup_steps)."""
    def fn(step):
        if step < warmup_steps:
            return lr_init * step / float(max(warmup_steps, 1))
        return schedule(step - warmup_steps)
    return fn


def build_schedule(cfg) -> Schedule:
    """The schedule a finalized Config describes."""
    t = cfg.train
    total = cfg.train_batch_num or 1
    if t.lr_type == "fixed":
        sched = fixed(t.learning_rate_init)
    elif t.lr_type == "exponential":
        sched = exponential(t.learning_rate_init, max(cfg.lr_decay_freq, 1),
                            t.lr_decay_factor, t.lr_lower_bound)
    elif t.lr_type == "cosine_decay":
        train_steps = max(
            int((t.total_epochs - float(t.use_warm_up) * t.warm_up_epoch)
                * total), 1)
        sched = cosine(t.learning_rate_init, train_steps, t.lr_lower_bound)
    elif t.lr_type == "cosine_decay_restart":
        sched = cosine_restarts(t.learning_rate_init, max(cfg.lr_decay_freq, 1))
    elif t.lr_type == "piecewise":
        boundaries = cfg.pw_boundaries_steps or tuple(
            float(b) * total for b in t.pw_boundaries)
        sched = piecewise(boundaries, t.pw_values)
    else:
        raise ValueError(f"unsupported lr_type: {t.lr_type!r}")
    if t.use_warm_up:
        sched = with_warmup(sched, t.learning_rate_init,
                            int(t.warm_up_epoch * total))
    return sched
