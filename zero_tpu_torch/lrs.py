"""Learning-rate schedule zoo (host-side, passed to the train step).

A copy of ``zero_tpu/lrs.py`` (the port imports nothing of the JAX
package). Parity targets: reference lrs/ -- noam (noamlr.py:28-34), gnmt+
(gnmtplr.py:36-45), epoch (epochlr.py:25-28), score-decay
(scorelr.py:33-42, replaying history on resume), cosine warm restarts
(cosinelr.py:43-60), vanilla. Like the reference (lrs/lr.py docstring), the
rate is computed on the host each step and passed to the step as an
argument.
"""

from __future__ import annotations

import math


class Lr:
    """Base schedule: hooks before/after epoch, per step, after eval;
    ``get_lr`` clamps to [min, max] (lrs/lr.py:14-45)."""

    def __init__(self, init_lrate, min_lrate, max_lrate, name="lr"):
        self.name = name
        self.init_lrate = init_lrate
        self.lrate = init_lrate
        self.min_lrate = min_lrate
        self.max_lrate = max_lrate
        if self.max_lrate <= self.min_lrate:
            raise ValueError("min_lrate must be < max_lrate")

    def before_epoch(self, eidx=None):
        pass

    def after_epoch(self, eidx=None):
        pass

    def step(self, step):
        pass

    def after_eval(self, eval_score):
        pass

    def get_lr(self):
        return max(min(self.lrate, self.max_lrate), self.min_lrate)


class VanillaLr(Lr):
    pass


class NoamDecayLr(Lr):
    """init * d^-0.5 * min((s+1) * w^-1.5, (s+1)^-0.5)."""

    def __init__(self, init_lr, min_lr, max_lr, warmup_steps, hidden_size,
                 name="noam_decay_lr"):
        super().__init__(init_lr, min_lr, max_lr, name=name)
        self.warmup_steps = warmup_steps
        self.hidden_size = hidden_size

    def step(self, step):
        s = float(step)
        w = float(self.warmup_steps)
        multiplier = float(self.hidden_size) ** -0.5
        decay = multiplier * min((s + 1) * (w ** -1.5), (s + 1) ** -0.5)
        self.lrate = self.init_lrate * decay


class GNMTPDecayLr(Lr):
    """GNMT+ warmup ramp to xn then exponential decay between start/end."""

    def __init__(self, init_lr, min_lr, max_lr, warmup_steps, nstable,
                 lrdecay_start, lrdecay_end, name="gnmtp_decay_lr"):
        super().__init__(init_lr, min_lr, max_lr, name=name)
        if nstable < 1:
            raise ValueError("nstable must be >= 1")
        self.warmup_steps = warmup_steps
        self.nstable = nstable
        self.lrdecay_start = lrdecay_start
        self.lrdecay_end = lrdecay_end

    def step(self, step):
        t = float(step)
        warmup = float(self.warmup_steps)
        peak = float(self.nstable)
        decay_start = float(self.lrdecay_start)
        decay_end = float(self.lrdecay_end)
        # Linear warmup from 1x toward the peak multiplier over the warmup
        # window, saturating at `peak`.
        ramp = min(1.0 + t * (peak - 1.0) / (peak * warmup), peak)
        # Exponential decay: starting from `peak`, shrink by a factor of
        # 1/(2*peak) for every (decay_end - decay_start)/peak steps past
        # decay_start/peak.
        span = decay_end - decay_start
        decayed = peak * (2.0 * peak) ** ((decay_start - peak * t) / span)
        self.lrate = self.init_lrate * min(ramp, decayed)


class EpochDecayLr(Lr):
    def __init__(self, init_lr, min_lr, max_lr, decay=0.5,
                 name="epoch_decay_lr"):
        super().__init__(init_lr, min_lr, max_lr, name=name)
        self.decay = decay

    def after_epoch(self, eidx=None):
        if eidx is None:
            self.lrate = self.init_lrate * self.decay
        else:
            self.lrate = self.init_lrate * self.decay ** int(eidx)


class ScoreDecayLr(Lr):
    """Halve after `patience` consecutive non-improving eval scores;
    history replay restores the state on resume (scorelr.py:30-42)."""

    def __init__(self, init_lr, min_lr, max_lr, history_scores=None,
                 decay=0.5, patience=1, name="score_decay_lr"):
        super().__init__(init_lr, min_lr, max_lr, name=name)
        self.decay = decay
        self.patience = patience
        self.bad_counter = 0
        self.best_score = -1e9
        if history_scores:
            for score in history_scores:
                self.after_eval(score)

    def after_eval(self, eval_score):
        if eval_score > self.best_score:
            self.best_score = eval_score
            self.bad_counter = 0
        else:
            self.bad_counter += 1
            if self.bad_counter >= self.patience:
                self.lrate = self.lrate * self.decay
                self.bad_counter = 0


class CosineDecayLr(Lr):
    """Fairseq-style cosine schedule with warm restarts and period growth."""

    def __init__(self, init_lr, min_lr, max_lr, warmup_steps, decay,
                 t_mult=1, update_period=5000, name="cosine_decay_lr"):
        super().__init__(init_lr, min_lr, max_lr, name=name)
        self.warmup_steps = warmup_steps
        self.warmup_init_lr = init_lr
        self.warmup_end_lr = max_lr
        self.t_mult = t_mult
        self.period = update_period
        self.lr_step = ((self.warmup_end_lr - self.warmup_init_lr)
                        / warmup_steps) if warmup_steps > 0 else 1.0
        self.decay = decay

    def step(self, step):
        if step < self.warmup_steps:
            self.lrate = self.warmup_init_lr + step * self.lr_step
        else:
            curr = step - self.warmup_steps
            if self.t_mult != 1:
                i = math.floor(math.log(
                    1 - curr / self.period * (1 - self.t_mult), self.t_mult))
                t_i = self.t_mult ** i * self.period
                t_curr = curr - (1 - self.t_mult ** i) \
                    / (1 - self.t_mult) * self.period
            else:
                i = math.floor(curr / self.period)
                t_i = self.period
                t_curr = curr - self.period * i
            shrink = self.decay ** i
            min_lr = self.min_lrate * shrink
            max_lr = self.max_lrate * shrink
            self.lrate = min_lr + 0.5 * (max_lr - min_lr) \
                * (1 + math.cos(math.pi * t_curr / t_i))


def get_lr(params):
    """Schedule factory from config (lrs/__init__.py:6-62)."""
    strategy = params.lrate_strategy.lower()
    if strategy == "noam":
        return NoamDecayLr(params.lrate, params.min_lrate, params.max_lrate,
                           params.warmup_steps, params.hidden_size)
    if strategy == "gnmt+":
        return GNMTPDecayLr(params.lrate, params.min_lrate, params.max_lrate,
                            params.warmup_steps, params.nstable,
                            params.lrdecay_start, params.lrdecay_end)
    if strategy == "epoch":
        return EpochDecayLr(params.lrate, params.min_lrate, params.max_lrate,
                            params.lrate_decay)
    if strategy == "score":
        history = []
        if "recorder" in params:
            history = [v[1] for v in params.recorder.valid_script_scores]
        return ScoreDecayLr(params.lrate, params.min_lrate, params.max_lrate,
                            history_scores=history, decay=params.lrate_decay,
                            patience=params.lrate_patience)
    if strategy == "vanilla":
        return VanillaLr(params.lrate, params.min_lrate, params.max_lrate)
    if strategy == "cosine":
        return CosineDecayLr(params.lrate, params.min_lrate, params.max_lrate,
                             params.warmup_steps, params.lrate_decay,
                             t_mult=params.cosine_factor,
                             update_period=params.cosine_period)
    raise NotImplementedError("%s is not supported" % strategy)
