"""Train state and optimizer factory (torch twin of
``spec_tpu/train/state.py``).

The JAX package builds an optax ``GradientTransformation`` from the
``OPTIMIZER`` config node and keeps params, BN statistics and optimizer
state in one pytree. Here :func:`make_optimizer` returns a
:class:`Transform` (the rule, with no tensors), and
:func:`create_train_state` binds it to a model's tensors as an
:class:`Optimizer`, whose state lives on the model's device.

Every update is a fixed sequence of ``torch._foreach_*`` operations on
device tensors: the update count, the learning rate (a tensor computed
from the count by the schedule) and the moments. No host value changes
between updates, so an update can sit inside a captured CUDA graph (the
counterpart of the JAX step's ``jax.jit``), and the CPU runs the same
code. ``torch.optim``'s optimizers do not serve both: its Adam refuses
``capturable=True`` for CPU tensors, and its SGD turns a tensor learning
rate into a host value. The rules are optax's:

* ``adam``: L2 folded into the gradient before the moments (torch's
  ``Adam(weight_decay=wd)``), then ``optax.adam``;
* ``adamw``: optax's decoupled decay ``update + wd * param``, scaled by
  the learning rate with the Adam direction;
* ``sgd``: optional L2, optional momentum (optax's trace: ``t = g + m t``);
* ``CLIP_GRAD_NORM``: optax's global-norm clip (``g * c / |g|`` when
  ``|g| >= c``; ``torch.nn.utils.clip_grad_norm_`` divides by ``|g| +
  1e-6`` instead), before any decay;
* ``GRAD_ACCUM_STEPS = k``: ``optax.MultiSteps``, a running mean of k
  micro-batches' gradients, one update per k calls; the parameters and
  the update count do not move in between;
* schedules count optimizer updates, not micro-batches.

``freeze_buffers``: the HMR head keeps ``init_pose/init_shape/init_cam``
as buffers, which the optimizer leaves alone (the reference's frozen
mean params). With ``freeze_buffers=False`` they are made trainable, as
the JAX head's params are when nothing freezes them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch

INIT_BUFFERS = ('init_pose', 'init_shape', 'init_cam')
B1, B2, EPS = 0.9, 0.999, 1e-8     # optax.adam's defaults, the reference's

Schedule = Callable[[torch.Tensor], torch.Tensor]


# -- schedules (optax's, on a float32 count tensor) ------------------------


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``: init -> end over ``steps`` updates."""
    if steps <= 0:
        return lambda count: count * 0.0 + init

    def schedule(count):
        frac = 1.0 - torch.clamp(count, 0.0, float(steps)) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """``optax.cosine_decay_schedule`` with exponent 1."""

    def schedule(count):
        c = torch.clamp(count, max=float(decay_steps))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _warmup_cosine(init: float, peak: float, warmup: int, total: int,
                   end: float) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: ``total`` counts the
    warmup too."""
    alpha = 0.0 if peak == 0.0 else end / peak
    ramp = _linear(init, peak, warmup)
    cosine = _cosine(peak, total - warmup, alpha)

    def schedule(count):
        return torch.where(count < warmup, ramp(count),
                           cosine(count - warmup))

    return schedule


def _staircase(lr: float, steps: int, rate: float) -> Schedule:
    """``optax.exponential_decay(staircase=True)``."""

    def schedule(count):
        return lr * rate ** torch.floor(count / steps)

    return schedule


def lr_schedule(lr: float, schedule: str = '', warmup_steps: int = 0,
                decay_steps: int = 0, decay_rate: float = 0.1,
                min_lr_ratio: float = 0.0) -> Union[float, Schedule]:
    """Learning-rate schedule factory: '' / 'constant' (optional linear
    warmup), 'cosine' (warmup to ``lr``, then a cosine to ``lr *
    min_lr_ratio`` over ``decay_steps`` more updates) or 'step'
    (``lr * decay_rate ** (count // decay_steps)``). Returns a float
    (constant, no warmup) or a function of the update count."""
    schedule = (schedule or 'constant').lower()
    if schedule == 'constant':
        return _linear(0.0, lr, warmup_steps) if warmup_steps else lr
    if schedule == 'cosine':
        if decay_steps <= 0:
            raise ValueError("SCHEDULE='cosine' needs DECAY_STEPS > 0 "
                             '(length of the cosine ramp-down, not '
                             'counting WARMUP_STEPS)')
        return _warmup_cosine(0.0 if warmup_steps else lr, lr, warmup_steps,
                              warmup_steps + decay_steps, lr * min_lr_ratio)
    if schedule == 'step':
        if decay_steps <= 0:
            raise ValueError("SCHEDULE='step' needs DECAY_STEPS > 0 "
                             '(interval between LR drops)')
        return _staircase(lr, decay_steps, decay_rate)
    raise ValueError(f'unknown OPTIMIZER.SCHEDULE {schedule!r}; '
                     "use '', 'constant', 'cosine', or 'step'")


# -- the rule and its bound state -------------------------------------------


@dataclasses.dataclass(frozen=True)
class Transform:
    """An update rule, the counterpart of an optax
    ``GradientTransformation``; :meth:`init` binds it to tensors."""

    kind: str                          # 'adam' | 'adamw' | 'sgd'
    learning_rate: Union[float, Schedule] = 1e-4
    weight_decay: float = 0.0
    momentum: Optional[float] = None   # sgd only
    clip_norm: float = 0.0
    freeze_buffers: bool = False
    every_k: int = 1

    def init(self, params) -> 'Optimizer':
        return Optimizer(self, list(params))


def adam(learning_rate=1e-4, weight_decay: float = 0.0) -> Transform:
    """The reference optimizer: Adam, with optional L2 folded into the
    gradient (torch's ``Adam(weight_decay=wd)``, not AdamW)."""
    return Transform('adam', learning_rate, float(weight_decay))


def make_optimizer(opt_cfg, freeze_buffers: bool = False,
                   grad_accum_steps: int = 1) -> Transform:
    """The rule of an ``OPTIMIZER`` config node: TYPE / LR / WD, and the
    optional SCHEDULE, WARMUP_STEPS, DECAY_STEPS, DECAY_RATE,
    MIN_LR_RATIO, CLIP_GRAD_NORM and MOMENTUM (all off by default)."""
    lr = lr_schedule(
        float(opt_cfg.LR),
        schedule=getattr(opt_cfg, 'SCHEDULE', ''),
        warmup_steps=int(getattr(opt_cfg, 'WARMUP_STEPS', 0) or 0),
        decay_steps=int(getattr(opt_cfg, 'DECAY_STEPS', 0) or 0),
        decay_rate=float(getattr(opt_cfg, 'DECAY_RATE', 0.1)),
        min_lr_ratio=float(getattr(opt_cfg, 'MIN_LR_RATIO', 0.0)),
    )
    opt_type = (getattr(opt_cfg, 'TYPE', 'adam') or 'adam').lower()
    wd = float(getattr(opt_cfg, 'WD', 0.0) or 0.0)
    momentum = None
    if opt_type == 'sgd':
        momentum = float(getattr(opt_cfg, 'MOMENTUM', 0.9)) or None
    elif opt_type not in ('adam', 'adamw'):
        raise ValueError(f'unknown OPTIMIZER.TYPE {opt_type!r}; '
                         "use 'adam', 'adamw', or 'sgd'")
    return Transform(
        opt_type, lr, wd, momentum,
        clip_norm=float(getattr(opt_cfg, 'CLIP_GRAD_NORM', 0.0) or 0.0),
        freeze_buffers=bool(freeze_buffers),
        every_k=max(int(grad_accum_steps or 1), 1))


class Optimizer:
    """A :class:`Transform` bound to ``params``, with its state on their
    device: ``count`` (updates applied), the moments, and the
    accumulated gradient under ``every_k > 1`` (``acc``, and ``mini``,
    micro-batches in it).

    Under FSDP (:meth:`shard`, ``parallel.shard_like``) the rule steps on
    ``targets``, this rank's slices of the sharded leaves (views of the
    parameters) and the replicated leaves whole, with the slots at the
    targets' shapes; ``step`` takes the targets' gradients and ends by
    gathering the updated slices into the whole parameters. Without a
    layout ``targets`` is ``params``."""

    def __init__(self, tx: Transform, params: list):
        if not params:
            raise ValueError('no trainable tensors')
        self.tx = tx
        self.params = params
        self.targets = params
        self.layout = None
        dev = params[0].device
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        self.slots = {}
        if tx.kind in ('adam', 'adamw'):
            self.slots['mu'], self.slots['nu'] = zeros(), zeros()
        elif tx.momentum:
            self.slots['trace'] = zeros()
        if tx.every_k > 1:
            self.slots['acc'] = zeros()
            self.mini = torch.zeros((), dtype=torch.float32, device=dev)
        # Micro-batches since the last update, as the host counts them
        # (it picks the accumulating or the updating step).
        self.host_mini = 0

    @torch.no_grad()
    def shard(self, layout) -> None:
        """Step on ``layout``'s slices from now on (a
        ``parallel.FsdpLayout`` over :attr:`params`): each slot keeps
        this rank's slice of its current value."""
        if self.layout is not None:
            raise ValueError('the optimizer state is already sharded')
        if layout.params is not self.params:
            raise ValueError('the layout is not over these tensors')
        self.layout = layout
        self.targets = layout.local
        self.slots = {k: [layout.slice(i, t).clone() for i, t in enumerate(v)]
                      for k, v in self.slots.items()}

    def slot_bytes(self) -> int:
        """Bytes of the slots this rank holds."""
        return sum(t.numel() * t.element_size()
                   for ts in self.slots.values() for t in ts)

    def will_update(self) -> bool:
        """Does the next micro-batch end an accumulation window?"""
        return self.host_mini + 1 >= self.tx.every_k

    def _learning_rate(self) -> torch.Tensor:
        lr = self.tx.learning_rate
        if callable(lr):
            return lr(self.count).to(torch.float32)
        return self.count * 0.0 + float(lr)

    @torch.no_grad()
    def step(self, grads: list, update: bool) -> None:
        """One micro-batch's gradients (of :attr:`targets`): accumulate
        them (``every_k > 1``) and, when ``update``, apply the rule.
        Device operations (and, under a layout, its collectives) only;
        the caller moves ``host_mini``."""
        tx = self.tx
        if tx.every_k > 1:
            acc = self.slots['acc']
            self.mini.add_(1.0)
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), self.mini))
            if not update:
                return
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            self.mini.zero_()
        elif not update:
            raise ValueError('every micro-batch updates when every_k is 1')
        if tx.clip_norm:
            norm = (self.layout.global_norm(grads) if self.layout
                    else torch.linalg.vector_norm(
                        torch.stack(torch._foreach_norm(grads))))
            factor = torch.where(norm < tx.clip_norm,
                                 torch.ones_like(norm), tx.clip_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        if tx.weight_decay and tx.kind in ('adam', 'sgd'):
            grads = torch._foreach_add(grads, self.targets,
                                       alpha=tx.weight_decay)
        if tx.kind in ('adam', 'adamw'):
            mu, nu = self.slots['mu'], self.slots['nu']
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - B1)
            torch._foreach_mul_(nu, B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
            t = self.count + 1.0
            mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(B1, t))
            nu_hat = torch._foreach_div(nu, 1.0 - torch.pow(B2, t))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, EPS)
            direction = torch._foreach_div(mu_hat, denom)
            if tx.kind == 'adamw' and tx.weight_decay:
                torch._foreach_add_(direction, self.targets,
                                    alpha=tx.weight_decay)
        elif tx.momentum:
            trace = self.slots['trace']
            torch._foreach_mul_(trace, tx.momentum)
            torch._foreach_add_(trace, grads)
            direction = trace
        else:
            direction = grads
        torch._foreach_sub_(self.targets, torch._foreach_mul(
            direction, self._learning_rate()))
        self.count.add_(1.0)
        if self.layout is not None:
            self.layout.gather_params()

    def state_dict(self) -> dict:
        """A copy of the state on the CPU, each slot whole. Under a layout
        the slots are gathered over the shard group: every rank of it
        calls this."""
        def copy(t):
            return t.detach().to('cpu', copy=True)

        def whole(ts):
            return self.layout.gather_whole(ts) if self.layout else ts

        out = {'kind': self.tx.kind, 'count': copy(self.count),
               'host_mini': self.host_mini,
               'slots': {k: [copy(t) for t in whole(v)]
                         for k, v in self.slots.items()}}
        if self.tx.every_k > 1:
            out['mini'] = copy(self.mini)
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a saved state (whole slots, whatever layout saved it)
        into this one's tensors, in place (graphs captured on them stay
        valid); under a layout each slot takes this rank's slice."""
        if sd['kind'] != self.tx.kind or set(sd['slots']) != set(
                self.slots):
            raise ValueError(
                f"optimizer state of a {sd['kind']!r} rule with slots "
                f"{sorted(sd['slots'])} does not fit a {self.tx.kind!r} "
                f'rule with slots {sorted(self.slots)}')
        for name, saved in sd['slots'].items():
            mine = self.slots[name]
            if len(saved) != len(mine) or any(
                    s.shape != p.shape for s, p in zip(saved, self.params)):
                raise ValueError(f'optimizer slot {name!r} has other '
                                 'shapes than the model')
            for i, (m, s) in enumerate(zip(mine, saved)):
                m.copy_(self.layout.slice(i, s) if self.layout else s)
        self.count.copy_(sd['count'])
        if self.tx.every_k > 1:
            self.mini.copy_(sd['mini'])
        self.host_mini = int(sd['host_mini'])


@dataclasses.dataclass
class TrainState:
    """``step``: train-step calls made (micro-batches); ``model``: its
    parameters and BN statistics; ``optimizer``: bound to the model."""

    step: int
    model: torch.nn.Module
    optimizer: Optimizer

    def variables(self) -> dict:
        return self.model.state_dict()


def trainable_tensors(model: torch.nn.Module, freeze_buffers: bool) -> list:
    """The model's parameters, plus (``freeze_buffers=False``) its
    ``init_pose/init_shape/init_cam`` buffers, made trainable."""
    params = [p for p in model.parameters() if p.requires_grad]
    for name, buf in model.named_buffers():
        if name.rsplit('.', 1)[-1] in INIT_BUFFERS:
            buf.requires_grad_(not freeze_buffers)
            if not freeze_buffers:
                params.append(buf)
    return params


def create_train_state(model: torch.nn.Module, tx: Transform) -> TrainState:
    """Step 0, and ``tx`` bound to the model's trainable tensors."""
    return TrainState(step=0, model=model, optimizer=tx.init(
        trainable_tensors(model, tx.freeze_buffers)))
