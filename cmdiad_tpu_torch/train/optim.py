"""The JAX package's optimizer on torch tensors, with optax's state layout.

``Adam`` is what the JAX trainer builds from optax:

    tx = optax.adam(warmup_constant_lr(...))            # b1 .9, b2 .999, eps 1e-8
    tx = optax.chain(optax.add_decayed_weights(wd), tx)  # when wd > 0
    tx = optax.MultiSteps(tx, every_k_schedule=k)        # when k > 1

and it reproduces optax's arithmetic, float32 throughout: the schedule is
evaluated at the update count *before* it is incremented (so with warmup
the first update has lr 0 while the moments still move); bias correction
divides by ``1 - b**(count + 1)``; weight decay adds ``wd * param`` to the
gradient before Adam; accumulation keeps the running mean ``acc + (g -
acc) / (n + 1)`` of the micro-steps' gradients (carried across epoch ends)
and applies the inner update on the ``k``-th, when the accumulator
restarts at 0.  The counters live on the host, so a step never waits on
the device.

``optax_state``/``load_optax_state`` write and read the state as the tree
that optax keeps, which the JAX package's checkpoints flatten:
``000000/{count,mu,nu}`` and ``000001/count`` for Adam and its schedule,
one level down under ``000001`` after ``add_decayed_weights`` (whose state
has no leaves), and ``mini_step``, ``gradient_step``, ``inner_opt_state``
and ``acc_grads`` around that for ``MultiSteps``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_constant_lr(base_lr: float, warmup_epochs: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """Linear warmup over ``warmup_epochs`` epochs of ``steps_per_epoch``
    updates, then ``base_lr`` (the reference's ``utils/lr_sched``), in the
    float32 arithmetic of the JAX package's schedule."""
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = f32(step) / f32(max(steps_per_epoch, 1))
        if epoch < warmup_epochs:
            return float(f32(base_lr) * epoch / f32(max(warmup_epochs, 1e-9)))
        return float(f32(base_lr))
    return schedule


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Adam:
    """optax's Adam with a schedule, optional L2 weight decay and optional
    gradient accumulation, updating ``params`` (name -> tensor) in place."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable[[int], float],
                 weight_decay: float = 0.0, accum_iter: int = 1):
        self.params = params
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.accum_iter = accum_iter
        self.count = 0       # inner updates applied (optax's counts)
        self.mini_step = 0   # micro-steps in the accumulator
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.acc = ({k: torch.zeros_like(p) for k, p in params.items()}
                    if accum_iter > 1 else {})

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.accum_iter > 1:
            n = self.mini_step
            for k, acc in self.acc.items():
                acc.add_((grads[k] - acc) / (n + 1))
            if n < self.accum_iter - 1:
                self.mini_step += 1
                return
            grads = self.acc
        step_size = -self.schedule(self.count)
        bc1 = _bias_correction(B1, self.count + 1)
        bc2 = _bias_correction(B2, self.count + 1)
        for k, p in self.params.items():
            g = grads[k]
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            p.add_(step_size * ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS)))
        self.count += 1
        if self.accum_iter > 1:
            self.mini_step = 0
            for acc in self.acc.values():
                acc.zero_()

    # -- optax's state tree --------------------------------------------------
    def optax_state(self, tree: Callable[[Dict[str, torch.Tensor]], dict]) -> dict:
        """The state as optax's tree; ``tree`` maps a per-parameter dict to
        the flax params tree (names and layouts)."""
        count = np.int32(self.count)
        inner = {"000000": {"count": count, "mu": tree(self.mu), "nu": tree(self.nu)},
                 "000001": {"count": count}}
        if self.weight_decay:
            inner = {"000001": inner}
        if self.accum_iter > 1:
            return {"mini_step": np.int32(self.mini_step), "gradient_step": count,
                    "inner_opt_state": inner, "acc_grads": tree(self.acc)}
        return inner

    def load_optax_state(self, state: dict,
                         named: Callable[[dict], Dict[str, np.ndarray]]) -> None:
        """Restore from optax's tree (``optax_state``'s layout); ``named``
        maps a flax params tree back to per-parameter torch-layout arrays."""
        if self.accum_iter > 1:
            self.mini_step = int(state["mini_step"])
            _copy_into(self.acc, named(state["acc_grads"]))
            state = state["inner_opt_state"]
        if self.weight_decay:
            state = state["000001"]
        adam = state["000000"]
        self.count = int(adam["count"])
        _copy_into(self.mu, named(adam["mu"]))
        _copy_into(self.nu, named(adam["nu"]))


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, np.ndarray]) -> None:
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(torch.as_tensor(np.asarray(src[k]).reshape(t.shape)))
