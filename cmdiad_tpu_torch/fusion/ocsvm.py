"""Linear one-class SVM late fusion.

The reference fits two ``sklearn.linear_model.SGDOneClassSVM`` fusers
(nu=0.5, max_iter=1000, random_state=42) on the λ-weighted score vectors of
a second training pass and uses ``score_samples`` as the final anomaly
score.  ``score_samples`` is higher for more NORMAL samples in sklearn and
the pipeline feeds it to AUROC as it is; that sign is inherited.

Two backends, the JAX package's ``ocsvm_backend`` values:

``'sklearn'`` (default): sklearn is not available everywhere the port
runs, so this is a numpy fit on the host of the same problem with
sklearn's algorithm (``_plain_sgd`` with ``one_class=1``): hinge loss at
threshold 1 on p = w·x + b, L2 penalty alpha = nu applied as weight decay,
the intercept moving by eta·(active − alpha), the 'optimal' schedule eta =
1/(alpha·(t0 + t − 1)) with sklearn's t0, a fresh shuffle per epoch, and
sklearn's stopping rule (stop after ``n_iter_no_change`` epochs whose mean
objective failed to improve on the best by ``tol``).  The shuffles come
from ``numpy.random.default_rng(random_state)``, not sklearn's generator,
so the fitted vector equals sklearn's in direction to within SGD noise,
not bit for bit.

``'jax'``: the JAX package's own SGD (``cmdiad_tpu.fusion.ocsvm._fit_jax``),
fitted on ``device``: alpha = nu/2, its t0 heuristic, float32 rows and step
sizes, every one of ``max_iter`` epochs (no stopping rule), each epoch's
rows in the order ``jax.random.permutation(keys[e], n)`` of ``keys =
split(PRNGKey(seed), max_iter)`` (``fusion.threefry``), and ``rho`` as the
offset.  JAX rounds every step's state to float32; the port evaluates the
same recurrence in float64 over the float32 rows and step sizes, so the
two agree to float32 rounding accumulated over the run, not bit for bit.

Speed: the per-sample updates are sequential, but within a run of steps
that all take the same active/inactive branch the state is a linear
recurrence with a closed form.  ``_sgd_chunk`` (and ``_jax_chunk`` for the
``'jax'`` recurrence, as torch ops on the device) guesses the branches of
a chunk, evaluates the whole chunk in closed form with cumulative sums, and
iterates until the guesses reproduce themselves; every iteration fixes at
least the first wrong guess, so the result is the sequential one up to
float64 rounding.  Hundreds of thousands of rows fit in seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from cmdiad_tpu_torch.fusion import threefry

BACKENDS = ("sklearn", "jax")


class SGDOneClassSVM:
    """Linear one-class SVM trained by SGD (``backend`` 'sklearn' or 'jax';
    ``device`` is where the 'jax' fit runs)."""

    def __init__(self, nu: float = 0.5, max_iter: int = 1000,
                 random_state: int = 42, tol: float = 1e-3,
                 n_iter_no_change: int = 5, backend: str = "sklearn",
                 device="cuda"):
        if not 0.0 < nu < 1.0:
            raise ValueError(f"nu must lie in (0, 1), got {nu}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown ocsvm backend {backend!r}; expected one of {BACKENDS}")
        self.backend = backend
        self.device = torch.device(device)
        self.nu = nu
        self.max_iter = max_iter
        self.random_state = random_state
        self.tol = tol
        self.n_iter_no_change = n_iter_no_change
        self.coef_ = None
        self.offset_ = None
        self.n_iter_ = 0

    def fit(self, x: np.ndarray) -> "SGDOneClassSVM":
        x = np.ascontiguousarray(x, np.float64)
        if self.backend == "jax":
            w, rho = _fit_jax(x, self.nu, self.max_iter, self.random_state, self.device)
            self.coef_, self.offset_, self.n_iter_ = w.reshape(1, -1), np.asarray([rho]), self.max_iter
            return self
        w, b, self.n_iter_ = _fit(x, self.nu, self.max_iter, self.random_state,
                                  self.tol, self.n_iter_no_change)
        self.coef_ = w.reshape(1, -1)
        self.offset_ = np.asarray([1.0 - b])
        return self

    def score_samples(self, x: np.ndarray) -> np.ndarray:
        """x·coef (sklearn's score_samples for this model)."""
        return np.asarray(x, np.float64) @ np.asarray(self.coef_, np.float64).reshape(-1)

    def decision_function(self, x: np.ndarray) -> np.ndarray:
        return self.score_samples(x) - self.offset_

    def load_weights(self, coef, offset) -> "SGDOneClassSVM":
        """Restore a fitted fuser from persisted weights."""
        self.coef_ = np.asarray(coef, np.float64).reshape(1, -1)
        self.offset_ = np.asarray(offset, np.float64).reshape(-1)
        return self


def _schedule_t0(alpha: float) -> float:
    """sklearn's 'optimal' schedule offset: eta at the first sample equals
    typw / max(1, -dloss(-typw)) with typw = sqrt(1/sqrt(alpha))."""
    typw = np.sqrt(1.0 / np.sqrt(alpha))
    return 1.0 / (typw * alpha)


def _sgd_chunk(xc, w, b, t_first, alpha, t0, max_rounds=4):
    """Run the SGD steps of the rows ``xc`` (K, d) from state (w, b) whose
    first step has counter ``t_first``.  Returns (steps taken L >= 1, w, b,
    sum of the per-step objective over those L steps)."""
    k = xc.shape[0]
    big_t = t0 + t_first - 1.0 + np.arange(k)           # eta_j = 1/(alpha T_j)
    eta = 1.0 / (alpha * big_t)
    decay = np.maximum(0.0, 1.0 - eta * alpha)
    a_cum = np.concatenate([[1.0], np.cumprod(decay)])   # A_j = prod_{i<j} decay_i
    base = xc @ w                                         # w_0 · x_j
    active = base + b <= 1.0                              # first guess: w fixed
    for _ in range(max_rounds):
        u = eta * active
        contrib = (u / a_cum[1:])[:, None] * xc           # u_j x_j / A_{j+1}
        v = np.concatenate([np.zeros((1, xc.shape[1])), np.cumsum(contrib, 0)])
        w_steps = a_cum[:k, None] * (w[None, :] + v[:k])  # w_j before step j
        b_steps = b + np.concatenate([[0.0], np.cumsum(u - eta * alpha)])
        p = np.einsum("jd,jd->j", w_steps, xc) + b_steps[:k]
        new_active = p <= 1.0
        wrong = np.flatnonzero(new_active != active)
        active = new_active
        if wrong.size == 0:
            n = k
            break
    else:
        n = int(wrong[0]) + 1       # steps whose branch is now verified
    u = eta[:n] * active[:n]
    w_new = a_cum[n] * (w + np.sum((u / a_cum[1:n + 1])[:, None] * xc[:n], 0))
    b_new = b + float(np.sum(u - eta[:n] * alpha))
    obj = (np.where(p[:n] <= 1.0, 1.0 - p[:n], 0.0)
           + alpha * 0.5 * np.einsum("jd,jd->j", w_steps[:n], w_steps[:n])
           + alpha * b_steps[:n])
    return n, w_new, b_new, float(np.sum(obj))


def _fit(x, nu, max_iter, seed, tol, n_iter_no_change, chunk=4096):
    """-> (w (d,), intercept b, epochs run)."""
    n, d = x.shape
    alpha = float(nu)
    t0 = _schedule_t0(alpha)
    rng = np.random.default_rng(seed)
    w, b, t = np.zeros(d), 1.0, 1.0
    best, no_improve = np.inf, 0
    epoch = 0
    for epoch in range(1, max_iter + 1):
        xs = x[rng.permutation(n)]
        total, i, size = 0.0, 0, 64
        while i < n:
            rows = xs[i:i + size]
            steps, w, b, obj = _sgd_chunk(rows, w, b, t, alpha, t0)
            total += obj
            i += steps
            t += steps
            # grow the chunk while guesses hold, shrink it when they do not
            size = min(chunk, size * 2) if steps == len(rows) else max(16, size // 2)
        mean_obj = total / n
        no_improve = no_improve + 1 if mean_obj > best - tol else 0
        best = min(best, mean_obj)
        if no_improve >= n_iter_no_change:
            break
    return w, b, epoch



def _jax_chunk(xc, eta, w, rho, alpha, nu, max_rounds=4):
    """Run the JAX fitter's SGD steps over the rows ``xc`` (K, d) with step
    sizes ``eta`` (K,) from state (w (d,), rho ()), all float64 tensors:
    step j is active when rho_j − w_j·x_j > 0 and then
    w_{j+1} = (1 − eta_j alpha) w_j + eta_j active_j x_j,
    rho_{j+1} = rho_j − eta_j (active_j − nu).
    Returns (steps taken L >= 1, w, rho)."""
    k = xc.shape[0]
    a_cum = torch.cat([eta.new_ones(1), torch.cumprod(1.0 - eta * alpha, 0)])
    active = rho - xc @ w > 0                             # first guess: w fixed
    n = k
    for _ in range(max_rounds):
        u = eta * active
        v = torch.cumsum((u / a_cum[1:])[:, None] * xc, 0)
        w_steps = a_cum[:k, None] * (w[None, :] + torch.cat([v.new_zeros(1, v.shape[1]), v[:-1]]))
        rho_steps = rho + torch.cat([eta.new_zeros(1), torch.cumsum(eta * nu - u, 0)[:-1]])
        new_active = rho_steps - torch.sum(w_steps * xc, 1) > 0
        wrong = torch.nonzero(new_active != active)
        active = new_active
        if wrong.numel() == 0:
            n = k
            break
        n = int(wrong[0, 0]) + 1   # steps whose branch is now verified
    u = eta[:n] * active[:n]
    w_new = a_cum[n] * (w + torch.sum((u / a_cum[1:n + 1])[:, None] * xc[:n], 0))
    rho_new = rho + torch.sum(eta[:n] * nu - u)
    return n, w_new, rho_new


def _fit_jax(x: np.ndarray, nu: float, max_iter: int, seed: int, device,
             max_chunk: int = 1 << 18):
    """The JAX package's ``_fit_jax`` on ``device`` -> (w (d,), rho), float32
    values as float64.  Its float32 step counter t stops at 2^24 (t + 1
    rounds back to t there), and with it the step size."""
    n, d = x.shape
    alpha = nu / 2.0
    t0 = 1.0 / (alpha * max(1.0, float(np.abs(x).mean())))
    f32 = dict(dtype=torch.float32, device=device)
    rows = torch.as_tensor(x, dtype=torch.float32).to(device)
    alpha32, t0_32 = torch.tensor(alpha, **f32), torch.tensor(t0, **f32)
    alpha64 = float(alpha32)
    nu64 = float(np.float32(nu))
    keys = threefry.split(threefry.prng_key(seed, device), max_iter)
    w = torch.zeros(d, dtype=torch.float64, device=device)
    rho = torch.zeros((), dtype=torch.float64, device=device)
    order = torch.empty(0, dtype=torch.int64, device=device)
    epochs_per_draw = max(1, max_chunk // max(n, 1) + 1)
    next_epoch, step, total, size = 0, 0, n * max_iter, 64
    while step < total:
        while order.numel() < size and next_epoch < max_iter:
            e1 = min(max_iter, next_epoch + epochs_per_draw)
            order = torch.cat([order, threefry.permutations(keys[next_epoch:e1], n).reshape(-1)])
            next_epoch = e1
        idx = order[:size]
        t = torch.clamp(torch.arange(step + 1, step + 1 + idx.numel(), device=device),
                        max=2 ** 24).to(torch.float32)
        m = alpha32 * (t0_32 + t)
        eta = (torch.ones_like(m) / m).to(torch.float64)
        taken, w, rho = _jax_chunk(rows[idx].to(torch.float64), eta, w, rho, alpha64, nu64)
        order = order[taken:]
        step += taken
        # grow the chunk while guesses hold, shrink it when they do not
        size = min(max_chunk, size * 2) if taken == idx.numel() else max(16, size // 2)
    return w.to(torch.float32).double().cpu().numpy(), float(rho.to(torch.float32))
