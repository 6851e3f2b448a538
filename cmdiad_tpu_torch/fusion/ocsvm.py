"""Linear one-class SVM late fusion.

The reference fits two ``sklearn.linear_model.SGDOneClassSVM`` fusers
(nu=0.5, max_iter=1000, random_state=42) on the λ-weighted score vectors of
a second training pass and uses ``score_samples`` as the final anomaly
score.  ``score_samples`` is higher for more NORMAL samples in sklearn and
the pipeline feeds it to AUROC as it is; that sign is inherited.

Two backends, the JAX package's ``ocsvm_backend`` values:

``'sklearn'`` (default): sklearn is not available everywhere the port
runs, so this is a numpy fit on the host of sklearn 1.9's own fit
(``_plain_sgd`` with ``one_class=1``): hinge loss at threshold 1 on p =
w·x + b, L2 penalty alpha = nu applied as weight decay, the intercept
moving by eta·(active − alpha), the 'optimal' schedule eta = 1/(alpha·(t0 +
t − 1)) with sklearn's t0, sklearn's shuffles and its stopping rule (stop
after ``n_iter_no_change`` epochs whose mean objective failed to improve on
the best by ``tol``).  The shuffles are sklearn's: the seed
``RandomState(random_state).randint(0, 2**31 - 1)``
(``sklearn/linear_model/_stochastic_gradient.py:2342-2345``) and, before
every epoch, ``dataset.shuffle(seed)`` (``sklearn/linear_model/
_sgd_fast.pyx.tp:473-474``), a Fisher–Yates with the xorshift
``our_rand_r`` (``sklearn/utils/_seq_dataset.pyx.tp:137-145``,
``sklearn/utils/_random.pxd:20-34``).  The seed goes to every shuffle by
value, so each epoch applies the same swaps to the previous epoch's order.
The fit visits the rows in sklearn's order and so equals sklearn's
``coef_``, ``offset_`` and ``n_iter_`` up to float64 rounding (the
closed-form chunks below sum in another order than sklearn's loop).

``'jax'``: the JAX package's own SGD (``cmdiad_tpu.fusion.ocsvm._fit_jax``)
as JAX computes it: alpha = nu/2, its t0 heuristic, every one of
``max_iter`` epochs (no stopping rule), each epoch's rows in the order
``jax.random.permutation(keys[e], n)`` of ``keys = split(PRNGKey(seed),
max_iter)`` (``prng``), ``rho`` as the offset, and every step's operations
rounded to float32 in JAX's order, the float32 counter t stopping at 2^24.
On a CUDA device a hand-written kernel (``csrc/ocsvm_sgd.cu``) runs the
steps, a block of epochs a launch; on the CPU its plain version, the same
steps one by one in numpy float32 scalars (some microseconds a step: keep
``n * max_iter`` small there).

Speed of the 'sklearn' fit: the per-sample updates are sequential, but
within a run of steps that all take the same active/inactive branch the
state is a linear recurrence with a closed form.  ``_sgd_chunk`` guesses
the branches of a chunk, evaluates the whole chunk in closed form with
cumulative sums, and iterates until the guesses reproduce themselves; every
iteration fixes at least the first wrong guess, so the result is the
sequential one up to float64 rounding.  Hundreds of thousands of rows fit
in seconds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cmdiad_tpu_torch import kernels, prng, tracing

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

    @property
    def coef_(self):
        return self._coef

    @coef_.setter
    def coef_(self, value):
        self._coef = value
        self._coef_on_device = None

    def device_coef(self) -> torch.Tensor:
        """``coef_`` as a float32 vector on ``device``: uploaded on the first
        request after ``coef_`` changes (``fit``, ``load_weights``), then
        kept, so a predict call reads it without a crossing."""
        if self._coef_on_device is None:
            self._coef_on_device = tracing.to_device(
                np.asarray(self._coef).reshape(-1), self.device, torch.float32)
        return self._coef_on_device

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


def sklearn_seed(random_state: int) -> int:
    """The shuffle seed sklearn's ``SGDOneClassSVM._fit_one_class`` draws:
    ``RandomState(random_state).randint(0, 2**31 - 1)``
    (``sklearn/linear_model/_stochastic_gradient.py:2342-2345``)."""
    return int(np.random.RandomState(random_state).randint(0, np.iinfo(np.int32).max))


@functools.lru_cache(maxsize=4)
def sklearn_shuffle(n: int, seed: int) -> np.ndarray:
    """The index order one ``dataset.shuffle(seed)`` of sklearn makes of
    ``arange(n)``: a Fisher–Yates, ``j = i + our_rand_r(&seed) % (n - i)``
    for ``i < n - 1`` (``sklearn/utils/_seq_dataset.pyx.tp:137-145``), with
    the xorshift ``our_rand_r`` (``sklearn/utils/_random.pxd:20-34``: a seed
    of 0 becomes 1, shifts 13, 17 and 5, the result ``% 2^31``).  The swaps
    are sequential, about a second of host time at 802816 rows, so the
    orders of the last few row counts are kept (read-only): the fusers of
    one configuration see the same row counts class after class."""
    mask = 0xFFFFFFFF
    s = seed & mask
    idx = list(range(n))
    for i in range(n - 1):
        if s == 0:
            s = 1
        s ^= (s << 13) & mask
        s ^= s >> 17
        s ^= (s << 5) & mask
        j = i + (s & 0x7FFFFFFF) % (n - i)
        idx[i], idx[j] = idx[j], idx[i]
    order = np.asarray(idx, np.int64)
    order.flags.writeable = False
    return order


def _fit(x, nu, max_iter, seed, tol, n_iter_no_change, chunk=4096):
    """-> (w (d,), intercept b, epochs run).  ``seed`` is the estimator's
    ``random_state``; the epochs visit the rows in sklearn's orders."""
    n, d = x.shape
    alpha = float(nu)
    t0 = _schedule_t0(alpha)
    # sklearn passes the seed to every epoch's shuffle by value: each epoch
    # applies the same swaps to the previous epoch's order
    swaps = sklearn_shuffle(n, sklearn_seed(seed))
    order = np.arange(n)
    w, b, t = np.zeros(d), 1.0, 1.0
    best, no_improve = np.inf, 0
    epoch = 0
    for epoch in range(1, max_iter + 1):
        order = order[swaps]
        xs = x[order]
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


MAX_D = 4               # the 'jax' fitter's widest rows (the fusers give 1 or 2)
STATE = MAX_D + 2       # its state: w (zero-padded to MAX_D), rho, t
LAUNCH_ROWS = 1 << 24   # rows gathered for one launch: whole epochs of them
_STALL = 1 << 24        # float32 t + 1 == t from here


def _jax_constants(x: np.ndarray, nu: float):
    """(alpha, t0, nu) as the JAX fitter rounds them into its float32 steps."""
    alpha = nu / 2.0
    t0 = 1.0 / (alpha * max(1.0, float(np.abs(x).mean())))
    return np.float32(alpha), np.float32(t0), np.float32(nu)


def sgd_steps(rows: torch.Tensor, state: torch.Tensor, alpha, t0, nu) -> None:
    """Run the JAX fitter's float32 SGD steps over ``rows`` (steps, d)
    float32, in order, from ``state`` (STATE,) float32 = w zero-padded to
    MAX_D, rho, t (an integer-valued float32, at most 2^24), updated in
    place.  A step: eta = 1/(alpha (t0 + t)); active = rho − w·x > 0; w −=
    eta (alpha w − active x); rho −= eta (active − nu); t += 1.  A CUDA
    tensor launches the kernel, a CPU tensor runs the plain version."""
    d = rows.shape[1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the 'jax' fitter takes 1 to {MAX_D} columns, got {d}")
    if rows.is_cuda:
        _sgd_steps_cuda(rows, state, alpha, t0, nu)
    else:
        _sgd_steps_plain(rows, state, alpha, t0, nu)


def _sgd_steps_cuda(rows, state, alpha, t0, nu) -> None:
    kernels.check_cuda_tensor(rows, "rows", torch.float32, (None, None))
    kernels.check_cuda_tensor(state, "state", torch.float32, (STATE,))
    if rows.shape[0] == 0:
        return
    kernels.launch("ocsvm_sgd", rows.data_ptr(), rows.shape[0], rows.shape[1],
                   float(alpha), float(t0), float(nu), state.data_ptr())


def _sgd_steps_plain(rows, state, alpha, t0, nu) -> None:
    """The kernel's plain version: the same float32 operations in the same
    order, step by step."""
    alpha, t0, nu = np.float32(alpha), np.float32(t0), np.float32(nu)
    one, zero = np.float32(1.0), np.float32(0.0)
    x = rows.numpy()
    d = x.shape[1]
    st = state.numpy()
    w = [st[j] for j in range(d)]
    rho, t_start = st[MAX_D], int(st[MAX_D + 1])
    # t only counts: step k has t = min(t_start + k, 2^24), exactly as the
    # float32 sequence t + 1 has it; numpy rounds each element's operations
    # as the scalar ones round them
    t = np.minimum(t_start + np.arange(len(x)), _STALL).astype(np.float32)
    eta = one / (alpha * (t0 + t))
    for e, xi in zip(eta, x):
        dot = w[0] * xi[0]
        for j in range(1, d):
            dot = dot + w[j] * xi[j]
        active = one if rho - dot > zero else zero
        for j in range(d):
            w[j] = w[j] - e * (alpha * w[j] - active * xi[j])
        rho = rho - e * (active - nu)
    st[:d] = w
    st[MAX_D] = rho
    st[MAX_D + 1] = np.float32(min(t_start + len(x), _STALL))


def _fit_jax(x: np.ndarray, nu: float, max_iter: int, seed: int, device):
    """The JAX package's ``_fit_jax`` on ``device`` -> (w (d,), rho), float32
    values as float64.  Each epoch's order is drawn on ``device``; the rows
    of ``LAUNCH_ROWS // n`` epochs (at least one) are gathered into that
    order and run by one ``sgd_steps``."""
    n, d = x.shape
    alpha, t0, nu32 = _jax_constants(x, nu)
    rows = torch.as_tensor(x, dtype=torch.float32).to(device)
    keys = prng.split(prng.prng_key(seed, device), max_iter)
    state = torch.zeros(STATE, dtype=torch.float32, device=device)
    state[MAX_D + 1] = 1.0
    per_launch = max(1, LAUNCH_ROWS // max(n, 1))
    for e0 in range(0, max_iter, per_launch):
        order = prng.permutations(keys[e0:e0 + per_launch], n).reshape(-1)
        sgd_steps(rows[order], state, alpha, t0, nu32)
    state = state.cpu().double().numpy()
    return state[:d].copy(), float(state[MAX_D])
