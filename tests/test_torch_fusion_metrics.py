"""The port's host-side OCSVM fit and metric copies.

The numpy OCSVM is sklearn's SGDOneClassSVM fit, its shuffles included:
held to sklearn's ``coef_`` and ``offset_`` within rtol 1e-9 with the same
``n_iter_`` (measured 1e-16 to 1e-11; the closed-form chunks sum in another
order than sklearn's loop), and to a step-by-step loop of the same shuffles
(up to float64 rounding).
"""

import numpy as np
import pytest
from sklearn.linear_model import SGDOneClassSVM as SklearnOCSVM

from cmdiad_tpu.metrics import calculate_au_pro as jax_au_pro
from cmdiad_tpu.metrics import roc_auc_score as jax_auroc
from cmdiad_tpu_torch.fusion.ocsvm import (SGDOneClassSVM, _fit, _schedule_t0, sklearn_seed,
                                           sklearn_shuffle)
from cmdiad_tpu_torch.metrics import calculate_au_pro, roc_auc_score


def _scores(rng, n, scale=(1.0, 0.3)):
    return np.abs(rng.normal(size=(n, 2))) * np.asarray(scale)


def _fit_sequential(x, nu, max_iter, seed, tol, n_iter_no_change):
    """Step-by-step reference of ``_fit``: sklearn's loop, the same shuffles."""
    n, d = x.shape
    alpha = float(nu)
    t0 = _schedule_t0(alpha)
    swaps, order = sklearn_shuffle(n, sklearn_seed(seed)), np.arange(n)
    w, b, t = np.zeros(d), 1.0, 1.0
    best, no_improve = np.inf, 0
    epoch = 0
    for epoch in range(1, max_iter + 1):
        total = 0.0
        order = order[swaps]
        for xi in x[order]:
            p = float(w @ xi) + b
            eta = 1.0 / (alpha * (t0 + t - 1.0))
            total += (1.0 - p if p <= 1.0 else 0.0) + alpha * 0.5 * float(w @ w) + alpha * b
            update = eta if p <= 1.0 else 0.0
            w = w * max(0.0, 1.0 - eta * alpha) + update * xi
            b += update - eta * alpha
            t += 1.0
        mean_obj = total / n
        no_improve = no_improve + 1 if mean_obj > best - tol else 0
        best = min(best, mean_obj)
        if no_improve >= n_iter_no_change:
            break
    return w, b, epoch


@pytest.mark.parametrize("n", [40, 3000])
def test_chunked_fit_equals_the_sequential_loop(rng, n):
    x = _scores(rng, n)
    w, b, ep = _fit(x, 0.5, 1000, 42, 1e-3, 5)
    w2, b2, ep2 = _fit_sequential(x, 0.5, 1000, 42, 1e-3, 5)
    assert ep == ep2
    np.testing.assert_allclose(w, w2, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(b, b2, rtol=1e-9)


@pytest.mark.parametrize("n,scale", [(16, (1.0, 0.1)), (5000, (1.0, 0.3)),
                                     (20000, (0.02, 0.05)), (60000, (0.3, 1.0))])
def test_fit_matches_sklearn_direction(rng, n, scale):
    """Same objective, schedule and shuffles as sklearn: the same vector
    (and so the same direction), offset and epochs."""
    x = _scores(rng, n, scale)
    ours = SGDOneClassSVM(nu=0.5, max_iter=1000, random_state=42).fit(x)
    ref = SklearnOCSVM(nu=0.5, max_iter=1000, random_state=42).fit(x)
    np.testing.assert_allclose(ours.coef_.ravel(), np.ravel(ref.coef_), rtol=1e-9, atol=0)
    np.testing.assert_allclose(ours.offset_, ref.offset_, rtol=1e-9, atol=0)
    assert ours.n_iter_ == ref.n_iter_ >= 6     # n_iter_no_change=5 needs 6 epochs


def test_sklearn_shuffle_is_sklearns(rng):
    """The order of one ``dataset.shuffle(seed)`` of sklearn's own
    sequential dataset, the seed of 0 (xorshift's fixed point) included."""
    from sklearn.utils._seq_dataset import ArrayDataset64
    for n, seed in ((1, 5), (2, 0), (7, 1), (1000, 12345), (5001, 2 ** 31 - 2)):
        data = ArrayDataset64(np.zeros((n, 1)), np.zeros(n), np.ones(n), seed=1)
        data._shuffle_py(seed)
        order = [data._next_py()[-1] for _ in range(n)]    # the sample indices in turn
        assert np.array_equal(order, sklearn_shuffle(n, seed)), (n, seed)
    assert sklearn_seed(42) == np.random.RandomState(42).randint(0, 2 ** 31 - 1)


def test_score_samples_keeps_the_sklearn_sign(rng):
    """Q9: score_samples is higher for more NORMAL rows (sklearn's
    convention), and the pipeline uses it as the anomaly score as it is."""
    x = _scores(rng, 2000)
    ours = SGDOneClassSVM().fit(x)
    ref = SklearnOCSVM(nu=0.5, max_iter=1000, random_state=42).fit(x)
    probe = np.array([[0.1, 0.05], [3.0, 1.0]])
    np.testing.assert_allclose(ours.score_samples(probe), probe @ ours.coef_.ravel())
    assert np.all(np.sign(ours.score_samples(probe)) == np.sign(ref.score_samples(probe)))
    assert np.all(ours.coef_ > 0)
    restored = SGDOneClassSVM().load_weights(ours.coef_.ravel(), ours.offset_)
    np.testing.assert_array_equal(restored.score_samples(probe), ours.score_samples(probe))
    np.testing.assert_array_equal(restored.decision_function(probe),
                                  ours.decision_function(probe))


def test_fit_is_fast_at_seg_fuser_scale(rng):
    import time
    x = _scores(rng, 400_000)
    t0 = time.perf_counter()
    SGDOneClassSVM().fit(x)
    assert time.perf_counter() - t0 < 20.0


def test_metric_copies_match(rng):
    labels = rng.random(500) < 0.3
    scores = rng.normal(size=500) + labels
    scores[:50] = np.round(scores[:50])            # ties
    assert roc_auc_score(labels, scores) == jax_auroc(labels, scores)
    gts, preds = [], []
    for _ in range(4):
        g = np.zeros((32, 32))
        g[rng.integers(0, 20):, rng.integers(0, 20):][:8, :8] = 1
        gts.append(g)
        preds.append(rng.random((32, 32)) + g)
    for lim in (0.3, 0.01):
        assert calculate_au_pro(gts, preds, lim)[0] == jax_au_pro(gts, preds, lim)[0]
