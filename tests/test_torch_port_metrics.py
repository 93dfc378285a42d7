"""The port's evaluation metrics (``train/metrics.py``) against the JAX
package's on random inputs with tied times, tied risks and censoring: the
censored c-index (the production, loop and brute-force forms, all five
returned counts), Kaplan-Meier, the log-rank test, the IPCW Brier score and
its integral, the cumulative/dynamic AUC, the discrete survival curve at
continuous times and the classification report.

Both are the same float64 numpy algorithm: held to 1e-12 (the counts exactly).
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from multimodal_path_omic_tpu.train import metrics as jm
from multimodal_path_omic_tpu_torch.train import metrics as tm

TOL = 1e-12


def _same(got, ref):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _same(a, b)
    elif isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _same(got[k], ref[k])
    else:
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(ref, float),
                                   rtol=TOL, atol=TOL, equal_nan=True)


def _cohort(seed, n, n_times, n_risks):
    """Times and risks from few distinct values (ties), ~40% censored."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, n_times + 1, n).astype(float) * 3.5
    e = rng.random(n) > 0.4
    r = np.round(rng.normal(size=n), 1) if n_risks else rng.normal(size=n)
    return t, e, r


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31), n=st.integers(2, 120), n_times=st.integers(1, 15),
       ties=st.booleans())
def test_concordance_index_equals_jax(seed, n, n_times, ties):
    t, e, r = _cohort(seed, n, n_times, ties)
    for fn in ("concordance_index_censored", "_concordance_index_censored_loop",
               "concordance_index_censored_bruteforce"):
        try:
            ref = getattr(jm, fn)(e, t, r)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)):
                getattr(tm, fn)(e, t, r)
            continue
        got = getattr(tm, fn)(e, t, r)
        assert got[1:] == ref[1:]  # concordant, discordant, tied risk, tied time
        _same(got[0], ref[0])


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31), n=st.integers(6, 80))
def test_survival_curves_and_logrank_equal_jax(seed, n):
    t, e, r = _cohort(seed, n, 12, True)
    _same(tm.kaplan_meier(t, e), jm.kaplan_meier(t, e))
    _same(tm.censoring_survival(t, e), jm.censoring_survival(t, e))
    group = np.arange(n) % 2 == 0
    _same(tm.logrank_test(t, e, group), jm.logrank_test(t, e, group))
    survs = np.cumprod(np.random.default_rng(seed).uniform(0.6, 1.0, (n, 4)), axis=1)
    _same(tm.survival_risk(survs), jm.survival_risk(survs))
    edges = np.array([0.0, 10.0, 20.0, 30.0, 50.0])
    taus = np.array([3.5, 10.0, 17.5, 28.0, 60.0])
    _same(tm.survival_at_times(survs, edges, taus), jm.survival_at_times(survs, edges, taus))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31), n=st.integers(8, 80))
def test_time_dependent_metrics_equal_jax(seed, n):
    t, e, r = _cohort(seed, n, 10, False)
    lo, hi = t.min(), t.max()
    if hi - lo < 7.0:
        return
    taus = np.array([lo + 1.0, (lo + hi) / 2, hi - 1.0])
    surv = np.clip(np.random.default_rng(seed + 1).uniform(0, 1, (n, 3)), 0, 1)
    for fn, args in (("brier_scores", (t, e, surv, taus)),
                     ("integrated_brier_score", (t, e, surv, taus)),
                     ("cumulative_dynamic_auc", (t, e, r, taus))):
        try:
            ref = getattr(jm, fn)(*args)
        except ValueError:
            with pytest.raises(ValueError):
                getattr(tm, fn)(*args)
            continue
        _same(getattr(tm, fn)(*args), ref)


def test_classification_report_and_errors_equal_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, 40)
    probs = rng.dirichlet(np.ones(3), 40)
    probs[:5] = probs[:5][:, [0, 0, 0]]  # argmax ties
    _same(tm.classification_report(labels, probs), jm.classification_report(labels, probs))
    for fn, args in (("concordance_index_censored", ([True], [1.0], [0.1])),
                     ("concordance_index_censored", ([False, False], [1.0, 2.0], [0.1, 0.2])),
                     ("logrank_test", ([1.0, 2.0], [1, 1], [True, True])),
                     ("integrated_brier_score", ([1.0, 2.0], [1, 0], [[0.5], [0.5]], [1.5]))):
        with pytest.raises(ValueError):
            getattr(jm, fn)(*args)
        with pytest.raises(ValueError):
            getattr(tm, fn)(*args)
