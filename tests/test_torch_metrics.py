"""The port's classification metrics against the JAX package's
(``msha_gnn_tpu.training.metrics``), on the same numpy inputs from a seed.

The cases: random scores rounded so that many tie, with one class absent
from the labels; every label one class (that class has no negatives, the
others no positives: no class enters the macro AUC); and predictions that
are all wrong (micro precision and recall 0, so ``f1`` is nan in both).
Tolerances: the AUCs within 1e-6 (rank sums, float32 on the JAX side);
accuracy and the micro values, ratios of counts, with the counts exact
and the ratios within one float32 rounding (rtol 2e-7: the JAX mean
multiplies by 1/B); the macro means of per-class ratios at rtol 1e-6 (the
mean's summation order); nan where the JAX package gives nan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msha_gnn_tpu.training import metrics as jm
from msha_gnn_torch.training import metrics as tm

M = 6


def case(name, seed=0, b=200):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(size=(b, M)), 1).astype(np.float32)
    if name == "ties_absent":
        labels = rng.choice([0, 1, 2, 3, 5], b)        # class 4 absent
    elif name == "one_class":
        labels = np.full(b, 2)
    elif name == "all_wrong":
        labels = (scores.argmax(1) + 1) % M
    else:
        raise ValueError(name)
    return scores, labels.astype(np.int32)


CASES = ("ties_absent", "one_class", "all_wrong")


def both(fn_t, fn_j, *arrays):
    got = fn_t(*(torch.from_numpy(a) for a in arrays))
    want = fn_j(*(jnp.asarray(a) for a in arrays))
    return got, want


def _f(x):
    return float(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x))


def same_count(got, want, n):
    """Ratios of one count to ``n``: the counts equal, the ratios within
    one float32 rounding."""
    assert round(_f(got) * n) == round(_f(want) * n)
    np.testing.assert_allclose(_f(got), _f(want), rtol=2e-7)


@pytest.mark.parametrize("name", CASES)
def test_binary_auc_matches_jax(name):
    scores, labels = case(name)
    for c in range(M):
        got, want = both(tm._binary_auc, jm._binary_auc, scores[:, c],
                         labels == c)
        np.testing.assert_allclose(_f(got), _f(want), atol=1e-6,
                                   equal_nan=True, err_msg=f"class {c}")
    # tied scores share their mean rank: all-equal scores give 0.5
    got = tm._binary_auc(torch.zeros(10), torch.arange(10) % 2 == 0)
    assert _f(got) == 0.5


@pytest.mark.parametrize("name", CASES)
def test_multiclass_auc_matches_jax(name):
    got, want = both(tm.multiclass_auc, jm.multiclass_auc, *case(name))
    np.testing.assert_allclose(_f(got), _f(want), atol=1e-6)
    if name == "one_class":
        assert _f(got) == 0.0  # no class has positives and negatives


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("average", ["macro", "micro"])
def test_precision_recall_and_f1_match_jax(name, average):
    scores, labels = case(name)
    pred = scores.argmax(1).astype(np.int32)
    got = tm.precision_recall(torch.from_numpy(pred),
                              torch.from_numpy(labels), M, average)
    want = jm.precision_recall(jnp.asarray(pred), jnp.asarray(labels), M,
                               average)
    for g, w in zip(got, want):
        if average == "micro":
            same_count(g, w, len(labels))
        else:
            np.testing.assert_allclose(_f(g), _f(w), rtol=1e-6)
    np.testing.assert_allclose(_f(tm.f1(*got)), _f(jm.f1(*want)), rtol=1e-6,
                               equal_nan=True)
    same_count(tm.accuracy(torch.from_numpy(pred), torch.from_numpy(labels)),
               jm.accuracy(jnp.asarray(pred), jnp.asarray(labels)),
               len(labels))


@pytest.mark.parametrize("name", CASES)
def test_classification_report_matches_jax(name):
    got, want = both(tm.classification_report, jm.classification_report,
                     *case(name))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dim() == 0
        np.testing.assert_allclose(_f(got[k]), _f(want[k]), rtol=1e-6,
                                   atol=1e-6, equal_nan=True, err_msg=k)
    if name == "all_wrong":
        assert _f(got["accuracy"]) == 0.0 and np.isnan(_f(got["f1_micro"]))


def test_precision_recall_rejects_an_unknown_average():
    with pytest.raises(ValueError, match="average"):
        tm.precision_recall(torch.zeros(3, dtype=torch.long),
                            torch.zeros(3, dtype=torch.long), 2, "weighted")
