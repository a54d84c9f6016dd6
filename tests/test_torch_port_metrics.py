"""The port's rank and threshold metrics (``auc``, ``auprc``, ``precision``,
``f1``, numpy with no scikit-learn) against the JAX package's, which call
scikit-learn, on the CPU.

Inputs come from a seed: scores rounded so that many tie, NaN labels
that are left out, binary and multiclass predictions, and the degenerate
cases (one class, every label NaN, labels that are not binary), which
must give the same value or raise the same error.  Values agree to
rtol=1e-12: the same sums, in another order.
"""

import warnings

import numpy as np
import pytest

from online_neural_cdes_tpu.training import metrics as jax_metrics
from online_neural_cdes_tpu_torch.training import metrics

NAMES = ["acc", "auc", "auprc", "precision", "f1"]


def _both(name, preds, labels):
    """(port, JAX) value, or the type of the error each raised."""
    out = []
    for fn in (metrics.METRICS[name], jax_metrics.METRICS[name]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                out.append(fn(preds, labels))
            except Exception as e:  # noqa: BLE001 -- the error's type is compared
                out.append(type(e))
    return out


def _same(name, preds, labels):
    got, want = _both(name, preds, labels)
    if isinstance(want, type):
        assert got is want, (name, got, want)
    elif np.isnan(want):
        assert np.isnan(got), (name, got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=name)


def _binary(seed, n=300, decimals=1):
    rng = np.random.default_rng(seed)
    preds = np.round(rng.normal(size=(n, 1)), decimals)
    labels = (rng.random(n) < 0.3).astype(np.float64)
    labels[rng.random(n) < 0.2] = np.nan
    return preds, labels


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("decimals", [0, 1, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_binary_metrics_match_jax_with_ties_and_nan_labels(name, seed, decimals):
    _same(name, *_binary(seed, decimals=decimals))


@pytest.mark.parametrize("name", NAMES)
def test_sequence_predictions_match_jax(name):
    """Online predictions (B, L, 1) against per-observation labels (B, L)
    with finished series marked NaN."""
    rng = np.random.default_rng(3)
    preds = np.round(rng.normal(size=(8, 12, 1)), 1)
    labels = rng.integers(0, 2, size=(8, 12)).astype(np.float32)
    labels[:, 9:] = np.nan
    _same(name, preds, labels)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("binary_labels", [False, True])
def test_multiclass_predictions_match_jax(name, binary_labels):
    """Several logits: macro precision and f1, and the largest logit as the
    score (which scikit-learn refuses for labels of more than two
    classes)."""
    rng = np.random.default_rng(4)
    preds = np.round(rng.normal(size=(200, 4)), 1)
    labels = rng.integers(0, 2 if binary_labels else 4, size=200).astype(np.float64)
    labels[::9] = np.nan
    _same(name, preds, labels)


DEGENERATE = {
    "only_zeros": np.zeros(6),
    "only_ones": np.ones(6),
    "all_nan": np.full(6, np.nan),
    "three_classes": np.array([0.0, 1.0, 2.0, 0.0, 1.0, 2.0]),
    "labels_one_two": np.array([1.0, 2.0, 1.0, 2.0, 2.0, 1.0]),
    "labels_zero_two": np.array([0.0, 2.0, 0.0, 2.0, 2.0, 0.0]),
}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_degenerate_labels_give_jax_s_value_or_error(name, case):
    preds = np.array([[0.3], [-1.0], [0.3], [2.0], [-0.5], [0.0]])
    _same(name, preds, DEGENERATE[case])


def test_single_class_auc_warns_and_is_nan():
    with pytest.warns(UserWarning, match="one class"):
        assert np.isnan(metrics.auc(np.zeros((4, 1)), np.ones(4)))
