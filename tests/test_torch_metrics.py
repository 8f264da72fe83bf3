"""Binary metrics of the PyTorch port against the JAX package: the
on-device tie-grouped curve metrics and the host evaluator, on scores with
heavy ties (the shape GBT probabilities take)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import device_metrics as jdm
from transmogrifai_tpu.evaluators.binary import binary_metrics as jax_host
from transmogrifai_tpu_torch.evaluators import device_metrics as tdm
from transmogrifai_tpu_torch.evaluators.binary import binary_metrics


def _tied(n, seed):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=n) < 0.4).astype(np.float64)
    margin = np.round(rng.normal(size=n) + y, 1)     # ~60 distinct values
    return y, margin


@pytest.mark.parametrize("metric", ["AuPR", "AuROC", "Precision", "Recall",
                                    "F1", "Error"])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_metric_matches_jax(metric, seed):
    y, margin = _tied(701, seed)
    ref = jdm.binary_metric(jnp.asarray(y),
                            *jdm.binary_from_sigmoid(jnp.asarray(margin)),
                            metric)
    got = tdm.binary_metric(torch.as_tensor(y),
                            *tdm.binary_from_sigmoid(torch.as_tensor(margin)),
                            metric)
    assert abs(float(got) - float(ref)) <= 1e-12


def test_single_class_curve_metrics_are_zero():
    y = np.ones(20)
    s = torch.linspace(0, 1, 20, dtype=torch.float64)
    for metric in ("AuPR", "AuROC"):
        assert float(tdm.binary_metric(torch.as_tensor(y), s,
                                       (s > 0.5).double(), metric)) == 0.0


def test_device_metric_equals_host_evaluator():
    y, margin = _tied(500, 2)
    p = 1.0 / (1.0 + np.exp(-margin))
    host = binary_metrics(y, (p > 1 - p).astype(float), p)
    ref = jax_host(y, (p > 1 - p).astype(float), p)
    for metric in ("AuPR", "AuROC", "Precision", "Recall", "F1", "Error"):
        dev = tdm.binary_metric(torch.as_tensor(y), *tdm.binary_from_sigmoid(
            torch.as_tensor(margin)), metric)
        assert abs(float(dev) - getattr(host, metric)) <= 1e-12
        assert getattr(host, metric) == getattr(ref, metric)


def test_raw_pair_scores_match_jax():
    """The logistic model's score twin: the max-shifted softmax of the
    [-m, m] pair, saturating margins included, equals the JAX package's
    (1e-15), and so does its AuPR (1e-12, the other tests' tolerance: the
    trapezoid sums add in another order)."""
    y, margin = _tied(400, 3)
    margin = margin * 12.0                        # p rounds to 1 at m > 19
    raw = np.stack([-margin, margin], axis=1)
    ref = jdm.binary_from_raw_pair(jnp.asarray(raw))
    got = tdm.binary_from_raw_pair(torch.as_tensor(raw))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    assert abs(float(tdm.binary_metric(torch.as_tensor(y), *got, "AuPR"))
               - float(jdm.binary_metric(jnp.asarray(y), *ref, "AuPR"))
               ) <= 1e-12
