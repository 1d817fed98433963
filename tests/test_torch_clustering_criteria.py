"""The research clustering criteria of the port (`cpc2_torch/research/
clustering_criterion.py`) against the JAX package's on the CPU, with the
JAX classifier's and CTC head's parameters carried across by
`state_dict_from_jax`: the delay gate, the invalid update mode, the
DeepClustering cross-entropy, `assign_labels`, the CTC loss, the DEC KL
loss and one DEC centroid update, and the k-means and DP-means cluster
updates from numpy's global state seeded the same before each side.

The JAX package's DEC update raises (its `jax.grad` reaches
`kMeanCluster`, which turns the traced centroids into numpy); the
comparison runs it with `kMeanCluster` replaced by the same distances in
jnp, which is the JAX package's update with that one fault mended.

Tolerances: losses, distances, gradients and centroids rtol 1e-5, atol
1e-6 (fp32 reordering; the cluster updates accumulate in another order, as
`tests/test_torch_clustering.py` states); labels exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpc2_tpu.research.clustering_criterion as jax_cc
from cpc2_tpu.clustering import clustering as jax_cl
from cpc2_torch.clustering import clustering as cl
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.research import (CTCCLustering, DeepClustering,
                                 DeepEmbeddedClustering)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")


def _blobs(seed, n_batches=4, b=3, s=10, d=8, k=5, spread=0.3):
    rs = np.random.RandomState(seed)
    centres = 3.0 * rs.randn(k, d)
    return [((centres[rs.randint(0, k, (b, s))]
              + spread * rs.randn(b, s, d)).astype(np.float32), None)
            for _ in range(n_batches)]


def _first(data):
    return data[0]


@pytest.mark.parametrize("cls,extra", [(DeepClustering, ()),
                                       (DeepEmbeddedClustering, (0.01,))])
def test_delay_gates_loss(cls, extra):
    jax_cls = getattr(jax_cc, cls.__name__)
    port = cls(*extra, 4, 8, 2, 1, "kmean", **CPU)
    ref = jax_cls(*extra, 4, 8, 2, 1, "kmean")
    x = np.zeros((2, 3, 8), np.float32)
    args = (x,) if cls is DeepEmbeddedClustering else (
        x, np.zeros((2, 3), np.int64))
    for _ in range(2):
        assert not port.canRun() and not ref.canRun()
        got = port(*(torch.as_tensor(a) for a in args))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref(*args)))
        np.testing.assert_array_equal(got.numpy(), np.zeros((1, 1)))
        port.step += 2
        ref.step += 2
    assert port.canRun() and ref.canRun()


def test_invalid_update_mode():
    with pytest.raises(ValueError, match="spectral"):
        jax_cc.DeepClustering(4, 8, 0, 1, "spectral")
    with pytest.raises(ValueError, match="spectral"):
        DeepClustering(4, 8, 0, 1, "spectral", **CPU)


def test_deep_clustering_ce_matches_jax():
    ref = jax_cc.DeepClustering(3, 6, 0, 1, "kmean")
    port = DeepClustering(3, 6, 0, 1, "kmean", **CPU)
    port.classifier.load_state_dict(state_dict_from_jax(
        ref._params["params"]))
    ref.step = port.step = 1
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 6).astype(np.float32)
    labels = rs.randint(0, 3, (2, 5))
    want = np.asarray(ref(jnp.asarray(x), jnp.asarray(labels)))
    got = port(torch.as_tensor(x), torch.as_tensor(labels))
    assert got.shape == (1, 1) and want[0, 0] > 0
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_assign_labels_matches_jax():
    centers = np.stack([np.zeros(4), np.ones(4) * 5, -np.ones(4)]
                       ).astype(np.float32)[None]
    ref = jax_cc.DeepClustering(3, 4, 0, 1, "kmean")
    port = DeepClustering(3, 4, 0, 1, "kmean", **CPU)
    ref.clusters = jax_cl.kMeanCluster(centers)
    port.clusters = cl.kMeanCluster(centers)
    rs = np.random.RandomState(1)
    ids = rs.permutation(np.arange(24) % 3).reshape(2, 12)
    x = (centers[0][ids] + 0.3 * rs.randn(2, 12, 4)).astype(np.float32)
    want = np.asarray(ref.assign_labels(jnp.asarray(x)))
    got = port.assign_labels(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, ids)


def test_ctc_clustering_loss_matches_jax():
    ref = jax_cc.CTCCLustering(4, 8, 0, 1, "kmean")
    port = CTCCLustering(4, 8, 0, 1, "kmean", **CPU)
    port.main_module.load_state_dict(state_dict_from_jax(
        ref._params["params"]))
    rs = np.random.RandomState(1)
    c = rs.randn(2, 16, 8).astype(np.float32)
    labels = np.pad(rs.randint(0, 4, (2, 4)), ((0, 0), (0, 12)))
    want = np.asarray(ref(jnp.asarray(c), jnp.asarray(labels)))
    got = port(torch.as_tensor(c), torch.as_tensor(labels))
    assert np.isfinite(want).all() and (want > 0).all()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _dec_pair(lr=0.05):
    ck = np.stack([np.ones(4), -np.ones(4), np.zeros(4)]
                  ).astype(np.float32)[None]
    ref = jax_cc.DeepEmbeddedClustering(lr, 3, 4, 0, 2, "kmean")
    port = DeepEmbeddedClustering(lr, 3, 4, 0, 2, "kmean", **CPU)
    ref.clusters = jax_cl.kMeanCluster(ck)
    port.clusters = cl.kMeanCluster(ck)
    return ref, port


def test_dec_kl_loss_matches_jax():
    ref, port = _dec_pair()
    ref.step = port.step = 1
    x = np.random.RandomState(2).randn(2, 6, 4).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(torch.as_tensor(x))
    assert got.shape == (1, 1) and want[0, 0] >= 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


class _TracedKMeanCluster:
    """`kMeanCluster` with its distances in jnp, so that `jax.grad` reaches
    the centroids."""

    def __init__(self, ck):
        self.Ck = jnp.asarray(ck, jnp.float32)

    def __call__(self, x):
        b, s, d = x.shape
        return jax_cl._sq_distances(x.reshape(b * s, d), self.Ck[0]
                                    ).reshape(b, s, -1)


def test_dec_update_matches_jax(monkeypatch):
    """One DEC update (3 batches of `clusterIter` 2) after the first,
    initialising one: the JAX package's own raises; with the traced
    distances it moves the centroids as the port's does."""
    loader = _blobs(4, n_batches=3, d=4, k=3)
    ref, port = _dec_pair()
    ref.init = port.init = True
    with pytest.raises(jax.errors.TracerArrayConversionError):
        ref.updateClusters(loader, _first)
    ref, port = _dec_pair()
    ref.init = port.init = True
    monkeypatch.setattr(jax_cc, "kMeanCluster", _TracedKMeanCluster)
    start = np.asarray(ref.clusters.Ck).copy()
    ref.updateClusters(loader, _first)
    port.updateClusters(loader, lambda data: torch.as_tensor(data[0]))
    got = port.clusters.Ck.numpy()
    assert np.abs(got - start).max() > 1e-3
    np.testing.assert_allclose(got, np.asarray(ref.clusters.Ck), **TOL)
    assert ref.step == port.step == 1


@pytest.mark.parametrize("mode", ["kmean", "dpmean"])
def test_cluster_update_matches_jax(mode):
    """`updateCLusters` past the delay: k-means from 5 rows drawn from
    numpy's global state, or DP-means at the distances' 5% quantile, on
    both sides from the same seed."""
    loader = _blobs(2)
    ref = jax_cc.DeepClustering(5, 8, 0, 2, mode)
    port = DeepClustering(5, 8, 0, 2, mode, **CPU)
    np.random.seed(11)
    ref.updateCLusters(loader, _first, MAX_ITER=3)
    np.random.seed(11)
    port.updateCLusters(loader, _first, MAX_ITER=3)
    assert port.init and ref.init and port.k == ref.k
    want = np.asarray(ref.clusters.Ck)
    assert port.clusters.Ck.shape == want.shape
    np.testing.assert_allclose(port.clusters.Ck.numpy(), want, **TOL)
