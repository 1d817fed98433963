"""The port's host DTW (`cpc2_torch.ops.dtw_host`, `csrc/host/dtwhost.cc`
built with g++) against the JAX package's host DTW
(`cpc2_tpu.ops.dtw_host`, where its library builds), the JAX wavefront
DTW and the port's plain DTW: bit for bit, on random and tie-heavy
distances, through `dtw_batch_host` with `ignore_diag` and `symetric`,
and its length checks.
"""

import numpy as np
import pytest
import torch

from cpc2_torch.ops.dtw import dtw_normalized_plain
from cpc2_torch.ops.dtw_host import dtw_batch_host, dtw_normalized_host
from cpc2_tpu.ops import dtw as jax_dtw
from cpc2_tpu.ops import dtw_host as jax_host


def _references(dist, n1, n2):
    """The other implementations' scores of the same pairs."""
    out = [np.asarray(jax_dtw.dtw_normalized(dist, n1, n2)),
           dtw_normalized_plain(torch.from_numpy(dist), torch.from_numpy(n1),
                                torch.from_numpy(n2)).numpy()]
    if jax_host.get_lib() is not None:
        out.append(jax_host.dtw_normalized_host(dist, n1, n2))
    return out


@pytest.mark.parametrize("draw", ["random", "ties"])
def test_bit_for_bit(rng, draw):
    """Random distances, and quantized ones whose many ties exercise the
    backtrack's diag <= left <= up order."""
    b, s1, s2 = 24, 37, 29
    if draw == "random":
        dist = rng.rand(b, s1, s2).astype(np.float32)
    else:
        dist = (rng.randint(0, 3, size=(b, s1, s2)) * 0.5).astype(np.float32)
    n1 = rng.randint(1, s1 + 1, size=b).astype(np.int32)
    n2 = rng.randint(1, s2 + 1, size=b).astype(np.int32)
    ours = dtw_normalized_host(dist, n1, n2)
    assert ours.dtype == np.float32 and ours.shape == (b,)
    for ref in _references(dist, n1, n2):
        np.testing.assert_array_equal(ours, ref)


def test_hand_computed():
    d = np.array([[[0.0, 1.0], [1.0, 0.0]], [[1.0, 2.0], [3.0, 1.0]]],
                 np.float32)
    np.testing.assert_array_equal(
        dtw_normalized_host(d, [2, 2], [2, 2]), np.float32([0.0, 1.0]))


@pytest.mark.parametrize("ignore_diag,symetric", [(False, False),
                                                  (True, True)])
def test_dtw_batch_host(rng, ignore_diag, symetric):
    """All pairs of an (Nx, Ny) block, as the JAX package's host and
    wavefront batches."""
    n, s = 5, 12
    dist = rng.rand(n, n, s, s).astype(np.float32)
    if symetric:
        dist = dist + dist.transpose(1, 0, 3, 2)
    sx = rng.randint(2, s + 1, size=n)
    ours = dtw_batch_host(None, None, sx, sx, dist, ignore_diag=ignore_diag,
                          symetric=symetric)
    want = np.asarray(jax_dtw.dtw_batch(None, None, sx, sx, dist,
                                        ignore_diag=ignore_diag,
                                        symetric=symetric))
    np.testing.assert_array_equal(ours, want)
    if jax_host.get_lib() is not None:
        np.testing.assert_array_equal(ours, jax_host.dtw_batch_host(
            None, None, sx, sx, dist, ignore_diag=ignore_diag,
            symetric=symetric))
    if ignore_diag:
        assert np.all(np.diag(ours) == 0.0)
    if symetric:
        np.testing.assert_array_equal(ours, ours.T)


@pytest.mark.parametrize("n1,n2", [([0], [3]), ([4], [3]), ([2, 2], [3])])
def test_lengths_are_checked(n1, n2):
    with pytest.raises(ValueError):
        dtw_normalized_host(np.zeros((len(n1), 3, 3), np.float32), n1, n2)
