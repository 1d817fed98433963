"""The port's DTW and ABX against the JAX package's on the CPU.

`dtw_normalized_plain` (the plain version of `cpc2_torch/csrc/dtw.cu`)
against `cpc2_tpu.ops.dtw.dtw_normalized` and the Pallas kernel
`dtw_normalized_pallas` in interpret mode; `dtw_batch`; the distances; and
the iterators and the whole `eval_ABX from_pre_computed` pass on the same
`.npy` features and `.item` file.

Tolerances: atol 1e-6 for DTW (every cost is one fp32 add to an exact
minimum, so equality is expected), 1e-5 for distances (arccos in two
libraries) and for ABX scores (the same win counts over the same
triplets).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.eval import eval_ABX as jax_eval_abx
from cpc2_tpu.eval.abx import abx_group_computation as jax_abx_g
from cpc2_tpu.eval.abx import abx_iterators as jax_abx_it
from cpc2_tpu.ops.dtw import dtw_batch as jax_dtw_batch
from cpc2_tpu.ops.dtw import dtw_normalized as jax_dtw
from cpc2_tpu.ops.dtw_pallas import dtw_normalized_pallas
from cpc2_torch.eval import eval_ABX
from cpc2_torch.eval.abx import abx_group_computation as abx_g
from cpc2_torch.eval.abx import abx_iterators as abx_it
from cpc2_torch.ops.dtw import (MAX_LEN, _bucket, dtw_batch, dtw_normalized,
                                dtw_normalized_plain)

torch.set_num_threads(1)

DTW_TOL = dict(rtol=0, atol=1e-6)


def _dtw_inputs(seed, p, s1, s2, ties):
    rs = np.random.RandomState(seed)
    if ties:
        # three distinct values: equal costs meet at most cells, so the
        # tie-break decides the path length
        dist = rs.randint(0, 3, (p, s1, s2)).astype(np.float32) / 2
    else:
        dist = rs.rand(p, s1, s2).astype(np.float32)
    n1 = rs.randint(1, s1 + 1, p).astype(np.int32)
    n2 = rs.randint(1, s2 + 1, p).astype(np.int32)
    n1[0] = n2[0] = 1                # a padded pair: d[0, 0]
    n1[1], n2[1] = s1, s2            # a whole matrix
    return dist, n1, n2


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,s1,s2", [(9, 16, 24), (7, 8, 40), (6, 40, 12)])
def test_dtw_plain_matches_jax_and_pallas(p, s1, s2, ties):
    dist, n1, n2 = _dtw_inputs(s1 + s2, p, s1, s2, ties)
    got = dtw_normalized_plain(torch.from_numpy(dist), torch.from_numpy(n1),
                               torch.from_numpy(n2)).numpy()
    scan = np.asarray(jax_dtw(jnp.asarray(dist), jnp.asarray(n1),
                              jnp.asarray(n2)))
    pallas = np.asarray(dtw_normalized_pallas(
        jnp.asarray(dist), jnp.asarray(n1), jnp.asarray(n2), interpret=True))
    np.testing.assert_allclose(got, scan, **DTW_TOL)
    np.testing.assert_allclose(got, pallas, **DTW_TOL)
    np.testing.assert_array_equal(got[0], dist[0, 0, 0])


def test_dtw_wrapper_on_cpu_is_the_plain_version():
    dist, n1, n2 = _dtw_inputs(0, 5, 8, 16, False)
    args = [torch.from_numpy(a) for a in (dist, n1, n2)]
    np.testing.assert_array_equal(dtw_normalized(*args).numpy(),
                                  dtw_normalized_plain(*args).numpy())
    with pytest.raises(ValueError, match="dtw_normalized"):
        dtw_normalized(args[0], args[1][:3], args[2])


def test_kernel_limit_covers_buckets_to_20_s():
    """Every bucket of a token up to 2,048 frames fits the kernel."""
    assert max(_bucket(n) for n in range(1, 2049)) == MAX_LEN == 2048


@pytest.mark.parametrize("ignore_diag", [False, True])
def test_dtw_batch_matches_jax(ignore_diag):
    rs = np.random.RandomState(4)
    dist_mat = rs.rand(3, 4, 10, 13).astype(np.float32)
    sx = rs.randint(1, 11, 3)
    sy = rs.randint(1, 14, 4)
    got = dtw_batch(None, None, sx, sy, dist_mat, ignore_diag=ignore_diag,
                    device="cpu")
    want = jax_dtw_batch(None, None, sx, sy, dist_mat,
                         ignore_diag=ignore_diag)
    np.testing.assert_allclose(got, want, **DTW_TOL)


@pytest.mark.parametrize("name", ["cosine", "euclidian"])
def test_distances_match_jax(name):
    rs = np.random.RandomState(1)
    a1 = abx_it.normalize_with_singularity(rs.randn(3, 5, 8))
    a2 = abx_it.normalize_with_singularity(rs.randn(4, 7, 8))
    got = abx_g.get_distance_function_from_name(name)(
        torch.from_numpy(a1), torch.from_numpy(a2)).numpy()
    want = np.asarray(jax_abx_g.get_distance_function_from_name(name)(a1, a2))
    assert got.shape == (3, 4, 5, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


PHONES = ["aa", "iy", "uw"]


@pytest.fixture(scope="module")
def npy_features(tmp_path_factory):
    """3 speakers x 2 files of (160, 6) random features saved as .npy,
    and an .item file of 6 tokens per file: "aa" and "iy" of 9-15 frames,
    "uw" of 19-29, so that groups pair ragged lengths in buckets 16 and 32
    (few distinct shapes keep the JAX side's compiles few)."""
    root = tmp_path_factory.mktemp("abx_npy")
    feats = root / "feats"
    feats.mkdir()
    rs = np.random.RandomState(7)
    lines = ["#file onset offset #phone prev-phone next-phone speaker"]
    for s in range(3):
        for f in range(2):
            name = f"spk{s}-{f}"
            np.save(feats / f"{name}.npy",
                    rs.randn(160, 6).astype(np.float32))
            t = 0.05
            for k in range(6):
                phone = PHONES[(k + s) % 3]
                dur = (0.20 if phone == "uw" else 0.10) \
                    + 0.01 * rs.randint(0, 7)
                lines.append(f"{name} {t:.3f} {t + dur:.3f} {phone} sil sil "
                             f"spk{s}")
                t += dur
    item = root / "test.item"
    item.write_text("\n".join(lines) + "\n")
    return item, feats


def _loaders(item, feats):
    seqs = sorted((p.stem, str(p)) for p in feats.glob("*.npy"))
    return (abx_it.ABXFeatureLoader(str(item), seqs, np.load, 100, True),
            jax_abx_it.ABXFeatureLoader(str(item), seqs, np.load, 100, True))


@pytest.mark.parametrize("mode", ["within", "across"])
def test_iterators_match_jax(npy_features, mode):
    loader, jax_loader = _loaders(*npy_features)
    np.testing.assert_array_equal(loader.data, jax_loader.data)
    extra = {"max_x_across": 1} if mode == "across" else {}
    random.seed(0)
    groups = list(loader.get_iterator(mode, 3, **extra))
    random.seed(0)
    jax_groups = list(jax_loader.get_iterator(mode, 3, **extra))
    assert len(groups) == len(jax_groups) > 0
    for got, want in zip(groups, jax_groups):
        assert got[0] == want[0]
        for (block, sizes), (jblock, jsizes) in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(block, jblock)
            np.testing.assert_array_equal(sizes, jsizes)
            np.testing.assert_array_equal(block.token_starts,
                                          jblock.token_starts)


def test_group_scorer_host_loop_matches_batched(npy_features):
    """A distance callable other than the built-in ones takes the host
    loop; with the cosine distance's own math it gives the same scores."""
    loader, _ = _loaders(*npy_features)

    def cosine(a1, a2):
        return abx_g.get_cosine_distance_batch(a1, a2)
    it = loader.get_iterator("within", 20)
    batched = abx_g.get_abx_scores_dtw_on_group(
        it, abx_g.get_cosine_distance_batch, True, device="cpu")
    host = abx_g.get_abx_scores_dtw_on_group(it, cosine, True, device="cpu")
    np.testing.assert_array_equal(batched[0], host[0])
    np.testing.assert_allclose(batched[1], host[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("flags", [
    [], ["--max_size_group", "3", "--max_x_across", "1", "--abx_seed", "3"]])
def test_eval_abx_from_pre_computed_matches_jax(npy_features, tmp_path,
                                                flags):
    item, feats = npy_features
    argv = ["from_pre_computed", str(item), str(feats), "--file_extension",
            ".npy"] + flags
    got = eval_ABX.main(argv + ["--device", "cpu", "--out",
                                str(tmp_path / "port")])
    want = jax_eval_abx.main(argv + ["--out", str(tmp_path / "jax")])
    assert set(got) == {"within", "across"}
    for mode in got:
        assert 0.0 <= got[mode] <= 1.0
        np.testing.assert_allclose(got[mode], want[mode], rtol=0, atol=1e-5)
    assert (tmp_path / "port" / "ABX_scores.json").exists()
    assert (tmp_path / "port" / "ABX_args.json").exists()
    assert eval_ABX.LAST_RUN["flushes"] > 0


def test_eval_abx_cuda_without_a_card_raises(npy_features, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    item, feats = npy_features
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_ABX.main(["from_pre_computed", str(item), str(feats),
                       "--file_extension", ".npy", "--out", str(tmp_path)])
