"""The ZeroSpeech export, its feature combiners and the PCA/SFA reductions of
the port against the JAX package on the CPU, at a tiny width (16), on the
corpus and the JAX-written checkpoint of `test_torch_clustering`.

`PCA` and `SFALinear` are built from the same streamed batches on both
sides. Their eigenvectors are defined up to sign only (`torch.linalg.eigh`
and `numpy.linalg.eigh` may pick either), so each eigenvector and each
projected column is compared after aligning its sign with the JAX
package's; the data are drawn so that no two eigenvalues lie within 1e-3 of
the largest of each other, where a rotation between eigenvectors would be
as right as another. Dim-reduction checkpoints of either package load in
the other. `ModelClusterCombined` (oneHot, int, softmax),
`ModelPhoneCombined` and `CPCModule` run on the same weights as the JAX
package's. `build_zeroSpeech_features.main` writes fea, npz and npy, plain,
with `--clusters`, `--dimReduction` and `--addCriterion` (the phone head of a
`cpc2_torch.train --supervised --pathPhone` checkpoint, which loads in both
packages' `load_supervised_criterion`).

The port accumulates the moments in float64; the JAX package forms each
batch's products in float32 (numpy on float32 arrays) and adds them in
float64, so the two differ by float32 rounding of the moments.

Tolerances: rtol 1e-5, atol 1e-6 (fp32 reordering) for features,
moments and exports; the eigenvectors (unit rows) and SFA's whitened
matrices (O(1) entries) atol 1e-5, the moments' rounding over the
eigenvalues' gaps (SFA's through the inverse Cholesky factor), and the
projections 1e-5 of their largest magnitude; the eigenvalues of the main's PCA 1e-5 of the
largest (float64 moments of features that agree to 1e-6).
"""

import json
import random

import jax
import numpy as np
import pytest
import torch

from cpc2_tpu import feature_loader as jax_fl
from cpc2_tpu.clustering.clustering import kMeanCluster as JaxKMeanCluster
from cpc2_tpu.eval import build_zeroSpeech_features as jax_export
from cpc2_tpu.losses.criterion import (
    CPCUnsupervisedCriterion as JaxCriterion)
from cpc2_tpu.research import dim_reduction as jax_dr
from cpc2_torch import feature_loader as fl
from cpc2_torch.clustering.clustering import (kMeanCluster,
                                              save_clustering_checkpoint)
from cpc2_torch.eval import build_zeroSpeech_features
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.losses import CPCUnsupervisedCriterion
from cpc2_torch.research import dim_reduction as dr
from cpc2_torch.train import main as train_main
from tests.test_torch_clustering import corpus, jax_checkpoint  # noqa: F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
# unit eigenvectors: the moments' rounding over the eigenvalues' gaps
EIGENVECTORS = dict(rtol=1e-5, atol=1e-5)
WIDTH = 16


def _first(data):
    return data[0]


def _smooth_batches(seed, n_batches=3, b=4, s=40, d=8):
    """Batches (b, s, d) of random walks, each latent channel at its own
    step size and scale, mixed by a random rotation and offset."""
    rs = np.random.RandomState(seed)
    rot = np.linalg.qr(rs.randn(d, d))[0]
    steps = np.linspace(0.5, 1.5, d) * np.linspace(1, 3, d)
    out = []
    for _ in range(n_batches):
        walk = np.cumsum(rs.randn(b, s, d) * steps, axis=1)
        out.append((walk @ rot.T + 0.5).astype(np.float32))
    return [(x, None) for x in out]


def _separated(values):
    v = np.sort(np.asarray(values, np.float64))
    return np.diff(v).min() > 1e-3 * np.abs(v).max()


def _align(got, want):
    """Signs (d,) that turn each row of `got` (d, k) towards `want`'s."""
    return np.where((np.asarray(got) * np.asarray(want)).sum(1) < 0, -1.0,
                    1.0)


def _close_projections(got, want):
    """Projected columns: an eigenvector's error times the input's scale,
    so 1e-5 of the largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_pca_matches_jax():
    loader = _smooth_batches(0)
    got = dr.buildPCA(loader, _first, 8)
    want = jax_dr.buildPCA(loader, _first, 8)
    assert _separated(want.PCA_values)
    np.testing.assert_allclose(got.mean.numpy(), want.mean, **TOL)
    np.testing.assert_allclose(got.var.numpy(), want.var, **TOL)
    np.testing.assert_allclose(got.PCA_values.numpy(), want.PCA_values,
                               rtol=1e-5, atol=1e-6 * want.PCA_values.max())
    signs = _align(got.PCA_mul[0], want.PCA_mul[0])
    np.testing.assert_allclose(got.PCA_mul[0].numpy() * signs[:, None],
                               want.PCA_mul[0], **EIGENVECTORS)
    x = _smooth_batches(1, 1)[0][0]
    _close_projections(got(x).numpy() * signs, want(x))
    assert got.PCA_mul.dtype == torch.float32
    assert got.var.dtype == torch.float64


def test_sfa_matches_jax():
    loader = _smooth_batches(0)
    got = dr.buildSFA(loader, _first, 8)
    want = jax_dr.buildSFA(loader, _first, 8)
    assert _separated(want.PCA_values)
    for key in ("mean_x", "square_x", "covar_x"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   getattr(want, key), err_msg=key, **TOL)
    # whitened: O(1) entries, through the inverse Cholesky factor
    for key in ("covar_speed", "normalizer", "PCA_values"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   getattr(want, key), err_msg=key,
                                   **EIGENVECTORS)
    signs = _align(got.PCA_mul[0], want.PCA_mul[0])
    np.testing.assert_allclose(got.PCA_mul[0].numpy() * signs[:, None],
                               want.PCA_mul[0], **EIGENVECTORS)
    x = _smooth_batches(3, 1)[0][0]
    _close_projections(got(x).numpy() * signs, want(x))


@pytest.mark.parametrize("kind", ["PCA", "SFA"])
def test_dim_reduction_checkpoints_load_in_either_package(kind, tmp_path):
    """A port-written file in the JAX package and the JAX package's format
    (its main's `torch.from_numpy` of each array) in the port: the same
    arrays bit for bit; with `centroidLimits` the SFA projection keeps the
    same rows."""
    loader = _smooth_batches(4)
    build = {"PCA": (dr.buildPCA, jax_dr.buildPCA),
             "SFA": (dr.buildSFA, jax_dr.buildSFA)}[kind]
    port, ref = build[0](loader, _first, 8), build[1](loader, _first, 8)
    values = np.linspace(-1, 1, 8)
    torch.save({"state_dict": {k: v.clone() for k, v in
                               port.state_dict().items()},
                "inDim": 8, "type": kind, "centroid_values": values},
               tmp_path / "port.pt")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                               ref.state_dict().items()},
                "inDim": 8, "type": kind, "centroid_values": values},
               tmp_path / "jax.pt")
    limits = [-0.5, 0.6] if kind == "SFA" else None
    for path, source in (("port.pt", port), ("jax.pt", ref)):
        mine = dr.loadDimReduction(tmp_path / path, limits)
        theirs = jax_dr.loadDimReduction(tmp_path / path, limits)
        for key, value in source.state_dict().items():
            if key == "projection" and limits is not None:
                continue
            np.testing.assert_array_equal(mine.state_dict()[key].numpy(),
                                          np.asarray(value), err_msg=key)
            np.testing.assert_array_equal(np.asarray(
                theirs.state_dict()[key]), np.asarray(value), err_msg=key)
        if limits is not None:
            np.testing.assert_array_equal(mine.projection.numpy(),
                                          theirs.projection)
            assert mine.projection.shape == (1, 4, 8)
        x = loader[0][0]
        _close_projections(mine(x).numpy(), theirs(x))


def test_dim_reduction_main_matches_jax(jax_checkpoint, corpus,  # noqa: F811
                                        tmp_path):
    """`main --mode PCA` over the corpus by a sequential loader of 4
    windows of 3,200 samples, the LSTM's state carried across batches."""
    root, _item, _paths, _phones = corpus
    argv = [str(jax_checkpoint), None, "--pathDB", str(root), "--extension",
            ".wav", "--recursionLevel", "1", "--mode", "PCA", "--batchSize",
            "4", "--sizeWindow", "3200"]
    out = {}
    for side, main, extra in (("port", dr.main, ["--device", "cpu"]),
                              ("jax", jax_dr.main, [])):
        argv[1] = str(tmp_path / f"{side}.pt")
        random.seed(2)
        main(argv + extra)
        out[side] = torch.load(tmp_path / f"{side}.pt", weights_only=False)
        assert json.loads((tmp_path / f"{side}_args.json").read_text())[
            "mode"] == "PCA"
    assert out["port"]["inDim"] == out["jax"]["inDim"] == WIDTH
    got, want = out["port"]["state_dict"], out["jax"]["state_dict"]
    for key in ("mean", "var"):
        assert got[key].dtype == want[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    values = want["PCA_values"].numpy()
    np.testing.assert_allclose(got["PCA_values"].numpy(), values, rtol=0,
                               atol=1e-5 * np.abs(values).max())


@pytest.fixture(scope="module")
def phone_checkpoint(corpus, tmp_path_factory):  # noqa: F811
    """One epoch of `cpc2_torch.train --supervised --pathPhone` on the
    corpus, at width 16."""
    root, _item, _paths, phones = corpus
    ck = tmp_path_factory.mktemp("phone_ck")
    train_main(["--pathDB", str(root), "--file_extension", ".wav",
                "--device", "cpu", "--nEpoch", "1", "--hiddenEncoder",
                str(WIDTH), "--hiddenGar", str(WIDTH), "--sizeWindow",
                "3200", "--batchSizeGPU", "4", "--random_seed", "3",
                "--n_process_loader", "1", "--supervised", "--pathPhone",
                str(phones), "--pathCheckpoint", str(ck)])
    return ck / "checkpoint_0.pt"


def _makers(checkpoint):
    port = fl.FeatureModule(fl.load_model([str(checkpoint)])[0], False)
    bundle = jax_fl.load_model([str(checkpoint)])[0]
    return port, jax_fl.FeatureModule(bundle, False), bundle


def _audio(seed=0, b=2, t=3200):
    return np.random.RandomState(seed).randn(b, t).astype(np.float32)


@pytest.mark.parametrize("out_format", ["oneHot", "int", "softmax"])
def test_model_cluster_combined_matches_jax(jax_checkpoint,  # noqa: F811
                                            out_format):
    port, ref, _ = _makers(jax_checkpoint)
    x = _audio()
    feats = port((x, None)).numpy()
    rs = np.random.RandomState(1)
    ck = (feats.reshape(-1, WIDTH)[[0, 9, 23, 31]]
          + 0.01 * rs.randn(4, WIDTH)).astype(np.float32)[None]
    dist = ((feats.reshape(-1, 1, WIDTH) - ck[0][None]) ** 2).sum(-1)
    dist.sort(axis=1)
    assert (dist[:, 1] - dist[:, 0]).min() > 1e-5
    got = fl.ModelClusterCombined(port, kMeanCluster(ck), 4, out_format)(
        (x, None))
    want = np.asarray(jax_fl.ModelClusterCombined(
        ref, JaxKMeanCluster(ck), 4, out_format)((x, None)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="Invalid output format"):
        fl.ModelClusterCombined(port, kMeanCluster(ck), 4, "bad")


@pytest.mark.parametrize("one_hot", [False, True])
def test_model_phone_combined_matches_jax(phone_checkpoint, one_hot):
    """The phone head of a port checkpoint, loaded by each package's
    `load_supervised_criterion`."""
    port, ref, _ = _makers(phone_checkpoint)
    crit, n_phones = fl.load_supervised_criterion(str(phone_checkpoint))
    jax_crit, jax_n = jax_fl.load_supervised_criterion(str(phone_checkpoint))
    assert n_phones == jax_n == 2
    x = _audio(2)
    got = fl.ModelPhoneCombined(port, crit, one_hot)((x, None))
    want = np.asarray(jax_fl.ModelPhoneCombined(ref, jax_crit, one_hot)(
        (x, None)))
    assert got.shape == want.shape == (2, 20, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("main_distance_only", [False, True])
def test_cpc_module_matches_jax(jax_checkpoint,  # noqa: F811
                                main_distance_only):
    """`cosine_distances` of a 2-head criterion with the JAX weights, in
    training mode on the port's side: the heads run without dropout."""
    k, frames = 2, 20
    crit = JaxCriterion(n_predicts=k, dim_ar=WIDTH, dim_enc=WIDTH,
                        negative_sampling_ext=4, rnn_mode="transformer",
                        size_input_seq=frames)
    zeros = jax.numpy.zeros((2, frames, WIDTH))
    # the heads are all the criterion's parameters
    variables = crit.init({"params": jax.random.PRNGKey(1)}, zeros, zeros,
                          method=crit.cosine_distances)
    port_crit = CPCUnsupervisedCriterion(k, WIDTH, WIDTH, 4,
                                         size_input_seq=frames)
    port_crit.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    model = fl.load_model([str(jax_checkpoint)])[0]
    bundle = jax_fl.load_model([str(jax_checkpoint)])[0]
    x = _audio(3, t=frames * 160)
    module = fl.CPCModule(model, fl.CriterionWrapper(port_crit),
                          main_distance_only=main_distance_only)
    port_crit.train()
    got = module((x, None))
    assert port_crit.training
    ref = jax_fl.CPCModule(bundle, jax_fl.CriterionWrapper(crit, variables),
                           main_distance_only=main_distance_only)
    # one program rather than each of its operations compiled in turn
    want = np.asarray(jax.jit(lambda a: ref((a, None)))(x))
    assert got.shape == want.shape == (2, frames - k)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    c, e, _ = model(torch.from_numpy(x))
    scores = port_crit.cosine_distances(c, e)
    assert scores.shape == (2, k, frames - k)


def _read(path, fmt):
    if fmt == "fea":
        rows = [list(map(float, line.split()))
                for line in path.read_text().splitlines()]
        return {"rows": np.asarray(rows)}
    if fmt == "npz":
        return dict(np.load(path))
    return {"features": np.load(path)}


@pytest.fixture(scope="module")
def export_heads(jax_checkpoint, corpus, tmp_path_factory):  # noqa: F811
    """A clustering checkpoint of 5 centroids near feature rows and a PCA
    file of the port, for `--clusters` and `--dimReduction`."""
    root, _item, paths, _phones = corpus
    out = tmp_path_factory.mktemp("heads")
    port, _, _ = _makers(jax_checkpoint)
    feats = fl.build_feature(port, paths[0], maxSizeSeq=3200)[0]
    save_clustering_checkpoint(feats[[1, 12, 25, 40, 55]][None] + 0.01,
                               out / "clusters.pt")
    pca = dr.buildPCA([(feats[None], None)], _first, WIDTH)
    torch.save({"state_dict": pca.state_dict(), "inDim": WIDTH,
                "type": "PCA"}, out / "pca.pt")
    return out


@pytest.mark.parametrize("fmt,head", [
    ("fea", None), ("npz", None), ("npy", None), ("npz", "clusters"),
    ("npy", "dimReduction"), ("fea", "addCriterion")])
def test_export_matches_jax(jax_checkpoint, phone_checkpoint,  # noqa: F811
                            export_heads, corpus, tmp_path, fmt, head):
    root, _item, paths, _phones = corpus
    ck = phone_checkpoint if head == "addCriterion" else jax_checkpoint
    flags = {None: [], "clusters": ["--clusters",
                                    str(export_heads / "clusters.pt")],
             "dimReduction": ["--dimReduction",
                              str(export_heads / "pca.pt")],
             "addCriterion": ["--addCriterion"]}[head]
    outputs = {}
    for side, main, extra in (("port", build_zeroSpeech_features.main,
                               ["--device", "cpu"]),
                              ("jax", jax_export.main, [])):
        out = tmp_path / side
        main([str(root), str(out), str(ck), "--format", fmt,
              "--maxSizeSeq", "3200"] + flags + extra)
        outputs[side] = {p.name: _read(p, fmt)
                         for p in sorted(out.glob(f"*.{fmt}"))}
        sidecar = json.loads((tmp_path / f"{side}.json").read_text())
        assert sidecar["format"] == fmt
    assert sorted(outputs["port"]) == sorted(
        f"{p.split('/')[-1][:-4]}.{fmt}" for p in paths)
    assert outputs["port"].keys() == outputs["jax"].keys()
    width = {None: WIDTH, "clusters": 5, "dimReduction": WIDTH,
             "addCriterion": 2}[head]
    for name, got in outputs["port"].items():
        want = outputs["jax"][name]
        assert got.keys() == want.keys()
        for key in got:
            assert got[key].shape == want[key].shape, (name, key)
            np.testing.assert_allclose(got[key], want[key], err_msg=name,
                                       **TOL)
        frames = (9600 if "-0." in name else 8000) // 160
        if fmt == "fea":
            assert got["rows"].shape == (frames, width + 1)
            np.testing.assert_array_equal(
                got["rows"][:, 0], 0.005 + 0.01 * np.arange(frames))
        else:
            assert got["features"].shape == (frames, width)


def test_export_cuda_without_a_card_and_train_mode_raise(
        jax_checkpoint, corpus, tmp_path, monkeypatch):  # noqa: F811
    """`--device cuda` without a card raises; `--train_mode` runs the
    per-file loop (no batching across files, as in the JAX package: each
    forward draws its own dropout masks) and, on the LSTM model (no
    dropout), writes the JAX package's `--train_mode` features."""
    root, _item, paths, _phones = corpus
    argv = [str(root), str(tmp_path / "o"), str(jax_checkpoint)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_zeroSpeech_features.main(argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dr.main([str(jax_checkpoint), str(tmp_path / "p.pt"),
                     "--pathDB", str(root)])

    def batched(*_args, **_kw):
        raise AssertionError("--train_mode batched files")
    monkeypatch.setattr(fl, "build_feature_files", batched)
    outputs = {}
    for side, main, extra in (("port", build_zeroSpeech_features.main,
                               ["--device", "cpu"]),
                              ("jax", jax_export.main, [])):
        out = tmp_path / side
        main([str(root), str(out), str(jax_checkpoint), "--format", "npy",
              "--maxSizeSeq", "3200", "--train_mode"] + extra)
        outputs[side] = {p.name: np.load(p) for p in sorted(out.glob("*"))}
    assert sorted(outputs["port"]) == sorted(
        f"{p.split('/')[-1][:-4]}.npy" for p in paths)
    for name, got in outputs["port"].items():
        np.testing.assert_allclose(got, outputs["jax"][name], err_msg=name,
                                   **TOL)
    sidecar = json.loads((tmp_path / "port.json").read_text())
    assert sidecar["train_mode"] is True
