"""Clustering, quantization and unit ABX of the port against the JAX package
on the CPU, at a tiny width (16).

The pure functions (`kMeanCluster`'s distances, one `kMeanClusterStep`,
`kMeanGPU` over a fixed list loader from given start centroids and from a
seeded numpy state, `KMean`, `fastDPMean`, `distanceEstimation`) take the
same numpy inputs on both sides. Clustering checkpoints written by either
package load in the other bit for bit. On a JAX-written checkpoint's
features: `build_feature_batch` with strict on and off; then the CLIs end
to end, `clustering_script` from the same start centroids (two groups of 8
dimensions), `clustering_quantization` batched, `--nobatch` and
`--separate-speaker` (identical lines, after checking that no frame's two
nearest centroids lie within 1e-5 of each other, so that no tie can hide a
difference) and `eval_ABX_clustering` with `--clustering` (concat, onehot)
and `--quantized` (equal scores).

Tolerances: distances, sums, centroids and features rtol 1e-5, atol 1e-6
(fp32 reordering); DP-means and k-means accumulate in another order than
the JAX package's host loop (a one-hot product), which the same tolerance
holds; quantized ids and unit ABX scores exact.
"""

import json
import random

import numpy as np
import pytest
import torch

from cpc2_tpu import feature_loader as jax_fl
from cpc2_tpu.clustering import clustering as jax_cl
from cpc2_tpu.clustering import clustering_quantization as jax_quant
from cpc2_tpu.clustering import clustering_script as jax_script
from cpc2_tpu.config import get_default_cpc_config as jax_default_config
from cpc2_tpu.data.audio_io import save_wav
from cpc2_tpu.eval import eval_ABX_clustering as jax_abx_cl
from cpc2_tpu.io.checkpoint import save_args as jax_save_args
from cpc2_tpu.io.torch_ckpt import params_to_torch_state_dict
from cpc2_tpu.io.torch_ckpt import save_checkpoint as jax_save_checkpoint
from cpc2_torch import feature_loader as fl
from cpc2_torch.clustering import clustering as cl
from cpc2_torch.clustering import clustering_quantization, clustering_script
from cpc2_torch.eval import eval_ABX_clustering

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
WIDTH = 16
SPEAKERS = ("s1", "s2", "s3")
GAP = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 speakers x 2 wav files (9,600 and 8,000 samples) of two
    alternating tones, an .item file of 4 tokens per file, and per-frame
    phone labels (two phones, one label every 160 samples)."""
    root = tmp_path_factory.mktemp("units_db")
    rs = np.random.RandomState(3)
    lines = ["#file onset offset #phone prev next speaker"]
    labels = []
    for s, spk in enumerate(SPEAKERS):
        (root / spk).mkdir()
        for i, n in enumerate((9600, 8000)):
            t = np.arange(n) / 16000.0
            tone = (t // 0.12) % 2
            f0 = np.where(tone == 0, 220.0, 330.0) + 20 * s
            x = (0.3 * np.sin(2 * np.pi * f0 * t)
                 + 0.05 * rs.randn(n)).astype(np.float32)
            name = f"{spk}-{i}"
            save_wav(str(root / spk / f"{name}.wav"), x, 16000)
            labels.append(name + " " + " ".join(
                str(int(v)) for v in tone[::160]))
            for k in range(4):
                onset = 0.12 * k + 0.01
                lines.append(f"{name} {onset:.2f} {onset + 0.1:.2f} "
                             f"{('aa', 'bb')[k % 2]} p n {spk}")
    item = root.parent / "units.item"
    item.write_text("\n".join(lines) + "\n")
    phones = root.parent / "units_phones.txt"
    phones.write_text("\n".join(labels) + "\n")
    paths = sorted(str(p) for p in root.rglob("*.wav"))
    return root, item, paths, phones


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX model's weights written as the JAX trainer writes them (its
    windows those of the tests' trainer runs, so that the JAX package
    initialises one model shape)."""
    args = jax_default_config()
    args.hiddenEncoder = args.hiddenGar = WIDTH
    args.sizeWindow = 3200
    args.load = None
    bundle = jax_fl.init_model(args, seed=0)
    ck = tmp_path_factory.mktemp("jax_ck")
    jax_save_checkpoint(params_to_torch_state_dict(bundle.variables["params"],
                                                   norm_mode=args.normMode),
                        {}, {}, None, str(ck / "checkpoint_0.pt"))
    jax_save_args(args, str(ck / "checkpoint_args.json"))
    (ck / "checkpoint_logs.json").write_text("{}")
    return ck / "checkpoint_0.pt"


def _blobs(seed, n_batches=4, b=3, s=10, d=8, k=5, spread=0.3):
    """Feature batches (b, s, d) drawn around k centres: a loader of
    `(features, None)` items for a feature maker that returns `data[0]`."""
    rs = np.random.RandomState(seed)
    centres = 3.0 * rs.randn(k, d)
    out = []
    for _ in range(n_batches):
        ids = rs.randint(0, k, (b, s))
        out.append(((centres[ids] + spread * rs.randn(b, s, d))
                    .astype(np.float32), None))
    return out


def _first(data):
    return data[0]


def _gap(feats, ck):
    """The smallest gap between a row's two nearest centroids' squared
    distances, rows of `feats` (.., d) against `ck` (k, d), in float64."""
    x = np.asarray(feats, np.float64).reshape(-1, ck.shape[-1])
    c = np.asarray(ck, np.float64).reshape(-1, ck.shape[-1])
    d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
    d.sort(axis=1)
    return float((d[:, 1] - d[:, 0]).min())


def test_kmean_cluster_distances_match_jax():
    rs = np.random.RandomState(0)
    feats = rs.randn(2, 9, 16).astype(np.float32)
    ck = rs.randn(1, 6, 16).astype(np.float32)
    got = cl.kMeanCluster(ck)(feats)
    assert got.shape == (2, 9, 6)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_cl.kMeanCluster(ck)(feats)),
                               **TOL)


def test_kmean_cluster_step_matches_jax():
    (feats, _), = _blobs(1, n_batches=1)
    ck = feats.reshape(-1, 8)[:5]
    assert _gap(feats, ck) > GAP
    sums, counts = cl.kMeanClusterStep(cl.kMeanCluster(ck[None]))(feats)
    want_sums, want_counts = jax_cl.kMeanClusterStep(
        jax_cl.kMeanCluster(ck[None]))(feats)
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums), **TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


@pytest.mark.parametrize("start", ["given", "seeded"])
def test_kmean_gpu_matches_jax(start, tmp_path):
    """Four iterations over a list loader. `given`: from start centroids,
    each package saving its checkpoints; `seeded`: the start rows drawn
    from numpy's global state seeded before each side, and from an
    explicit `rng` on the port's."""
    loader = _blobs(2)
    given = loader[0][0].reshape(-1, 8)[[0, 3, 7, 12, 20]][None]
    kw = dict(MAX_ITER=4, EPSILON=0.0)
    if start == "given":
        (tmp_path / "port").mkdir()
        (tmp_path / "jax").mkdir()
        got = cl.kMeanGPU(loader, _first, 5, start_clusters=given,
                          save_dir=tmp_path / "port", device="cpu", **kw)
        want = jax_cl.kMeanGPU(loader, _first, 5, start_clusters=given,
                               save_dir=tmp_path / "jax", mesh=None, **kw)
        port_ck = torch.load(tmp_path / "port" / "checkpoint_4.pt",
                             weights_only=False)
        jax_ck = torch.load(tmp_path / "jax" / "checkpoint_4.pt",
                            weights_only=False)
        for key in ("n_clusters", "dim", "iteration", "mode"):
            assert port_ck[key] == jax_ck[key], key
        np.testing.assert_allclose(port_ck["last_diff"],
                                   jax_ck["last_diff"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(port_ck["state_dict"]["Ck"],
                                      got.numpy())
    else:
        np.random.seed(5)
        got = cl.kMeanGPU(loader, _first, 5, device="cpu", **kw)
        np.random.seed(5)
        want = jax_cl.kMeanGPU(loader, _first, 5, mesh=None, **kw)
        again = cl.kMeanGPU(loader, _first, 5, device="cpu",
                            rng=np.random.RandomState(5), **kw)
        torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert got.shape == (1, 5, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kmean_matches_jax():
    (feats, _), = _blobs(3, n_batches=1, b=6)
    rows = feats.reshape(-1, 8)
    np.random.seed(7)
    got = cl.KMean(rows, 4, MAX_ITER=6, device="cpu")
    np.random.seed(7)
    want = jax_cl.KMean(rows, 4, MAX_ITER=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("from_scratch", [True, False])
def test_fast_dp_mean_matches_jax(from_scratch):
    """lambda = 2 over blobs 3 apart: clusters open during the first
    pass; the count must be the JAX package's."""
    loader = _blobs(4)
    mu = None if from_scratch else loader[1][0][0, :2]
    got = cl.fastDPMean(loader, _first, 2.0, MAX_ITER=3, mu_start=mu,
                        device="cpu")
    want = np.asarray(jax_cl.fastDPMean(loader, _first, 2.0, MAX_ITER=3,
                                        mu_start=mu, mesh=None))
    assert got.shape == want.shape and want.shape[1] > 3
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_distance_estimation_matches_jax():
    loader = _blobs(5, n_batches=3)
    np.random.seed(11)
    got = cl.distanceEstimation(_first, loader, maxSizeGroup=17,
                                device="cpu")
    np.random.seed(11)
    want = jax_cl.distanceEstimation(_first, loader, maxSizeGroup=17)
    assert len(got) == len(want) > 0 and got == sorted(got)
    np.testing.assert_allclose(got, want, **TOL)


def test_clustering_checkpoints_load_in_either_package(tmp_path):
    rs = np.random.RandomState(6)
    ck = rs.randn(1, 7, 12).astype(np.float32)
    base = torch.from_numpy(rs.randn(3, 7, 12).astype(np.float32))
    # a view of a larger tensor: only its own values are saved
    cl.save_clustering_checkpoint(base[1:2], tmp_path / "port.pt",
                                  mode="kMean", iter=3, last_diff=0.5)
    jax_cl.save_clustering_checkpoint(ck, tmp_path / "jax.pt",
                                      mode="DPMean", iter=2, last_diff=0.25)
    port_file = torch.load(tmp_path / "port.pt", weights_only=False)
    assert port_file["state_dict"]["Ck"].untyped_storage().nbytes() == \
        7 * 12 * 4
    assert {k: v for k, v in port_file.items() if k != "state_dict"} == {
        "n_clusters": 7, "dim": 12, "iteration": 3, "last_diff": 0.5,
        "mode": "kMean"}
    np.testing.assert_array_equal(
        np.asarray(jax_cl.load_clustering_checkpoint(
            tmp_path / "port.pt").Ck), base[1:2].numpy())
    loaded = cl.loadClusterModule(tmp_path / "jax.pt")
    assert loaded.Ck.dtype == torch.float32 and loaded.k == 7
    np.testing.assert_array_equal(loaded.Ck.numpy(), ck)


def test_get_last_checkpoint_and_mesh(tmp_path):
    for i in (1, 3, 12):
        (tmp_path / f"checkpoint_{i}.pt").write_bytes(b"")
    (tmp_path / "checkpoint_last.pt").write_bytes(b"")
    assert cl.get_last_checkpoint(tmp_path).name == "checkpoint_12.pt"
    assert cl.get_last_checkpoint(tmp_path) == jax_cl.get_last_checkpoint(
        tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cl.kMeanGPU(_blobs(0, 1), _first, 2, mesh="data", device="cpu")


@pytest.mark.parametrize("strict", [True, False])
def test_build_feature_batch_matches_jax(jax_checkpoint, corpus, strict):
    """3,200-sample chunks two at a time: 9,600 samples are 3 chunks (a
    batch of 2, then 1), 8,000 are 2 chunks and a 1,600-sample remainder
    (with `strict` the last 3,200 samples' final 10 frames)."""
    _root, _item, paths, _phones = corpus
    port = fl.FeatureModule(fl.load_model([str(jax_checkpoint)])[0], False)
    ref = jax_fl.FeatureModule(jax_fl.load_model([str(jax_checkpoint)])[0],
                               False)
    for path in paths[:2]:
        got = fl.buildFeature_batch(port, path, strict=strict,
                                    maxSizeSeq=3200, batch_size=2)
        want = np.asarray(jax_fl.buildFeature_batch(
            ref, path, strict=strict, maxSizeSeq=3200, batch_size=2))
        assert isinstance(got, np.ndarray)
        assert got.shape == want.shape == (
            1, (9600 if path.endswith("-0.wav") else 8000) // 160, WIDTH)
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)


@pytest.fixture(scope="module")
def clustering_runs(jax_checkpoint, corpus, tmp_path_factory):
    """`clustering_script.main` of both packages over the same corpus and
    checkpoint from the same 4 start centroids of 8 dimensions (the 16
    channels in 2 groups), 2 iterations. The JAX package's loader takes
    `--batchSizeGPU` times its device count windows a batch, the port's
    `--batchSizeGPU`: the port is given that product."""
    import jax
    root, _item, paths, _phones = corpus
    out = tmp_path_factory.mktemp("clusterings")
    feats = fl.build_feature_files(fl.FeatureModule(
        fl.load_model([str(jax_checkpoint)])[0], False, keep_hidden=True),
        paths[:1])[paths[0]].reshape(-1, 8)
    start = out / "start.pt"
    cl.save_clustering_checkpoint(feats[[0, 15, 40, 77]][None], start)
    n_dev = len(jax.devices())
    argv = [str(jax_checkpoint), None, str(root), "--extension", ".wav",
            "--recursionLevel", "1", "--sizeWindow", "3200", "-n", "2",
            "-k", "4", "--load", str(start)]
    runs = {}
    for side, main, batch, extra in (
            ("port", clustering_script.main, n_dev, ["--device", "cpu"]),
            ("jax", jax_script.main, 1, [])):
        argv[1] = str(out / side)
        random.seed(0)
        np.random.seed(0)
        main(argv + ["--batchSizeGPU", str(batch)] + extra)
        runs[side] = out / side
    return runs


def test_clustering_script_matches_jax(clustering_runs):
    got = torch.load(clustering_runs["port"] / "checkpoint_last.pt",
                     weights_only=False)["state_dict"]["Ck"]
    want = torch.load(clustering_runs["jax"] / "checkpoint_last.pt",
                      weights_only=False)["state_dict"]["Ck"]
    assert got.shape == (1, 4, 8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    saved = json.loads((clustering_runs["port"] / "args.json").read_text())
    assert saved["device"] == "cpu" and saved["MAX_ITER"] == 2
    assert (clustering_runs["port"] / "checkpoint_2.pt").is_file()


def _quantized_features(checkpoint, paths, mode):
    """The features the quantization of `mode` computes, by the port."""
    maker = fl.FeatureModule(fl.load_model([str(checkpoint)])[0], False,
                             keep_hidden=mode == "nobatch")
    if mode == "nobatch":
        return list(fl.build_feature_files(maker, paths, strict=True,
                                           maxSizeSeq=3200).values())
    return [fl.build_feature_batch(maker, p, strict=True, maxSizeSeq=3200,
                                   batch_size=2) for p in paths]


@pytest.mark.parametrize("mode,source", [
    ("batched", "jax"), ("nobatch", "port"), ("separate", "jax")])
def test_clustering_quantization_matches_jax(clustering_runs, corpus,
                                             jax_checkpoint, tmp_path, mode,
                                             source):
    """Both packages quantize with one clustering run's checkpoint and
    `args.json` (the JAX package's, or the port's with its `device`)."""
    root, _item, paths, _phones = corpus
    ck = clustering_runs[source] / "checkpoint_last.pt"
    centroids = torch.load(ck, weights_only=False)["state_dict"]["Ck"][0]
    for feats in _quantized_features(jax_checkpoint, paths,
                                     "nobatch" if mode == "nobatch"
                                     else "batched"):
        assert _gap(feats, centroids.numpy()) > GAP
    flags = {"batched": [], "nobatch": ["--nobatch"],
             "separate": ["--separate-speaker"]}[mode]
    argv = [str(ck), str(root), None, "--file_extension", ".wav",
            "--max_size_seq", "3200", "--batch_size", "2",
            "--recursionLevel", "1"] + flags
    outputs = {}
    for side, main, extra in (("port", clustering_quantization.main,
                               ["--device", "cpu"]),
                              ("jax", jax_quant.main, [])):
        argv[2] = str(tmp_path / side)
        main(argv + extra)
        outputs[side] = {p.name: p.read_text() for p in
                         sorted((tmp_path / side).glob("*.txt"))}
    names = ({f"{s}_quantized_outputs.txt" for s in SPEAKERS}
             if mode == "separate" else {"quantized_outputs.txt"})
    assert set(outputs["port"]) == names
    assert outputs["port"] == outputs["jax"]
    lines = "\n".join(outputs["port"].values()).split("\n")
    assert len(lines) == len(paths)
    assert all("-" in line.split("\t")[1] for line in lines)


@pytest.fixture(scope="module")
def pair_vocabulary(tmp_path_factory):
    """Every pair of 4 units of the 2 groups, one token a line."""
    path = tmp_path_factory.mktemp("vocab") / "pairs.txt"
    path.write_text("".join(f"{a}-{b} 1\n" for a in range(4)
                            for b in range(4)))
    return path


@pytest.mark.parametrize("source", ["concat", "onehot", "quantized"])
def test_eval_abx_clustering_matches_jax(clustering_runs, corpus,
                                         pair_vocabulary, tmp_path, source):
    """`--clustering` (the units computed as the features are made, the 2
    groups side by side or as one token of the pair vocabulary) and
    `--quantized` (a quantization table of the port): the same scores."""
    root, item, paths, _phones = corpus
    ck = clustering_runs["jax"] / "checkpoint_last.pt"
    if source == "quantized":
        clustering_quantization.main([
            str(ck), str(root), str(tmp_path / "q"), "--file_extension",
            ".wav", "--max_size_seq", "64000", "--nobatch",
            "--recursionLevel", "1", "--device", "cpu"])
        flags = ["--quantized", str(tmp_path / "q" /
                                    "quantized_outputs.txt"),
                 "--onehot-dict", str(pair_vocabulary)]
    else:
        flags = ["--clustering", str(ck), "--group-modes", source]
        if source == "onehot":
            flags += ["--onehot-dict", str(pair_vocabulary)]
    argv = flags + ["--path_audio_data", str(root), "--path_abx_item",
                    str(item), "--file-extension", ".wav"]
    random.seed(1)
    got = eval_ABX_clustering.main(argv + [
        "--device", "cpu", "--name-output", str(tmp_path / "port.json")])
    random.seed(1)
    want = jax_abx_cl.main(argv + ["--name-output",
                                   str(tmp_path / "jax.json")])
    for mode in ("within", "across"):
        assert 0.0 <= got[mode] <= 1.0
        assert got[mode] == want[mode], (mode, got[mode], want[mode])
    saved = json.loads((tmp_path / "port.json").read_text())
    assert saved["args"]["modes"] == ["within", "across"]


@pytest.mark.parametrize("module,argv", [
    (clustering_script, ["ck.pt", "out", "db"]),
    (clustering_quantization, ["ck.pt", "db", "out"]),
    (eval_ABX_clustering, ["--quantized", "q.txt", "--path_audio_data",
                           "db", "--path_abx_item", "a.item"]),
])
def test_cuda_without_a_card_raises(module, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


def test_train_mode_raises(jax_checkpoint, corpus, clustering_runs,
                           tmp_path):
    """`--train_mode` (dropout on while the features are made) no longer
    raises: `clustering_script --train_mode` of both packages from the same
    start centroids (the LSTM model has no dropout, so the features are
    evaluation's) gives the same centroids, and `clustering_quantization`
    of either run, whose `args.json` carries `train_mode`, the same
    lines."""
    import jax
    root, _item, paths, _phones = corpus
    start = clustering_runs["port"].parent / "start.pt"
    argv = [str(jax_checkpoint), None, str(root), "--extension", ".wav",
            "--recursionLevel", "1", "--sizeWindow", "3200", "-n", "1",
            "-k", "4", "--load", str(start), "--train_mode"]
    for side, main, batch, extra in (
            ("port", clustering_script.main, len(jax.devices()),
             ["--device", "cpu"]),
            ("jax", jax_script.main, 1, [])):
        argv[1] = str(tmp_path / side)
        random.seed(0)
        np.random.seed(0)
        main(argv + ["--batchSizeGPU", str(batch)] + extra)
    got, want = (torch.load(tmp_path / side / "checkpoint_last.pt",
                            weights_only=False)["state_dict"]["Ck"]
                 for side in ("port", "jax"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    saved = json.loads((tmp_path / "port" / "args.json").read_text())
    assert saved["train_mode"] is True
    for feats in _quantized_features(jax_checkpoint, paths, "batched"):
        assert _gap(feats, got[0].numpy()) > GAP
    outputs = {}
    for side, main, extra in (("port", clustering_quantization.main,
                               ["--device", "cpu"]),
                              ("jax", jax_quant.main, [])):
        main([str(tmp_path / "port" / "checkpoint_last.pt"), str(root),
              str(tmp_path / f"q_{side}"), "--file_extension", ".wav",
              "--max_size_seq", "3200", "--batch_size", "2",
              "--recursionLevel", "1"] + extra)
        outputs[side] = (tmp_path / f"q_{side}" /
                         "quantized_outputs.txt").read_text()
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"].strip().split("\n")) == len(paths)
