"""What feature extraction lacked until now, held against the JAX package on
the CPU at a tiny width (16, the default one-layer transformer context
network over 3,200-sample windows, i.e. 20 frames):

* `FeatureModule(train_mode=True)`: at dropout 0 the port's features equal
  the JAX package's (the JAX transformer layers built at rate 0 for the
  test); at the recipe's 0.1, the JAX test's properties (two calls differ,
  a second instance with the same seed replays the first, the features
  differ from evaluation's), no parameter, buffer or module mode changes,
  and a `batchNorm` encoder is refused as the JAX package refuses it;
* `build_feature_files(bucket_frames=4)` over ragged lengths, the padded
  tail frames included, and `bucket_frames=0` unchanged;
* the CCA: `fit_cca` against scikit-learn's `CCA` on one draw,
  `research.train_cca.main` against the JAX package's on the same corpus
  and checkpoints, `FeatureModule(cca_projection=<the JAX package's
  pickle>)` against the JAX `FeatureModule` with it, the scikit-learn
  pickle read with every `sklearn` module blocked, and a pickle naming
  another class refused.

The dropout masks cannot equal the JAX package's draws (ROADMAP "Dropout
masks"), hence rate 0 for the comparison.

Tolerances: features rtol 1e-5, atol 1e-6 (fp32 reordering); the fit on
the same matrices as scikit-learn 1e-10 of each field's largest entry
(float64, another SVD); the end-to-end fit, whose features differ by fp32
reordering (1e-6), 1e-3 of each field's largest entry, and its
projections 1e-3 of their largest.
"""

import json
import pickle
import sys

import flax.errors
import numpy as np
import pytest
import torch

import cpc2_tpu.models.transformer as jax_transformer
from cpc2_tpu import feature_loader as jax_fl
from cpc2_tpu.config import get_default_cpc_config as jax_default_config
from cpc2_tpu.data.audio_io import save_wav
from cpc2_tpu.research import train_cca as jax_train_cca
from cpc2_torch import feature_loader as fl
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.models.transformer import FFNetwork
from cpc2_torch.research import cca, train_cca
from tests.test_feature_api import _write_ckpt

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
WIDTH = 16
WINDOW = 3200


def _args(**over):
    args = jax_default_config()
    args.hiddenEncoder = args.hiddenGar = WIDTH
    args.sizeWindow = WINDOW
    args.arMode = "transformer"
    args.load = None
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _port_model(bundle, args):
    import copy
    model = fl.build_model(copy.deepcopy(args))
    model.load_state_dict(state_dict_from_jax(bundle.variables["params"]))
    return model


@pytest.fixture(scope="module")
def transformer():
    """A JAX transformer-context model and the port's on its weights."""
    args = _args()
    bundle = jax_fl.init_model(args, seed=0)
    return bundle, _port_model(bundle, args), args


def _audio(seed=0, b=2, n=WINDOW):
    return np.random.RandomState(seed).randn(b, n).astype(np.float32)


def _set_rate(model, rate):
    for m in model.modules():
        if isinstance(m, FFNetwork):
            m.dropout = rate
        if hasattr(m, "drop"):
            m.drop.rate = rate


class _RateZeroLayer(jax_transformer.TransformerLayer):
    dropout: float = 0.0


def test_train_mode_at_rate_0_matches_jax(transformer, monkeypatch):
    """The JAX package's `train_mode` forward (train=True, a dropout key
    each call) with its transformer layers at rate 0, against the port's
    with its dropout modules at rate 0; and the port's equal to its own
    evaluation bit for bit."""
    bundle, model, args = transformer
    monkeypatch.setattr(jax_transformer, "TransformerLayer", _RateZeroLayer)
    data = (_audio(1), None)
    want = np.asarray(jax_fl.FeatureModule(
        jax_fl.init_model(args, seed=0), False, train_mode=True)(data))
    _set_rate(model, 0.0)
    try:
        got = fl.FeatureModule(model, False, train_mode=True)(data)
        evaluated = fl.FeatureModule(model, False)(data)
    finally:
        _set_rate(model, 0.1)
    assert got.shape == want.shape == (2, WINDOW // 160, WIDTH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, evaluated, rtol=0, atol=0)


def test_train_mode_keeps_dropout_active(transformer):
    """The JAX test's three properties at the recipe's rate (0.1), on both
    packages' features of the same audio."""
    bundle, model, _args_ = transformer
    data = (_audio(0), None)
    for package, maker in (("jax", lambda **kw: jax_fl.FeatureModule(
            bundle, False, **kw)), ("port", lambda **kw: fl.FeatureModule(
                model, False, **kw))):
        evaluated = np.asarray(maker()(data))
        train = maker(train_mode=True)
        first, second = np.asarray(train(data)), np.asarray(train(data))
        assert not np.allclose(first, second), package
        assert not np.allclose(first, evaluated), package
        np.testing.assert_array_equal(
            first, np.asarray(maker(train_mode=True)(data)), err_msg=package)
        other = np.asarray(maker(train_mode=True, train_mode_seed=1)(data))
        assert not np.allclose(first, other), package


def test_train_mode_changes_no_state(transformer):
    """Over three `train_mode` calls with the state carried, no parameter
    or buffer moves and every module keeps its (evaluation) mode."""
    _bundle, model, _args_ = transformer
    before = {k: v.clone() for k, v in model.state_dict().items()}
    modes = [m.training for m in model.modules()]
    maker = fl.FeatureModule(model, False, train_mode=True, keep_hidden=True)
    for seed in range(3):
        maker((_audio(seed), None))
    after = model.state_dict()
    assert before.keys() == after.keys()
    for key, value in before.items():
        torch.testing.assert_close(after[key], value, rtol=0, atol=0)
    assert [m.training for m in model.modules()] == modes
    assert not any(modes)


def test_train_mode_refuses_batch_norm():
    """A `batchNorm` encoder with `train_mode`: the JAX package's forward
    raises flax's error (its batch statistics are immutable there); the
    port refuses at construction with a `ValueError` naming the cause."""
    args = _args(normMode="batchNorm", arMode="LSTM")
    bundle = jax_fl.init_model(args, seed=0)
    with pytest.raises(flax.errors.ModifyScopeVariableError):
        jax_fl.FeatureModule(bundle, False, train_mode=True)(
            (_audio(0), None))
    model = fl.build_model(args)
    with pytest.raises(ValueError, match="batchNorm"):
        fl.FeatureModule(model, False, train_mode=True)
    # evaluation extraction of the same model stays available
    assert fl.FeatureModule(model, False)((_audio(0), None)).shape == (
        2, WINDOW // 160, WIDTH)


@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    """Five files of 58, 60, 40, 43 (and 70 samples) and 56 frames."""
    root = tmp_path_factory.mktemp("ragged")
    rs = np.random.RandomState(7)
    paths = []
    for i, n in enumerate([9280, 9600, 6400, 6950, 8960]):
        wav = (0.3 * np.sin(np.arange(n) * (0.01 + 0.002 * i))
               + 0.01 * rs.randn(n)).astype(np.float32)
        path = str(root / f"b{i}.wav")
        save_wav(path, wav, 16000)
        paths.append(path)
    return paths


@pytest.mark.parametrize("strict", [False, True])
def test_bucket_frames_matches_jax(ragged, strict):
    """`bucket_frames=4` pads 58 -> 60, 43 -> 44 and 56 -> 56 frames: the
    port's outputs, each cut to its file's own frames, equal the JAX
    package's, tail frames included (both read the same padding); with
    `bucket_frames=0` every file is `build_feature`'s."""
    args = _args(arMode="LSTM")
    bundle = jax_fl.init_model(args, seed=3)
    model = _port_model(bundle, args)
    port = fl.FeatureModule(model, False, keep_hidden=True)
    ref = jax_fl.FeatureModule(bundle, False, keep_hidden=True)
    got = fl.build_feature_files(port, ragged, maxSizeSeq=3200,
                                 strict=strict, max_batch=3,
                                 bucket_frames=4)
    want = jax_fl.build_feature_files(ref, ragged, maxSizeSeq=3200,
                                      strict=strict, max_batch=3,
                                      bucket_frames=4)
    plain = fl.build_feature_files(port, ragged, maxSizeSeq=3200,
                                   strict=strict, max_batch=3)
    assert sorted(got) == sorted(want) == sorted(ragged)
    for path, n in zip(ragged, [9280, 9600, 6400, 6950, 8960]):
        assert got[path].shape == (1, n // 160, WIDTH), path
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   err_msg=path, **TOL)
        one = fl.build_feature(port, path, maxSizeSeq=3200, strict=strict)
        np.testing.assert_array_equal(plain[path], one, err_msg=path)


def test_fit_cca_matches_sklearn():
    """`fit_cca` on the same float32 matrices as scikit-learn 1.9's `CCA`
    (float64 both): means, scales, rotations and the projection."""
    sklearn_cca = pytest.importorskip("sklearn.cross_decomposition")
    rs = np.random.RandomState(0)
    z = rs.randn(300, 5)
    x = (z @ rs.randn(5, 12) + 0.5 * rs.randn(300, 12)).astype(np.float32)
    y = (z @ rs.randn(5, 9) + 0.5 * rs.randn(300, 9)).astype(np.float32)
    want = sklearn_cca.CCA(n_components=4).fit(x, y)
    got = cca.fit_cca(x, y, 4)
    for mine, theirs in ((got.x_mean, want._x_mean),
                         (got.x_std, want._x_std),
                         (got.x_rotations, want.x_rotations_)):
        np.testing.assert_allclose(mine, theirs, rtol=0,
                                   atol=1e-10 * np.abs(theirs).max())
    np.testing.assert_allclose(got.transform(x), want.transform(x),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="upper bound is 9"):
        cca.fit_cca(x, y, 10)


@pytest.fixture(scope="module")
def cca_runs(tmp_path_factory):
    """`train_cca.main` of both packages: two 20-wide checkpoints (seeds 0
    and 1) over two files of 21,000 samples, 4 components, `--no_batch`."""
    pytest.importorskip("sklearn")
    tmp = tmp_path_factory.mktemp("cca")
    da, db_ = tmp / "a", tmp / "b"
    da.mkdir(), db_.mkdir()
    _write_ckpt(da, 20, seed=0)
    _write_ckpt(db_, 20, seed=1)
    audio = tmp / "audio"
    audio.mkdir()
    rs = np.random.RandomState(0)
    for i in range(2):
        x = (0.2 * np.sin(np.arange(21000) * (0.01 + 0.003 * i))
             + 0.01 * rs.randn(21000)).astype(np.float32)
        save_wav(str(audio / f"f{i}.wav"), x, 16000)
    argv = ["--path_cp_X", str(da / "checkpoint_3.pt"), "--path_cp_Y",
            str(db_ / "checkpoint_3.pt"), "--path_db", str(audio),
            "--n_components", "4", "--max_size_seq", "10240", "--no_batch"]
    jax_train_cca.main(argv + ["--path_output", str(tmp / "jax")])
    train_cca.main(argv + ["--path_output", str(tmp / "port"),
                           "--device", "cpu"])
    return tmp, da / "checkpoint_3.pt", audio


def _scaled(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * np.abs(want).max())


def test_train_cca_matches_jax(cca_runs):
    tmp, _ck, _audio_dir = cca_runs
    name = "cca_model_n_components_4.pkl"
    with open(tmp / "jax" / name, "rb") as f:
        want = pickle.load(f)
    with open(tmp / "port" / name, "rb") as f:
        got = pickle.load(f)
    assert isinstance(got, cca.CCAProjection)
    assert got.x_rotations.shape == want.x_rotations_.shape == (20, 4)
    _scaled(got.x_mean, want._x_mean, 1e-3)
    _scaled(got.x_std, want._x_std, 1e-3)
    _scaled(got.x_rotations, want.x_rotations_, 1e-3)
    probe = np.random.RandomState(5).randn(7, 20)
    _scaled(got.transform(probe), want.transform(probe), 1e-3)
    saved = json.loads((tmp / "port" / "CCA_info_args.json").read_text())
    assert saved["n_components"] == 4 and saved["device"] == "cpu"


def test_cca_projection_of_a_jax_pickle(cca_runs):
    """The port's `FeatureModule` with the JAX package's scikit-learn
    pickle against the JAX `FeatureModule` with it; the port's own pickle
    gives its own fit's projection."""
    tmp, ck, audio_dir = cca_runs
    pkl = str(tmp / "jax" / "cca_model_n_components_4.pkl")
    data = (_audio(2, n=4160), None)
    want = np.asarray(jax_fl.FeatureModule(
        jax_fl.load_model([str(ck)])[0], False, cca_projection=pkl)(data))
    model = fl.load_model([str(ck)])[0]
    got = fl.FeatureModule(model, False, cca_projection=pkl)(data)
    assert got.shape == want.shape == (2, 26, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    own = str(tmp / "port" / "cca_model_n_components_4.pkl")
    plain = fl.FeatureModule(model, False)(data)
    projected = fl.FeatureModule(model, False, cca_projection=own)(data)
    np.testing.assert_allclose(
        projected.numpy().reshape(-1, 4),
        cca.load_cca(own).transform(plain.numpy().reshape(-1, 20)), **TOL)


def test_sklearn_pickle_read_without_sklearn(cca_runs, monkeypatch):
    tmp, _ck, _audio_dir = cca_runs
    with open(tmp / "jax" / "cca_model_n_components_4.pkl", "rb") as f:
        want = pickle.load(f)
    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    got = cca.load_cca(str(tmp / "jax" / "cca_model_n_components_4.pkl"))
    np.testing.assert_array_equal(got.x_mean, want._x_mean)
    np.testing.assert_array_equal(got.x_std, want._x_std)
    np.testing.assert_array_equal(got.x_rotations, want.x_rotations_)
    with pytest.raises(ImportError):
        import sklearn  # noqa: F401


class _Other:
    def __init__(self):
        self.x_rotations_ = np.eye(3)


def test_a_pickle_of_another_class_is_refused(tmp_path):
    bad = tmp_path / "other.pkl"
    with open(bad, "wb") as f:
        pickle.dump(_Other(), f)
    with pytest.raises(pickle.UnpicklingError, match="_Other"):
        cca.load_cca(str(bad))
    with open(tmp_path / "os.pkl", "wb") as f:
        pickle.dump(np.random.RandomState(0), f)
    with pytest.raises(pickle.UnpicklingError):
        cca.load_cca(str(tmp_path / "os.pkl"))
    with pytest.raises(ValueError, match=r"\.pkl"):
        fl.FeatureModule(torch.nn.Linear(1, 1), False,
                         cca_projection=str(tmp_path / "x.pt"))
