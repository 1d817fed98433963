"""The port's host augmentation (`cpc2_torch/data/augmentation.py`) and its
place in the loader and the trainer.

Every augmenter draws from the generators it is given; the JAX package's
draw from the global streams. A legacy `RandomState(s)` draws what
`np.random.seed(s)` followed by the same calls draws, so each augmenter is
held bit for bit to `cpc2_tpu.data.augmentation` on the same seed, alone,
in the factory's chains and inside `AudioBatchData.get_batch`; and to the
committed oracles (`tests/fixtures/augment_oracles.npz`) as
`tests/test_augment_fixtures.py` holds the JAX package's. The trainer runs
host, device and hybrid chains on a synthesised corpus with a noise corpus
and a directory of impulse responses, with equal losses whatever
`--host_prefetch`, a resumed augmented run equal to an uninterrupted one,
and validation unaugmented.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from cpc2_tpu.data import augmentation as ha
from cpc2_tpu.data.dataset import AudioBatchData as JaxAudioBatchData
from cpc2_torch.config import parse_args
from cpc2_torch.data import AudioBatchData, find_all_seqs
from cpc2_torch.data import augmentation as pa
from cpc2_torch.data.audio_io import save_wav
from cpc2_torch.train import main

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), 'fixtures',
                   'augment_oracles.npz')


def _window(w, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(w) / 16000.0
    x = (0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
         + 0.05 * rs.randn(w))
    return x.astype(np.float32)[None, :]


def _same(jax_aug, port_aug, xs, seed):
    """Each window through the JAX augmenter under np.random.seed(seed)
    and through the port's drawing from RandomState(seed): equal arrays."""
    np.random.seed(seed)
    want = [jax_aug(x) for x in xs]
    got = [port_aug(x) for x in xs]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,make_jax,make_port", [
    ("bandreject", lambda: ha.BandrejectAugment(),
     lambda r: pa.BandrejectAugment(r)),
    ("bandreject_scaled", lambda: ha.BandrejectAugment(scaler=3.0),
     lambda r: pa.BandrejectAugment(r, scaler=3.0)),
    ("pitch_wsola", lambda: ha.PitchAugment(),
     lambda r: pa.PitchAugment(r)),
    ("pitch_vocoder", lambda: ha.PitchAugment(algo='vocoder'),
     lambda r: pa.PitchAugment(r, algo='vocoder')),
    ("pitch_quick", lambda: ha.PitchAugment(quick=True, algo='vocoder'),
     lambda r: pa.PitchAugment(r, quick=True, algo='vocoder')),
    ("reverb", lambda: ha.ReverbAugment(), lambda r: pa.ReverbAugment(r)),
    ("time_dropout", lambda: ha.TimeDropoutAugment(50),
     lambda r: pa.TimeDropoutAugment(r, 50)),
    ("reverb_dropout", lambda: ha.ReverbDropout(),
     lambda r: pa.ReverbDropout(r)),
    ("pitch_dropout", lambda: ha.PitchDropout(),
     lambda r: pa.PitchDropout(r)),
    ("pitch_dropout_vocoder", lambda: ha.PitchDropout(algo='vocoder'),
     lambda r: pa.PitchDropout(r, algo='vocoder')),
    ("random_noise", lambda: ha.RandomAdditiveNoiseAugment(7.0),
     lambda r: pa.RandomAdditiveNoiseAugment(r, 7.0)),
])
def test_augmenter_bit_for_bit(name, make_jax, make_port):
    w = 2048 if "reverb" in name else 8192
    xs = [_window(w, seed) for seed in range(3)]
    _same(make_jax(), make_port(np.random.RandomState(11)), xs, 11)


@pytest.fixture(scope="module")
def sounds(tmp_path_factory):
    """A noise corpus (one folder of white noise) and a directory of
    impulse responses."""
    root = tmp_path_factory.mktemp("sounds")
    rs = np.random.RandomState(7)
    (root / "noise" / "n").mkdir(parents=True)
    for i in range(2):
        save_wav(str(root / "noise" / "n" / f"n{i}.wav"),
                 (0.1 * rs.randn(14000)).astype(np.float32), 16000)
    (root / "irs").mkdir()
    for i in range(3):
        ir = np.zeros(700, np.float32)
        ir[0], ir[150 + 200 * i], ir[600] = 1.0, 0.5, 0.2
        save_wav(str(root / "irs" / f"ir{i}.wav"), ir, 16000)
    return root


def _noise_datasets(root, w):
    """The JAX package's and the port's AudioBatchData on the same noise
    files, built under the same seed."""
    seqs, _ = find_all_seqs(str(root), extension=".wav", speaker_level=0)
    random.seed(3)
    jax_ds = JaxAudioBatchData(str(root), w, seqs, None, 1, nProcessLoader=1)
    random.seed(3)
    port_ds = AudioBatchData(str(root), w, seqs, None, 1, nProcessLoader=1)
    return jax_ds, port_ds


def test_additive_noise_bit_for_bit(sounds):
    """The noise windows come from each package's noise loader (its
    sampler draws from the global streams in both) and the SNRs from the
    augmenter's generator."""
    w = 2048
    jax_ds, port_ds = _noise_datasets(sounds / "noise", w)
    try:
        np.random.seed(5)
        random.seed(5)
        jax_aug = ha.AdditiveNoiseAugment(jax_ds, 2.0, 12.0, 3)
        np.random.seed(5)
        random.seed(5)
        port_aug = pa.AdditiveNoiseAugment(np.random.RandomState(9),
                                           port_ds, 2.0, 12.0, 3)
        xs = [_window(w, seed) for seed in range(7)]
        np.random.seed(9)
        want = [jax_aug(x) for x in xs]
        got = [port_aug(x) for x in xs]
        for g, v in zip(got, want):
            np.testing.assert_array_equal(g, v)
    finally:
        port_ds.close()


@pytest.mark.parametrize("batch_wise", [False, True])
def test_natural_reverb_bit_for_bit(sounds, batch_wise):
    """The file choice from a `random.Random`, as the JAX package's from
    the global `random` on the same seed."""
    ir_dir = str(sounds / "irs")
    random.seed(4)
    np.random.seed(4)
    jax_aug = ha.NaturalReverb(ir_dir, 0.7, 2, batch_wise=batch_wise)
    xs = [_window(2048, seed) for seed in range(5)]
    want = [jax_aug(x) for x in xs]
    port_aug = pa.NaturalReverb(np.random.RandomState(4), random.Random(4),
                                ir_dir, 0.7, 2, batch_wise=batch_wise)
    got = [port_aug(x) for x in xs]
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g, v)


def _args(types, **kw):
    from cpc2_tpu.config import get_default_cpc_config
    args = get_default_cpc_config()
    args.augment_type = types
    args.augment_past = True
    args.nGPU, args.batchSizeGPU = 1, 2
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("types", [
    ['bandreject', 'pitch'], ['pitch_quick'], ['pitch', 'pitch_quick'],
    ['pitch_deropout', 'time_dropout'], ['none', 'bandreject', 'pitch'],
    ['time_dropout', 'natural_reverb', 'additive'],
])
def test_factory_chain_bit_for_bit(sounds, types):
    """`augmentation_factory`'s chains (the quick contagion, both
    spellings of pitch_dropout, 'none' entries) draw in the same order as
    the JAX package's, one window after another; the port is given the
    batch size the JAX package computes from --nGPU."""
    w = 2048
    args = _args(types, pathImpulseResponses=str(sounds / "irs"),
                 pitch_algo='vocoder' if 'pitch_quick' in types else 'wsola')
    jax_ds, port_ds = _noise_datasets(sounds / "noise", w)
    try:
        for seed in (1, 2):
            random.seed(seed)
            np.random.seed(seed)
            jax_aug = ha.augmentation_factory(args, jax_ds)
            random.seed(seed)
            np.random.seed(seed)
            port_aug = pa.augmentation_factory(
                args, port_ds, batch_size=2,
                rng=np.random.RandomState(seed),
                choice_rng=random.Random(seed))
            assert type(port_aug).__name__ == type(jax_aug).__name__
            xs = [_window(w, s) for s in range(4)]
            np.random.seed(seed)
            random.seed(seed)
            want = [jax_aug(x) for x in xs]
            got = [port_aug(x) for x in xs]
            for g, v in zip(got, want):
                np.testing.assert_array_equal(g, v)
    finally:
        port_ds.close()


def test_factory_vocabulary_and_errors():
    gens = dict(batch_size=2, rng=np.random.RandomState(0),
                choice_rng=random.Random(0))
    assert pa.augmentation_factory(_args(['none']), **gens) is None
    assert pa.augmentation_factory(_args(['pitch'], augment_past=False),
                                   **gens) is None
    aug = pa.augmentation_factory(_args(['pitch_quick']), **gens)
    assert isinstance(aug, pa.PitchAugment) and aug.quick
    for spelling in ('pitch_dropout', 'pitch_deropout'):
        assert isinstance(pa.augmentation_factory(_args([spelling]), **gens),
                          pa.PitchDropout)
    with pytest.raises(RuntimeError, match="Noise dataset"):
        pa.augmentation_factory(_args(['additive']), **gens)
    with pytest.raises(RuntimeError, match="Noise dataset"):
        pa.augmentation_factory(_args(['bandreject', 'additive']), **gens)
    # meta augmentation reads --meta_aug_type and --meta_ir_batch_wise
    meta = pa.augmentation_factory(
        _args(['pitch'], meta_aug_type=['none']), applied_on_noise=True,
        **gens)
    assert meta is None


@pytest.fixture(scope="module")
def oracles():
    return np.load(FIX)


@pytest.mark.parametrize("band", [0, 1, 2])
def test_bandstop_oracle(oracles, band):
    """The port's band-reject path on a pinned band: the committed
    Kaiser-sinc oracle within 5e-6."""
    lo = float(oracles[f'band_{band}_lo'])
    hi = float(oracles[f'band_{band}_hi'])
    for name in ('tone', 'harmonic', 'speechy'):
        x = oracles[f'in_{name}'].astype(np.float64)[None]
        aug = pa.BandrejectAugment(np.random.RandomState(0), numtaps=1021)
        aug.generate_freq_mask = lambda scaler, rng: (lo, hi)
        np.testing.assert_allclose(aug(x)[0], oracles[
            f'bandstop_{band}_{name}'], atol=5e-6)


@pytest.mark.parametrize("room_i", [0, 1, 2])
def test_freeverb_oracle(oracles, room_i):
    """The port's `_freeverb` at reverberance 100 and 50: the committed
    direct-form oracle within 1e-5."""
    x = oracles['in_harmonic'].astype(np.float64)
    room = float(oracles[f'room_{room_i}'])
    np.testing.assert_allclose(pa._freeverb(x, 100.0, 100.0, room),
                               oracles[f'freeverb_{room_i}_harmonic'],
                               atol=1e-5)
    np.testing.assert_allclose(pa._freeverb(x, 50.0, 50.0, room),
                               oracles[f'freeverb50_{room_i}_harmonic'],
                               atol=1e-5)


@pytest.mark.parametrize("ci", [0, 1, 2, 3])
def test_wsola_oracle(oracles, ci):
    """The port's WSOLA pitch shift: the committed sox-family oracle
    within 5e-3 of its peak (the JAX package's tolerance)."""
    cents = float(oracles[f'cents_{ci}'])
    for name in ('tone', 'speechy'):
        x = oracles[f'in_{name}'].astype(np.float64)[None]
        got = pa.pitch_shift(x, cents, algo='wsola')[0]
        ref = oracles[f'wsola_{ci}_{name}']
        assert np.abs(got - ref).max() < 5e-3 * np.abs(ref).max()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 speakers x 2 files of WAV in LibriSpeech layout."""
    root = tmp_path_factory.mktemp("aug_db")
    rs = np.random.RandomState(3)
    for s in range(3):
        folder = root / str(500 + s) / "2"
        folder.mkdir(parents=True)
        for i in range(2):
            n = 26000 + 3000 * i
            t = np.arange(n) / 16000
            x = (0.3 * np.sin(2 * np.pi * (90 + 40 * s) * t)
                 + 0.05 * rs.randn(n)).astype(np.float32)
            save_wav(str(folder / f"{500 + s}-2-{i}.wav"), x, 16000)
    return root


@pytest.mark.parametrize("equal", [False, True])
def test_get_batch_bit_for_bit(corpus, equal):
    """`AudioBatchData.get_batch` with a chain on both views (the past
    views' draws before the future views'), or the same draws on both
    with `past_equal_future`: the JAX package's batch."""
    seqs, speakers = find_all_seqs(str(corpus), extension=".wav")
    gens = dict(batch_size=4, rng=np.random.RandomState(6),
                choice_rng=random.Random(6))
    args = _args(['bandreject', 'pitch', 'time_dropout'],
                 augment_future=True)
    flags = dict(augment_past=True, augment_future=True,
                 past_equal_future=equal)
    random.seed(0)
    jax_ds = JaxAudioBatchData(str(corpus), 3840, seqs, None, len(speakers),
                               nProcessLoader=1,
                               augmentation=ha.augmentation_factory(args),
                               **flags)
    random.seed(0)
    port_ds = AudioBatchData(str(corpus), 3840, seqs, None, len(speakers),
                             nProcessLoader=1,
                             augmentation=pa.augmentation_factory(
                                 args, **gens), **flags)
    try:
        idx = [0, 5000, 17000, 40000]
        np.random.seed(6)
        want, want_spk = jax_ds.get_batch(idx)
        got, got_spk = port_ds.get_batch(idx)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_spk, want_spk)
        assert got.shape == (4, 2, 1, 3840) and got.dtype == np.float32
        assert equal == np.array_equal(got[:, 0], got[:, 1])
    finally:
        port_ds.close()
    with pytest.raises(ValueError, match="augment_past = False"):
        AudioBatchData(str(corpus), 3840, seqs, None, len(speakers),
                       past_equal_future=True)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--hiddenEncoder", "16", "--hiddenGar", "16",
         "--nPredicts", "3", "--negativeSamplingExt", "4",
         "--sizeWindow", "3840", "--batchSizeGPU", "4", "--random_seed",
         "5", "--logging_step", "50", "--n_process_loader", "1",
         "--file_extension", ".wav"]
AUG = ["--augment_past", "--augment_future"]


def _run(corpus, sounds, ck, *extra):
    return main(["--pathDB", str(corpus), "--pathCheckpoint", str(ck),
                 "--pathDBNoise", str(sounds / "noise"),
                 "--pathImpulseResponses", str(sounds / "irs"),
                 *SMALL, *extra])


def _losses(record):
    return np.asarray(record["logs"]["locLoss_train"])


@pytest.mark.parametrize("types,on_device", [
    (["bandreject", "pitch", "additive", "natural_reverb"], False),
    (["bandreject", "pitch", "artificial_reverb_dropout", "additive",
      "natural_reverb"], True),
])
def test_train_main_augmented(corpus, sounds, tmp_path, types, on_device):
    """`main` with a host chain, and with the same types on the device:
    finite losses, and the trainer's record of the loader's waits."""
    extra = AUG + ["--nEpoch", "1", "--augment_type", *types]
    if on_device:
        extra.append("--augment_on_device")
    record = _run(corpus, sounds, tmp_path / "ck", *extra)
    for key in ("locLoss_train", "locLoss_val"):
        values = np.asarray(record["logs"][key])
        assert values.shape == (1, 3) and np.isfinite(values).all(), key
    assert len(record["wait_ms"]) == len(record["step_ms"]) \
        == len(record["load_ms"]) == record["logs"]["iter"][0] > 2
    assert record["median_wait_ms"] >= 0 and record["median_load_ms"] > 0
    assert 0 < record["audio_hours_per_hour_with_waits"] \
        <= record["audio_hours_per_hour"] * 1.5


def test_hybrid_chain(corpus, sounds, tmp_path, monkeypatch):
    """A type with no device version stays on the host, ahead of the
    device types (exercised by taking one out of DEVICE_AUGMENTATIONS);
    a device type listed before a host type raises."""
    from cpc2_torch.data import augment_device
    monkeypatch.setattr(augment_device, 'DEVICE_AUGMENTATIONS', tuple(
        t for t in augment_device.DEVICE_AUGMENTATIONS if t != 'pitch'))
    record = _run(corpus, sounds, tmp_path / "ck", *AUG, "--nEpoch", "1",
                  "--augment_on_device", "--augment_type", "pitch",
                  "time_dropout", "bandreject")
    assert np.isfinite(_losses(record)).all()
    with pytest.raises(ValueError, match="reorder"):
        _run(corpus, sounds, tmp_path / "ck2", *AUG, "--nEpoch", "1",
             "--augment_on_device", "--augment_type", "time_dropout",
             "pitch")


HOST_CHAIN = AUG + ["--augment_type", "bandreject", "pitch", "additive",
                    "natural_reverb"]


def test_prefetch_changes_no_draw(corpus, sounds, tmp_path):
    """The loader on a thread two batches ahead, or between the steps:
    the same batches, the same losses."""
    runs = [_run(corpus, sounds, tmp_path / f"ck{depth}", *HOST_CHAIN,
                 "--nEpoch", "1", "--host_prefetch", str(depth))
            for depth in (0, 2)]
    np.testing.assert_array_equal(_losses(runs[0]), _losses(runs[1]))
    np.testing.assert_array_equal(
        np.asarray(runs[0]["logs"]["locLoss_val"]),
        np.asarray(runs[1]["logs"]["locLoss_val"]))


@pytest.mark.parametrize("device_chain", [False, True])
def test_augmented_resume_replays(corpus, sounds, tmp_path, device_chain):
    """Two augmented epochs in one run equal one epoch resumed to two, bit
    for bit: the augmentations' generators are reseeded at each epoch and
    the noise loader and batch-wise response start again."""
    extra = HOST_CHAIN + ["--ir_batch_wise"]
    if device_chain:
        extra.append("--augment_on_device")
    whole = _run(corpus, sounds, tmp_path / "whole", *extra, "--nEpoch", "2")
    _run(corpus, sounds, tmp_path / "split", *extra, "--nEpoch", "1")
    resumed = main(["--pathCheckpoint", str(tmp_path / "split"),
                    "--nEpoch", "2", "--device", "cpu"])
    np.testing.assert_array_equal(_losses(whole), _losses(resumed))
    a = torch.load(tmp_path / "whole" / "checkpoint_1.pt", weights_only=True)
    b = torch.load(tmp_path / "split" / "checkpoint_1.pt", weights_only=True)
    for key, value in a["gEncoder"].items():
        assert torch.equal(value, b["gEncoder"][key]), key


def test_validation_is_unaugmented(corpus, sounds, tmp_path, monkeypatch):
    """The validation pass sees the corpus's windows as they are: its
    losses are those of a run without augmentation, given the same
    weights."""
    import cpc2_torch.train as train_mod
    seen = []
    real = train_mod.val_epoch

    def spy(trainer, loader, device, *rest):
        for batch, _speaker in loader:
            seen.append(batch)
        return real(trainer, loader, device, *rest)

    monkeypatch.setattr(train_mod, "val_epoch", spy)
    _run(corpus, sounds, tmp_path / "ck", *HOST_CHAIN, "--nEpoch", "1")
    assert seen
    for batch in seen:
        # both views the same window, which lies in the corpus as read
        np.testing.assert_array_equal(batch[:, 0], batch[:, 1])
        assert np.abs(batch).max() < 0.6


def test_meta_aug_flags():
    """`--meta_aug` needs a real `--meta_aug_type`, and the type needs the
    flag, as `cpc2_tpu.train.parse_args` checks them."""
    base = ["--pathDB", "db"]
    with pytest.raises(ValueError, match="haven't"):
        parse_args(base + ["--meta_aug"])
    with pytest.raises(ValueError, match="haven't"):
        parse_args(base + ["--meta_aug", "--meta_aug_type", "none"])
    with pytest.raises(ValueError, match="without"):
        parse_args(base + ["--meta_aug_type", "natural_reverb"])
    args = parse_args(base + ["--meta_aug", "--meta_aug_type",
                              "natural_reverb"])
    assert args.meta_aug and args.meta_aug_type == ["natural_reverb"]


def test_meta_aug_on_the_noise_corpus(corpus, sounds, tmp_path):
    """`--meta_aug --meta_aug_type natural_reverb` reverberates the noise
    corpus's windows before they are mixed in."""
    record = _run(corpus, sounds, tmp_path / "ck", *AUG, "--nEpoch", "1",
                  "--augment_type", "additive", "--meta_aug",
                  "--meta_aug_type", "natural_reverb",
                  "--meta_ir_batch_wise")
    assert np.isfinite(_losses(record)).all()
    with open(tmp_path / "ck" / "checkpoint_args.json") as fh:
        saved = json.load(fh)
    assert saved["meta_aug"] and saved["meta_aug_type"] == ["natural_reverb"]
