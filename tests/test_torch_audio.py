"""The port's audio IO against the JAX package's on the CPU: FLAC through
the port's copy of the native decoder, mp3 through its copy of the FFmpeg
shim, both built with `g++` by `cpc2_torch/ops/_build.py:build_host`, and a
FLAC corpus through both packages' `AudioBatchData`.

Tolerance: none. Both packages decode the same bytes with the same C++ and
the same numpy downmix, so every array, sample rate and frame count must be
equal.
"""

import random

import numpy as np
import pytest

from cpc2_torch.data import audio_io
from cpc2_torch.data import AudioBatchData, find_all_seqs
from cpc2_torch.ops import _build
from cpc2_tpu.data import audio_io as jax_audio_io
from cpc2_tpu.data.corpus import find_all_seqs as jax_find_all_seqs
from cpc2_tpu.data.dataset import AudioBatchData as JaxAudioBatchData
from tests.test_audiodec import _MONO_FRAME, _STEREO_FRAME, _write_mp3
from tests.test_flac import encode_flac


def _pcm(seed, n, scale=3000):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.int16)


def _tone(n):
    t = np.arange(n)
    return (3000 * np.sin(2 * np.pi * 220 * t / 16000)).astype(np.int16)


# name -> (channels, encode_flac options): the subframe types of
# `tests/test_flac.py`'s encoder, mono and stereo, a ragged last block
# (1,024 + 1,024 + 452) and a stream without its total in STREAMINFO
FLAC_CASES = {
    "verbatim_mono": (lambda: [_pcm(0, 5000)], dict(subframe="verbatim")),
    "fixed1_mono": (lambda: [_tone(7000)], dict(subframe="fixed1")),
    "constant_mono": (lambda: [np.full(4096, -123, np.int16)],
                      dict(subframe="constant")),
    "verbatim_stereo": (lambda: [_pcm(1, 3000, 2000), _pcm(2, 3000, 2000)],
                        dict(subframe="verbatim")),
    "fixed1_stereo": (lambda: [_tone(4100), _pcm(3, 4100, 500)],
                      dict(subframe="fixed1")),
    "ragged_tail": (lambda: [_pcm(4, 2500, 1000)],
                    dict(subframe="verbatim")),
    "no_total": (lambda: [_tone(2048)], dict(total_in_streaminfo=False)),
}


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_matches_jax(tmp_path, case):
    make, options = FLAC_CASES[case]
    channels = make()
    path = str(tmp_path / f"{case}.flac")
    encode_flac(path, channels, **options)
    got, sr = audio_io.load_audio(path)
    want, want_sr = jax_audio_io.load_audio(path)
    assert got.dtype == np.float32 and sr == want_sr == 16000
    np.testing.assert_array_equal(got, want)
    # and the samples it was written from, mono-averaged
    np.testing.assert_array_equal(
        got, np.stack(channels, 1).astype(np.float32).mean(1) / 32768.0)
    assert audio_io.audio_info(path) == jax_audio_io.audio_info(path) == (
        len(channels[0]), 16000)


def test_flac_garbage_raises(tmp_path):
    path = tmp_path / "junk.flac"
    path.write_bytes(b"not a flac stream" * 8)
    with pytest.raises(audio_io.AudioFormatError):
        audio_io.load_audio(str(path))


def test_host_build_is_cached_and_raises_with_compiler_output(tmp_path,
                                                              monkeypatch):
    """A built library newer than its source is not rebuilt; a source that
    does not compile raises with g++'s message instead of passing."""
    built = _build.build_host("flacdec")
    stamp = built.stat().st_mtime_ns
    assert _build.build_host("flacdec") == built
    assert built.stat().st_mtime_ns == stamp
    (tmp_path / "flacdec.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(_build, "HOST_CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="error"):
        _build.build_host("flacdec")
    assert not list((tmp_path / "out").glob("*.so"))


def test_wav_and_save_dispatch(tmp_path):
    x = np.clip(np.random.RandomState(5).randn(3000) * 0.2, -1, 1)
    audio_io.save_audio(str(tmp_path / "a.wav"), x.astype(np.float32), 16000)
    got, sr = audio_io.load_audio(str(tmp_path / "a.wav"))
    want, _ = jax_audio_io.load_audio(str(tmp_path / "a.wav"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(audio_io.AudioFormatError, match="WAV"):
        audio_io.save_audio(str(tmp_path / "a.flac"), x, 16000)


def test_compressed_without_ffmpeg_headers_raises(tmp_path, monkeypatch):
    """Where the shim cannot be built, the JAX package's help text."""
    monkeypatch.setattr(_build, "host_buildable", lambda name: False)
    path = str(tmp_path / "a.mp3")
    _write_mp3(path, _MONO_FRAME, 4)
    for fn in (audio_io.load_audio, audio_io.audio_info):
        with pytest.raises(audio_io.AudioFormatError,
                           match="Convert first") as err:
            fn(path)
        assert jax_audio_io._MP3_HELP in str(err.value)


needs_shim = pytest.mark.skipif(
    not audio_io.compressed_available()
    or jax_audio_io._get_audec_lib() is None,
    reason="FFmpeg dev libraries not available; audiodec shim not built")


@needs_shim
@pytest.mark.parametrize("frame,n_frames", [(_MONO_FRAME, 50),
                                            (_STEREO_FRAME, 20)])
def test_silent_mp3_matches_jax(tmp_path, frame, n_frames):
    """Silent MPEG-2 Layer III frames: 576 samples a frame at 16 kHz."""
    path = str(tmp_path / "silence.mp3")
    _write_mp3(path, frame, n_frames)
    got, sr = audio_io.load_audio(path)
    want, want_sr = jax_audio_io.load_audio(path)
    assert got.shape == (576 * n_frames,) and sr == want_sr == 16000
    np.testing.assert_array_equal(got, want)
    assert audio_io.audio_info(path) == jax_audio_io.audio_info(path)


@needs_shim
@pytest.mark.parametrize("stereo", [False, True])
def test_wav_through_the_shim_matches_jax(tmp_path, stereo):
    shape = (5000, 2) if stereo else (12345,)
    x = np.clip(np.random.RandomState(7).randn(*shape) * 0.2, -1, 1)
    path = str(tmp_path / "tone.wav")
    audio_io.save_wav(path, x.astype(np.float32), 16000)
    got, sr = audio_io.load_compressed(path)
    want, want_sr = jax_audio_io.load_compressed(path)
    assert sr == want_sr == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, audio_io.load_wav(path)[0], atol=1e-7)


@needs_shim
def test_compressed_errors_raise(tmp_path):
    junk = tmp_path / "junk.mp3"
    junk.write_bytes(b"this is not an mpeg stream at all" * 10)
    for path in (junk, tmp_path / "missing.mp3"):
        with pytest.raises(audio_io.AudioFormatError):
            audio_io.load_compressed(str(path))


@pytest.fixture(scope="module")
def flac_corpus(tmp_path_factory):
    """3 speakers x 2 FLAC files in LibriSpeech layout, stereo for the
    last speaker."""
    root = tmp_path_factory.mktemp("flac_db")
    rs = np.random.RandomState(9)
    for s in range(3):
        folder = root / str(200 + s) / "11"
        folder.mkdir(parents=True)
        for i in range(2):
            n = 20000 + 3000 * i + 500 * s
            t = np.arange(n) / 16000
            x = 0.3 * np.sin(2 * np.pi * (90 + 40 * s) * t) \
                + 0.05 * rs.randn(n)
            pcm = np.clip(np.round(x * 32767), -32768, 32767).astype(
                np.int16)
            encode_flac(str(folder / f"{200 + s}-11-{i}.flac"),
                        [pcm, pcm[::-1].copy()] if s == 2 else [pcm])
    return root


def test_flac_corpus_batches_match_jax(flac_corpus):
    """The same corpus, split and seeds through both packages' loaders:
    equal batches and speakers, batch by batch."""
    seqs, speakers = find_all_seqs(str(flac_corpus), extension=".flac")
    jax_seqs, jax_speakers = jax_find_all_seqs(str(flac_corpus),
                                               extension=".flac")
    assert seqs == jax_seqs and speakers == jax_speakers
    port = AudioBatchData(str(flac_corpus), 3840, seqs, None,
                          len(speakers), nProcessLoader=2)
    ref = JaxAudioBatchData(str(flac_corpus), 3840, jax_seqs, None,
                            len(jax_speakers), nProcessLoader=2)
    try:
        loaders = []
        for dataset in (port, ref):
            random.seed(3)
            np.random.seed(3)
            loaders.append(list(dataset.getDataLoader(4, "samespeaker",
                                                      True)))
        got, want = loaders
        assert len(got) == len(want) > 2
        for (batch, spk), (ref_batch, ref_spk, *_rest) in zip(got, want):
            np.testing.assert_array_equal(np.asarray(batch),
                                          np.asarray(ref_batch))
            np.testing.assert_array_equal(np.asarray(spk),
                                          np.asarray(ref_spk))
    finally:
        port.close()
        if hasattr(ref, "close"):
            ref.close()
