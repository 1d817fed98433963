"""The port's device augmentation (`cpc2_torch/data/augment_device.py`) on
the CPU: each apply, at given parameters, against the JAX package's inner
functions (`cpc2_tpu.data.augment_device`) and against the host pipeline
(`cpc2_tpu.data.augmentation`), at the JAX package's own tolerances
(`tests/test_augment_device.py`, `tests/test_augment_fixtures.py`); the
WSOLA stretch with the host's segment positions; the draws' ranges; and the
factory's vocabulary, errors and quick contagion."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from cpc2_tpu.data import augment_device as jd
from cpc2_tpu.data import augmentation as ha
from cpc2_torch.data import augment_device as td
from cpc2_torch.data.audio_io import save_wav

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), 'fixtures',
                   'augment_oracles.npz')


def _tone(freq, w=20480, sr=16000.0, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(w) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)
            + 0.01 * rs.randn(w)).astype(np.float32)


def _t(*arrays):
    return torch.from_numpy(np.stack(arrays))


@pytest.fixture(scope="module")
def oracles():
    return np.load(FIX)


def _gen(seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


# --- band-reject ----------------------------------------------------------

def test_bandstop_taps_match_firwin_and_jax():
    bands = [(400.0, 900.0), (1500.0, 3200.0), (60.0, 120.0)]
    lo = torch.tensor([b[0] for b in bands])
    hi = torch.tensor([b[1] for b in bands])
    got = td._bandstop_taps(lo, hi).numpy()
    for row, (l, h) in zip(got, bands):
        ref = sps.firwin(td._BR_TAPS, [l, h], fs=16000,
                         window=('kaiser', 12.0), pass_zero='bandstop')
        np.testing.assert_allclose(row, ref, atol=2e-6)
        np.testing.assert_allclose(row, np.asarray(jd._bandstop_taps(
            jnp.float32(l), jnp.float32(h))), atol=2e-6)


@pytest.mark.parametrize("band", [0, 1, 2])
def test_bandreject_apply_matches_host_and_oracle(oracles, band):
    """The band-stop by FFT: the host's `fftconvolve(..., 'same')` with
    the same taps within 2e-4, the committed oracle within 5e-4."""
    x = oracles['in_harmonic']
    lo = float(oracles[f'band_{band}_lo'])
    hi = float(oracles[f'band_{band}_hi'])
    got = td.bandreject_apply(_t(x), torch.tensor([lo]),
                              torch.tensor([hi]))[0].numpy()
    taps = sps.firwin(td._BR_TAPS, [lo, hi], fs=16000,
                      window=('kaiser', 12.0), pass_zero='bandstop')
    ref = sps.fftconvolve(x[None], taps[None, :], mode='same')[0]
    np.testing.assert_allclose(got, ref, atol=2e-4)
    np.testing.assert_allclose(got, oracles[f'bandstop_{band}_harmonic'],
                               atol=5e-4)


def test_bandreject_draw_and_degenerate_band():
    lo, hi = td.bandreject_draw(4096, 8, _gen())
    assert lo.shape == (4096,) and (lo >= 1).all() and (hi <= 7999).all()
    assert (hi >= lo).all()
    # mel width at most 27/256 of the mel range
    mel = 2595 * torch.log10(1 + torch.stack([lo, hi]) / 700)
    assert ((mel[1] - mel[0]) <= 27 / 256 * 2840.1 + 1e-2).all()
    x = _t(_tone(440, 4096), _tone(880, 4096))
    y = td.bandreject_apply(x, torch.tensor([300.0, 1000.0]),
                            torch.tensor([301.0, 1500.0]))
    assert torch.equal(y[0], x[0]) and not torch.equal(y[1], x[1])


# --- pitch ----------------------------------------------------------------

@pytest.mark.parametrize("cents", [-300.0, -120.0, 150.0, 299.0])
def test_pitch_vocoder_matches_host_and_jax(cents):
    x = _tone(440, w=8192)
    got = td.pitch_apply(_t(x), torch.tensor([cents]))[0].numpy()
    scale = np.abs(x).max()
    host = ha.pitch_shift(x[None], cents, algo='vocoder')[0]
    assert np.abs(got - host).max() < 0.02 * scale
    jax_y = np.asarray(jd._pitch_one(jnp.asarray(x), jnp.float32(cents),
                                     2.0 ** (300.0 / 1200.0)))
    assert np.abs(got - jax_y).max() < 0.02 * scale


@pytest.mark.parametrize("cents", [-300.0, -137.0, -1.0, 1.0, 55.0, 299.0])
def test_pitch_quick_matches_host_and_jax(cents):
    x = _tone(440, w=4160)
    got = td.pitch_quick_apply(_t(x), torch.tensor([cents]))[0].numpy()
    ref = ha.pitch_shift(x[None], cents, quick=True, algo='vocoder')[0]
    tol = 2e-3 * max(np.abs(ref).max(), 1e-6)
    assert np.abs(got - ref).max() < tol
    jax_y = np.asarray(jd._pitch_quick_one(
        jnp.asarray(x), jnp.float32(cents), 2.0 ** (300.0 / 1200.0)))
    assert np.abs(got - jax_y).max() < tol


def test_zero_cents_is_identity():
    x = _t(_tone(300, 4096), _tone(500, 4096))
    cents = torch.tensor([0.4, 0.0])
    for apply in (td.pitch_apply, td.pitch_quick_apply,
                  td.pitch_wsola_apply):
        assert torch.equal(apply(x, cents), x)


def _host_wsola(x, out_len):
    """The host's `_wsola_stretch`, step for step, returning its output and
    each segment's position."""
    seg, ovr, search = 1312, 192, 234
    hop = seg - ovr
    rate = len(x) / float(out_len)
    out = np.zeros(out_len + seg)
    ramp = np.linspace(0.0, 1.0, ovr)
    pos, tail, positions = 0, None, []
    while pos < out_len:
        want = int(round(pos * rate))
        if want + seg > len(x):
            chunk = np.zeros(seg)
            chunk[:len(x) - want] = x[want:] if want < len(x) else 0.0
            best = want
        elif tail is None:
            best, chunk = want, x[want:want + seg]
        else:
            lo = max(0, want - search)
            hi = min(len(x) - seg, want + search)
            if hi <= lo:
                best = max(0, min(want, len(x) - seg))
            else:
                cands = np.lib.stride_tricks.sliding_window_view(
                    x[lo:hi + ovr], ovr)[:hi - lo + 1]
                best = lo + int(np.argmax(cands @ tail))
            chunk = x[best:best + seg]
        if tail is None:
            out[pos:pos + seg] = chunk
        else:
            out[pos:pos + ovr] = tail * (1 - ramp) + chunk[:ovr] * ramp
            out[pos + ovr:pos + seg] = chunk[ovr:]
        tail = (x[best + hop:best + hop + ovr]
                if best + hop + ovr <= len(x) else chunk[-ovr:])
        positions.append(best)
        pos += hop
    return out[:out_len], positions


def _hold_positions(x, got, want):
    """Equal positions, except where the host's scores of the two lags
    are equal in exact arithmetic (a pure tone shifted by a whole number
    of periods: 400 samples are 11 periods of 440 Hz), where float64
    rounding in another order may pick either: there the scores must
    agree to 1e-12."""
    x = x.astype(np.float64)
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            tail = x[want[i - 1] + 1120:want[i - 1] + 1120 + 192]
            s_g, s_w = x[g:g + 192] @ tail, x[w:w + 192] @ tail
            assert abs(s_g - s_w) <= 1e-12 * abs(s_w), (i, g, w, s_g, s_w)


@pytest.mark.parametrize("ci", [0, 1, 2, 3])
def test_wsola_positions_and_output(oracles, ci):
    """The WSOLA stretch takes the host's segment positions and matches
    the JAX package's and the host's stretch within 1e-5 of the peak
    (which only the same positions allow); the pitch shift matches the
    host's within the quick path's 2e-3, and the JAX package's and the
    committed oracle within 5e-3 of the peak."""
    cents = float(oracles[f'cents_{ci}'])
    for name in ('tone', 'harmonic', 'speechy'):
        x = oracles[f'in_{name}']
        w = x.shape[0]
        out_len = int(round(w * 2.0 ** (cents / 1200.0)))
        host_out, host_pos = _host_wsola(x.astype(np.float64), out_len)
        np.testing.assert_array_equal(
            host_out, ha._wsola_stretch(x.astype(np.float64), out_len))
        max_out = int(np.ceil(w * 2.0 ** (300 / 1200.0))) + 1
        stretched, positions = td._wsola_stretch_dev(
            _t(x), torch.tensor([out_len]), max_out)
        _hold_positions(x, positions[0, :len(host_pos)].tolist(), host_pos)
        jax_stretched = np.asarray(jd._wsola_stretch_dev(
            jnp.asarray(x), jnp.int32(out_len), max_out))
        scale = np.abs(x).max()
        live = stretched[0, :out_len].numpy()
        assert np.abs(live - jax_stretched[:out_len]).max() < 1e-5 * scale
        assert np.abs(live - host_out).max() < 1e-5 * scale
        got = td.pitch_wsola_apply(_t(x), torch.tensor([cents]))[0].numpy()
        # the resample back to W as the quick path's: float32 positions
        # against the host's float64 np.interp
        host = ha.pitch_shift(x[None].astype(np.float64), cents)[0]
        assert np.abs(got - host).max() < 2e-3 * scale
        jax_y = np.asarray(jd._pitch_wsola_one(
            jnp.asarray(x), jnp.float32(cents), 2.0 ** (300.0 / 1200.0)))
        assert np.abs(got - jax_y).max() < 5e-3 * scale
        ref = oracles[f'wsola_{ci}_{name}']
        assert np.abs(got - ref).max() < 5e-3 * np.abs(ref).max()


def test_wsola_unity_gain_and_batch():
    """The crossfade replaces the resident tail (+6 dB over every overlap
    if it were added), and a batch of windows takes each its own
    positions, the same as one at a time."""
    ones = torch.ones(1, 8192)
    y, _ = td._wsola_stretch_dev(ones, torch.tensor([9000]), 9000)
    assert (y[0, :7000] - 1.0).abs().max() < 1e-5
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(3, 8192).astype(np.float32))
    cents = torch.tensor([-250.0, 13.0, 290.0])
    together = td.wsola_positions(x, cents)
    for i in range(3):
        assert torch.equal(td.wsola_positions(x[i:i + 1], cents[i:i + 1]),
                           together[i:i + 1])


def test_round_ratio_is_exact():
    num = torch.tensor([5, 7, 9, 10, 2 ** 40 + 3, 0, 15])
    den = torch.tensor([2, 2, 6, 4, 2, 3, 10])
    want = [round(n / d) for n, d in zip(num.tolist(), den.tolist())]
    assert td._round_ratio(num, den).tolist() == want
    assert np.asarray(jd._round_ratio(jnp.asarray(num[:4].int().numpy()),
                                      jnp.asarray(den[:4].int().numpy()))
                      ).tolist() == want[:4]


# --- noise, dropout, reverbs ---------------------------------------------

def test_gaussian_noise_is_the_host_formula():
    x = np.stack([_tone(440), 0.01 * _tone(440)])
    noise = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    got = td.gaussian_noise_apply(torch.from_numpy(x),
                                  torch.from_numpy(noise), snr=15.0).numpy()
    for row_x, row_n, row in zip(x, noise, got):
        alpha = np.exp(15.0 * np.log(10) / 10) / (row_x.std() + 1e-12)
        np.testing.assert_allclose(row, row_x + row_n / alpha, rtol=1e-5,
                                   atol=1e-7)
    (drawn,) = td.gaussian_noise_draw(2, 20480, _gen())
    assert drawn.shape == (2, 20480) and abs(drawn.std().item() - 1) < 0.02


def test_time_dropout_is_the_host_span():
    """Given the host's draws (its span, then its start), the same zeros;
    the device's own draws keep to the host's ranges."""
    x = np.ones((1, 16000), np.float32)
    rng = np.random.RandomState(5)
    host = ha.TimeDropoutAugment
    np.random.seed(5)
    want = host(100)(x)
    span = rng.randint(0, 1600)
    start = rng.randint(0, 16000 - span)
    got = td.time_dropout_apply(torch.from_numpy(x), torch.tensor([start]),
                                torch.tensor([span]))
    np.testing.assert_array_equal(got.numpy(), want)
    start, span = td.time_dropout_draw(2000, 4096, _gen(), t_ms=50)
    assert (span >= 0).all() and (span < 800).all()
    assert (start >= 0).all() and (start + span <= 4096).all()


def test_freeverb_bank_matches_jax_and_lfilter():
    rs = np.random.RandomState(0)
    x = rs.randn(5000)
    d, c1, c2 = 1116, 0.5, 0.2
    b = np.zeros(d + 1)
    b[d] = 1.0
    a = np.zeros(d + 2)
    a[0], a[d], a[d + 1] = 1.0, -c1, -c2
    np.testing.assert_allclose(td._comb_np(x, d, c1, c2),
                               sps.lfilter(b, a, x), atol=1e-9)
    np.testing.assert_array_equal(td._freeverb_ir(37.0, 100.0, 100.0, 3000),
                                  jd._freeverb_ir(37.0, 100.0, 100.0, 3000))


@pytest.mark.parametrize("room", [0, 37, 99])
def test_artificial_reverb_matches_host_freeverb(room):
    """A fixed room: the bank's response by FFT against the host's filter
    chain within 2e-3 of its peak, and against the JAX package's
    convolution."""
    x = _tone(300, w=6000)
    got = td.artificial_reverb_apply(_t(x), torch.tensor([room]))[0].numpy()
    host = ha._freeverb(x.astype(np.float64), 100.0, 100.0, float(room))
    scale = np.abs(host).max()
    assert np.abs(got - host).max() < 2e-3 * scale
    ir = jd._freeverb_ir(float(room), 100.0, 100.0, 6000)
    jax_y = np.asarray(jd._fft_conv_crop(jnp.asarray(x[None]),
                                         jnp.asarray(ir[None])))[0]
    assert np.abs(got - jax_y).max() < 2e-3 * scale


def test_reverb_dropout_is_the_host_chain():
    """Host `ReverbDropout` at its drawn room, span and start."""
    x = _tone(300, w=4096)[None]
    np.random.seed(8)
    want = ha.ReverbDropout(50)(x)
    rng = np.random.RandomState(8)
    room = rng.randint(0, 100)
    span = rng.randint(0, 800)
    start = rng.randint(0, 4096 - span)
    got = td.artificial_reverb_dropout_apply(
        torch.from_numpy(x), torch.tensor([room]), torch.tensor([start]),
        torch.tensor([span])).numpy()
    assert np.abs(got - want).max() < 2e-3 * np.abs(want).max()
    np.testing.assert_array_equal(got[0, start:start + span], 0.0)


@pytest.fixture(scope="module")
def irs(tmp_path_factory):
    d = tmp_path_factory.mktemp("irs")
    ir = np.zeros(800, np.float32)
    ir[0], ir[400] = 1.0, 0.5
    save_wav(str(d / "ir0.wav"), ir, 16000)
    return d, ir


def test_natural_reverb_matches_host(irs):
    d, ir = irs
    x = _tone(440, w=4096)
    stage = td.make_natural_reverb(str(d), p=1.0)
    got = stage(_t(x), _gen())[0].numpy()
    host = ha.NaturalReverb.__new__(ha.NaturalReverb)
    np.testing.assert_allclose(got, host._apply_ir(x[None], ir)[0],
                               atol=2e-3)
    # p = 0: peak-normalised, as the host does without the response
    dry = td.make_natural_reverb(str(d), p=0.0)(_t(0.25 * x), _gen())
    np.testing.assert_allclose(dry[0].numpy(), 0.25 * x / (
        np.abs(0.25 * x).max() + 1e-8), atol=1e-5)
    idx, u = td.make_natural_reverb(str(d), 0.5, batch_wise=True).draw(
        6, 4096, _gen())
    assert idx.shape == (1,) and u.shape == (6,)


def test_additive_noise_mix(tmp_path):
    """The pool's windows mixed by the host formula at the drawn SNR (a
    very high SNR leaves the peak-normalised input)."""
    from cpc2_torch.data import AudioBatchData, find_all_seqs
    root = tmp_path / "noise"
    (root / "n").mkdir(parents=True)
    rs = np.random.RandomState(7)
    for i in range(2):
        save_wav(str(root / "n" / f"n{i}.wav"),
                 (0.1 * rs.randn(20000)).astype(np.float32), 16000)
    seqs, _ = find_all_seqs(str(root), extension=".wav", speaker_level=0)
    ds = AudioBatchData(str(root), 4096, seqs, None, 1, nProcessLoader=1)
    try:
        stage = td.make_additive_noise(ds, 10.0, 10.0, 4, pool_size=8)
        x = _tone(440, w=4096)
        idx, snr = stage.draw(1, 4096, _gen())
        got = stage.apply(_t(x), idx, snr)[0].numpy()
        assert float(snr) == 10.0 and 0 <= int(idx) < 8
        assert abs(np.abs(got).max() - 1.0) < 1e-3
        quiet = td.make_additive_noise(ds, 80.0, 80.0, 4, pool_size=8)
        yq = quiet(_t(x), _gen())[0].numpy()
        xe = x / (np.sqrt(np.mean(x ** 2)) + 1e-8)
        np.testing.assert_allclose(yq, xe / (np.abs(xe).max() + 1e-8),
                                   atol=2e-3)
    finally:
        ds.close()


# --- the factory ----------------------------------------------------------

def test_factory_vocabulary_and_errors():
    for name in td.DEVICE_AUGMENTATIONS:
        if name in ('natural_reverb', 'additive'):
            with pytest.raises(RuntimeError):
                td.make_device_augment([name])
            continue
        chain = td.make_device_augment([name])
        x = _t(_tone(440, 4096), _tone(660, 4096))
        y = chain(x, _gen())
        assert y.shape == x.shape and torch.isfinite(y).all(), name
    assert td.make_device_augment([]) is None
    assert td.make_device_augment(['pitch_deropout']).stages[0].name \
        == 'pitch_dropout'
    with pytest.raises(ValueError, match="no device implementation"):
        td.make_device_augment(['reverb'])


@pytest.mark.parametrize("names,algo,expect", [
    (['pitch'], 'wsola', ['wsola']),
    (['pitch_quick'], 'wsola', ['wsola']),
    (['pitch', 'pitch_quick'], 'wsola', ['wsola', 'wsola']),
    (['pitch'], 'vocoder', ['vocoder']),
    (['pitch_quick'], 'vocoder', ['quick']),
    (['pitch', 'pitch_quick'], 'vocoder', ['quick', 'quick']),
])
def test_factory_pitch_dispatch(names, algo, expect):
    """Under the default WSOLA every pitch stage stretches by WSOLA; under
    'vocoder' a 'pitch' beside a 'pitch_quick' runs the quick resample
    (the host factory's contagion)."""
    applies = {td.pitch_wsola_apply: 'wsola', td.pitch_apply: 'vocoder',
               td.pitch_quick_apply: 'quick'}
    chain = td.make_device_augment(names, pitch_algo=algo)
    assert [applies[s.apply.func] for s in chain.stages] == expect


def test_chain_draws_then_applies_deterministically():
    """The same draws give the same result (no scatter-add anywhere), a
    chain equals its stages one by one, and one generator seed gives one
    draw."""
    chain = td.make_device_augment(['bandreject', 'pitch_dropout',
                                    'artificial_reverb', 'random_noise'])
    x = _t(_tone(440, 4096), _tone(550, 4096), _tone(700, 4096))
    draws = chain.draw(3, 4096, _gen(3))
    y = chain.apply(x, draws)
    assert torch.equal(y, chain.apply(x, draws))
    assert torch.equal(y, chain(x, _gen(3)))
    step = x
    for stage, params in zip(chain.stages, draws):
        step = stage.apply(step, *params)
    assert torch.equal(step, y)


@pytest.mark.parametrize("same", [False, True])
def test_trainer_augments_training_views_only(same):
    """`Trainer._augment` draws from its own generator: the two views get
    their own draws, or the same with `past_equal_future`; the trainer's
    own generator is untouched."""
    from cpc2_torch.training import Trainer
    chain = td.make_device_augment(['bandreject', 'time_dropout'])
    gen, aug_gen = _gen(1), _gen(2)
    trainer = Trainer(None, None, None, gen, device_augment=(
        chain, True, True, same), augment_generator=aug_gen)
    x = _t(_tone(440, 4096), _tone(550, 4096))
    state = gen.get_state()
    past, future = trainer._augment(x, x.clone())
    assert torch.equal(gen.get_state(), state)
    assert same == torch.equal(past, future)
    assert not torch.equal(past, x)
