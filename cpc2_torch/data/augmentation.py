"""Waveform augmentation on the host (a copy of
`cpc2_tpu/data/augmentation.py`, reference `cpc/data_augmentation.py`).

The reference shells out to WavAugment/sox effect chains and
torch-audiomentations; these are the same effects as self-contained
numpy/scipy DSP run by the loader on the host:

* `BandrejectAugment`: a random mel-spaced windowed-sinc band-reject FIR
  (sox `sinc -a 120 high-low`, `data_augmentation.py:16-61`);
* `PitchAugment` / `PitchDropout`: a pitch shift in cents by a WSOLA
  (or phase-vocoder) time-stretch and a resample (sox `pitch` + `rate`,
  `:64-132`);
* `ReverbAugment` / `ReverbDropout`: Schroeder/freeverb-style artificial
  reverb (sox `reverb`, `:135-154,242-265`);
* `AdditiveNoiseAugment`: noise windows drawn from a second AudioBatchData
  through its own loader, mixed at a target SNR (`:157-228`);
* `RandomAdditiveNoiseAugment`: Gaussian noise at a fixed SNR (`:231-239`);
* `TimeDropoutAugment`: zero a random span (`:268-275`);
* `NaturalReverb`: impulse-response convolution, per window or per batch
  (`:278-318`);
* `CombinedTransforms` and `augmentation_factory`: composition and CLI
  wiring (`:331-443`).

Every transform takes and returns float32 arrays shaped (C, W) (C == 1),
the reference's per-item convention. Unlike the JAX package's, which draw
from the global `np.random` and `random` streams, each augmenter draws
from generators it is given: `rng`, an `np.random.RandomState`, for its
parameters, and `choice_rng`, a `random.Random`, for `NaturalReverb`'s file
choice. A legacy `RandomState(s)` draws what `np.random.seed(s)` followed
by the same calls draws, so the two packages agree bit for bit on the same
seed; the trainer reseeds the generators at each epoch, and `restart`
resets the augmenters' own state, so that a resumed run replays an
uninterrupted one.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

SAMPLE_RATE = 16000.0


def _signal():
    """`scipy.signal`, imported at its first use: it takes seconds to
    import, which every trainer process, a rank's too, would pay."""
    from scipy import signal
    return signal


def energy_normalization(wav: np.ndarray) -> np.ndarray:
    return wav / (np.sqrt(np.mean(wav ** 2)) + 1e-8)


def peak_normalization(wav: np.ndarray) -> np.ndarray:
    return wav / (np.abs(wav).max(axis=-1, keepdims=True) + 1e-8)


# ---------------------------------------------------------------------------
# Band reject
# ---------------------------------------------------------------------------

class BandrejectAugment:
    """Reject a random mel-spaced band (reference `:16-61`):
    F = 27*scaler; band width ~ U(0, melfmax*F/256) mel, start ~ U.

    The filter length is sized from the band width like sox's `sinc`
    (Kaiser formula for ~120 dB stop-band attenuation) unless `numtaps` is
    given."""

    def __init__(self, rng: np.random.RandomState, scaler: float = 1.0,
                 numtaps: Optional[int] = None):
        self.rng = rng
        self.scaler = scaler
        self.numtaps = numtaps

    @staticmethod
    def _auto_numtaps(lo: float, hi: float, fs: float = SAMPLE_RATE) -> int:
        transition = max(20.0, (hi - lo) * 0.25)
        n = int((120.0 - 7.95) / (2.285 * 2 * np.pi * transition / fs))
        n = min(max(n, 255), 4001)
        return n | 1  # odd

    @staticmethod
    def freq2mel(f):
        return 2595. * np.log10(1 + f / 700)

    @staticmethod
    def mel2freq(m):
        return (10. ** (m / 2595.) - 1) * 700

    @staticmethod
    def generate_freq_mask(scaler, rng: np.random.RandomState):
        f_ = 27.0 * scaler
        melfmax = BandrejectAugment.freq2mel(SAMPLE_RATE / 2)
        meldf = rng.uniform(0, melfmax * f_ / 256.)
        melf0 = rng.uniform(0, melfmax - meldf)
        low = BandrejectAugment.mel2freq(melf0)
        high = BandrejectAugment.mel2freq(melf0 + meldf)
        return low, high

    def __call__(self, x: np.ndarray) -> np.ndarray:
        low, high = self.generate_freq_mask(self.scaler, self.rng)
        nyq = SAMPLE_RATE / 2
        lo = max(low, 1.0)
        hi = min(high, nyq - 1.0)
        if hi - lo < 2.0:  # degenerate band: no-op
            return x.astype(np.float32)
        numtaps = self.numtaps or self._auto_numtaps(lo, hi)
        # 120 dB attenuation like sox `sinc -a 120` -> Kaiser beta ~ 12.
        taps = _signal().firwin(numtaps, [lo, hi], fs=SAMPLE_RATE,
                                window=('kaiser', 12.0),
                                pass_zero='bandstop')
        y = _signal().fftconvolve(x, taps[None, :], mode='same')
        return y.astype(np.float32)


# ---------------------------------------------------------------------------
# Pitch
# ---------------------------------------------------------------------------

def _stft(x, n_fft, hop, win):
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode='reflect')
    n_frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(xp[idx] * win, axis=1)


def _istft(spec, n_fft, hop, win, length):
    frames = np.fft.irfft(spec, n=n_fft, axis=1) * win
    out = np.zeros(hop * (spec.shape[0] - 1) + n_fft)
    norm = np.zeros_like(out)
    for i in range(spec.shape[0]):
        out[i * hop:i * hop + n_fft] += frames[i]
        norm[i * hop:i * hop + n_fft] += win ** 2
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    return out[pad:pad + length]


def _phase_vocoder(spec, rate, hop):
    """Standard phase-vocoder time-stretch by `rate` (>1 = faster)."""
    n_frames, n_bins = spec.shape
    time_steps = np.arange(0, n_frames - 1, rate)
    omega = 2 * np.pi * hop * np.arange(n_bins) / ((n_bins - 1) * 2)
    out = np.zeros((len(time_steps), n_bins), dtype=complex)
    phase_acc = np.angle(spec[0])
    for t, step in enumerate(time_steps):
        i = int(step)
        frac = step - i
        mag = (1 - frac) * np.abs(spec[i]) + frac * np.abs(spec[i + 1])
        out[t] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(spec[i + 1]) - np.angle(spec[i]) - omega
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc += omega + dphase
    return out


def _wsola_stretch(x: np.ndarray, out_len: int, sr: float = SAMPLE_RATE,
                   segment_ms: float = 82.0, search_ms: float = 14.68,
                   overlap_ms: float = 12.0) -> np.ndarray:
    """WSOLA time-stretch to `out_len` samples, the algorithm family
    behind sox `tempo`/`pitch` (music defaults: 82/14.68/12 ms). Output
    segments are copied from the input at rate-scaled positions, each
    shifted within +-search to maximise the cross-correlation with the
    tail of what was already written, then crossfaded over the overlap
    (held to `tests/fixtures/augment_oracles.npz`)."""
    seg = int(segment_ms * sr / 1000)
    ovr = int(overlap_ms * sr / 1000)
    search = int(search_ms * sr / 1000)
    hop = seg - ovr
    rate = len(x) / float(out_len)
    out = np.zeros(out_len + seg)
    ramp = np.linspace(0.0, 1.0, ovr)

    pos, tail = 0, None
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
            # The crossfade replaces the previous segment's tail (already
            # written at [pos, pos+ovr)): (1-ramp)*prev + ramp*new, unity
            # gain. Adding to it would double the resident tail, +6 dB
            # over every overlap window.
            out[pos:pos + ovr] = tail * (1 - ramp) + chunk[:ovr] * ramp
            out[pos + ovr:pos + seg] = chunk[ovr:]
        tail = (x[best + hop:best + hop + ovr]
                if best + hop + ovr <= len(x) else chunk[-ovr:])
        pos += hop
    return out[:out_len]


def pitch_shift(x: np.ndarray, cents: float, quick: bool = False,
                algo: str = 'wsola') -> np.ndarray:
    """Shift pitch by `cents` (1/100 semitone) keeping the duration, like
    sox `pitch` + `rate`. Input and output (C, W).

    algo: 'wsola' (the default: sox `pitch` is the WSOLA/tempo family in
    every reference chain, the quick ones included; `rate -q` only
    degrades the resample stage) or 'vocoder' (the phase-vocoder
    approximation, under which `quick` selects the linear-stretch
    shortcut)."""
    if abs(cents) < 1:
        return x.astype(np.float32)
    factor = 2.0 ** (cents / 1200.0)
    c, w = x.shape
    out = np.empty_like(x)
    n_fft, hop = 1024, 256
    win = np.hanning(n_fft + 1)[:-1]
    for ch in range(c):
        if algo == 'wsola':
            stretched = _wsola_stretch(x[ch].astype(np.float64),
                                       int(round(w * factor)))
        elif quick:
            # cheap: linear-interp resample then crop/pad (small artifacts)
            stretched = np.interp(
                np.arange(0, w, 1.0 / factor) / factor * factor,
                np.arange(w), x[ch])
        else:
            spec = _stft(x[ch], n_fft, hop, win)
            spec2 = _phase_vocoder(spec, 1.0 / factor, hop)
            stretched = _istft(spec2, n_fft, hop, win,
                               int(round(w * factor)))
        # resample stretched (length ~ w*factor) back to w samples
        src = np.linspace(0, 1, num=len(stretched), endpoint=False)
        dst = np.linspace(0, 1, num=w, endpoint=False)
        out[ch] = np.interp(dst, src, stretched)
    y = out.astype(np.float32)
    if not np.isfinite(y).all():
        return x.copy()
    return y


class PitchAugment:
    """`:64-100`: a random shift ~ U{-shift_max, shift_max - 1} cents."""

    def __init__(self, rng: np.random.RandomState, quick: bool = False,
                 shift_max: int = 300, algo: str = 'wsola'):
        self.rng = rng
        self.quick = quick
        self.shift_max = shift_max
        self.algo = algo

    def __call__(self, x: np.ndarray) -> np.ndarray:
        shift = self.rng.randint(-self.shift_max, self.shift_max)
        return pitch_shift(x, shift, quick=self.quick, algo=self.algo)


# ---------------------------------------------------------------------------
# Artificial reverb (freeverb-style, like sox `reverb`)
# ---------------------------------------------------------------------------

_COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
_ALLPASS_TUNINGS = (556, 441, 341, 225)


def _freeverb(x: np.ndarray, reverberance: float, hf_damping: float,
              room_scale: float, wet_gain_db: float = 0.0) -> np.ndarray:
    """Mono freeverb approximation of sox `reverb` (one channel, (W,))."""
    # sox maps reverberance/room-scale onto feedback/damping like freeverb.
    feedback = 0.28 + 0.7 * (room_scale / 100.0)
    damping = hf_damping / 100.0 * 0.4 + 0.2
    wet = np.zeros_like(x)
    for tuning in _COMB_TUNINGS:
        # Lowpass-feedback comb filter via lfilter:
        # y[n] = x[n-d] + f*(1-damp)*y[n-d] + f*damp*y[n-d-1] (approx)
        d = tuning
        b = np.zeros(d + 1)
        b[d] = 1.0
        a = np.zeros(d + 2)
        a[0] = 1.0
        a[d] = -feedback * (1 - damping)
        a[d + 1] = -feedback * damping
        wet += _signal().lfilter(b, a, x)
    wet /= len(_COMB_TUNINGS)
    for tuning in _ALLPASS_TUNINGS:
        d = tuning
        b = np.zeros(d + 1)
        b[0] = -0.5
        b[d] = 1.0
        a = np.zeros(d + 1)
        a[0] = 1.0
        a[d] = -0.5
        wet = _signal().lfilter(b, a, wet)
    mix = reverberance / 100.0
    y = (1 - mix * 0.5) * x + mix * 0.5 * wet * (10 ** (wet_gain_db / 20))
    return y


class ReverbAugment:
    """sox reverb(100, 100, random_room_size) (`:135-154`)."""

    def __init__(self, rng: np.random.RandomState, shift_max: int = 100,
                 reverberance: float = 100.0, hf_damping: float = 100.0):
        self.rng = rng
        self.shift_max = shift_max
        self.reverberance = reverberance
        self.hf_damping = hf_damping

    def __call__(self, x: np.ndarray) -> np.ndarray:
        room = self.rng.randint(0, self.shift_max)
        y = np.stack([_freeverb(x[c], self.reverberance, self.hf_damping,
                                room) for c in range(x.shape[0])])
        return y.astype(np.float32)


class TimeDropoutAugment:
    """Zero one random span of up to T_ms (`:268-275`, WavAugment
    time_dropout)."""

    def __init__(self, rng: np.random.RandomState, T_ms: int = 100,
                 sr: float = SAMPLE_RATE):
        self.rng = rng
        self.t_max = int(T_ms / 1000.0 * sr)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        w = x.shape[-1]
        length = self.rng.randint(0, max(1, self.t_max))
        if length == 0 or length >= w:
            return x
        start = self.rng.randint(0, w - length)
        y = x.copy()
        y[..., start:start + length] = 0.0
        return y


class ReverbDropout:
    """reverb(50,50,rand) then time dropout (`:242-265`)."""

    def __init__(self, rng: np.random.RandomState, T_ms: int = 100):
        self.reverb = ReverbAugment(rng, shift_max=100, reverberance=50.0,
                                    hf_damping=50.0)
        self.dropout = TimeDropoutAugment(rng, T_ms)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.dropout(self.reverb(x))


class PitchDropout:
    """pitch + time dropout (`:103-132`)."""

    def __init__(self, rng: np.random.RandomState, T_ms: int = 100,
                 shift_max: int = 300, algo: str = 'wsola'):
        # The reference chain is `pitch ... rate -q`: sox `pitch` is the
        # WSOLA stretch and `-q` only degrades the resample stage, so the
        # default algo runs the WSOLA stretch here too; algo='vocoder'
        # keeps the quick linear-stretch shortcut for this chain.
        self.pitch = PitchAugment(rng, quick=(algo != 'wsola'),
                                  shift_max=shift_max, algo=algo)
        self.dropout = TimeDropoutAugment(rng, T_ms)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.dropout(self.pitch(x))


# ---------------------------------------------------------------------------
# Additive noise
# ---------------------------------------------------------------------------

class AdditiveNoiseAugment:
    """Mix in noise windows from a second AudioBatchData at a target SNR
    (`:157-228`). The noise windows come in order from the noise corpus's
    own loader; `restart` begins a new pass over it."""

    def __init__(self, rng: np.random.RandomState, noise_dataset,
                 snr_min: float, snr_max: float, batchSize: int,
                 sampling: str = 'uniform'):
        if noise_dataset is None or snr_min > snr_max:
            raise ValueError("additive noise needs a noise dataset and "
                             f"snr_min <= snr_max ({snr_min}, {snr_max})")
        self.rng = rng
        self.noise_dataset = noise_dataset
        self.sampling = sampling
        self.batchSize = batchSize
        self.snr_min = snr_min
        self.snr_max = snr_max
        self.restart()

    def restart(self):
        self.update_noise_loader()
        self.get_next_batch()

    def update_noise_loader(self):
        self.noise_data_loader = iter(self.noise_dataset.getDataLoader(
            self.batchSize, self.sampling, True,
            remove_artefacts=self.sampling != "uniform"))

    def get_next_batch(self):
        try:
            self.current_noise_batch = next(self.noise_data_loader)[0]
        except StopIteration:
            self.update_noise_loader()
            self.current_noise_batch = next(self.noise_data_loader)[0]

    def get_noise_sequence(self) -> np.ndarray:
        if self.current_noise_batch.shape[0] == 0:
            self.get_next_batch()
        noise = self.current_noise_batch[0, 0, ...]
        self.current_noise_batch = self.current_noise_batch[1:, ...]
        return np.asarray(noise)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        noise = self.get_noise_sequence()
        snr = ((self.snr_max - self.snr_min) * self.rng.random_sample()
               + self.snr_min)
        a = float(snr) / 20
        noise_rms = 1 / (10 ** a)
        noise = noise.reshape(x.shape)
        noised = peak_normalization(
            energy_normalization(x) + energy_normalization(noise) * noise_rms)
        return noised.astype(np.float32)


class RandomAdditiveNoiseAugment:
    """Gaussian noise at a fixed SNR (`:231-239`)."""

    def __init__(self, rng: np.random.RandomState, snr: float = 15):
        self.rng = rng
        self.snr = np.exp(snr * np.log(10) / 10)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        alpha = self.snr / (x.std() + 1e-12)
        noise = self.rng.randn(*x.shape).astype(np.float32) / alpha
        return x + noise


# ---------------------------------------------------------------------------
# Natural reverb (impulse responses)
# ---------------------------------------------------------------------------

class NaturalReverb:
    """Convolve with a random measured impulse response (`:278-318`): a
    new file for each window, or with `batch_wise` one for every
    `batchSize` windows (`restart` draws a new one)."""

    def __init__(self, rng: np.random.RandomState, choice_rng: random.Random,
                 ir_paths: str, p: float, batchSize: int, sr: int = 32000,
                 batch_wise: bool = False):
        from .audio_io import load_audio
        from .corpus import find_all_seqs
        self.rng = rng
        self.choice_rng = choice_rng
        self.p = p
        self.sr = sr
        self.batch_wise = batch_wise
        self.count = 0
        self.batchSize = batchSize
        self._load_audio = load_audio

        ir_files, _ = find_all_seqs(ir_paths, extension=".wav",
                                    speaker_level=0)
        self.ir_files = [os.path.join(ir_paths, data[1])
                         for data in ir_files]
        print("Found %d files for natural reverberation"
              % len(self.ir_files))
        self.current_ir = None
        self.restart()

    def restart(self):
        self.count = 0
        if self.batch_wise:
            self.get_new_impulse_response()

    def get_new_impulse_response(self):
        ir_file = self.choice_rng.choice(self.ir_files)
        ir, _sr = self._load_audio(ir_file)
        self.current_ir = np.asarray(ir, dtype=np.float32)

    def _apply_ir(self, x: np.ndarray, ir: np.ndarray) -> np.ndarray:
        y = _signal().fftconvolve(x, ir[None, :],
                                  mode='full')[..., :x.shape[-1]]
        return peak_normalization(y).astype(np.float32)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if self.batch_wise:
            ir = self.current_ir
            apply_it = self.rng.random_sample() < self.p
            y = self._apply_ir(x, ir) if apply_it else peak_normalization(x)
            self.count += 1
            if self.count == self.batchSize:
                self.get_new_impulse_response()
                self.count = 0
            return y.astype(np.float32)
        if self.rng.random_sample() < self.p:
            ir_file = self.choice_rng.choice(self.ir_files)
            ir, _sr = self._load_audio(ir_file)
            return self._apply_ir(x, np.asarray(ir, dtype=np.float32))
        return peak_normalization(x).astype(np.float32)


# ---------------------------------------------------------------------------
# Composition and factory (`:321-443`)
# ---------------------------------------------------------------------------

class AugmentCfg:
    """One augmentation of a chain given as JSON, as the Common Voices
    CLI's `-a '{"type": "bandreject", "bandreject_scaler": 1.0}'` gives it:
    its type and its factory arguments (`:321-329`)."""

    def __init__(self, **kwargs):
        self.augment_type = kwargs["type"]
        self.config = {k: i for k, i in kwargs.items() if k != 'type'}

    def __repr__(self):
        return f"{self.augment_type} : \n {self.config}"


class CombinedTransforms:
    """Apply several augmentations in order (`:331-344`). An entry is an
    augment type, built from `kwargs`, or an `AugmentCfg`, built from
    `kwargs` and its own config (the JAX package hands the `AugmentCfg`
    itself to `get_augment` as the type, which raises on every one)."""

    def __init__(self, augment_cfgs, **kwargs):
        self.transfors_cfgs = [
            get_augment(x.augment_type, **{**kwargs, **x.config})
            if isinstance(x, AugmentCfg) else get_augment(x, **kwargs)
            for x in augment_cfgs]

    def __call__(self, x):
        for transform in self.transfors_cfgs:
            if transform is not None:
                x = transform(x)
        return x

    def restart(self):
        for transform in self.transfors_cfgs:
            restart(transform)


def restart(augmentation) -> None:
    """Reset what an augmenter carries from window to window (the noise
    loader's place, a batch-wise impulse response) to a fresh start drawn
    from its generators, as the trainer does at each epoch after
    reseeding them."""
    if hasattr(augmentation, 'restart'):
        augmentation.restart()


def canonical_augment_type(augment_type: str) -> str:
    """Map the reference CLI's misspelled choice 'pitch_deropout'
    (`cpc_default_config.py:131`) onto the factory's 'pitch_dropout' key
    (`data_augmentation.py:368`): in the reference the two never meet, so
    PitchDropout is unreachable from its CLI; both spellings are taken."""
    return 'pitch_dropout' if augment_type == 'pitch_deropout' \
        else augment_type


def get_augment(augment_type, **kwargs):
    augment_type = canonical_augment_type(augment_type)
    rng = kwargs['rng']
    if not augment_type or augment_type == 'none':
        return None
    elif augment_type == 'bandreject':
        return BandrejectAugment(rng, scaler=kwargs['bandreject_scaler'])
    elif augment_type == 'additive':
        if not kwargs['noise_dataset']:
            raise RuntimeError('Noise dataset is needed for the additive '
                               'noise')
        return AdditiveNoiseAugment(rng, kwargs['noise_dataset'],
                                    kwargs['additive_noise_snr_min'],
                                    kwargs['additive_noise_snr_max'],
                                    kwargs['batchSize'],
                                    kwargs['additive_noise_sampling'])
    elif augment_type in ('pitch', 'pitch_quick'):
        # 'pitch_quick' inside a combined chain crashes the reference
        # factory (`data_augmentation.py:358,378`); honour it here.
        return PitchAugment(rng, quick=(kwargs['pitch_quick']
                                        or augment_type == 'pitch_quick'),
                            shift_max=kwargs['shift_max'],
                            algo=kwargs.get('pitch_algo', 'wsola'))
    elif augment_type == 'artificial_reverb':
        return ReverbAugment(rng)
    elif augment_type == 'time_dropout':
        return TimeDropoutAugment(rng, kwargs['t_ms'])
    elif augment_type == 'artificial_reverb_dropout':
        return ReverbDropout(rng, kwargs['t_ms'])
    elif augment_type == 'random_noise':
        return RandomAdditiveNoiseAugment(rng, kwargs['additive_noise_snr'])
    elif augment_type == 'pitch_dropout':
        return PitchDropout(rng, kwargs['t_ms'],
                            shift_max=kwargs['shift_max'],
                            algo=kwargs.get('pitch_algo', 'wsola'))
    elif augment_type == 'natural_reverb':
        return NaturalReverb(rng, kwargs['choice_rng'],
                             ir_paths=kwargs['pathImpulseResponses'],
                             p=kwargs['impulse_response_prob'],
                             batchSize=kwargs['batchSize'],
                             sr=kwargs['ir_sample_rate'],
                             batch_wise=kwargs['ir_batch_wise'])
    else:
        raise RuntimeError(f'Unknown augment_type = {augment_type}')


def augmentation_factory(args, noise_dataset=None, applied_on_noise=False,
                         *, batch_size: int, rng: np.random.RandomState,
                         choice_rng: random.Random):
    """CLI wiring (`:381-443`), the meta-augmentation mode that augments
    the noise corpus itself included. `batch_size` is the trainer's batch
    (the JAX package reads `nGPU * batchSizeGPU`); `rng` and `choice_rng`
    are the chain's generators."""
    if applied_on_noise:
        augment_type = args.meta_aug_type
        ir_batch_wise = args.meta_ir_batch_wise
        if augment_type is not None:
            print("Activating meta data augmentation with : %s"
                  % augment_type)
    else:
        augment_type = args.augment_type
        ir_batch_wise = args.ir_batch_wise
        print("Activating data augmentation with : %s" % augment_type)

    if (not augment_type or augment_type == 'none'
            or not (args.augment_past or args.augment_future)):
        return None
    # 'none' entries are no-ops: the reference compares the list with the
    # string 'none' (always False), so its ['none'] falls through to the
    # dispatch tail and raises although 'none' is an argparse choice
    # (`data_augmentation.py:394,443`). Dropping them makes ['none'] return
    # None and ['pitch', 'none'] act as ['pitch'].
    augment_type = [canonical_augment_type(t) for t in augment_type
                    if t != 'none']
    if not augment_type:
        return None

    additive_noise_sampling = ("temporalsamespeaker"
                               if args.temporal_additive_noise else "uniform")
    if len(augment_type) > 1:
        # The reference writes `args.augment_type == 'pitch_quick'` here
        # (`data_augmentation.py:401,421`), a list-vs-str compare that is
        # always False, so its pitch_quick runs the full-quality path;
        # here every pitch stage of a chain that lists pitch_quick is quick.
        aug_args = {"bandreject_scaler": args.bandreject_scaler,
                    "pitch_quick": 'pitch_quick' in augment_type,
                    "t_ms": args.t_ms,
                    "noise_dataset": noise_dataset,
                    "additive_noise_snr_min": args.min_snr_in_db,
                    "additive_noise_snr_max": args.max_snr_in_db,
                    "additive_noise_sampling": additive_noise_sampling,
                    "impulse_response_prob": args.impulse_response_prob,
                    "pathImpulseResponses": args.pathImpulseResponses,
                    "ir_sample_rate": args.ir_sample_rate,
                    "batchSize": batch_size,
                    "ir_batch_wise": ir_batch_wise,
                    "shift_max": args.shift_max,
                    "pitch_algo": getattr(args, 'pitch_algo', 'wsola'),
                    "rng": rng, "choice_rng": choice_rng}
        return CombinedTransforms(augment_type, **aug_args)
    augment_type = augment_type[0]

    if augment_type == 'bandreject':
        return BandrejectAugment(rng, scaler=args.bandreject_scaler)
    elif augment_type in ['pitch', 'pitch_quick']:
        return PitchAugment(rng, quick=augment_type == 'pitch_quick',
                            shift_max=args.shift_max,
                            algo=getattr(args, 'pitch_algo', 'wsola'))
    elif augment_type == 'artificial_reverb':
        return ReverbAugment(rng)
    elif augment_type == 'time_dropout':
        return TimeDropoutAugment(rng, args.t_ms)
    elif augment_type == 'additive':
        if not noise_dataset:
            raise RuntimeError('Noise dataset is needed for the additive '
                               'noise')
        return AdditiveNoiseAugment(rng, noise_dataset, args.min_snr_in_db,
                                    args.max_snr_in_db, batch_size,
                                    additive_noise_sampling)
    elif augment_type == 'artificial_reverb_dropout':
        return ReverbDropout(rng, args.t_ms)
    elif augment_type == 'pitch_dropout':
        return PitchDropout(rng, args.t_ms, shift_max=args.shift_max,
                            algo=getattr(args, 'pitch_algo', 'wsola'))
    elif augment_type == 'natural_reverb':
        return NaturalReverb(rng, choice_rng,
                             ir_paths=args.pathImpulseResponses,
                             p=args.impulse_response_prob,
                             batchSize=batch_size,
                             sr=args.ir_sample_rate,
                             batch_wise=ir_batch_wise)
    else:
        raise RuntimeError(f'Unknown augment_type = {augment_type}')
