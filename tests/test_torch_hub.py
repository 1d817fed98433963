"""The port's hub entry (`cpc2_torch.hub.CPC_audio`) against the root
`hubconf.CPC_audio` of the JAX package on the CPU: the committed
miniature payload in the published checkpoint's layout
(`tests/fixtures/hub_mini_60k.pt`) loads key for key, its features match
the JAX bundle's (rtol 1e-5; atol 1e-5, since the encoder's ChannelNorm
divides by a standard deviation, which scales fp32 reordering errors, as
`tests/test_torch_modules.py` holds the encoder), a fresh model takes its
widths from the keyword arguments, a payload that lacks a key or a model
the port cannot build raises, and the default device is the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_torch.hub import CPC_audio

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "hub_mini_60k.pt")


def test_payload_loads_every_key():
    payload = torch.load(FIXTURE, weights_only=False)
    model = CPC_audio(pretrained_path=FIXTURE, device="cpu")
    state = model.state_dict()
    assert set(payload["weights"]) <= set(state)
    for key, value in payload["weights"].items():
        assert torch.equal(state[key], value), key


def test_features_match_the_jax_bundle():
    import hubconf
    x = np.random.RandomState(0).randn(2, 4160).astype(np.float32)
    bundle = hubconf.CPC_audio(pretrained_path=FIXTURE)
    c_j, e_j, _, _ = jax.jit(lambda a: bundle.apply(a))(jnp.asarray(x))
    model = CPC_audio(pretrained_path=FIXTURE, device="cpu")
    with torch.no_grad():
        c, e, _h = model(torch.from_numpy(x))
    assert c.shape == (2, 26, 32)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), rtol=1e-5,
                               atol=1e-5)


def test_fresh_model_widths():
    model = CPC_audio(hiddenEncoder=24, hiddenGar=24, device="cpu")
    with torch.no_grad():
        c, e, _h = model(torch.zeros(1, 4160))
    assert c.shape == (1, 26, 24) and e.shape == (1, 26, 24)
    assert model.gAR.baseNet.mode == "LSTM"


def test_missing_key_raises(tmp_path):
    payload = torch.load(FIXTURE, weights_only=False)
    del payload["weights"]["gAR.baseNet.weight_hh_l0"]
    path = tmp_path / "partial.pt"
    torch.save(payload, path)
    with pytest.raises(KeyError, match="weight_hh_l0"):
        CPC_audio(pretrained_path=str(path), device="cpu")


def test_unported_model_raises():
    """A configuration that no package builds raises; the MFCC front-end,
    once refused here, is ported and builds."""
    with pytest.raises(ValueError, match="encoder_type"):
        CPC_audio(encoder_type="wavelet", device="cpu")
    model = CPC_audio(encoder_type="mfcc", device="cpu")
    assert type(model.gEncoder).__name__ == "MFCCEncoder"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CPC_audio()
