"""The port's device-resident corpus and multi-step dispatch on the CPU
(`cpc2_torch/data/device_corpus.py`, `cpc2_torch/dispatch.py`,
`cpc2_torch/training.py:MultiStep`, `cpc2_torch.train --corpus_on_device
--steps_per_dispatch N`) against the JAX package's: `pcm16_wire` and the
window gather bit for bit, the resident pack against the host gather, the
loader's offsets and labels for every sampling type, the group boundaries,
and whole CLI runs, where N steps per dispatch with the pack on the device
equal one step per dispatch from host batches bit for bit (on the CPU the N
steps run eagerly). Tiny widths: the file runs in well under 30 s.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.data.corpus import find_all_seqs as jax_find_all_seqs
from cpc2_tpu.data.dataset import AudioBatchData as JaxAudioBatchData
from cpc2_tpu.dispatch import GroupAssembler as JaxGroupAssembler
from cpc2_tpu.parallel import mesh as jax_mesh
from cpc2_torch.config import parse_args
from cpc2_torch.data import AudioBatchData, find_all_seqs
from cpc2_torch.data.device_corpus import (DeviceCorpus,
                                           device_gather_windows, pcm16_wire)
from cpc2_torch.dispatch import GroupAssembler
from cpc2_torch.losses import CPCUnsupervisedCriterion, CTCPhoneCriterion
from cpc2_torch.train import _load_optimizer, main
from cpc2_torch.training import dispatch_route

torch.set_num_threads(1)


def _pack(kind: str, n: int = 5000) -> np.ndarray:
    rs = np.random.RandomState(0)
    if kind == "on_grid":
        return rs.randint(-32768, 32768, n).astype(np.float32) / 32768.0
    if kind == "grid_ends":       # -1 and 32767 / 32768, both on the grid
        x = rs.randint(-32768, 32768, n).astype(np.float32) / 32768.0
        x[:2] = -1.0, 32767 / 32768.0
        return x
    if kind == "off_grid":
        return (rs.randn(n) * 0.1).astype(np.float32)
    if kind == "out_of_range":    # 1.0 * 32768 is past int16
        x = rs.randint(-32768, 32768, n).astype(np.float32) / 32768.0
        x[7] = 1.0
        return x
    raise ValueError(kind)


PACKS = ["on_grid", "grid_ends", "off_grid", "out_of_range"]


@pytest.mark.parametrize("kind", PACKS)
def test_pcm16_wire_matches_jax(kind):
    arr = _pack(kind)
    got, got_i16 = pcm16_wire(arr)
    want, want_i16 = jax_mesh.pcm16_wire(arr)
    assert got_i16 == want_i16 == (kind in ("on_grid", "grid_ends"))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", PACKS)
def test_device_gather_windows_matches_jax(kind):
    """int16 and float32 packs; offsets at the pack's ends and past them
    (clamped, as `dynamic_slice` clamps)."""
    w = 256
    wire, _ = pcm16_wire(_pack(kind))
    n = wire.shape[0]
    idx = np.array([0, 1, 1234, n - w - 1, n - w, n - w + 9, n + 100, -3],
                   np.int32)
    got = device_gather_windows(torch.from_numpy(wire),
                                torch.from_numpy(idx), w)
    want = np.asarray(jax_mesh.device_gather_windows(
        jnp.asarray(wire), jnp.asarray(idx), w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 2, 1, w)
    np.testing.assert_array_equal(got.numpy(), want)


def _datasets(corpus, window, max_size, keep_temporality=False):
    """The port's and the JAX package's datasets on `corpus`, built from the
    same seed."""
    seqs, speakers = find_all_seqs(str(corpus), extension=".wav")
    jax_seqs, _ = jax_find_all_seqs(str(corpus), extension=".wav")
    out = []
    for cls, sq in ((AudioBatchData, seqs), (JaxAudioBatchData, jax_seqs)):
        random.seed(0)
        np.random.seed(0)
        out.append(cls(str(corpus), window, sq, None, len(speakers),
                       nProcessLoader=1, MAX_SIZE_LOADED=max_size,
                       keep_temporality=keep_temporality))
    return out


def _close(*datasets):
    for ds in datasets:
        ds.reload_pool.shutdown(wait=True)


def test_device_corpus_put_matches_get_batch(mini_corpus):
    """The resident pack (int16: the WAV corpus sits on the PCM16 grid)
    gathers the host loader's batches bit for bit, and `gather_windows`
    is the JAX package's."""
    port, ref = _datasets(mini_corpus, 3200, 4000000000)
    try:
        corpus = DeviceCorpus(3200, torch.device("cpu"),
                              port.max_pack_samples())
        corpus.ensure(port.data)
        assert corpus.resident.dtype == torch.int16
        assert port.max_pack_samples() == ref.max_pack_samples() \
            == len(port.data)
        idx = [0, 3200, 40000, len(port.data) - 3200]
        got = corpus.put(np.asarray(idx)).numpy()
        np.testing.assert_array_equal(got, port.get_batch(idx)[0])
        np.testing.assert_array_equal(got, port.gather_windows(idx))
        np.testing.assert_array_equal(port.gather_windows(idx),
                                      ref.gather_windows(idx))
        np.testing.assert_array_equal(port.get_batch_meta(idx)[0],
                                      port.get_batch(idx)[1])
    finally:
        _close(port, ref)


def test_pack_swap_reuploads():
    corpus = DeviceCorpus(16, torch.device("cpu"), 100)
    a = np.zeros(100, np.float32)
    b = np.full(60, 0.25, np.float32)
    corpus.ensure(a)
    slab = corpus.resident
    corpus.ensure(a)
    assert corpus.resident is slab
    corpus.ensure(b)                    # a smaller pack: into the same slab
    assert corpus.resident is slab
    np.testing.assert_array_equal(corpus.put(np.array([0, 44, 80])).numpy(),
                                  0.25)    # 80 clamps to 60 - 16
    c = np.full(100, 0.3, np.float32)   # off the grid: a float32 slab
    corpus.ensure(c)
    assert corpus.resident.dtype == torch.float32
    np.testing.assert_array_equal(corpus.put(np.array([3])).numpy(),
                                  np.float32(0.3))


def test_pack_swap_with_recycled_id():
    """Residency keys on a strong reference, not `id()`: a new pack at a
    freed pack's address is uploaded."""
    corpus = DeviceCorpus(16, torch.device("cpu"))
    corpus.ensure(np.zeros(100, np.float32))
    for i in range(50):
        b = np.full(100, (i + 1) / 256.0, np.float32)
        corpus.ensure(b)
        np.testing.assert_array_equal(
            corpus.put(np.array([0, 8])).numpy(), np.float32((i + 1) / 256))
        del b


def test_ensure_refuses_2_to_the_31_samples():
    huge = np.broadcast_to(np.float32(0), (2 ** 31,))
    with pytest.raises(ValueError, match="Lower --max_size_loaded"):
        DeviceCorpus(16, torch.device("cpu")).ensure(huge)


@pytest.mark.parametrize("sampling", ["samespeaker", "uniform",
                                      "samesequence", "sequential",
                                      "temporalsamespeaker"])
def test_yield_indices_matches_jax(mini_corpus, sampling):
    """The offsets, labels and clean windows of a two-epoch walk over three
    packs, batch by batch, are the JAX loader's."""
    temporal = sampling == "temporalsamespeaker"
    port, ref = _datasets(mini_corpus, 3200, 120000, temporal)
    try:
        assert len(port.packageIndex) == len(ref.packageIndex) >= 3
        assert port.max_pack_samples() == ref.max_pack_samples()
        for epoch in range(2):
            walks = []
            for ds in (port, ref):
                random.seed(epoch)
                np.random.seed(epoch)
                walks.append([
                    (np.asarray(b[0]), np.asarray(b[1]),
                     ds.gather_windows(b[0]))
                    for b in ds.getDataLoader(4, sampling, True,
                                              batch_size_per_gpu=4,
                                              yield_indices=True)])
            assert len(walks[0]) == len(walks[1]) > 3
            for got, want in zip(*walks):
                assert got[0].dtype == want[0].dtype == np.int64
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
    finally:
        _close(port, ref)


def _groups_of(assembler, items):
    out = [assembler.add(it) for it in items] + [assembler.flush()]
    return [o for o in out if o is not None]


@pytest.mark.parametrize("layout", [
    (6,),             # full groups only
    (4, 5),           # a pack swap mid-group
    (5,),             # the epoch's end flushes a partial group
    (2, 3, 1, 7),     # several swaps, a pack shorter than a group
])
def test_group_boundaries_match_jax(layout):
    spd, rs = 3, np.random.RandomState(1)
    items = []
    for n in layout:
        pack = np.zeros(10, np.float32)
        items += [(pack, rs.randint(0, 1000, 4).astype(np.int32),
                   rs.randint(0, 5, 4).astype(np.int64)) for _ in range(n)]
    got = _groups_of(GroupAssembler(spd), items)
    want = _groups_of(JaxGroupAssembler(jax_mesh.make_mesh(1), spd,
                                        lambda labs, stacked=False: labs),
                      [(p, o, lab.astype(np.int32), None, None)
                       for p, o, lab in items])
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        if g[0] == 'idxpartial':
            assert len(g[1]) == len(w[1])
            for a, b in zip(g[1], w[1]):
                assert a[0] is b[0]
                np.testing.assert_array_equal(a[1], b[1])
        else:
            assert g[1] is w[1] and g[4] == w[6]
            assert g[2].dtype == torch.int32 and g[2].shape == (spd, 4)
            np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
            np.testing.assert_array_equal(g[3].numpy(), np.asarray(w[3]))


BASE = ["--pathDB", "db", "--file_extension", ".wav"]


@pytest.mark.parametrize("flags", [
    ["--steps_per_dispatch", "1"], ["--steps_per_dispatch", "2"],
    ["--steps_per_dispatch", "4", "--corpus_on_device"],
])
def test_dispatch_flags_parse(flags):
    args = parse_args(BASE + flags)
    assert args.steps_per_dispatch == int(flags[1])
    assert args.corpus_on_device == ("--corpus_on_device" in flags)


def _train(corpus, tmp_path, name, *extra):
    return main(["--pathDB", str(corpus), "--file_extension", ".wav",
                 "--device", "cpu", "--nEpoch", "2", "--hiddenEncoder", "16",
                 "--hiddenGar", "16", "--nPredicts", "3",
                 "--negativeSamplingExt", "4", "--sizeWindow", "3200",
                 "--batchSizeGPU", "4", "--random_seed", "3",
                 "--logging_step", "5", "--n_process_loader", "1",
                 "--max_size_loaded", "120000",
                 "--pathCheckpoint", str(tmp_path / name), *extra])


def _equal_runs(a, b):
    for key in ("locLoss_train", "locAcc_train", "locLoss_val",
                "locAcc_val", "iter"):
        np.testing.assert_array_equal(np.asarray(a["logs"][key]),
                                      np.asarray(b["logs"][key]), key)
    ca = torch.load(a["checkpoint"], weights_only=False)
    cb = torch.load(b["checkpoint"], weights_only=False)
    for part in ("gEncoder", "cpcCriterion"):
        for k, v in ca[part].items():
            assert torch.equal(v, cb[part][k]), (part, k)


@pytest.mark.parametrize("extra", [
    [],
    ["--supervised"],
    # composes with the device augmentation
    ["--augment_past", "--augment_type", "bandreject", "--augment_on_device"],
])
def test_cli_groups_on_device_equal_single_steps(mini_corpus, tmp_path,
                                                 extra):
    """Two epochs over three packs: N = 3 with the pack on the device (the
    groups broken at pack swaps and short batches, the rest eager steps)
    against N = 1 from host batches, bit for bit."""
    host = _train(mini_corpus, tmp_path, "host", *extra)
    dev = _train(mini_corpus, tmp_path, "dev", "--corpus_on_device",
                 "--steps_per_dispatch", "3", *extra)
    for rec in (host, dev):
        rec["checkpoint"] = str(tmp_path / ("dev" if rec is dev else "host")
                                / "checkpoint_1.pt")
    _equal_runs(host, dev)
    assert (host["steps_per_dispatch"], dev["steps_per_dispatch"]) == (1, 3)
    assert host["dispatch"] == dev["dispatch"] == "eager"
    n_steps = sum(dev["logs"]["iter"])
    assert len(dev["step_ms"]) == n_steps
    assert len(host["dispatch_ms"]) == n_steps
    assert n_steps / 3 <= len(dev["dispatch_ms"]) < n_steps


def test_sequential_sampling_keeps_one_step(mini_corpus, tmp_path, capsys):
    rec = _train(mini_corpus, tmp_path, "seq", "--samplingType",
                 "sequential", "--steps_per_dispatch", "2",
                 "--corpus_on_device", "--nEpoch", "1")
    assert "incompatible with the sequential-sampling hidden carry; " \
        "using 1" in capsys.readouterr().out
    assert rec["steps_per_dispatch"] == 1
    assert len(rec["dispatch_ms"]) == rec["logs"]["iter"][0]


def test_host_augmentation_with_corpus_on_device_raises(mini_corpus,
                                                        tmp_path):
    with pytest.raises(ValueError, match="needs clean host windows"):
        _train(mini_corpus, tmp_path, "aug", "--corpus_on_device",
               "--augment_past", "--augment_type", "bandreject")


def test_capturable_flag_follows_the_loading_optimizer():
    """A checkpoint of a card's fused, capturable Adam (step counts on the
    device) loads into a plain one and back: `capturable` and `fused` are
    the loading run's."""
    p = torch.nn.Parameter(torch.ones(3))
    saved_by = torch.optim.Adam([p], lr=1e-3)
    p.grad = torch.full((3,), 0.5)
    saved_by.step()
    saved = saved_by.state_dict()
    saved["param_groups"][0].update(capturable=True, fused=True)
    q = torch.nn.Parameter(p.detach().clone())
    plain = torch.optim.Adam([q], lr=1e-3)
    _load_optimizer(plain, saved, {}, "layerNorm")
    assert plain.param_groups[0]["capturable"] is False
    assert not plain.param_groups[0]["fused"]
    q.grad = torch.full((3,), 0.5)
    plain.step()
    p.grad = torch.full((3,), 0.5)
    saved_by.step()
    assert torch.equal(p, q)


@pytest.mark.parametrize("device,ctc,route", [
    ("cuda", False, "graph"), ("cuda", True, "eager"),
    ("cpu", False, "eager"), ("cpu", True, "eager")])
def test_dispatch_route(device, ctc, route):
    """A card captures the N steps into a graph unless the criterion reads
    values on the host (torch's CUDA `ctc_loss` copies its lengths there);
    the CPU runs them eagerly."""
    criterion = (CTCPhoneCriterion(16, 5) if ctc else
                 CPCUnsupervisedCriterion(n_predicts=2, dim_ar=16,
                                          dim_enc=16,
                                          negative_sampling_ext=4))
    assert dispatch_route(torch.device(device), criterion) == route
