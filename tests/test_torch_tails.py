"""Ragged batches under ranks on the CPU (`cpc2_torch/train_tails.py`,
counterpart of `cpc2_tpu/train_tails.py`, and the weighted step of
`training.Trainer`), two `gloo` ranks as processes
(`tests/torch_ranks.py`), as `tests/test_pod_tail.py:45-130` holds the
JAX package's:

* the example-weighted step: a zero-weight row's content changes
  nothing (negatives that never sample it, layerNorm); all-ones weights
  give the plain step; and the step equals the JAX package's 2-device
  weighted step (`build_steps(example_weighted=True)`,
  `tests/torch_dp_reference.py`) from the same weights and negatives;
* `PodTailRunner`: ranks that buffered 2 and 1 short batches both run 2
  rounds (the second a filler on one), and stay bit for bit equal;
* `TailRunner`: a short batch that the ranks do not divide runs whole on
  every rank, its views augmented on the device, which stay bit for bit
  equal, and equal to the single process's step with the same
  generators;
* `route`, `PodTailRunner`'s padding and fillers (against the JAX
  package's) and `pack_windows` (how a short batch of
  `--corpus_on_device` is buffered).

Tolerances are `tests/test_torch_step.py`'s: rtol 1e-4, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import torch_dp_reference as ref
import torch_ranks
from cpc2_torch.data.dataset import pack_windows
from cpc2_torch.train_tails import route
from torch_ranks import N, S, W, WINDOW, port_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)
B, WORLD = 2, 2
VALID = np.array([1, 1, 1, 0], np.float32)     # rank 1's second row pads


def _batch(seed=0):
    return np.random.RandomState(seed).randn(B * WORLD, 2, 1, WINDOW).astype(
        np.float32)


def _negatives():
    """Each rank's negatives among its real rows only (rank 1: row 0)."""
    rs = np.random.RandomState(2)
    neg = rs.randint(0, B * S, size=(WORLD, B, N, W)).astype(np.int32)
    neg[1] = rs.randint(0, S, size=(B, N, W))
    return neg


@pytest.fixture(scope="module")
def runs():
    """One start of two ranks for every case, run while JAX takes its
    weighted step."""
    ranks = torch_ranks.Ranks(torch_ranks.cases, WORLD)
    monkeypatch = pytest.MonkeyPatch()
    try:
        before, ctx = ref.prepare(WORLD)
        argv = port_flags(**{"--batchSizeGPU": B})
        other = _batch()
        other[3] = np.random.RandomState(99).randn(2, 1, WINDOW)
        neg = [list(_negatives())]
        ranks.send([
            ("steps", (argv, *before, [_batch()], neg, [VALID])),
            ("steps", (argv, *before, [other], neg, [VALID])),
            ("steps", (argv, *before, [_batch()], neg, [np.ones(4)])),
            ("steps", (argv, *before, [_batch()], neg)),
            ("pod_tails", (argv,)),
            ("one_host_tail", (argv, _batch(5))),
        ])
        out_j, after_j, grads_j = ref.run(ctx, [_batch()], _negatives(),
                                          valid=[VALID],
                                          monkeypatch=monkeypatch)
    except BaseException:
        ranks.kill()
        raise
    finally:
        monkeypatch.undo()
    ranks = ranks.join()
    return before, (out_j, after_j, grads_j), ranks


def test_weighted_step_matches_jax(runs):
    _, (out_j, after_j, grads_j), ranks = runs
    got = ranks[0][0]
    np.testing.assert_allclose(got["steps"][0][0], out_j[0][0], **TOL)
    np.testing.assert_allclose(got["steps"][0][1], out_j[0][1], **TOL)
    moved = 0
    for name, g in grads_j.items():
        mask = np.abs(g) >= 1e-7
        moved += mask.sum()
        np.testing.assert_allclose(got["state"][name][mask],
                                   after_j[name][mask], err_msg=name, **TOL)
    assert moved > 0


def test_pad_rows_are_inert(runs):
    """Another content in the zero-weight row: the same losses, metrics
    and update, bit for bit."""
    _, _, ranks = runs
    for r in range(WORLD):
        a, b = ranks[r][0], ranks[r][1]
        for x, y in zip(a["steps"][0], b["steps"][0]):
            assert np.array_equal(x, y)
        for name in a["state"]:
            assert np.array_equal(a["state"][name], b["state"][name]), name


def test_all_ones_weights_are_the_plain_step(runs):
    _, _, ranks = runs
    w, plain = ranks[0][2], ranks[0][3]
    np.testing.assert_allclose(w["steps"][0][0], plain["steps"][0][0],
                               atol=1e-6)
    np.testing.assert_allclose(w["steps"][0][1], plain["steps"][0][1],
                               atol=1e-6)
    for name in plain["state"]:
        np.testing.assert_allclose(w["state"][name], plain["state"][name],
                                   atol=1e-5, err_msg=name)


def test_pod_tail_rounds_keep_the_ranks_in_sync(runs):
    _, _, ranks = runs
    a, b = ranks[0][4], ranks[1][4]
    assert [n for n, _, _ in a["rounds"]] == [1, 1]
    assert [n for n, _, _ in b["rounds"]] == [1, 0]      # then a filler
    for (_, la, aa), (_, lb, ab) in zip(a["rounds"], b["rounds"]):
        assert np.array_equal(la, lb) and np.array_equal(aa, ab)
        assert np.isfinite(la).all()
    for name in a["state"]:
        assert np.array_equal(a["state"][name], b["state"][name]), name


def test_one_host_tail_runs_whole_on_every_rank(runs):
    """Both ranks take the same step on the whole short batch, its views
    augmented from the tail runner's generator, not the rank's own (and
    after it a reduced step), and stay bit for bit equal; the tail step
    is the single process's on those rows from the same generators."""
    _, _, ranks = runs
    a, b = ranks[0][5], ranks[1][5]
    for key in ("after_tail", "state"):
        for name in a[key]:
            assert np.array_equal(a[key][name], b[key][name]), (key, name)
    assert torch.equal(a["generator"], b["generator"])
    assert torch.equal(a["augment_generator"], b["augment_generator"])
    from cpc2_torch.train_tails import TailRunner
    trainer = torch_ranks.trainer_of(None, port_flags(**{
        "--batchSizeGPU": B}), augment=True)
    losses, accs = TailRunner(torch.device("cpu"), 11).train(
        trainer, torch.from_numpy(_batch(5)[:3]))
    assert np.array_equal(losses.numpy(), a["tail"][0])
    one = torch_ranks.state(trainer.model, trainer.criterion)
    for name in one:
        assert np.array_equal(one[name], a["after_tail"][name]), name


class _Ranks:
    def __init__(self, world, pod):
        self.world, self.pod = world, pod


def test_route():
    assert route(8, 8, None) == "whole" and route(5, 8, None) == "whole"
    one_host = _Ranks(2, False)
    assert route(8, 8, one_host) == "rows"
    assert route(6, 8, one_host) == "rows"
    assert route(5, 8, one_host) == "alone"
    pod = _Ranks(2, True)
    assert route(4, 4, pod) == "whole" and route(3, 4, pod) == "tail"


@pytest.mark.parametrize("t,b", [(1, 2), (3, 4), (4, 4)])
def test_pod_tail_padding_matches_jax(t, b):
    """`PodTailRunner.padded` (cyclic repeat of a short batch's rows, its
    mask's past and future rows apart, 0/1 weights) and its fillers
    (the last item again, else zeros; weight 0) as the JAX package's
    `_padded` and `_filler`."""
    import argparse
    from cpc2_tpu.train_tails import PodTailRunner as JaxPodTailRunner
    from cpc2_torch.train_tails import PodTailRunner
    frames, window = 5, 32
    rs = np.random.RandomState(t * 10 + b)
    item = (rs.randn(t, 2, 1, window).astype(np.float32),
            np.arange(t), rs.randn(t, frames).astype(np.float32),
            rs.rand(2 * t, frames) > 0.5)
    args = argparse.Namespace(sizeWindow=window, cpc_mode="bert",
                              mask_prob=0.0)
    port = PodTailRunner(None, b, frames, window, True)
    jax_tails = JaxPodTailRunner(None, None, None, args, None, b, frames)

    def same(got, want):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(np.asarray(g), w)

    for with_quality in (True, False):
        same(port.filler(with_quality), jax_tails._filler(with_quality))
    port.add(item)
    jax_tails.add(item)
    same(port.padded(port.items[0]), jax_tails._padded(item))
    for with_quality in (True, False):
        same(port.filler(with_quality), jax_tails._filler(with_quality))


def test_pack_windows_are_the_loaders_windows():
    rs = np.random.RandomState(4)
    pack = rs.randn(10000).astype(np.float32)
    offsets = np.array([0, 17, 5000])
    got = pack_windows(pack, offsets, 320)
    assert got.shape == (3, 2, 1, 320)
    for i, o in enumerate(offsets):
        assert np.array_equal(got[i, 0, 0], pack[o:o + 320])
        assert np.array_equal(got[i, 1, 0], pack[o:o + 320])
