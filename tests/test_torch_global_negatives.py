"""`--global_negatives` of the port on the CPU: two `gloo` ranks
(`tests/torch_ranks.py`) whose InfoNCE pool is every rank's encodings
(`parallel.gather_pool`), against the JAX package's 2-device step
(`tests/torch_dp_reference.py`) and against the port's single process on
the global batch with the same indices over the whole pool (as
`tests/test_global_negatives.py:45-95` holds the JAX package's); the
draw over the gathered pool, one rank's pool being its own, and the
InfoNCE plan and counters of a gathered pool. The CLI's
`--global_negatives` runs in `tests/test_torch_ddp.py`.

Tolerances are `tests/test_torch_step.py`'s: rtol 1e-4, atol 1e-6 on
losses, accuracies and gradients (gradients with atol 1e-6 of the
tensor's largest value), and parameters after Adam where the reference's
gradient is at least 1e-7.
"""

import numpy as np
import pytest
import torch

import torch_dp_reference as ref
import torch_ranks
from cpc2_torch.losses import sample_negative_indices
from cpc2_torch.ops import infonce
from torch_ranks import N, S, W, WINDOW, port_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)
B, WORLD = 2, 2


def _inputs():
    rs = np.random.RandomState(3)
    batch = rs.randn(B * WORLD, 2, 1, WINDOW).astype(np.float32)
    # each rank's indices over the whole pool of WORLD x B x S rows, with
    # collisions on a positive of each rank (`test_global_negatives.py`)
    neg = rs.randint(0, WORLD * B * S, size=(WORLD, B, N, W)).astype(
        np.int32)
    neg[0, 0, 0, 0] = 0 * B * S + 1         # rank 0's (b 0, k 1, w 0)
    neg[1, 0, 0, 0] = 1 * B * S + 1         # rank 1's
    return batch, neg


def _hold_params(got, want, grads, what):
    moved = total = 0
    for name, g in grads.items():
        mask = np.abs(g) >= 1e-7
        moved, total = moved + mask.sum(), total + mask.size
        np.testing.assert_allclose(got[name][mask], want[name][mask],
                                   err_msg=f"{what}: {name}", **TOL)
    assert moved > 0.5 * total


@pytest.fixture(scope="module")
def runs():
    """The ranks' step, run while JAX takes its own."""
    batch, neg = _inputs()
    ranks = torch_ranks.Ranks(torch_ranks.steps, WORLD)
    monkeypatch = pytest.MonkeyPatch()
    try:
        before, ctx = ref.prepare(WORLD, global_negatives=True)
        ranks.send(port_flags(**{"--batchSizeGPU": B,
                                 "--global_negatives": True}),
                   *before, [batch], [list(neg)])
        out_j, after_j, grads_j = ref.run(ctx, [batch], neg,
                                          monkeypatch=monkeypatch)
    except BaseException:
        ranks.kill()
        raise
    finally:
        monkeypatch.undo()
    ranks = ranks.join()
    return before, (out_j, after_j, grads_j), ranks


def test_two_rank_global_step_matches_jax(runs):
    _, (out_j, after_j, grads_j), ranks = runs
    got = ranks[0]
    np.testing.assert_allclose(got["steps"][0][0], out_j[0][0], **TOL)
    np.testing.assert_allclose(got["steps"][0][1], out_j[0][1], **TOL)
    _hold_params(got["state"], after_j, grads_j, "jax")
    for name in got["state"]:
        assert np.array_equal(got["state"][name], ranks[1]["state"][name])


def test_two_rank_global_step_is_one_process_over_the_pool(runs):
    """The gathered pool of the ranks' halves is the global batch's pool:
    the single process's step on the global batch with the same indices
    gives the same losses, gradients and parameters."""
    before, _, ranks = runs
    batch, neg = _inputs()
    one = torch_ranks.steps(None, port_flags(**{
        "--batchSizeGPU": B * WORLD}), *before, [batch],
        [np.concatenate(list(neg))])
    got = ranks[0]
    np.testing.assert_allclose(got["steps"][0][0], one["steps"][0][0], **TOL)
    np.testing.assert_allclose(got["steps"][0][1], one["steps"][0][1], **TOL)
    for name, g in one["grads"].items():
        atol = 1e-6 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got["grads"][name], g, rtol=1e-4,
                                   atol=atol, err_msg=name)
    _hold_params(got["state"], one["state"], one["grads"], "one process")


def test_sampled_indices_span_the_gathered_pool():
    gen = torch.Generator()
    gen.manual_seed(0)
    idx = sample_negative_indices(gen, 2, S, 64, W, torch.device("cpu"),
                                  pool_batch=8).numpy()
    assert idx.min() >= 0 and idx.max() < 8 * S
    assert idx.max() >= 2 * S          # the widened pool is used
    with pytest.raises(ValueError, match="mutually exclusive"):
        sample_negative_indices(gen, 4, S, 4, W, torch.device("cpu"),
                                pool_group=2, pool_batch=8)


class _OneRank:
    """A pool of one rank (no collective is ever made on it)."""
    world, rank = 1, 0


def test_one_rank_pool_is_the_local_one():
    """A batch on one rank is its own pool: the criterion given a one-rank
    pool scores as without one, bit for bit."""
    _, _, crit = torch_ranks.build(port_flags())
    rs = np.random.RandomState(8)
    c = torch.from_numpy(rs.randn(B, S, 16).astype(np.float32))
    e = torch.from_numpy(rs.randn(B, S, 16).astype(np.float32))
    neg = torch.from_numpy(_inputs()[1][0] % (B * S))
    for u, v in zip(crit(c, e, None, neg), crit(c, e, None, neg,
                                                pool=_OneRank())):
        assert torch.equal(u, v)


def test_gathered_plan_and_counters():
    """The kernels' plan at the gathered pool of the recipe (2 ranks x 8 x
    128 rows against 8 local elements): one group of every pool row,
    tiles over all of them; its launches count as `infonce_*_gathered`;
    the wrapper takes a pool of equal rank shares and no group."""
    b, k, w, n, d, ranks = 8, 12, 116, 128, 256, 2
    p = ranks * b * 128
    plan = infonce.infonce_plan(b, k, w, n, d, p)
    assert plan.group_rows == p and plan.group_units == b * w
    assert plan.row_tiles * plan.pt >= p
    assert plan == infonce.infonce_plan(b, k, w, n, d, p, group=None)
    assert infonce._counters(plan, p, ranks) == ("infonce_fwd_gathered",
                                                 "infonce_bwd_gathered")
    assert infonce._counters(plan, p, 1) == ("infonce_fwd", "infonce_bwd")
    assert {"infonce_fwd_gathered", "infonce_bwd_gathered"} <= set(
        infonce._build.KERNELS)
    preds, z = torch.zeros(2, 3, 4, 8), torch.zeros(2 * 2 * 7, 8)
    idx = torch.zeros(2, 4, 5, dtype=torch.int32)
    assert infonce.negative_scores(preds, z, idx, ranks=2).shape == (
        2, 3, 4, 5)
    with pytest.raises(ValueError, match="no group"):
        infonce.negative_scores(preds, z, idx, group=1, ranks=2)
    with pytest.raises(ValueError, match="does not split"):
        infonce.negative_scores(preds, z[:27], idx, ranks=2)


def test_gathered_pool_walk_computes_the_function():
    """The plan's decomposition at a gathered pool (the local units'
    samples over 2 ranks' rows), emulated in float64 as the kernels walk
    it (`tests/test_torch_kernels.py:_emulate_walk`), gives the plain
    version's scores and gradients, rows no local unit sampled at 0."""
    from test_torch_kernels import _emulate_walk
    b, k, w, n, d, s, ranks = 2, 3, 5, 12, 16, 8, 2
    p = ranks * b * s
    rs = np.random.RandomState(6)
    preds = torch.from_numpy(rs.randn(b, k, w, d))
    z = torch.from_numpy(rs.randn(p, d))
    idx = torch.from_numpy(rs.randint(0, p, size=(b, w, n)).astype(np.int32))
    g = torch.from_numpy(rs.randn(b, k, w, n))
    plan = infonce.infonce_plan(b, k, w, n, d, p, sms=7)
    out, dpreds, dz = _emulate_walk(plan, preds, z, idx, g)
    pr, zr = preds.clone().requires_grad_(True), z.clone().requires_grad_(True)
    want = infonce.negative_scores_plain(pr, zr, idx)
    want.backward(g)
    for got, exp in ((out, want.detach()), (dpreds, pr.grad), (dz, zr.grad)):
        torch.testing.assert_close(got, exp, rtol=1e-12, atol=1e-12)
    unsampled = np.setdiff1d(np.arange(p), idx.numpy().ravel())
    assert len(unsampled) and not dz[unsampled].any()
