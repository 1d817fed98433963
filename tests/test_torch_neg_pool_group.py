"""Grouped negative pools (`--neg_pool_group G`) in the port, held against
`cpc2_tpu` on the CPU at tiny shapes: each batch element draws its InfoNCE
negatives within its group of G contiguous elements, as each worker of the
reference's DataParallel run draws within its own shard.

Anchors, as `tests/test_neg_pool_group.py` sets them for the JAX package:
  * the draw stays in the group's rows; G = B is bit-identical to the
    whole-batch draw from the same generator; a batch of at most G, or one
    that G does not divide, pools over the whole batch;
  * the grouped criterion agrees with the JAX package's on the same
    group-local indices (losses and accuracies rtol 1e-5 / atol 1e-6,
    gradients rtol 1e-4 / atol 1e-6, dropout off), and equals independent
    per-group runs;
  * `negative_scores(group=)` agrees with the JAX package's Pallas kernel
    vmapped over the groups in interpret mode (scores rtol 1e-5 / atol
    1e-5, gradients rtol 1e-4 / atol 2e-5, the cotangent rounded to 16
    significant bits, as `tests/test_torch_kernels.py` holds the whole-pool
    kernel and for its reason: the Pallas kernel's bf16 planes);
  * the grouped dz plan tiles each group apart, covers every group's units
    once, fits shared memory, and one group is the whole pool's plan; its
    walk, emulated in float64 as the kernels take it, gives the plain
    version's dz;
  * the CLI refuses the flag beside `--global_negatives` and a G that does
    not divide `--batchSizeGPU`, with the JAX package's messages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.losses.criterion import (
    CPCUnsupervisedCriterion as JaxCriterion)
from cpc2_tpu.ops.infonce_pallas import negative_scores_pallas
from cpc2_torch.config import check_ported, parse_args
from cpc2_torch.losses import CPCUnsupervisedCriterion
from cpc2_torch.losses.criterion import sample_negative_indices
from cpc2_torch.ops.infonce import (SMEM_LIMIT, infonce_plan,
                                    negative_scores, negative_scores_plain)
from tests.test_torch_heads import hold_criterion

torch.set_num_threads(1)

CPU = torch.device("cpu")
B, S, D, K, N = 4, 16, 8, 2, 5
W = S - K


def _draw(seed, b, pool_group=None, s=S, n=N):
    gen = torch.Generator().manual_seed(seed)
    idx = sample_negative_indices(gen, b, s, n, s - K, CPU,
                                  pool_group=pool_group)
    return idx, gen


# --- the draw -------------------------------------------------------------

def test_draw_stays_in_its_group():
    g = 2
    idx, _ = _draw(0, 8, g)
    assert idx.shape == (8, N, W) and idx.dtype == torch.int32
    for b in range(8):
        lo = b // g * g * S
        assert lo <= int(idx[b].min()) and int(idx[b].max()) < lo + g * S
    # every element draws from its group's other element too
    own = torch.arange(8)[:, None, None]
    assert (idx // S != own).any(dim=2).any(dim=1).all()


def test_group_of_the_batch_is_the_whole_batch_draw():
    """G = B makes the same two `randint` draws: the same indices, and the
    generator left in the same state."""
    whole, gen_a = _draw(7, 8)
    grouped, gen_b = _draw(7, 8, 8)
    assert torch.equal(whole, grouped)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


def _criterion(neg_pool_group=0, b_s=S):
    torch.manual_seed(0)
    crit = CPCUnsupervisedCriterion(K, D, D, N, size_input_seq=b_s,
                                    rnn_mode="linear",
                                    neg_pool_group=neg_pool_group)
    return crit.eval()


def _features(b, seed=3):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(b, S, D).astype(np.float32)),
            torch.from_numpy(rs.randn(b, S, D).astype(np.float32)))


@pytest.mark.parametrize("b,g,pool", [(8, 4, 4), (4, 4, None),
                                      (2, 4, None), (6, 4, None)])
def test_criterion_draws_in_groups_or_over_the_batch(b, g, pool):
    """The criterion's own draw is `sample_negative_indices(pool_group=G)`
    where G divides a batch larger than G, else the whole-batch draw: the
    same losses as an ungrouped criterion given those indices."""
    c, e = _features(b)
    crit = _criterion(g)
    got = crit(c, e, torch.Generator().manual_seed(11))
    idx, _ = _draw(11, b, pool)
    want = _criterion(0)(c, e, negative_indices=idx)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# --- the criterion against cpc2_tpu, and per-group runs -------------------

def _group_local(seed, b, g):
    """(B, N, W) indices, each element's rows in its group's, by numpy."""
    rs = np.random.RandomState(seed)
    base = (np.arange(b) // g * g * S)[:, None, None]
    return (base + rs.randint(0, g * S, size=(b, N, W))).astype(np.int32)


def test_grouped_criterion_matches_jax():
    rs = np.random.RandomState(5)
    c = rs.randn(B, S, D).astype(np.float32)
    e = rs.randn(B, S, D).astype(np.float32)
    neg = _group_local(6, B, 2)
    jcrit = JaxCriterion(n_predicts=K, dim_ar=D, dim_enc=D,
                         negative_sampling_ext=N, size_input_seq=S,
                         rnn_mode="linear", neg_pool_group=2)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, cc, ee: jcrit.init(r, cc, ee, None, train=False))(
            {"params": jax.random.PRNGKey(3)}, jnp.asarray(c),
            jnp.asarray(e))["params"])
    crit = CPCUnsupervisedCriterion(K, D, D, N, size_input_seq=S,
                                    rnn_mode="linear", neg_pool_group=2)
    from cpc2_torch.io import state_dict_from_jax
    crit.load_state_dict(state_dict_from_jax(params))
    hold_criterion(jcrit, params, crit.eval(), c, e, neg)


def test_grouped_run_equals_per_group_runs():
    """G = 2 at B = 4 is two batch-2 runs, each over its own pool (indices
    rebased), averaged: the reference's 2-GPU DataParallel step."""
    c, e = _features(B, seed=8)
    idx = torch.from_numpy(_group_local(9, B, 2))
    got = _criterion(2)(c, e, negative_indices=idx)
    local = _criterion(0)
    parts = [local(c[i:i + 2], e[i:i + 2],
                   negative_indices=idx[i:i + 2] - i * S)
             for i in (0, 2)]
    for j, x in enumerate(got):
        want = (parts[0][j] + parts[1][j]) / 2
        torch.testing.assert_close(x, want, rtol=0, atol=1e-6)


# --- the op against the Pallas kernel vmapped over groups ------------------

@pytest.mark.parametrize("n_groups,g", [(2, 2), (4, 1)])
def test_grouped_scores_match_vmapped_pallas(n_groups, g):
    rs = np.random.RandomState(11)
    k, w, d, n, s = 3, 6, 16, 5, 8
    preds = rs.randn(n_groups, g, k, w, d).astype(np.float32)
    z = rs.randn(n_groups, g * s, d).astype(np.float32)
    idx = rs.randint(0, g * s, size=(n_groups, g, w, n)).astype(np.int32)
    cot = rs.randn(n_groups, g, k, w, n).astype(np.float32)
    cot = (cot.view(np.uint32) + np.uint32(0x80)
           & np.uint32(0xFFFFFF00)).view(np.float32)

    kernel = jax.vmap(functools.partial(negative_scores_pallas,
                                        interpret=True))
    out_j, vjp = jax.vjp(lambda a, zz: kernel(a, zz, jnp.asarray(idx)),
                         jnp.asarray(preds), jnp.asarray(z))
    dp_j, dz_j = vjp(jnp.asarray(cot))

    b = n_groups * g
    pt = torch.from_numpy(preds.reshape(b, k, w, d)).requires_grad_(True)
    zt = torch.from_numpy(z.reshape(b * s, d)).requires_grad_(True)
    base = (np.arange(n_groups) * g * s)[:, None, None, None]
    it = torch.from_numpy((idx + base).reshape(b, w, n))
    out = negative_scores(pt, zt, it, group=g)
    out.backward(torch.from_numpy(cot.reshape(b, k, w, n)))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(out_j).reshape(b, k, w, n),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(),
                               np.asarray(dp_j).reshape(b, k, w, d),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(zt.grad.numpy(),
                               np.asarray(dz_j).reshape(b * s, d),
                               rtol=1e-4, atol=2e-5)


# --- the grouped dz plan --------------------------------------------------

RECIPE = (64, 12, 116, 128, 256, 8192, 8)
ODD = (6, 5, 9, 20, 36, 120, 3)


def _kernels_take_groups(plan, b, w, p):
    """`csrc/infonce.cu:bwd_ok`'s conditions on the grouped fields."""
    groups = p // plan.group_rows
    return (p % plan.group_rows == 0 and plan.group_units % w == 0
            and b % (plan.group_units // w) == 0
            and b // (plan.group_units // w) == groups
            and plan.group_tiles * plan.pt >= plan.group_rows
            > (plan.group_tiles - 1) * plan.pt
            and plan.row_tiles == plan.group_tiles * groups)


def test_grouped_plan_at_the_recipe_and_an_odd_shape():
    """Batch 64 in groups of 8: 8 groups of 1,024 rows in 8 tiles each, 2
    splits of a group's 928 units (464 a dz CTA, not the whole pool's
    3,712); the odd shape's 60-row groups in one 64-row tile each."""
    b, k, w, n, d, p, g = RECIPE
    plan = infonce_plan(b, k, w, n, d, p, group=g)
    whole = infonce_plan(b, k, w, n, d, p)
    assert (plan.group_rows, plan.group_units, plan.group_tiles,
            plan.pt, plan.row_tiles, plan.splits) == (1024, 928, 8, 128,
                                                      64, 2)
    assert (whole.group_rows, whole.group_units, whole.row_tiles,
            whole.splits) == (8192, 7424, 64, 2)
    assert plan.group_units // plan.splits == 464
    assert whole.group_units // whole.splits == 3712
    # only the dz fields differ from the whole pool's plan
    assert plan._replace(group_rows=p, group_units=b * w,
                         group_tiles=plan.row_tiles) == whole
    odd = infonce_plan(*ODD[:6], group=ODD[6])
    assert (odd.group_rows, odd.group_units, odd.group_tiles, odd.pt,
            odd.row_tiles) == (60, 27, 1, 64, 2)
    for shape, pl in ((RECIPE, plan), (ODD, odd)):
        assert _kernels_take_groups(pl, shape[0], shape[2], shape[5])
        assert max(pl.fwd_smem, pl.bwd_smem) <= SMEM_LIMIT
        assert pl.row_tiles * pl.col_slices * pl.splits <= 132


@pytest.mark.parametrize("shape", [RECIPE, ODD, (8, 12, 116, 128, 256,
                                                 1024, 8)])
def test_one_group_is_the_whole_pool_plan(shape):
    b, k, w, n, d, p, _ = shape
    whole = infonce_plan(b, k, w, n, d, p)
    assert infonce_plan(b, k, w, n, d, p, group=b) == whole
    assert infonce_plan(b, k, w, n, d, p, group=2 * b) == whole
    assert (whole.group_rows, whole.group_units,
            whole.group_tiles) == (p, b * w, whole.row_tiles)


def test_plan_refuses_a_group_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        infonce_plan(8, 3, 5, 4, 16, 64, group=3)
    with pytest.raises(ValueError, match="must divide"):
        infonce_plan(4, 3, 5, 4, 16, 66, group=2)


def _emulate_dz(plan, b, w, idx, g, preds, p):
    """dz as the kernels take the plan, in float64: each (row tile, column
    slice, split) CTA walks its run of its group's units and adds the
    sampled rows of its tile; the partials sit at rows rt * pt of each
    split, and the sum reads pool row r from its group's tiles. Returns dz
    and how often each (tile, unit) pair was walked."""
    d = preds.shape[3]
    n = idx.shape[2]
    rows = plan.row_tiles * plan.pt
    partial = torch.zeros(plan.splits, rows, d, dtype=torch.float64)
    walked = torch.zeros(plan.row_tiles, b * w, dtype=torch.int64)
    gu = plan.group_units
    for tile in range(plan.row_tiles * plan.col_slices):
        rt = tile // plan.col_slices
        pg = rt // plan.group_tiles
        row0 = pg * plan.group_rows + rt % plan.group_tiles * plan.pt
        valid = min(plan.pt, (pg + 1) * plan.group_rows - row0)
        c0 = tile % plan.col_slices * plan.dzc
        c1 = min(d, c0 + plan.dzc)
        for s in range(plan.splits):
            for u in range(pg * gu + s * gu // plan.splits,
                           pg * gu + (s + 1) * gu // plan.splits):
                if c0 == 0:
                    walked[rt, u] += 1
                bi, wi = divmod(u, w)
                for j in range(n):
                    r = int(idx[bi, wi, j]) - row0
                    if 0 <= r < valid:
                        partial[s, rt * plan.pt + r, c0:c1] += (
                            g[bi, :, wi, j] @ preds[bi, :, wi, c0:c1])
    stride = plan.group_tiles * plan.pt
    src = [r // plan.group_rows * stride + r % plan.group_rows
           for r in range(p)]
    return partial.sum(0)[src], walked


@pytest.mark.parametrize("b,k,w,n,d,p,grp", [
    (6, 5, 9, 20, 36, 120, 3),     # 60-row groups in one 64-row tile each
    (4, 3, 3, 6, 8, 1040, 2),      # 520-row groups in several tiles
    (4, 2, 2, 4, 1032, 32, 2),     # two column slices of D
])
def test_grouped_walk_covers_each_group_once(b, k, w, n, d, p, grp):
    rs = np.random.RandomState(2)
    preds = torch.from_numpy(rs.randn(b, k, w, d))
    z = torch.from_numpy(rs.randn(p, d))
    rows = p // (b // grp)
    base = (np.arange(b) // grp * rows)[:, None, None]
    idx = torch.from_numpy(
        (base + rs.randint(0, rows, size=(b, w, n))).astype(np.int32))
    idx[:, :, ::3] = torch.from_numpy(
        np.broadcast_to(base + rows - 1, (b, w, 1)).astype(np.int32))
    g = torch.from_numpy(rs.randn(b, k, w, n))
    plan = infonce_plan(b, k, w, n, d, p, sms=7, group=grp)
    assert _kernels_take_groups(plan, b, w, p)
    dz, walked = _emulate_dz(plan, b, w, idx, g, preds, p)
    # every tile walks each unit of its own group once, no other unit
    for rt in range(plan.row_tiles):
        pg = rt // plan.group_tiles
        own = torch.zeros(b * w, dtype=torch.int64)
        own[pg * plan.group_units:(pg + 1) * plan.group_units] = 1
        assert torch.equal(walked[rt], own)
    zr = z.clone().requires_grad_(True)
    negative_scores_plain(preds, zr, idx).backward(g)
    torch.testing.assert_close(dz, zr.grad, rtol=1e-12, atol=1e-12)


# --- the CLI --------------------------------------------------------------

BASE = ["--pathDB", "db", "--file_extension", ".wav"]


def test_cli_refuses_the_flag_beside_global_negatives():
    with pytest.raises(ValueError, match="mutually exclusive"):
        parse_args(BASE + ["--neg_pool_group", "4", "--global_negatives"])


def test_cli_refuses_a_group_that_does_not_divide_the_batch():
    with pytest.raises(ValueError, match="must divide"):
        parse_args(BASE + ["--neg_pool_group", "3", "--batchSizeGPU", "8"])
    # a resume checks its saved flags the same way
    args = parse_args(BASE + ["--neg_pool_group", "4"])
    args.batchSizeGPU = 6
    with pytest.raises(ValueError, match="must divide"):
        check_ported(args)


def test_train_main_in_groups_on_cpu_and_resume(mini_corpus, tmp_path,
                                                monkeypatch):
    """`python -m cpc2_torch.train --neg_pool_group 2 --device cpu` trains
    at batch 4 in groups of 2, and a resume reads the flag back from
    `checkpoint_args.json` (and checks it again)."""
    from cpc2_torch import train
    built = []
    get_criterion = train.get_criterion

    def spy(*args, **kwargs):
        built.append(get_criterion(*args, **kwargs))
        return built[-1]
    monkeypatch.setattr(train, "get_criterion", spy)
    ck = str(tmp_path / "ck")
    record = train.main([
        "--pathDB", str(mini_corpus), "--file_extension", ".wav",
        "--device", "cpu", "--hiddenEncoder", "16", "--hiddenGar", "16",
        "--nPredicts", "3", "--negativeSamplingExt", "4",
        "--sizeWindow", "10240", "--batchSizeGPU", "4",
        "--neg_pool_group", "2", "--random_seed", "5", "--nEpoch", "1",
        "--n_process_loader", "1", "--pathCheckpoint", ck])
    assert np.isfinite(np.asarray(record["logs"]["locLoss_train"])).all()
    assert [c.neg_pool_group for c in built] == [2]
    args = parse_args(["--pathCheckpoint", ck, "--nEpoch", "2"])
    train._resume(args)
    assert args.neg_pool_group == 2 and args.batchSizeGPU == 4
    assert get_criterion(args).neg_pool_group == 2
