"""Data-parallel training of the port against the JAX package's on the CPU:
two `gloo` ranks as processes (`tests/torch_ranks.py`) against
`cpc2_tpu.training.build_steps` on a 2-device mesh of the forced CPU
devices (`tests/torch_dp_reference.py`), from the same weights
(`state_dict_from_jax`), batch and negatives (given per device), at a
tiny width (24 frames of 16 channels, 3 predictions, 4 negatives, 2
windows a rank, linear heads: no dropout).

It holds one step's losses, accuracies and parameters after Adam, and
with `--normMode batchNorm` the running statistics; the same step against
the port's single process on the global batch with `--neg_pool_group 2`
(each rank's pool, as the reference's DataParallel workers draw); 4 ranks
laid out as 2 nodes (`--dcn_axis_size 2`) against the flat 4; the file
split of `--distributed`; the loader-length guard; the SLURM and
torchrun fields and the resume's peek at `--distributed`; and the CLI at
`--device cpu --nGPU 2` for an epoch, its checkpoint and a resume.

Tolerances are `tests/test_torch_step.py`'s: rtol 1e-4, atol 1e-6 on
losses and accuracies; parameters after Adam at rtol 1e-4, atol 1e-6,
where the reference's gradient is at least 1e-7 (below that Adam's first
step is +-lr times the sign of a rounding error); the running mean at
rtol 1e-4, atol 1e-6.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_dp_reference as ref
import torch_ranks
from cpc2_tpu.parallel import distributed as jax_distributed
from cpc2_tpu.train import _peek_distributed as jax_peek
from cpc2_torch.data import filter_distributed
from cpc2_torch.parallel import (init_distributed_mode, peek_distributed,
                                 rank_layout)
from torch_ranks import N, S, W, WINDOW, port_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)
B, WORLD = 2, 2


def _batches(n_steps, seed=0, b=B * WORLD):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, 2, 1, WINDOW).astype(np.float32)
            for _ in range(n_steps)]


def _negatives(seed=1, world=WORLD, b=B):
    """(world, b, N, W) negatives, each rank's in its own pool."""
    rs = np.random.RandomState(seed)
    return rs.randint(0, b * S, size=(world, b, N, W)).astype(np.int32)


def _hold_params(got, want, grads, what):
    moved = total = 0
    for name, g in grads.items():
        mask = np.abs(g) >= 1e-7
        moved, total = moved + mask.sum(), total + mask.size
        np.testing.assert_allclose(got[name][mask], want[name][mask],
                                   err_msg=f"{what}: {name}", **TOL)
    assert moved > 0.5 * total


NORMS = ("layerNorm", "batchNorm")


@pytest.fixture(scope="module")
def port_runs():
    """One start of two ranks for every 2-rank case (the step from the
    JAX weights at each norm mode, the guard on equal and unequal lengths,
    the gathered pool, a drifted replica) and one of four ranks for the
    node layouts, both running while JAX takes its steps."""
    two = torch_ranks.Ranks(torch_ranks.cases, WORLD)
    _, model, crit = torch_ranks.build(port_flags())
    four = torch_ranks.Ranks(
        torch_ranks.layouts, 4, (0, 2), port_flags(**{"--batchSizeGPU": 1}),
        {k: v.numpy() for k, v in model.state_dict().items()},
        {k: v.numpy() for k, v in crit.state_dict().items()},
        _batches(3, seed=5, b=4))
    monkeypatch = pytest.MonkeyPatch()
    try:
        prepared = {norm: ref.prepare(WORLD, norm) for norm in NORMS}
        entries = [("steps", (port_flags(**{
            "--normMode": norm, "--batchSizeGPU": B}), *prepared[norm][0],
            _batches(1), [list(_negatives())])) for norm in NORMS]
        entries += [("check_lengths", ([[5, 1], [5, 1]],)),
                    ("check_lengths", ([[5, 1], [6, 1]],)),
                    ("gather", (3, 4, 7)),
                    ("drifted_replicas", ())]
        two.send(entries)
        jax_runs = {norm: ref.run(prepared[norm][1], _batches(1),
                                  _negatives(), monkeypatch=monkeypatch)
                    for norm in NORMS}
    except BaseException:
        two.kill()
        four.kill()
        raise
    finally:
        monkeypatch.undo()
    ranks, layouts = two.join(), four.join()
    return jax_runs, ranks, entries, layouts


@pytest.mark.parametrize("case,norm", [(0, "layerNorm"), (1, "batchNorm")])
def test_two_rank_step_matches_jax(port_runs, case, norm):
    jax_runs, ranks, _, _ = port_runs
    out_j, after_j, grads_j = jax_runs[norm]
    got = ranks[0][case]
    np.testing.assert_allclose(got["steps"][0][0], out_j[0][0], **TOL)
    np.testing.assert_allclose(got["steps"][0][1], out_j[0][1], **TOL)
    _hold_params(got["state"], after_j, grads_j, norm)
    if norm == "batchNorm":
        # the running mean as JAX's pmean of it; the running variance too
        # once flax's biased batch variance is scaled to torch's unbiased
        # one (n: a rank's 2B windows times the layer's frames; momentum
        # 0.1 from 1)
        from cpc2_torch.models.encoder import CONV_STACK
        frames = WINDOW
        for i, (k, s, p) in enumerate(CONV_STACK):
            frames = (frames + 2 * p - k) // s + 1
            n = 2 * B * frames
            name = f"model.gEncoder.batchNorm{i}"
            np.testing.assert_allclose(got["state"][name + ".running_mean"],
                                       after_j[name + ".running_mean"],
                                       **TOL)
            want = 0.9 + (after_j[name + ".running_var"] - 0.9) * n / (n - 1)
            np.testing.assert_allclose(got["state"][name + ".running_var"],
                                       want, err_msg=name, **TOL)


@pytest.mark.parametrize("case", [0, 1])
def test_ranks_stay_bit_for_bit_equal(port_runs, case):
    _, ranks, _, _ = port_runs
    a, b = ranks[0][case], ranks[1][case]
    for name in a["state"]:
        assert np.array_equal(a["state"][name], b["state"][name]), name
    for x, y in zip(a["steps"][0], b["steps"][0]):
        assert np.array_equal(x, y)


def test_two_ranks_equal_one_process_in_groups(port_runs):
    """The 2-rank step is the single process's step on the global batch
    with `--neg_pool_group 2` and the same negatives in global rows: the
    gradients, the losses and the parameters after Adam."""
    _, ranks, entries, _ = port_runs
    _, model_sd, crit_sd = entries[0][1][:3]
    neg = _negatives()
    glob = np.concatenate([neg[r] + r * B * S for r in range(WORLD)])
    one = torch_ranks.steps(None, port_flags(**{
        "--batchSizeGPU": B * WORLD, "--neg_pool_group": B}), model_sd,
        crit_sd, _batches(1), [glob])
    got = ranks[0][0]
    np.testing.assert_allclose(got["steps"][0][0], one["steps"][0][0], **TOL)
    np.testing.assert_allclose(got["steps"][0][1], one["steps"][0][1], **TOL)
    for name, g in one["grads"].items():
        atol = 1e-6 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got["grads"][name], g, rtol=1e-4,
                                   atol=atol, err_msg=name)
    _hold_params(got["state"], one["state"], one["grads"], "one process")


def test_loader_length_guard(port_runs):
    _, ranks, _, _ = port_runs
    assert ranks[0][2] is None and ranks[1][2] is None
    for r in range(WORLD):
        assert "diverge across ranks" in ranks[r][3]


def test_gather_pool_and_its_gradient(port_runs):
    """The pool is every rank's rows in rank order; a rank's gradient is
    the pool's gradient summed over the ranks, its own slice (the
    transpose of JAX's `all_gather`)."""
    _, ranks, _, _ = port_runs
    blocks = [np.random.RandomState(7 + r).randn(3, 4) for r in range(WORLD)]
    cot = np.random.RandomState(7).randn(WORLD * 3, 4)
    for r in range(WORLD):
        pool, grad = ranks[r][4]
        np.testing.assert_array_equal(pool, np.concatenate(blocks))
        np.testing.assert_array_equal(grad, WORLD * cot[3 * r:3 * r + 3])


def test_dcn_layout_matches_flat(port_runs):
    """4 ranks as 2 nodes of 2 (`--dcn_axis_size 2`) train bit for bit as
    the flat 4 (`tests/test_dcn_mesh.py::test_dcn_matches_flat`), over
    three steps of their own draws."""
    runs = port_runs[3]
    for r in range(4):
        flat, dcn = runs[r]
        assert dcn["layout"] == [[0, 1], [2, 3]]
        for (a, b), (c, d) in zip(flat["steps"], dcn["steps"]):
            assert np.array_equal(a, c) and np.array_equal(b, d)
        for name in flat["state"]:
            assert np.array_equal(flat["state"][name], dcn["state"][name])
    np.testing.assert_array_equal(rank_layout(4, 2), [[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="does not divide"):
        rank_layout(4, 3)


def test_replica_check_finds_a_drifted_rank(port_runs):
    """`check_replicas` raises on every rank when one rank's weight moved
    by 1e-6 (it passed after every `steps` case above)."""
    _, ranks, _, _ = port_runs
    for r in range(WORLD):
        assert "replicas differ in 1 of 2 tensors" in ranks[r][5]


@pytest.mark.parametrize("n,world", [(7, 2), (10, 3), (3, 4), (16, 4)])
def test_file_split_matches_jax(n, world):
    """`filter_distributed` cuts the files as `cpc2_tpu/train.py:531-543`
    does: rank r's [n r // world, n (r + 1) // world), which cover the
    list once, in order."""
    files = [(i % 3, f"f{i}") for i in range(n)]
    shards = [filter_distributed(files, r, world) for r in range(world)]
    for r, shard in enumerate(shards):
        assert shard == files[n * r // world:n * (r + 1) // world]
    assert sum(shards, []) == files


ENVS = {
    "slurm": {"SLURM_JOB_ID": "9", "SLURM_JOB_NUM_NODES": "2",
              "SLURM_NODEID": "1", "SLURM_LOCALID": "1",
              "SLURM_PROCID": "3", "SLURM_NTASKS": "4"},
    "torchrun": {"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "0",
                 "N_NODES": "2", "NODE_ID": "1"},
    "one": {},
}


@pytest.mark.parametrize("env", list(ENVS))
def test_distributed_fields_match_jax(env, monkeypatch):
    for name in ("SLURM_JOB_ID", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in ENVS[env].items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(jax.distributed, "initialize", lambda **k: None)
    got, want = type("A", (), {})(), type("A", (), {})()
    init_distributed_mode(got)
    jax_distributed.init_distributed_mode(want)
    assert vars(got) == vars(want)


def test_peek_distributed_matches_jax(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    argvs = [["--distributed"], ["--pathCheckpoint", str(ck)],
             ["--pathCheckpoint", str(ck), "--restart"],
             [f"--pathCheckpoint={ck}"]]
    for saved in (None, False, True):
        if saved is not None:
            (ck / "checkpoint_args.json").write_text(json.dumps(
                {"distributed": saved}))
            (ck / "checkpoint_logs.json").write_text("{}")
            torch.save({}, str(ck / "checkpoint_0.pt"))
        for argv in argvs:
            assert peek_distributed(argv) == jax_peek(argv), (saved, argv)
    assert peek_distributed(["--pathCheckpoint", str(ck)])


def test_cli_two_ranks_on_cpu_and_resume(mini_corpus, tmp_path):
    """`--device cpu --nGPU 2`: two ranks for an epoch, one checkpoint
    (rank 0's) whose weights load, and a resume to a second epoch that
    restores both ranks' generators; with `--global_negatives`,
    `--steps_per_dispatch 2` (its groups eager under `gloo`),
    `--corpus_on_device` (each rank's resident pack) and
    `--augment_on_device`, and same-speaker batches, whose short ones of
    an odd size run whole on both ranks (`TailRunner`): the epochs' ends
    hold the ranks' replicas equal (`check_replicas`)."""
    from cpc2_torch import feature_loader as fl
    from cpc2_torch.train import main
    ck = str(tmp_path / "ck")
    flags = ["--pathDB", str(mini_corpus), "--file_extension", ".wav",
             "--device", "cpu", "--nGPU", "2", "--hiddenEncoder", "16",
             "--hiddenGar", "16", "--nPredicts", "3",
             "--negativeSamplingExt", "4", "--sizeWindow", "3840",
             "--batchSizeGPU", "2", "--random_seed", "5",
             "--n_process_loader", "1", "--samplingType", "samespeaker",
             "--global_negatives", "--steps_per_dispatch", "2",
             "--corpus_on_device", "--augment_on_device", "--augment_past",
             "--augment_type", "bandreject"]
    record = main(flags + ["--nEpoch", "1", "--pathCheckpoint", ck])
    assert record["ranks"] == 2 and record["backend"] == "gloo"
    assert record["dispatch"] == "eager"
    assert record["alone_steps"] > 0
    assert len(record["dispatch_ms"]) < len(record["step_ms"])
    losses = np.asarray(record["logs"]["locLoss_train"])
    assert losses.shape == (1, 3) and np.isfinite(losses).all()
    assert sorted(os.listdir(ck)) == ["checkpoint_0.pt",
                                      "checkpoint_args.json",
                                      "checkpoint_logs.json"]
    saved = torch.load(os.path.join(ck, "checkpoint_0.pt"),
                       weights_only=False)
    assert len(saved["optimizer"]["rank_generator_states"]) == 2
    model, _, _ = fl.load_model([os.path.join(ck, "checkpoint_0.pt")])
    assert sum(p.numel() for p in model.parameters()) > 0
    resumed = main(["--pathCheckpoint", ck, "--nEpoch", "2", "--device",
                    "cpu", "--nGPU", "2"])
    assert resumed["logs"]["epoch"] == [0, 1]
    assert resumed["alone_steps"] > 0
    assert np.isfinite(np.asarray(resumed["step_losses"])).all()
    assert os.path.exists(os.path.join(ck, "checkpoint_1.pt"))
