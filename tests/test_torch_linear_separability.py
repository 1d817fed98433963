"""The port's linear-separability probe against the JAX package's on the
CPU: three train steps and a validation step of `ProbeSteps`, frozen and
`--unfrozen`, for speakers and phones, from the same weights on the same
batches; then `cpc2_torch.eval.linear_separability.main` on a tiny
checkpoint for speakers, phones, `--CTC`, `--get_encoded` and
`--unfrozen`.

Tolerances: rtol 1e-4, atol 1e-6 for the losses, accuracies and
parameters of whole steps.
"""

import glob
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from cpc2_torch.config import parse_args as train_parse_args
from cpc2_torch.eval import linear_separability as ls
from cpc2_torch.feature_loader import build_model
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.io.checkpoint import load_torch_checkpoint
from cpc2_torch.train import main as train_main

torch.set_num_threads(1)

STEP = dict(rtol=1e-4, atol=1e-6)
B, WINDOW, ENC, AR, N_SPK, N_PH = 4, 3200, 16, 24, 3, 5
FRAMES = WINDOW // 160


def _batches(kind, n=4, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        batch = rs.randn(B, 2, 1, WINDOW).astype(np.float32)
        if kind == "speaker":
            label = rs.randint(0, N_SPK, B).astype(np.int64)
        else:
            label = np.repeat(rs.randint(0, N_PH, (B, FRAMES // 4)), 4,
                              axis=1).astype(np.int64)
        out.append((batch, label))
    return out


def _probe_args(kind, unfrozen, get_encoded=False):
    return ls.parse_args(["db", "train.txt", "val.txt", "ck.pt",
                          "--device", "cpu", "--size_window", str(WINDOW)]
                         + (["--pathPhone", "p"] if kind == "phone" else [])
                         + (["--unfrozen"] if unfrozen else [])
                         + (["--get_encoded"] if get_encoded else []))


def _jax_probe(kind, unfrozen, get_encoded, batches):
    from cpc2_tpu import feature_loader as fl
    from cpc2_tpu.config import get_default_cpc_config
    from cpc2_tpu.eval import linear_separability as jls
    cfg = get_default_cpc_config()
    cfg.hiddenEncoder, cfg.hiddenGar = ENC, AR
    cfg.sizeWindow, cfg.arMode = WINDOW, "LSTM"
    bundle = fl.init_model(cfg, seed=0)
    args = _probe_args(kind, unfrozen, get_encoded)
    criterion, per_frame = jls.select_probe(
        args, ENC if get_encoded else AR, N_SPK, N_PH)
    crit_vars = jls._criterion_init(criterion, args, AR, ENC, per_frame)
    params = {"model": bundle.variables["params"],
              "criterion": crit_vars["params"]}
    start = jax.tree_util.tree_map(np.asarray, params)
    tx = optax.adam(args.lr, b1=args.beta1, b2=args.beta2, eps=args.epsilon)
    opt_state = tx.init(params)
    steps = jls.ProbeSteps(bundle.module, criterion, tx, unfrozen, None)
    out = []
    for i, (batch, label) in enumerate(batches[:-1]):
        params, opt_state, loss, acc = steps.train_batch(
            params, opt_state, batch, label.astype(np.int32),
            jax.random.PRNGKey(i))
        out.append((np.asarray(loss), np.asarray(acc)))
    val = steps.val_batch(params, batches[-1][0],
                          batches[-1][1].astype(np.int32))
    return (start, out, tuple(map(np.asarray, val)),
            jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("kind,unfrozen,get_encoded", [
    ("speaker", False, False), ("speaker", True, False),
    ("phone", False, False), ("phone", True, False),
    ("phone", False, True)])
def test_probe_steps_match_jax(kind, unfrozen, get_encoded):
    """Three train steps, then a validation step: each loss and accuracy,
    and every parameter after (frozen, the model's are unchanged)."""
    batches = _batches(kind)
    start, jax_out, jax_val, jax_after = _jax_probe(kind, unfrozen,
                                                    get_encoded, batches)
    args = _probe_args(kind, unfrozen, get_encoded)
    model = build_model(train_parse_args([
        "--pathDB", ".", "--hiddenEncoder", str(ENC), "--hiddenGar", str(AR),
        "--sizeWindow", str(WINDOW)]))
    model.load_state_dict(state_dict_from_jax(start["model"]))
    criterion = ls.select_probe(args, AR, ENC, N_SPK, N_PH)
    criterion.load_state_dict(state_dict_from_jax(start["criterion"]))
    params = list(criterion.parameters())
    if unfrozen:
        params = list(model.parameters()) + params
    steps = ls.ProbeSteps(model, criterion, torch.optim.Adam(
        params, lr=args.lr, betas=(args.beta1, args.beta2),
        eps=args.epsilon), unfrozen)
    for (batch, label), (loss_j, acc_j) in zip(batches, jax_out):
        loss, acc = steps.train_batch(batch, label)
        np.testing.assert_allclose(loss.numpy(), loss_j, **STEP)
        np.testing.assert_allclose(acc.numpy(), acc_j, **STEP)
    loss, acc = steps.val_batch(*batches[-1])
    np.testing.assert_allclose(loss.numpy(), jax_val[0], **STEP)
    np.testing.assert_allclose(acc.numpy(), jax_val[1], **STEP)
    for scope, module in (("model", model), ("criterion", criterion)):
        want = state_dict_from_jax(jax_after[scope])
        for key, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[key].numpy(),
                                       err_msg=f"{scope}.{key}", **STEP)
        if scope == "model" and not unfrozen:
            for key, p in module.named_parameters():
                assert torch.equal(p.detach(), state_dict_from_jax(
                    start["model"])[key]), key


def test_frozen_step_leaves_no_graph_on_the_model():
    """Frozen, the features carry no autograd history: the LSTM runs its
    forward only and the model gets no gradient."""
    args = _probe_args("speaker", False)
    model = build_model(train_parse_args([
        "--pathDB", ".", "--hiddenEncoder", str(ENC), "--hiddenGar", str(AR),
        "--sizeWindow", str(WINDOW)]))
    criterion = ls.select_probe(args, AR, ENC, N_SPK, N_PH)
    steps = ls.ProbeSteps(model, criterion, torch.optim.Adam(
        criterion.parameters()), False)
    batch, label = _batches("speaker", 1)[0]
    c, e = steps._features(torch.from_numpy(batch[:, 0, 0]), True)
    assert c.grad_fn is None and e.grad_fn is None and not model.training
    steps.train_batch(batch, label)
    assert all(p.grad is None for p in model.parameters())
    assert all(p.grad is not None for p in criterion.parameters())


def test_probe_flags():
    with pytest.raises(NotImplementedError, match="Data-parallel"):
        ls.parse_args(["db", "t", "v", "ck.pt", "--nGPU", "2"])
    args = ls.parse_args(["db", "t", "v", "a.pt", "b.pt"])
    assert args.nGPU == 1 and args.device == "cuda" and len(args.load) == 2
    assert args.save_step == args.n_epoch == 10


# ---------------------------------------------------------------------------
# The probe's command line on a tiny checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def probe_run(tmp_path_factory):
    """A 3-speaker WAV corpus, its phone labels, train and validation
    lists, and a one-epoch port checkpoint at width 16 / 24."""
    from cpc2_torch.data.audio_io import save_wav
    root = tmp_path_factory.mktemp("probe_db")
    rs = np.random.RandomState(7)
    names, lines = [], []
    for s in range(3):
        folder = root / f"s{s}" / "c"
        folder.mkdir(parents=True)
        for i in range(3):
            n = 28000
            t = np.arange(n) / 16000.0
            x = (0.3 * np.sin(2 * np.pi * (120 + 60 * s + 25 * i) * t)
                 + 0.04 * rs.randn(n)).astype(np.float32)
            name = f"s{s}-c-{i:04d}"
            save_wav(str(folder / f"{name}.wav"), x, 16000)
            names.append(name)
            lines.append(name + " " + " ".join(map(str, np.repeat(
                rs.randint(0, N_PH, n // 640), 4))))
    work = tmp_path_factory.mktemp("probe_work")
    (work / "phones.txt").write_text("\n".join(lines) + "\n")
    (work / "train.txt").write_text("\n".join(names[:6]) + "\n")
    (work / "val.txt").write_text("\n".join(names[6:]) + "\n")
    train_main(["--pathDB", str(root), "--file_extension", ".wav",
                "--device", "cpu", "--nEpoch", "1", "--hiddenEncoder",
                str(ENC), "--hiddenGar", str(AR), "--nPredicts", "2",
                "--negativeSamplingExt", "4", "--sizeWindow", str(WINDOW),
                "--batchSizeGPU", "4", "--random_seed", "3",
                "--n_process_loader", "1", "--pathCheckpoint",
                str(work / "ck")])
    return root, work


@pytest.mark.parametrize("extra", [
    [], ["--pathPhone"], ["--pathPhone", "--CTC"],
    ["--pathPhone", "--get_encoded"], ["--unfrozen"]],
    ids=["speaker", "phone", "ctc", "get_encoded", "unfrozen"])
def test_linear_separability_main(probe_run, tmp_path, extra):
    """One epoch: the best accuracy in [0, 1], `checkpoint_logs.json` with
    the reference's keys, and `checkpoint_0.pt` holding the model, the
    head and the best epoch's model."""
    root, work = probe_run
    flags = [str(work / "phones.txt") if f == "--pathPhone" else f
             for f in extra]
    if "--pathPhone" in extra:
        flags.insert(extra.index("--pathPhone"), "--pathPhone")
    out = tmp_path / "sep"
    acc = ls.main([str(root), str(work / "train.txt"), str(work / "val.txt"),
                   str(work / "ck" / "checkpoint_0.pt"), "--pathCheckpoint",
                   str(out), "--n_epoch", "1", "--batchSizeGPU", "4",
                   "--size_window", str(WINDOW), "--file_extension", ".wav",
                   "--device", "cpu", *flags])
    assert 0.0 <= acc <= 1.0
    logs = json.loads((out / "checkpoint_logs.json").read_text())
    assert logs["epoch"] == [0] and logs["iter"][0] > 0
    for key in ("locLoss_train", "locAcc_train", "locLoss_val",
                "locAcc_val"):
        assert np.isfinite(logs[key][0]).all(), key
    saved = load_torch_checkpoint(str(out / "checkpoint_0.pt"))
    assert set(saved) == {"gEncoder", "cpcCriterion", "optimizer", "best"}
    head = ("PhoneCriterionClassifier" if "--pathPhone" in extra
            else "linearSpeakerClassifier")
    assert set(saved["cpcCriterion"]) == {f"{head}.weight", f"{head}.bias"}
    base = load_torch_checkpoint(str(work / "ck" / "checkpoint_0.pt"))
    same = all(torch.equal(saved["gEncoder"][k], v)
               for k, v in base["gEncoder"].items())
    assert same != ("--unfrozen" in extra)
    assert json.loads((out / "checkpoint_args.json").read_text())[
        "unfrozen"] == ("--unfrozen" in extra)
    assert glob.glob(str(out / "checkpoint_*.pt")) == [
        os.path.join(str(out), "checkpoint_0.pt")]
    assert len(ls.LAST_RUN["train_step_ms"]) == logs["iter"][0]


def test_linear_separability_needs_a_card_unless_cpu(probe_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, work = probe_run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ls.main([str(root), str(work / "train.txt"), str(work / "val.txt"),
                 str(work / "ck" / "checkpoint_0.pt"), "--pathCheckpoint",
                 str(tmp_path / "sep"), "--file_extension", ".wav"])
