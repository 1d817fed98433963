"""The port's Common Voices CTC/PER evaluation against the JAX package's on
the CPU (`cpc2_torch.eval.common_voices_eval` against
`cpc2_tpu.eval.common_voices_eval`), at width 16 on utterances of at most
1 s: the dataset's items and batches under one `random` seed; the CTC
head's loss and gradients, `mean` and `sum`, with `seqNorm` and the LSTM
on and off, on a batch with a repeated label and an infeasible target; two
training steps frozen and unfrozen from the same weights, AdamW against
optax's `adamw` (the frozen model's decayed weights included); the
posteriors and the PER; each package's `checkpoint.pt` in the other's
`per`; the CLI's `train` then `per` on pre-computed features (`ID`); and
`-a` augmentations.

Tolerances: rtol 1e-5 for the loss, rtol 1e-4 and atol 1e-6 for gradients
and parameters after whole steps. The head's gradients reach 3 and more
(`sum` adds the batch's losses), and their entries near 0 carry the fp32
cancellation of those sums (2e-6 at a largest of 3), so a gradient's atol
is 1e-6 of its largest value where that is above 1e-6.
"""

import json
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpc2_torch.config import parse_args as train_parse_args
from cpc2_torch.eval import common_voices_eval as cv
from cpc2_torch.feature_loader import build_model
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.io.checkpoint import (load_torch_checkpoint, save_args,
                                      save_checkpoint, save_logs)

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-6)
C, N_PHONES = 16, 6


@pytest.fixture(scope="module")
def cv_corpus(tmp_path_factory):
    """4 WAV utterances of 0.6-1.0 s and their transcripts (one with
    repeated labels), and a port checkpoint at width 16 (random
    weights from a seed)."""
    from cpc2_torch.data.audio_io import save_wav
    root = tmp_path_factory.mktemp("cvdb")
    (root / "d").mkdir()
    rs = np.random.RandomState(0)
    lines = []
    for i in range(4):
        n = 9600 + 2133 * i
        x = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * np.arange(n) / 16000.)
             + 0.03 * rs.randn(n)).astype(np.float32)
        save_wav(str(root / "d" / f"utt{i:03d}.wav"), x, 16000)
        labels = [1, 1, 2, 4] if i == 1 else rs.randint(0, N_PHONES, 3 + i)
        lines.append(f"utt{i:03d} " + " ".join(map(str, labels)))
    work = tmp_path_factory.mktemp("cvwork")
    phones = work / "phones.txt"
    phones.write_text("\n".join(lines) + "\n")
    (work / "val.txt").write_text("utt001\nutt003\n")
    ck = work / "ck"
    ck.mkdir()
    torch.manual_seed(3)
    args = _model_args()
    save_checkpoint(build_model(args).state_dict(), {}, {}, None,
                    str(ck / "checkpoint_0.pt"))
    save_args(args, str(ck / "checkpoint_args.json"))
    save_logs({"epoch": [0]}, str(ck / "checkpoint_logs.json"))
    return root, work


def _seqs(root):
    from cpc2_torch.data.corpus import find_all_seqs
    return find_all_seqs(str(root), extension=".wav", loadCache=False)[0]


def test_dataset_matches_jax(cv_corpus):
    """Items with a random offset, and shuffled batches with the ragged
    tail, the same under the same `random` seed."""
    from cpc2_torch.data.corpus import parse_seq_labels
    from cpc2_tpu.eval import common_voices_eval as jcv
    root, work = cv_corpus
    labels, n_phones = parse_seq_labels(str(work / "phones.txt"))
    assert n_phones == N_PHONES
    out = []
    for mod in (jcv, cv):
        ds = mod.SingleSequenceDataset(str(root), _seqs(root), labels,
                                       random_offset_amplitude=80)
        random.seed(5)
        items = [ds[i] for i in range(len(ds))]
        batches = list(ds.batches(3))
        out.append((ds.maxSize, ds.maxSizePhone, items, batches))
    (size_j, ph_j, items_j, batches_j), (size_t, ph_t, items_t,
                                         batches_t) = out
    assert (size_j, ph_j) == (size_t, ph_t) == (16000 - 1, 6)
    for a, b in zip(items_j + batches_j, items_t + batches_t):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert [b[0].shape[0] for b in batches_t] == [3, 1]


def _criterion_inputs():
    rs = np.random.RandomState(1)
    c = rs.randn(4, 40, C).astype(np.float32)
    feature_size = np.array([40, 33, 24, 40], np.int32)
    # frames 9 (clipped), 8, 6, 9: a repeated label; 7 labels in 8
    # frames; 6 labels with 2 repeats in 6 frames (infeasible); one label
    label = np.array([[1, 1, 2, 3, 0, 0, 0], [0, 2, 4, 5, 1, 3, 2],
                      [3, 3, 3, 1, 2, 0, 0], [5, 0, 0, 0, 0, 0, 0]],
                     np.int32)
    label_size = np.array([4, 7, 6, 1], np.int32)
    return c, feature_size, label, label_size


def _jax_criterion(use_lstm, seq_norm, reduction, dim=C):
    from cpc2_tpu.eval import common_voices_eval as jcv
    crit = jcv.CTCPhoneCriterionCV(dim_encoder=dim, n_phones=N_PHONES,
                                   use_lstm=use_lstm, seq_norm=seq_norm,
                                   reduction=reduction)
    # as `main` inits it (the eager ops it compiles are then cached for
    # the CLI runs below)
    variables = crit.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jnp.zeros((2, 16, dim)), jnp.ones((2,), jnp.int32) * 8,
        jnp.zeros((2, 8), jnp.int32), jnp.ones((2,), jnp.int32),
        train=False)
    return crit, jax.tree_util.tree_map(np.asarray, variables['params'])


def _hold_grad(got, want, what):
    atol = max(STEP["atol"], 1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=STEP["rtol"], atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("reduction,seq_norm,use_lstm", [
    ("mean", False, False), ("sum", True, False), ("mean", True, True),
    ("sum", False, True)])
def test_criterion_matches_jax(reduction, seq_norm, use_lstm):
    """The loss (rtol 1e-5) and its gradients with respect to the features
    and every parameter (rtol 1e-4); the infeasible sample counts 0."""
    c, fs, label, ls = _criterion_inputs()
    crit_j, params = _jax_criterion(use_lstm, seq_norm, reduction)

    def loss_fn(p, x):
        return jnp.sum(crit_j.apply({'params': p}, x, fs, label, ls,
                                    train=False))
    loss_j, (gp_j, gc_j) = jax.value_and_grad(loss_fn, (0, 1))(
        params, jnp.asarray(c))

    crit = cv.CTCPhoneCriterionCV(C, N_PHONES, use_lstm=use_lstm,
                                  seq_norm=seq_norm, reduction=reduction)
    crit.load_state_dict(state_dict_from_jax(params))
    x = torch.from_numpy(c).requires_grad_(True)
    loss = crit(x, torch.from_numpy(fs), torch.from_numpy(label),
                torch.from_numpy(ls))
    assert loss.shape == (1, 1)
    loss.sum().backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **FWD)
    _hold_grad(x.grad.numpy(), np.asarray(gc_j), "features")
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))
    for key, p in crit.named_parameters():
        _hold_grad(p.grad.numpy(), want[key].numpy(), key)
    # the infeasible sample alone: no loss and no gradient
    one = crit(x[2:3], torch.from_numpy(fs[2:3]),
               torch.from_numpy(label[2:3]), torch.from_numpy(ls[2:3]))
    assert one.item() == 0.0


def _model_args():
    return train_parse_args(["--pathDB", ".", "--hiddenEncoder", str(C),
                             "--hiddenGar", str(C), "--sizeWindow", "3200"])


@pytest.fixture(scope="module")
def jax_model():
    """The JAX package's CPC model at width 16 (LSTM) and its initial
    params, as numpy."""
    from cpc2_tpu import feature_loader as fl
    from cpc2_tpu.config import get_default_cpc_config
    cfg = get_default_cpc_config()
    cfg.hiddenEncoder, cfg.hiddenGar = C, C
    cfg.sizeWindow, cfg.arMode = 3200, "LSTM"
    bundle = fl.init_model(cfg, seed=0)
    return bundle.module, jax.tree_util.tree_map(
        np.asarray, bundle.variables['params'])


def _step_batches():
    rs = np.random.RandomState(2)
    out = []
    for sizes, labels, label_sizes in (
            ([30, 22], [[1, 2, 2, 3], [4, 0, 0, 0]], [4, 1]),
            ([26, 30], [[0, 5, 1, 0], [3, 3, 2, 1]], [3, 4])):
        seq = rs.randn(2, 1, 4800).astype(np.float32)
        out.append((seq, np.asarray(sizes, np.int32),
                    np.asarray(labels, np.int64),
                    np.asarray(label_sizes, np.int32)))
    return out


@pytest.mark.parametrize("freeze", [True, False],
                         ids=["frozen", "unfrozen"])
def test_cv_steps_match_jax(jax_model, freeze):
    """Two training steps from the same weights:
    the losses, and every parameter after against optax's `adamw`
    (`multi_transform` with the model at lr / 10 unfrozen). Frozen, the
    model's weights move by the weight decay alone: that move is held to
    the JAX package's too."""
    from cpc2_tpu.eval import common_voices_eval as jcv
    lr = 1e-2
    module, model_params = jax_model
    crit_j, crit_params = _jax_criterion(freeze, freeze, "mean")
    params = {"model": model_params, "criterion": crit_params}
    start = jax.tree_util.tree_map(np.asarray, params)
    if freeze:
        tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8)
    else:
        tx = optax.multi_transform(
            {'criterion': optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8),
             'model': optax.adamw(lr / 10, b1=0.9, b2=0.999, eps=1e-8)},
            lambda p: {'model': 'model', 'criterion': 'criterion'})
    opt_state = tx.init(params)
    steps_j = jcv.CVSteps(module, crit_j, tx, freeze)
    batches = _step_batches()
    losses_j = []
    for i, (seq, size, label, label_size) in enumerate(batches):
        params, opt_state, loss = steps_j.train_batch(
            params, opt_state, seq[:, 0], size, label.astype(np.int32),
            label_size, jax.random.PRNGKey(i))
        losses_j.append(float(loss))
    after = jax.tree_util.tree_map(np.asarray, params)

    model = build_model(_model_args())
    model.load_state_dict(state_dict_from_jax(start["model"]))
    crit = cv.CTCPhoneCriterionCV(C, N_PHONES, use_lstm=freeze,
                                  seq_norm=freeze, reduction="mean")
    crit.load_state_dict(state_dict_from_jax(start["criterion"]))
    args = cv.parse_args(["train", "db", "p", "ck", "--lr", str(lr)]
                         + (["--freeze"] if freeze else []))
    steps = cv.CVSteps(model, crit, cv.make_optimizer(model, crit, args),
                       freeze)
    for batch, want in zip(batches, losses_j):
        np.testing.assert_allclose(steps.train_batch(*batch).item(), want,
                                   **STEP)
    decayed = 0
    for scope, module in (("model", model), ("criterion", crit)):
        want = state_dict_from_jax(after[scope])
        first = state_dict_from_jax(start[scope])
        for key, p in module.named_parameters():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, want[key].numpy(),
                                       err_msg=f"{scope}.{key}", **STEP)
            if scope == "model" and freeze:
                moved = got - first[key].numpy()
                decayed += int(np.count_nonzero(moved))
                np.testing.assert_allclose(
                    moved, want[key].numpy() - first[key].numpy(),
                    rtol=0, atol=1e-7, err_msg=key)
    assert decayed > 1000 or not freeze


def test_predictions_and_per_match_jax(cv_corpus, jax_model):
    """`predict_batch`'s posteriors and `per_step`'s PER on the corpus,
    from the same weights."""
    from cpc2_torch.data.corpus import parse_seq_labels
    from cpc2_tpu.eval import common_voices_eval as jcv
    root, work = cv_corpus
    labels, _ = parse_seq_labels(str(work / "phones.txt"))
    ds = cv.SingleSequenceDataset(str(root), _seqs(root), labels,
                                  random_offset_amplitude=0)
    module, model_params = jax_model
    crit_j, crit_params = _jax_criterion(True, True, "mean")
    params = {"model": model_params, "criterion": crit_params}
    steps_j = jcv.CVSteps(module, crit_j, optax.adamw(2e-4), True)
    model = build_model(_model_args())
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["model"])))
    crit = cv.CTCPhoneCriterionCV(C, N_PHONES, use_lstm=True, seq_norm=True)
    crit.load_state_dict(state_dict_from_jax(crit_params))
    steps = cv.CVSteps(model, crit, None, True)
    seq, size, _, _ = next(ds.batches(4, shuffle=False))
    np.testing.assert_allclose(
        steps.predict_batch(seq, size // 160),
        steps_j.predict_batch(params, seq[:, 0], size // 160), **FWD)
    per_j = jcv.per_step(ds, params, steps_j.predict_batch,
                         crit_j.blank_label, 3, 160)
    per_t = cv.per_step(ds, steps.predict_batch, crit.blank_label, 3, 160)
    assert per_t == per_j
    assert len(cv.LAST_RUN["pers"]) == len(ds) == 4


def _average_per(out: str) -> float:
    return float(re.findall(r"Average PER (\S+)", out)[-1])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_loads_in_the_other_per(cv_corpus, tmp_path, capsys,
                                           writer):
    """`main train` of one package (`--freeze --LSTM --seqNorm`, one
    epoch, `--pathVal`), then both packages' `main per` on its
    `checkpoint.pt`: the same PER."""
    from cpc2_tpu.eval import common_voices_eval as jcv
    root, work = cv_corpus
    out = tmp_path / "cvout"
    argv = ["train", str(root), str(work / "phones.txt"),
            str(work / "ck" / "checkpoint_0.pt"), "--freeze", "--LSTM",
            "--seqNorm", "--file_extension", ".wav", "--batchSize", "2",
            "--nEpochs", "1", "--pathVal", str(work / "val.txt"), "-o",
            str(out)]
    if writer == "jax":
        jcv.main(argv)
    else:
        best = cv.main(argv + ["--device", "cpu"])
        assert np.isfinite(best) and len(cv.LAST_RUN["epoch_s"]) == 1
    saved = load_torch_checkpoint(str(out / "checkpoint.pt"))
    assert set(saved) == {"classifier", "model", "bestLoss"}
    assert {"PhoneCriterionClassifier.weight",
            "conv1.weight_hh_l0"} <= set(saved["classifier"])
    capsys.readouterr()
    per = ["per", str(out), "--batchSize", "2", "--file_extension", ".wav"]
    jcv.main(per)
    per_j = _average_per(capsys.readouterr().out)
    per_t = cv.main(per + ["--device", "cpu"])
    assert per_t == pytest.approx(per_j, rel=1e-12)
    assert (out / "args_validation_0.json").exists()
    assert len(cv.LAST_RUN["pers"]) == 2


def test_main_on_precomputed_features(tmp_path):
    """`ID` mode: `.npy` features of `--in_dim` rows pass through to the
    head; `train` then `per` through the CLI, the model's state empty."""
    root = tmp_path / "feats" / "d"
    root.mkdir(parents=True)
    rs = np.random.RandomState(4)
    lines = []
    for i in range(4):
        np.save(str(root / f"f{i}.npy"),
                rs.randn(60 + 10 * i, 8).astype(np.float32))
        lines.append(f"f{i} " + " ".join(map(str, rs.randint(0, 5, 3))))
    phones = tmp_path / "phones.txt"
    phones.write_text("\n".join(lines) + "\n")
    out = tmp_path / "out"
    best = cv.main(["train", str(root.parent), str(phones), "ID",
                    "--in_dim", "8", "--file_extension", ".npy",
                    "--batchSize", "2", "--nEpochs", "2", "-o", str(out),
                    "--device", "cpu"])
    assert np.isfinite(best)
    saved = load_torch_checkpoint(str(out / "checkpoint.pt"))
    assert saved["model"] == {}
    per = cv.main(["per", str(out), "--file_extension", ".npy", "--device",
                   "cpu"])
    assert 0.0 <= per and len(cv.LAST_RUN["pers"]) == 4


def test_main_with_augments(cv_corpus, tmp_path):
    """`-a`: each JSON object an `AugmentCfg` of the chain applied to the
    training utterances (the JAX package's chain raises on every one:
    its `CombinedTransforms` hands `get_augment` the `AugmentCfg` as the
    type), with a random offset."""
    from cpc2_tpu.data.augmentation import AugmentCfg, CombinedTransforms
    cfgs = ['{"type": "bandreject", "bandreject_scaler": 1.0}',
            '{"type": "time_dropout", "t_ms": 50}']
    with pytest.raises(RuntimeError, match="Unknown augment_type"):
        CombinedTransforms([AugmentCfg(type="bandreject",
                                       bandreject_scaler=1.0)])
    root, work = cv_corpus
    np.random.seed(0)
    best = cv.main(["train", str(root), str(work / "phones.txt"),
                    str(work / "ck" / "checkpoint_0.pt"), "--freeze",
                    "--file_extension", ".wav", "--batchSize", "2",
                    "--nEpochs", "1", "-o", str(tmp_path / "out"),
                    "--roffset", "40", "--device", "cpu", "-a", *cfgs])
    assert np.isfinite(best)
    chain = cv._augments([json.loads(c) for c in cfgs])
    x = np.random.RandomState(1).randn(1, 3200).astype(np.float32)
    assert chain(x).shape == (1, 3200) and not np.array_equal(chain(x), x)
