"""The port's supervised path against the JAX package's on the CPU: the
phone-label parser, phone-labelled batches, the supervised criteria (loss,
accuracy, the gradients of their inputs and weights), their state-dict keys
and optax leaf order, the CTC decoding and PER tools, two whole training
steps for speaker, phone and CTC, and `cpc2_torch.train.main
--supervised`, its checkpoint's heads and their reload with
`--loadCriterion`.

Tolerances: forwards rtol 1e-5, atol 1e-6; gradients and whole steps rtol
1e-4, atol 1e-6; the CTC loss as each test states.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.data.corpus import find_all_seqs as jax_find_all_seqs
from cpc2_tpu.data.corpus import parse_seq_labels as jax_parse_seq_labels
from cpc2_tpu.data.dataset import AudioBatchData as JaxAudioBatchData
from cpc2_tpu.io.torch_ckpt import params_to_torch_state_dict
from cpc2_tpu.losses import criterion as jc
from cpc2_tpu.losses import seq_alignment as jsa
from cpc2_torch.config import parse_args
from cpc2_torch.data import AudioBatchData, find_all_seqs, parseSeqLabels
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.io.checkpoint import load_torch_checkpoint
from cpc2_torch.io.from_jax import jax_param_order
from cpc2_torch.losses import criterion as pc
from cpc2_torch.losses import seq_alignment as psa
from cpc2_torch.train import main

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Corpus with phone labels
# ---------------------------------------------------------------------------

def _write_phone_labels(path, names_lengths, n_phones=6, seed=1):
    """One line a sequence: runs of 1-6 equal phones, one every 160
    samples, covering a little less than the file (the dataset cuts the
    file to its labels)."""
    rs = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for name, n in names_lengths:
            n_labels = n // 160 - int(rs.randint(0, 4))
            runs = np.repeat(rs.randint(0, n_phones, n_labels),
                             rs.randint(1, 7, n_labels))[:n_labels]
            fh.write(name + " " + " ".join(map(str, runs)) + "\n")


@pytest.fixture(scope="module")
def phone_corpus(tmp_path_factory):
    """3 speakers x 3 WAV files of 28,000-33,000 samples in
    speaker/chapter/file layout, and their phone labels."""
    from cpc2_torch.data.audio_io import save_wav
    root = tmp_path_factory.mktemp("phone_db")
    rs = np.random.RandomState(7)
    names = []
    for s in range(3):
        folder = root / f"s{s}" / "c"
        folder.mkdir(parents=True)
        for i in range(3):
            n = 28000 + 2500 * i
            t = np.arange(n) / 16000.0
            x = (0.3 * np.sin(2 * np.pi * (120 + 60 * s + 25 * i) * t)
                 + 0.04 * rs.randn(n)).astype(np.float32)
            name = f"s{s}-c-{i:04d}"
            save_wav(str(folder / f"{name}.wav"), x, 16000)
            names.append((name, n))
    labels = root.parent / (root.name + "_phones.txt")
    _write_phone_labels(str(labels), names)
    return root, str(labels), [name for name, _ in names]


def test_parse_seq_labels_matches_jax(phone_corpus):
    _root, labels, names = phone_corpus
    got, n_got = parseSeqLabels(labels)
    want, n_want = jax_parse_seq_labels(labels)
    assert got == want and n_got == n_want
    assert got["step"] == 160 and set(names) <= set(got)


def _datasets(root, labels, window=3200):
    seqs, speakers = find_all_seqs(str(root), extension=".wav")
    jax_seqs, jax_speakers = jax_find_all_seqs(str(root), extension=".wav")
    assert seqs == jax_seqs and speakers == jax_speakers
    phones = None if labels is None else parseSeqLabels(labels)[0]
    random.seed(0)
    port = AudioBatchData(str(root), window, seqs, phones, len(speakers),
                          nProcessLoader=1)
    random.seed(0)
    ref = JaxAudioBatchData(str(root), window, jax_seqs, phones,
                            len(jax_speakers), nProcessLoader=1)
    return port, ref


@pytest.mark.parametrize("mode", ["phones", "speakers", "double"])
def test_get_batch_with_phone_labels_matches_jax(phone_corpus, mode):
    """Per-frame phones (the sequences cut to their labels), speakers
    without labels, and speakers then phones with `doubleLabels`: the
    waveforms and every label bit for bit, batch by batch through the
    loader with `remove_artefacts` (which reads the cut `seqLabel`), and at
    given indices."""
    root, labels, _names = phone_corpus
    port, ref = _datasets(root, None if mode == "speakers" else labels)
    try:
        if mode == "double":
            port.doubleLabels = ref.doubleLabels = True
        assert port.seqLabel == ref.seqLabel
        assert port.data.shape == ref.data.shape
        idx = [0, 1000, 20000, len(port.data) - 3200]
        got, want = port.get_batch(idx), ref.get_batch(idx)
        assert len(got) == len(want) == (3 if mode == "double" else 2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if mode == "phones":
            assert got[1].shape == (4, 20) and got[1].dtype == np.int64
        loaders = []
        for dataset in (port, ref):
            random.seed(3)
            np.random.seed(3)
            loaders.append(list(dataset.getDataLoader(
                4, "samespeaker", True, remove_artefacts=True)))
        assert len(loaders[0]) == len(loaders[1]) > 2
        for g_batch, w_batch in zip(*loaders):
            for g, w in zip(g_batch, w_batch):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    finally:
        port.close()
        ref.reload_pool.shutdown(wait=True)


def test_reset_phone_labels_matches_jax(phone_corpus):
    root, labels, _names = phone_corpus
    phones = parseSeqLabels(labels)[0]
    port, ref = _datasets(root, None)
    try:
        port.resetPhoneLabels(phones, 160)
        ref.resetPhoneLabels(phones, 160)
        assert port.phoneStep == ref.phoneStep == 20
        assert port.seqLabel == ref.seqLabel
        for g, w in zip(port.get_batch([5, 321]), ref.get_batch([5, 321])):
            np.testing.assert_array_equal(g, w)
    finally:
        port.close()
        ref.reload_pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# Criteria
# ---------------------------------------------------------------------------

B, T, DIM_AR, DIM_ENC, N_SPK, N_PH = 3, 12, 24, 16, 5, 6


def _inputs(kind, seed=0):
    rs = np.random.RandomState(seed)
    c = rs.randn(B, T, DIM_AR).astype(np.float32)
    e = rs.randn(B, T, DIM_ENC).astype(np.float32)
    if kind == "speaker":
        label = rs.randint(0, N_SPK, B).astype(np.int64)
    elif kind == "ctc_infeasible":
        # 16 labels on 12 frames: sample 0 collapses to 16, more than the
        # frames (no alignment), the others to 4 and 16 -> 2 runs
        label = np.stack([np.arange(16) % N_PH,
                          np.repeat([1, 4, 2, 3], 4),
                          np.repeat([5, 0], 8)]).astype(np.int64)
    else:
        label = np.repeat(rs.randint(0, N_PH, (B, T // 2)), 2,
                          axis=1).astype(np.int64)
        label[1, ::3] = 2            # ragged collapsed lengths
    return c, e, label


# (name, JAX module, port module, input kind, label or None)
def _cases():
    return {
        "speaker": (jc.SpeakerCriterion(dim_encoder=DIM_AR,
                                        n_speakers=N_SPK),
                    pc.SpeakerCriterion(DIM_AR, N_SPK), "speaker"),
        "adv_speaker": (jc.AdvSpeakerCriterion(dim_encoder=DIM_AR,
                                               n_speakers=N_SPK),
                        pc.AdvSpeakerCriterion(DIM_AR, DIM_ENC, N_SPK),
                        "speaker"),
        "adv_speaker_no_label": (
            jc.AdvSpeakerCriterion(dim_encoder=DIM_AR, n_speakers=N_SPK),
            pc.AdvSpeakerCriterion(DIM_AR, DIM_ENC, N_SPK), "none"),
        "adv_speaker_on_encoder": (
            jc.AdvSpeakerCriterion(dim_encoder=DIM_ENC, n_speakers=N_SPK,
                                   on_encoder=True),
            pc.AdvSpeakerCriterion(DIM_AR, DIM_ENC, N_SPK, on_encoder=True),
            "speaker"),
        "phone": (jc.PhoneCriterion(dim_encoder=DIM_AR, n_phones=N_PH),
                  pc.PhoneCriterion(DIM_AR, DIM_ENC, N_PH), "phone"),
        "phone_on_encoder": (
            jc.PhoneCriterion(dim_encoder=DIM_ENC, n_phones=N_PH,
                              on_encoder=True),
            pc.PhoneCriterion(DIM_AR, DIM_ENC, N_PH, on_encoder=True),
            "phone"),
        "phone_3_levels": (
            jc.PhoneCriterion(dim_encoder=DIM_AR, n_phones=N_PH, n_layers=3),
            pc.PhoneCriterion(DIM_AR, DIM_ENC, N_PH, n_layers=3), "phone"),
        "phone_3_levels_on_encoder": (
            jc.PhoneCriterion(dim_encoder=DIM_ENC, n_phones=N_PH,
                              on_encoder=True, n_layers=3),
            pc.PhoneCriterion(DIM_AR, DIM_ENC, N_PH, on_encoder=True,
                              n_layers=3), "phone"),
        "ctc": (jc.CTCPhoneCriterion(dim_encoder=DIM_AR, n_phones=N_PH),
                pc.CTCPhoneCriterion(DIM_AR, N_PH), "phone"),
        "ctc_infeasible": (
            jc.CTCPhoneCriterion(dim_encoder=DIM_AR, n_phones=N_PH),
            pc.CTCPhoneCriterion(DIM_AR, N_PH), "ctc_infeasible"),
    }


def _jax_run(module, c, e, label):
    lab = None if label is None else jnp.asarray(label.astype(np.int32))
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(c),
                            jnp.asarray(e), lab)
    params = variables["params"]

    def loss_fn(p, cc, ee):
        loss, acc = module.apply({"params": p}, cc, ee, lab)
        return jnp.sum(loss), (loss, acc)

    (_, (loss, acc)), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(c),
                                                  jnp.asarray(e))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), np.asarray(loss), np.asarray(acc), to_np(grads)


def _port_run(module, params, c, e, label):
    module.load_state_dict(state_dict_from_jax(params))
    ct = torch.from_numpy(c).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    lab = None if label is None else torch.from_numpy(label)
    loss, acc = module(ct, et, lab)
    loss.sum().backward()
    return loss, acc, ct.grad, et.grad


@pytest.mark.parametrize("name", list(_cases()))
def test_criterion_matches_jax(name):
    """Loss and accuracy at the forward tolerance, the gradients of the
    context, the encodings and every weight at the gradient tolerance.
    The CTC losses: torch's alignment sums against optax's, both in fp32
    log space in another order, rtol 1e-5 of the loss."""
    jax_mod, port_mod, kind = _cases()[name]
    c, e, label = _inputs("speaker" if kind == "none" else kind)
    label = None if kind == "none" else label
    params, loss_j, acc_j, (g_params, g_c, g_e) = _jax_run(jax_mod, c, e,
                                                           label)
    loss, acc, g_ct, g_et = _port_run(port_mod, params, c, e, label)
    assert tuple(loss.shape) == loss_j.shape
    assert tuple(acc.shape) == acc_j.shape == (1, 1)
    np.testing.assert_allclose(loss.detach().numpy(), loss_j, **FWD)
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    for got, want in ((g_ct, g_c), (g_et, g_e)):
        np.testing.assert_allclose(
            np.zeros_like(want) if got is None else got.numpy(), want,
            **GRAD)
    want = state_dict_from_jax(g_params)
    got = {k: p.grad for k, p in port_mod.named_parameters()}
    assert set(got) == set(want)
    for key, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want[key].numpy(),
                                   err_msg=key, **GRAD)
    if name == "ctc_infeasible":
        # sample 0 has more collapsed labels than frames: it counts 0
        sizes = pc.collapse_label_chain_padded(torch.from_numpy(label))[1]
        assert sizes[0].item() > T and (sizes[1:] <= T).all()
        assert np.isfinite(loss_j).all() and loss.item() > 0


def test_ctc_on_encoder_raises():
    with pytest.raises(ValueError, match="not implemented"):
        pc.CTCPhoneCriterion(DIM_AR, N_PH, on_encoder=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collapse_label_chain_padded_matches_jax(seed):
    rs = np.random.RandomState(seed)
    labels = np.repeat(rs.randint(0, 4, (5, 9)), rs.randint(1, 4),
                       axis=1).astype(np.int64)
    labels[seed] = labels[seed, 0]            # one run over the whole row
    got, sizes = pc.collapse_label_chain_padded(torch.from_numpy(labels))
    want, want_sizes = jc.collapse_label_chain_padded(
        jnp.asarray(labels.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))


@pytest.mark.parametrize("name", ["speaker", "adv_speaker_on_encoder",
                                  "phone", "phone_3_levels_on_encoder",
                                  "ctc"])
def test_criterion_state_dict_keys_match_jax(name):
    """The port head's state-dict keys are the JAX package's own converter's
    (`params_to_torch_state_dict`), `state_dict_from_jax` gives its
    values, and `jax_param_order` is `tree_leaves`' order and shapes."""
    jax_mod, port_mod, kind = _cases()[name]
    c, e, label = _inputs(kind)
    params = _jax_run(jax_mod, c, e, label)[0]
    want = params_to_torch_state_dict(params)
    assert set(port_mod.state_dict()) == set(want)
    for key, value in state_dict_from_jax(params).items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]))
    leaves = jax.tree_util.tree_flatten_with_path({"criterion": params})[0]
    assert jax_param_order({"criterion": port_mod}) == [
        (tuple(str(getattr(k, "key", k)) for k in path), tuple(v.shape))
        for path, v in leaves]


def test_model_criterion_combined():
    from cpc2_torch.feature_loader import build_model
    args = parse_args(["--pathDB", ".", "--hiddenEncoder", "16",
                       "--hiddenGar", "24", "--sizeWindow", "1920"])
    model = build_model(args)
    crit = pc.PhoneCriterion(24, 16, N_PH)
    combined = pc.ModelCriterionCombined(model, crit)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 1920).astype(
        np.float32))
    label = torch.zeros((2, 12), dtype=torch.int64)
    loss, acc = combined(x, label)
    c, e, _h = model(x)
    want = crit(c, e, label)
    assert torch.equal(loss, want[0]) and torch.equal(acc, want[1])


# ---------------------------------------------------------------------------
# Sequence alignment
# ---------------------------------------------------------------------------

def test_seq_alignment_matches_jax():
    rs = np.random.RandomState(4)
    labels = np.repeat(rs.randint(0, 5, (4, 7)), 2, axis=1)
    for got, want in zip(psa.collapse_label_chain(labels),
                         jsa.collapse_label_chain(labels)):
        np.testing.assert_array_equal(got, want)
    assert psa.collapseLabelChain is psa.collapse_label_chain
    post = rs.dirichlet(np.ones(6), size=9)
    assert psa.beam_search(post, 5, 5) == jsa.beam_search(post, 5, 5)
    a, b = rs.randint(0, 5, 11), rs.randint(0, 5, 8)
    for normalize in (True, False):
        assert psa.needleman_wunsch_align_score(a, b, -1, -1, 0, normalize) \
            == jsa.needleman_wunsch_align_score(a, b, -1, -1, 0, normalize)
    assert psa.NeedlemanWunschAlignScore(a, b, -1, -2, 1) == \
        jsa.NeedlemanWunschAlignScore(a, b, -1, -2, 1)
    assert psa.get_seq_PER(a, b) == jsa.get_seq_PER(a, b)


def test_get_per_matches_jax_with_tensor_features():
    """`getPER` with a feature maker that returns a tensor: the port brings
    it to the host; the same posteriorgrams as numpy through the JAX
    package's."""
    rs = np.random.RandomState(5)
    loader = [(None, np.repeat(rs.randint(0, 4, (2, 5)), 2, axis=1))
              for _ in range(2)]
    posts = {id(batch): rs.dirichlet(np.ones(5), size=(2, 10)).astype(
        np.float32) for batch in loader}
    got = psa.getPER(loader, lambda d: torch.from_numpy(posts[id(d)]), 4,
                     n_keep_beam_search=4)
    want = jsa.getPER(loader, lambda d: posts[id(d)], 4,
                      n_keep_beam_search=4)
    assert got == want and 0.0 <= got


# ---------------------------------------------------------------------------
# Whole training steps
# ---------------------------------------------------------------------------

STEP_B, STEP_WINDOW, STEP_ENC, STEP_AR = 4, 3200, 16, 24
STEP_FRAMES = STEP_WINDOW // 160


def _step_labels(kind):
    rs = np.random.RandomState(11)
    if kind == "speaker":
        return rs.randint(0, N_SPK, STEP_B).astype(np.int64)
    return np.repeat(rs.randint(0, N_PH, (STEP_B, STEP_FRAMES // 4)), 4,
                     axis=1).astype(np.int64)


def _supervised_flags(kind):
    return {"speaker": [], "phone": ["--pathPhone", "p"],
            "phone_on_encoder": ["--pathPhone", "p", "--onEncoder",
                                 "--nLevelsPhone", "2"],
            "ctc": ["--pathPhone", "p", "--CTC"]}[kind]


def _jax_steps(kind, batch, label, n_steps=2):
    """`cpc2_tpu.training.build_steps`' train step on a one-device mesh,
    `n_steps` times: the losses, accuracies and parameters after each."""
    from cpc2_tpu import feature_loader as fl
    from cpc2_tpu.config import get_default_cpc_config
    from cpc2_tpu.parallel.mesh import make_mesh, shard_batch
    from cpc2_tpu.train import get_criterion, init_criterion_vars
    from cpc2_tpu.training import (build_steps, create_train_state,
                                   make_optimizer)
    args = get_default_cpc_config()
    args.hiddenEncoder, args.hiddenGar = STEP_ENC, STEP_AR
    args.sizeWindow, args.arMode = STEP_WINDOW, "LSTM"
    args.supervised = True
    args.pathPhone = None if kind == "speaker" else "p"
    args.CTC = kind == "ctc"
    args.onEncoder = kind == "phone_on_encoder"
    args.nLevelsPhone = 2 if args.onEncoder else 1
    args.optimizer, args.learningRate = "adam", 2e-4
    args.beta1, args.beta2, args.epsilon = 0.9, 0.999, 1e-8
    mesh = make_mesh(1)
    bundle = fl.init_model(args, seed=0)
    criterion = get_criterion(args, 160, n_speakers=N_SPK, n_phones=N_PH)
    crit_vars = init_criterion_vars(criterion, args, bundle)
    tx = make_optimizer(args)
    state = create_train_state(bundle.variables, crit_vars, tx)
    train_step, _ = build_steps(bundle.module, criterion, tx, mesh)
    start = jax.tree_util.tree_map(np.asarray, state.params)
    xb, lb = shard_batch(mesh, batch, label.astype(np.int32))
    out = []
    for _ in range(n_steps):
        state, losses, accs = train_step(state, xb, lb,
                                         jax.random.PRNGKey(0))[:3]
        out.append((np.asarray(losses), np.asarray(accs),
                    jax.tree_util.tree_map(np.asarray, state.params)))
    return start, out


@pytest.mark.parametrize("kind", ["speaker", "phone", "phone_on_encoder",
                                  "ctc"])
def test_supervised_steps_match_jax(kind):
    """Two `Trainer.train_step`s with labels from the JAX parameters
    against two of the JAX package's train steps: the losses and
    accuracies of each, and every parameter after the second."""
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer
    rs = np.random.RandomState(0)
    batch = rs.randn(STEP_B, 2, 1, STEP_WINDOW).astype(np.float32)
    label = _step_labels("speaker" if kind == "speaker" else "phone")
    start, jax_out = _jax_steps(kind, batch, label)

    args = parse_args(["--pathDB", ".", "--device", "cpu", "--sizeWindow",
                       str(STEP_WINDOW), "--hiddenEncoder", str(STEP_ENC),
                       "--hiddenGar", str(STEP_AR), "--supervised",
                       "--random_seed", "0"] + _supervised_flags(kind))
    model = build_model(args)
    crit = get_criterion(args, N_SPK, N_PH)
    model.load_state_dict(state_dict_from_jax(start["model"]))
    crit.load_state_dict(state_dict_from_jax(start["criterion"]))
    named = dict(list(model.named_parameters(prefix="model"))
                 + list(crit.named_parameters(prefix="criterion")))
    trainer = Trainer(model, crit, make_optimizer(args, named.values()))
    assert trainer.supervised
    for losses_j, accs_j, _params in jax_out:
        losses, accs = trainer.train_step(torch.from_numpy(batch),
                                          label=torch.from_numpy(label))
        np.testing.assert_allclose(losses.numpy(), losses_j, **GRAD)
        np.testing.assert_allclose(accs.numpy(), accs_j, **GRAD)
    after = {f"{scope}.{k}": v for scope in ("model", "criterion")
             for k, v in state_dict_from_jax(jax_out[-1][2][scope]).items()}
    assert set(named) == set(after)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   err_msg=name, **GRAD)


# ---------------------------------------------------------------------------
# The trainer's command line
# ---------------------------------------------------------------------------

def _train_argv(root, ck, *extra):
    return ["--pathDB", str(root), "--file_extension", ".wav", "--device",
            "cpu", "--nEpoch", "1", "--hiddenEncoder", "16", "--hiddenGar",
            "24", "--sizeWindow", "3200", "--batchSizeGPU", "4",
            "--random_seed", "3", "--n_process_loader", "1",
            "--logging_step", "4", "--supervised", "--pathCheckpoint",
            str(ck), *extra]


@pytest.mark.parametrize("mode,keys", [
    ("speaker", {"linearSpeakerClassifier.weight",
                 "linearSpeakerClassifier.bias"}),
    ("phone", {"PhoneCriterionClassifier.weight",
               "PhoneCriterionClassifier.bias"}),
    ("ctc", {"PhoneCriterionClassifier.weight",
             "PhoneCriterionClassifier.bias"}),
])
def test_train_main_supervised(phone_corpus, tmp_path, mode, keys):
    """One epoch of `--supervised` on the CPU: finite one-column logs, the
    head's keys in the checkpoint's `cpcCriterion` (CTC's n_phones + 1
    rows), and a second run with `--load ... --loadCriterion` starting from
    those weights."""
    root, labels, _names = phone_corpus
    extra = {"speaker": [], "phone": ["--pathPhone", labels],
             "ctc": ["--pathPhone", labels, "--CTC"]}[mode]
    record = main(_train_argv(root, tmp_path / "a", *extra))
    logs = record["logs"]
    for key in ("locLoss_train", "locAcc_train", "locLoss_val",
                "locAcc_val"):
        values = np.asarray(logs[key])
        assert values.shape == (1, 1) and np.isfinite(values).all(), key
        if key.startswith("locAcc"):
            assert 0.0 <= values.min() and values.max() <= 1.0
    assert record["logs"]["iter"][0] >= 4
    saved = load_torch_checkpoint(str(tmp_path / "a" / "checkpoint_0.pt"))
    assert set(saved["cpcCriterion"]) == keys
    n_out = saved["cpcCriterion"][sorted(keys)[-1]].shape[0]
    assert n_out == {"speaker": 3, "phone": N_PH, "ctc": N_PH + 1}[mode]

    from cpc2_torch import train as train_mod
    loaded = {}
    real_load_state = train_mod.load_state

    def spy(module, state, what):
        real_load_state(module, state, what)
        if what == "cpcCriterion":
            loaded.update({k: v.clone() for k, v in
                           module.state_dict().items()})
    train_mod.load_state = spy
    try:
        main(_train_argv(root, tmp_path / "b", "--load",
                         str(tmp_path / "a" / "checkpoint_0.pt"),
                         "--loadCriterion", *extra))
    finally:
        train_mod.load_state = real_load_state
    assert set(loaded) == keys
    for key in keys:
        assert torch.equal(loaded[key], saved["cpcCriterion"][key])


def test_train_main_supervised_prefetch_equal_losses(phone_corpus, tmp_path):
    """The labels ride the loader thread: `--host_prefetch 0` and `2` give
    equal losses."""
    root, labels, _names = phone_corpus
    logs = [main(_train_argv(root, tmp_path / str(depth), "--pathPhone",
                             labels, "--host_prefetch", str(depth)))["logs"]
            for depth in (0, 2)]
    assert logs[0]["locLoss_train"] == logs[1]["locLoss_train"]
    assert logs[0]["locLoss_val"] == logs[1]["locLoss_val"]
