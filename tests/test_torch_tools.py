"""The port's host tools (`cpc2_torch/tools/`) against the JAX package's on
the same synthetic files, on the CPU: `adjust_sample_rate` (the resampled
arrays and the written files), `best_val_epoch`, `build_power_two_training`
(the packet trees under the same `random` seed), `extract_segments` (the
RTTM records, the cuts, both samplers under the same numpy seed, the tier
symlinks, the CLI) and `filter` (its table, written CSV byte for byte,
every criterion's selection at several percentages, ties included, the
random draw under the same numpy seed, the symlink trees, the CLI from
`--create_pred_table` and from `--table`), the port's without pandas.

Every comparison is exact: the same files, bytes, links and values.
"""

import os
import random

import numpy as np
import pytest

from cpc2_tpu.data.audio_io import save_wav
from cpc2_tpu.tools import adjust_sample_rate as jax_resample
from cpc2_tpu.tools import best_val_epoch as jax_best
from cpc2_tpu.tools import build_power_two_training as jax_b2
from cpc2_tpu.tools import extract_segments as jax_segments
from cpc2_torch.tools import adjust_sample_rate, best_val_epoch
from cpc2_torch.tools import build_power_two_training as b2
from cpc2_torch.tools import extract_segments
from cpc2_torch.tools import filter as port_filter


def _tree(root):
    """{relative path: ('link', target relative to `root`'s parent or
    absolute) or ('file', bytes, `root`'s own path in them as <out>)} of
    everything under `root`."""
    out = {}
    base = os.path.dirname(os.path.abspath(root))
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                target = os.readlink(path)
                out[rel] = ("link", os.path.relpath(target, base)
                            if os.path.isabs(target) else target)
            elif os.path.isfile(path):
                with open(path, "rb") as f:
                    out[rel] = ("file", f.read().replace(
                        os.path.abspath(root).encode(), b"<out>"))
            else:
                out[rel] = ("dir",)
    return out


def _same_trees(a, b):
    """Two trees built from the same inputs in sibling directories `a` and
    `b`; links into each one's own output compared relative to it."""
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for key in ta:
        va, vb = ta[key], tb[key]
        if va[0] == "link":
            va = ("link", va[1].replace(os.path.basename(a), "<out>", 1))
            vb = ("link", vb[1].replace(os.path.basename(b), "<out>", 1))
        assert va == vb, key
    return ta


def test_resample_matches_jax():
    sr = 32000
    x = np.sin(2 * np.pi * 440 * np.arange(sr) / sr).astype(np.float32)
    for target in (16000, 22050, sr):
        got = adjust_sample_rate.resample(x, sr, target)
        np.testing.assert_array_equal(got, jax_resample.resample(x, sr,
                                                                 target))
    assert adjust_sample_rate.resample(x, sr, sr) is x


def test_adjust_sample_rate_cli_matches_jax(tmp_path):
    db = tmp_path / "db"
    db.mkdir()
    rs = np.random.RandomState(0)
    for i, sr in enumerate((8000, 22050, 16000)):
        save_wav(str(db / f"utt{i}.wav"),
                 (0.3 * rs.randn(sr)).astype(np.float32), sr)
    save_wav(str(db / "untranscribed.wav"), np.zeros(800, np.float32), 8000)
    tsv = tmp_path / "files.tsv"
    tsv.write_text("utt0.wav 0 1 2\nutt1 a b\nutt2.mp3 x\n")
    outs = {}
    for side, main in (("port", adjust_sample_rate.main),
                       ("jax", jax_resample.main)):
        main([str(db), str(tsv), str(tmp_path / side),
              "--file_extension", ".wav"])
        outs[side] = _tree(tmp_path / side)
    assert sorted(outs["port"]) == ["utt0.wav", "utt1.wav", "utt2.wav"]
    assert outs["port"] == outs["jax"]
    assert (adjust_sample_rate.transcribed_audio(str(db), ".wav", str(tsv))
            == jax_resample.transcribed_audio(str(db), ".wav", str(tsv)))


@pytest.fixture
def run_dir(tmp_path):
    logs = {"locAcc_val": [[0.1, 0.2], [0.5, 0.4], [0.3, 0.9], [0.7, 0.8],
                           [0.2, 0.1]]}
    import json
    (tmp_path / "checkpoint_logs.json").write_text(json.dumps(logs))
    for epoch in (0, 1, 2, 4):
        (tmp_path / f"checkpoint_{epoch}.pt").write_bytes(b"")
    (tmp_path / "checkpoint_last.pt").write_bytes(b"")
    return tmp_path


@pytest.mark.parametrize("bounds", [[], ["--min", "3"], ["--max", "1"],
                                    ["--min", "1", "--max", "2"]])
def test_best_val_epoch_matches_jax(run_dir, bounds, capsys):
    argv = ["--model_path", str(run_dir)] + bounds
    got = best_val_epoch.main(argv)
    said = capsys.readouterr().out
    assert got == jax_best.main(argv)
    assert said == capsys.readouterr().out
    assert (best_val_epoch.find_best_epoch(str(run_dir))
            == jax_best.find_best_epoch(str(run_dir)))


def test_best_val_epoch_refusals(run_dir, tmp_path):
    for side in (best_val_epoch, jax_best):
        with pytest.raises(ValueError, match="No saved checkpoint"):
            side.main(["--model_path", str(run_dir), "--min", "9"])
        with pytest.raises(ValueError, match="is not a directory"):
            side.main(["--model_path", str(tmp_path / "none")])
        with pytest.raises(ValueError, match="checkpoint_logs.json"):
            side.find_best_epoch(str(tmp_path / "none"))


def test_power_two_training_matches_jax(tmp_path, monkeypatch):
    """8 files of a nominal 30 minutes each in 4 packets of 1 h: the 1h, 2h
    and 4h tiers of links, the same on both sides."""
    audio = tmp_path / "db"
    for spk in ("a", "b"):
        (audio / spk).mkdir(parents=True)
        for i in range(4):
            save_wav(str(audio / spk / f"u{i}.wav"),
                     np.zeros(160 * (i + 1), np.float32), 16000)
    for module in (b2, jax_b2):
        monkeypatch.setattr(module, "get_audio_duration",
                            lambda p: 1800.0)
    for side, main in (("port", b2.main), ("jax", jax_b2.main)):
        random.seed(42)
        main(["--audio_path", str(audio), "--duration", "3600",
              "--nb_packets", "4", "--output_path", str(tmp_path / side)])
    tree = _same_trees(tmp_path / "port", tmp_path / "jax")
    links = [k for k, v in tree.items() if v[0] == "link"]
    assert len(links) == 8 * 3
    for side in (b2, jax_b2):
        with pytest.raises(ValueError, match="already exists"):
            side.main(["--audio_path", str(audio), "--duration", "4",
                       "--nb_packets", "2", "--output_path",
                       str(tmp_path / "port")])


def test_audio_duration_matches_jax(tmp_path):
    path = str(tmp_path / "x.wav")
    save_wav(path, np.zeros(24000, np.float32), 16000)
    assert b2.get_audio_duration(path) == jax_b2.get_audio_duration(
        path) == 1.5


@pytest.fixture
def rttm_corpus(tmp_path):
    """Three recordings (one without an .rttm) and their annotations."""
    audio, rttm = tmp_path / "audio", tmp_path / "rttm"
    audio.mkdir(), rttm.mkdir()
    sr = 16000
    rs = np.random.RandomState(4)
    for name in ("recA_Bergelson", "recB_Bergelson", "recC"):
        save_wav(str(audio / f"{name}.wav"),
                 (0.2 * rs.randn(8 * sr)).astype(np.float32), sr)
    for name in ("recA_Bergelson", "recB_Bergelson", "other_Bergelson"):
        lines = [f"SPEAKER {name} 1 {0.25 * k + 0.1:.2f} "
                 f"{0.05 + 0.3 * ((k * 7) % 5):.2f} <NA> <NA> "
                 f"{('KCHI', 'FEM', 'MAL', 'CHI')[k % 4]} <NA> <NA>"
                 for k in range(20)]
        (rttm / f"{name}.rttm").write_text("\n".join(lines) + "\n")
    return audio, rttm


def test_load_all_rttm_matches_jax(rttm_corpus):
    audio, rttm = rttm_corpus
    for regex, classes, min_dur in (("", {"KCHI", "FEM"}, 0.1),
                                    ("Bergelson", {"MAL"}, 0.0)):
        got = extract_segments.load_all_rttm(str(rttm), classes, regex,
                                             min_dur, str(audio))
        want = jax_segments.load_all_rttm(str(rttm), classes, regex,
                                          min_dur, str(audio))
        assert got == want and got


def test_cut_wave_file_matches_jax(rttm_corpus, tmp_path):
    audio, _ = rttm_corpus
    for side, module in (("port", extract_segments), ("jax", jax_segments)):
        (tmp_path / side / "KCHI").mkdir(parents=True)
        module.cut_wave_file(str(audio / "recA_Bergelson.wav"), 0.53, 1.27,
                             "KCHI", str(tmp_path / side))
    tree = _same_trees(tmp_path / "port", tmp_path / "jax")
    assert "KCHI/recA_Bergelson_KCHI_0.53_1.80.wav" in tree


@pytest.mark.parametrize("sampling", ["random", "longest"])
def test_segment_sampler_matches_jax(rttm_corpus, tmp_path, sampling):
    """Tiers of 1, 2 and 3 h from hour-long annotated durations (each cut
    clamps to the end of its 8-second recording, as in the JAX package's
    test), and their symlinks."""
    audio, _rttm = rttm_corpus
    classes = ["KCHI", "FEM"]
    segs = [[str(audio / f"rec{'AB'[k % 2]}_Bergelson.wav"), 0.5 * k,
             3600.0 + 450.0 * k, classes[k % 2]] for k in range(7)]
    tiers = np.asarray([3600, 7200, 10800])
    for side, module in (("port", extract_segments), ("jax", jax_segments)):
        np.random.seed(3)
        module.segment_sampler([list(s) for s in segs], tiers, sampling,
                               str(tmp_path / side))
        module.create_symlink(str(tmp_path / side), tiers, classes)
    tree = _same_trees(tmp_path / "port", tmp_path / "jax")
    assert any(v[0] == "link" for v in tree.values())
    assert {k.split("/")[0] for k in tree} == {"1h", "2h", "3h"}
    with pytest.raises(ValueError, match="Only 'random' or 'longest'"):
        extract_segments.segment_sampler(segs, tiers, "middle",
                                         str(tmp_path / "x"))


def test_extract_segments_cli_matches_jax(rttm_corpus, tmp_path):
    """The CLI at hour-sized tiers: annotations too short for 1 h raise on
    both sides; the output directory is refused when it exists."""
    audio, rttm = rttm_corpus
    for side, main in (("port", extract_segments.main),
                       ("jax", jax_segments.main)):
        argv = ["--audio_path", str(audio), "--rttm_path", str(rttm),
                "--classes", "KCHI", "FEM", "--durations", "1",
                "--sampling", "longest", "--output_path",
                str(tmp_path / side)]
        with pytest.raises(ValueError, match="Requested 1 h"):
            main(argv)
        with pytest.raises(ValueError, match="already exists"):
            main(argv)


@pytest.fixture
def scored_segments(tmp_path):
    """13 segments in 3 subfolders, SNRs with ties (0-3) listed in another
    order than the C50s."""
    seg = tmp_path / "segments" / "no_filter"
    pred = tmp_path / "pred"
    seg.mkdir(parents=True), pred.mkdir()
    rs = np.random.RandomState(0)
    names, snrs, c50s = [], [], []
    for i in range(13):
        sub = seg / f"d{i % 3}"
        sub.mkdir(exist_ok=True)
        save_wav(str(sub / f"utt{i}.wav"), np.zeros(160, np.float32), 16000)
        names.append(f"utt{i}")
        snrs.append(float(rs.randint(0, 4)))
        c50s.append(round(float(rs.randn()), 3))
    order = rs.permutation(13)
    (pred / "mean_snr_labels.txt").write_text(
        "".join(f"{names[i]} {snrs[i]}\n" for i in order))
    (pred / "reverb_labels.txt").write_text(
        "".join(f"{n} {v}\n" for n, v in zip(names, c50s)))
    return tmp_path / "segments", pred


def _jax_filter():
    pytest.importorskip("pandas")
    from cpc2_tpu.tools import filter as jax_filter
    return jax_filter


def test_filter_table_and_selection_match_jax(scored_segments):
    jax_filter = _jax_filter()
    seg_dir, pred_dir = scored_segments
    csv_path = seg_dir / "no_filter" / port_filter.TABLE_NAME
    want = jax_filter.create_snr_c50_table(str(seg_dir), str(pred_dir))
    want_csv = csv_path.read_bytes()
    got = port_filter.create_snr_c50_table(str(seg_dir), str(pred_dir))
    assert csv_path.read_bytes() == want_csv
    assert len(got) == len(want) == 13
    assert list(got.columns) == list(want.columns)
    for name in want.columns:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      want[name].to_numpy(), err_msg=name)
    assert got["snr_normalized"].min() == 0.0
    assert got["snr_normalized"].max() == 1.0
    read = port_filter.read_csv(csv_path)
    import pandas as pd
    read_jax = pd.read_csv(csv_path)
    for criterion in ("snr", "c50", "snr_c50"):
        for percentage in (10, 20, 50, 70, 90, 100):
            for table, ref in ((got, want), (read, read_jax)):
                sel = port_filter.filter_data(table, criterion, percentage)
                ref_sel = jax_filter.filter_data(ref, criterion, percentage)
                assert list(sel["uri"]) == list(ref_sel["uri"]), (
                    criterion, percentage)
                assert ([str(p) for p in sel["subpath"]]
                        == [str(p) for p in ref_sel["subpath"]])
    for percentage in (10, 50, 90):
        np.random.seed(percentage)
        sel = port_filter.randomly_filter_data(got, "random", percentage)
        np.random.seed(percentage)
        ref_sel = jax_filter.randomly_filter_data(want, "random", percentage)
        assert list(sel["uri"]) == list(ref_sel["uri"])


def test_filter_prediction_count_mismatch(scored_segments):
    jax_filter = _jax_filter()
    seg_dir, pred_dir = scored_segments
    save_wav(str(seg_dir / "no_filter" / "extra.wav"),
             np.zeros(160, np.float32), 16000)
    for side in (port_filter, jax_filter):
        with pytest.raises(ValueError, match="= 13.*= 14"):
            side.create_snr_c50_table(str(seg_dir), str(pred_dir))


@pytest.mark.parametrize("source", ["create_pred_table", "table"])
def test_filter_cli_matches_jax(scored_segments, tmp_path, source):
    """`main` over copies of the segments: the subsets' symlink trees of
    every criterion at 20 and 60 percent, the random one under the same
    numpy seed."""
    import shutil
    jax_filter = _jax_filter()
    seg_dir, pred_dir = scored_segments
    trees = {}
    for side, main in (("port", port_filter.main), ("jax", jax_filter.main)):
        root = tmp_path / side
        shutil.copytree(seg_dir, root)
        if source == "table":
            jax_filter.create_snr_c50_table(str(root), str(pred_dir))
            flags = ["--table", str(root / "no_filter" /
                                    port_filter.TABLE_NAME)]
        else:
            flags = ["--create_pred_table", str(pred_dir)]
        np.random.seed(5)
        main([str(root), "-p", "20", "60"] + flags)
        trees[side] = root
    tree = _same_trees(trees["port"], trees["jax"])
    # 60% of 13 rows: int(7.8) ranked, round(7.8) drawn
    for criterion, n in (("snr", 7), ("c50", 7), ("snr_c50", 7),
                         ("random", 8)):
        assert sum(1 for k, v in tree.items() if v[0] == "link"
                   and k.startswith(f"{criterion}/60/")) == n
