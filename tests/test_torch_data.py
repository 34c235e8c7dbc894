"""The port's data pipeline against the JAX package's, batch for batch and bit
for bit: ``get_SLU_datasets`` and ``get_ASR_datasets`` on the synthetic trees
of ``tests/fixtures.py`` (and CSVs that exercise pandas' type inference and
NA strings), the TextGrid reader and writer, WSOLA, and ``BatchLoader``'s
process shards.

Loaders run on one thread here: the augment and the ASR crop draw from one
generator per dataset, in the order the threads reach the items.
"""

import csv
import os

import numpy as np
import pytest

from tests import fixtures
from tpu_slu import read_config as jax_read_config
from tpu_slu.data import datasets as jdata
from tpu_slu.data import loader as jloader
from tpu_slu.data import tempo as jtempo
from tpu_slu.data import textgrid as jtextgrid
from tpu_slu_torch.config import read_config
from tpu_slu_torch.data import datasets as tdata
from tpu_slu_torch.data import loader as tloader
from tpu_slu_torch.data import tempo as ttempo
from tpu_slu_torch.data import textgrid as ttextgrid


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert np.array_equal(g[k], w[k]), k


def _epochs(datasets, n_train_epochs=2):
    """Every batch of every split: the train split's over ``n_train_epochs``."""
    out = []
    for i, ds in enumerate(datasets):
        ds.loader.num_threads = 1
        for _ in range(n_train_epochs if i == 0 else 1):
            out.append(list(ds.loader))
    return out


def _rewrite_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _read_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _odd_types(root):
    """CSVs as pandas infers and fills them: a leading unnamed index column
    (dropped), numeric speaker ids with gaps (float, each NaN its own key),
    a slot value "None" and an empty cell (NaN), and a synthetic split."""
    path = os.path.join(root, "data", "train_data.csv")
    header, *rows = _read_rows(path)
    new = []
    for i, r in enumerate(rows):
        r = dict(zip(header, r))
        r["speakerId"] = "" if i % 5 == 0 else str(i % 3)
        if i == 2:
            r["location"] = "None"
        new.append([str(i)] + [r[c] for c in header])
    _rewrite_csv(path, [""] + header, new)
    valid = _read_rows(os.path.join(root, "data", "valid_data.csv"))
    synth = [[r[0], str(7 + i % 2)] + r[2:] for i, r in enumerate(valid[1:])]
    _rewrite_csv(os.path.join(root, "data", "synthetic_data.csv"), valid[0], synth)


def _synthetic_split(root, suffix=""):
    """Rows in the synthetic split (a copy of valid's, speakers renamed)."""
    header, *rows = _read_rows(os.path.join(root, "data", f"valid_data{suffix}.csv"))
    rows = [[r[0], f"syn{i % 3}"] + r[2:] for i, r in enumerate(rows)]
    _rewrite_csv(os.path.join(root, "data", f"synthetic_data{suffix}.csv"), header, rows)


VARIANTS = {
    "fixed_slot": {},
    "seq2seq": {"seq2seq": True},
    "augment": {"extra": "augment=True\n"},
    "subsets": {"subsets": True},
    "wordings": {"wordings": True},
    "odd_types": {"odd_types": True},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_slu_datasets_equal_jax(variant, tmp_path):
    """The same config through both packages under the same
    ``np.random.seed``: equal ``Sy_intent``, ``values_per_slot`` and
    ``num_phonemes``, and equal batches of every split (the train split over
    two epochs)."""
    opts = VARIANTS[variant]
    root = fixtures.make_slu_dataset(str(tmp_path / "fsc"), n_train=20, n_valid=6, n_test=6)
    replace = {}
    if opts.get("subsets"):
        _synthetic_split(root)
        replace = {"real_dataset_subset_percentage=1.0": "real_dataset_subset_percentage=0.75",
                   "synthetic_dataset_subset_percentage=1.0": "synthetic_dataset_subset_percentage=0.5",
                   "real_speaker_subset_percentage=1.0": "real_speaker_subset_percentage=0.5",
                   "synthetic_speaker_subset_percentage=1.0": "synthetic_speaker_subset_percentage=0.67"}
    if opts.get("odd_types"):
        _odd_types(root)
        replace = {"real_speaker_subset_percentage=1.0": "real_speaker_subset_percentage=0.6"}
    if opts.get("wordings"):
        header, *rows = _read_rows(os.path.join(root, "data", "train_data.csv"))
        words = sorted({r[header.index("transcription")] for r in rows})
        for name, keep in (("train.txt", words[::2]), ("test.txt", words[1::2])):
            with open(tmp_path / name, "w") as f:
                f.writelines(w + "\n" for w in keep)
        replace = {"train_wording_path=None": f"train_wording_path={tmp_path / 'train.txt'}",
                   "test_wording_path=None": f"test_wording_path={tmp_path / 'test.txt'}"}
    out = {}
    for pkg, read, get in (("jax", jax_read_config, jdata.get_SLU_datasets),
                           ("port", read_config, tdata.get_SLU_datasets)):
        cfg = fixtures.write_cfg(str(tmp_path / f"{pkg}.cfg"), folder=str(tmp_path / pkg), slu_path=root,
                                 seq2seq=opts.get("seq2seq", False), extra=opts.get("extra", ""),
                                 replace=replace)
        config = read(cfg)
        if variant == "fixed_slot":
            fixtures.write_phonemes_txt(config.folder)
        np.random.seed(11)
        datasets = get(config)
        out[pkg] = (config, _epochs(datasets))
    (jc, jb), (tc, tb) = out["jax"], out["port"]
    assert repr(tc.Sy_intent) == repr(jc.Sy_intent)
    for attr in ("values_per_slot", "num_phonemes"):
        assert getattr(tc, attr, None) == getattr(jc, attr, None), attr
    for got, want in zip(tb, jb):
        _assert_batches_equal(got, want)
    assert sum(len(b) for b in jb[0]) > 0


def test_asr_datasets_equal_jax(tmp_path):
    """``get_ASR_datasets`` on the synthetic LibriSpeech tree: the same
    ``phonemes.txt``/``words.txt`` (built from the valid split), the same
    ``num_phonemes`` and equal batches of every split; then again from the
    written vocabulary files."""
    root = fixtures.make_asr_dataset(str(tmp_path / "asr"), n_per_split=7)
    configs = {}
    for pkg, read in (("jax", jax_read_config), ("port", read_config)):
        cfg = fixtures.write_cfg(str(tmp_path / f"{pkg}.cfg"), folder=str(tmp_path / pkg), asr_path=root,
                                 replace={"pretraining_batch_size=8": "pretraining_batch_size=3"})
        configs[pkg] = (read(cfg), read(cfg))
    for round_ in range(2):
        jc, tc = configs["jax"][round_], configs["port"][round_]
        jb, tb = _epochs(jdata.get_ASR_datasets(jc)), _epochs(tdata.get_ASR_datasets(tc))
        assert tc.num_phonemes == jc.num_phonemes
        for got, want in zip(tb, jb):
            _assert_batches_equal(got, want)
        assert any((b["y_phoneme"] == -1).any() and (b["y_word"] == -1).any() for b in jb[0])
    for name in ("phonemes.txt", "words.txt"):
        with open(tmp_path / "port" / "pretraining" / name) as f, \
                open(tmp_path / "jax" / "pretraining" / name) as g:
            assert f.read() == g.read(), name


SHORT_TEXTGRID = '''"ooTextFile"
"TextGrid"
0
1.5
<exists>
2
"IntervalTier"
"words"
0
1.5
2
0
0.5
"a ""quoted"" word"
0.5
1.5
""
"TextTier"
"points"
0
1.5
1
0.7
"p"
'''


def test_textgrid_equals_jax(tmp_path):
    """``write_textgrid`` writes JAX's bytes; ``read_textgrid`` reads the long
    format and the short one (a quoted quote, a point tier) as JAX does."""
    tiers = {"words": [(0.0, 0.4, "cat"), (0.4, 1.25, "")], "phones": [(0.0, 0.4, "K1"), (0.4, 1.25, "sil")]}
    ours, theirs = tmp_path / "ours.TextGrid", tmp_path / "theirs.TextGrid"
    ttextgrid.write_textgrid(str(ours), tiers, 1.25)
    jtextgrid.write_textgrid(str(theirs), tiers, 1.25)
    assert ours.read_bytes() == theirs.read_bytes()
    short = tmp_path / "short.TextGrid"
    short.write_text(SHORT_TEXTGRID)

    def as_tuples(tg):
        return {k: (t.name, [(iv.minTime, iv.maxTime, iv.mark) for iv in t]) for k, t in tg.items()}

    for path in (ours, short):
        got, want = as_tuples(ttextgrid.read_textgrid(str(path))), as_tuples(jtextgrid.read_textgrid(str(path)))
        assert got == want
    assert got["words"][1][0][2] == 'a "quoted" word'


@pytest.mark.parametrize("speed", [0.9, 0.97, 1.0, 1.05, 1.1])
def test_wsola_equals_jax(speed):
    """``wsola_tempo`` bit for bit, on 1 s of noise and on an input too short
    to stretch."""
    rng = np.random.default_rng(int(speed * 100))
    for n in (16000, 500):
        x = rng.standard_normal(n).astype(np.float32)
        got, want = ttempo.wsola_tempo(x, speed), jtempo.wsola_tempo(x, speed)
        assert got.dtype == want.dtype and np.array_equal(got, want)


class _Items:
    def __init__(self, n):
        self.waves = [np.full(100 + 37 * i, i + 1, np.float32) for i in range(n)]

    def __len__(self):
        return len(self.waves)

    def __getitem__(self, i):
        return self.waves[i]


def _collate(items):
    x, w, lengths = jloader.pad_wave_batch(items, 4, 64)
    return {"x": x, "w": w, "len": lengths}


@pytest.mark.parametrize("pcount", [2, 3])
def test_batch_loader_shards_equal_jax(pcount):
    """Each process's batches over two epochs equal JAX's ``BatchLoader``
    given the same ``process_index``/``process_count``: one permutation from
    ``seed + epoch``, wrapped to equal shards whose duplicates weigh 0; over
    the processes every example counts once."""
    data = _Items(10)
    seen = []
    for pidx in range(pcount):
        ours = tloader.BatchLoader(data, 4, _collate, seed=5, process_index=pidx, process_count=pcount,
                                   num_threads=1)
        theirs = jloader.BatchLoader(data, 4, _collate, seed=5, process_index=pidx, process_count=pcount,
                                     num_threads=1)
        assert len(ours) == len(theirs)
        for _ in range(2):
            got, want = list(ours), list(theirs)
            _assert_batches_equal(got, want)
        for b in got:
            seen += [int(v) for v, w in zip(b["x"][:, 0], b["w"]) if w > 0]
    assert sorted(seen) == list(range(1, 11))
    with pytest.raises(ValueError):
        tloader.BatchLoader(data, 4, _collate, process_index=pcount, process_count=pcount)


def test_pad_wave_batch_equals_jax():
    waves = [np.ones(n, np.float32) * n for n in (3, 9000, 17)]
    for got, want in zip(tloader.pad_wave_batch(waves, 5, 8000), jloader.pad_wave_batch(waves, 5, 8000)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
