"""Datasets: FSC / Snips / Timers-and-Such for SLU, LibriSpeech alignments for ASR.

The port's own copy of ``tpu_slu/data/datasets.py``, with the standard
library's ``csv`` where JAX's reads with pandas. The batches are JAX's bit
for bit, and so is what the functions attach to the config
(``Sy_intent``, ``values_per_slot``, ``num_phonemes``) and write
(``pretraining/phonemes.txt``, ``pretraining/words.txt``). What pandas did
and this module does by hand (:class:`Table`):

* ``read_csv``'s types: a column whose values all read as integers holds
  ints (floats once a value is missing), else floats if they all read as
  numbers, bools if all are ``True``/``False``, else strings; the NA strings
  (``""``, ``"NA"``, ``"None"``, ... :data:`NA_STRINGS`) read as NaN: the
  one ``np.nan`` in a string column, a float NaN of its own per cell in a
  numeric one (so ``Counter`` counts each apart, as over a pandas column);
* a header cell that is empty is named ``Unnamed: <i>``;
* ``concat`` then ``reset_index()``: the rows' labels become a leading
  ``index`` column; an int column meeting a float one becomes float;
* ``isin``: NaN matches NaN only among float values (a string array holds
  ``"nan"``, which matches nothing).

The speaker and dataset subsets draw from the global ``np.random`` in JAX's
order (real speakers, synthetic speakers, real rows, synthetic rows); the
slot vocabulary is the training split's values in ``Counter`` order (first
appearance); the ASR vocabulary is built from the *valid* split when the
experiment has no ``phonemes.txt``/``words.txt`` yet.
"""

from __future__ import annotations

import csv
import glob
import os
import re
import string
from collections import Counter

import numpy as np

from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.data.loader import WAVE_BUCKET_QUANT, BatchLoader, pad_to_bucket, pad_wave_batch
from tpu_slu_torch.data.textgrid import read_textgrid

SLOTS = ("action", "object", "location")
LABEL_BUCKET_QUANT = 16
# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
                        "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"[+-]?\d+")
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


def _is_nan(v) -> bool:
    return isinstance(v, float) and v != v


def _parse_column(raw: list[str]) -> tuple[str, list]:
    """One column's cells -> (kind, values), kind one of int, float, bool, str."""
    present = [s.strip() for s in raw if s not in NA_STRINGS]
    missing = len(present) < len(raw)
    if all(_INT.fullmatch(s) for s in present):
        if not missing:
            return "int", [int(s) for s in raw]
        return "float", [float("nan") if s in NA_STRINGS else float(s) for s in raw]
    try:
        if "_" in "".join(present):
            raise ValueError
        floats = [float("nan") if s in NA_STRINGS else float(s.strip()) for s in raw]
        return "float", floats
    except ValueError:
        pass
    if present and all(s in _BOOLS for s in present) and not missing:
        return "bool", [_BOOLS[s.strip()] for s in raw]
    return "str", [np.nan if s in NA_STRINGS else s for s in raw]


class Table:
    """The rows of a CSV as dicts, each with its pandas index label."""

    def __init__(self, columns: list[str], rows: list[dict], labels: list, kinds: dict[str, str]):
        self.columns, self.rows, self.labels, self.kinds = columns, rows, labels, kinds

    @staticmethod
    def read_csv(path: str) -> "Table":
        with open(path, newline="") as f:
            lines = [r for r in csv.reader(f) if r]
        header = [c if c != "" else f"Unnamed: {i}" for i, c in enumerate(lines[0])] if lines else []
        body = lines[1:]
        kinds, cols = {}, {}
        for j, name in enumerate(header):
            raw = [r[j] if j < len(r) else "" for r in body]
            kinds[name], cols[name] = _parse_column(raw) if body else ("object", [])
        rows = [{c: cols[c][i] for c in header} for i in range(len(body))]
        return Table(header, rows, list(range(len(body))), kinds)

    def __len__(self):
        return len(self.rows)

    def col(self, name: str) -> list:
        return [r[name] for r in self.rows]

    def take(self, positions) -> "Table":
        return Table(self.columns, [self.rows[i] for i in positions], [self.labels[i] for i in positions],
                     self.kinds)

    def where(self, mask) -> "Table":
        return self.take([i for i, keep in enumerate(mask) if keep])

    def drop(self, name: str) -> "Table":
        if name not in self.columns:
            return self
        rows = [{c: v for c, v in r.items() if c != name} for r in self.rows]
        return Table([c for c in self.columns if c != name], rows, self.labels,
                     {c: k for c, k in self.kinds.items() if c != name})

    def reset_index(self, drop: bool = False) -> "Table":
        if drop:
            return Table(self.columns, self.rows, list(range(len(self))), self.kinds)
        rows = [{"index": lab, **r} for lab, r in zip(self.labels, self.rows)]
        return Table(["index"] + self.columns, rows, list(range(len(self))), {"index": "int", **self.kinds})

    @staticmethod
    def concat(tables: list["Table"]) -> "Table":
        columns = list(dict.fromkeys(c for t in tables for c in t.columns))
        kinds = {}
        for c in columns:
            seen = {t.kinds.get(c, "float") for t in tables if len(t)}
            kinds[c] = "float" if seen == {"int", "float"} else (seen.pop() if len(seen) == 1 else "object")
        rows, labels = [], []
        for t in tables:
            for lab, r in zip(t.labels, t.rows):
                row = {c: r.get(c, float("nan")) for c in columns}
                for c in columns:
                    if kinds[c] == "float" and isinstance(row[c], int) and not isinstance(row[c], bool):
                        row[c] = float(row[c])
                rows.append(row)
                labels.append(lab)
        return Table(columns, rows, labels, kinds)


def isin(values: list, selected) -> list[bool]:
    """pandas ``Series.isin``: membership, NaN matching only a float NaN."""
    sel = list(np.asarray(selected).tolist()) if not isinstance(selected, list) else selected
    has_nan = any(_is_nan(s) for s in sel)
    members = {s for s in sel if not _is_nan(s)}
    return [has_nan if _is_nan(v) else (v in members) for v in values]


# ---------------------------------------------------------------------------
# SLU (FSC / Snips / Timers-and-Such)
# ---------------------------------------------------------------------------


def get_SLU_datasets(config):
    """(train, valid, test) :class:`SLUDataset`; attaches ``Sy_intent`` and
    ``values_per_slot`` (fixed-slot) or the character vocabulary (seq2seq),
    and ``num_phonemes`` from ``pretraining/phonemes.txt``, to the config."""
    base_path = config.slu_path
    suffix = "_seq2seq" if config.seq2seq else ""

    def read(split):
        return Table.read_csv(os.path.join(base_path, "data", f"{split}_data{suffix}.csv"))

    synthetic_train, real_train = read("synthetic"), read("train").drop("Unnamed: 0")

    if "speakerId" in real_train.columns and "speakerId" in synthetic_train.columns:
        for which, pct in (("real", config.real_speaker_subset_percentage),
                           ("synthetic", config.synthetic_speaker_subset_percentage)):
            if pct < 1:
                df = real_train if which == "real" else synthetic_train
                speakers = np.array(list(Counter(df.col("speakerId"))))
                np.random.shuffle(speakers)
                selected = speakers[: round(pct * len(speakers))]
                df = df.where(isin(df.col("speakerId"), selected))
                if which == "real":
                    real_train = df
                else:
                    synthetic_train = df
    else:
        real_train, synthetic_train = real_train.drop("speakerId"), synthetic_train.drop("speakerId")
        if config.real_speaker_subset_percentage < 1 or config.synthetic_speaker_subset_percentage < 1:
            print("no speaker id listed in dataset .csv; ignoring speaker subset selection")

    if config.real_dataset_subset_percentage < 1:
        size = round(config.real_dataset_subset_percentage * len(real_train))
        real_train = real_train.take(np.random.choice(len(real_train), size, replace=False))
    if config.synthetic_dataset_subset_percentage < 1:
        size = round(config.synthetic_dataset_subset_percentage * len(synthetic_train))
        synthetic_train = synthetic_train.take(np.random.choice(len(synthetic_train), size, replace=False))

    train_df = Table.concat([synthetic_train, real_train]).reset_index()
    valid_df, test_df = read("valid"), read("test")

    if not config.seq2seq:
        Sy_intent = {slot: {} for slot in SLOTS}
        values_per_slot = []
        for slot in SLOTS:
            slot_values = Counter(train_df.col(slot))
            for idx, value in enumerate(slot_values):
                Sy_intent[slot][value] = idx
            values_per_slot.append(len(slot_values))
        config.values_per_slot = values_per_slot
        config.Sy_intent = Sy_intent
    else:
        all_chars = "".join(str(v) for v in train_df.col("semantics")) + string.printable
        Sy_intent = ["<sos>"] + sorted(set(all_chars)) + ["<eos>"]
        config.Sy_intent = Sy_intent

    if config.train_wording_path is not None:
        with open(config.train_wording_path) as f:
            wordings = [line.strip() for line in f]
        train_df = train_df.where(isin(train_df.col("transcription"), wordings)).reset_index(drop=True)
    if config.test_wording_path is not None:
        with open(config.test_wording_path) as f:
            wordings = [line.strip() for line in f]
        valid_df = valid_df.where(isin(valid_df.col("transcription"), wordings)).reset_index(drop=True)
        test_df = test_df.where(isin(test_df.col("transcription"), wordings)).reset_index(drop=True)

    phones_path = os.path.join(config.folder, "pretraining", "phonemes.txt")
    if os.path.isfile(phones_path):
        with open(phones_path) as f:
            config.num_phonemes = len([line for line in f if line.rstrip("\n") != ""])
    else:
        print("No phoneme file found.")

    train = SLUDataset(train_df, base_path, Sy_intent, config,
                       upsample_factor=config.dataset_upsample_factor, shuffle=True)
    return train, SLUDataset(valid_df, base_path, Sy_intent, config), SLUDataset(test_df, base_path,
                                                                                 Sy_intent, config)


class SLUDataset:
    """Map-style SLU dataset over a :class:`Table`; owns its batch loader.
    The training split (``shuffle``) augments when the config says so."""

    def __init__(self, df: Table, base_path, Sy_intent, config, upsample_factor=1, shuffle=False):
        self.df = df.reset_index(drop=True)
        self.base_path = base_path
        self.Sy_intent = Sy_intent
        self.upsample_factor = upsample_factor
        self.seq2seq = config.seq2seq
        self.augment = getattr(config, "augment", False) and shuffle
        self._rng = np.random.default_rng(config.seed)
        collate = CollateWavsSLU(Sy_intent, self.seq2seq, config.training_batch_size)
        self.loader = BatchLoader(self, config.training_batch_size, collate, shuffle=shuffle, seed=config.seed)

    def __len__(self):
        return len(self.df) * self.upsample_factor

    def __getitem__(self, idx):
        row = self.df.rows[idx % len(self.df)]
        x, _fs = read_wav(os.path.join(self.base_path, row["path"]))
        if self.augment:
            x = _augment_wave(x, self._rng)
        if not self.seq2seq:
            y = [self.Sy_intent[slot][row[slot]] for slot in SLOTS]
        else:
            y = ([self.Sy_intent.index("<sos>")] + [self.Sy_intent.index(c) for c in row["semantics"]]
                 + [self.Sy_intent.index("<eos>")])
        return x, y


def _augment_wave(x, rng):
    """Pitch-preserving tempo change by U(0.9, 1.1) (WSOLA), a gain of
    U(-10, 10) dB and Gaussian noise at an SNR from {0, 5, 10, 15, 20} dB."""
    from tpu_slu_torch.data.tempo import wsola_tempo

    speed = rng.uniform(0.9, 1.1)
    x = wsola_tempo(x, speed)
    x = x * (10.0 ** (rng.uniform(-10, 10) / 20.0))
    snr = rng.choice([0, 5, 10, 15, 20])
    noise = rng.standard_normal(len(x)).astype(np.float32)
    s_db = 10 * np.log10(1e-12 + float(x @ x) / len(x))
    n_db = 10 * np.log10(1e-12 + float(noise @ noise) / len(noise))
    return (x + noise * 10.0 ** ((s_db - snr - n_db) / 20.0)).astype(np.float32)


class CollateWavsSLU:
    """Items -> a fixed-size batch: ``x`` bucket-padded, ``w``, ``len`` and
    ``y_intent`` (slot ids; or one-hot labels, EOS-padded to a multiple of
    16 steps, with their true lengths ``y_len``)."""

    def __init__(self, Sy_intent, seq2seq, batch_size):
        self.Sy_intent = Sy_intent
        self.seq2seq = seq2seq
        self.batch_size = batch_size
        if seq2seq:
            self.num_labels = len(Sy_intent)
            self.eos = Sy_intent.index("<eos>")

    def __call__(self, items):
        x, w, lengths = pad_wave_batch([x for x, _ in items], self.batch_size, WAVE_BUCKET_QUANT)
        if not self.seq2seq:
            y = np.zeros((self.batch_size, len(SLOTS)), np.int32)
            for i, (_, y_) in enumerate(items):
                y[i] = y_
            return {"x": x, "y_intent": y, "w": w, "len": lengths}
        u_max = pad_to_bucket(max(len(y_) for _, y_ in items), LABEL_BUCKET_QUANT)
        ids = np.full((self.batch_size, u_max), self.eos, np.int64)
        y_len = np.zeros((self.batch_size,), np.int32)
        for i, (_, y_) in enumerate(items):
            ids[i, : len(y_)] = y_
            y_len[i] = len(y_)
        onehot = np.zeros((self.batch_size, u_max, self.num_labels), np.float32)
        np.put_along_axis(onehot, ids[:, :, None], 1.0, axis=2)
        return {"x": x, "y_intent": onehot, "w": w, "len": lengths, "y_len": y_len}


# ---------------------------------------------------------------------------
# ASR (LibriSpeech + forced alignments)
# ---------------------------------------------------------------------------


def get_ASR_datasets(config):
    """(train, valid, test) :class:`ASRDataset` from the alignment TextGrids
    under ``asr_path/text/{train*,dev*,test*}/*/*/``; attaches
    ``num_phonemes``. Reads ``pretraining/phonemes.txt`` and ``words.txt``,
    or builds them from the valid split (the phonemes in first-appearance
    order with stress digits stripped, the ``vocabulary_size`` most common
    words) and writes them."""
    base_path = config.asr_path
    splits = {}
    for split, pattern in (("train", "train*"), ("valid", "dev*"), ("test", "test*")):
        tg = sorted(glob.glob(os.path.join(base_path, "text", pattern, "*", "*", "*.TextGrid")))
        splits[split] = ([p.replace("text", "audio").replace(".TextGrid", ".wav") for p in tg], tg)

    phones_path = os.path.join(config.folder, "pretraining", "phonemes.txt")
    words_path = os.path.join(config.folder, "pretraining", "words.txt")
    if os.path.isfile(phones_path) and os.path.isfile(words_path):
        with open(phones_path) as f:
            Sy_phoneme = [line.rstrip("\n") for line in f if line.rstrip("\n") != ""]
        with open(words_path) as f:
            Sy_word = [line.rstrip("\n") for line in f]
    else:
        print("Getting vocabulary...")
        phoneme_counter: Counter = Counter()
        word_counter: Counter = Counter()
        for path in splits["valid"][1]:
            tiers = read_textgrid(path)
            phoneme_counter.update(iv.mark.rstrip("0123456789") for iv in tiers["phones"] if iv.mark != "")
            word_counter.update(iv.mark for iv in tiers["words"])
        Sy_phoneme = list(phoneme_counter)
        Sy_word = [w for w, _ in word_counter.most_common(config.vocabulary_size)]
        for path, lines in ((phones_path, Sy_phoneme), (words_path, Sy_word)):
            # beside it, then over it: the ranks of a group each write the same
            # file, and a rank that reads it meanwhile sees all of it or nothing
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.writelines(line + "\n" for line in lines)
            os.replace(tmp, path)
    config.num_phonemes = len(Sy_phoneme)
    print("Done.")
    return tuple(ASRDataset(*splits[s], Sy_phoneme, Sy_word, config, shuffle=(s == "train"))
                 for s in ("train", "valid", "test"))


class ASRDataset:
    """LibriSpeech wav + TextGrid alignment dataset. An item is a random crop
    of ~N(pretraining_length_mean, pretraining_length_var) s (at least 0.5 s)
    with its per-sample phoneme and word ids (-1 for silence and unknown
    words) strided down to the two stacks' frame rates."""

    def __init__(self, wav_paths, textgrid_paths, Sy_phoneme, Sy_word, config, shuffle=False):
        self.wav_paths = wav_paths
        self.textgrid_paths = textgrid_paths
        self.length_mean = config.pretraining_length_mean
        self.length_var = config.pretraining_length_var
        self.Sy_phoneme = Sy_phoneme
        self.Sy_word = Sy_word
        self._phoneme_ids = {p: i for i, p in enumerate(Sy_phoneme)}
        self._word_ids = {w: i for i, w in enumerate(Sy_word)}
        self.phone_downsample_factor = config.phone_downsample_factor
        self.word_downsample_factor = config.word_downsample_factor
        self._rng = np.random.default_rng(config.seed)
        collate = CollateWavsASR(config.pretraining_batch_size, self.phone_downsample_factor,
                                 self.word_downsample_factor)
        self.loader = BatchLoader(self, config.pretraining_batch_size, collate, shuffle=shuffle,
                                  seed=config.seed)

    def __len__(self):
        return len(self.wav_paths)

    def __getitem__(self, idx):
        x, fs = read_wav(self.wav_paths[idx])
        tiers = read_textgrid(self.textgrid_paths[idx])

        def ids(tier, lookup):
            parts = [np.full(round((iv.maxTime - iv.minTime) * fs), lookup(iv), np.int32) for iv in tier]
            return np.concatenate(parts) if parts else np.zeros(0, np.int32)

        y_phoneme = ids(tiers["phones"], lambda iv: -1 if iv.mark == "" else
                        self._phoneme_ids.get(iv.mark.rstrip("0123456789"), -1))
        y_word = ids(tiers["words"], lambda iv: self._word_ids.get(iv.mark, -1))

        random_length = round(fs * max(self.length_mean + self.length_var * self._rng.standard_normal(), 0.5))
        start = 0 if len(x) <= random_length else int(self._rng.integers(0, len(x) - random_length))
        end = start + random_length
        return (x[start:end], y_phoneme[start:end: self.phone_downsample_factor],
                y_word[start:end: self.word_downsample_factor])


class CollateWavsASR:
    """Items -> a fixed-size batch: ``x`` bucket-padded with zeros, ``w``,
    ``len``, and ``y_phoneme``/``y_word`` padded with -1 to ``ceil(t_pad /
    ds)`` frames of each rate (the encoder's ceil frames may differ by one:
    the loss trims)."""

    def __init__(self, batch_size, phone_ds, word_ds):
        self.batch_size = batch_size
        self.phone_ds = phone_ds
        self.word_ds = word_ds

    def __call__(self, items):
        x, w, lengths = pad_wave_batch([x for x, _, _ in items], self.batch_size, WAVE_BUCKET_QUANT)
        t_pad = x.shape[1]
        n_phone, n_word = -(-t_pad // self.phone_ds), -(-t_pad // self.word_ds)
        y_phoneme = np.full((self.batch_size, n_phone), -1, np.int32)
        y_word = np.full((self.batch_size, n_word), -1, np.int32)
        for i, (_, yp, yw) in enumerate(items):
            y_phoneme[i, : len(yp)] = yp[:n_phone]
            y_word[i, : len(yw)] = yw[:n_word]
        return {"x": x, "y_phoneme": y_phoneme, "y_word": y_word, "w": w, "len": lengths}
