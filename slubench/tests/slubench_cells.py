"""The cells the tests use: the benchmark's own, and tiny copies of each,
for runs of the drivers on the CPU through the program's plain PyTorch
path."""

from __future__ import annotations

import copy

from slubench.cell import Cell, load_benchmark, load_cell


def full_cell(name: str) -> Cell:
    """Cell ``name`` at its own size, from BENCHMARK.json."""
    return load_cell(load_benchmark(), name)


def tiny_cell(name: str, workdir: str) -> Cell:
    """Cell ``name`` with every width and length cut to a CPU test's size;
    the limits are the cell's own."""
    cell = copy.deepcopy(full_cell(name))
    cfg = cell.conf["cfg"]
    cfg["phoneme_module"].update({"cnn_n_filt": "8,6,6", "cnn_len_filt": "41,5,5", "phone_rnn_num_hidden": "8,8"})
    cfg["word_module"].update({"word_rnn_num_hidden": "8,8", "vocabulary_size": "50"})
    cfg["intent_module"].update({"intent_encoder_dim": "8", "intent_decoder_dim": "16",
                                 "intent_decoder_key_dim": "8", "intent_decoder_value_dim": "8"})
    cell.conf["labels"] = ["<sos>"] + list("abcdefghij") + ["<eos>"]
    cell.conf["serve"].update({"max_batch": 4, "max_decode_len": 6})
    cell.mix.update({"clients": 8, "pool": 16, "length_min_s": 0.3, "length_max_s": 1.0, "length_mean_s": 0.5,
                     "check_requests": 4})
    cell.workdir = workdir
    return cell
