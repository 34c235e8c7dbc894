"""The flagship models at full width, with seeded random weights.

The fixed-slot model has the topology of ``experiments/no_unfreezing.cfg``
(and of ``no_pretraining.cfg``, which trains it from scratch): sinc conv of
80 filters and 401 taps at stride 80, two 5-tap convs of 60 channels, four
bi-GRU layers of H = 128 each followed by a ceil avg-pool of 2, and an
intent bi-GRU of H = 128. Its slots are shaped as Fluent Speech Commands'
are (6 actions, 14 objects, 4 locations; 42 phonemes). The seq2seq model has
the same encoder and the head of ``experiments/all_real_seq2seq.cfg``: one
bi-GRU encoder layer of H = 128, two decoder GRUCells of H = 256, keys of
100 and values of 200, over the 102 labels of the character vocabulary the
JAX package builds (``<sos>``, the printable characters, ``<eos>``). The
trained weights are not in the repo, so the weights are random, made from
``seed``.
"""

from __future__ import annotations

import os
import string

from tpu_slu_torch.config import read_config
from tpu_slu_torch.device import entry_device
from tpu_slu_torch.models.slu import Model

_EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                            "experiments")
FLAGSHIP_CFG = os.path.join(_EXPERIMENTS, "no_unfreezing.cfg")
# the same widths, trained from scratch: every layer trains from step 1
TRAIN_CFG = os.path.join(_EXPERIMENTS, "no_pretraining.cfg")
SEQ2SEQ_CFG = os.path.join(_EXPERIMENTS, "all_real_seq2seq.cfg")
# the overrides that make every GRU layer unidirectional, as a cfg's
# *_rnn_bidirectional=False does: flagship_model(device, **UNIDIRECTIONAL)
# is the flagship's unidirectional model (four phone/word layers and the
# intent layer of H = 128, each one direction), run by K5f and K5b on the card
UNIDIRECTIONAL = {"phone_rnn_bidirectional": False, "word_rnn_bidirectional": False,
                  "intent_rnn_bidirectional": False}
# tpu_slu/data/datasets.py: <sos>, the sorted set of the semantics' characters
# and string.printable (the semantics are printable), <eos>
SEQ2SEQ_LABELS = ["<sos>"] + sorted(set(string.printable)) + ["<eos>"]
# the fixed-slot vocabulary, shaped as Fluent Speech Commands' (Model.attach_vocab)
FLAGSHIP_VOCAB = {
    "seq2seq": False,
    "Sy_intent": {"action": {f"a{i}": i for i in range(6)},
                  "object": {f"o{i}": i for i in range(14)},
                  "location": {f"l{i}": i for i in range(4)}},
    "values_per_slot": [6, 14, 4],
    "num_phonemes": 42,
}


def flagship_model(device=None, seed: int = 0, cfg: str = FLAGSHIP_CFG, **overrides) -> Model:
    """The flagship ``Model`` of ``cfg`` in eval mode on ``device`` (the GPU
    by default; raises without one); needs no file but the cfg (no
    pretrained encoder is loaded). ``overrides`` set config attributes
    before the model is built (``intent_rnn_drop=[0.0]``)."""
    device = entry_device(device)
    config = read_config(cfg, make_dirs=False)
    for k, v in overrides.items():
        setattr(config, k, v)
    Model.attach_vocab(config, FLAGSHIP_VOCAB)
    return Model(config, seed=seed, load_pretrained=False).eval().to(device)


def flagship_seq2seq_model(device=None, seed: int = 0, **overrides) -> Model:
    """The flagship seq2seq ``Model`` of ``all_real_seq2seq.cfg`` in eval
    mode on ``device`` (the GPU by default; raises without one), as
    :func:`flagship_model`; ``seq2seq_max_decode_len`` is among the
    ``overrides`` (default 200)."""
    device = entry_device(device)
    config = read_config(SEQ2SEQ_CFG, make_dirs=False)
    for k, v in overrides.items():
        setattr(config, k, v)
    Model.attach_vocab(config, {"seq2seq": True, "Sy_intent": list(SEQ2SEQ_LABELS),
                                "values_per_slot": None, "num_phonemes": 42})
    return Model(config, seed=seed, load_pretrained=False).eval().to(device)
