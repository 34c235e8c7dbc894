"""The flagship fixed-slot model at full width, with seeded random weights.

The topology of ``experiments/no_unfreezing.cfg``: sinc conv of 80 filters
and 401 taps at stride 80, two 5-tap convs of 60 channels, four bi-GRU
layers of H = 128 each followed by a ceil avg-pool of 2, and an intent
bi-GRU of H = 128. Its slots are shaped as Fluent Speech Commands' are
(6 actions, 14 objects, 4 locations; 42 phonemes). The trained weights are
not in the repo, so the weights are random, made from ``seed``.
"""

from __future__ import annotations

import os

from tpu_slu.config import read_config
from tpu_slu_torch.models.slu import Model

FLAGSHIP_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                            "experiments", "no_unfreezing.cfg")


def flagship_model(device="cpu", seed: int = 0) -> Model:
    """The flagship ``Model`` in eval mode on ``device``; needs no file but the cfg."""
    config = read_config(FLAGSHIP_CFG, make_dirs=False)
    Model.attach_vocab(config, {
        "seq2seq": False,
        "Sy_intent": {"action": {f"a{i}": i for i in range(6)},
                      "object": {f"o{i}": i for i in range(14)},
                      "location": {f"l{i}": i for i in range(4)}},
        "values_per_slot": [6, 14, 4],
        "num_phonemes": 42,
    })
    return Model(config, seed=seed, load_pretrained=False).eval().to(device)
