"""Command-line decode of one WAV file (the ``--decode`` branch of ``tpu_slu/cli.py``).

    python -m tpu_slu_torch.cli --decode --wav test.wav --config_path exp.cfg [--device cpu]

Prints the intent of the wav, as a Python list of slot values (or, for a
seq2seq model, its semantics string), from the trained checkpoint of the
config's experiment folder. ``--train``,
``--pretrain`` and ``--restart`` are not ported.
"""

from __future__ import annotations

import argparse

import numpy as np

from tpu_slu_torch.config import read_config
from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.serving import load_trained_model


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tpu_slu_torch.cli")
    parser.add_argument("--decode", action="store_true",
                        help="decode intents for --wav using the trained SLU checkpoint")
    parser.add_argument("--wav", type=str, help="wav file for --decode")
    parser.add_argument("--config_path", type=str, required=True,
                        help="path to config file with hyperparameters, etc.")
    parser.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = parser.parse_args(argv)
    if not args.decode:
        parser.error("only --decode is ported (--train, --pretrain and --restart are not)")
    if not args.wav:
        parser.error("--decode requires --wav")

    config = read_config(args.config_path)
    np.random.seed(config.seed)
    model = load_trained_model(config, device=args.device)
    signal, _ = read_wav(args.wav)
    print(model.decode_intents(signal[None, :])[0])


if __name__ == "__main__":
    main()
