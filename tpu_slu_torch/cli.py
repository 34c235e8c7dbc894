"""The command line of the port, with the flags of ``tpu_slu/cli.py``:

    python -m tpu_slu_torch.cli --pretrain [--restart] --config_path exp.cfg [--device cpu]
    python -m tpu_slu_torch.cli --train [--restart] --config_path exp.cfg [--device cpu]
    python -m tpu_slu_torch.cli --decode --wav test.wav --config_path exp.cfg [--device cpu]

``--pretrain`` trains the ASR encoder on the config's LibriSpeech alignments
(``asr_path``) and writes ``<folder>/pretraining/``: ``phonemes.txt``,
``words.txt``, ``log.csv``, ``model_state.npz`` and ``trainer_state.npz``
after every epoch. ``--train`` trains the SLU model on the config's SLU
dataset (``slu_path``), its encoder loaded from ``pretraining/`` when
``pretraining_type`` is not 0, writes ``<folder>/training/`` (``log.csv``,
``model_state.npz``, ``trainer_state.npz``, ``vocab.json``) after every
epoch and ends with a test pass. ``--restart`` resumes either from its
folder's checkpoint. ``--decode`` prints the intent of one wav (a list of
slot values, or a seq2seq model's semantics string) from ``training/``.
The files are the JAX package's: either package reads what the other
wrote. Runs on the GPU unless ``--device`` says otherwise.

Data-parallel training runs one process a GPU under ``torchrun``:

    torchrun --nproc_per_node=N -m tpu_slu_torch.cli --train --config_path exp.cfg

Each rank trains on its shard of every epoch at the config's batch size
(the global batch is N times it; ``tpu_slu_torch.parallel``); rank 0 writes
the files. With ``--device cpu`` the ranks run on the CPU over gloo.
``--decode`` runs on rank 0 alone. ``model_parallel=M`` in the cfg's
``[training]`` lays the N ranks out as an (N/M, M) grid, the vocab heads
column-sharded over each data index's M ranks (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse

import numpy as np

from tpu_slu_torch import parallel
from tpu_slu_torch.config import read_config


def pretrain(config, device, restart: bool) -> None:
    from tpu_slu_torch.data.datasets import get_ASR_datasets
    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.training.trainer import Trainer

    train_dataset, valid_dataset, _ = get_ASR_datasets(config)
    trainer = Trainer(PretrainedModel(config).to(device), config)
    if restart:
        trainer.load_checkpoint()
    n = config.pretraining_num_epochs
    for epoch in range(n):
        print(f"========= Epoch {epoch + 1} of {n} =========")
        tpa, tpl, twa, twl = trainer.train(train_dataset)
        vpa, vpl, vwa, vwl = trainer.test(valid_dataset)
        print(f"========= Results: epoch {epoch + 1} of {n} =========")
        print(f"*phonemes*| train accuracy: {tpa:.2f}| train loss: {tpl:.2f}| valid accuracy: {vpa:.2f}| "
              f"valid loss: {vpl:.2f}\n")
        print(f"*words*| train accuracy: {twa:.2f}| train loss: {twl:.2f}| valid accuracy: {vwa:.2f}| "
              f"valid loss: {vwl:.2f}\n")
        trainer.save_checkpoint()


def train(config, device, restart: bool) -> None:
    from tpu_slu_torch.data.datasets import get_SLU_datasets
    from tpu_slu_torch.models.slu import Model
    from tpu_slu_torch.training.trainer import Trainer

    train_dataset, valid_dataset, test_dataset = get_SLU_datasets(config)
    trainer = Trainer(Model(config).to(device), config)
    if restart:
        trainer.load_checkpoint()
    n = config.training_num_epochs
    for epoch in range(n):
        print(f"========= Epoch {epoch + 1} of {n} =========")
        tia, til = trainer.train(train_dataset)
        via, vil = trainer.test(valid_dataset)
        print(f"========= Results: epoch {epoch + 1} of {n} =========")
        print(f"*intents*| train accuracy: {tia:.2f}| train loss: {til:.2f}| valid accuracy: {via:.2f}| "
              f"valid loss: {vil:.2f}\n")
        trainer.save_checkpoint()
    test_ia, test_il = trainer.test(test_dataset, log_set="test")
    print("========= Test results =========")
    print(f"*intents*| test accuracy: {test_ia:.2f}| test loss: {test_il:.2f}\n")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tpu_slu_torch.cli")
    parser.add_argument("--pretrain", action="store_true", help="run ASR pre-training")
    parser.add_argument("--train", action="store_true", help="run SLU training")
    parser.add_argument("--restart", action="store_true", help="load checkpoint from a previous run")
    parser.add_argument("--decode", action="store_true",
                        help="decode intents for --wav using the trained SLU checkpoint")
    parser.add_argument("--wav", type=str, help="wav file for --decode")
    parser.add_argument("--config_path", type=str, required=True,
                        help="path to config file with hyperparameters, etc.")
    parser.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = parser.parse_args(argv)
    if args.decode and not args.wav:
        parser.error("--decode requires --wav")

    device = parallel.init_from_env(args.device)
    try:
        config = read_config(args.config_path)
        np.random.seed(config.seed)
        if args.pretrain:
            pretrain(config, device, args.restart)
        if args.train:
            train(config, device, args.restart)
        if args.decode and parallel.rank() == 0:
            from tpu_slu_torch.data.audio import read_wav
            from tpu_slu_torch.serving import load_trained_model

            model = load_trained_model(config, device=device)
            signal, _ = read_wav(args.wav)
            print(model.decode_intents(signal[None, :])[0])
    finally:
        parallel.destroy()


if __name__ == "__main__":
    main()
