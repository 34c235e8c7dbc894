"""What the drivers share: the program's config from a configuration file,
and the shape of a driver's result."""

from __future__ import annotations

import dataclasses
import os
import sys
import time

from slubench.reference.model import Arch


def port_config(conf: dict, workdir: str):
    """The program's ``Config`` of a configuration file: its sections
    written out as a .cfg in ``workdir`` and read by the program's own
    parser, the experiment folder set to ``workdir``."""
    from tpu_slu_torch.config import read_config

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "experiment.cfg")
    with open(path, "w") as f:
        for section, keys in conf["cfg"].items():
            f.write(f"[{section}]\n" + "".join(f"{k}={v}\n" for k, v in keys.items()) + "\n")
    config = read_config(path, make_dirs=False)
    config.folder = workdir
    arch = Arch(conf)
    config.num_phonemes = arch.num_phonemes
    if arch.seq2seq:
        from tpu_slu_torch.models.slu import Model

        Model.attach_vocab(config, {"seq2seq": True, "Sy_intent": list(arch.labels), "values_per_slot": None,
                                    "num_phonemes": arch.num_phonemes})
    return config


@dataclasses.dataclass
class Result:
    """What a driver hands the harness. ``end_to_end``: name -> value of
    the untraced window; ``ctx``: what the per-layer readers read
    (``trace``, and the driver's record of the traced window);
    ``checks``: (name, value, limit) of each number that decides
    ``correct``, each passing when its value is at most its limit."""

    end_to_end: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    ctx: dict
    checks: list


class Marks:
    """The set-up's phases on the host clock, printed on standard error so
    that a run shows where its set-up went."""

    def __init__(self, t_process: float):
        self.t_process = self.last = t_process
        self.phases: list[tuple[str, float]] = []

    def __call__(self, phase: str) -> None:
        now = time.time()
        self.phases.append((phase, now - self.last))
        self.last = now

    def report(self) -> None:
        print("slubench: set-up " + ", ".join(f"{p} {s:.3f} s" for p, s in self.phases), file=sys.stderr)
