"""The port's own config reader against the JAX package's, key for key."""

import glob
import os

import pytest

from tpu_slu.config import read_config as jax_read_config
from tpu_slu_torch.config import read_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "experiments", "**", "*.cfg"), recursive=True))
CFGS.append(os.path.join(REPO, "tests", "assets", "golden", "experiment.cfg.template"))


@pytest.mark.parametrize("path", CFGS, ids=lambda p: os.path.relpath(p, REPO))
def test_read_config_matches_jax(path):
    got = read_config(path, make_dirs=False).to_dict()
    assert got == jax_read_config(path, make_dirs=False).to_dict()
    assert {"seed", "folder", "cnn_N_filt", "intent_rnn_num_hidden", "mask_padding",
            "word_downsample_factor"} <= set(got)


def test_read_config_makes_the_folder_as_jax_does(tmp_path):
    src = os.path.join(REPO, "experiments", "no_unfreezing.cfg")
    with open(src) as f:
        text = f.read()
    for name, reader in (("port", read_config), ("jax", jax_read_config)):
        folder = tmp_path / name / "exp"
        cfg = tmp_path / f"{name}.cfg"
        cfg.write_text(text.replace(read_config(src, make_dirs=False).folder, str(folder), 1))
        reader(str(cfg))
        assert sorted(os.listdir(folder)) == ["experiment.cfg", "pretraining", "training"]
        assert (folder / "experiment.cfg").read_text() == cfg.read_text()


def test_missing_config_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_config(str(tmp_path / "absent.cfg"))
