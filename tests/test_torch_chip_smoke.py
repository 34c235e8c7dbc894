"""The developer copies of ``chip_smoke.py`` (``VARIANTS``) edit kernel text
that exists.

Each variant is a copy of ``tpu_slu_torch/csrc`` with some exact texts
replaced, compiled on the card beside the port's library for an A/B or a
trace. A text that no longer occurs (the template's lines changed) or occurs
in several files would stop the smoke on the card; here it fails on the CPU,
with no compiler.
"""

import os

import pytest

import chip_smoke
from tpu_slu_torch.ops import _build


def _sources() -> dict:
    texts = {}
    for fn in os.listdir(_build.CSRC):
        with open(os.path.join(_build.CSRC, fn)) as f:
            texts[fn] = f.read()
    return texts


@pytest.mark.parametrize("name", sorted(chip_smoke.VARIANTS))
def test_variant_edits_apply_to_one_source(name):
    source, edits, flags = chip_smoke.VARIANTS[name]
    texts = _sources()
    assert source in texts and source.endswith(".cu")
    for old, new in edits:
        assert old != new
        assert len([fn for fn, t in texts.items() if old in t]) == 1, old


def test_other_size_variants_invert_only_the_two_direction_rule():
    """K1's, K2's and K4f's A/B copies change the two-direction cluster rule
    and nothing of K5f's one-direction rule."""
    sizes = {}
    for name in ("k1_other_c", "k2_other_c", "k4f_other_c"):
        (rule, inverted), _ = chip_smoke.VARIANTS[name][1]
        sizes[name] = inverted
        assert rule.startswith("*C = (ndir == 1 ? 4 * B <= sms : ")
        assert inverted.startswith("*C = (ndir == 1 ? 4 * B <= sms : ") and inverted != rule
    assert len(set(sizes.values())) == 1
