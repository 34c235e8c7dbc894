"""The yardstick's operation and byte counts against numbers worked out by
hand at the flagship shapes (widths of experiments/all_real_seq2seq.cfg:
sinc 80 x 401 / 80, convs 60 x 5, bi-GRUs of H=128, decoder cells of
H=256, keys 100, values 200, 102 labels)."""

import pytest

from slubench_cells import full_cell
from slubench.reference.model import Arch
from slubench.work import (
    PEAK_BYTES,
    PEAK_F32,
    bound_s,
    decode_flops,
    encoder_fwd_flops,
    gru_fwd_flops,
    k7_call_bound_s,
    k7_work,
)


def arch(name):
    return Arch(full_cell(name).conf)


def test_gru_forward_row():
    # 2 directions x (2 x 3H x (D + H) + 20 H) at D = 60, H = 128
    assert gru_fwd_flops(1, 60, 128) == 2 * (2 * 384 * 188 + 2560) == 293_888


def test_a_bound_is_the_larger_of_its_two_times():
    assert bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)
    assert PEAK_BYTES == 3.35e12 and PEAK_F32 == 67e12


def test_encoder_forward_of_one_second():
    # sinc 2*80*401*200, convs 2*60*80*5*100 + 2*60*60*5*100, bi-GRUs at 100, 50, 25, 13 frames
    assert encoder_fwd_flops(arch("s2s_serve_closed"), 16000) == 102_975_872


def test_k7_of_sixteen_utterances_matches_the_smoke_bound():
    flops, nbytes = k7_work(25, 4, 200, 2, 256, 100, 200, 102)
    assert flops == 2_009_236 * 800
    assert 16 * flops / PEAK_F32 * 1e3 == pytest.approx(0.3839, abs=5e-5)  # PERF.md's K7 bound at B=16, T=25
    assert nbytes < flops / PEAK_F32 * PEAK_BYTES  # operations bind


def test_k7_call_bound_counts_real_rows_only():
    a = arch("s2s_serve_closed")
    n = 64000  # 4 s: 25 frames after the four pools
    assert a.frames(n)[-1] == 25
    one = k7_call_bound_s(a, [n], 4, 200)
    assert k7_call_bound_s(a, [n, 0, 0, 0], 4, 200) == one
    assert k7_call_bound_s(a, [n] * 16, 4, 200) == pytest.approx(0.3839e-3, abs=5e-8)


def test_decode_flops_add_the_encoders_and_the_search():
    a = arch("s2s_serve_closed")
    n = 64000
    t = 25
    enc = encoder_fwd_flops(a, n) + 2 * t * (2 * 384 * (256 + 128) + 20 * 128) \
        + 2 * t * 256 * 300
    assert decode_flops(a, n, 4, 200) == enc + k7_work(t, 4, 200, 2, 256, 100, 200, 102)[0]
