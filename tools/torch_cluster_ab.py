#!/usr/bin/env python3
"""A/Bs of the port's cluster kernels on one GPU: K1's cluster size, K7's
cluster size by batch, and K7's step with parts of its design taken out.

    python3 tools/torch_cluster_ab.py [--k1-batches 1 2 4 8 12 16 64]
        [--k7-sizes] [--k7-variants base skip_gi skip_gh no_kv no_cache ...]

``--k1-batches``: K1's five flagship layers on clusters of 2 and of 4 CTAs
in turns at each batch (``chip_smoke.k1_cluster_ab``, the other size from
the smoke's ``k1_other_c`` variant). ``--k7-sizes``: the cluster size K7
takes at each batch at the flagship decoder, W = 4, 4 s. ``--k7-variants``:
each variant is ``tpu_slu_torch/csrc/beam_decode.cu`` with one text edit
(``VARIANTS``) and ``TSL_TRACE`` defined, compiled alone into
``build/variants/`` (``chip_smoke.start_variant``) and swapped in for the
kernel library's K7 entry points; K7's whole search at the flagship decoder
(W = 4, U = 200, 4 s, B = 1 and 16) is timed for each in turns (the list,
then the list reversed), with its step split by phase at B = 1 from its
trace. Every variant, ``base`` too, carries the trace's clock reads, so
the variants compare with each other, not with the served kernel. A
variant that skips work gives wrong tokens: it measures time only. Run
from the root of a checkout.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAG = (2, 256, 100, 200, 102)  # all_real_seq2seq.cfg's decoder: layers, H, K, V, L
_DOT_GI = "dot_rows<G, 3>(wi, in, off_in, in4, lane, ai);"
_DOT_GH = "dot_rows<G, 3>(wh, hprev, off_h, Hp / 4, lane, ah);"
_UNROLL = "#pragma unroll 2\n  for (int c = lane; c < n4; c += kLanes)"
# name -> [(text in beam_decode.cu or a header it includes, its replacement)]
VARIANTS = {
    "base": [],
    "skip_gi": [(_DOT_GI, "")],  # no products of the layers' inputs
    "skip_gh": [(_DOT_GH, "")],  # no recurrent products
    "skip_attention": [("for (int t0 = 0; t0 < n; t0 += kFB) {", "for (int t0 = 0; t0 < 0; t0 += kFB) {")],
    "no_kv": [("const bool kv_resident = plan + bias + kv <= kSmemLimit;", "const bool kv_resident = false;")],
    "no_cache": [("const unsigned cache = pick_cache(d, C, kSmemLimit - fixed, &smem);", "const unsigned cache = 0;")],
    "unroll1": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 1"))],
    "unroll4": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 4"))],
    "test_wait": [("mbarrier.try_wait.parity.shared::cta.b64", "mbarrier.test_wait.parity.shared::cta.b64")],
}


def k7_variants(names: list[str], dev, card: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch.models.slu import Seq2SeqArch, Seq2SeqDecoder
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.attention import attention_kv
    from tpu_slu_torch.ops.beam_fused import beam_decode

    builds = {n: cs.start_variant(f"k7_{n}", "beam_decode.cu", VARIANTS[n], ["-DTSL_TRACE"]) for n in names}
    libs = {n: cs.load_variant(f"k7_{n}", *b) for n, b in builds.items()}
    nl, H, K, V, L = FLAG
    arch = Seq2SeqArch(num_labels=L, num_encoder_layers=1, encoder_dim=128, num_decoder_layers=nl,
                       decoder_dim=H, key_dim=K, value_dim=V, sos=0)
    dec = Seq2SeqDecoder(arch, torch.Generator().manual_seed(0)).eval().to(dev)
    kv = {}
    for B in (1, 16):
        enc = np.random.default_rng(B).standard_normal((B, 25, 256)).astype(np.float32)
        with torch.inference_mode():
            kv[B] = attention_kv(dec.attention, torch.from_numpy(enc).to(dev))
    real = _build.library()
    ms = {}
    try:
        for name in names + names[::-1]:
            _build._lib = libs[name]
            for B, (keys, values) in kv.items():
                with torch.inference_mode():
                    ms.setdefault((name, B), []).append(
                        cs.cuda_ms(lambda: beam_decode(dec, keys, values, None, 4, 200), reps=10, warmup=2))
        for name in names:
            _build._lib = libs[name]
            print(f"[k7-variant] {name:15s} " + "; ".join(
                f"B={B} {ms[name, B][0]:.4f}, {ms[name, B][1]:.4f} ms" for B in kv) + f" on {card}")
            cs.k7_round_split(libs[name], dec, *kv[1], 200, sum(ms[name, 1]) / 2, card)
    finally:
        _build._lib = real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1-batches", type=int, nargs="*", default=[])
    ap.add_argument("--k7-sizes", action="store_true")
    ap.add_argument("--k7-variants", nargs="*", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.smi()
    print(f"[env] {card}")
    if args.k1_batches:
        other = cs.load_variant("k1_other_c", *cs.start_variant("k1_other_c", *cs.VARIANTS["k1_other_c"]))
        cs.k1_cluster_ab(dev, card, np.random.default_rng(0), other, tuple(args.k1_batches))
    if args.k7_sizes:
        from tpu_slu_torch.ops.beam_fused import beam_cluster_size

        sizes = {B: beam_cluster_size(B, 25, 4, *FLAG, 200) for B in
                 (1, 8, 12, 15, 16, 17, 24, 28, 30, 32, 34, 40, 64, 66, 67, 100, 133)}
        print(f"[k7-sizes] flagship decoder, W=4, 4 s: cluster size by B {sizes} on {card}")
    if args.k7_variants:
        k7_variants(args.k7_variants, dev, card)


if __name__ == "__main__":
    main()
