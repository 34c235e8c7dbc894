#!/usr/bin/env python3
"""Settle where K7's beam search parts from the plain search: a tie, or a fault?

    python3 tools/k7_tie_replay.py [--B 133] [--W 25] [--U 200]

Runs K7 (``beam_fused.beam_decode``) and its plain version
(``beam.beam_search_reference``) on the card at the flagship decoder
(``all_real_seq2seq.cfg``) on the seeded case of
``tests/test_torch_cuda.py::test_k7_plan_boundary_on_small_clusters``
(``k7_inputs(B + W, B, 25, ...)``, valid frames from ``default_rng(B)``).
For each row whose tokens differ it finds the step u where the two
searches' beams first differ (``chip_smoke.parting_step``), then replays
in f64 on the CPU every hypothesis of both searches' beams after u + 1
steps and every extension of their common beams after u steps: a copy of
the decoder in f64 is teacher-forced along each token prefix and its
log-probabilities summed in f64. It prints, per row:

* the exact (f64) scores of both beam sets, and which set the exact scores
  prefer: the exact top-W of the common beams' W x L extensions;
* the hypotheses the two sets do not share, their exact scores and the
  gap between them, against the f32 drift of u + 1 summed steps
  (``chip_smoke.tie_tolerance``);
* each search's own f32 scores against the exact ones (its drift);
* a verdict: ``tie`` where the exact gap between the differing members is
  within the drift, else ``fault`` naming the search that took the lower
  member.

The last line is one JSON object with those numbers. Run from the root of
a checkout on a machine with one GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replay_scores(dec64, keys64, values64, n_valid, prefixes):
    """Exact scores of token prefixes (N, u) of one utterance: the f64
    decoder teacher-forced along each, the log-probabilities of its tokens
    summed in f64 (the search's first input is all zeros). Returns (scores
    (N,), the last step's log-probabilities (N, L))."""
    import torch
    import torch.nn.functional as F

    from tpu_slu_torch.ops.beam import decoder_step

    N, u = prefixes.shape
    L = dec64.linear.out_features
    keys, values = keys64.expand(N, -1, -1), values64.expand(N, -1, -1)
    mask = (torch.arange(keys.shape[1])[None, :] < n_valid).expand(N, -1)
    state = dec64.initial_state[None].expand((N,) + tuple(dec64.initial_state.shape))
    score = torch.zeros(N, dtype=torch.float64)
    y_prev = torch.zeros((N, L), dtype=torch.float64)
    lp = None
    for k in range(u + 1):
        state, lp = decoder_step(dec64, keys, values, state, y_prev, mask=mask)
        if k < u:
            tok = prefixes[:, k]
            score = score + lp.gather(1, tok[:, None])[:, 0]
            y_prev = F.one_hot(tok, L).double()
    return score, lp


def settle_row(b, u, ours, ref, common, dec64, keys64, values64, n_valid, W):
    """The f64 replay of row ``b`` parting at step ``u``: ``ours``/``ref``
    (scores (W,), tokens (W, u + 1)) of K7 and the plain search after u + 1
    steps; ``common`` the tokens (W, u) both held after u steps."""
    import chip_smoke as cs
    import torch

    L = dec64.linear.out_features
    base, lp = replay_scores(dec64, keys64, values64, n_valid, common)
    ext = base[:, None] + lp
    if u == 0:
        ext[1:] = float("-inf")  # at the first step only beam 0's extensions compete
    ext = ext.reshape(-1)  # exact scores of the W x L extensions
    order = torch.sort(ext, descending=True, stable=True).indices[:W]
    exact_top = {(int(i) // L, int(i) % L) for i in order}

    def as_set(tokens):
        # a beam after u + 1 steps: its parent among the common beams and its new token
        out = set()
        for w in range(W):
            parent = next(p for p in range(W) if torch.equal(common[p], tokens[w, :u]))
            out.add((parent, int(tokens[w, u])))
        return out

    def exact_of(tokens):  # the exact score of each beam, in the search's order
        return [float(ext[p * L + t]) for p, t in (
            (next(q for q in range(W) if torch.equal(common[q], tokens[w, :u])), int(tokens[w, u]))
            for w in range(W))]

    searches = {"K7": ours, "plain": ref}
    sets = {k: as_set(v[1]) for k, v in searches.items()}
    exact = {k: exact_of(v[1]) for k, v in searches.items()}
    # where the two beams differ, position by position: their exact scores' difference
    diff = [w for w in range(W) if not torch.equal(ours[1][w], ref[1][w])]
    gap = max(abs(exact["K7"][w] - exact["plain"][w]) for w in diff)
    drift = {k: (searches[k][0].double() - torch.tensor(exact[k], dtype=torch.float64)).abs().max().item()
             for k in searches}
    ranked = {k: all(a >= b for a, b in zip(exact[k], exact[k][1:])) for k in searches}
    tol = cs.tie_tolerance(u + 1, ref[0].tolist())
    wrong = [k for k in searches if sets[k] != exact_top or not ranked[k]]
    verdict = "tie" if gap <= tol else "fault: " + (", ".join(wrong) or "neither set nor order off the exact")
    sorted_gap = (ours[0].double() - ref[0].double()).abs().max().item()
    print(f"[replay] row {b}: beams part at step {u} (equal after {u} steps) at positions {diff}; sorted f32 beam "
          f"scores {sorted_gap:.4g} apart, f32 drift bound of {u + 1} steps {tol:.4g}")
    for k in searches:
        print(f"[replay]   {k:5s} beams at those positions (parent beam, token) "
              f"{[sorted(as_set(searches[k][1][w:w + 1].expand(W, -1)))[0] for w in diff]}, exact scores "
              f"{[f'{exact[k][w]:.10f}' for w in diff]}; f32 scores {[f'{float(searches[k][0][w]):.6f}' for w in diff]}"
              f", all within {drift[k]:.4g} of exact; its set {'is' if sets[k] == exact_top else 'is NOT'} the exact "
              f"top-{W}, its order {'is' if ranked[k] else 'is NOT'} the exact order")
    print(f"[replay]   exact gap between the differing beams {gap:.4g}; verdict: {verdict}")
    return {"row": b, "step": u, "positions": diff, "sorted_f32_gap": sorted_gap, "tolerance": tol,
            "exact_gap": gap, "drift": drift, "same_set": sets["K7"] == sets["plain"],
            "exact_set": {k: sets[k] == exact_top for k in searches}, "exact_order": ranked,
            "exact_at_positions": {k: [exact[k][w] for w in diff] for k in searches}, "verdict": verdict}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=133)
    ap.add_argument("--W", type=int, default=25)
    ap.add_argument("--U", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from tests.test_torch_cuda import FLAGSHIP_DECODER, k7_inputs
    from tpu_slu_torch.ops.attention import attention_kv
    from tpu_slu_torch.ops.beam import beam_search_reference
    from tpu_slu_torch.ops.beam_fused import beam_decode

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.smi()
    print(f"[env] {card}")
    B, W, U = args.B, args.W, args.U
    seed = B + W
    dec, keys, values = k7_inputs(seed, B, 25, *FLAGSHIP_DECODER, dev)
    n = torch.from_numpy(np.random.default_rng(B).integers(1, 26, B)).to(dev)
    dec64 = copy.deepcopy(dec).cpu().double()
    enc = np.random.default_rng(seed).standard_normal((B, 25, 256))  # k7_inputs' encoder states, in f64
    with torch.inference_mode():
        keys64, values64 = attention_kv(dec64.attention, torch.from_numpy(enc.astype(np.float32)).double())

    def search(fn):
        cache = {}

        def steps(n_steps):
            if n_steps not in cache:
                with torch.inference_mode():
                    cache[n_steps] = tuple(t.cpu() for t in fn(dec, keys, values, n, W, n_steps))
            return cache[n_steps]
        return steps

    run, ref_run = search(beam_decode), search(beam_search_reference)
    got, ref = run(U), ref_run(U)
    rows = [b for b in range(B) if not torch.equal(got[1][:, b], ref[1][:, b])]
    print(f"[replay] K7 against the plain search, flagship decoder, B={B} W={W} U={U}, seed {seed}: rows whose "
          f"tokens differ {rows} on {card}")
    results = []
    with torch.inference_mode():
        for b in rows:
            u = cs.parting_step(run, ref_run, U, b)
            ours = tuple(t[:, b] for t in run(u + 1))
            theirs = tuple(t[:, b] for t in ref_run(u + 1))
            common = run(u)[1][:, b] if u > 0 else torch.zeros((W, 0), dtype=torch.int64)
            results.append(settle_row(b, u, ours, theirs, common, dec64, keys64[b:b + 1], values64[b:b + 1],
                                      int(n[b]), W))
    print(json.dumps({"case": {"B": B, "W": W, "U": U, "seed": seed}, "card": card, "rows": results}))


if __name__ == "__main__":
    main()
