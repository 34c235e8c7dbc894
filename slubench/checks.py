"""The comparisons that decide ``correct``: the program's outputs against the
plain reference (:mod:`slubench.reference.model`), number by number.

Serving (``s2s_serve_closed``): a sample of answered requests, drawn from
the seed with the longest among them. The program's hypotheses of each
(the W scores and token sequences of its search, best first) come from the
same model object's public ``predict_intents``, run once the window has
closed on the batch that served the request, rebuilt row for row. Each
request's waveform goes alone, at its exact length, through the reference,
which runs its own search and teacher-forces the program's hypotheses:

* ``answer_mismatches``: served strings that differ from the reference's
  rendering of the program's best hypothesis, plus sampled requests whose
  serving batch could not be found (limit 0);
* ``score_gap_mean``: the mean over the samples of each one's largest
  |program's score - reference's score| of a returned hypothesis, in nats
  (both a running f32 sum of the steps' log-probabilities, as the search
  keeps it): the search scored what it kept. The mean, not the largest:
  the f32 running sum's rounding (~2e-3 nats off an f64 sum at ~900) now
  and then takes another path for one sample, in sound runs too;
* ``search_gap``: the largest amount, in nats, by which the reference's own
  best score lies above the reference's score of the program's best
  hypothesis, less twice that sample's score gap (an order the two
  scorings cannot tell apart), and at least 0: the search kept, and put
  first, what it should have;
* ``unanswered``: requests that failed or never came (limit 0).
"""

from __future__ import annotations

import numpy as np
import torch

from slubench.reference import model as ref


def serve_gaps(p: dict, arch, samples: list[dict], W: int, U: int) -> dict:
    """Per sample of ``samples`` (each ``wav``, the float32 waveform;
    ``served``, the answer string; ``tokens`` (W, U) and ``scores`` (W,) of
    the hypotheses returned, best first): ``mismatch``, whether the served
    string differs from the reference's rendering of the best hypothesis;
    ``score_gap``, the largest |program's score - reference's score| of a
    hypothesis; ``search_gap``, the reference's own best score less its
    score of the program's best; ``top2``, the reference's best less its
    second best."""
    with ref.f32_matmuls(False):
        feats = [ref.seq2seq_features(p, arch, torch.as_tensor(s["wav"], device=_dev(p))) for s in samples]
        keys, values, mask = ref.pad_kv(feats)
        own = ref.beam_search(p, arch, keys, values, mask, W, U)[0].double().cpu().numpy()  # (W, N)
        rows = lambda t: t.repeat_interleave(W, dim=0)  # noqa: E731
        tokens = torch.as_tensor(np.concatenate([s["tokens"] for s in samples]), device=keys.device)
        lp = ref.teacher_force(p, arch, rows(keys), rows(values), rows(mask), tokens)
    taken = lp.gather(2, tokens[:, :, None])[..., 0]  # (N W, U) f32
    score = torch.zeros_like(taken[:, 0])
    for u in range(U):  # the score as the search keeps it: a running f32 sum, step by step
        score = score + taken[:, u]
    score = score.double().view(len(samples), W).cpu().numpy()
    prog = np.stack([np.asarray(s["scores"], np.float64) for s in samples])
    return {"mismatch": np.array([s["served"] != ref.ids_to_string(s["tokens"][0], arch.labels) for s in samples]),
            "score_gap": np.abs(prog - score).max(axis=1), "search_gap": own[0] - score[:, 0],
            "top2": own[0] - own[1] if W > 1 else np.full(len(samples), np.inf)}


def serve_numbers(p: dict, arch, samples: list[dict], W: int, U: int) -> dict:
    """The numbers compared of ``samples`` (as :func:`serve_gaps` takes
    them)."""
    if not samples:  # the caller counts what it could not sample as mismatches
        return {"answer_mismatches": 0.0, "score_gap_mean": 0.0, "search_gap": 0.0}
    g = serve_gaps(p, arch, samples, W, U)
    return {"answer_mismatches": float(g["mismatch"].sum()), "score_gap_mean": float(g["score_gap"].mean()),
            "search_gap": max(0.0, float(np.max(g["search_gap"] - 2.0 * g["score_gap"])))}


def reference_serve(p: dict, arch, wavs: list[np.ndarray], W: int, U: int, tf32: bool = False,
                    skip_best_at: int | None = None) -> list[dict]:
    """The reference's own searches of ``wavs``, as :func:`serve_numbers`
    takes samples, to put in the program's place: the lower-precision
    control (``tf32``) or a planted selection fault (``skip_best_at``)."""
    with ref.f32_matmuls(tf32):
        feats = [ref.seq2seq_features(p, arch, torch.as_tensor(w, device=_dev(p))) for w in wavs]
        scores, tokens = ref.beam_search(p, arch, *ref.pad_kv(feats), W, U, skip_best_at=skip_best_at)
    out = []
    for i, w in enumerate(wavs):
        tok = tokens[:, i].cpu().numpy()
        out.append({"wav": w, "tokens": tok, "scores": scores[:, i].cpu().numpy(),
                    "served": ref.ids_to_string(tok[0], arch.labels)})
    return out


def _dev(p: dict) -> torch.device:
    return next(iter(p.values())).device
