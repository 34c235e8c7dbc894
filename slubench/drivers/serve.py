"""The server loop: a closed loop of clients against an in-process ``IntentServer``.

Set-up builds the seq2seq ``Model`` with the seed's weights, hands an
``IntentServer`` a :class:`Recorder` that forwards ``decode_intents`` to
it, makes the request pool, and decodes one request of each bucket length
the pool can produce (``IntentServer.warmup``). The window starts the
traffic's ``clients`` clients at once; each is a done-callback that submits
its next request as soon as its answer resolves (no think time), until the
window ends. A traced run profiles the traffic's ``trace_seconds`` of it.

The :class:`Recorder` times each device call on the host clock and notes
which requests it carried. Once the window has closed, the check's sample
of answered requests is decoded again, each in the batch that served it,
through the model's public ``predict_intents``, which returns the scores
and tokens behind each served string (:mod:`slubench.checks`).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import sys
import threading
import time

import numpy as np
import torch

from slubench import checks
from slubench.port import Marks, Result, port_config
from slubench.reference.model import Arch
from slubench.trace import Tracer
from slubench.traffic import bucket, check_generator, client_request, closed_requests, request_lengths, sub_seed
from slubench.weights import make_weights

DRAIN_S = 60.0  # how long the answers still due at the window's close are waited for
HEAD = 8  # the samples of a row's start that, with its length, name the request it carries
RATE_BIN_S = 10.0  # the window's answers a second are printed by spans of this length


class Recorder:
    """The model ``IntentServer`` is handed: forwards ``decode_intents`` and
    records each call's host span, its batch's shape and lengths, the first
    ``HEAD`` samples of each row (which name the request it carried) and
    the answers."""

    def __init__(self, model):
        self.model = model
        self.calls: list[dict] = []

    def decode_intents(self, x, bucket: bool = False, lengths=None):
        t0 = time.perf_counter()
        out = self.model.decode_intents(x, bucket=bucket, lengths=lengths)
        t1 = time.perf_counter()
        x = np.asarray(x)
        self.calls.append({"t0": t0, "t1": t1, "shape": x.shape, "lengths": np.asarray(lengths),
                           "heads": x[:, :HEAD].copy(), "answers": out})
        return out


class ClosedLoop:
    """``clients`` clients, each submitting its next pool request from its
    previous one's done-callback while the window is open."""

    def __init__(self, server, mix: dict, requests: list[np.ndarray]):
        self.server, self.mix, self.requests = server, mix, requests
        self.records: list[dict] = []
        self.stop_at = float("inf")
        self._lock = threading.Lock()
        self._open = 0
        self.idle = threading.Event()

    def start(self, stop_at: float) -> None:
        self.stop_at = stop_at
        for c in range(self.mix["clients"]):
            self._submit(c, 0)

    def _submit(self, c: int, k: int) -> None:
        idx = client_request(self.mix, c, k)
        with self._lock:
            self._open += 1
            self.idle.clear()
        t = time.perf_counter()
        fut = self.server.submit(self.requests[idx])
        fut.add_done_callback(lambda f: self._done(f, c, k, idx, t))

    def _done(self, fut, c: int, k: int, idx: int, t_submit: float) -> None:
        t = time.perf_counter()
        err = fut.exception()
        self.records.append({"idx": idx, "t_submit": t_submit, "t_done": t, "ok": err is None,
                             "answer": None if err else fut.result()})
        if t < self.stop_at:
            self._submit(c, k + 1)
        with self._lock:
            self._open -= 1
            if self._open == 0:
                self.idle.set()


def request_key(n: int, head: np.ndarray) -> tuple[int, bytes]:
    """What names a request in a batch: its length and its first samples."""
    return int(n), np.ascontiguousarray(head[:HEAD], np.float32).tobytes()


def find_row(calls: list[dict], rec: dict, key: tuple[int, bytes]) -> tuple[dict, int] | None:
    """The call and row that answered request ``rec`` (named by ``key``):
    the latest call that started after its submit and ended before its
    answer came, with a row of that request."""
    for call in reversed(calls):
        if call["t1"] > rec["t_done"]:
            continue
        if call["t0"] < rec["t_submit"]:
            return None
        for row, (n, head) in enumerate(zip(call["lengths"], call["heads"])):
            if request_key(n, head) == key:
                return call, row
    return None


def program_hypotheses(model, calls: list[dict], picked: list[dict], requests: list[np.ndarray],
                       index: dict, W: int) -> tuple[list[dict], int]:
    """The program's hypotheses of each picked request: the batch that
    served it rebuilt row for row from the pool, through the model's public
    ``predict_intents`` once more (each batch once). Returns the samples
    and the count of picked requests whose batch could not be rebuilt."""
    by_call: dict[int, tuple[dict, list]] = {}
    missing = 0
    for r in picked:
        wav = requests[r["idx"]]
        found = find_row(calls, r, request_key(len(wav), wav))
        if found is None:
            missing += 1
            continue
        call, row = found
        by_call.setdefault(id(call), (call, []))[1].append((r, row))
    samples = []
    for call, rows in by_call.values():
        keys = [(row, request_key(n, h)) for row, (n, h) in enumerate(zip(call["lengths"], call["heads"])) if n > 0]
        if any(k not in index for _, k in keys):
            missing += len(rows)
            continue
        x = np.zeros(call["shape"], np.float32)
        for row, k in keys:
            x[row, :k[0]] = requests[index[k]]
        scores, tokens = model.predict_intents(x, lengths=call["lengths"], beam_width=W)
        for r, row in rows:
            samples.append({"wav": requests[r["idx"]], "served": r["answer"],
                            "tokens": tokens[:, row].cpu().numpy(), "scores": scores[:, row].cpu().numpy()})
    return samples, missing


def setup(cell, seed: int, device: torch.device, mark=lambda phase: None) -> dict:
    from tpu_slu_torch.models.slu import Model
    from tpu_slu_torch.serving import IntentServer

    mark("imports")
    check_generator(cell.mix, "closed")
    arch = Arch(cell.conf)
    config = port_config(cell.conf, cell.workdir)
    config.seq2seq_max_decode_len = cell.conf["serve"]["max_decode_len"]
    model = Model(config, load_pretrained=False).eval().to(device)
    model.load_state_dict(make_weights(arch, sub_seed(seed, 3), device), strict=True)
    rec = Recorder(model)
    mark("model")
    s = cell.conf["serve"]
    server = IntentServer(rec, max_batch=s["max_batch"], batch_window_ms=s["batch_window_ms"],
                          max_seconds=s["max_seconds"], fs=arch.fs)
    requests = closed_requests(cell.mix, seed, device)
    index = {request_key(len(w), w): i for i, w in enumerate(requests)}
    if len(index) != len(requests):
        raise ValueError("two requests of the pool begin alike: the check could not tell them apart")
    mark("traffic")
    lengths = request_lengths(cell.mix)
    quant = round(cell.mix["bucket_s"] * arch.fs)
    buckets = range(bucket(int(lengths.min()), quant), bucket(int(lengths.max()), quant) + 1, quant)
    return {"arch": arch, "model": model, "rec": rec, "server": server, "requests": requests,
            "index": index, "warm": [b / arch.fs for b in buckets]}


def sample(records: list[dict], requests: list[np.ndarray], n: int, seed: int) -> list[dict]:
    """``n`` answered requests of distinct pool entries drawn from the seed,
    the longest among them first."""
    by_idx = {}
    for r in records:
        if r["ok"]:
            by_idx.setdefault(r["idx"], r)
    idx = sorted(by_idx)
    longest = max(idx, key=lambda i: (len(requests[i]), -i))
    rest = [i for i in idx if i != longest]
    rng = np.random.default_rng(sub_seed(seed, 5))
    pick = [longest] + [rest[j] for j in rng.choice(len(rest), min(n - 1, len(rest)), replace=False)]
    return [by_idx[i] for i in pick]


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, marks: Marks) -> Result:
    cuda = device.type == "cuda"
    state = setup(cell, seed, device, marks)
    rec, server, requests = state["rec"], state["server"], state["requests"]
    mix, W, U = cell.mix, cell.conf["serve"]["beam_width"], cell.conf["serve"]["max_decode_len"]
    loop = ClosedLoop(server, mix, requests)
    server.warmup(seconds=state["warm"])
    if cuda:
        torch.cuda.synchronize()
    rec.calls.clear()
    fill0 = collections.Counter(server.batch_sizes)
    marks("warm buckets")
    setup_s = time.time() - marks.t_process
    marks.report()
    tracer = Tracer(cell.workdir) if trace else contextlib.nullcontext()
    with tracer:
        length = min(seconds, mix["trace_seconds"]) if trace else seconds
        t0 = time.perf_counter()
        end = t0 + length
        loop.start(end)
        time.sleep(max(0.0, end - time.perf_counter()))
        drained = loop.idle.wait(DRAIN_S + max(0.0, end - time.perf_counter()))
    fill = collections.Counter(server.batch_sizes)
    fill.subtract(fill0)
    server.close()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    recs = loop.records
    done = [r for r in recs if r["t_done"] <= end]
    if not done:
        raise RuntimeError(f"no request was answered in the {end - t0:.1f} s window")
    lat = np.array([r["t_done"] - r["t_submit"] for r in done]) * 1e3
    bins = int(np.ceil(length / RATE_BIN_S))
    at = ((np.array([r["t_done"] for r in done]) - t0) // RATE_BIN_S).astype(np.int64)
    per_bin = np.bincount(np.minimum(at, bins - 1), minlength=bins)
    spans = [min(RATE_BIN_S, length - k * RATE_BIN_S) for k in range(bins)]
    print(f"slubench: answers a second by {RATE_BIN_S:g} s of the window: "
          + ", ".join(f"{c / t:.1f}" for c, t in zip(per_bin, spans)), file=sys.stderr)
    failed = sum(not r["ok"] for r in recs) + (0 if drained else loop._open)  # never answered
    picked = sample(done, requests, mix["check_requests"], seed)
    samples, unmatched = program_hypotheses(state["model"], rec.calls, picked, requests, state["index"], W)
    calls = [{"t0": c["t0"], "t1": c["t1"], "lengths": c["lengths"]} for c in rec.calls]
    arch = state["arch"]
    del state, rec, server, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = checks.serve_numbers(make_weights(arch, sub_seed(seed, 3), device), arch, samples, W, U)
    print(f"slubench: reference check {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    nums["answer_mismatches"] += unmatched
    nums["unanswered"] = float(failed)
    ctx = {"trace": getattr(tracer, "trace", None), "arch": arch, "calls": calls, "batch_fill": fill,
           "W": W, "U": U, "samples": samples}
    e2e = {"serve_utt_per_s": len(done) / (end - t0),
           "serve_p95_ms": float(np.percentile(lat, 95)), "setup_s": setup_s}
    return Result(end_to_end=e2e, attempted=sum(r["t_submit"] < end for r in recs), failed=failed,
                  memory_peak_bytes=int(peak), ctx=ctx,
                  checks=[(n, nums[n], lim) for n, lim in cell.limits.items()])
