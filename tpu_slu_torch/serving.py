"""Inference serving: dataset-free model loading and a micro-batching decode server.

Port of ``tpu_slu/serving.py``:

* :func:`load_trained_model` builds a trained :class:`Model` from its
  experiment folder (``vocab.json`` + checkpoint), on the GPU by default.
* :class:`IntentServer` drains concurrent requests from a queue on one
  worker thread and pads them into ONE ``(max_batch, 0.5 s bucket)`` decode
  through the length-exact path (``Model.decode_intents(x, lengths=)``), so
  batching never changes an answer: every request decodes as it would
  alone at its exact shape. The rows that fill the batch have length 0.
* :func:`make_http_server`: ``POST /decode`` with a WAV body ->
  ``{"intents": [...], "ms": N}`` (a seq2seq model answers
  ``{"intents": "<semantics string>", ...}``); ``GET /healthz`` -> ``{"ok": true}``.

Run a server:

    python -m tpu_slu_torch.serving --config_path experiments/X.cfg [--port 8600]
        [--max-batch 8] [--batch-window-ms 5] [--max-seconds 16] [--no-warmup]
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import itertools
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from tpu_slu_torch.data.audio import decode_wav_bytes
from tpu_slu_torch.data.loader import WAVE_BUCKET_QUANT, pad_to_bucket
from tpu_slu_torch.device import entry_device
from tpu_slu_torch.models.slu import Model
from tpu_slu_torch.utils.profiling import record_span, recording, span

__all__ = ["WAVE_BUCKET_QUANT", "IntentServer", "load_trained_model", "make_http_server"]


def load_trained_model(config, device: str | torch.device | None = None) -> Model:
    """Build a :class:`Model` from a trained experiment folder, in eval mode
    on ``device`` (the GPU by default; raises without one).

    ``<folder>/training/vocab.json`` supplies the slot vocabulary, or the
    label list of a seq2seq model (the port does not read datasets); the JAX
    package's ``model_state.npz`` is preferred, a reference
    ``model_state.pth`` is taken as well.
    """
    device = entry_device(device)
    training = os.path.join(config.folder, "training")
    vocab_path = os.path.join(training, "vocab.json")
    if not os.path.isfile(vocab_path):
        raise FileNotFoundError(f"no {vocab_path}: the port decodes from a saved vocab only")
    with open(vocab_path) as f:
        Model.attach_vocab(config, json.load(f))
    model = Model(config, load_pretrained=False)
    npz = os.path.join(training, "model_state.npz")
    pth = os.path.join(training, "model_state.pth")
    if os.path.isfile(npz):
        model.load_native_checkpoint(npz)
    elif os.path.isfile(pth):
        model.load_state_dict(torch.load(pth, map_location="cpu"), strict=True)
    else:
        raise FileNotFoundError(f"no trained SLU checkpoint at {npz} or {pth}")
    return model.to(device).eval()


class IntentServer:
    """Queue + worker thread turning concurrent decode requests into batched
    device calls. Thread-safe; one device call in flight at a time.
    ``batch_sizes`` counts the device calls by the number of requests each
    carried.

    While a profiler runs (:mod:`tpu_slu_torch.utils.profiling`) each
    request gets an id ``rid`` and a ``serve.queue`` span from its submit
    until the worker takes it, and each device call a ``serve.batch`` span
    (with the ``rids`` it carried) from its first request taken until its
    last answer is set, over ``serve.drain``, ``serve.pad``, the model's
    ``decode`` and ``serve.resolve`` (``set_result`` and the done-callbacks
    it runs on the worker)."""

    def __init__(self, model, max_batch: int = 8, batch_window_ms: float = 5.0,
                 max_seconds: float = 16.0, fs: int = 16000):
        self.model = model
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1000.0
        self.max_samples = int(max_seconds * fs)
        self.fs = fs
        self.batch_sizes: collections.Counter = collections.Counter()
        self._queue: queue.Queue = queue.Queue()
        self._rids = itertools.count()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client API ---------------------------------------------------------

    def submit(self, wav: np.ndarray) -> cf.Future:
        """Enqueue a 1-D float32 waveform; resolves to its intent decode (a
        list of slot strings, or the seq2seq string)."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        if wav.size == 0:
            raise ValueError("empty waveform")
        if wav.size > self.max_samples:
            raise ValueError(
                f"waveform of {wav.size} samples exceeds max_seconds "
                f"({self.max_samples} samples)"
            )
        fut: cf.Future = cf.Future()
        stamp = (next(self._rids), time.time_ns()) if recording() else None
        self._queue.put((wav, fut, stamp))
        return fut

    def decode(self, wav: np.ndarray):
        return self.submit(wav).result()

    def warmup(self, seconds=(1.0, 2.0, 4.0)):
        """Decode silence of the common bucket lengths once, so that the
        first timed request pays neither the kernel build nor a first call."""
        for s in seconds:
            self.decode(np.zeros(int(s * self.fs), np.float32))

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # -- worker ---------------------------------------------------------------

    def _take(self, timeout: float):
        """The next request, waiting up to ``timeout`` (raises
        ``queue.Empty``); ends its ``serve.queue`` span."""
        item = self._queue.get(timeout=timeout)
        if item[2] is not None:
            rid, t_submit = item[2]
            record_span("serve.queue", t_submit, time.time_ns(), rid=rid)
        return item

    def _drain(self, first):
        """Gather up to max_batch requests, ``first`` among them, within the
        batching window."""
        items = [first]
        deadline = time.time() + self.batch_window_s
        while len(items) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                items.append(self._take(remaining))
            except queue.Empty:
                break
        return items

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._take(0.1)
            except queue.Empty:
                continue
            with span("serve.batch") as batch:
                with span("serve.drain"):
                    items = self._drain(first)
                if batch:
                    batch.set(rids=[stamp[0] for _, _, stamp in items if stamp is not None])
                try:
                    results = self._decode_batch([w for w, _, _ in items])
                    with span("serve.resolve"):
                        for (_, fut, _), res in zip(items, results):
                            fut.set_result(res)
                except Exception as e:
                    for _, fut, _ in items:
                        if not fut.done():
                            fut.set_exception(e)

    def _decode_batch(self, waves):
        """Pad to (max_batch, bucket) and run ONE length-exact decode."""
        with span("serve.pad"):
            t_pad = pad_to_bucket(max(len(w) for w in waves), WAVE_BUCKET_QUANT)
            x = np.zeros((self.max_batch, t_pad), np.float32)
            lengths = np.zeros((self.max_batch,), np.int64)
            for i, w in enumerate(waves):
                x[i, : len(w)] = w
                lengths[i] = len(w)
        self.batch_sizes[len(waves)] += 1
        decoded = self.model.decode_intents(x, lengths=lengths)
        return decoded[: len(waves)]


def make_http_server(server: IntentServer, host: str = "127.0.0.1", port: int = 0):
    """Wrap an IntentServer in a stdlib ThreadingHTTPServer (POST /decode,
    GET /healthz). Returns the HTTPServer; call .serve_forever() (and
    .shutdown() from another thread)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/decode":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                wav, fs = decode_wav_bytes(self.rfile.read(n))
                if fs != server.fs:
                    raise ValueError(f"expected {server.fs} Hz audio, got {fs}")
                t0 = time.time()
                intents = server.decode(wav)
                self._reply(200, {"intents": intents if isinstance(intents, str) else list(intents),
                                  "ms": round((time.time() - t0) * 1000, 2)})
            except Exception as e:
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    """Serve a trained model over HTTP (the flags of the JAX package's
    ``tools/serve.py``, and ``--device``)."""
    from tpu_slu_torch.config import read_config

    parser = argparse.ArgumentParser(prog="python -m tpu_slu_torch.serving")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8600)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--batch-window-ms", type=float, default=5.0)
    parser.add_argument("--max-seconds", type=float, default=16.0)
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    config = read_config(args.config_path, make_dirs=False)
    model = load_trained_model(config, device=args.device)
    server = IntentServer(model, max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
                          max_seconds=args.max_seconds)
    # bind before warmup: early clients wait in the TCP backlog instead of being refused
    httpd = make_http_server(server, args.host, args.port)
    if not args.no_warmup:
        print("warming up the bucket shapes ...", flush=True)
        server.warmup()
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(max_batch={args.max_batch}, window={args.batch_window_ms} ms)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
