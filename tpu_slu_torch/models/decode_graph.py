"""The length-exact decode replayed as CUDA graphs, one per padded shape.

A served call of the length-exact decode (``Model.predict_intents`` with
``lengths=`` or ``bucket=True``) is a chain of some 300 short launches: the
masked front end, the K4f layers, the attention keys and values, and K7 or
the fixed-slot head. Enqueued one by one from Python they take the host
longer than the card takes to run them. :class:`DecodeGraphs` captures the
chain once per key (the head and its widths, the padded batch B x T_pad,
the beam width, the parameters' dtype, the float32 matmul precision) with
``torch.cuda.graphs`` and replays it after: one launch a call. The functions captured are the eager path's own, so every
kernel runs in the same order on the same data, and the answers are equal
bit for bit.

A graph reads its input from static buffers and the parameters from the
addresses they had at capture: in-place updates (``load_state_dict``, an
optimiser step) are read on replay, and a model whose parameters moved to
new storage (``.to()``) captures anew (:meth:`DecodeGraphs.run` is given the
parameters' addresses, and drops every graph when they change). The graphs
share one memory pool, since one lock keeps their replays serial. At most
``CAPACITY`` graphs are kept, the least recently used dropped first. A key
whose capture raises stays eager for good.

Counters: ``captures`` (graphs captured), ``replays`` (calls answered by a
replay, a capturing call's too), ``fallbacks`` (calls of the graph route
answered eagerly because their key's capture raised). Spans while a profiler
runs: ``decode.h2d`` (the inputs' copy into the static buffers), then
``decode.replay`` (the replay and the copy of its outputs) or, on a key's
first call, ``decode.capture``.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from tpu_slu_torch.utils.profiling import span

# the graphs kept a model: IntentServer's default max_seconds of 16 s gives 32
# buckets of 0.5 s at one batch size
CAPACITY = 32


def check_lengths(n: np.ndarray, B: int, t_pad: int) -> None:
    """Raise ``ValueError`` unless ``n`` is (B,) sample counts in [0, t_pad]."""
    if n.shape != (B,):
        raise ValueError(f"lengths has shape {n.shape}, want ({B},)")
    if B and (n.min() < 0 or n.max() > t_pad):
        raise ValueError(f"lengths must lie in [0, T={t_pad}], got [{n.min()}, {n.max()}]")


class _Graph:
    """One key's static inputs x (B, T_pad) float32 and n (B,) int64, its
    graph, and the outputs the graph writes."""

    def __init__(self, B: int, t_pad: int, device: torch.device):
        self.x = torch.empty((B, t_pad), dtype=torch.float32, device=device)
        self.n = torch.empty((B,), dtype=torch.int64, device=device)
        self.graph = None
        self.outs: tuple = ()

    def load(self, x: torch.Tensor, n: np.ndarray) -> None:
        """Copy x (B, T <= T_pad) and n into the static buffers, zeros past T."""
        T = x.shape[1]
        self.x[:, :T].copy_(x)
        if T < self.x.shape[1]:
            self.x[:, T:].zero_()
        self.n.copy_(torch.from_numpy(n))


class DecodeGraphs:
    """A model's length-exact decodes as CUDA graphs (module docstring)."""

    def __init__(self):
        self.captures = self.replays = self.fallbacks = 0
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._eager: set = set()
        self._params: tuple | None = None
        self._lock = threading.Lock()
        self._pool = None
        self._stream = None

    def __reduce__(self):  # a copy of the model starts with no graphs
        return DecodeGraphs, ()

    def keys(self) -> list:
        """The keys that have a graph, the least recently used first."""
        return list(self._graphs)

    def get(self, key):
        """The key's graph (now the most recently used), or None."""
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        """Keep ``entry`` under ``key``, dropping the least recently used past the capacity."""
        self._graphs[key] = entry
        self._graphs.move_to_end(key)
        while len(self._graphs) > CAPACITY:
            self._graphs.popitem(last=False)

    def run(self, fn, key, params: tuple, x: torch.Tensor, n: np.ndarray, t_pad: int, device: torch.device):
        """``fn(x, n)`` on CUDA ``device`` by the key's graph: x (B, T)
        waveforms on any device, zero-padded to the static x's (B, t_pad),
        and n (B,) int64 host lengths already checked against t_pad.
        ``params`` are the parameters' addresses. Returns copies of the
        outputs, or None where the key stays eager (the caller decodes)."""
        with self._lock:
            if params != self._params:
                self._graphs.clear()
                self._params, self._stream = params, None
            if key in self._eager:
                self.fallbacks += 1
                return None
            entry = self.get(key)
            with span("decode.h2d"):
                if entry is None:
                    entry = _Graph(x.shape[0], t_pad, device)
                entry.load(x, n)
            if entry.graph is None:
                with span("decode.capture"):
                    return self._capture(fn, key, entry)
            with span("decode.replay"):
                entry.graph.replay()
                self.replays += 1
                return tuple(t.clone() for t in entry.outs)

    def _capture(self, fn, key, entry: _Graph):
        """The first call of ``key``: an eager warm pass on the capture
        stream, the capture of ``fn``, and a replay that answers the call."""
        device = entry.x.device
        with torch.cuda.device(device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
                self._pool = torch.cuda.graph_pool_handle()
            current = torch.cuda.current_stream(device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                fn(entry.x, entry.n)  # lazy state (kernel build, handles, plans) outside the capture
                graph = torch.cuda.CUDAGraph()
                try:
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        outs = fn(entry.x, entry.n)
                    finally:
                        graph.capture_end()
                except Exception:
                    graph = None
            current.wait_stream(self._stream)
            if graph is None:
                self._eager.add(key)
                self.fallbacks += 1
                return fn(entry.x, entry.n)
            entry.graph, entry.outs = graph, tuple(outs)
            self.put(key, entry)
            self.captures += 1
            graph.replay()
            self.replays += 1
            return tuple(t.clone() for t in entry.outs)
