"""The port's program spans on the card: their clock against the device trace,
what they cost, and ``StepTimer``'s synchronisations.

``--serve SEED ...`` runs the benchmark's ``s2s_serve_closed`` cell traced
(``slubench/drivers/serve.py`` with the harness's ``Tracer``, keeping the
exported Chrome trace) once a seed and prints: the span metrics the
harness's readers find (``slubench/metrics/``), the mean of each span, the
window's idle device time by innermost span (``slubench/spans.py``), the
share of the window's host ``cudaLaunchKernel*`` and ``cudaMemcpyAsync``
events that begin inside a ``decode`` span, and the K7 launches inside each
``decode.search`` span (matched to K7's kernels by the trace's correlation
ids). ``--span-cost`` times one span off, on the profiled thread (with its
``record_function`` copy) and on another thread. ``--asr-epoch`` trains a
short ASR epoch (``no_unfreezing.cfg`` encoder, B = 64) with
``profile_dir`` and counts the host's ``cudaDeviceSynchronize`` and
``cudaStreamSynchronize`` events inside and between the ``train.step``
spans, print steps apart. ``--repo`` imports the port from another
checkout (a tree without spans reports the epoch's synchronisations only).
Run from the root of a checkout on a machine with a GPU:

    python3 tools/torch_span_check.py --serve 4100000021 --span-cost --asr-epoch
    python3 tools/torch_span_check.py --asr-epoch --repo build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import threading
import time
from collections import Counter, defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")


def serve_check(seed: int, cell=None, dev=None) -> None:
    import torch

    from slubench import spans as sp
    from slubench.cell import load_benchmark, load_cell, metric_reader
    from slubench.drivers import serve
    from slubench.port import Marks
    from slubench.trace import Tracer, read_chrome_trace
    from tpu_slu_torch.utils import profiling

    class KeptTracer(Tracer):
        """The harness's ``Tracer``, keeping the raw events of its trace."""

        last = None

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            self._mark.__exit__(*exc)
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(self.path)
            self.trace = read_chrome_trace(self.path)
            with open(self.path) as f:
                self.raw = json.load(f)
            os.remove(self.path)
            KeptTracer.last = self
            return False

    profiling.clear_spans()
    serve.Tracer = KeptTracer
    cell = cell or load_cell(load_benchmark(), "s2s_serve_closed")
    res = serve.run(cell, seed, 51.0, True, dev or torch.device("cuda", 0), Marks(time.time()))
    tr, raw = res.ctx["trace"], KeptTracer.last.raw
    recorded = profiling.spans()
    print(f"[serve] seed {seed}: correct checks {[(n, v, lim) for n, v, lim in res.checks]}, "
          f"failed {res.failed}; window {tr.window_s:.4f} s, busy {tr.busy_s():.4f} s; "
          f"{len(recorded)} spans, {profiling.dropped_spans()} dropped")
    base = profiling.kineto_base_ns(min(s.t0_ns for s in recorded))
    print(f"[clock] trace baseTimeNanoseconds {raw.get('baseTimeNanoseconds')}, the helper's {base}: "
          f"{'equal' if int(raw.get('baseTimeNanoseconds', -1)) == base else 'DIFFER'}")
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(res.ctx)
        print(f"[metric] {m['name']}: {value!r} {m['unit']}")
    by = defaultdict(list)
    for s in sp.window_spans(res.ctx):
        by[s.name].append(s.dur)
    for name in sorted(by):
        d = by[name]
        print(f"[span] {name}: {len(d)} in the window, mean {1e3 * statistics.fmean(d):.4f} ms, "
              f"median {1e3 * statistics.median(d):.4f} ms")
    n_calls = len(by["decode"])
    idle = sp.idle_by_span(res.ctx)
    total = sum(idle.values())
    print(f"[idle] {total:.4f} s idle in the window ({100 * total / tr.window_s:.2f}%), "
          f"{1e3 * total / max(n_calls, 1):.4f} ms a call, by innermost span:")
    for name, v in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {name:18s} {v:.4f} s  {1e3 * v / max(n_calls, 1):.4f} ms a call  {100 * v / total:.1f}%")
    print(f"[idle-host-op] the harness's split by host operation: {tr.idle_gaps()}")
    decodes = sp.window_spans(res.ctx, "decode")
    w0, w1 = tr.window
    launches = [t for name, t, _ in tr.host
                if name.startswith(("cudaLaunchKernel", "cudaMemcpyAsync")) and w0 <= t < w1]
    inside = sum(any(d.t0 <= t < d.t1 for d in decodes) for t in launches)
    print(f"[clock] {inside} of {len(launches)} host cudaLaunchKernel*/cudaMemcpyAsync events of the window "
          f"begin inside a decode span: {100 * inside / max(len(launches), 1):.3f}%")
    events = [e for e in raw["traceEvents"] if e.get("ph") == "X"]
    k7 = {e["args"].get("correlation") for e in events
          if e.get("cat") == "kernel" and "beam_decode_kernel" in e.get("name", "")}
    k7_host = sorted(e["ts"] * 1e-6 for e in events
                     if e.get("cat") == "cuda_runtime" and e.get("args", {}).get("correlation") in k7)
    counts = [sum(s.t0 <= t < s.t1 for t in k7_host) for s in sp.window_spans(res.ctx, "decode.search")
              if w0 < s.t0 and s.t1 < w1]
    print(f"[clock] K7 launches in each whole decode.search span of the window: "
          f"{dict(sorted(Counter(counts).items()))} over {len(counts)} spans; "
          f"{sum(c == 1 for c in counts)} hold exactly one")
    profiling.clear_spans()


def span_cost() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_slu_torch.utils import profiling

    def loop(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    def bare(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        return (time.perf_counter() - t0) / n * 1e6

    off = min(loop(200_000) for _ in range(3)) - min(bare(200_000) for _ in range(3))
    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on, profiled thread (record_function copy)"] = min(loop(20_000) for _ in range(3))
        th = threading.Thread(target=lambda: out.__setitem__("on, another thread", min(loop(20_000) for _ in range(3))))
        th.start()
        th.join()
        t0 = time.perf_counter()
        for _ in range(20_000):
            profiling.record_span("cost.cross", 0, 1)
        out["record_span"] = (time.perf_counter() - t0) / 20_000 * 1e6
    profiling.clear_spans()
    print(f"[span-cost] off: {off:.4f} us a span (the loop's own cost taken out); "
          + "; ".join(f"{k}: {v:.3f} us" for k, v in out.items()) + f"; torch {torch.__version__}")


def asr_epoch(steps: int, print_interval: int, dev=None, batch: int = 64, profiled: bool = True) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_slu_torch import read_config
    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG
    from tpu_slu_torch.training import Trainer

    dev = dev or torch.device("cuda", 0)
    config = read_config(FLAGSHIP_CFG, make_dirs=False)
    config.num_phonemes = 42
    model = PretrainedModel(config, generator=torch.Generator().manual_seed(1)).to(dev)
    batches = cs.asr_batches(np.random.default_rng(1), steps, batch, cs.ASR_T, 42, config.vocabulary_size,
                             config.phone_downsample_factor, config.word_downsample_factor)
    config.folder = tempfile.mkdtemp(prefix="span_check_")
    data = type("Batches", (), {"loader": batches})()
    warm = Trainer(model, config, generator=torch.Generator().manual_seed(7))
    warm.train(type("Batches", (), {"loader": batches[:2]})(), print_interval=10**9)  # builds, warms
    config.profile_dir = os.path.join(config.folder, "profile") if profiled else None
    trainer = Trainer(model, config, generator=torch.Generator().manual_seed(7))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with open(os.devnull, "w") as quiet:
        stdout, sys.stdout = sys.stdout, quiet
        try:
            trainer.train(data, print_interval=print_interval)
        finally:
            sys.stdout = stdout
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    results = trainer._rows[-1]
    if not profiled:
        print(f"[asr-wall] tpu_slu_torch from {os.path.dirname(os.path.dirname(sys.modules['tpu_slu_torch'].__file__))}: "
              f"{steps} steps of B={batch}, print_interval {print_interval}, unprofiled: {wall:.4f} s, "
              f"{1e3 * wall / steps:.4f} ms a step; log.csv step_ms_p50 {results.get('step_ms_p50')!r}, "
              f"step_ms_mean {results.get('step_ms_mean')!r}")
        return
    with open(os.path.join(config.profile_dir, "rank0.train.pt.trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    syncs = sorted(e["ts"] for e in events if e.get("cat") == "cuda_runtime" and e.get("name") in SYNCS)
    steps_ev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "user_annotation" and e.get("name") == "train.step")
    print(f"[asr-epoch] tpu_slu_torch from {os.path.dirname(os.path.dirname(sys.modules['tpu_slu_torch'].__file__))}: "
          f"{steps} steps of B={batch}, print_interval {print_interval}, profiled, {wall:.3f} s; log.csv "
          f"step_ms_p50 {results.get('step_ms_p50')!r}, step_ms_mean {results.get('step_ms_mean')!r}; "
          f"{len(syncs)} host synchronisations in the trace, {len(steps_ev)} train.step spans")
    if not steps_ev:
        return
    inside = [sum(a <= t < b for t in syncs) for a, b in steps_ev]
    between = [sum(b <= t < (steps_ev[i + 1][0] if i + 1 < len(steps_ev) else float("inf")) for t in syncs)
               for i, (a, b) in enumerate(steps_ev)]
    before = sum(t < steps_ev[0][0] for t in syncs)
    printed = [i % print_interval == 0 for i in range(len(steps_ev))]
    quiet_gaps = [n for n, p in zip(between[:-1], printed) if not p]
    print(f"[asr-epoch] syncs inside each step {inside}; after each step {between} (the last: after the epoch); "
          f"before the first {before}; print steps {[i for i, p in enumerate(printed) if p]}; "
          f"syncs between steps after no print step: {sum(quiet_gaps)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", type=int, nargs="*", default=[], help="seeds of traced s2s_serve_closed runs")
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--asr-epoch", action="store_true")
    ap.add_argument("--asr-wall", action="store_true", help="time an unprofiled epoch of --steps steps instead")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--print-interval", type=int, default=5)
    ap.add_argument("--repo", default=HERE, help="the checkout whose tpu_slu_torch to import")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs

    print(f"card: {cs.smi()}; torch {torch.__version__}")
    for seed in args.serve:
        serve_check(seed)
    if args.span_cost:
        span_cost()
    if args.asr_epoch or args.asr_wall:
        asr_epoch(args.steps, args.print_interval, profiled=not args.asr_wall)


if __name__ == "__main__":
    main()
