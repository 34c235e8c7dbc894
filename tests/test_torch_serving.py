"""The port's micro-batching server, HTTP surface, CLI and entry-point devices.

Runs on the golden checkpoint (``tests/assets/golden``) on the CPU: batching
never changes an answer, bad requests are refused, and the committed golden
wavs decode to their expected intents over HTTP, through
``python -m tpu_slu_torch.serving`` and through ``python -m tpu_slu_torch.cli``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_slu_torch import read_config
from tpu_slu_torch.data.audio import read_wav
from tpu_slu_torch.models import flagship
from tpu_slu_torch.serving import IntentServer, load_trained_model, make_http_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "assets", "golden")
with open(os.path.join(GOLDEN, "expected.json")) as _f:
    CASES = json.load(_f)["expected"]


def golden_cfg(tmp) -> str:
    """A cfg of the golden experiment in ``tmp``, with its vocab and checkpoint."""
    folder = os.path.join(tmp, "exp")
    with open(os.path.join(GOLDEN, "experiment.cfg.template")) as f:
        template = f.read()
    path = os.path.join(tmp, "exp.cfg")
    with open(path, "w") as f:
        f.write(template.replace("__GOLDEN_FOLDER__", folder))
    os.makedirs(os.path.join(folder, "training"), exist_ok=True)
    for name in ("model_state.npz", "vocab.json"):
        shutil.copyfile(os.path.join(GOLDEN, name), os.path.join(folder, "training", name))
    return path


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    return golden_cfg(str(tmp_path_factory.mktemp("golden_serve")))


@pytest.fixture(scope="module")
def model(cfg_path):
    return load_trained_model(read_config(cfg_path, make_dirs=False), device="cpu")


def want(case):
    return [case["action"], case["object"], case["location"]]


def test_batched_results_equal_direct_decodes(model):
    rng = np.random.default_rng(0)
    waves = [read_wav(os.path.join(GOLDEN, c["wav"]))[0] for c in CASES]
    waves += [(0.1 * rng.standard_normal(t)).astype(np.float32) for t in (7200, 5111, 12000, 1)]
    server = IntentServer(model, max_batch=4, batch_window_ms=50)
    try:
        futures = [server.submit(w) for w in waves]
        got = [f.result(timeout=120) for f in futures]
    finally:
        server.close()
    for w, g in zip(waves, got):
        assert g == model.decode_intents(w)[0]
    assert got[:len(CASES)] == [want(c) for c in CASES]
    sizes = server.batch_sizes
    assert sum(k * v for k, v in sizes.items()) == len(waves)
    assert 1 < max(sizes) <= 4


def test_oversize_and_empty_requests_rejected(model):
    server = IntentServer(model, max_seconds=1.0)
    try:
        with pytest.raises(ValueError):
            server.submit(np.zeros(16001, np.float32))
        with pytest.raises(ValueError):
            server.submit(np.zeros(0, np.float32))
        assert not server.batch_sizes
    finally:
        server.close()


def test_http_decode_and_healthz(model):
    server = IntentServer(model, max_batch=4, batch_window_ms=5)
    httpd = make_http_server(server, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        for case in CASES:
            with open(os.path.join(GOLDEN, case["wav"]), "rb") as f:
                req = urllib.request.Request(f"{base}/decode", data=f.read())
            with urllib.request.urlopen(req, timeout=120) as r:
                payload = json.loads(r.read())
            assert payload["intents"] == want(case) and payload["ms"] >= 0
        for path, body, code in (("/decode", b"nope", 400), ("/other", b"", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(urllib.request.Request(base + path, data=body), timeout=30)
            assert err.value.code == code and "error" in json.loads(err.value.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(cfg_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_trained_model(read_config(cfg_path, make_dirs=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.flagship_model()
    assert load_trained_model(read_config(cfg_path, make_dirs=False), device="cpu").device.type == "cpu"


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_cli_decode_prints_the_golden_intents(cfg_path):
    case = CASES[1]
    out = subprocess.run(
        [sys.executable, "-m", "tpu_slu_torch.cli", "--decode", "--wav",
         os.path.join(GOLDEN, case["wav"]), "--config_path", cfg_path, "--device", "cpu"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == str(want(case))


def test_serving_main_answers_over_http(cfg_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_slu_torch.serving", "--config_path", cfg_path, "--port", "0",
         "--device", "cpu", "--max-batch", "2"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        port = None
        for line in proc.stdout:
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port is not None, "the server never said where it serves"
        case = CASES[2]
        with open(os.path.join(GOLDEN, case["wav"]), "rb") as f:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/decode", data=f.read())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["intents"] == want(case)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
