"""The PyTorch port decodes without jax, pandas or ``tpu_slu.data``.

Checked in a fresh interpreter: this test process has imported jax already.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, os, shutil, sys, tempfile
import tpu_slu_torch
from tpu_slu_torch import load_trained_model, read_config, read_wav

golden = os.path.join("tests", "assets", "golden")
tmp = tempfile.mkdtemp()
try:
    folder = os.path.join(tmp, "exp")
    with open(os.path.join(golden, "experiment.cfg.template")) as f:
        template = f.read()
    with open(os.path.join(tmp, "exp.cfg"), "w") as f:
        f.write(template.replace("__GOLDEN_FOLDER__", folder))
    config = read_config(os.path.join(tmp, "exp.cfg"))
    for name in ("model_state.npz", "vocab.json"):
        shutil.copyfile(os.path.join(golden, name), os.path.join(folder, "training", name))
    model = load_trained_model(config)
    with open(os.path.join(golden, "expected.json")) as f:
        case = json.load(f)["expected"][0]
    wav, _ = read_wav(os.path.join(golden, case["wav"]))
    decoded = model.decode_intents(wav)[0]
finally:
    shutil.rmtree(tmp)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pandas") or m.startswith("tpu_slu.data"))
tpu_slu_mods = sorted(m for m in sys.modules if m.split(".")[0] == "tpu_slu")
print(json.dumps({"decoded": decoded, "want": [case["action"], case["object"], case["location"]],
                  "forbidden": loaded, "tpu_slu": tpu_slu_mods}))
"""


def test_port_imports_neither_jax_nor_pandas():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    import json

    result = json.loads(out.strip().splitlines()[-1])
    assert result["decoded"] == result["want"]
    assert result["forbidden"] == []
    assert result["tpu_slu"] == ["tpu_slu", "tpu_slu.config"]
