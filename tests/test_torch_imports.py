"""The PyTorch port decodes, serves and trains (both heads, a unidirectional model, and at
``compute_dtype=bfloat16``, the seq2seq head too), pre-trains,
saves and reloads, and runs its CLI's training legs without jax, pandas or any ``tpu_slu`` module;
its data- and model-parallel and profiling modules import none of them either.

Checked in a fresh interpreter: this test process has imported jax already.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, os, shutil, sys, tempfile
import tpu_slu_torch
import tpu_slu_torch.parallel
import tpu_slu_torch.parallel.mesh
import tpu_slu_torch.parallel.vocab
import tpu_slu_torch.utils.profiling
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
    model = load_trained_model(config, device="cpu")
    with open(os.path.join(golden, "expected.json")) as f:
        case = json.load(f)["expected"][0]
    wav, _ = read_wav(os.path.join(golden, case["wav"]))
    decoded = model.decode_intents(wav)[0]
    # one request through the micro-batching server
    from tpu_slu_torch.serving import IntentServer
    server = IntentServer(model, max_batch=2)
    try:
        served = server.decode(wav)
    finally:
        server.close()
    # one train step of the port's Trainer on loader-format batches
    import numpy as np
    from tpu_slu_torch.training import Trainer
    batch = {"x": np.stack([wav[:4000], wav[-4000:]]), "y_intent": np.zeros((2, 3), np.int64),
             "w": np.ones(2, np.float32), "len": np.full(2, 4000)}
    class Data:
        loader = [batch]
    acc, loss = Trainer(model, config).train(Data())
    assert np.isfinite(loss)
    # the same step at compute_dtype=bfloat16 (K1, K2 and K3 on bf16 streams)
    config.compute_dtype = "bfloat16"
    trainer = Trainer(model, config)
    acc, loss = trainer.train(Data())
    bf16 = [str(trainer.compute_dtype), bool(np.isfinite(loss))]
    config.compute_dtype = "float32"
    # the flagship's unidirectional model (K5f and K5b on a card): a decode and a train step
    from tpu_slu_torch.models.flagship import TRAIN_CFG, UNIDIRECTIONAL, flagship_model
    uni = flagship_model("cpu", **UNIDIRECTIONAL).decode_intents(wav[:8000])[0]
    uni_model = flagship_model("cpu", cfg=TRAIN_CFG, **UNIDIRECTIONAL)
    uni_model.config.folder = os.path.join(tmp, "uni")
    acc, loss = Trainer(uni_model, uni_model.config).train(Data())
    uni = [len(uni), bool(np.isfinite(loss))]
    # one seq2seq decode of the golden seq2seq checkpoint
    golden = os.path.join("tests", "assets", "golden_seq2seq")
    folder = os.path.join(tmp, "s2s")
    with open(os.path.join(golden, "experiment.cfg.template")) as f:
        template = f.read()
    with open(os.path.join(tmp, "s2s.cfg"), "w") as f:
        f.write(template.replace("__GOLDEN_FOLDER__", folder))
    config = read_config(os.path.join(tmp, "s2s.cfg"))
    with open(os.path.join(golden, "expected.json")) as f:
        meta = json.load(f)
    config.seq2seq_max_decode_len = meta["max_decode_len"]
    for name in ("model_state.npz", "vocab.json"):
        shutil.copyfile(os.path.join(golden, name), os.path.join(folder, "training", name))
    wav, _ = read_wav(os.path.join(golden, meta["expected"][0]["wav"]))
    s2s_model = load_trained_model(config, device="cpu")
    s2s = [s2s_model.decode_intents(wav)[0], meta["expected"][0]["semantics"]]
    # one seq2seq train step: one-hot targets and their lengths
    y = np.eye(len(s2s_model.Sy_intent), dtype=np.float32)[np.full((2, 5), s2s_model.Sy_intent.index("<eos>"))]
    batch = {"x": np.stack([wav[:4000], wav[-4000:]]), "y_intent": y, "w": np.ones(2, np.float32),
             "len": np.full(2, 4000), "y_len": np.array([5, 3])}
    class S2SData:
        loader = [batch]
    acc, loss = Trainer(s2s_model, config).train(S2SData())
    assert np.isfinite(loss) and acc == 0.0
    # the same seq2seq step at compute_dtype=bfloat16 (K4f and K4b on bf16 streams)
    config.compute_dtype = "bfloat16"
    trainer = Trainer(s2s_model, config)
    acc, loss = trainer.train(S2SData())
    bf16 += [str(trainer.compute_dtype), bool(np.isfinite(loss)), acc]
    # ASR pre-training, its checkpoint under a Model, and the CLI's training legs on a tiny tree
    import chip_smoke
    from tpu_slu_torch import cli
    slu, asr = chip_smoke.write_cli_tree(os.path.join(tmp, "tree"), np.random.default_rng(0))
    cfg = os.path.join(tmp, "cli.cfg")
    chip_smoke.write_cli_cfg(cfg, os.path.join("tests", "assets", "golden", "experiment.cfg.template"),
                             folder=os.path.join(tmp, "cli"), asr_path=asr, slu_path=slu, pretraining_type=2,
                             pretraining_num_epochs=1, training_num_epochs=1)
    for leg in (["--pretrain"], ["--train"], ["--train", "--restart"]):
        cli.main(leg + ["--config_path", cfg, "--device", "cpu"])
    trained = load_trained_model(read_config(cfg), device="cpu")
    cli_files = {sub: sorted(os.listdir(os.path.join(tmp, "cli", sub))) for sub in ("pretraining", "training")}
    cli_decode = trained.decode_intents(read_wav(os.path.join(slu, "wavs", "test_0.wav"))[0])[0]
finally:
    shutil.rmtree(tmp)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pandas", "tpu_slu"))
print(json.dumps({"decoded": decoded, "served": served,
                  "want": [case["action"], case["object"], case["location"]], "s2s": s2s, "uni": uni, "bf16": bf16,
                  "cli_files": cli_files, "cli_decode": cli_decode, "forbidden": loaded}))
"""


def test_port_imports_neither_jax_nor_pandas():
    """Nor ``tpu_slu`` or any module under it: the port keeps its own copies."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    import json

    result = json.loads(out.strip().splitlines()[-1])
    assert result["decoded"] == result["served"] == result["want"]
    assert result["s2s"][0] == result["s2s"][1]
    assert result["uni"] == [3, True]
    assert result["bf16"] == ["torch.bfloat16", True, "torch.bfloat16", True, 0.0]
    assert result["cli_files"] == {
        "pretraining": ["log.csv", "model_state.npz", "phonemes.txt", "trainer_state.npz", "words.txt"],
        "training": ["log.csv", "model_state.npz", "trainer_state.npz", "vocab.json"]}
    assert len(result["cli_decode"]) == 3
    assert result["forbidden"] == []
