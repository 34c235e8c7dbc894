"""What the benchmark loads, in a fresh interpreter, by whole top-level name
(the part before the first dot): the port's name begins with the JAX
package's, so a prefix would not tell them apart."""

import os
import subprocess
import sys

from slubench.cell import ROOT

PROBE = """
import sys
{imports}
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_after(imports: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_loads_no_jax_nor_the_jax_package():
    # everything a run imports: the harness, its readers, and the program's modules the drivers call
    loaded = top_level_after(
        "import slubench.run, slubench.cell, slubench.checks, slubench.trace, slubench.work\n"
        "import slubench.drivers.serve, slubench.controls.calibrate\n"
        "from slubench.cell import load_benchmark, metric_reader\n"
        "[metric_reader(m['name']) for m in load_benchmark()['per_layer']]\n"
        "import tpu_slu_torch.models.slu, tpu_slu_torch.serving")
    assert "tpu_slu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpu_slu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = top_level_after("import slubench.reference.model")
    assert not loaded & {"jax", "jaxlib", "flax", "tpu_slu", "tpu_slu_torch"}


def test_the_reference_sources_name_no_program_module():
    folder = os.path.join(ROOT, "slubench", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            with open(os.path.join(folder, name)) as f:
                imports = [ln.split() for ln in f if ln.lstrip().startswith(("import ", "from "))]
            modules = {words[1].split(".")[0] for words in imports}
            assert not modules & {"jax", "jaxlib", "flax", "tpu_slu", "tpu_slu_torch"}, name
