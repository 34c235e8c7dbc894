#!/usr/bin/env python3
"""Compare the ptxas report of two checkouts' kernel sources: each kernel's
registers, spill stores, spill loads and stack frame.

    python3 tools/torch_ptxas_diff.py --parent DIR

compiles every ``tpu_slu_torch/csrc/*.cu`` of this checkout and of the one at
DIR (for example the parent commit unpacked with ``git archive``) with the
flags of ``tpu_slu_torch/ops/_build.py`` and ``-Xptxas -v``, all files of
both trees at once, and prints, for every kernel of the parent, whether this
tree's kernel of the same name has the same four numbers, then the kernels
only this tree has. Kernels are matched by name and template arguments,
not by their parameter lists (a parameter whose type became an alias
demangles otherwise), and a kernel that gained a template argument
defaulting to ``false`` is matched to its parent's name without it. Needs
``nvcc`` (the card machine's CUDA toolkit), not a GPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def report(tree: str, out_dir: str, flags: list[str], nvcc: str) -> dict[str, tuple]:
    """Mangled kernel name -> (registers, spill stores, spill loads, stack
    frame bytes) over every source of ``tree``'s kernel library."""
    procs = []
    for src in sorted(glob.glob(os.path.join(tree, "tpu_slu_torch", "csrc", "*.cu"))):
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *flags, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", obj, src]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    kernels = {}
    for src, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {src}:\n{err}")
        name, frame = None, None
        for line in err.splitlines():
            if m := _ENTRY.search(line):
                name, frame = m.group(1), None
            elif (m := _FRAME.search(line)) and name:
                frame = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
            elif (m := _REGS.search(line)) and name and frame:
                kernels[name] = (int(m.group(1)), *frame)
                name = None
    return kernels


def without_params(name: str) -> str:
    """A demangled kernel name without its parameter list: the text before
    the parentheses that close it."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def without_false(name: str) -> str:
    """A demangled kernel name without a last template argument ``false``
    (``(bool)0``), as it reads before that argument was added."""
    return re.sub(r", (?:false|\(bool\)0)>(?=\(|$)", ">", name, count=1)


def demangle(names, filt: str | None) -> dict[str, str]:
    if filt is None:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the checkout to compare with")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from tpu_slu_torch.ops import _build

    nvcc = _build._nvcc()
    filt = shutil.which("cu++filt", path=os.path.dirname(nvcc)) or shutil.which("c++filt")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("parent", "this")}
        for d in dirs.values():
            os.makedirs(d)
        got = {k: report(tree, dirs[k], _build.ARCH_FLAGS, nvcc)
               for k, tree in (("parent", os.path.abspath(args.parent)), ("this", HERE))}
    names = {k: {m: without_params(n) for m, n in demangle(list(v), filt).items()} for k, v in got.items()}
    this_by_name = {n: got["this"][m] for m, n in names["this"].items()}
    for m, n in names["this"].items():  # a template argument that defaults to false, as the parent named it
        this_by_name.setdefault(without_false(n), got["this"][m])
    same, differ = 0, []
    for m, n in sorted(names["parent"].items(), key=lambda kv: kv[1]):
        mine = this_by_name.get(n)
        if mine == got["parent"][m]:
            same += 1
        else:
            differ.append((n, got["parent"][m], mine))
    print(f"[ptxas] {len(names['parent'])} kernels of the parent (registers, spill stores, spill loads, "
          f"stack bytes): {same} the same in this tree, {len(differ)} not")
    for n, p, t in differ:
        print(f"[ptxas] differs: {n}: parent {p}, this {t}")
    matched = set(names["parent"].values())
    for m, n in sorted(names["this"].items(), key=lambda kv: kv[1]):
        if n not in matched and without_false(n) not in matched:
            print(f"[ptxas] only in this tree: {n}: {got['this'][m]}")


if __name__ == "__main__":
    main()
