"""Compare the SASS of CUDA sources in two copies of `mmda_tpu_torch/csrc`,
function by function, instruction by instruction.

    python scripts/compare_sass.py OLD_CSRC NEW_CSRC short_attn_fwd short_attn_bwd ...

Each `<name>.cu` is compiled in both directories with the package's nvcc
flags (`mmda_tpu_torch/ops/kernels/_build.py` NVCC_FLAGS, as a cubin; all
at once), and `cuobjdump -sass` lists its kernels.  Addresses, encodings
and the file's anonymous-namespace tag in a function's name are dropped, so
two functions are "same" when their instruction lists are equal.  Prints
one JSON object: {name: {function: "same" | "differs" | "old only" | "new
only"}}, and exits 1 if a function that both compile differs.  Needs nvcc
(the card's machine).
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from mmda_tpu_torch.ops.kernels import _build  # noqa: E402

_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENC = re.compile(r"/\* 0x[0-9a-f]+ \*/")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def compile_cubin(csrc: pathlib.Path, name: str, cubin: pathlib.Path) -> subprocess.Popen:
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return subprocess.Popen([_build.nvcc_path(), *flags, "-cubin", "-o", str(cubin),
                             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def sass_by_function(cubin: pathlib.Path) -> dict:
    """{kernel function: [instruction text, ...]} of a cubin."""
    tool = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    functions: dict = {}
    current = None
    for line in text.splitlines():
        if "Function : " in line:
            name = _ANON.sub("_GLOBAL__N__", line.split("Function : ")[1].strip())
            current = functions.setdefault(name, [])
        elif current is not None and _ADDR.search(line):
            ins = _ENC.sub("", _ADDR.sub("", line)).strip()
            if ins:
                current.append(ins)
    return functions


def main(argv) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old_dir, new_dir = pathlib.Path(argv[0]), pathlib.Path(argv[1])
    report, differs = {}, False
    with tempfile.TemporaryDirectory() as tmp:
        cubins = {(side, name): pathlib.Path(tmp) / f"{side}-{name}.cubin"
                  for side in ("old", "new") for name in argv[2:]}
        procs = {key: compile_cubin(old_dir if key[0] == "old" else new_dir, key[1], path)
                 for key, path in cubins.items()}
        for key, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        for name in argv[2:]:
            old = sass_by_function(cubins["old", name])
            new = sass_by_function(cubins["new", name])
            row = {}
            for fn in sorted(set(old) | set(new)):
                if fn not in new:
                    row[fn] = "old only"
                elif fn not in old:
                    row[fn] = "new only"
                else:
                    row[fn] = "same" if old[fn] == new[fn] else "differs"
                    differs |= row[fn] == "differs"
            report[name] = row
    print(json.dumps(report, indent=1))
    return 1 if differs else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
