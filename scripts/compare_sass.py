"""Compare the SASS of CUDA sources in two copies of `mmda_tpu_torch/csrc`,
function by function, instruction by instruction.

    python scripts/compare_sass.py OLD_CSRC NEW_CSRC short_attn_fwd short_attn_bwd ...
    python scripts/compare_sass.py --counts OLD_CSRC NEW_CSRC flash_fwd ...

Each `<name>.cu` is compiled in both directories with the package's nvcc
flags (`mmda_tpu_torch/ops/kernels/_build.py` NVCC_FLAGS, as a cubin; all
at once), and `cuobjdump -sass` lists its kernels.  Addresses, encodings
and the file's anonymous-namespace tag in a function's name are dropped, so
two functions are "same" when their instruction lists are equal.  Prints
one JSON object: {name: {function: "same" | "differs" | "old only" | "new
only"}}, and exits 1 if a function that both compile differs.  Needs nvcc
(the card's machine).

`--counts` is for a change to a kernel's arguments, which renames it (the
mangled name carries its parameter types): functions are matched by their
demangled name without the parameter list (`cu++filt`), and each gets its
instruction count, its HGMMA and HMMA counts (old, new) and the opcodes
added and removed (a multiset difference); it exits 1 if a tensor-core
count changed or a function is on one side only.
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


def sass_by_function(cubin: pathlib.Path, anon_tags: bool = False) -> dict:
    """{kernel function: [instruction text, ...]} of a cubin; the file's
    anonymous-namespace tag dropped from the names unless `anon_tags` (a
    mangled name without it no longer demangles)."""
    tool = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    functions: dict = {}
    current = None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            name = name if anon_tags else _ANON.sub("_GLOBAL__N__", name)
            current = functions.setdefault(name, [])
        elif current is not None and _ADDR.search(line):
            ins = _ENC.sub("", _ADDR.sub("", line)).strip()
            if ins:
                current.append(ins)
    return functions


_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")


def opcode(ins: str) -> str:
    """An instruction's opcode with its modifiers, without its predicate."""
    return _PRED.sub("", ins).split()[0].rstrip(";")


def unmangled(names) -> dict:
    """{mangled name: demangled name without its parameter list}."""
    tool = pathlib.Path(_build.nvcc_path()).parent / "cu++filt"
    names = list(names)
    text = subprocess.run([str(tool)], input="\n".join(names), check=True, capture_output=True,
                          text=True).stdout.splitlines()
    out = {}
    for name, plain in zip(names, text):
        depth = 0                   # the parameter list: the last (...) group, from its end
        for i in range(len(plain) - 1, -1, -1):
            depth += (plain[i] == ")") - (plain[i] == "(")
            if depth == 0:
                plain = plain[:i] if plain.endswith(")") else plain
                break
        out[name] = _ANON.sub("_GLOBAL__N__", plain)
    return out


def count_report(old: dict, new: dict) -> tuple:
    """({function: counts}, whether a tensor-core count or a function's
    presence changed) for two {function: instructions} of one source."""
    old, new = ({plain: side[k] for k, plain in unmangled(side).items()} if side else {}
                for side in (old, new))
    row, bad = {}, False
    for fn in sorted(set(old) | set(new)):
        if fn not in old or fn not in new:
            row[fn] = "old only" if fn in old else "new only"
            bad = True
            continue
        ops = [[opcode(i) for i in side[fn]] for side in (old, new)]
        counts = {tc: [sum(o.split(".")[0] == tc for o in side) for side in ops]
                  for tc in ("HGMMA", "HMMA")}
        added, removed = {}, {}
        for o in set(ops[0]) | set(ops[1]):
            d = ops[1].count(o) - ops[0].count(o)
            if d:
                (added if d > 0 else removed)[o] = abs(d)
        row[fn] = {"instructions": [len(ops[0]), len(ops[1])], **counts,
                   "added": added, "removed": removed}
        bad |= any(a != b for a, b in counts.values())
    return row, bad


def main(argv) -> int:
    counts = argv[:1] == ["--counts"]
    argv = argv[1:] if counts else argv
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
            old = sass_by_function(cubins["old", name], counts)
            new = sass_by_function(cubins["new", name], counts)
            if counts:
                report[name], bad = count_report(old, new)
                differs |= bad
                continue
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
