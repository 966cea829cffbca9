"""Compare the device code (SASS) of a CUDA source's kernels between two
versions of the file: whether an edit left a kernel's instructions as
they were.

    python -m repro_torch.launch.sass_diff OLD.cu NEW.cu --match flash_fwdIf

Compiles both for sm_90a as the kernel build does (-O3, to a cubin),
disassembles them with `cuobjdump -sass`, and compares the instruction
listings of every kernel whose mangled name contains `--match`, with the
anonymous namespace's per-file hash taken out of the names, and shows
each differing kernel's first differing instruction. A source's
quoted includes resolve beside it, so OLD.cu is best a copy of the old
file placed where its includes resolve. Prints one JSON line; exits 1 if
a kernel differs or is missing on one side. Needs the CUDA toolkit.
"""
import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels.common import _nvcc

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}")


def sass(source, cubin):
    """{normalized kernel name: instruction listing} of one source."""
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", str(source), "-o",
                    str(cubin)], check=True, capture_output=True, text=True)
    dump = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
                           str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    kernels = {}
    for block in dump.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        # instruction lines, their column padding (which follows the
        # widest line of the whole listing) collapsed
        lines = [" ".join(ln.split()) for ln in body.splitlines()
                 if ln.strip().startswith("/*")]
        kernels[_ANON.sub("_GLOBAL__N__<file>", name.strip())] = lines
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--match", default="")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        old = sass(args.old, Path(tmp) / "old.cubin")
        new = sass(args.new, Path(tmp) / "new.cubin")
    names = sorted(n for n in set(old) | set(new) if args.match in n)
    result = {n: ("missing" if n not in old or n not in new else
                  "same" if old[n] == new[n] else "differs")
              for n in names}
    sizes = {n: [len(old.get(n, [])), len(new.get(n, []))] for n in names}
    first = {n: next(([a, b] for a, b in zip(old[n], new[n]) if a != b),
                     None)
             for n in names if result[n] == "differs"}
    print(json.dumps({"match": args.match, "kernels": result,
                      "instructions_old_new": sizes,
                      "first_difference": first}))
    return 0 if names and all(r == "same" for r in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
