"""The CUDA kernel build (repro_torch.kernels.common) on the CPU: which
files it compiles, and that editing a source or a header it includes
rebuilds the library. A stand-in `nvcc` (a Python script that records its
arguments and writes the file after `-o`) takes the compiler's place, so
this runs without the CUDA toolkit."""
import json
import sys

import pytest

from repro_torch.kernels import common

FAKE_NVCC = f"""#!{sys.executable}
import json, os, sys
with open(os.environ["FAKE_NVCC_LOG"], "a") as log:
    log.write(json.dumps(sys.argv[1:]) + "\\n")
open(sys.argv[sys.argv.index("-o") + 1], "w").close()
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A package with two kernels, one of which includes a header, a
    build directory and the stand-in nvcc, all under tmp_path."""
    pkg = tmp_path / "pkg"
    for name, files in (("a", ("a.cu", "a.cuh")), ("b", ("b.cu",))):
        csrc = pkg / "kernels" / name / "csrc"
        csrc.mkdir(parents=True)
        for f in files:
            (csrc / f).write_text(f"// {f}\n")
    (pkg / "kernels" / "a" / "csrc" / "notes.txt").write_text("not a source")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setattr(common, "PACKAGE_DIR", pkg)
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    return pkg, log


def _calls(log):
    if not log.exists():
        return []
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    log.unlink()
    return calls


def test_kernel_sources_list_sources_and_headers(tree):
    pkg, _ = tree
    names = [p.relative_to(pkg).as_posix() for p in common.kernel_sources()]
    assert names == ["kernels/a/csrc/a.cu", "kernels/a/csrc/a.cuh",
                     "kernels/b/csrc/b.cu"]


def test_build_compiles_sources_only_and_links_once(tree):
    _, log = tree
    lib, _ = common.build_kernels()
    assert lib.exists()
    calls = _calls(log)
    compiled = sorted(c[c.index("-c") + 1].rsplit("/", 1)[1]
                      for c in calls if "-c" in c)
    assert compiled == ["a.cu", "b.cu"]
    assert sum("-shared" in c for c in calls) == 1


@pytest.mark.parametrize("edit", ["kernels/a/csrc/a.cuh",
                                  "kernels/b/csrc/b.cu", None])
def test_build_reruns_exactly_when_a_source_or_header_changes(tree, edit):
    pkg, log = tree
    common.build_kernels()
    _calls(log)
    if edit is not None:
        (pkg / edit).write_text("// edited\n")
    common.build_kernels()
    assert bool(_calls(log)) == (edit is not None)
