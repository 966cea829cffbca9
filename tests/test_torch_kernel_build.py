"""The CUDA kernel build (repro_torch.kernels.common) on the CPU: which
files it compiles, and that editing a source or a header it includes
rebuilds the library. A stand-in `nvcc` (a Python script that records its
arguments and writes the file after `-o`) takes the compiler's place, so
this runs without the CUDA toolkit."""
import json
import shutil
import sys

import pytest
import torch

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


def test_shared_header_is_a_source_and_every_include_resolves():
    """The repository's own kernels: the shared headers (the tensor-core
    helpers, the scans' blocking) are in the build's sources, and every
    quoted include of a `.cu` or `.cuh` names a header that is one of
    them (nvcc resolves it beside the including file)."""
    sources = common.kernel_sources()
    names = [p.relative_to(common.PACKAGE_DIR).as_posix() for p in sources]
    assert "kernels/shared/csrc/sm90.cuh" in names
    assert "kernels/shared/csrc/scan_tiles.cuh" in names
    included = set()
    for src in sources:
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                header = (src.parent / line.split('"')[1]).resolve()
                assert header in sources, f"{src.name}: {line}"
                included.add(header.name)
    assert included == {"sm90.cuh", "scan_tiles.cuh"}


@pytest.mark.parametrize("edit", ["kernels/shared/csrc/sm90.cuh",
                                  "kernels/flash_attention/csrc/"
                                  "flash_attention.cu", None])
def test_editing_the_shared_header_changes_the_digest(tmp_path, monkeypatch,
                                                      edit):
    """A copy of the repository's kernel sources: editing the shared
    header (or a source) changes the build's digest, so the library is
    rebuilt; the untouched tree keeps its digest."""
    pkg = tmp_path / "pkg"
    shutil.copytree(common.PACKAGE_DIR / "kernels", pkg / "kernels",
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(common, "PACKAGE_DIR", pkg)
    before = common._digest(common.kernel_sources())
    if edit is not None:
        path = pkg / edit
        path.write_text(path.read_text() + "\n// edited\n")
    after = common._digest(common.kernel_sources())
    assert (after != before) == (edit is not None)


def test_replay_draw_sizing_and_limits_need_no_library(monkeypatch):
    """`prioritized_sample_c`'s pure-Python side: its limits raise with
    their messages before the library is asked for anything (here it
    cannot be built), and the buffer sizing of a draw the kernel takes
    does ask it."""
    from repro_torch.kernels.replay_sample import kernel as rk

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(rk, "_launcher", no_library)
    rk.buffer_words.cache_clear()
    with pytest.raises(ValueError, match=r"C=4194305 above 4194304 slots"):
        rk.buffer_words(4096 * 1024 + 1, 64)
    with pytest.raises(AssertionError, match="library"):
        rk.buffer_words(20000, 64)
    prio = torch.ones(2000)
    size = torch.tensor([5], dtype=torch.int32)
    for n, msg in ((1025, r"n=1025 outside \[1, min\(C=2000, 1024\)\]"),
                   (0, r"n=0 outside"), (2001, r"n=2001 outside")):
        with pytest.raises(ValueError, match=msg):
            rk._check(prio, prio, size, n)
    with pytest.raises(ValueError, match="size must be torch.int32"):
        rk._check(prio, prio, size.long(), 8)
    rk._check(prio, prio, size, 1024)


@pytest.mark.parametrize("KVH,G", [(2, 3), (1, 4), (3, 1)])
def test_flash_packed_arguments_index_the_model_layout(KVH, G):
    """The flash kernel's packed arguments (`FlashParams`, 176 bytes) for
    the model layout qg (B,S,KVH,G,D), k, v (B,S,KVH,D): pointers, dims,
    and (b, h, s) strides such that head h = kvh * G + g of q lies at
    h * q_h, the kv heads at kvh * k_h, out contiguous (B,S,H,D), and no
    log-sum-exp output (a null `lse`: the serving forward)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    assert fk.PARAMS.size == 176
    B, S, D = 2, 5, 32
    qg = torch.zeros((B, S, KVH, G, D), dtype=torch.bfloat16)
    k = torch.zeros((B, S, KVH + 1, D), dtype=torch.bfloat16)[:, :, 1:]
    v = torch.zeros((B, S, KVH, D), dtype=torch.bfloat16)
    out = torch.empty_like(qg)
    f = fk.PARAMS.unpack(fk.grouped_params(qg, k, v, out, True, 7))
    H = KVH * G
    assert f[:4] == (qg.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr())
    assert f[4:13] == (1, B, H, KVH, S, D, 1, 7, S)
    assert f[13] == pytest.approx(D ** -0.5)
    q_h = qg.stride(2) if G == 1 else qg.stride(3)
    assert f[14:] == (qg.stride(0), q_h, qg.stride(1),
                      k.stride(0), k.stride(2), k.stride(1),
                      v.stride(0), v.stride(2), v.stride(1),
                      S * H * D, D, H * D, 0)
    # (KVH, G) that do not fold into one head stride are refused
    if KVH > 1 and G > 1:
        odd = torch.zeros((B, S, G, KVH, D),
                          dtype=torch.bfloat16).transpose(2, 3)
        assert fk.grouped_params(odd, k, v, out, True, 0) is None


@pytest.mark.parametrize("kv_end", [1, 3, 4, 31, 32, 33, 384])
@pytest.mark.parametrize("dt", [0, 1])
def test_flash_kernel_choice(dt, kv_end):
    """`kernel_kind`, the one place the flash call picks its kernel: the
    short-span f32 kernel (kind 2) exactly when the call is f32 (dt 0) and
    every row's keys fit one tile (kv_end <= 32); flash_fwd<float> (0)
    for longer f32 spans; bf16 (1) whatever the span."""
    from repro_torch.kernels.flash_attention import kernel as fk
    want = 1 if dt == 1 else 2 if kv_end <= 32 else 0
    assert fk.kernel_kind(dt, kv_end, 32, 2, kv_end, 2) == want
    # a grid past 2^31 - 1 blocks keeps flash_fwd
    assert fk.kernel_kind(dt, kv_end, 65535, 65535, 64, 1) == (1 if dt
                                                               else 0)


@pytest.mark.parametrize("S,kind", [(1, 2), (3, 2), (4, 2), (32, 2),
                                    (33, 0)])
def test_flash_f32_packed_arguments_name_the_kernel(S, kind):
    """The trunk's f32 calls (S = 3 for pendulum, 4 for cartpole) pack
    kind 2, the short-span kernel, through both entries; a span of 33
    keys packs flash_fwd's 0; a `valid_len` of 32 brings a longer call
    back to the short kernel."""
    from repro_torch.kernels.flash_attention import kernel as fk
    B, KVH, G, D = 32, 2, 2, 64
    qg = torch.zeros((B, S, KVH, G, D))
    k = v = torch.zeros((B, S, KVH, D))
    out = torch.empty_like(qg)
    assert fk.PARAMS.unpack(fk.grouped_params(qg, k, v, out, True,
                                              0))[4] == kind
    q = qg.reshape(B, S, KVH * G, D).transpose(1, 2)
    dt, kv_end = fk._check(q, k.transpose(1, 2), v.transpose(1, 2), None)
    assert fk.kernel_kind(dt, kv_end, B, KVH, S, G) == kind
    _, kv_end = fk._check(q, k.transpose(1, 2), v.transpose(1, 2), 32)
    assert fk.kernel_kind(dt, kv_end, B, KVH, S, G) == 2
