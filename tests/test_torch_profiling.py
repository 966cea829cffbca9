"""`launch/profiling.records_whole`, the rule by which a torch.profiler
window counts (the profiler now and then loses kernel records, not
their launch calls), on synthetic counts: no card needed."""
import pytest

from repro_torch.launch.profiling import records_whole


@pytest.mark.parametrize("launches,records,whole", [
    (10, 10, True),    # every launch's kernel recorded
    (10, 12, True),    # more records than launch calls (e.g. a library's
                       # own launches the runtime API did not show)
    (10, 9, False),    # a kernel record lost
    (0, 0, False),     # nothing seen: no window to count
    (0, 3, True),      # launch records lost, kernels whole
    (40, 0, False)])
def test_records_fall_short_of_launch_calls(launches, records, whole):
    assert records_whole(launches, records) is whole


@pytest.mark.parametrize("counts,calls,whole", [
    ({"k": 20, "null": 10}, 10, True),
    ({"k": 19, "null": 10}, 10, False),   # one call's kernel lost
    ({"k": 10, "Memcpy HtoD": 5}, 5, True),
    ({"k": 7}, 10, False)])
def test_each_kernel_a_whole_number_of_times_a_call(counts, calls, whole):
    records = sum(counts.values())
    assert records_whole(records, records, counts, calls) is whole


@pytest.mark.parametrize("source,cuts", [
    ("flash_attention/csrc/flash_attention.cu", "_FLASH_SHORT"),
    ("advantages/csrc/advantages.cu", "_SCAN"),
    ("vtrace/csrc/vtrace.cu", "_VTRACE"),
    ("flash_attention/csrc/flash_attention_bwd.cu", "_FLASH_BWD")])
def test_ablation_cut_texts_stand_in_their_sources(source, cuts):
    """Every text `profile_small_kernels --ablate` cuts out of a kernel
    source's build stands in that source or in the shared headers it
    includes (kernels/shared/csrc/*.cuh) as they are now."""
    from repro_torch.kernels import common
    from repro_torch.launch import profile_small_kernels as psk
    texts = psk.build_texts(common.PACKAGE_DIR / "kernels" / source)
    assert psk.missing_texts("\n".join(texts.values()),
                             getattr(psk, cuts)) == []


def test_a_variant_includes_its_cut_header(tmp_path):
    """A variant's copies lie as in the package, so the source's quoted
    include of the shared header resolves to the header's copy, which
    carries the cut (the tiled kernels' loads stand there)."""
    from repro_torch.kernels import common
    from repro_torch.launch import profile_small_kernels as psk
    texts = psk.build_texts(common.PACKAGE_DIR / "kernels" / "vtrace" /
                            "csrc" / "vtrace.cu")
    src = psk.write_variant(tmp_path, texts, [psk._LOAD_TILE])
    include = '#include "../../shared/csrc/scan_tiles.cuh"'
    assert include in src.read_text()
    header = (src.parent / "../../shared/csrc/scan_tiles.cuh").read_text()
    old, new = psk._LOAD_TILE
    assert new in header and old not in header


def test_ablation_refuses_a_cut_whose_text_moved(tmp_path):
    """A cut whose text the source no longer holds is an error before any
    build, not a variant quietly left out."""
    from repro_torch.launch import profile_small_kernels as psk
    source = tmp_path / "k.cu"
    source.write_text("__global__ void k() { int x = 1; }\n")
    with pytest.raises(ValueError, match="no_x"):
        psk.build_variants(tmp_path, source,
                           [("no_x", [("int x = 2;", "int x = 0;")])])


def test_host_pairs_rotate_the_order(monkeypatch):
    """`profile_host_cost --parent A --parent B` runs a warm-up process
    per checkout, then rounds of one process each, the order rotating by
    one each round so every checkout takes every place."""
    from repro_torch.launch import profile_host_cost as phc
    seen = []
    monkeypatch.setattr(phc, "side", lambda co: seen.append(str(co)) or co)
    out = phc.pairs(["a", "b"], 4)
    tree = str(phc.Path(phc.__file__).resolve().parents[3])
    assert seen[:3] == ["a", "b", tree]
    assert [r["order"] for r in out] == [["a", "b", "tree"],
                                         ["b", "tree", "a"],
                                         ["tree", "a", "b"],
                                         ["a", "b", "tree"]]
    assert all(str(r[name]) == (tree if name == "tree" else name)
               for r in out for name in r["order"])
