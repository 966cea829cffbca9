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
    ("advantages/csrc/advantages.cu", "_SCAN")])
def test_ablation_cut_texts_stand_in_their_sources(source, cuts):
    """Every text `profile_small_kernels --ablate` cuts out of a kernel
    source stands in that source as it is now."""
    from repro_torch.kernels import common
    from repro_torch.launch import profile_small_kernels as psk
    text = (common.PACKAGE_DIR / "kernels" / source).read_text()
    assert psk.missing_texts(text, getattr(psk, cuts)) == []


def test_ablation_refuses_a_cut_whose_text_moved(tmp_path):
    """A cut whose text the source no longer holds is an error before any
    build, not a variant quietly left out."""
    from repro_torch.launch import profile_small_kernels as psk
    source = tmp_path / "k.cu"
    source.write_text("__global__ void k() { int x = 1; }\n")
    with pytest.raises(ValueError, match="no_x"):
        psk.build_variants(tmp_path, source,
                           [("no_x", [("int x = 2;", "int x = 0;")])])
