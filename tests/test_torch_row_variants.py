"""tools/row_variants.py against the graph kernels' sources as they
stand, on the CPU (no card, no nvcc): every planted fault and design copy
must match the sources as often as it says, change them, and name graph
kernels that chip_smoke.check_rows or chip_smoke.check_merge knows, so a
tool left behind by a change to the kernels fails here and not on the
card."""
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "row_variants", ROOT / "tools" / "row_variants.py")
RV = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RV)

import chip_smoke  # noqa: E402  (row_variants puts the root on sys.path)


@pytest.mark.parametrize("table,name", [
    *((RV.FAULTS, name) for name in RV.FAULTS),
    *((RV.ABLATIONS, name) for name in RV.ABLATIONS)])
def test_variant_applies_to_the_current_sources(table, name):
    subs, kernels = table[name]
    base = RV.sources()
    copy = RV.planted(base, subs)
    assert (copy != base) == bool(subs)
    assert set(kernels) <= set(chip_smoke.GRAPH_KERNELS)
    if table is RV.FAULTS:
        # a planted fault must name the kernels whose check it fails
        assert bool(kernels) == bool(subs)
    else:
        assert kernels and set(kernels) <= set(RV.TIMED)


def test_a_stale_substitution_is_refused():
    base = RV.sources()
    with pytest.raises(ValueError, match="occurs 0 times"):
        RV.planted(base, [("no such line in any source", "x")])
    with pytest.raises(ValueError, match="not 1"):
        RV.planted(base, [("warp_load_row8(ell_src, r, s);", "x")])


def test_the_built_sources_hold_the_entry_points_the_tool_binds():
    """Each source the tool builds defines the C entry points it binds
    from that source's library."""
    base = RV.sources()
    for src, names in RV.LIBS.items():
        for name in names:
            assert f'extern "C" int {name}(' in base[src], (src, name)


def test_merge_tile_is_the_sources():
    """The merge's tile, which chip_smoke.MERGE_CASES straddle, is the one
    csrc/repair.cu compiles, and the copies that change it start from
    it."""
    from repro_torch.kernels import repair as TK
    assert chip_smoke.MERGE_TILE == TK.MERGE_TILE
    assert f"constexpr int kMergeTile = {TK.MERGE_TILE};" == RV.MERGE_TILE
    assert RV.sources()["repair.cu"].count(RV.MERGE_TILE) == 1
    edges = {D for _, D, *_ in chip_smoke.MERGE_CASES}
    T = TK.MERGE_TILE
    assert {1, T - 1, T, T + 1, 3 * T + 5} <= edges
