"""The tile and occupancy planners of the block and GDFN kernels
(``ops/block.py::plan_tiles``, ``gram_groups``; ``ops/gdfn.py::pick_layout``,
``plan_ffn``) are plain Python over a library handle: here that handle is a
stub that answers with byte counts and resident-block counts, so the tests
need neither a GPU nor a compiler. Also the build module's variants, its
binding of entry points and its reader of ptxas' report."""

import pytest

from rethink_acoustic_image_enhancement_tpu_torch.ops import _build
from rethink_acoustic_image_enhancement_tpu_torch.ops import block as pblock
from rethink_acoustic_image_enhancement_tpu_torch.ops import gdfn as pgdfn

LIMIT = pgdfn.SMEM_LIMIT
HALF = 115712  # what a block may use for two to be resident on an SM


class StubLibrary:
    """Answers like ``csrc/stage.cu`` and ``csrc/gdfn.cu``: shared memory
    grows with the tile's halo pixels, the channels and the chunk; two blocks
    are resident where a block needs at most half an SM. ``scale`` stretches
    every byte count, ``gram_bytes`` is kernel (A)'s answer for an 8x8 tile."""

    def __init__(self, scale=1.0, gram_bytes=110_000, refuse=()):
        self.scale, self.gram_bytes, self.refuse = scale, gram_bytes, set(refuse)

    def _apply_bytes(self, th, tw, c, fc):
        if (th, tw) in self.refuse:
            return 2 ** 31 - 1
        halo = (th + 2) * (tw + 2)
        return int(self.scale * (halo * c * 6 + halo * fc * 4 + c * fc * 3 + 8_000))

    def raie_stage_smem_bytes(self, kind, th, tw, c, heads, fc, chunk=0):
        if kind == 0:
            return int(self.gram_bytes * th * tw / 64)
        return self._apply_bytes(th, tw, c, fc)

    def raie_stage_blocks_per_sm(self, kind, th, tw, c, heads, fc, chunk=0):
        n = (self.raie_stage_smem_bytes(0, th, tw, c, heads, 0) if kind == 0
             else self._apply_bytes(th, tw, c, fc))
        return 0 if n > LIMIT else 2 if n <= HALF else 1

    def raie_gdfn_smem_bytes(self, th, tw, c, fc):
        return self._apply_bytes(th, tw, c, fc)

    def raie_gdfn_blocks_per_sm(self, th, tw, c, fc):
        n = self._apply_bytes(th, tw, c, fc)
        return 0 if n > LIMIT else 2 if n <= HALF else 1


def test_candidates_go_from_the_largest_tile_and_chunk_down():
    cands = pgdfn.ffn_candidates()
    assert cands[0] == (8, 8, 64) and cands[1] == (8, 8, 32)
    assert cands[-1] == (4, 4, 32) and len(cands) == 6


def test_largest_tile_and_chunk_with_two_blocks_resident():
    lib = StubLibrary()
    assert lib._apply_bytes(8, 8, 96, 64) <= HALF
    plan = pblock.plan_tiles(lib, 96, 1)
    assert plan == pblock.TilePlan((8, 8), 2, 64, (8, 8), 2)
    assert pgdfn.plan_ffn(lib, 96) == (64, (8, 8), 2)


def test_chunk_falls_back_from_64_to_32_for_the_second_block():
    lib = StubLibrary(scale=1.25)
    assert lib._apply_bytes(8, 8, 96, 64) > HALF >= lib._apply_bytes(8, 8, 96, 32)
    plan = pblock.plan_tiles(lib, 96, 1)
    assert (plan.fc, plan.apply_tile, plan.apply_blocks) == (32, (8, 8), 2)
    assert pgdfn.plan_ffn(lib, 96) == (32, (8, 8), 2)


def test_smaller_tile_where_it_buys_the_second_block():
    lib = StubLibrary(scale=1.4)
    assert lib._apply_bytes(8, 8, 96, 32) > HALF >= lib._apply_bytes(4, 8, 96, 64)
    plan = pblock.plan_tiles(lib, 96, 1)
    assert (plan.fc, plan.apply_tile, plan.apply_blocks) == (64, (4, 8), 2)


def test_one_block_per_sm_where_two_do_not_fit():
    lib = StubLibrary(scale=1.2)
    assert lib._apply_bytes(4, 4, 384, 32) > HALF  # no candidate gives two
    assert lib._apply_bytes(8, 8, 384, 64) > LIMIT  # and the largest gives none
    plan = pblock.plan_tiles(lib, 384, 1)
    assert plan.apply_blocks == 1
    # the first candidate, in order of preference, that fits at all
    fits = [c for c in pgdfn.ffn_candidates() if lib._apply_bytes(c[0], c[1], 384, c[2]) <= LIMIT]
    assert (plan.apply_tile, plan.fc) == (fits[0][:2], fits[0][2])
    assert pgdfn.plan_ffn(lib, 384) == (fits[0][2], fits[0][:2], 1)


def test_a_tile_the_kernel_refuses_is_skipped():
    """The library answers INT_MAX bytes for a shape it does not take (an
    output tile whose fragments do not fit the warps' registers)."""
    plan = pblock.plan_tiles(StubLibrary(refuse={(8, 8)}), 96, 1)
    assert plan.apply_tile == (4, 8) and plan.fc == 64


def test_gram_tile_is_the_largest_with_two_blocks_else_the_largest_that_fits():
    plan = pblock.plan_tiles(StubLibrary(gram_bytes=50_000), 96, 1)
    assert (plan.gram_tile, plan.gram_blocks) == ((8, 16), 2)  # 100,000 bytes
    plan = pblock.plan_tiles(StubLibrary(gram_bytes=110_000), 96, 1)
    assert (plan.gram_tile, plan.gram_blocks) == ((8, 8), 2)  # (8, 16) fits, but once
    plan = pblock.plan_tiles(StubLibrary(gram_bytes=440_000), 96, 1)
    assert (plan.gram_tile, plan.gram_blocks) == ((4, 4), 2)
    plan = pblock.plan_tiles(StubLibrary(gram_bytes=900_000), 96, 1)
    assert (plan.gram_tile, plan.gram_blocks) == ((4, 4), 1)  # 225,000 bytes


class WideStub(StubLibrary):
    """As ``csrc/stage.cu`` at C = 384: the C x C weights held whole fit no
    tile; in chunks they fit, once per SM."""

    def raie_stage_smem_bytes(self, kind, th, tw, c, heads, fc, chunk=0):
        if chunk == 0 and c == 384:
            return LIMIT + 1
        return super().raie_stage_smem_bytes(kind, th, tw, c, heads, fc) // 4

    def raie_stage_blocks_per_sm(self, kind, th, tw, c, heads, fc, chunk=0):
        n = self.raie_stage_smem_bytes(kind, th, tw, c, heads, fc, chunk)
        return 0 if n > LIMIT else 1 if chunk else 2


def test_wide_layout_only_where_no_whole_layout_fits():
    """C = 384 takes the chunked layouts, the largest chunk first; a width
    whose weights fit whole keeps them whole, though a chunked layout would
    be resident more often."""
    plan = pblock.plan_tiles(WideStub(), 384, 8)
    assert (plan.gram_chunk, plan.apply_chunk) == (64, 128)
    assert (plan.gram_blocks, plan.apply_blocks) == (1, 1)
    plan = pblock.plan_tiles(WideStub(), 192, 4)
    assert (plan.gram_chunk, plan.apply_chunk) == (0, 0)
    assert pblock._chunks(384, pblock._GRAM_CHUNKS) == [64, 32]
    assert pblock._chunks(96, pblock._PROJ_CHUNKS) == []  # no chunk divides 96 below it


class ShardStub(StubLibrary):
    """As ``csrc/stage.cu``'s layout queries for a model shard's block:
    records what it is asked; at C = 384 a shard's C x Cq weights held
    whole fit no tile from Cq = 192 on."""

    def __init__(self):
        super().__init__()
        self.asked = []

    def raie_stage_shard_smem_bytes(self, kind, th, tw, c, cq, heads, fc, chunk=0):
        self.asked.append((kind, c, cq, heads, fc))
        if chunk == 0 and c == 384 and cq >= 192:
            return LIMIT + 1
        return super().raie_stage_smem_bytes(kind, th, tw, c, heads, fc) // 4

    def raie_stage_shard_blocks_per_sm(self, kind, th, tw, c, cq, heads, fc, chunk=0):
        n = self.raie_stage_shard_smem_bytes(kind, th, tw, c, cq, heads, fc, chunk)
        return 0 if n > LIMIT else 1 if chunk else 2


def test_shard_plan_asks_for_the_shard_kernels():
    """With ``cq`` the planner asks the shard layouts of kernels (A) and
    (C') (kind 2, at the smallest hidden chunk), never (C), with both widths;
    the wide layout's chunks divide the shard's cq channels."""
    lib = ShardStub()
    plan = pblock.plan_tiles(lib, 384, 4, cq=192)
    assert {a[0] for a in lib.asked} == {0, 2}
    assert {a[1:4] for a in lib.asked} == {(384, 192, 4)}
    assert {a[4] for a in lib.asked if a[0] == 2} == {32}
    assert (plan.gram_chunk, plan.apply_chunk) == (64, 64)  # 128 does not divide 192
    plan = pblock.plan_tiles(ShardStub(), 384, 2, cq=96)
    assert (plan.gram_chunk, plan.apply_chunk) == (0, 0)


def test_nothing_fits_raises():
    with pytest.raises(ValueError, match="no block-kernel tile fits 96"):
        pblock.plan_tiles(StubLibrary(scale=50.0), 96, 1)
    with pytest.raises(ValueError, match="no block-kernel tile fits 96"):
        pblock.plan_tiles(StubLibrary(gram_bytes=10 ** 8), 96, 1)
    with pytest.raises(ValueError, match="no GDFN-kernel tile fits 96"):
        pgdfn.plan_ffn(StubLibrary(scale=50.0), 96)


def test_pick_layout_prefers_two_blocks_over_order():
    sizes = {"a": LIMIT, "b": HALF, "c": LIMIT + 1}
    blocks = {"a": 1, "b": 2, "c": 0}
    pick = pgdfn.pick_layout([("a",), ("b",), ("c",)], sizes.get, blocks.get)
    assert pick == (("b",), 2)
    pick = pgdfn.pick_layout([("a",), ("c",)], sizes.get, blocks.get)
    assert pick == (("a",), 1)
    assert pgdfn.pick_layout([("c",)], sizes.get, blocks.get) is None
    # fits by its bytes, but the device keeps no block of it resident
    assert pgdfn.pick_layout([("a",)], sizes.get, {"a": 0}.get) is None


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("blocks_per_sm", [1, 2])
def test_gram_groups_stay_one_wave(batch, blocks_per_sm):
    n_sm = 132
    groups = pblock.gram_groups(4096, n_sm, batch, blocks_per_sm)
    assert groups * batch <= blocks_per_sm * n_sm  # every block resident at once
    assert (groups + 1) * batch > blocks_per_sm * n_sm  # and no SM left out
    assert groups == {(1, 1): 132, (2, 1): 66, (8, 1): 16,
                      (1, 2): 264, (2, 2): 132, (8, 2): 33}[(batch, blocks_per_sm)]


def test_gram_groups_never_exceed_the_tiles_nor_fall_to_zero():
    assert pblock.gram_groups(6, 132, 1) == 6
    assert pblock.gram_groups(4096, 132, 200) == 1


def test_instrumented_library_is_a_variant_of_the_stage_source():
    assert _build.VARIANTS["stage_clocks"] == ("stage", ("-DRAIE_PHASE_CLOCKS",))
    assert _build.VARIANTS["stage_sm90_clocks"] == ("stage_sm90", ("-DRAIE_PHASE_CLOCKS",))
    assert _build.VARIANTS["stage_sm90_wide_clocks"] == ("stage_sm90_wide",
                                                         ("-DRAIE_PHASE_CLOCKS",))
    assert set(_build.sources()) == {"gdfn", "layernorm", "stage", "stage_clocks",
                                     "stage_sm90", "stage_sm90_clocks", "stage_sm90_wide",
                                     "stage_sm90_wide_clocks"}
    assert _build._lib_path("stage") != _build._lib_path("stage_clocks")
    assert _build._lib_path("stage_clocks").name.startswith("libstage_clocks-")


def test_kernel_resources_reads_the_ptxas_report(tmp_path, monkeypatch):
    log = """\
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__abc_8_stage_cu_1f2e7k_applyILi64EffEEvPKT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN58_GLOBAL__N__abc_8_stage_cu_1f2e7k_applyILi64EffEEvPKT0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__abc_8_stage_cu_1f2e7k_applyILi32E13__nv_bfloat16fEEvPKT0_' for 'sm_90a'
    24 bytes stack frame, 24 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__abc_8_stage_cu_1f2e9k_softmaxEPKfS1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers
"""
    monkeypatch.setattr(_build, "build_log", lambda name: log)
    assert _build.kernel_resources("stage") == {
        "k_apply": {"registers": 128, "spill_bytes": 40},
        "k_softmax": {"registers": 48, "spill_bytes": 0}}


def test_bind_types_each_table_once_and_then_returns_at_once(monkeypatch):
    """Two modules bind one library with tables of their own: each table's
    entry points are typed on its first bind; a bound table returns the
    loaded handle without loading or typing again (every launch binds)."""
    from types import SimpleNamespace

    def fn():
        return SimpleNamespace(argtypes=None, restype=None)

    handle = SimpleNamespace(raie_stub_error_string=fn(), raie_a=fn(), raie_b=fn())
    loads = []

    def load(name):
        loads.append(name)
        _build._loaded[name] = handle
        return handle

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_bound", set())
    first, second = {"raie_a": [int]}, {"raie_b": [float, int]}
    assert _build.bind("stub", first) is handle and loads == ["stub"]
    assert handle.raie_a.argtypes == [int] and handle.raie_b.argtypes is None
    assert handle.raie_stub_error_string.restype is not None
    handle.raie_a.argtypes = "untouched"
    assert _build.bind("stub", first) is handle and loads == ["stub"]
    assert handle.raie_a.argtypes == "untouched"
    assert _build.bind("stub", second) is handle and loads == ["stub", "stub"]
    assert handle.raie_b.argtypes == [float, int] and handle.raie_a.argtypes == "untouched"
