"""The split plan of the port's paged attention kernel
(``repro_torch.kernels.paged_attention.splits``) and the head groups of
its blocks (``heads_per_block``), property-tested on the CPU: both are
plain Python that the wrapper computes before each launch, and the
kernel trusts the plan to cover every page of a slot's table row exactly
once, in whole pages."""

import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import paged_attention as pa  # noqa: E402

GRID_Y = 65535               # the kernel's grid is (n_split, B * Hq / GB)


def _check_plan(B, blocks, n_pages, page, n_sm):
    n, chunk = pa.splits(B, blocks, n_pages, page, n_sm)
    assert 1 <= n <= pa.MAX_SPLITS                               # one cluster a row
    assert chunk % page == 0 and chunk > 0                       # whole pages
    per = chunk // page
    ranges = [(s * per, min(n_pages, (s + 1) * per)) for s in range(n)]
    assert all(lo < hi for lo, hi in ranges)                     # no empty range
    covered = [0] * n_pages
    for lo, hi in ranges:
        for j in range(lo, hi):
            covered[j] += 1
    assert covered == [1] * n_pages                              # each page once
    if B * blocks * min(pa.MAX_SPLITS, n_pages) >= n_sm:         # the pages allow it
        assert B * blocks * n >= min(n_sm, B * blocks * n)
    assert n <= -(-pa.BLOCKS_PER_SM * n_sm // (B * blocks))      # no more than needed
    return n, chunk


@settings(max_examples=400, deadline=None)
@given(B=st.integers(1, 16), blocks=st.integers(1, 64), n_pages=st.integers(1, 512),
       page=st.sampled_from([1, 8, 16, 32]), n_sm=st.integers(1, 132))
@example(B=1, blocks=1, n_pages=7, page=16, n_sm=132)     # 7 pages: 7 splits of one
@example(B=1, blocks=1, n_pages=13, page=16, n_sm=132)    # 8 wanted: 7 splits of two
@example(B=16, blocks=64, n_pages=1, page=16, n_sm=1)
def test_split_ranges_tile_the_pages_once(B, blocks, n_pages, page, n_sm):
    _check_plan(B, blocks, n_pages, page, n_sm)


@pytest.mark.parametrize("B,Hq,Hkv,n_pages,page,quant,want", [
    (8, 32, 8, 16, 16, False, (4, 64)),     # minitron-8b at the serving batch: 256 blocks
    (8, 32, 8, 16, 16, True, (4, 64)),      # the same over int8/fp8 pages
    (1, 32, 8, 16, 16, False, (8, 32)),     # minitron-8b, one slot
    (8, 4, 2, 6, 16, False, (6, 16)),       # the smoke config (max_seq 96)
    (8, 48, 1, 16, 16, False, (6, 48)),     # granite-20b: G 48, six head groups of 8
    (8, 48, 8, 16, 16, False, (4, 64)),     # grok: G 6, one group a kv head
    (8, 64, 8, 16, 16, True, (3, 96)),      # deepseek-67b over codes: G 8, two groups of 4
])
def test_split_plan_at_the_paths_shapes(B, Hq, Hkv, n_pages, page, quant, want):
    gb = pa.heads_per_block(Hq // Hkv, quant)
    assert (Hq // Hkv) % gb == 0
    assert _check_plan(B, Hq // gb, n_pages, page, 132) == want


@pytest.mark.parametrize("G", pa.GROUPS)
def test_heads_per_block_divides_each_group_the_kernel_takes(G):
    dense, quant = pa.heads_per_block(G, False), pa.heads_per_block(G, True)
    assert G % dense == 0 and dense in (1, 2, 4, 6, 8)
    assert G % quant == 0 and quant in (1, 2, 4)
    assert dense == min(G, 8) and quant <= min(G, 4)


@pytest.mark.parametrize("src", ["attention.cu", "attention_quant.cu"])
def test_packed_args_match_the_source(src):
    """``_PACK`` is csrc/paged_attention.cuh's PagedArgs (size and format),
    which both entry points take."""
    import re
    import struct
    from pathlib import Path
    csrc = Path(pa.__file__).parent / "csrc"
    text = (csrc / "paged_attention.cuh").read_text()
    size = int(re.search(r"sizeof\(PagedArgs\) == (\d+)", text).group(1))
    assert struct.calcsize(pa._PACK.format) == pa._PACK.size == size
    assert re.search(r'struct format "([^"]+)"', text).group(1) == pa._PACK.format
    assert '#include "paged_attention.cuh"' in (csrc / src).read_text()


def test_wrapper_refuses_a_device_it_does_not_take():
    """Meta tensors take the plain version (nothing runs); a device that
    is neither the CPU, meta nor CUDA raises."""
    from _torch_elsewhere import elsewhere
    q = torch.zeros(1, 4, 1, 16, device="meta")
    pages = torch.zeros(3, 2, 16, 16, device="meta")
    bt = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    out = pa.paged_attention(q, pages, pages, block_tables=bt, kv_len=8)
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(elsewhere(1, 4, 1, 16), elsewhere(3, 2, 16, 16),
                           elsewhere(3, 2, 16, 16),
                           block_tables=elsewhere(1, 2, dtype=torch.int32), kv_len=8)
