"""The split plan of the port's decode attention kernel
(``repro_torch.kernels.decode_attention.splits``), property-tested on the
CPU: the plan is plain Python that the wrapper computes before each
launch, and the kernel trusts it to cover every key exactly once."""

import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import decode_attention as dec  # noqa: E402

GRID_Y = 65535               # the kernel's grid is (n_split, B * Hkv * head groups)


def _check_plan(B, Hkv, S, n_sm):
    n, chunk = dec.splits(B, Hkv, S, n_sm)
    assert 1 <= n <= dec.MAX_SPLITS and B * Hkv <= GRID_Y     # one cluster a (slot, kv head)
    assert chunk >= dec.MIN_KEYS or n == 1
    ranges = [(s * chunk, min(S, (s + 1) * chunk)) for s in range(n)]
    assert all(lo < hi for lo, hi in ranges)                     # no empty range
    covered = [0] * S
    for lo, hi in ranges:
        for t in range(lo, hi):
            covered[t] += 1
    assert covered == [1] * S                                    # each key once
    if B * Hkv * min(dec.MAX_SPLITS, max(1, S // dec.MIN_KEYS)) >= n_sm:   # S allows it
        assert B * Hkv * n >= n_sm
    # no more splits than the block target needs
    assert n <= -(-dec.BLOCKS_PER_SM * n_sm // (B * Hkv))


@settings(max_examples=400, deadline=None)
@given(B=st.integers(1, 16), Hkv=st.integers(1, 32), S=st.integers(1, 4096),
       n_sm=st.integers(1, 132))
@example(B=16, Hkv=1, S=270, n_sm=100)    # 32-key units would give 5 splits, 80 blocks
@example(B=1, Hkv=1, S=15, n_sm=132)
@example(B=16, Hkv=32, S=1, n_sm=1)
def test_split_ranges_tile_the_keys_once_and_fill_the_card(B, Hkv, S, n_sm):
    _check_plan(B, Hkv, S, n_sm)


@pytest.mark.parametrize("B,Hkv,S,n_sm,want", [
    (1, 8, 256, 132, (8, 32)),       # minitron-8b, B=1: 64 blocks of 32 keys
    (8, 32, 256, 132, (2, 128)),     # zamba2-7b's shared block at B=8: 512 blocks
    (8, 8, 256, 132, (5, 52)),       # minitron-8b at the serving batch
    (2, 2, 48, 132, (3, 16)),        # the smoke config
    (16, 32, 4096, 132, (1, 4096)),  # enough (slot, kv head) pairs: no split
])
def test_split_plan_at_the_paths_shapes(B, Hkv, S, n_sm, want):
    assert dec.splits(B, Hkv, S, n_sm) == want
    _check_plan(B, Hkv, S, n_sm)


@pytest.mark.parametrize("G", range(1, 65))
def test_heads_per_block_divides_the_group_and_fits_the_kernel(G):
    """A block takes 1, 2, 4 or 8 query heads (the kernel's instantiations),
    a divisor of G: all of G up to 8 where it is one of those."""
    gb = dec.heads_per_block(G)
    assert gb in (1, 2, 4, 8) and G % gb == 0
    if G in (1, 2, 4, 8):
        assert gb == G
    assert gb == max(d for d in (1, 2, 4, 8) if G % d == 0)


@pytest.mark.parametrize("B,Hq,Hkv,S,want_gb,want", [
    (1, 48, 1, 256, 8, (8, 32)),      # granite-20b at B=1: six groups of 8, 48 blocks
    (8, 48, 1, 256, 8, (6, 43)),      # granite-20b at the serving batch
    (1, 16, 16, 256, 1, (8, 32)),     # gemma-7b at B=1: 128 blocks
    (1, 64, 8, 256, 8, (8, 32)),      # deepseek-67b at B=1
    (2, 8, 2, 48, 4, (3, 16)),        # deepseek-67b's smoke (D 8)
])
def test_head_groups_and_splits_at_the_new_configs(B, Hq, Hkv, S, want_gb, want):
    gb = dec.heads_per_block(Hq // Hkv)
    assert gb == want_gb
    assert dec.splits(B, Hq // gb, S, 132) == want      # rows: (slot, kv head, head group)
    _check_plan(B, Hq // gb, S, 132)


def test_packed_args_match_the_source():
    """``_PACK`` is csrc/decode_attention.cu's DecodeArgs: size and format."""
    import re
    import struct
    from pathlib import Path
    text = (Path(dec.__file__).parent / "csrc" / "decode_attention.cu").read_text()
    size = int(re.search(r"sizeof\(DecodeArgs\) == (\d+)", text).group(1))
    assert struct.calcsize(dec._PACK.format) == dec._PACK.size == size
    assert re.search(r'struct format "([^"]+)"', text).group(1) == dec._PACK.format


def test_wrapper_refuses_a_device_it_does_not_take():
    """Meta tensors take the plain version (nothing runs); a device that
    is neither the CPU, meta nor CUDA raises."""
    from _torch_elsewhere import elsewhere
    q = torch.zeros(1, 4, 1, 16, device="meta")
    kv = torch.zeros(1, 2, 8, 16, device="meta")
    out = dec.decode_attention(q, kv, kv, kv_len=8)
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention(elsewhere(1, 4, 1, 16), elsewhere(1, 2, 8, 16),
                             elsewhere(1, 2, 8, 16), kv_len=8)
