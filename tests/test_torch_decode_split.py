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

GRID_Y = 65535               # the kernel's grid is (n_split, B * Hkv)


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


def test_wrapper_refuses_a_device_it_does_not_take():
    q = torch.zeros(1, 4, 1, 16, device="meta")
    kv = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention(q, kv, kv, kv_len=8)
