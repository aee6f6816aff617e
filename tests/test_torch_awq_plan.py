"""The parts of the port's W4A16 and RMSNorm kernels that are plain Python
or plain arithmetic, held on the CPU: ``awq_matmul``'s launch plan
(``splits``), its K order on the tensor cores (``k_order``, and a
lane-by-lane model of how the bf16 body feeds ``mma.sync``), the
swizzled layout of a pipeline stage, its
per-group formulation (``plain_grouped``) against the JAX package, and
the packed argument blocks of both wrappers against their CUDA sources.

Tolerance: ``plain_grouped`` against the JAX reference and the Pallas
kernel (interpret mode) within atol 1e-5 + rtol 1e-5 in float32: the
sums run in another order (per group, then over groups), with outputs
O(10) at K = 256. The lane model works on small integers, so its
products and sums are exact and it is held bit for bit.
"""

import re
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")
jnp = jax.numpy
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.awq_matmul import awq_matmul as pallas_awq  # noqa: E402
from repro_torch.kernels import awq_matmul as awq  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.serving import quantize as quant  # noqa: E402

CSRC = Path(awq.__file__).resolve().parent / "csrc"
GRID = 65535                 # the kernel's grid limit along y (column tiles) and z (row tiles)


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), atol=atol, rtol=rtol)


# ------------------------------------------------------------------ formulation
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("M", [1, 8, 17])
def test_plain_grouped_matches_reference_and_pallas(M, group):
    rng = np.random.default_rng(11)
    K, N = 256, 256                   # the Pallas kernel tiles N by 128
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = quant.quantize_weight(torch.from_numpy(
        (0.05 * rng.normal(size=(K, N))).astype(np.float32)), group_size=group)
    qw, s, z = (w[k].numpy() for k in ("qw", "scales", "zeros"))
    got = awq.plain_grouped(torch.from_numpy(x), w["qw"], w["scales"], w["zeros"],
                            group_size=group)
    assert got.shape == (M, N) and got.dtype == torch.float32
    args = [jnp.asarray(a) for a in (x, qw, s, z)]
    close(got, jref.awq_matmul(*args, group_size=group))
    close(got, pallas_awq(*args, group_size=group, block_k=group, interpret=True))
    close(got, awq.plain(torch.from_numpy(x), w["qw"], w["scales"], w["zeros"],
                         group_size=group))


def test_plain_grouped_keeps_bfloat16():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32)).to(torch.bfloat16)
    qw = ref.awq_pack(torch.from_numpy(rng.integers(0, 16, size=(128, 64))))
    s = torch.from_numpy((0.01 * rng.random(size=(2, 64))).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, 16, size=(2, 64)).astype(np.float32))
    got = awq.plain_grouped(x, qw, s, z, group_size=64)
    want = awq.plain(x, qw, s, z, group_size=64)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1.6e-2)


# ------------------------------------------------------------------ plan
def _check_plan(M, K, N, group, n_sm):
    p = awq.splits(M, K, N, group, n_sm)
    groups = K // group
    assert p.mt == (8 if M <= 8 else 16) and p.bn in awq.COL_TILES
    assert 1 <= p.n_split <= awq.MAX_SPLITS and p.groups_per_split >= 1
    ranges = [(r * p.groups_per_split, min(groups, (r + 1) * p.groups_per_split))
              for r in range(p.n_split)]
    assert all(lo < hi for lo, hi in ranges)                    # each range >= 1 group
    covered = [0] * groups
    for lo, hi in ranges:
        for gi in range(lo, hi):
            covered[gi] += 1
    assert covered == [1] * groups                              # every group once
    tiles = -(-N // p.bn) * -(-M // p.mt)
    assert -(-N // p.bn) <= GRID and -(-M // p.mt) <= GRID
    aim = awq.BLOCKS_PER_SM * n_sm
    assert p.n_split == 1 or tiles * p.n_split <= aim           # no more blocks than the aim
    # the finest split into ranges of one size within the cap and the aim
    cap = min(awq.MAX_SPLITS, groups, max(1, aim // tiles))
    assert p.n_split == -(-groups // p.groups_per_split) <= cap
    assert p.groups_per_split == 1 or -(-groups // (p.groups_per_split - 1)) > cap
    return p, tiles * p.n_split


@settings(max_examples=400, deadline=None)
@given(M=st.integers(1, 300), groups=st.integers(1, 300), N=st.integers(1, 20000),
       group=st.sampled_from([64, 128, 192, 256, 512]), n_sm=st.integers(1, 132))
@example(M=8, groups=64, N=16384, group=64, n_sm=132)
@example(M=1, groups=1, N=1, group=512, n_sm=1)
@example(M=250, groups=256, N=4096, group=64, n_sm=132)
def test_split_ranges_cover_every_group_once(M, groups, N, group, n_sm):
    _check_plan(M, groups * group, N, group, n_sm)


@pytest.mark.parametrize("M,K,N,want", [
    (8, 4096, 16384, awq.Plan(128, 8, 4, 16)),    # w1 / w3 at B = 8
    (8, 16384, 4096, awq.Plan(64, 8, 8, 32)),     # w2: narrower tiles, not a second launch
    (8, 4096, 4096, awq.Plan(64, 8, 8, 8)),       # wo
    (16, 4096, 16384, awq.Plan(128, 16, 4, 16)),  # a 16-token prefill piece
    (1, 4096, 16384, awq.Plan(128, 8, 4, 16)),    # generate() at B = 1
])
def test_split_plan_at_the_paths_shapes(M, K, N, want):
    """At the main paths' shapes on 132 SMs the grid holds 512 blocks:
    about BLOCKS_PER_SM a SM, in one cluster per column tile."""
    p, blocks = _check_plan(M, K, N, 64, 132)
    assert p == want and blocks == 512


def test_plan_refuses_a_group_the_kernel_does_not_take():
    for K, group in ((4096, 32), (4096, 96), (2048, 1024), (192, 128), (0, 64)):
        with pytest.raises(ValueError, match="group_size"):
            awq.splits(8, K, 256, group, 132)


def test_wrapper_refuses_a_device_it_does_not_take():
    """Meta tensors take the plain version (nothing runs); a device that
    is neither the CPU, meta nor CUDA raises."""
    from _torch_elsewhere import elsewhere
    x = torch.zeros(2, 64, device="meta")
    qw = torch.zeros(8, 16, dtype=torch.int32, device="meta")
    s = torch.zeros(1, 16, device="meta")
    assert awq.awq_matmul(x, qw, s, s, group_size=64).shape == (2, 16)
    assert rms.rmsnorm(x, torch.zeros(64, device="meta")).device.type == "meta"
    with pytest.raises(ValueError, match="CUDA"):
        awq.awq_matmul(elsewhere(2, 64), elsewhere(8, 16, dtype=torch.int32),
                       elsewhere(1, 16), elsewhere(1, 16), group_size=64)
    with pytest.raises(ValueError, match="CUDA"):
        rms.rmsnorm(elsewhere(2, 64), elsewhere(64))
    assert awq.launches == rms.launches == 0


# ------------------------------------------------------------------ K order
@pytest.mark.parametrize("group", [64, 128, 512])
def test_k_order_is_a_permutation_within_each_group(group):
    order = awq.k_order(group)
    assert sorted(order) == list(range(group))
    for slab in range(0, group, awq.SLAB):                  # and within each 64-row slab
        assert sorted(order[slab:slab + awq.SLAB]) == list(range(slab, slab + awq.SLAB))


@pytest.mark.parametrize("group", [64, 128])
def test_k_order_on_both_operands_leaves_the_product(group):
    rng = np.random.default_rng(13)
    M, K, N = 5, 4 * group, 48
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 16, size=(K, N)))
    s = torch.from_numpy((0.01 * rng.random(size=(K // group, N))).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, 16, size=(K // group, N)).astype(np.float32))
    perm = torch.tensor([g0 + k for g0 in range(0, K, group) for k in awq.k_order(group)])
    want = awq.plain(x, ref.awq_pack(q), s, z, group_size=group)
    got = awq.plain(x[:, perm], ref.awq_pack(q[perm]), s, z, group_size=group)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(awq.plain_grouped(x[:, perm], ref.awq_pack(q[perm]), s, z,
                                                 group_size=group), want,
                               atol=1e-5, rtol=1e-5)


def _perm(a, b, sel):
    """__byte_perm on words held as (low half, high half)."""
    return {0x5410: (a[0], b[0]), 0x7632: (a[1], b[1])}[sel]


def _code_pair(word):
    """lop3 + fma: nibbles at bits 0-3 and 16-19, as exact codes."""
    return (word & 15, (word >> 16) & 15)


def _mma(d, a, b0, b1):
    """mma.sync.m16n8k16 row.col, on the PTX fragment layouts: lane (g, t)
    holds A rows g, g + 8, columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9
    (a2, a3); B rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g;
    C rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1."""
    A = np.zeros((16, 16), dtype=np.int64)
    B = np.zeros((16, 8), dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, (r, c) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                      (g + 8, 2 * t + 8))):
            A[r, c], A[r, c + 1] = a[lane][reg]
        B[2 * t, g], B[2 * t + 1, g] = b0[lane]
        B[2 * t + 8, g], B[2 * t + 9, g] = b1[lane]
    C = A @ B
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for e, (r, c) in enumerate(((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                                    (g + 8, 2 * t + 1))):
            d[lane][e] += C[r, c]


def test_bf16_body_lane_model_computes_the_product():
    """One warp's 32 columns over one 64-row slab, as csrc/awq_matmul.cu's
    bf16 body stages and feeds them: the codes chunk of lane l is packed row
    4 b + l % 4, columns 4 (l / 4) .. + 3; its x chunk row 8 h + l / 4, K rows
    32 b + 8 (l % 4) .. + 7; A by byte permutes, B by nibble pairs, and the
    fragment (i, e) lands at row g + 8 (e / 2), column 8 t + 4 (e % 2) + i.
    The product must be x @ q, and A's slots must follow k_order."""
    rng = np.random.default_rng(14)
    x = rng.integers(-8, 9, size=(16, 64))
    x[0] = rng.permutation(64) - 32         # distinct: row 0 names the K row of each slot
    q = rng.integers(0, 16, size=(64, 32))
    qw = ref.awq_pack(torch.from_numpy(q)).numpy().astype(np.int64) & 0xFFFFFFFF

    def xwords(h, b, lane):                 # 16 bytes of x: 4 words of (low, high)
        g, t = lane >> 2, lane & 3
        row = x[8 * h + g, 32 * b + 8 * t:32 * b + 8 * t + 8]
        return [(row[2 * i], row[2 * i + 1]) for i in range(4)]

    acc = [[[0] * 4 for _ in range(4)] for _ in range(32)]
    slots = []
    for b in (0, 1):
        a = [[None] * 4 for _ in range(2)]
        a_lanes = []
        for lane in range(32):
            xa, xb = xwords(0, b, lane), xwords(1, b, lane)
            a_lanes.append([
                [_perm(xa[0], xa[2], 0x5410), _perm(xb[0], xb[2], 0x5410),
                 _perm(xa[0], xa[2], 0x7632), _perm(xb[0], xb[2], 0x7632)],
                [_perm(xa[1], xa[3], 0x5410), _perm(xb[1], xb[3], 0x5410),
                 _perm(xa[1], xa[3], 0x7632), _perm(xb[1], xb[3], 0x7632)]])
        for i in range(4):                  # n8 tile i: word i of each lane's chunk
            words = [int(qw[4 * b + (lane & 3), 4 * (lane >> 2) + i]) for lane in range(32)]
            d = [acc[lane][i] for lane in range(32)]
            _mma(d, [a_lanes[lane][0] for lane in range(32)],
                 [_code_pair(w) for w in words], [_code_pair(w >> 4) for w in words])
            _mma(d, [a_lanes[lane][1] for lane in range(32)],
                 [_code_pair(w >> 8) for w in words], [_code_pair(w >> 12) for w in words])
        # the K row of each A slot, from lane (0, t)'s row-0 registers
        for s in (0, 1):
            kof = {}
            for t in range(4):
                lane = t
                xa = x[0, 32 * b + 8 * t:32 * b + 8 * t + 8]
                for reg, slot in ((0, 2 * t), (2, 2 * t + 8)):
                    pair = a_lanes[lane][s][reg]
                    for half in (0, 1):
                        kof[slot + half] = 32 * b + 8 * t + list(xa).index(pair[half])
            slots += [kof[j] for j in range(16)]
    out = np.zeros((16, 32), dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            for e in range(4):
                out[g + 8 * (e >> 1), 8 * t + 4 * (e & 1) + i] = acc[lane][i][e]
    np.testing.assert_array_equal(out, x @ q)
    assert slots == awq.k_order(64)


def _code_chunk(bn, r, cc):
    """csrc/awq_matmul.cu's code_chunk: 16-byte chunk cc of packed row r."""
    return r * (bn // 4) + (cc ^ ((r & 3) << 1))


def _x_chunk(m, kc):
    """csrc/awq_matmul.cu's x_chunk: chunk kc (8 values) of x's row m."""
    return m * 8 + (kc ^ ((m & 1) << 2))


@pytest.mark.parametrize("bn,mt", [(128, 8), (128, 16), (64, 8), (64, 16)])
def test_stage_layout_is_a_bijection_without_bank_conflicts(bn, mt):
    """A stage's swizzled chunks: every chunk has one place, and the 8
    lanes of each phase of a 16-byte access (reads by the mma lanes,
    writes by the row-wise copies) fall in 8 distinct bank groups (the
    chunk index mod 8: each region starts on a 128-byte line)."""
    text = (CSRC / "awq_matmul.cu").read_text()
    assert "(cc ^ ((r & 3) << 1))" in text and "(kc ^ ((m & 1) << 2))" in text
    cpr = bn // 4                                               # chunks a packed row
    assert sorted(_code_chunk(bn, r, cc) for r in range(8)
                  for cc in range(cpr)) == list(range(8 * cpr))
    assert sorted(_x_chunk(m, kc) for m in range(mt) for kc in range(8)) == list(range(8 * mt))
    for phase in range(4):
        lanes = range(8 * phase, 8 * phase + 8)
        for b in (0, 1):
            for wn in range(bn // 32):                          # the mma lanes' reads
                assert len({_code_chunk(bn, 4 * b + (ln & 3), 8 * wn + (ln >> 2)) % 8
                            for ln in lanes}) == 8
            for h in range(mt // 8):
                assert len({_x_chunk(8 * h + (ln >> 2), 4 * b + (ln & 3)) % 8
                            for ln in lanes}) == 8
    for c0 in range(0, 8 * cpr, 8):                             # the copies' writes
        assert len({_code_chunk(bn, c // cpr, c % cpr) % 8 for c in range(c0, c0 + 8)}) == 8
    for c0 in range(0, 8 * mt, 8):
        assert len({_x_chunk(c // 8, c % 8) % 8 for c in range(c0, c0 + 8)}) == 8


# ------------------------------------------------------------------ packed args
@pytest.mark.parametrize("mod,src,name", [(awq, "awq_matmul.cu", "AwqArgs"),
                                          (rms, "rmsnorm.cu", "RmsArgs")])
def test_packed_args_match_the_source(mod, src, name):
    text = (CSRC / src).read_text()
    size = int(re.search(rf"sizeof\({name}\) == (\d+)", text).group(1))
    assert struct.calcsize(mod._PACK.format) == mod._PACK.size == size
    fmt = re.search(r'struct format "([^"]+)"', text).group(1)
    assert fmt == mod._PACK.format
