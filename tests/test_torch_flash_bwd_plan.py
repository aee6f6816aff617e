"""The bf16 flash-attention backward kernel's schedule and rounding
(``csrc/flash_attention_bwd.cu``, ``bwd_wgmma_kernel``), as a plain
float32 model, against ``jax.vjp`` of the JAX package's
``repro.kernels.ref.mha`` and against ``flash_attention.plain_bwd``.
Inputs from a numpy seed, rounded to bf16 as the kernel sees them.

The model follows the kernel: a unit is a (batch, kv head, 64-key tile),
taken in ticket order (key tile major); it walks the 64-query tiles that
see its keys (the tiles holding rows that see no key first, then the
others from the last down to the diagonal) for each query head of the kv
head, forms S and dP once, and produces dV over P in two bf16 pieces (hi
and lo), dK over dS in two pieces, and dQ's share over dS rounded once to
bf16. At D = 256, and at D = 192 padded to 256, a block is two
warpgroups, each forming S and dP over all of D and producing 128 of the
columns of dV, dK and dQ's share.
dQ's shares of a (query head, query tile) are admitted in ascending key
tile order, whatever order the units arrive in: the first stores, the
others add, the last scales. The share's workspace layout (a thread's
float4s at i NT + tid) is modelled lane by lane.

Tolerance: the bf16 one of ``chip_smoke.py`` and the card tests, atol
1e-2 + rtol 1.6e-2, between the model's gradients rounded to bf16 and the
float32 references rounded to bf16 (one bf16 rounding of P or dS is
2^-9 relative; the hi/lo pieces keep about 2^-17).
"""

import math
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

ATOL, RTOL = 1e-2, 1.6e-2
TILE = 64                      # the kernel's query and key tile (wgmma.cuh BR, BN)

# (B, Hq, Hkv, Sq, Skv, D, causal, cap)
CASES = [
    (1, 4, 2, 130, 130, 16, True, 0.0),      # causal, three ragged tiles, G 2
    (2, 4, 4, 150, 70, 16, True, 0.0),       # Skv < Sq: 80 rows see no key, G 1
    (1, 4, 1, 70, 200, 16, True, 0.0),       # Skv > Sq: the offset diagonal, G 4
    (1, 4, 2, 100, 140, 16, False, 0.0),     # non-causal
    (1, 4, 2, 130, 130, 16, True, 30.0),     # soft cap 30
    (1, 2, 2, 90, 90, 16, True, 2.0),        # a cap that bites
    (1, 2, 1, 90, 150, 112, True, 0.0),      # D 112, G 2
    (1, 4, 1, 80, 50, 112, True, 5.0),       # D 112, no-key rows under a cap, G 4
    (1, 2, 2, 130, 130, 256, True, 0.0),     # gemma-7b's D 256: two warpgroups, G 1
    (1, 4, 2, 100, 70, 256, True, 30.0),     # D 256, no-key rows, cap, G 2
    (1, 4, 1, 130, 130, 8, True, 0.0),       # deepseek-67b's smoke D 8, G 4
    (1, 2, 1, 90, 150, 8, False, 0.0),       # D 8, non-causal
    (1, 2, 2, 63, 63, 24, True, 0.0),        # the MLA smoke's D 24, one ragged tile
    (1, 2, 2, 75, 150, 64, False, 0.0),      # whisper's D 64, cross: Sq != Skv
    (1, 2, 2, 70, 70, 192, True, 0.0),       # MLA's D 192: two warpgroups over 256
]


def warpgroup_columns(D):
    """The column ranges of dV, dK and dQ that a block's warpgroups own:
    one warpgroup over the padded width up to 128, two of 128 at 192
    (padded to 256) and 256."""
    DP = fa.bwd_width(D)
    W = DP // 2 if DP > 128 else DP
    return [(c0, min(c0 + W, D)) for c0 in range(0, DP, W) if c0 < D]


def _bf(t):
    return t.to(torch.bfloat16).float()


def _hilo(t):
    hi = _bf(t)
    return hi + _bf(t - hi)


def walk(n, Sq, Skv, causal):
    """The query tiles key tile ``n`` walks, in the kernel's order: those
    holding rows that see no key, then the others from the last down to
    the diagonal."""
    nq, off = -(-Sq // TILE), Skv - Sq
    n_none = -(-min(-off, Sq) // TILE) if causal and off < 0 else 0

    def t_first(kt):
        kk = kt * TILE
        return 0 if not causal or kk - off <= 0 else min(nq, (kk - off) // TILE)

    return list(range(n_none)) + list(range(nq - 1, max(t_first(n), n_none) - 1, -1))


def plan_bwd(q, k, v, o, lse, do, *, causal, cap, order=None):
    """(dq, dk, dv) in float32 as the kernel computes them; ``order`` is
    the order the units arrive in (default: ticket order)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G, scale, off = Hq // Hkv, 1.0 / math.sqrt(D), Skv - Sq
    nkv = -(-Skv // TILE)
    delta = (do * o).sum(-1)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    units = [(n, bkv) for n in range(nkv) for bkv in range(B * Hkv)]
    arrivals = []
    for n, bkv in (units if order is None else [units[i] for i in order]):
        b, h = divmod(bkv, Hkv)
        k0 = n * TILE
        K, V = k[b, h, k0:k0 + TILE], v[b, h, k0:k0 + TILE]
        kpos = torch.arange(k0, k0 + K.shape[0])
        for mt in walk(n, Sq, Skv, causal):
            for g in range(G):
                hq = h * G + g
                q0 = mt * TILE
                Qt, dO = q[b, hq, q0:q0 + TILE], do[b, hq, q0:q0 + TILE]
                qpos = torch.arange(q0, q0 + Qt.shape[0]) + off
                none = (qpos < 0) if causal else torch.zeros_like(qpos, dtype=torch.bool)
                vis = torch.ones((Qt.shape[0], K.shape[0]), dtype=torch.bool)
                if causal:
                    vis = (kpos[None, :] <= qpos[:, None]) | none[:, None]
                x = scale * Qt @ K.T
                capf = torch.ones_like(x)
                if cap > 0:
                    th = torch.tanh(x / cap)
                    x, capf = cap * th, 1 - th * th
                x = torch.where(none[:, None], 0.0, x)
                p = torch.where(vis, torch.exp(x - lse[b, hq, q0:q0 + TILE, None]), 0.0)
                dp = dO @ V.T
                ds = torch.where(vis & ~none[:, None],
                                 p * (dp - delta[b, hq, q0:q0 + TILE, None]) * capf, 0.0)
                share = torch.zeros(Qt.shape[0], D)
                for c0, c1 in warpgroup_columns(D):   # S and dP over all of D, each
                    dv[b, h, k0:k0 + TILE, c0:c1] += _hilo(p).T @ dO[:, c0:c1]
                    dk[b, h, k0:k0 + TILE, c0:c1] += _hilo(ds).T @ Qt[:, c0:c1]
                    share[:, c0:c1] = _bf(ds) @ K[:, c0:c1]
                arrivals.append(((b, hq, mt), n, share))
    dq = torch.zeros_like(q)
    for (b, hq, mt), acc in admit(arrivals).items():
        dq[b, hq, mt * TILE:mt * TILE + acc.shape[0]] = scale * acc
    return dq, dk * scale, dv


def admit(arrivals):
    """The turn counters: each (query head, query tile)'s shares summed in
    ascending key tile order, whatever order they arrive in."""
    turn, pending, acc = defaultdict(int), {}, {}
    for key, n, share in arrivals:
        pending[key, n] = share
        while (key, turn[key]) in pending:
            s = pending.pop((key, turn[key]))
            acc[key] = s if turn[key] == 0 else acc[key] + s
            turn[key] += 1
    assert not pending
    return acc


def _inputs(case):
    B, Hq, Hkv, Sq, Skv, D, _, _ = case
    r = np.random.default_rng(Sq * 1000 + Skv + D)
    return [_bf(torch.from_numpy(r.standard_normal(s).astype(np.float32))) for s in (
        (B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D), (B, Hq, Sq, D))]


def _close(name, got, want):
    got, want = _bf(got), _bf(torch.from_numpy(np.array(want, dtype=np.float32)))
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    assert not bool(bad.any()), f"{name}: max err {err.max().item():.3e}"


@pytest.mark.parametrize("case", CASES)
def test_plan_matches_jax_vjp_and_plain_bwd(case):
    causal, cap = case[6], case[7]
    q, k, v, do = _inputs(case)
    o, lse = fa.plain_fwd(q, k, v, causal=causal, logit_soft_cap=cap)
    got = plan_bwd(q, k, v, o, lse, do, causal=causal, cap=cap)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha(a, b, c, causal=causal, logit_soft_cap=cap),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(do.numpy()))
    mine = fa.plain_bwd(q, k, v, o, lse, do, causal=causal, logit_soft_cap=cap)
    for name, g, jw, w in zip("qkv", got, jgrads, mine):
        _close(f"d{name} vs jax.vjp", g, jw)
        _close(f"d{name} vs plain_bwd", g, w)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[6]])
def test_dq_sum_order_gives_the_same_bits_whatever_order_units_arrive(case):
    """Units that arrive in another order (blocks run in no fixed order)
    give the same bits: shares are admitted by key tile, not by arrival."""
    causal, cap = case[6], case[7]
    q, k, v, do = _inputs(case)
    o, lse = fa.plain_fwd(q, k, v, causal=causal, logit_soft_cap=cap)
    first = plan_bwd(q, k, v, o, lse, do, causal=causal, cap=cap)
    n_units = case[0] * case[2] * -(-case[4] // TILE)
    shuffled = np.random.default_rng(1).permutation(n_units)
    again = plan_bwd(q, k, v, o, lse, do, causal=causal, cap=cap, order=shuffled)
    assert torch.equal(first[0], again[0])
    # the admission is what fixes the order: summing in arrival order would not
    arrivals = [(("t",), n, torch.tensor([x], dtype=torch.float32))
                for n, x in enumerate((1e8, 1.0, -1e8, 1.0))]
    assert admit(arrivals)["t",].item() == admit(arrivals[::-1])["t",].item() == 1.0


@pytest.mark.parametrize("Sq,Skv,causal", [(130, 130, True), (150, 70, True),
                                           (70, 200, True), (100, 140, False)])
def test_key_tiles_that_walk_a_query_tile_are_a_prefix(Sq, Skv, causal):
    """The turn scheme needs the key tiles that walk query tile mt to be
    0 .. n_last: the kernel's turn for key tile n is n. Every visible
    (query, key) pair is walked exactly once."""
    nq, nkv = -(-Sq // TILE), -(-Skv // TILE)
    walkers = {mt: [n for n in range(nkv) if mt in walk(n, Sq, Skv, causal)]
               for mt in range(nq)}
    for mt, ns in walkers.items():
        assert ns == list(range(len(ns))) and ns, (mt, ns)
    off = Skv - Sq
    for i in range(Sq):
        for j in range(Skv):
            sees = not causal or j <= i + off or i + off < 0
            if sees:
                assert i // TILE in walk(j // TILE, Sq, Skv, causal)


def test_packed_args_match_the_source():
    """``flash_attention._BWD_PACK`` is ``csrc/flash_attention_bwd.cu``'s
    BwdArgs: the same size and the struct format its comment states."""
    import re
    import struct
    from pathlib import Path
    text = (Path(fa.__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu").read_text()
    size = int(re.search(r"sizeof\(BwdArgs\) == (\d+)", text).group(1))
    assert struct.calcsize(fa._BWD_PACK.format) == fa._BWD_PACK.size == size
    assert re.search(r'struct format "([^"]+)"', text).group(1) == fa._BWD_PACK.format


def _c_int(expr: str, D: int) -> int:
    """Evaluate one of the source's constexpr int expressions of D: at
    most one ``a ? b : c``, integer division."""
    import re
    m = re.fullmatch(r"(.+?)\?(.+?):(.+)", expr)
    if m:
        expr = f"({m.group(2)}) if ({m.group(1)}) else ({m.group(3)})"
    return eval(expr.replace("/", "//"), {}, {"D": D})


@pytest.mark.parametrize("D", fa.BWD_HEAD_DIMS)
def test_bwd_width_matches_the_source(D):
    """``bwd_width`` sizes dq_acc; the kernel writes 64 x ``Bf16<D>::DP``
    floats a (query head, query tile) there, so the two must agree at
    every width the backward takes."""
    import re
    from pathlib import Path
    csrc = Path(fa.__file__).resolve().parent / "csrc"
    tile = re.search(r"struct Tile \{\s*static constexpr int DP = ([^;]+);",
                     (csrc / "wgmma.cuh").read_text()).group(1)
    dp = re.search(r"struct Bf16 \{.*?static constexpr int DP = ([^,;]+)[,;]",
                   (csrc / "flash_attention_bwd.cu").read_text(), re.S).group(1)
    assert _c_int(dp.replace("wg::Tile<D>::DP", f"({tile})"), D) == fa.bwd_width(D)


@pytest.mark.parametrize("D", fa.BWD_HEAD_DIMS)
def test_dq_share_workspace_layout_covers_the_tile_once(D):
    """dQ's share of a (query head, query tile) leaves the block as 64 x DP
    floats: thread tid (of NT = 128 or 256) stores its m64nW fragment's
    floats 4 i .. 4 i + 3 as float4 i NT + tid, and the last key tile
    reads the sum back at the same places. Every (row, column) of the
    padded tile is one float of it, and the warpgroups' columns tile D."""
    DP = fa.bwd_width(D)
    NWG = 2 if DP > 128 else 1
    NT, W = 128 * NWG, DP // NWG
    seen = {}
    for tid in range(NT):
        warp, lane = (tid >> 5) & 3, tid & 31
        col0 = (tid >> 7) * W
        for f in range(W // 2):                     # the fragment's floats
            n, h, e = f // 4, (f % 4) // 2, f % 2
            row = 16 * warp + lane // 4 + 8 * h
            col = col0 + 8 * n + 2 * (lane % 4) + e
            at = 4 * ((f // 4) * NT + tid) + f % 4
            assert at not in seen
            seen[at] = (row, col)
    assert sorted(seen) == list(range(64 * DP))
    assert sorted(seen.values()) == [(r, c) for r in range(64) for c in range(DP)]
    assert [c for r in warpgroup_columns(D) for c in range(*r)] == list(range(D))
