"""Port MLA (``repro_torch.models.mla``) against the JAX package's
``models/mla.py``, branch by branch, with the reference's weights and
the same inputs and caches (numpy, from a seed): the cache-free forward;
the contiguous whole-prompt prefill, decode and chunk; the paged decode,
prefill chunk and speculative verify window, each with and without a
``pos_offset`` (a verify window past the table scatters to the trash
page); int8 and fp8 latent pools, whose written codes are bit-equal to
the reference's and whose scales are bit-equal to the reference's
``quantize_kv`` of the latents the port writes (and within 4 ulp of the
reference's own, whose latents carry XLA's matmul rounding); and the
absorbed decode. The deepseek-v2-
lite smoke config (D = qk_nope + qk_rope = 24), float32: outputs and
written caches within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models.common import init_params as ref_init  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.common import flatten  # noqa: E402
from repro_torch.models.interop import _tensor, params_from_numpy  # noqa: E402

ATOL = 1e-5
ARCH = "deepseek-v2-lite-16b"
P, PAGE, NPG = 14, 8, 4           # pool pages (0 is the trash page), page, table width
QDT = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture(scope="module")
def mods():
    kw = dict(compute_dtype="float32")
    jcfg, cfg = ref_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)
    jp = ref_init(jmla.mla_def(jcfg), jax.random.PRNGKey(1), jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _run(mods, x, positions, cache=None, **kw):
    """The reference's (y, new cache) and the port's (y, its cache written
    in place) on the same inputs."""
    jcfg, cfg, jp, pp = mods
    jx, tx = _both(x)
    jpos, tpos = _both(positions)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if cache is None:
        return (jmla.mla_attention(jx, jp, jcfg, positions=jpos, **jkw), None,
                mla.mla_attention(tx, pp, cfg, positions=tpos, **tkw), None)
    jc = tuple(jnp.asarray(c) for c in cache)
    tc = tuple(_tensor(c) for c in cache)
    jy, jnew = jmla.mla_attention(jx, jp, jcfg, positions=jpos, cache=jc, **jkw)
    ty = mla.mla_attention(tx, pp, cfg, positions=tpos, cache=tc, **tkw)
    return jy, jnew, ty, tc


def _caches_close(jnew, tc):
    """Float caches within ATOL; int8 / fp8 codes bit-equal; the scale
    sidecars within 4 ulp (a latent's amax carries the matmul's rounding,
    which differs by an ulp between XLA and PyTorch; the scales of the
    same latents are bit-equal, :func:`_scales_of_own_latents`)."""
    for j, t in zip(jnew, tc):
        if t.dtype in (torch.int8, torch.float8_e4m3fn):
            np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                          np.asarray(j).view(np.uint8))
        elif len(jnew) == 4 and t.dim() == 2:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=5e-7, atol=0)
        else:
            close(t, j)


def _scales_of_own_latents(mods, kv, x, positions, kw, tc, seed):
    """The port's quantized pool against the reference's ``quantize_kv`` of
    the latents the port writes (read back from a float32 twin pool):
    codes and scales bit-equal at every written position, the rest
    untouched."""
    twin = _pools(mods[1], "fp32", seed)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(np.asarray(positions))
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    written = tuple(_tensor(c) for c in twin)
    mla.mla_attention(tx, mods[3], mods[1], positions=tpos, cache=written, **tkw)
    init = _pools(mods[1], kv, seed)
    for f0, f1, q, s, q0, s0 in ((twin[0], written[0], tc[0], tc[2], init[0], init[2]),
                                 (twin[1], written[1], tc[1], tc[3], init[1], init[3])):
        hit = (f1.numpy() != f0).any(-1)                       # (P, PAGE) written rows
        assert hit.any()
        jq, js = jops.quantize_kv(jnp.asarray(f1.numpy()), QDT[kv][0])
        want_q = np.where(hit[..., None], np.asarray(jq).view(np.uint8), q0.view(np.uint8))
        want_s = np.where(hit, np.asarray(js), s0)
        np.testing.assert_array_equal(q.view(torch.uint8).numpy(), want_q)
        np.testing.assert_array_equal(s.numpy(), want_s)


def test_param_defs_match_reference(mods):
    jcfg, cfg, jp, _ = mods
    ref = {p: tuple(a.shape) for p, a in flatten(jax.tree.map(np.asarray, jp))}
    assert {p: d.shape for p, d in flatten(mla.mla_def(cfg))} == ref


def test_forward_matches_reference(mods):
    cfg = mods[1]
    x = _rand((2, 11, cfg.d_model), 0)
    jy, _, ty, _ = _run(mods, x, np.arange(11))
    close(ty, jy)


def _contig_cache(cfg, B, S, seed):
    return (_rand((B, S, cfg.kv_lora_rank), seed), _rand((B, S, cfg.qk_rope_head_dim), seed + 1))


def test_contiguous_prefill_matches_reference(mods):
    cfg = mods[1]
    x = _rand((2, 9, cfg.d_model), 2)
    jy, jnew, ty, tc = _run(mods, x, np.arange(9), _contig_cache(cfg, 2, 32, 3),
                            cache_index=0)
    close(ty, jy)
    _caches_close(jnew, tc)


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_contiguous_decode_matches_reference(mods, absorbed, per_slot):
    cfg = mods[1]
    x = _rand((2, 1, cfg.d_model), 4)
    pos = np.array([9, 17], np.int32) if per_slot else 12
    positions = pos[:, None] if per_slot else np.array([pos])
    jy, jnew, ty, tc = _run(mods, x, positions, _contig_cache(cfg, 2, 32, 5),
                            cache_index=pos, absorbed=absorbed)
    close(ty, jy)
    _caches_close(jnew, tc)


def test_contiguous_chunk_matches_reference(mods):
    cfg = mods[1]
    x = _rand((2, 5, cfg.d_model), 6)
    jy, jnew, ty, tc = _run(mods, x, 8 + np.arange(5), _contig_cache(cfg, 2, 32, 7),
                            cache_index=8, chunked=True)
    close(ty, jy)
    _caches_close(jnew, tc)


def _pools(cfg, kv, seed):
    """Latent pools (P, PAGE, r) / (P, PAGE, dr) of random contents: floats,
    or int8 / fp8 codes with their (P, PAGE) scales (the reference's
    quantize_kv of random floats)."""
    cc, cr = _rand((P, PAGE, cfg.kv_lora_rank), seed), _rand((P, PAGE, cfg.qk_rope_head_dim),
                                                             seed + 1)
    if kv == "fp32":
        return (cc, cr)
    jdt = QDT[kv][0]
    (qc, sc), (qr, sr) = (jops.quantize_kv(jnp.asarray(a), jdt) for a in (cc, cr))
    return tuple(np.asarray(a) for a in (qc, qr, sc, sr))


TABLES = np.array([[3, 7, 1, 12], [5, 2, 9, 0], [4, 6, 8, 10]], np.int32)


@pytest.mark.parametrize("kv", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("rolled", [False, True])
@pytest.mark.parametrize("absorbed", [False, True])
def test_paged_decode_matches_reference(mods, kv, rolled, absorbed):
    cfg = mods[1]
    pos = np.array([5, 17, 30], np.int32)
    poff = np.array([0, 8, 16], np.int32) if rolled else None
    spos = pos - (poff if rolled else 0)
    x = _rand((3, 1, cfg.d_model), 8)
    kw = dict(cache_index=pos, block_tables=TABLES, absorbed=absorbed)
    if rolled:
        kw["pos_offset"] = poff
    jy, jnew, ty, tc = _run(mods, x, spos[:, None], _pools(cfg, kv, 9), **kw)
    close(ty, jy)
    _caches_close(jnew, tc)
    if kv != "fp32":
        _scales_of_own_latents(mods, kv, x, spos[:, None], kw, tc, 9)


@pytest.mark.parametrize("kv", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("rolled", [False, True])
def test_paged_chunk_matches_reference(mods, kv, rolled):
    cfg = mods[1]
    start, poff = (20, 8) if rolled else (12, None)
    si = start - (poff or 0)
    x = _rand((1, 4, cfg.d_model), 10)
    kw = dict(cache_index=start, block_tables=TABLES[:1], chunked=True)
    if rolled:
        kw["pos_offset"] = poff
    jy, jnew, ty, tc = _run(mods, x, si + np.arange(4), _pools(cfg, kv, 11), **kw)
    close(ty, jy)
    _caches_close(jnew, tc)
    if kv != "fp32":
        _scales_of_own_latents(mods, kv, x, si + np.arange(4), kw, tc, 11)


@pytest.mark.parametrize("kv", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("rolled", [False, True])
def test_paged_verify_window_matches_reference(mods, kv, rolled):
    """A (3, W = 4) window at per-slot positions; the last slot's window
    runs past its table's 32 positions, whose stray writes go to page 0."""
    cfg = mods[1]
    pos = np.array([5, 20, 37], np.int32)
    poff = np.array([0, 8, 8], np.int32) if rolled else np.zeros(3, np.int32)
    if not rolled:
        pos = pos - np.array([0, 8, 8], np.int32)
    spos = pos - poff
    x = _rand((3, 4, cfg.d_model), 12)
    kw = dict(cache_index=pos, block_tables=TABLES, chunked=True)
    if rolled:
        kw["pos_offset"] = poff
    positions = spos[:, None] + np.arange(4)[None, :]
    assert (spos + 4 > NPG * PAGE).any()
    jy, jnew, ty, tc = _run(mods, x, positions, _pools(cfg, kv, 13), **kw)
    close(ty, jy)
    # the trash page takes the strays in either package's order: compare
    # the pages a table maps
    live = sorted(set(TABLES.ravel().tolist()) - {0})
    _caches_close(tuple(np.asarray(j)[live] for j in jnew), tuple(t[live] for t in tc))
    if kv != "fp32":
        _scales_of_own_latents(mods, kv, x, positions, kw, tc, 13)
