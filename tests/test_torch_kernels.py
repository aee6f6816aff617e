"""Port kernels: the plain PyTorch versions against the JAX package's
oracles (``repro.kernels.ref``) and its Pallas kernels in interpret
mode, on shared numpy inputs, and the device dispatch of ``ops``. The
hand kernels themselves run on the card only: tests/test_torch_cuda.py.

Tolerance: float32, max abs error <= 1e-5 (the two frameworks sum in
different orders; outputs are O(1)).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro_torch.kernels import decode_attention as dec_k  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa_k  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_k  # noqa: E402

ATOL = 1e-5


def both(a):
    """One numpy array -> (torch tensor, jax array)."""
    return torch.from_numpy(np.array(a)), jnp.asarray(a)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("gemma_style", [False, True])
def test_rmsnorm_plain_matches_reference_and_pallas(gemma_style):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = (0.1 * rng.normal(size=(64,))).astype(np.float32) + (0 if gemma_style else 1)
    (xt, xj), (wt, wj) = both(x), both(w)
    out = ref.rmsnorm(xt, wt, eps=1e-5, gemma_style=gemma_style)
    close(out, jref.rmsnorm(xj, wj, eps=1e-5, gemma_style=gemma_style))
    close(out, pallas_rmsnorm(xj, wj, eps=1e-5, gemma_style=gemma_style,
                              interpret=True))
    assert out.dtype == torch.float32 and out.shape == (3, 5, 64)


# ------------------------------------------------------------------ paged
def _paged_inputs(rng, *, B=3, Hq=8, Hkv=2, D=32, page=16, n_pages=6, P=32):
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    kp = rng.normal(size=(P, Hkv, page, D)).astype(np.float32)
    vp = rng.normal(size=(P, Hkv, page, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:B * n_pages].reshape(B, n_pages)
    return q, kp, vp, bt.astype(np.int32)


PAGED_CASES = {
    "ragged": dict(kv_len=[1, 37, 96]),
    "pos_offset": dict(kv_len=[36, 80, 96], pos_offset=[16, 32, 64]),
    "mqa_soft_cap": dict(kv_len=[40, 48, 9], Hq=4, Hkv=4, soft_cap=30.0),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_attention_plain_matches_reference_and_pallas(case):
    c = PAGED_CASES[case]
    rng = np.random.default_rng(1)
    q, kp, vp, bt = _paged_inputs(rng, Hq=c.get("Hq", 8), Hkv=c.get("Hkv", 2))
    kv_len = np.asarray(c["kv_len"], np.int32)
    poff = np.asarray(c["pos_offset"], np.int32) if "pos_offset" in c else None
    # garbage in the trash page, and the trash page in every row's tail
    kp[0], vp[0] = 1e6, -1e6
    live = (kv_len - (poff if poff is not None else 0) + 15) // 16
    for b, n in enumerate(live):
        bt[b, n:] = 0
    cap = c.get("soft_cap", 0.0)
    tq, jq = both(q)
    tk, jk = both(kp)
    tv, jv = both(vp)
    tb, jb = both(bt)
    out = ref.paged_attention(
        tq, tk, tv, block_tables=tb, kv_len=torch.from_numpy(kv_len),
        pos_offset=None if poff is None else torch.from_numpy(poff),
        logit_soft_cap=cap)
    kw = dict(block_tables=jb, kv_len=jnp.asarray(kv_len), logit_soft_cap=cap,
              pos_offset=None if poff is None else jnp.asarray(poff))
    close(out, jref.paged_attention(jq, jk, jv, **kw))
    close(out, pallas_paged(jq, jk, jv, interpret=True, **kw))
    # ops dispatches a CPU tensor to the plain version, bit for bit
    via_ops = ops.paged_attention(
        tq, tk, tv, block_tables=tb, kv_len=torch.from_numpy(kv_len),
        pos_offset=None if poff is None else torch.from_numpy(poff),
        logit_soft_cap=cap)
    assert torch.equal(via_ops, out)


def test_paged_attention_shared_pages_across_slots():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    kp = rng.normal(size=(12, 2, 16, 16)).astype(np.float32)
    vp = rng.normal(size=(12, 2, 16, 16)).astype(np.float32)
    bt = np.asarray([[5, 6, 7, 1], [5, 6, 7, 2]], np.int32)
    kv_len = np.asarray([64, 52], np.int32)
    out = ref.paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp)),
                              block_tables=torch.from_numpy(bt),
                              kv_len=torch.from_numpy(kv_len))
    close(out, pallas_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            block_tables=jnp.asarray(bt),
                            kv_len=jnp.asarray(kv_len), interpret=True))


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("Hq,Hkv,cap", [(8, 2, 0.0), (4, 4, 30.0)])
def test_decode_attention_plain_matches_reference_and_pallas(Hq, Hkv, cap):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, Hq, 1, 32)).astype(np.float32)
    k = rng.normal(size=(3, Hkv, 64, 32)).astype(np.float32)
    v = rng.normal(size=(3, Hkv, 64, 32)).astype(np.float32)
    kv_len = np.asarray([1, 30, 64], np.int32)
    k[:, :, 40:] = 1e6                  # dead cache slots beyond every live length but one
    k[2, :, 40:] = rng.normal(size=(Hkv, 24, 32))
    out = ref.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               kv_len=torch.from_numpy(kv_len), logit_soft_cap=cap)
    kw = dict(kv_len=jnp.asarray(kv_len), logit_soft_cap=cap)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    close(out, jref.decode_attention(*jargs, **kw))
    close(out, pallas_decode(*jargs, interpret=True, **kw))


def test_chunk_attention_matches_reference_mha():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 4, 5, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 32, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, 32, 16)).astype(np.float32)
    out = ops.chunk_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              q_offset=11, kv_len=16)
    close(out, jref.mha(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                        kv_len=16, q_offset=11))


# ------------------------------------------------------------------ dispatch
def test_kernel_wrappers_dispatch_by_device():
    """A wrapper takes its plain version for a CPU tensor, bit for bit and
    without counting a launch; a tensor on any other non-CUDA device is
    refused. ``ops`` hands the models these same wrappers."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(1, 4, 1, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(3, 2, 16, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 16, 16)).astype(np.float32))
    bt = torch.tensor([[2, 1]], dtype=torch.int32)
    assert torch.equal(rms_k.rmsnorm(x, w), rms_k.plain(x, w))
    assert torch.equal(pa_k.paged_attention(q, kp, kp, block_tables=bt, kv_len=20),
                       pa_k.plain(q, kp, kp, block_tables=bt, kv_len=20))
    assert torch.equal(dec_k.decode_attention(q, k, k, kv_len=9),
                       dec_k.plain(q, k, k, kv_len=9))
    assert (ops.rmsnorm, ops.paged_attention, ops.decode_attention) == (
        rms_k.rmsnorm, pa_k.paged_attention, dec_k.decode_attention)
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="CUDA"):
        rms_k.rmsnorm(x.to(**meta), w.to(**meta))
    with pytest.raises(ValueError, match="CUDA"):
        pa_k.paged_attention(q.to(**meta), kp.to(**meta), kp.to(**meta),
                             block_tables=bt.to(**meta), kv_len=20)
    with pytest.raises(ValueError, match="CUDA"):
        dec_k.decode_attention(q.to(**meta), k.to(**meta), k.to(**meta), kv_len=9)
    assert rms_k.launches == pa_k.launches == dec_k.launches == 0
