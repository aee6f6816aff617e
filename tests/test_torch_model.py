"""Port model (dense TransformerLM) against the JAX package with the
reference's weights carried over by ``interop.params_from_numpy``:
chunked prefill and decode logits, contiguous and paged, at the smoke
configs of the dense family (minitron-8b; gemma-7b with GeGLU, (1+w)
norms, sqrt(d) embedding scale and tied embeddings; granite-20b's MQA;
deepseek-67b's D = 8) in float32. Tolerance: logits max abs error <= 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import flatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving.pagepool import chunk_plan  # noqa: E402

ATOL = 1e-4
KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
PAGE, MAX_SEQ = 16, 64
DENSE = ["minitron-8b", "gemma-7b", "granite-20b", "deepseek-67b"]   # family "dense"


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    jm = ref_build(ref_smoke(request.param).replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(get_smoke_config(request.param).replace(**KW))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, pm, pp


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference_field_for_field(arch):
    from repro.configs import get_config as ref_full
    for port, ref in ((get_config(arch), ref_full(arch)),
                      (get_smoke_config(arch), ref_smoke(arch))):
        for f in ref.__dataclass_fields__:
            assert getattr(port, f) == getattr(ref, f), f
    from repro.configs import ARCHS
    for other in ARCHS:                     # every arch of the reference is ported
        for port, ref in ((get_config(other), ref_full(other)),
                          (get_smoke_config(other), ref_smoke(other))):
            assert all(getattr(port, f) == getattr(ref, f)
                       for f in ref.__dataclass_fields__), other


def test_param_tree_layout_matches_reference(models):
    jm, jp, pm, _ = models
    ref = {path: tuple(a.shape) for path, a in flatten(jax.tree.map(np.asarray, jp))}
    port = {path: d.shape for path, d in flatten(pm.param_defs())}
    assert port == ref
    p = build_model(pm.cfg.replace(param_dtype="bfloat16")).init(seed=3)
    leaves = [t for _, t in flatten(p)]
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    again = build_model(pm.cfg.replace(param_dtype="bfloat16")).init(seed=3)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten(p), flatten(again)))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 259, size=n).tolist()


def _port_prefill(pm, pp, ids, cache):
    off = 0
    for n in chunk_plan(0, len(ids), PAGE):
        logits, cache = pm.prefill_chunk(pp, torch.tensor([ids[off:off + n]]), cache)
        off += n
    return logits, cache


def _ref_prefill(jm, jp, ids, cache):
    off = 0
    for n in chunk_plan(0, len(ids), PAGE):
        logits, cache = jm.prefill_chunk(jp, jnp.asarray([ids[off:off + n]]), cache)
        off += n
    return logits, cache


def test_contiguous_prefill_and_decode_match_reference(models):
    jm, jp, pm, pp = models
    ids = _prompt(0, 21)                           # chunks 16 + 4 + 1
    jl, jc = _ref_prefill(jm, jp, ids, jm.init_cache(1, MAX_SEQ))
    with torch.inference_mode():
        pl, pc = _port_prefill(pm, pp, ids, pm.init_cache(1, MAX_SEQ))
    close(pl, jl)
    tok = int(np.argmax(np.asarray(jl)[0]))
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jnp.asarray([[tok]]), jc)
        with torch.inference_mode():
            pl, pc = pm.decode_step(pp, torch.tensor([[tok]]), pc)
        close(pl, jl)
        tok = int(np.argmax(np.asarray(jl)[0]))
    assert pc["pos"] == int(jc["pos"]) == 25


def test_paged_prefill_and_decode_match_reference_and_contiguous(models):
    """Two slots in one pool: slot 0's 21-token prompt on pages [3, 5],
    slot 1's 7-token prompt on page [7]; both prefill through their own
    block-table row, then decode together through (2, 4) tables."""
    jm, jp, pm, pp = models
    cfg = pm.cfg
    prompts = [_prompt(1, 21), _prompt(2, 7)]
    rows = np.zeros((2, MAX_SEQ // PAGE), np.int32)
    rows[0, :2], rows[1, :1] = [3, 5], [7]
    shape = (cfg.n_layers, 12, cfg.n_kv_heads, PAGE, cfg.head_dim)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    toks = []
    for b, ids in enumerate(prompts):
        jl, jc = _ref_prefill(jm, jp, ids, {
            "k": jk, "v": jv, "pos": jnp.asarray(0, jnp.int32),
            "pos_offset": jnp.zeros((), jnp.int32),
            "block_tables": jnp.asarray(rows[b:b + 1])})
        jk, jv = jc["k"], jc["v"]
        with torch.inference_mode():
            pl, _ = _port_prefill(pm, pp, ids, {
                "k": pk, "v": pv, "pos": 0,
                "block_tables": torch.from_numpy(rows[b:b + 1])})
        close(pl, jl)
        toks.append(int(np.argmax(np.asarray(jl)[0])))
    close(pk, jk, 1e-5)                            # the pool pages themselves

    # the port's contiguous cache for the same prompts: paged == contiguous
    contig = []
    for ids in prompts:
        with torch.inference_mode():
            contig.append(_port_prefill(pm, pp, ids, pm.init_cache(1, MAX_SEQ))[1])

    pos = np.asarray([len(p) for p in prompts], np.int32)
    jc = {"k": jk, "v": jv, "pos": jnp.asarray(pos),
          "pos_offset": jnp.zeros(2, jnp.int32), "block_tables": jnp.asarray(rows)}
    pc = {"k": pk, "v": pv, "pos": torch.from_numpy(pos),
          "pos_offset": torch.zeros(2, dtype=torch.int32),
          "block_tables": torch.from_numpy(rows)}
    tok = np.asarray(toks)
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok[:, None]), jc)
        with torch.inference_mode():
            pl, pc = pm.decode_step(pp, torch.from_numpy(tok[:, None]).long(), pc)
            for b in range(2):
                cl, contig[b] = pm.decode_step(pp, torch.tensor([[int(tok[b])]]),
                                               contig[b])
                torch.testing.assert_close(pl[b], cl[0], atol=1e-5, rtol=0)
        close(pl, jl)
        tok = np.argmax(np.asarray(jl), axis=-1)
    assert pk.data_ptr() == pc["k"].data_ptr()     # written in place, never copied


def test_pool_dtype_must_equal_compute_dtype(models):
    _, _, pm, pp = models
    shape = (pm.cfg.n_layers, 4, pm.cfg.n_kv_heads, PAGE, pm.cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
             "v": torch.zeros(shape, dtype=torch.bfloat16),
             "pos": torch.tensor([3], dtype=torch.int32),
             "pos_offset": torch.zeros(1, dtype=torch.int32),
             "block_tables": torch.tensor([[1, 0, 0, 0]], dtype=torch.int32)}
    with pytest.raises(TypeError, match="compute dtype"):
        pm.decode_step(pp, torch.tensor([[5]]), cache)
