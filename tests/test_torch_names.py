"""Public names the port carries for the JAX package's callers, held
against the reference: ``PagePool.n_free``, ``sampler.sample``,
``GenerationParams.resolve`` and ``configs.list_archs``, and the public
functions of the MoE and MLA modules and the two MoE configs.

``sample`` draws with one key over the whole (B, V) batch, as
``jax.random.categorical`` does; the draws are compared token for token
(the Gumbel noise may differ by an ulp of ``log`` between XLA and
PyTorch, which moves no argmax here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.serving.pagepool import PagePool as RefPagePool  # noqa: E402
from repro.serving.sampler import GenerationParams as RefParams  # noqa: E402
from repro.serving.sampler import SamplerConfig as RefSC  # noqa: E402
from repro.serving.sampler import sample as ref_sample  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import GenerationParams, SamplerConfig  # noqa: E402
from repro_torch.serving.pagepool import PagePool  # noqa: E402
from repro_torch.serving.sampler import sample  # noqa: E402

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")


def test_list_archs_lists_every_reference_arch():
    """Every arch is listed and builds: its full config's param tree and
    its smoke model, by the reference's key paths and shapes."""
    from repro_torch.models.common import flatten
    assert list_archs() == ref_list_archs()
    from repro.configs import get_config as ref_full
    for arch in list_archs():
        full = build_model(get_config(arch))
        assert {p: d.shape for p, d in flatten(full.param_defs())} == {
            p: d.shape for p, d in flatten(ref_build(ref_full(arch)).param_defs())}, arch
        smoke = build_model(get_smoke_config(arch).replace(**KW)).init(seed=0, device="cpu")
        assert {p: tuple(t.shape) for p, t in flatten(smoke)} == {
            p: d.shape for p, d in flatten(ref_build(ref_smoke(arch).replace(**KW))
                                           .param_defs())}, arch


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_n_free_tracks_allocations_as_the_reference(kv_dtype):
    ref = RefPagePool(ref_build(ref_smoke("minitron-8b").replace(**KW)), page=16,
                      capacity=5, kv_dtype=kv_dtype)
    port = PagePool(build_model(get_smoke_config("minitron-8b").replace(**KW)), page=16,
                    capacity=5, kv_dtype=kv_dtype)
    assert port.n_free() == ref.n_free() == 5
    got = []
    for _ in range(7):                      # two past the capacity: None
        a, b = ref.alloc(), port.alloc()
        assert a == b
        got.append(a)
        assert port.n_free() == ref.n_free()
    assert got[-2:] == [None, None] and port.n_free() == 0
    for pid in (got[1], got[3]):
        ref.free(pid)
        port.free(pid)
        assert port.n_free() == ref.n_free()
    assert port.n_free() == 2


def _logits(seed, B, V):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("cfg", [
    dict(temperature=0.0),                                  # greedy
    dict(temperature=0.0, vocab_size=40),                   # greedy, masked vocab
    dict(temperature=1.0),                                  # the categorical draw
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.8, vocab_size=50),
    dict(temperature=1.0, top_k=1),
])
def test_sample_matches_reference(seed, cfg):
    logits = _logits(seed, 6, 64)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(ref_sample(jnp.asarray(logits), key, RefSC(**cfg)))
    pair = tuple(int(v) for v in np.asarray(key).tolist())
    got = sample(torch.from_numpy(logits), pair, SamplerConfig(**cfg))
    assert got.dtype == torch.int64 and got.shape == (6,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_draws_differ_across_rows_and_keys():
    """One key covers the batch: equal rows still draw apart."""
    logits = torch.zeros(64, 300)
    a = sample(logits, (0, 1), SamplerConfig(temperature=1.0))
    b = sample(logits, (0, 2), SamplerConfig(temperature=1.0))
    assert len(set(a.tolist())) > 32 and not torch.equal(a, b)


@pytest.mark.parametrize("params", [
    dict(), dict(temperature=0.9), dict(top_p=0.5), dict(temperature=0.0, top_p=0.95),
])
def test_resolve_matches_reference(params):
    for base in (dict(), dict(temperature=0.3, top_k=8, top_p=0.7, vocab_size=300)):
        want = RefParams(**params).resolve(RefSC(**base))
        got = GenerationParams(**params).resolve(SamplerConfig(**base))
        assert isinstance(got, SamplerConfig)
        assert (got.temperature, got.top_k, got.top_p, got.vocab_size) == (
            want.temperature, want.top_k, want.top_p, want.vocab_size)


def test_serving_exports_cover_the_reference():
    """``repro_torch.serving`` exports every name ``repro.serving`` does
    (the port's own extras beside them), SlotSplicer, WindowPolicy and
    the fleet among them."""
    import repro.serving as ref_serving
    import repro_torch.serving as port_serving
    from repro_torch.serving import (EngineFleet, FleetHandle, SlotSplicer,  # noqa: F401
                                     WindowPolicy)

    assert set(ref_serving.__all__) <= set(port_serving.__all__)
    assert set(port_serving.__all__) - set(ref_serving.__all__) == {"resolve_device",
                                                                    "TRASH_PAGE"}
    assert all(hasattr(port_serving, n) for n in port_serving.__all__)
    assert WindowPolicy().cap_pages == ref_serving.WindowPolicy().cap_pages == 6


@pytest.mark.parametrize("mod", ["moe", "mla"])
def test_moe_and_mla_modules_carry_the_reference_names(mod):
    """``models.moe`` and ``models.mla`` define the reference's public
    functions (and ``_route``, ``_slots``, ``_norm``, ``_pad_v``), with the
    same positional parameters."""
    import importlib
    import inspect
    ref = importlib.import_module(f"repro.models.{mod}")
    port = importlib.import_module(f"repro_torch.models.{mod}")

    def public(m):
        return {n for n, f in vars(m).items() if inspect.isfunction(f)
                and f.__module__ == m.__name__ and not n.startswith("_")}

    assert public(port) == public(ref)
    helpers = {"moe": ("_route", "_slots", "_experts_ffn"), "mla": ("_norm", "_pad_v")}[mod]
    for name in sorted(public(port)) + list(helpers):
        want = [p for p in inspect.signature(getattr(ref, name)).parameters]
        got = [p for p in inspect.signature(getattr(port, name)).parameters]
        assert got[:len(want)] == want, name


# the reference's shims for JAX's API drift, with no torch counterpart
JAX_ONLY = {"distributed.sharding": {"get_abstract_mesh", "shard_map_compat"},
            "launch.analysis": {"analyze_hlo"}}
# the port's own: the placements DTensor takes, its active-mesh context,
# the uneven-heads gathers of a tensor and of its gradient, the gradient
# laid out as its tensor, analyze_hlo's counterpart, and the dry-run's
# walk on meta DTensors over a fake world
PORT_ONLY = {"distributed.sharding": {"to_placements", "use_mesh", "gather_unless_divides",
                                      "gather_grad_unless_divides", "grad_like"},
             "launch.analysis": {"analyze_step"},
             "launch.dryrun": {"accum_for", "sharded_meta", "lay_out", "local_bytes", "combine",
                               "cell_step", "fake_world", "cell_config", "cell_record"}}


@pytest.mark.parametrize("mod", ["distributed.sharding", "distributed.fault", "launch.mesh",
                                 "launch.analysis"])
def test_distribution_modules_carry_the_reference_names(mod):
    """The distribution modules define the reference's public functions
    with the same leading parameters, less the documented JAX-only shims
    and beside the port's own; the packages export the same."""
    import importlib
    import inspect
    ref = importlib.import_module(f"repro.{mod}")
    port = importlib.import_module(f"repro_torch.{mod}")

    def public(m):
        return {n for n, f in vars(m).items() if inspect.isfunction(f)
                and f.__module__ == m.__name__ and not n.startswith("_")}

    assert public(port) == (public(ref) - JAX_ONLY.get(mod, set())) | PORT_ONLY.get(mod, set())
    for name in sorted(public(port) & public(ref)) + (
            ["_resolve_one"] if mod == "distributed.sharding" else []):
        want = [p for p in inspect.signature(getattr(ref, name)).parameters]
        got = [p for p in inspect.signature(getattr(port, name)).parameters]
        assert got[:len(want)] == want, name      # make_local_mesh adds device
    if mod == "distributed.sharding":
        import repro.distributed as ref_pkg
        import repro_torch.distributed as port_pkg
        assert port_pkg.__all__ == ref_pkg.__all__
        assert port.DEFAULT_RULES == ref.DEFAULT_RULES


@pytest.mark.parametrize("mod", ["launch.dryrun", "launch.perf"])
def test_dryrun_modules_carry_the_reference_names(mod):
    """The dry-run and the optimized cells define the reference's public
    functions with the same leading parameters, beside the port's own
    walk. Importing the reference's modules appends a host device count
    to XLA_FLAGS; it is put back, so this process's JAX keeps its own."""
    import importlib
    import inspect
    import os

    flags = os.environ.get("XLA_FLAGS")
    try:
        ref = importlib.import_module(f"repro.{mod}")
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    port = importlib.import_module(f"repro_torch.{mod}")

    def public(m):
        return {n for n, f in vars(m).items() if inspect.isfunction(f)
                and f.__module__ == m.__name__ and not n.startswith("_")}

    assert public(port) == public(ref) | PORT_ONLY.get(mod, set())
    for name in sorted(public(ref)) + (["_extra_from_specs"] if mod == "launch.dryrun" else []):
        want = [p for p in inspect.signature(getattr(ref, name)).parameters]
        got = [p for p in inspect.signature(getattr(port, name)).parameters]
        assert got[:len(want)] == want, name


def test_configs_and_models_export_the_reference_names():
    import repro.configs as ref_configs
    import repro.models as ref_models
    import repro_torch.configs as port_configs
    import repro_torch.models as port_models
    assert set(ref_configs.__all__) <= set(port_configs.__all__)
    assert set(port_configs.__all__) - set(ref_configs.__all__) == {"PORTED"}
    assert set(port_models.__all__) == set(ref_models.__all__)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_moe_configs_carry_the_reference_names(arch):
    import importlib
    mod = arch.replace("-", "_").replace(".", "_")
    ref = importlib.import_module(f"repro.configs.{mod}")
    port = importlib.import_module(f"repro_torch.configs.{mod}")
    assert port.CONFIG == get_config(arch) and port.SMOKE == get_smoke_config(arch)
    for name in ("CONFIG", "SMOKE"):
        r, p = getattr(ref, name), getattr(port, name)
        assert {f: getattr(p, f) for f in r.__dataclass_fields__} == {
            f: getattr(r, f) for f in r.__dataclass_fields__}
