"""The port's step analyzer and cost model (``repro_torch.launch.analysis``),
held against the JAX package's: the two exact FLOP counts of
``tests/test_sharding_analysis.py`` (a rematerialized layer loop under
grad, nested loops), ``analytic_costs`` on every (arch, shape cell), the
roofline terms with the H100's constants, a smoke model's step on meta
tensors, and the collective bytes of a known program on two gloo ranks."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.utils.checkpoint  # noqa: E402

from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import shapes_for as ref_shapes_for  # noqa: E402
from repro.launch import analysis as ref  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_smoke_config, list_archs, \
    shapes_for  # noqa: E402
from repro_torch.launch.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,  # noqa: E402
                                         analytic_costs, analyze_step, roofline_terms)
from repro_torch.models import build_model  # noqa: E402
from _torch_dist_worker import launch  # noqa: E402


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_analyzer_exact_on_remat_loop_grad(device):
    L, M, D = 8, 64, 128

    def body(x, w):
        return torch.tanh(x @ w)

    def step(ws, x):
        y = x
        for i in range(L):
            y = torch.utils.checkpoint.checkpoint(body, y, ws[i], use_reentrant=False)
        return torch.autograd.grad((y * y).sum(), [ws, x])

    ws = torch.randn(L, D, D, device=device, requires_grad=True)
    x = torch.randn(M, D, device=device, requires_grad=True)
    res = analyze_step(step, ws, x)
    # fwd: 1 matmul/layer; bwd: refwd + dx + dw = 3 matmuls/layer
    assert res["flops"] == 4 * L * 2 * M * D * D
    assert res["collective_bytes_total"] == 0


def test_analyzer_counts_nested_loops():
    def inner(x):
        c = x
        for _ in range(3):
            c = c @ x
        return c

    def outer(x):
        c = x
        for _ in range(5):
            c = inner(c)
        return c.sum()

    D = 32
    res = analyze_step(outer, torch.empty(D, D, device="meta"))
    assert res["flops"] == 15 * 2 * D * D * D  # 5 x 3 matmuls
    assert set(res) == {"flops", "collective_bytes", "collective_bytes_total",
                        "collective_op_counts"}


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_costs_equal_the_reference(arch):
    cells = shapes_for(arch)
    assert [c.name for c in cells] == [c.name for c in ref_shapes_for(arch)]
    for cell in cells:
        assert analytic_costs(get_config(arch), cell) == ref.analytic_costs(ref_full(arch),
                                                                            cell), cell.name


def test_analytic_costs_sane():
    cfg = get_config("minitron-8b")
    train = analytic_costs(cfg, SHAPES["train_4k"])
    dec = analytic_costs(cfg, SHAPES["decode_32k"])
    assert train["model_flops_global"] == pytest.approx(
        6 * train["n_params_active"] * 256 * 4096, rel=0.25)
    ratio = dec["model_flops_global"] / 128 / (2 * dec["n_params_active"])
    assert 1.0 <= ratio <= 3.0, ratio
    assert dec["hbm_bytes_global"] >= dec["n_params_total"] * 2


def test_roofline_terms_pick_bottleneck_with_h100_constants():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    rec = {"hlo_flops_per_device": PEAK_FLOPS,             # exactly 1 s of compute
           "hbm_bytes_global": HBM_BW * 256 * 0.5,
           "collective_bytes_total_per_device": LINK_BW * 0.1,
           "model_flops_global": PEAK_FLOPS * 256}
    t = roofline_terms(rec, 256)
    assert t["bottleneck"] == "compute_s"
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5) and t["collective_s"] == pytest.approx(0.1)
    assert t["mfu_bound"] == pytest.approx(1.0)
    rec["collective_bytes_total_per_device"] = LINK_BW * 2.0
    assert roofline_terms(rec, 256)["bottleneck"] == "collective_s"


def test_smoke_step_on_meta_counts_what_the_cpu_step_counts():
    """A smoke minitron's loss and gradients on meta params count the
    same matmul FLOPs as on the CPU: the kernels' plain versions stand in
    on both, and nothing runs on meta."""
    cfg = get_smoke_config("minitron-8b").replace(compute_dtype="float32")
    model = build_model(cfg)

    def step(params, tokens):
        leaves = [t.requires_grad_() for t in jax.tree_util.tree_leaves(params)]
        loss, _ = model.loss(params, {"tokens": tokens})
        return torch.autograd.grad(loss, leaves)

    cpu = model.init(0, device="cpu")
    meta = jax.tree_util.tree_map(lambda t: torch.empty_like(t, device="meta"), cpu)
    toks = torch.zeros(2, 17, dtype=torch.int64)
    got = analyze_step(step, meta, toks.to("meta"))
    assert got["flops"] == analyze_step(step, cpu, toks)["flops"] > 0


def test_collectives_of_a_known_program_on_two_ranks(tmp_path):
    """Each rank's bytes: all-reduce of (4, 8) float32 counted twice (256),
    all-gather into (4, 8) and DTensor's gather of (6, 8) (128 + 192),
    reduce-scatter into (2, 8) (64), all-to-all of (4, 8) (128); the
    sharded (6, 8) @ (8, 4) counts its local (3, 8) @ (8, 4)."""
    for out in launch(2, tmp_path, 120):
        a = out["analysis"]
        assert a["collective_bytes"] == {"all-gather": 320, "all-reduce": 256,
                                         "reduce-scatter": 64, "all-to-all": 128,
                                         "collective-permute": 0}
        assert a["collective_op_counts"] == {"all-gather": 2, "all-reduce": 1,
                                             "reduce-scatter": 1, "all-to-all": 1,
                                             "collective-permute": 0}
        assert a["collective_bytes_total"] == 768
        assert a["flops"] == 2 * 3 * 4 * 8


def test_fake_and_meta_tensors_take_the_plain_versions():
    """A FakeTensor on the card's device and a meta tensor go to the plain
    versions, as a CPU tensor does: nothing is launched for them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    with FakeTensorMode():
        x, w = torch.empty(4, 8, device="cuda"), torch.empty(8, device="cuda")
        assert _build.runs_plain(x)
        assert rmsnorm(x, w).shape == (4, 8)
    q, kv = torch.empty(1, 4, 16, 8, device="meta"), torch.empty(1, 2, 16, 8, device="meta")
    assert _build.runs_plain(q) and _build.runs_plain(torch.ones(2))
    assert flash_attention(q, kv, kv).shape == (1, 4, 16, 8)
