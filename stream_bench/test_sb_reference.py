"""Each configuration's plain reference against the port's model, at smoke
size in float32 on the CPU, with the benchmark's own weights written into
the port (the test may import both)."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from stream_bench.reference import moe_lm
from stream_bench.weights import Weights, block_indices

CONFIGS = sorted(p.stem for p in (Path(__file__).parent / "configs").glob("*.json"))


def smoke(name):
    from repro_torch.configs import get_smoke_config
    cfg = json.loads((Path(__file__).parent / "configs" / f"{name}.json").read_text())
    full = cfg["port"]["model"]
    # the configuration's own switches, at the smoke's widths and in float32;
    # capacity wide enough that no unit is dropped, as the reference keeps all
    c = get_smoke_config(cfg["port"]["arch"]).replace(
        param_dtype="float32", compute_dtype="float32", capacity_factor=100.0,
        eval_capacity_factor=100.0, norm_eps=full["norm_eps"],
        router_renorm=full["router_renorm"], mla_absorbed_decode=full["mla_absorbed_decode"])
    return c, {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


def port_gaps(model, params, vocab, full, served):
    with torch.no_grad():
        lg = model.forward(params, torch.tensor([full[:-1]]))[0].float()
    rows = lg[-len(served):, :vocab]
    return rows.max(-1).values - rows.gather(1, torch.tensor(served)[:, None])[:, 0]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port(name):
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten
    c, m = smoke(name)
    model = build_model(c)
    params = model.init(0, "cpu")
    W = Weights(moe_lm.layout(m), seed=2**32 + 17, dtype=torch.float32, device="cpu")
    W.write_into({".".join(k): t for k, t in flatten(params)})
    g = torch.Generator().manual_seed(1)
    seqs = [torch.randint(3, c.vocab_size, (n,), generator=g).tolist() for n in (21, 40)]
    served = [s[-6:] for s in seqs]
    out = moe_lm.judge(m, W, [s[:-1] for s in seqs], served, control=True)
    for s, t, gap in zip(seqs, served, out["gap"]):
        assert torch.allclose(port_gaps(model, params, c.vocab_size, s, t), gap,
                              atol=1e-4, rtol=1e-4)
    # the fp8 control is a different arithmetic
    assert any(float(x.max()) > 0 for x in out["control_gap"])
    # one weight changed in the port only: the reference sees the difference
    params["blocks"]["mlp"]["w1"][0, 0] += 0.1
    assert not torch.allclose(port_gaps(model, params, c.vocab_size, seqs[1], served[1]),
                              out["gap"][1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_made_block_by_block_from_seed_and_name(name):
    _, m = smoke(name)
    lay = moe_lm.layout(m)
    a = Weights(lay, seed=5, dtype=torch.float32, device="cpu")
    b = Weights(lay, seed=6, dtype=torch.float32, device="cpu")
    name_ = "blocks.mlp.w1"
    shape = lay[name_][0]
    assert len(list(block_indices(shape))) == shape[0] * shape[1]
    assert torch.equal(a.block(name_, (1, 2)), a.block(name_, (1, 2)))
    assert not torch.equal(a.block(name_, (1, 2)), a.block(name_, (1, 3)))
    assert not torch.equal(a.block(name_, (1, 2)), b.block(name_, (1, 2)))
    # a reference read deeper than the block is the block's row
    assert torch.equal(a.get("blocks.ln1.w", (1,)), a.block("blocks.ln1.w")[1])


def test_layouts_match_the_configurations_published_numbers():
    ds = json.loads((Path(__file__).parent / "configs" / "deepseek-v2-lite-16b.json").read_text())
    m = ds["port"]["model"]
    assert (m["d_model"], m["d_ff"], m["moe_d_ff"], m["n_experts"], m["top_k"],
            m["n_shared_experts"], m["kv_lora_rank"], m["n_layers"], m["vocab_size"],
            m["norm_eps"], m["router_renorm"]) == (
        ds["hidden_size"], ds["intermediate_size"], ds["moe_intermediate_size"],
        ds["n_routed_experts"], ds["num_experts_per_tok"], ds["n_shared_experts"],
        ds["kv_lora_rank"], ds["num_hidden_layers"], ds["vocab_size"], ds["rms_norm_eps"],
        ds["norm_topk_prob"])
    n = sum(torch.Size(s).numel() for s, _, _ in moe_lm.layout(m).values())
    assert n == ds["memory"]["params"] and 15.6e9 < n < 15.8e9
    gk = json.loads((Path(__file__).parent / "configs" / "grok-1-314b.json").read_text())
    m = gk["port"]["model"]
    assert (m["d_model"], m["moe_d_ff"], m["n_heads"], m["n_kv_heads"], m["n_experts"],
            m["top_k"], m["n_layers"], m["vocab_size"]) == (
        gk["hidden_size"], gk["intermediate_size"], gk["num_attention_heads"],
        gk["num_key_value_heads"], gk["num_experts"], gk["num_experts_per_tok"],
        gk["num_hidden_layers"], gk["vocab_size"])
    n = sum(torch.Size(s).numel() for s, _, _ in moe_lm.layout(m).values())
    assert n == gk["memory"]["params"]
