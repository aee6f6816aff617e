"""The harness end to end at smoke size on the CPU (its look for a card
skipped): a sound run is correct, and a run with the timed path broken
underneath comes out not correct, once for each fault a serving cell can
have. The cells run on one card, so no exchange between chips exists to
leave out."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stream_bench import run
from stream_bench._smoke import smoke_spec

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 77


def one_run(name, trace=False, seconds=3.0):
    return run.run_cell(smoke_spec(name), SEED, seconds, trace, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = one_run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert {"output_tok_s", "itl_p95_ms", "setup_s"} <= set(res["metrics"])


def test_a_traced_run_reads_the_host_metrics():
    res = one_run(CELLS[0], trace=True)
    assert res["correct"], res["checks"]
    assert {"crypto_ms_per_token", "tick_ms", "mfu"} <= set(res["metrics"])
    # no device on the CPU: no device metric is written
    assert not {"decode_device_ms", "device_idle"} & set(res["metrics"])


def _alter_token(monkeypatch):
    """One slot's token a tick, the slot in turn, is another id of the
    vocabulary, so every request that lasts a few ticks is served some."""
    from repro_torch.serving.scheduler import ContinuousBatcher
    orig = ContinuousBatcher._fused
    tick = [0]

    def fused(self, rng):
        packed = orig(self, rng)
        slot = tick[0] % len(packed)
        tick[0] += 1
        if packed[slot, 1]:
            packed[slot, 0] = (packed[slot, 0] + 1) % 384
        return packed
    monkeypatch.setattr(ContinuousBatcher, "_fused", fused)


def _state_unchanged(monkeypatch):
    from repro_torch.models.lm import TransformerLM
    orig = TransformerLM.decode_step

    def decode_step(self, params, token, cache, extra=None):
        logits, new = orig(self, params, token, cache, extra)
        return logits, {**new, "pos": cache["pos"]}
    monkeypatch.setattr(TransformerLM, "decode_step", decode_step)


def _half_batch(monkeypatch):
    from repro_torch.models.lm import TransformerLM
    orig = TransformerLM.decode_step

    def decode_step(self, params, token, cache, extra=None):
        logits, new = orig(self, params, token, cache, extra)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:h].mean(0, keepdim=True).expand(
            logits.shape[0] - h, -1)]), new
    monkeypatch.setattr(TransformerLM, "decode_step", decode_step)


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged, _half_batch],
                         ids=["token_altered", "state_unchanged", "half_batch_left_out"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = one_run(CELLS[0])
    assert not res["correct"]
    assert res["checks"]["mean_logit_gap"]["value"] > res["checks"]["mean_logit_gap"]["limit"]


def test_a_frame_altered_in_the_relay_is_not_correct(monkeypatch):
    # the id of every third token frame the consumer opens is another:
    # the texts stay empty for most ids, so only the relay's check sees it
    from repro_torch.core import data_plane
    orig = data_plane.decrypt_envelope
    n = [0]

    def decrypt(aes, env):
        out = orig(aes, env)
        if out.get("t") == "token":
            n[0] += 1
            if n[0] % 3 == 0:
                out = dict(out, id=(out["id"] + 1) % 384)
        return out
    monkeypatch.setattr(data_plane, "decrypt_envelope", decrypt)
    res = one_run(CELLS[0])
    assert not res["correct"] and res["checks"]["relay_mismatch"]["value"] > 0


def test_a_miscounted_usage_is_not_correct(monkeypatch):
    from repro_torch.core import gateway
    orig = gateway.usage_chunk

    def usage_chunk(*a, **k):
        k["completion_tokens"] += 1
        return orig(*a, **k)
    monkeypatch.setattr(gateway, "usage_chunk", usage_chunk)
    res = one_run(CELLS[0])
    assert not res["correct"] and res["checks"]["usage_mismatch"]["value"] > 0


def test_a_token_outside_the_vocabulary_is_not_correct(monkeypatch):
    from repro_torch.serving.scheduler import ContinuousBatcher
    orig = ContinuousBatcher._fused

    def fused(self, rng):
        packed = orig(self, rng)
        if packed[0, 1]:
            packed[0, 0] = 384 + 5
        return packed
    monkeypatch.setattr(ContinuousBatcher, "_fused", fused)
    res = one_run(CELLS[0])
    assert not res["correct"] and res["checks"]["token_outside_vocab"]["value"] > 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_the_process_that_runs_a_cell_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from stream_bench import run\n"
        "from stream_bench._smoke import smoke_spec\n"
        "import importlib, pkgutil, stream_bench.metrics as M, stream_bench.reference as R\n"
        "for pkg in (M, R):\n"
        "    for mi in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(pkg.__name__ + '.' + mi.name)\n"
        f"res = run.run_cell(smoke_spec({CELLS[0]!r}), 5, 1.0, True, device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & run.FORBIDDEN), 'checks' in res)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_no_module_reads_the_jax_era_benchmarks_folder():
    import ast
    for path in Path(__file__).parent.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for n in ast.walk(tree):
            if isinstance(n, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in n.names] + [getattr(n, "module", None) or ""]
                assert not any(x.split(".")[0] in ("benchmarks", "jax", "repro")
                               for x in names), (path, names)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs:
                assert "benchmarks" not in n.value, (path, n.value)
