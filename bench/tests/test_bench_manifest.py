"""BENCHMARK.json against the benchmark contract, and every cell's files
found by name."""
import json
import re
from pathlib import Path

import pytest

from bench import compare, manifest
from bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "bench/run.py"] and B["paths"] == ["bench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in B[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in B["configs"] + B["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    assert len(json.dumps(B)) < 64 * 1024


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("name", [w["name"] for w in B["workloads"]] + [tiny.HELD_OUT["name"]])
def test_cell_files_resolve(name):
    held = name == tiny.HELD_OUT["name"]  # its files kept, its entry out of BENCHMARK.json
    c = manifest.cell(name, ROOT, workload=tiny.HELD_OUT if held else None)
    assert c.chips == 1 and c.config["source"].startswith("https://")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "train_samples_per_s", "mfu",
                                                 "peak_mem_gb"}
    assert bool(c.per_layer) != held and c.limits["tau_mismatch"] == 0
    assert set(c.limits) <= set(compare.NUMBERS) and {"loss_gap", "stats_gap"} <= set(c.limits)
    assert all(isinstance(v, (int, float)) and v >= 0 for v in c.limits.values())


HELD_OUT_CONFIG = dict(
    name="granite-moe-1b-a400m", file="bench/configs/granite-moe-1b-a400m.json",
    source="https://huggingface.co/ibm-granite/granite-3.0-1b-a400m-base/blob/main/config.json",
    reduced=["num_hidden_layers", "embedding_multiplier", "attention_multiplier",
             "residual_multiplier", "logits_scaling"])


@pytest.mark.parametrize("entry", B["configs"] + [HELD_OUT_CONFIG], ids=lambda c: c["name"])
def test_config_files_state_their_cuts(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("bench/configs/") and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    for key in cfg["reduced"]:
        assert key in cfg.get("published", {})
    port = cfg["port"]["fields"]
    pairs = dict(num_layers="num_hidden_layers", d_model="hidden_size",
                 num_heads="num_attention_heads", num_kv_heads="num_key_value_heads",
                 head_dim="head_dim", vocab_size="vocab_size", rope_theta="rope_theta",
                 tie_embeddings="tie_word_embeddings", qkv_bias="attention_bias")
    for ours, theirs in pairs.items():
        assert port[ours] == cfg[theirs], ours
    if cfg.get("num_local_experts"):
        assert (port["num_experts"], port["experts_per_token"], port["moe_d_ff"]) == (
            cfg["num_local_experts"], cfg["num_experts_per_tok"], cfg["intermediate_size"])
        assert port["capacity_factor"] == cfg["capacity_factor"]
        assert port["router_aux_loss"] == cfg["router_aux_loss_coef"]
    else:
        assert port["d_ff"] == cfg["intermediate_size"]
