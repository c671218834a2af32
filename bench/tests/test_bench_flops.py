"""The benchmark's arithmetic against hand counts and the port's layout."""
import json
import math
from pathlib import Path

import pytest

from bench import data, flops, harness, manifest
from bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
QWEN = json.loads((ROOT / "bench/configs/qwen1.5-0.5b.json").read_text())
GRANITE = json.loads((ROOT / "bench/configs/granite-moe-1b-a400m.json").read_text())


def test_qwen_parameters_by_hand():
    d, f, V, L = 1024, 2816, 151936, 24
    per_layer = 4 * d * d + 3 * d * f + 2 * d + 3 * d  # q k v o, SwiGLU, two norms, qkv bias
    assert flops.param_count(QWEN) == L * per_layer + V * d + d
    assert round(flops.param_count(QWEN) / 1e6, 1) == 464.0
    # 6 x the matmul weights a token (layers' products and the tied unembedding)
    mm = L * (4 * d * d + 3 * d * f) + V * d
    assert flops.matmul_params_per_token(QWEN) == mm
    attn = L * 4 * 16 * 64 * 128 * 129 // 2  # QK^T and PV over the causal pairs
    assert flops.train_flops_per_seq(QWEN, 128) == 6 * mm * 128 + 3 * attn


def test_granite_active_parameters_by_hand():
    d, L, V = 1024, 8, 49155
    attn = 2 * d * d + 2 * d * 512
    assert flops.matmul_params_per_token(GRANITE) == L * (attn + 32 * d + 8 * 3 * d * 512) + V * d
    assert flops.param_count(GRANITE) == L * (attn + 32 * d + 32 * 3 * d * 512 + 2 * d) + V * d + d


def test_kernel_bytes_against_the_kernel_table():
    # PERF.md's kernel table: vecavg at [5, 555178] needs 13.3 MB
    assert round(flops.vecavg_bytes(5, 555178, div=True) / 1e6, 1) == 13.3
    assert flops.peaks("NVIDIA H100 80GB HBM3")["fp32_flops_per_s"] == 67e12


@pytest.mark.parametrize("name", ["qwen05-fedveca", "granite-moe-fedveca"])
def test_layout_and_count_equal_the_port(name):
    from repro_torch.models.model import params_struct

    cell = manifest.cell(name, ROOT, workload=tiny.HELD_OUT if name == tiny.HELD_OUT["name"] else None)
    model = harness.build_model(cell, "cpu")  # raises unless the layouts agree
    struct = params_struct(model)
    assert sum(v.numel() for v in struct.values()) == flops.param_count(cell.config)
    assert sum(math.prod(s) for s, _ in data.weight_layout(cell.config).values()) == \
        flops.param_count(cell.config)
