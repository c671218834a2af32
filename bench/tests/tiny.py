"""Tiny copies of the benchmark's cells for CPU tests: the cell's own
traffic, limits and metrics, its configuration cut to a few dozen
features (every kind of layer kept)."""
from __future__ import annotations

import copy

from bench import manifest

WIDTHS = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
              head_dim=16, num_hidden_layers=2, vocab_size=256)
PORT = dict(d_model=64, d_ff=96, num_heads=4, num_kv_heads=2, head_dim=16, num_layers=2,
            vocab_size=256)
MOE = dict(num_local_experts=4, num_experts_per_tok=2, intermediate_size=32)
PORT_MOE = dict(num_experts=4, experts_per_token=2, d_ff=32, moe_d_ff=32)


# the MoE cell, held out of BENCHMARK.json while its comparison cannot
# separate the TF32 control from sound runs (PERF.md), so that the CPU
# tests still hold the port's MoE round to the reference
HELD_OUT = dict(name="granite-moe-fedveca", config="granite-moe-1b-a400m",
                traffic="fedveca-lm8", chips=1)


def cell(name: str) -> manifest.Cell:
    c = manifest.cell(name, workload=HELD_OUT if name == HELD_OUT["name"] else None)
    c.config = copy.deepcopy(c.config)
    moe = bool(c.config.get("num_local_experts"))
    c.config.update(WIDTHS, **(MOE if moe else {}))
    c.config["port"]["fields"].update(PORT, **(PORT_MOE if moe else {}))
    c.traffic = dict(c.traffic, client_sizes=[8, 11, 14, 17, 20, 23, 26, 29], seq=16, batch=4,
                     tau_max=3, test_seqs=8, profile_rounds=1)
    return c
