"""The JAX package's optimisation driver (``repro/launch/perf.py``): the
dry run's bundles re-lowered with candidate options (``remat``,
``stat_dtype``, ``fed_batch_rules``, ``kv_seq_shard``) and their XLA
roofline terms recorded beside the baselines.

Not ported (ROADMAP.md A18d): it reads the dry run's XLA cost tables
(``launch/dryrun.py``). The options themselves are the step bundles'
keywords (``train/steps.py``).

    python -m repro_torch.launch.perf   # raises naming A18d
"""
from __future__ import annotations

from repro_torch import not_ported


def main(argv=None):
    raise not_ported("launch.perf (the dry run's roofline terms a candidate option)", "A18d")


if __name__ == "__main__":
    main()
