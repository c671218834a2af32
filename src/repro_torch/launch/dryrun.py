"""The JAX package's multi-pod dry run (``repro/launch/dryrun.py``): every
(architecture x input shape x mesh) step bundle lowered and compiled
against 512 placeholder host devices, with XLA's cost analysis of each
(HLO operation and byte counts, collective tables).

Not ported (ROADMAP.md A18d). Its cost tables are XLA's and mean nothing
for eager torch; the part that does (each bundle's parameter bytes a rank
under the port's layout, ``sharding.partition.exec_dim``, and the
collectives a step, ``sharding.api.collectives``) is A18d's to write.

    python -m repro_torch.launch.dryrun   # raises naming A18d
"""
from __future__ import annotations

from repro_torch import not_ported


def main(argv=None):
    raise not_ported("launch.dryrun (XLA's compiled cost analysis of every step bundle)",
                     "A18d")


if __name__ == "__main__":
    main()
