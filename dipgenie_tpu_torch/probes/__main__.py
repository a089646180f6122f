"""``python -m dipgenie_tpu_torch.probes <name> [args]``."""

from __future__ import annotations

import importlib
import sys

from ..device import NoCudaDevice

# probe name -> (module[:function, default main], exit code when the card
# is asked for and absent)
PROBES = {
    "floor": ("floor", 1),
    "pair": ("pair", 1),
    "edge": ("edge", 1),
    "dp-stages": ("dp_stages", 1),
    "parity-gate": ("parity_gate", 2),
    "caps": ("caps", 1),
    "caps2": ("caps:main2", 1),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in PROBES:
        print("usage: python -m dipgenie_tpu_torch.probes "
              f"{{{','.join(PROBES)}}} [--device cuda|cpu] ...",
              file=sys.stderr)
        return 2
    target, no_card = PROBES[argv[0]]
    module, _, entry = target.partition(":")
    probe = importlib.import_module(f"{__package__}.{module}")
    try:
        return getattr(probe, entry or "main")(argv[1:])
    except NoCudaDevice as e:
        print(f"[E::probes] {e}", file=sys.stderr)
        return no_card


if __name__ == "__main__":
    raise SystemExit(main())
