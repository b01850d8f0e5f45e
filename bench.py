"""Headline benchmark: ``python bench.py`` from the repo root.

The implementation lives in :mod:`nbody.bench.headline`.  It measures on
an NVIDIA GPU or exits non-zero without printing a result.
"""

from nbody.bench.headline import main

if __name__ == "__main__":
    raise SystemExit(main())
