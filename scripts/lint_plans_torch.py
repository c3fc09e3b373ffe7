#!/usr/bin/env python
"""The port's static MergePlan lint sweep — a thin wrapper over ``python -m
repro_torch.analysis``, so both share one entry point.

Sweeps every config in src/repro_torch/configs/, every app superstep in
src/repro_torch/apps/, every shipped merge fn, and the ShardedKV serving
stores at 8 shards stacked on one device; fails with stable CC diagnostic
codes. The programs run on the card unless ``--device cpu`` is given::

    python scripts/lint_plans_torch.py [--device cpu] --json lint_report.json

Suppress a finding per site with ``--suppress CC021@kv[all]``; run the
seeded-violation canaries with ``--fixtures``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
