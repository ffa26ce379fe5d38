"""Entry point for ``python -m repro_torch.analysis``."""

from __future__ import annotations

import sys

from .cli import main

sys.exit(main())
