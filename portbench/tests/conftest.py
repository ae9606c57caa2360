"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
checkout's root (the ``requires_cuda`` ones run on the card and skip
elsewhere)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
