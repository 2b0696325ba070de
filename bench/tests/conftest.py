"""The benchmark's tests import ``bench`` from the checkout's root and
``repro_torch`` from its ``src``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
