"""CPU tests of the benchmark (``python -m pytest portbench/tests``).

Tests that need the card carry the ``cuda`` marker and skip without one.
"""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
