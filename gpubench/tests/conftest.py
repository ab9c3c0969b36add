"""The CPU tests of the benchmark (``python -m pytest gpubench/tests -q``):
the checkout's root on the path, so ``gpubench`` and the program import."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
