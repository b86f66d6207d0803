"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
from the repository's root (about a minute on the CPU).  Tests marked
``cuda`` decide inside themselves whether a card is present and skip
without one."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
