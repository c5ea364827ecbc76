"""The benchmark's tests run from the repository root:
``python -m pytest benchmarks/tests -q``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
