"""The benchmark's own tests: the repository root on the import path, and
few threads a worker (the runs are small; xdist runs several)."""

import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
