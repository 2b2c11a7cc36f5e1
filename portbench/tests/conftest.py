import sys
from pathlib import Path

# The tests import the tiny-root helper beside them and the repo's packages.
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
