"""Device ms a traced train step in the program's ``train.optimizer`` span:
the gradient dict with its zeros, the global norm, the clip and Adam,
timed on the card's stream.  None off the card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    return _program.per_root(run, "train.step", ("train.optimizer",), device=True)
