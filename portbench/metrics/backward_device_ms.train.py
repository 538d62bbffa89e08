"""Device ms a traced train step in the program's ``train.backward`` span:
autograd's backward from the total loss,
timed on the card's stream.  None off the card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    return _program.per_root(run, "train.step", ("train.backward",), device=True)
