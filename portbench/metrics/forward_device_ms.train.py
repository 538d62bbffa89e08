"""Device ms a traced train step in the program's ``train.forward`` span:
the model's forward and its losses (``models/tts.py`` ``compute_losses``),
timed on the card's stream.  None off the card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    return _program.per_root(run, "train.step", ("train.forward",), device=True)
