"""Device ms a traced request in the program's ``prefill.moe`` spans
(``models/granite.py`` ``GraniteLayer.forward``: each layer's mixture of
experts and shared MLP over every row's prefix), summed over the layers.
None where the program has no such spans."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402


def read(run):
    return _program.per_root(run, "synth.request", ("prefill.moe",), device=True)
