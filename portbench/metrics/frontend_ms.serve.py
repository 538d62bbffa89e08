"""Host ms a traced request in the front-ends: G2P, BERT, the FACodec
encode of a voice not yet encoded, the duration predictor and the FACodec
decode (the program's spans ``synth.g2p``, ``synth.bert``,
``synth.voice_encode``, ``synth.durations``, ``synth.codec_decode``)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _program  # noqa: E402

NAMES = ("synth.g2p", "synth.bert", "synth.voice_encode", "synth.durations",
         "synth.codec_decode")


def read(run):
    return _program.per_root(run, "synth.request", NAMES)
