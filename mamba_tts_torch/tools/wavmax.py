"""Find the longest WAV inside a tar/tar.gz archive: the counterpart of
``mamba_tts_tpu/tools/wavmax.py``.

Dataset utility for sizing the codec's ``max_seq_len`` against a corpus.
The WAVs are read on the host by the port's own ``audio/wavio.read_wav``.

CLI: python -m mamba_tts_torch.tools.wavmax archive.tar.gz
"""
from __future__ import annotations

import argparse
import tarfile
from typing import Optional, Tuple

from mamba_tts_torch.audio.wavio import read_wav


def longest_wav_in_tar(tar_path: str) -> Tuple[Optional[str], float]:
    """(member name, seconds) of the longest ``.wav`` member; (None, 0.0)
    when the archive holds none."""
    max_len = 0.0
    max_name = None
    with tarfile.open(tar_path, "r:*") as tf:
        for member in tf.getmembers():
            if not member.name.lower().endswith(".wav"):
                continue
            f = tf.extractfile(member)
            if f is None:
                continue
            wav, sr = read_wav(f.read())
            duration = wav.shape[0] / sr
            if duration > max_len:
                max_len = duration
                max_name = member.name
    return max_name, max_len


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Find longest WAV file inside a .tar/.tar.gz archive."
    )
    parser.add_argument("archive", help="Path to tar or tar.gz file")
    args = parser.parse_args(argv)
    fname, length = longest_wav_in_tar(args.archive)
    if fname is None:
        print("No WAV files found.")
    else:
        print(f"Longest file: {fname}")
        print(f"Duration: {length:.3f} seconds")


if __name__ == "__main__":
    main()
