"""Rebuild the port's LTS alignment artifact from its bundled lexicon: the
counterpart of ``mamba_tts_tpu/tools/train_lts.py``.

    python -m mamba_tts_torch.tools.train_lts [--iters 5] [--out PATH] [--eval]

Aligns every entry of ``text/lexicon_en.txt`` (plus the inline seed
lexicon) into graphones by Viterbi EM and writes
``mamba_tts_torch/text/lts_alignments.txt``, the artifact that
``lts.default_model()`` replays at load time.  Run after any lexicon
change.  ``--eval`` also reports held-out exact-match accuracy on a
deterministic 80/20 split (seed 0), as the JAX tool does.
"""
from __future__ import annotations

import argparse
import random

from mamba_tts_torch.text.g2p import _builtin_lexicon
from mamba_tts_torch.text.lts import _ALIGNMENTS_PATH, JointNgramLTS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=_ALIGNMENTS_PATH)
    ap.add_argument("--eval", action="store_true")
    args = ap.parse_args(argv)

    lex = dict(_builtin_lexicon())
    print(f"lexicon entries: {len(lex)}")

    if args.eval:
        words = sorted(lex)
        random.Random(0).shuffle(words)
        n_test = len(words) // 5
        test, train = words[:n_test], words[n_test:]
        model = JointNgramLTS.train(
            {w: lex[w] for w in train}, order=4, iters=args.iters
        )
        exact = sum(model.predict(w) == lex[w] for w in test)
        print(f"held-out exact: {exact}/{n_test} = {exact / n_test:.4f}")

    aligned = JointNgramLTS.align_lexicon(lex, iters=args.iters)
    JointNgramLTS.save_alignments(aligned, args.out)
    print(f"wrote {len(aligned)} alignments -> {args.out}")


if __name__ == "__main__":
    main()
