"""mamba_tts_torch — the PyTorch/CUDA port of ``mamba_tts_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``infer/``, ``audio/``, ``text/``) so each module's counterpart is easy to
find; the JAX package stays the numerical reference.  Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path becomes a hand-written
Hopper kernel under ``ops/csrc/`` with a plain PyTorch version beside it.

- ``ops``    : the hand-written Hopper kernels beside their plain versions:
               the int8 weight-streaming matvec, the decode megakernel, the
               training selective scan (forward, checkpointing forward,
               backward) and flash cross-attention (forward, backward).
- ``models`` : Mamba decoder stack and its captured decode, text encoder,
               duration predictor, SMSD head, the NAR style branch, BERT
               style-text encoder and FACodec (with its VQ training losses)
               with the converters of their released state dicts, the
               multi-resolution STFT discriminator, the training losses
               (``MambaTTS.compute_losses``).
- ``infer``  : int8 step decode and the ``Synthesizer`` serving entry point
               (seeded weights or the train CLI's checkpoints).
- ``train``  : Adam with global-norm clipping, checkpoints, the batch
               preparer, the trainer CLI and the codec trainer CLI.
- ``data``   : the raw corpus, both offline preprocessors and
               ``OfflineDataset`` (the JAX package's on-disk format), the
               worker-backed loader; ``audio`` and ``utils`` beside.
- ``bridge`` : JAX-package parameter trees (numpy, or one ``.npz``) -> port
               modules.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
