"""mamba_tts_torch — the PyTorch/CUDA port of ``mamba_tts_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``infer/``, ``audio/``, ``text/``) so each module's counterpart is easy to
find; the JAX package stays the numerical reference.  Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path becomes a hand-written
Hopper kernel under ``ops/csrc/`` with a plain PyTorch version beside it.

- ``ops``    : selective-scan reference/step, the int8 weight-streaming
               matvec (CUDA kernel + plain version).
- ``models`` : Mamba decoder stack, text encoder, duration predictor, SMSD
               head, BERT style-text encoder, FACodec (inference half).
- ``infer``  : int8 step decode and the ``Synthesizer`` serving entry point.
- ``bridge`` : JAX-package parameter trees (numpy) -> port modules.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
