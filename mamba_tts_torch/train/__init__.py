"""train of the PyTorch/CUDA port (see mamba_tts_torch/__init__.py)."""
