"""Parallel training and serving over ``torch.distributed``: counterpart of
``mamba_tts_tpu/parallel``."""
