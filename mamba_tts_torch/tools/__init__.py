"""Command-line tools: counterpart of ``mamba_tts_tpu/tools``."""
