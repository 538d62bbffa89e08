"""Plain float32 references of the models the port runs, in plain ``torch``,
importing nothing of the port: ``hybrid_tts`` (the jamba decoder)."""
