"""The plain float32 reference of the jamba codec-token decoder, frozen for
the benchmark (a copy of the repository's ``reference/hybrid_tts.py``); it
imports nothing of the system."""
