"""The plain float32 reference of the granite codec-token decoder
(``granite_tts.py``); it imports nothing of the system."""
