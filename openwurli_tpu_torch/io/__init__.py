"""File formats of the port: Standard MIDI Files in, WAV in and out."""
