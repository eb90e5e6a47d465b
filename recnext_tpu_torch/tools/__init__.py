"""Measurement tools of the port; each runs on the GPU as a script."""
