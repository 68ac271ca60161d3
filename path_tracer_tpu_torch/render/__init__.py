"""Renderer: camera basis, sample passes, host pipeline, image output."""
