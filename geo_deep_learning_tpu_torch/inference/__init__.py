"""Inference: sliding-window whole-scene segmentation, whole or band-streamed."""
