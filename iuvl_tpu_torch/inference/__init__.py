"""Inference heads and post-processing of the seg eval."""
