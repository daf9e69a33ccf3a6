"""Seg-stream losses: the Hungarian matcher and the set criterion."""
