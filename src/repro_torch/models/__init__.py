"""Backbone layers, attention and the decoder stack of the port."""
