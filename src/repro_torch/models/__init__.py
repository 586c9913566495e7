"""The language model (hybrid family) of the port: layers, blocks, LM."""
