"""The LM substrate's model: config, layers, decoder stack, assembly."""
