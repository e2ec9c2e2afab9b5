"""Client samplers on the port's main path (Algorithm 2 and its bases)."""
