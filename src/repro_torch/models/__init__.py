"""Port of ``repro.models``: the dense transformer family (config, layers,
decoder-only LM with its two-tier decode cache, model facade)."""
