"""Port of ``repro.runtime`` (see the package docstring)."""
