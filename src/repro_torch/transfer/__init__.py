"""Port of ``repro.transfer`` (see the package docstring)."""
