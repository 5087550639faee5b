"""Port of ``repro.kernels`` (see the package docstring)."""
