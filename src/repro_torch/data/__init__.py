"""Port of ``repro.data``: the synthetic token source."""
from repro_torch.data.pipeline import SyntheticTokenSource, make_batch_for

__all__ = ["SyntheticTokenSource", "make_batch_for"]
