"""fig2, fig4 and consistency on the port against the reference's, run
live on the CPU with the reference's draws injected; the tolerances of
``test_torch_paper_figs.py`` (hours, counts and claims exact, accuracy
figures within 0.02)."""
import pytest

from repro_torch.benchmarks import paper_figs as PFIGS
from test_torch_paper_figs import (REF_FIGS, assert_suite_matches,  # noqa
                                   reference_draws)


@pytest.mark.parametrize("suite", ["fig2", "fig4", "consistency"])
def test_suite_matches_reference(reference_draws, suite):
    ref_fn = {"fig2": REF_FIGS.fig2_distributed, "fig4": REF_FIGS.fig4_alpha,
              "consistency": REF_FIGS.consistency_bench}[suite]
    ref = ref_fn(True)
    port = PFIGS.SUITES[suite](True, device="cpu")
    assert_suite_matches(port, ref)
    assert port["_claims"] == ref["_claims"]
    assert all(port["_claims"].values())
