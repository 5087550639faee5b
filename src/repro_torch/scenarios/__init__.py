"""Fleet-scale scenario registry (registry.py) + the probe task (port of
``repro.scenarios``)."""
from repro_torch.scenarios.probe import ProbeTask, make_probe_data  # noqa: F401
from repro_torch.scenarios.registry import SCENARIOS, Scenario, get  # noqa: F401
