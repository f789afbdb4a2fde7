"""repro_torch.analysis: the port's static analysis and runtime guard.

Counterpart of ``repro.analysis``. Static rules (AST-based, run via
``python -m repro_torch.analysis``): the thread-ownership race checker
for the ground segment's recount workers, the host-sync lint of the hot
modules, and the determinism lints (the reference's, and torch's global
generators and ``cudnn.benchmark``). Runtime:
:class:`~repro_torch.analysis.launchguard.LaunchGuard` counts kernel
library loads, new allocator segments, launches by entry and syncs, so
benches and tests can assert that steady-state rounds build and
allocate nothing.
"""
from repro_torch.analysis.engine import (Finding, analyze, load_rules,  # noqa: F401
                                         register)
from repro_torch.analysis.launchguard import LaunchGuard  # noqa: F401
