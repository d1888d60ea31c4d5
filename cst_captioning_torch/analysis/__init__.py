"""Invariant engine: AST-based machine-checking of the port's
correctness contracts (rule catalogue in docs/ANALYSIS.md and the README's
port section): all thirteen families, CST-THR, CFG, MET, EXC, OBS, RES,
JIT, DON, DEC, RNG, SHD, DTY and SHP, in their torch meaning.

Public surface::

    from cst_captioning_torch.analysis import run_analysis
    report = run_analysis()          # whole package, all rules
    report.findings                  # unsuppressed [Finding]

    python -m cst_captioning_torch.analysis [--json]   # CLI / preflight

The engine is pure stdlib-AST (it imports neither torch nor jax) so it
runs in seconds on any host; the dynamic lock-order twin lives in
``analysis.lockwatch`` and runs under stub traffic in the tests and
under real replica traffic on the card (chip_smoke phase 12).
"""

from cst_captioning_torch.analysis.engine import (  # noqa: F401
    CHECKERS,
    Finding,
    Report,
    run_analysis,
    validate_report,
)
from cst_captioning_torch.analysis.sarif import (  # noqa: F401
    to_sarif,
    validate_sarif,
)
