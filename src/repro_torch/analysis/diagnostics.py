"""Stable diagnostic codes for the static MergePlan verifier.

The port's copy of the JAX package's ``repro/analysis/diagnostics.py``:
the same codes, messages and suppression syntax, so a report of either
package reads the same. Every check in ``repro_torch.analysis`` reports
through a :class:`Diagnostic` carrying a stable ``CCnnn`` code, so logs,
suppressions and tests key on the code rather than on message text. The
catalog groups codes by layer:

* CC00x — merge-fn trait certification (randomized algebraic probes +
  the aten ops ``apply`` runs that ``combine`` does not);
* CC01x — privatization discipline of a program run on example tensors
  (collectives in non-commit regions, settled/pending taint escapes,
  plan/trait audits);
* CC02x — placement (non-commit collectives, commit programs diverging
  from the scheduled collective manifest, donation fallback). The
  reference reads these off compiled HLO; the port off the collectives a
  tick records and the storages it returns (``analysis/placement.py``);
* CC03x — benchmark record-stream hygiene (no benchmark twin yet);
* CC040 — volatile defer state the checkpoint tree does not cover.

Suppressions are per-code, optionally per-site: ``"CC021"`` drops the code
everywhere, ``"CC021@kv[all]"`` only at sites whose name contains
``kv[all]``. Suppressed findings stay in the report (marked) but do not
fail it — the suppression is visible, not silent.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

CATALOG = {
    "CC001": "merge declared idempotent but combine(a, a) != a",
    "CC002": "merge declared scalable but scaling does not commute with "
             "combine (or with its installation into memory)",
    "CC003": "merge declared invertible but combine(a, delta(a, b)) != b",
    "CC004": "merge declared deferrable but apply is not a homomorphism "
             "over combine",
    "CC005": "merge declared deferrable but apply observes memory "
             "(comparison/clamp primitives absent from combine)",
    "CC006": "merge draws a PRNG key per apply but is declared deferrable",
    "CC010": "collective primitive inside a non-commit region",
    "CC011": "settled/remote state read escapes into pending state inside "
             "a non-commit region",
    "CC012": "pending mass escapes into settled state outside a commit",
    "CC013": ":defer level reached by a non-deferrable merge",
    "CC014": "plan geometry or wire codec invalid for the axis/merge",
    "CC020": "cross-device collective in a non-commit tick's compiled HLO",
    "CC021": "commit program's collectives diverge from the scheduled "
             "manifest",
    "CC022": "donated buffer compiled to a copy instead of an alias",
    "CC030": "duplicate benchmark record key in one run",
    "CC040": "volatile defer state not covered by the checkpoint tree "
             "(pending mass would be dropped on restore)",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, the offending site, and the evidence."""

    code: str
    site: str                      # plan/app/program the finding is about
    message: str
    level: Optional[str] = None    # offending plan level name, if any
    severity: str = "error"        # "error" | "warning"

    def __post_init__(self):
        if self.code not in CATALOG:
            raise ValueError(f"unknown diagnostic code {self.code!r} "
                             f"(catalog: {sorted(CATALOG)})")

    def format(self) -> str:
        where = f" level={self.level}" if self.level else ""
        sev = "" if self.severity == "error" else f" [{self.severity}]"
        return f"{self.code}{sev} site={self.site}{where}: {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _suppressed(d: Diagnostic, suppressions: Iterable[str]) -> bool:
    for s in suppressions:
        code, _, site = s.partition("@")
        if code == d.code and (not site or site in d.site):
            return True
    return False


class Report:
    """Accumulates diagnostics + the list of sites that were swept.

    ``ok()`` is the CI verdict: no unsuppressed error-severity findings.
    ``as_json()`` is the machine-readable artifact
    ``scripts/lint_plans_torch.py`` emits; ``format()`` the human rendering
    (one line per finding, CC code first).
    """

    def __init__(self, suppressions: Iterable[str] = ()):
        self.suppressions = tuple(suppressions)
        self.diagnostics: list[Diagnostic] = []
        self.checked: list[str] = []

    def mark_checked(self, site: str) -> None:
        self.checked.append(site)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        for d in diags:
            self.add(d)

    def failures(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == "error"
                and not _suppressed(d, self.suppressions)]

    def ok(self) -> bool:
        return not self.failures()

    def as_dict(self) -> dict:
        return {
            "ok": self.ok(),
            "checked": list(self.checked),
            "suppressions": list(self.suppressions),
            "diagnostics": [d.as_dict() for d in self.diagnostics],
        }

    def as_json(self) -> str:
        return json.dumps(self.as_dict(), indent=1)

    def format(self) -> str:
        lines = []
        for d in self.diagnostics:
            mark = ("suppressed: " if _suppressed(d, self.suppressions)
                    else "")
            lines.append(f"{mark}{d.format()}")
        verdict = "OK" if self.ok() else "FAIL"
        lines.append(f"lint: {verdict} ({len(self.checked)} sites swept, "
                     f"{len(self.failures())} failures, "
                     f"{len(self.diagnostics)} findings)")
        return "\n".join(lines)
