"""Committed suppression baseline for kept linter findings.

Counterpart of `repro.analysis.baseline`.  A finding is baselined by the
key (rule, path, whitespace-normalised source line) -- line numbers shift
too easily to key on.  Every entry must carry a non-empty human reason;
the reason is the reviewable artifact (the same contract as
verify/golden's committed accuracy JSON).

Flow:
  * `python -m repro_torch.analysis --check` fails on any finding that is
    not baselined and not pragma-suppressed, and on any entry no finding
    reproduces (a stale entry);
  * after an INTENDED new suppression, add the entry by hand (preferred,
    forces writing the reason) or run `--update-baseline` and fill in the
    generated "TODO" reasons before committing -- the checker rejects a
    baseline containing TODO reasons.
"""

from __future__ import annotations

import json
from pathlib import Path

from .lint import Finding

BASELINE_PATH = Path(__file__).parent / "baseline.json"


def load_baseline(path: Path = BASELINE_PATH) -> list[dict]:
    if not Path(path).exists():
        return []
    entries = json.loads(Path(path).read_text())["findings"]
    for e in entries:
        if not e.get("reason", "").strip() or "TODO" in e.get("reason", ""):
            raise ValueError(
                f"baseline entry for {e.get('path')}:{e.get('code', '')!r} "
                "has an empty/TODO reason; every suppression needs a real one")
    return entries


def _key(rule: str, path: str, code: str) -> tuple[str, str, str]:
    return (rule, path, " ".join(code.split()))


def split_baselined(findings: list[Finding], entries: list[dict]):
    """-> (new_findings, baselined_findings, unused_entries)."""
    allowed = {_key(e["rule"], e["path"], e["code"]) for e in entries}
    used: set[tuple[str, str, str]] = set()
    new, old = [], []
    for f in findings:
        k = _key(f.rule, f.path, f.code)
        if k in allowed:
            used.add(k)
            old.append(f)
        else:
            new.append(f)
    unused = [e for e in entries
              if _key(e["rule"], e["path"], e["code"]) not in used]
    return new, old, unused


def update_baseline(findings: list[Finding], path: Path = BASELINE_PATH) -> int:
    """Rewrite the baseline to exactly the current findings, keeping any
    existing reasons; new entries get a "TODO" reason the check rejects
    until a human fills it in."""
    try:
        existing = {_key(e["rule"], e["path"], e["code"]): e["reason"]
                    for e in json.loads(Path(path).read_text())["findings"]}
    except (FileNotFoundError, KeyError, json.JSONDecodeError):
        existing = {}
    entries, seen = [], set()
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        k = _key(f.rule, f.path, f.code)
        if k in seen:
            continue
        seen.add(k)
        entries.append({
            "rule": f.rule, "path": f.path, "code": " ".join(f.code.split()),
            "reason": existing.get(k, "TODO: justify this suppression"),
        })
    Path(path).write_text(json.dumps({"findings": entries}, indent=2) + "\n")
    return len(entries)
