"""Rule registry and finding model for the port's tracelint (the JAX
package's ``lint/base.py``, as it is).

Mirrors the ``core.schemes`` register pattern: rules are frozen dataclasses
held in a module-level registry, looked up by id, and enumerated in sorted
order so ``--self-test`` and the CLI see a stable rule set.

A :class:`Finding` is one diagnostic anchored to a file/line.  Findings may
carry a mechanical fix as a whole-line replacement; ``--fix`` applies those
only when the on-disk line still matches what the rule saw (no stale edits).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .engine import Project


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id, location, message, optional line fix."""

    rule_id: str
    path: str
    line: int
    message: str
    # (original_line_text, replacement_line_text) for --fix; None = not fixable
    fix: Optional[Tuple[str, str]] = None

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "fixable": self.fix is not None,
        }


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered lint rule.

    ``check`` receives the whole :class:`~repro_torch.lint.engine.Project`
    so rules can be cross-module (TL005 compares tables against configs
    that live in different files; the captured round spans modules).
    ``contract`` names the parity contract the rule protects; it rides
    along into ``--json`` output and the README table.
    """

    id: str
    name: str
    summary: str
    contract: str
    check: Callable[["Project"], List[Finding]]
    fixable: bool = False


_REGISTRY: Dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate tracelint rule id {rule.id!r}")
    _REGISTRY[rule.id] = rule
    return rule


def get(rule_id: str) -> Rule:
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        known = ", ".join(names())
        raise KeyError(f"unknown tracelint rule {rule_id!r}; known: {known}")


def names() -> List[str]:
    return sorted(_REGISTRY)


def all_rules() -> List[Rule]:
    return [_REGISTRY[k] for k in names()]
