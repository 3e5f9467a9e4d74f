"""The check that decides ``correct``: the answers of the kept calls
against the plain reference, each number held to its limit.

A driver gives, for each kept call, the program's answers
(``answer(item)``), the reference's (``reference(item, dtype)``) and their
comparison (``compare(got, want)``: named numbers, larger is worse).  The
control puts the reference computed in a lower precision in the program's
place.
"""

from __future__ import annotations

import math

import torch


def largest(t: torch.Tensor) -> float:
    """A tensor's largest entry as a float; NaN anywhere reads as inf."""
    t = t.detach().to(torch.float64)
    if bool(torch.isnan(t).any()):
        return math.inf
    return float(t.max())


def numbers(driver, items: list, control: torch.dtype | None = None) -> dict:
    """Each compared number, the largest over the kept calls ``items``:
    the program's answers against the float32 reference, or with
    ``control`` the reference in that dtype against it."""
    worst: dict[str, float] = {}
    for item in items:
        want = driver.reference(item, torch.float32)
        got = (driver.answer(item) if control is None
               else driver.reference(item, control))
        for name, value in driver.compare(got, want).items():
            worst[name] = max(worst.get(name, -math.inf), value)
    return worst


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, held)``: every limited number at most its limit (a
    missing number fails), and ``{name: {"value", "limit"}}``."""
    held = {name: {"value": values.get(name, math.inf), "limit": limit}
            for name, limit in limits.items()}
    return all(h["value"] <= h["limit"] for h in held.values()), held
