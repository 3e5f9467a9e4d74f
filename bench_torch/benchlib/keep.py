"""The calls a run keeps for its check."""

from __future__ import annotations

from benchlib.stats import rng


class KeptCalls:
    """Keeps ``check["keep"]`` calls drawn from the seed among the first
    ``check["keep_within"]`` of the window, and the window's last call:
    their inputs and outputs, until the check reads them."""

    def __init__(self, seed: int, check: dict):
        self.keep_idx = set(rng(seed, 0, 1).sample(
            range(check["keep_within"]), check["keep"]))
        self.kept: dict = {}
        self.latest = None

    def keep(self, i: int, inp, out) -> None:
        self.latest = (i, inp, out)
        if i in self.keep_idx:
            self.kept[i] = (inp, out)

    def kept_items(self) -> list:
        """``(i, inputs, outputs)`` of each kept call, in call order."""
        items = dict(self.kept)
        if self.latest is not None:
            items[self.latest[0]] = self.latest[1:]
        return [(i, *items[i]) for i in sorted(items)]
