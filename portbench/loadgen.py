"""The one traffic generator: reads a mix's parameters and draws its queries
from the seed.

A mix (`traffic/<mix>.json`) names its loop ("closed": each client sends
its next query when its last one returns), its number of clients, and its
templates: a list of `templates` (labels and edges), or `families`, each a
shape whose labels are shifted by every one of its `offsets`, or both.

The queries come in decks: each deck holds every distinct template once,
in an order drawn from the seed. So every seed sends the same templates
equally often and only their order changes, and a window's work does not
swing with the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

# a large odd constant that separates the traffic's random stream from the
# graph's, which is drawn from the same --seed
_TRAFFIC_STREAM = 0x2545F491


@dataclasses.dataclass(frozen=True)
class TemplateSpec:
    name: str
    labels: Tuple[int, ...]
    edges: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class Mix:
    loop: str
    clients: int
    templates: List[TemplateSpec]

    def stream(self, seed: int) -> Iterator[int]:
        """Template indices in the order the clients send them, forever."""
        rng = np.random.default_rng([int(seed), _TRAFFIC_STREAM])
        while True:
            yield from (int(i) for i in rng.permutation(len(self.templates)))


def _spec(name, labels, edges) -> TemplateSpec:
    return TemplateSpec(name, tuple(int(x) for x in labels),
                        tuple((int(a), int(b)) for a, b in edges))


def load_mix(params: dict) -> Mix:
    if params.get("loop") != "closed":
        raise ValueError(f"unknown loop {params.get('loop')!r}")
    clients = int(params["clients"])
    if clients < 1:
        raise ValueError("a mix needs at least one client")
    templates = [_spec(t["name"], t["labels"], t["edges"])
                 for t in params.get("templates", [])]
    for fam in params.get("families", []):
        for b in fam["offsets"]:
            templates.append(_spec(f"{fam['name']}{b}",
                                   [l + int(b) for l in fam["labels"]],
                                   fam["edges"]))
    if not templates:
        raise ValueError("a mix needs at least one template")
    return Mix(loop="closed", clients=clients, templates=templates)
