"""Shared test helpers. NOTE: no XLA_FLAGS here — smoke tests and benches must
see 1 device; only launch/dryrun.py forces 512 host devices (in a subprocess).
"""
import numpy as np
import pytest

from repro.graph.structs import Graph
from repro.core.template import Template


def sample_template_from(g: Graph, size: int, seed: int, extra_edge_p: float = 0.5) -> Template:
    """Random connected subgraph of g as a template — guarantees >= 1 match."""
    r = np.random.default_rng(seed)
    offsets, neighbors = g.csr()
    deg = offsets[1:] - offsets[:-1]
    nz = np.flatnonzero(deg > 0)
    if nz.size == 0:
        raise ValueError("graph has no edges")
    start = int(r.choice(nz))
    verts = [start]
    edges = set()
    for _ in range(size * 4):
        if len(verts) >= size:
            break
        u = int(r.choice(verts))
        nb = neighbors[offsets[u]:offsets[u + 1]]
        if nb.size == 0:
            continue
        v = int(r.choice(nb))
        if v not in verts:
            verts.append(v)
        edges.add((min(u, v), max(u, v)))
    vid = {v: i for i, v in enumerate(verts)}
    es = [(vid[a], vid[b]) for a, b in edges if a in vid and b in vid]
    keyset = set(zip(g.src.tolist(), g.dst.tolist()))
    for a in verts:
        for b in verts:
            if a < b and (a, b) in keyset and r.random() < extra_edge_p:
                es.append((vid[a], vid[b]))
    es = list({tuple(sorted(e)) for e in es})
    return Template([int(g.labels[v]) for v in verts], es)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one (README: "
        "running the port's card tests)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _isolated_dispatch_policy(tmp_path, monkeypatch):
    """Keep tier-1 hermetic w.r.t. any tuned dispatch-policy cache in the
    workspace: every test sees an empty per-test cache path and starts from
    the untuned eligibility fallback (tests install policies explicitly)."""
    from repro.kernels import registry

    monkeypatch.setenv(
        "REPRO_DISPATCH_POLICY", str(tmp_path / "dispatch_policy.json"))
    registry.clear_policy()
    yield
    registry.clear_policy()
