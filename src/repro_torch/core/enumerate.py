"""Full match enumeration, counting and streaming on the pruned solution
subgraph (§4).

Per the paper, enumeration is Alg. 6 with the full template as the
constraint, work aggregation off, and every possible match verified. The
join (core/join.py) walks the complete edge-cover walk of the template;
omega from pruning filters candidates.

Three result modes:
  materialize  every embedding as a row of `EnumerationResult.embeddings`
               (template-vertex column order).
  count        completion counts only; symmetry restrictions from the
               template's automorphism group are enforced in-flight, and
               `n_embeddings` is restricted_count * |Aut|.
  stream       `stream_matches`: a generator of embedding blocks under a
               fixed row budget (bounded memory).

Two join routes serve every mode, resolved through the dispatch policy
(route name ``enumerate.join``, bucket ``(kind, mode)``, kind "local" or
"sharded"):
  host    the numpy row-table join over the compacted active subgraph (the
          local default);
  device  the device-resident join (`join.DeviceJoin`). On a sharded
          `PruneResult` (prune(..., partition=/mesh=)) it is the only route:
          it runs on the backend's shard arrays and never gathers the
          reduced subgraph, in the "rowsharded" flavor (rows on their
          frontier vertex's owner shard; the default) or the "replicated"
          one (the row table on every shard), which the policy's
          ("sharded", mode) bucket or `route=` picks.

On a TdsOverflow that survives chunk back-off to a single source, that
source is finished by the streaming emitter instead of raising.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch import tracing
from repro_torch.core.state import PruneState
from repro_torch.core.template import Template, _edge_cover_walk
from repro_torch.core.tds import compact_active, TdsOverflow
from repro_torch.core import join as join_mod
from repro_torch.kernels import registry

# dispatch-policy route name of the enumeration join (host or device),
# bucketed by (kind, mode), kind "local" or "sharded"
ENUM_ROUTE = "enumerate.join"

MODE_MATERIALIZE = "materialize"
MODE_COUNT = "count"
MODE_STREAM = "stream"


@dataclasses.dataclass
class EnumerationResult:
    embeddings: np.ndarray  # int32[count, n0]: column q = background vertex for q
    n_embeddings: int
    n_distinct_vertex_sets: int  # -1 in count mode (needs materialized rows)
    automorphisms: int
    mode: str = MODE_MATERIALIZE
    route: str = registry.ROUTE_HOST
    n_canonical: Optional[int] = None  # symmetry-restricted row count, if broken


def template_walk(template: Template, label_freq: Optional[np.ndarray] = None):
    freq = label_freq if label_freq is not None else np.ones(int(template.labels.max()) + 1)
    rank = {q: float(freq[template.labels[q]]) for q in range(template.n0)}
    start = min(range(template.n0), key=lambda q: (rank[q], q))
    return _edge_cover_walk(
        set(range(template.n0)), set(template.edge_set), start,
        {q: list(template.adj[q]) for q in range(template.n0)}, rank,
    )


def count_automorphisms(template: Template) -> int:
    """|Aut(T)|, cached on the template."""
    return max(template.automorphism_count(), 1)


_FLAVORS = (registry.ROUTE_ROWSHARDED, registry.ROUTE_REPLICATED)


def _resolve_route(kind: str, mode: str, route: Optional[str],
                   backend: str) -> str:
    """The join route. Local kind: "host" or "device" when pinned, else the
    policy's choice for ("local", mode), the host join by default. Sharded
    kind: always the device join, in the row-placement flavor pinned
    ("rowsharded" | "replicated") or the policy's for ("sharded", mode),
    rowsharded by default; route="device" leaves the flavor to the policy,
    route="host" raises (it would gather the reduced subgraph)."""
    if route is not None:
        if route not in (registry.ROUTE_HOST, registry.ROUTE_DEVICE) + _FLAVORS:
            raise ValueError(f"unknown enumerate.join route {route!r}")
        if kind == "sharded" and route == registry.ROUTE_HOST:
            raise ValueError(
                "the sharded enumeration join is device-resident; route="
                "'host' would gather the reduced subgraph")
        if kind != "sharded" and route in _FLAVORS:
            raise ValueError(
                f"route={route!r} is a sharded row placement; the local "
                "backend has no shards to place rows on")
        if route in _FLAVORS or kind != "sharded":
            return route
    if kind == "sharded":
        return registry.resolve_route(
            ENUM_ROUTE, (kind, mode), default=registry.ROUTE_ROWSHARDED,
            backend=backend, allowed=_FLAVORS)
    return registry.resolve_route(
        ENUM_ROUTE, (kind, mode), default=registry.ROUTE_HOST,
        backend=backend, allowed=(registry.ROUTE_HOST, registry.ROUTE_DEVICE))


def _public_route(route: str) -> str:
    """What `EnumerationResult.route` and the stats report: the row
    placements are flavors of the device route."""
    return registry.ROUTE_DEVICE if route in _FLAVORS else route


def _unpack_args(dg, state, template):
    """Accept (dg, state, template) or a PruneResult first argument ->
    (dg, state, template, the backend a sharded result carries or None)."""
    if state is None and hasattr(dg, "dg") and hasattr(dg, "state"):
        result = dg
        template = template if template is not None else result.template
        backend = getattr(result, "backend", None)
        if backend is None or backend.name not in ("sim", "spmd"):
            backend = None
        return result.dg, result.state, template, backend
    return dg, state, template, None


def _make_engine(route, dg, state, template, walk, max_rows, symmetry_break,
                 stats, backend=None):
    if route == registry.ROUTE_ROWSHARDED:
        return join_mod.RowShardedJoin(
            backend.join_context(), template, walk, max_rows,
            symmetry_break=symmetry_break, stats=stats)
    if route == registry.ROUTE_REPLICATED:
        return join_mod.ReplicatedJoin(
            backend.join_context(), template, walk, max_rows,
            symmetry_break=symmetry_break, stats=stats)
    if route == registry.ROUTE_DEVICE:
        return join_mod.DeviceJoin(
            join_mod.LocalJoinContext(dg, state), template, walk, max_rows,
            symmetry_break=symmetry_break, stats=stats)
    return join_mod.HostJoin(compact_active(dg, state), template, walk,
                             max_rows, symmetry_break=symmetry_break,
                             stats=stats)


def _run_engine(engine, chunk: int, max_rows: int, count_only: bool,
                stats: Optional[Dict]):
    """Chunked source loop with overflow back-off; at chunk 1 an overflowing
    source is finished by the streaming emitter (bounded memory)."""
    sources = engine.sources()
    blocks = []
    total = 0
    off, cur_chunk = 0, chunk
    while off < sources.size:
        ids = sources[off: off + cur_chunk]
        try:
            rows = engine.seed(ids)
            for r in range(1, len(engine.steps) + 1):
                if engine.nrows(rows) == 0:
                    break
                rows = engine.step(rows, r)
            if engine.nrows(rows):
                if count_only:
                    total += engine.count(rows)
                else:
                    blocks.append(engine.emit(rows))
        except TdsOverflow:
            if cur_chunk == 1:
                if stats is not None:
                    stats["enum_stream_fallbacks"] = (
                        stats.get("enum_stream_fallbacks", 0) + 1)
                for blk in join_mod.stream_join(engine, ids, 1, max_rows):
                    if count_only:
                        total += blk.shape[0]
                    else:
                        blocks.append(blk)
                off += ids.size
                continue
            cur_chunk = max(1, cur_chunk // 4)  # paper's rate control
            continue
        off += ids.size
        if cur_chunk < chunk:  # recover toward the configured chunk
            cur_chunk = min(chunk, cur_chunk * 2)
    return total, blocks


@tracing.traced("count.join")
def enumerate_matches(
    dg,
    state: Optional[PruneState] = None,
    template: Optional[Template] = None,
    label_freq: Optional[np.ndarray] = None,
    chunk: int = 4096,
    max_rows: int = 5_000_000,
    stats: Optional[Dict] = None,
    *,
    mode: str = MODE_MATERIALIZE,
    symmetry_break: Optional[bool] = None,
    route: Optional[str] = None,
) -> EnumerationResult:
    """Enumerate (or count) all template embeddings in the pruned graph.

    `dg` may be a `PruneResult` (then `state`/`template` default from it;
    a sharded one runs the sharded device join on its shard arrays).
    `mode` is "materialize" (default) or "count"; `symmetry_break` defaults
    to True exactly in count mode. `route` pins "host" or "device" (or, on
    a sharded result, the flavor "rowsharded" or "replicated"); otherwise
    the dispatch policy decides, the host join by default on a local
    result."""
    dg, state, template, backend = _unpack_args(dg, state, template)
    if mode not in (MODE_MATERIALIZE, MODE_COUNT):
        raise ValueError(f"unknown enumeration mode {mode!r}")
    aut = count_automorphisms(template)
    if template.n0 == 1:
        with tracing.read("enumerate.omega"):
            verts = np.flatnonzero(state.omega[:, 0].cpu().numpy())
        emb = verts.astype(np.int32).reshape(-1, 1)
        if mode == MODE_COUNT:
            return EnumerationResult(
                np.zeros((0, 1), np.int32), emb.shape[0], -1, 1, mode=mode)
        return EnumerationResult(emb, emb.shape[0], emb.shape[0], 1)

    kind = "sharded" if backend is not None else "local"
    route = _resolve_route(kind, mode, route, dg.device.type)
    public = _public_route(route)
    sb = symmetry_break if symmetry_break is not None else (mode == MODE_COUNT)
    if stats is not None:
        stats["enumerate_route"] = public
        stats["enumerate_mode"] = mode
        if kind == "sharded":
            stats["enumerate_join_engine"] = route
    walk = template_walk(template, label_freq)
    engine = _make_engine(route, dg, state, template, walk, max_rows, sb,
                          stats, backend)
    total, blocks = _run_engine(engine, chunk, max_rows,
                                count_only=(mode == MODE_COUNT), stats=stats)
    if mode == MODE_COUNT:
        n_emb = total * aut if sb else total
        return EnumerationResult(
            np.zeros((0, template.n0), np.int32), n_emb, -1, aut,
            mode=mode, route=public, n_canonical=(total if sb else None))
    if blocks:
        emb = np.unique(np.concatenate(blocks, axis=0), axis=0)
    else:
        emb = np.zeros((0, template.n0), np.int32)
    vsets = np.unique(np.sort(emb, axis=1), axis=0)
    n_emb = emb.shape[0] * aut if sb else emb.shape[0]
    return EnumerationResult(
        embeddings=emb,
        n_embeddings=n_emb,
        n_distinct_vertex_sets=vsets.shape[0],
        automorphisms=aut,
        mode=mode,
        route=public,
        n_canonical=(emb.shape[0] if sb else None),
    )


def count_matches(dg, state=None, template=None, **kw) -> EnumerationResult:
    """The counting fast path: `enumerate_matches(..., mode="count")`."""
    return enumerate_matches(dg, state, template, mode=MODE_COUNT, **kw)


def stream_matches(
    dg,
    state: Optional[PruneState] = None,
    template: Optional[Template] = None,
    label_freq: Optional[np.ndarray] = None,
    chunk: int = 4096,
    max_rows: int = 1_000_000,
    stats: Optional[Dict] = None,
    *,
    symmetry_break: bool = False,
    route: Optional[str] = None,
) -> Iterator[np.ndarray]:
    """Stream embedding blocks (int32[k, n0], template-vertex column order)
    under a fixed `max_rows` budget instead of materializing every match:
    source chunks are walked depth-first and row blocks split before each
    expansion (`join.stream_join`), so the whole row table never exists at
    once. `route` as in `enumerate_matches`."""
    dg, state, template, backend = _unpack_args(dg, state, template)
    if template.n0 == 1:
        verts = np.flatnonzero(state.omega[:, 0].cpu().numpy()).astype(np.int32)
        for off in range(0, verts.size, max(max_rows, 1)):
            yield verts[off: off + max_rows].reshape(-1, 1)
        return
    kind = "sharded" if backend is not None else "local"
    route = _resolve_route(kind, MODE_STREAM, route, dg.device.type)
    if stats is not None:
        stats["enumerate_route"] = _public_route(route)
        stats["enumerate_mode"] = MODE_STREAM
        if kind == "sharded":
            stats["enumerate_join_engine"] = route
    walk = template_walk(template, label_freq)
    engine = _make_engine(route, dg, state, template, walk, max_rows,
                          symmetry_break, stats, backend)
    yield from join_mod.stream_join(engine, engine.sources(), chunk, max_rows)
